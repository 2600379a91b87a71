"""Build, bind and launch the deformable-conv kernels:

- ``deform_fwd`` (``csrc/deform_fwd.cu``), replacing
  ``jspsr_tpu/ops/pallas_deform.py::_fwd_kernel``: a persistent grid over
  4 x 64 output tiles, each tile's offset and mask planes and a window of
  the image around it brought into shared memory by TMA (or, for shapes a
  tensor map cannot take, by cp.async); ``fwd_window`` counts, from the
  offsets, the corners it reads from that window and from global memory;
- ``deform_bwd`` (``csrc/deform_bwd.cu``), replacing ``_bwd_kernel`` with
  ``need_dx=False``: one launch of a persistent grid over 4 x 64 tiles,
  each tile's planes and an image window staged in shared memory as K1's
  (TMA, or cp.async), that writes d_offset and d_mask and finishes d_weight
  and d_bias itself (each block's sums in a fixed order, then the last
  block sums the blocks' rows, through a ticket counter that ``_counter``
  keeps per stream);
- ``deform_bwd_dx`` (the same source, its own kernel), replacing
  ``_bwd_kernel`` with ``need_dx=True``: K2 with the input gradient d_x,
  one cooperative launch of K2's persistent grid in three phases split by
  grid-wide barriers (zero the fixed-point d_x accumulator and sum each
  image's L1 norm of contributions in a fixed order; the tiles, scattering
  d_x in 64-bit fixed point scaled per image from that norm into a
  shared-memory window around each 4 x 64 tile, flushed with integer
  atomics; d_x back to fp32 and d_weight and d_bias summed from the
  blocks' rows): bitwise reproducible, one device kernel per call
  (``dx_atomics`` counts, from the offsets, where this data's corners
  go);
- ``deform_fwd``, ``deform_bwd`` and ``deform_bwd_dx`` with
  ``sample_dtype="bfloat16"``: the three kernels' bf16-sampling mode (a
  template flag of each, entry points ``jspsr_deform_fwd_bf16``,
  ``jspsr_deform_bwd_bf16`` and ``jspsr_deform_bwd_dx_bf16``), replacing
  ``_fwd_kernel`` and ``_bwd_kernel`` (need_dx False and True) with
  ``sample_dtype='bfloat16'``: the row products in bf16, as
  ``ops.deform_conv`` defines them (K3's d_x stays the fp32 mode's);
- ``deform_fwd``, ``deform_bwd`` and ``deform_bwd_dx`` on a row slab
  (``y0``; offsets, mask and gradient of Hs rows, the image whole): K1,
  K2 and K3 with their output rows and window origins moved to image rows
  ``y0 + h``, for the spatially sharded forward and backward
  (``parallel/spatial.py``), in either mode (the slab's rows are the same
  template code as the whole image's, so a slab's outputs are those rows
  of the whole image's, bit for bit; K3's d_x is the whole image's
  gradient from the slab's contributions alone, in the slab's own fixed
  point).

Each source is compiled with ``nvcc`` for ``sm_90a`` at first use into a
shared library of its own with a plain C entry point (``ops/cuda_build.py``
builds every kernel of the port in one parallel pass), loaded with
``ctypes``. Nothing is built or loaded when this module is imported, so it
imports on a host without CUDA.

``LAUNCHES`` counts kernel launches by kernel name (one per wrapper call;
the port's launch counters are registered in ``utils/tracing.py``);
a run resets it to show that its main path went through the kernels. The
two backward kernels share a library (``deform_bwd``) and count apart;
each bf16 mode counts under its own name (``deform_fwd_bf16``,
``deform_bwd_bf16``, ``deform_bwd_dx_bf16``), and so does each kernel on a
row slab in each mode (``deform_fwd_slab``, ``deform_bwd_slab``,
``deform_bwd_dx_slab``, ``deform_fwd_bf16_slab``, ``deform_bwd_bf16_slab``,
``deform_bwd_dx_bf16_slab``). The custom ops of
``ops.deform_conv`` call these wrappers from their real implementations
only (never from their fakes), so a count is one launch, not a trace.
"""

from __future__ import annotations

import ctypes

import torch

from jspsr_torch.ops.cuda_build import build
from jspsr_torch.ops.deform_conv import (
    _corners,
    _positions,
    bf16_sampling,
    check_deform_args,
    is_slab,
)
from jspsr_torch.utils import tracing

TAPS = 9
# K1's output tile (rows, columns) and window margin: the constants of
# csrc/deform_fwd.cu, checked against the library when it is loaded
FWD_TILE = (4, 64)
FWD_MARGIN = 4
# K3's output tile (rows, columns; K2's) and window margin: the constants
# of csrc/deform_bwd.cu, checked against the library when it is loaded
DX_TILE = (4, 64)
DX_MARGIN = 4
# a row of K2's scratch: a block's 9 d_weight sums and its d_bias sum
K2_SUMS = TAPS + 1

KERNELS = ("deform_fwd", "deform_bwd", "deform_bwd_dx", "deform_fwd_bf16",
           "deform_bwd_bf16", "deform_bwd_dx_bf16", "deform_fwd_slab",
           "deform_bwd_slab", "deform_fwd_bf16_slab", "deform_bwd_bf16_slab",
           "deform_bwd_dx_slab", "deform_bwd_dx_bf16_slab")
LAUNCHES = tracing.counters("deform_cuda", KERNELS)

_fns: dict = {}
# K2's ticket counters, one zeroed int32 per (device, stream): see
# ``_counter``
_COUNTERS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# kernel -> (library, entry point, number of pointer arguments before
# batch, h, w, pad, hs, y0: every entry point takes a row slab). A kernel
# on a row slab (``<kernel>_slab``) is its kernel's entry point.
_ENTRY = {"deform_fwd": ("deform_fwd", "jspsr_deform_fwd", 6),
          "deform_bwd": ("deform_bwd", "jspsr_deform_bwd", 11),
          "deform_bwd_dx": ("deform_bwd", "jspsr_deform_bwd_dx", 11),
          "deform_fwd_bf16": ("deform_fwd", "jspsr_deform_fwd_bf16", 6),
          "deform_bwd_bf16": ("deform_bwd", "jspsr_deform_bwd_bf16", 11),
          "deform_bwd_dx_bf16": ("deform_bwd", "jspsr_deform_bwd_dx_bf16",
                                 11)}


def _load(name: str):
    """The kernel's ctypes function; for the backward kernels with the
    library's row count, which sizes K2's scratch rows, and K3's scratch
    size in int64 words."""
    name = name.removesuffix("_slab")
    if name not in _fns:
        source, symbol, n_ptr = _ENTRY[name]
        lib = ctypes.CDLL(str(build()[source][0]))
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [
            ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if source == "deform_fwd":
            window = (ctypes.c_int * 5)()
            lib.jspsr_deform_fwd_window(window)
            want = (*FWD_TILE, FWD_MARGIN,
                    *fwd_window_shape(FWD_TILE, FWD_MARGIN))
            if tuple(window) != want:
                raise RuntimeError(f"deform_fwd library's window "
                                   f"{tuple(window)} != {want}")
            path = lib.jspsr_deform_fwd_path
            path.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
            path.restype = ctypes.c_int
            _fns["deform_fwd_path"] = path
        if source == "deform_bwd":
            rows = lib.jspsr_deform_bwd_rows
            rows.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            rows.restype = ctypes.c_int64
            window = (ctypes.c_int * 3)()
            lib.jspsr_deform_bwd_dx_window(window)
            if tuple(window) != (*DX_TILE, DX_MARGIN):
                raise RuntimeError(f"deform_bwd library's window "
                                   f"{tuple(window)} != {DX_TILE}, "
                                   f"{DX_MARGIN}")
            scratch = lib.jspsr_deform_bwd_dx_scratch
            scratch.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int]
            scratch.restype = ctypes.c_int64
            fn = (fn, rows, scratch)
        _fns[name] = fn
    return _fns[name]


def _check(tensors: dict, like: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != like.device:
            raise ValueError(f"deform kernel: {name} must be on {like.device} "
                             f"(CUDA), got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"deform kernel: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"deform kernel: {name} must be contiguous")
    _, _, h, w = like.shape
    if h * w >= 2**31:
        raise ValueError(f"deform kernel: H*W={h * w} exceeds int32 indexing")


def _name(kernel: str, sample_dtype, x, offset, y0: int) -> str:
    """The launch count's name: the kernel, its bf16 mode, and its
    row-slab form (``_slab``) in either mode."""
    name = f"{kernel}_bf16" if bf16_sampling(sample_dtype) else kernel
    return f"{name}_slab" if is_slab(x, offset, y0) else name


def deform_fwd(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, mask: torch.Tensor, padding: int = 1,
               sample_dtype=None, y0: int = 0) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors of the shapes that
    ``ops.deform_conv.check_deform_args`` admits, in its bf16-sampling mode
    where ``sample_dtype`` asks for it, on the row slab of ``offset`` and
    ``mask`` whose first row is image row ``y0`` (the whole image by
    default); raises on anything else. No autograd here:
    ``ops.deform_conv.deform_conv2d`` wraps it."""
    check_deform_args(x, offset, weight, bias, mask, y0)
    name = _name("deform_fwd", sample_dtype, x, offset, y0)
    _check({"x": x, "offset": offset, "weight": weight, "bias": bias,
            "mask": mask}, x)
    b, _, h, w = x.shape
    hs = offset.shape[2]
    if max(h, w) >= 2**22:
        raise ValueError(f"deform_fwd: H, W = {h}, {w}: each must be below "
                         f"2^22")
    out = x.new_empty(b, 1, hs, w)
    fn = _load(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                b, h, w, int(padding), hs, int(y0), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def fwd_path(x: torch.Tensor, offset: torch.Tensor,
             mask: torch.Tensor) -> str:
    """Which load path K1 takes for these CUDA tensors: ``"tma"``, or
    ``"copy"`` where a tensor map cannot take them (a row pitch or a base
    that is not a multiple of 16 bytes)."""
    _load("deform_fwd")
    use = _fns["deform_fwd_path"](x.data_ptr(), offset.data_ptr(),
                                  mask.data_ptr(), x.shape[-1])
    return "tma" if use else "copy"


def _counter(stream: torch.cuda.Stream) -> torch.Tensor:
    """K2's ticket counter for launches on ``stream``: one int32, zeroed
    once, that every K2 launch leaves at 0. One per stream suffices, as a
    stream runs its launches one after the other; two streams may run two
    at once, so each has its own (``deform_bwd.cu``, jspsr_deform_bwd)."""
    key = (stream.device_index, stream.cuda_stream)
    if key not in _COUNTERS:  # the caller's current stream zeroes it
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32,
                                     device=stream.device)
    return _COUNTERS[key]


def _backward_args(kernel, x, offset, weight, mask, grad_out,
                   sample_dtype, y0):
    """Check a backward kernel's arguments; returns its launch count's name
    and (B, H, W, Hs)."""
    check_deform_args(x, offset, weight, None, mask, y0)
    name = _name(kernel, sample_dtype, x, offset, y0)
    _check({"x": x, "offset": offset, "weight": weight, "mask": mask,
            "grad_out": grad_out}, x)
    b, _, h, w = x.shape
    hs = offset.shape[2]
    if grad_out.shape != (b, 1, hs, w):
        raise ValueError(f"grad_out must be {(b, 1, hs, w)}, got "
                         f"{tuple(grad_out.shape)}")
    return name, (b, h, w, hs)


def deform_bwd(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
               mask: torch.Tensor, grad_out: torch.Tensor,
               padding: int = 1, sample_dtype=None, y0: int = 0):
    """Launch the backward kernel without the input gradient on CUDA
    tensors: x (B,1,H,W), offset (B,18,Hs,W), weight (1,1,3,3), mask
    (B,9,Hs,W), grad_out (B,1,Hs,W), the row slab whose first row is image
    row ``y0`` (Hs = H, y0 = 0 by default: the whole image), in its
    bf16-sampling mode where ``sample_dtype`` asks for it. Returns
    ``(d_offset, d_mask, d_weight, d_bias)``, all four from one launch
    (d_weight and d_bias summed in the kernel in a fixed order, the same
    bits on every call on one card; on a slab, its share of the image's).
    An empty batch or slab launches nothing."""
    name, (b, h, w, hs) = _backward_args("deform_bwd", x, offset, weight,
                                         mask, grad_out, sample_dtype, y0)
    d_offset = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    if d_offset.numel() == 0:  # nothing to compute: no launch, none counted
        return d_offset, d_mask, torch.zeros_like(weight), x.new_zeros(1)
    fn, rows, _ = _load(name)
    d_weight, d_bias = torch.empty_like(weight), x.new_empty(1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        # the blocks' sums, written before they are read
        scratch = x.new_empty(rows(b, hs, w), K2_SUMS, dtype=torch.float64)
        ptrs = [x, offset, mask, weight, grad_out, d_offset, d_mask,
                d_weight, d_bias, scratch, _counter(stream)]
        rc = fn(*(t.data_ptr() for t in ptrs), b, h, w, int(padding), hs,
                int(y0), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return d_offset, d_mask, d_weight, d_bias


def deform_bwd_dx(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  mask: torch.Tensor, grad_out: torch.Tensor,
                  padding: int = 1, sample_dtype=None, y0: int = 0):
    """Launch the backward kernel with the input gradient: as
    ``deform_bwd`` (the row slab of image row ``y0`` included), and returns
    ``(d_offset, d_mask, d_weight, d_bias, d_x)``, d_x (B,1,H,W) the whole
    image's gradient from the slab's contributions. All five come from one
    launch: d_x summed in fixed point, scaled per image (from the slab's
    own pixels) on the device, d_weight and d_bias in the kernel in a fixed
    order, so every output is the same, bit for bit, on every call on one
    card. In the bf16-sampling mode d_offset, d_mask and d_weight are
    ``deform_bwd``'s in that mode and d_x is the fp32 mode's. An empty
    batch or slab launches nothing and gives zero d_x, d_weight and
    d_bias."""
    name, (b, h, w, hs) = _backward_args("deform_bwd_dx", x, offset, weight,
                                         mask, grad_out, sample_dtype, y0)
    d_offset = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    if d_offset.numel() == 0:  # nothing to compute: no launch, none counted
        return (d_offset, d_mask, torch.zeros_like(weight), x.new_zeros(1),
                torch.zeros_like(x))
    fn, _, scratch = _load(name)
    d_weight, d_bias, d_x = (torch.empty_like(weight), x.new_empty(1),
                             torch.empty_like(x))
    # the accumulator, the bounds and the blocks' rows: written by the
    # kernel before it reads them
    work = torch.empty(scratch(b, h, w, hs), device=x.device,
                       dtype=torch.int64)
    ptrs = [x, offset, mask, weight, grad_out, d_offset, d_mask, d_weight,
            d_bias, work, d_x]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), b, h, w, int(padding), hs,
                int(y0), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return d_offset, d_mask, d_weight, d_bias, d_x


def dx_atomics(offset: torch.Tensor, h: int, w: int, padding: int = 1,
               tile=DX_TILE, margin: int = DX_MARGIN, y0: int = 0) -> dict:
    """Where K3's d_x contributions go for these offsets (B, 18, Hs, W), the
    row slab of an H x W image whose first row is image row ``y0`` (the
    whole image by default), on their device: one per in-bounds corner of
    every tap (``corners``), into the block's shared-memory window
    (``shared``) when the corner lies within ``margin`` of its pixel's
    output tile (a tile of the slab, at image rows ``y0 + h``), else
    straight to global memory (``direct``). ``flush`` counts the in-image
    window cells that receive a contribution, one global atomic each (an
    upper bound: the kernel skips a cell whose sum is exactly 0);
    ``global`` is ``direct + flush``. Plain PyTorch. Without the window
    every corner would go global."""
    b, _, hs, _ = offset.shape
    th, tw = tile
    win_h, win_w = th + 2 * margin, tw + 2 * margin
    tiles_y, tiles_x = -(-hs // th), -(-w // tw)
    dev = offset.device
    yy = torch.arange(hs, device=dev).view(1, 1, hs, 1)
    xx = torch.arange(w, device=dev).view(1, 1, 1, w)
    # each output pixel's window origin (an image row) and block
    wy0, wx0 = y0 + (yy // th) * th - margin, (xx // tw) * tw - margin
    block = (torch.arange(b, device=dev).view(b, 1, 1, 1) * tiles_y
             + yy // th) * tiles_x + xx // tw
    corners, _, _ = _corners(*_positions(offset, padding, y0), h, w)
    counts = {"corners": 0, "shared": 0, "direct": 0}
    cells = []
    for idx, valid in corners:
        ry, rx = idx // w - wy0, idx % w - wx0
        inside = valid & (ry >= 0) & (ry < win_h) & (rx >= 0) & (rx < win_w)
        counts["corners"] += int(valid.sum())
        counts["shared"] += int(inside.sum())
        cells.append(((block * win_h + ry) * win_w + rx)[inside])
    counts["direct"] = counts["corners"] - counts["shared"]
    counts["flush"] = int(torch.unique(torch.cat(cells)).numel())
    counts["global"] = counts["direct"] + counts["flush"]
    return counts


def fwd_window_shape(tile=FWD_TILE, margin: int = FWD_MARGIN):
    """K1's window (rows, columns) around a ``tile``: every corner of every
    tap whose offsets are within ``margin``; its left edge lies on a
    multiple of 4 columns (16-byte groups, up to 3 columns further out),
    its width is a whole number of groups."""
    th, tw = tile
    return th + 2 * margin + 3, (tw + 2 * margin + 9) // 4 * 4


def fwd_window_origin(y, x, padding: int = 1, tile=FWD_TILE,
                      margin: int = FWD_MARGIN):
    """The image row and column of the window's first cell for the tile
    that holds pixel (y, x) (integer tensors or ints)."""
    th, tw = tile
    return (y // th * th - padding - margin,
            (x // tw * tw - padding - margin) // 4 * 4)


def fwd_window(offset: torch.Tensor, h: int, w: int, padding: int = 1,
               tile=FWD_TILE, margin: int = FWD_MARGIN) -> dict:
    """Where K1 reads its corners for these offsets (B, 18, H, W), on their
    device. A tap whose 2 x 2 block of corners lies in the window of its
    pixel's tile reads all four from shared memory (``window``, off-image
    cells included: they hold 0); any other tap reads its in-image corners
    from global memory (``global``). ``corners`` counts the in-image
    corners of every tap, what a plain gather reads; ``taps`` and
    ``window_taps`` count taps. Plain PyTorch."""
    win_h, win_w = fwd_window_shape(tile, margin)
    dev = offset.device
    wy0, wx0 = fwd_window_origin(torch.arange(h, device=dev).view(1, 1, h, 1),
                                 torch.arange(w, device=dev).view(1, 1, 1, w),
                                 padding, tile, margin)
    py, px = _positions(offset, padding)
    # each pixel's window origin, in float as the kernel tests it
    ry = torch.floor(py) - wy0.float()
    rx = torch.floor(px) - wx0.float()
    inside = ((ry >= 0) & (ry <= win_h - 2) & (rx >= 0)
              & (rx <= win_w - 2))
    corners, _, _ = _corners(py, px, h, w)
    in_image = sum(valid.to(torch.int64) for _, valid in corners)
    window_taps = int(inside.sum())
    return {"taps": inside.numel(), "window_taps": window_taps,
            "window": 4 * window_taps,
            "global": int(in_image[~inside].sum()),
            "corners": int(in_image.sum())}
