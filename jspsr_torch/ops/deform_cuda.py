"""Build, bind and launch the deformable-conv kernels:

- ``deform_fwd`` (``csrc/deform_fwd.cu``), replacing
  ``jspsr_tpu/ops/pallas_deform.py::_fwd_kernel``: a persistent grid over
  4 x 64 output tiles, each tile's offset and mask planes and a window of
  the image around it brought into shared memory by TMA (or, for shapes a
  tensor map cannot take, by cp.async); ``fwd_window`` counts, from the
  offsets, the corners it reads from that window and from global memory;
- ``deform_bwd`` (``csrc/deform_bwd.cu``), replacing ``_bwd_kernel`` with
  ``need_dx=False``: d_offset, d_mask and per-block d_weight partials;
- ``deform_bwd_dx`` (the same source, its own kernel), replacing
  ``_bwd_kernel`` with ``need_dx=True``: the same outputs plus the input
  gradient d_x, scattered in 64-bit fixed point (scaled per image from
  the L1 norm of its contributions, which a first pass sums in a fixed
  order) into a shared-memory window around each 8 x 32 output tile and
  flushed with integer atomics, then turned back into fp32 by a last pass:
  bitwise reproducible (``dx_atomics`` counts, from the offsets, where
  this data's corners go).

Each source is compiled with ``nvcc`` for ``sm_90a`` at first use into a
shared library of its own with a plain C entry point (``ops/cuda_build.py``
builds every kernel of the port in one parallel pass), loaded with
``ctypes``. Nothing is built or loaded when this module is imported, so it
imports on a host without CUDA.

``LAUNCHES`` counts kernel launches by kernel name (one per wrapper call);
a run resets it to show that its main path went through the kernels. The
two backward kernels share a library (``deform_bwd``) and count apart.
"""

from __future__ import annotations

import ctypes

import torch

from jspsr_torch.ops.cuda_build import build
from jspsr_torch.ops.deform_conv import _corners, _positions

TAPS = 9
# K1's output tile (rows, columns) and window margin: the constants of
# csrc/deform_fwd.cu, checked against the library when it is loaded
FWD_TILE = (4, 64)
FWD_MARGIN = 4
# K3's output tile (rows, columns) and window margin: the constants of
# csrc/deform_bwd.cu, checked against the library when it is loaded
DX_TILE = (8, 32)
DX_MARGIN = 4

KERNELS = ("deform_fwd", "deform_bwd", "deform_bwd_dx")
LAUNCHES = {name: 0 for name in KERNELS}

_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# kernel -> (library, number of pointer arguments before batch, h, w, pad)
_ENTRY = {"deform_fwd": ("deform_fwd", 6), "deform_bwd": ("deform_bwd", 8),
          "deform_bwd_dx": ("deform_bwd", 10)}


def _load(name: str):
    """The kernel's ctypes function; for the backward kernels with the
    library's block count, which sizes the d_weight partials, and K3's
    scratch size in int64 words."""
    if name not in _fns:
        source, n_ptr = _ENTRY[name]
        lib = ctypes.CDLL(str(build()[source][0]))
        fn = getattr(lib, f"jspsr_{name}")
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if name == "deform_fwd":
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
            blocks = lib.jspsr_deform_bwd_blocks
            blocks.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int]
            blocks.restype = ctypes.c_int64
            window = (ctypes.c_int * 3)()
            lib.jspsr_deform_bwd_dx_window(window)
            if tuple(window) != (*DX_TILE, DX_MARGIN):
                raise RuntimeError(f"deform_bwd library's window "
                                   f"{tuple(window)} != {DX_TILE}, "
                                   f"{DX_MARGIN}")
            scratch = lib.jspsr_deform_bwd_dx_scratch
            scratch.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            scratch.restype = ctypes.c_int64
            need_dx = int(name == "deform_bwd_dx")
            fn = (fn, lambda b, h, w: blocks(need_dx, b, h, w), scratch)
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


def deform_fwd(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, mask: torch.Tensor,
               padding: int = 1) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors of the shapes that
    ``ops.deform_conv.check_deform_args`` admits; raises on anything
    else. No autograd here: ``ops.deform_conv.deform_conv2d`` wraps it."""
    _check({"x": x, "offset": offset, "weight": weight, "bias": bias,
            "mask": mask}, x)
    b, _, h, w = x.shape
    if max(h, w) >= 2**22:
        raise ValueError(f"deform_fwd: H, W = {h}, {w}: each must be below "
                         f"2^22")
    out = torch.empty_like(x)
    fn = _load("deform_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                b, h, w, int(padding), stream)
    if rc != 0:
        raise RuntimeError(f"deform_fwd launch failed: cudaError {rc}")
    LAUNCHES["deform_fwd"] += 1
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


def _backward(name, x, offset, weight, mask, grad_out, padding):
    _check({"x": x, "offset": offset, "weight": weight, "mask": mask,
            "grad_out": grad_out}, x)
    if grad_out.shape != x.shape:
        raise ValueError(f"grad_out must be {tuple(x.shape)}, got "
                         f"{tuple(grad_out.shape)}")
    b, _, h, w = x.shape
    fn, blocks, scratch = _load(name)
    d_offset = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    partial = torch.empty(blocks(b, h, w), TAPS, device=x.device,
                          dtype=torch.float32)
    tail, d_x = [], []
    if name == "deform_bwd_dx":
        # the fixed-point accumulator, summed with atomics, starts at zero;
        # the bounds pass's partials after it are written whole
        d_x = [torch.empty_like(x)]
        tail = [torch.zeros(scratch(b, h, w), device=x.device,
                            dtype=torch.int64), d_x[0]]
    ptrs = [x, offset, mask, weight, grad_out, d_offset, d_mask, partial,
            *tail]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), b, h, w, int(padding), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    d_weight = partial.sum(0).view_as(weight)
    return (d_offset, d_mask, d_weight, grad_out.sum().view(1), *d_x)


def deform_bwd(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
               mask: torch.Tensor, grad_out: torch.Tensor,
               padding: int = 1):
    """Launch the backward kernel without the input gradient on CUDA
    tensors: x (B,1,H,W), offset (B,18,H,W), weight (1,1,3,3), mask
    (B,9,H,W), grad_out (B,1,H,W). Returns ``(d_offset, d_mask, d_weight,
    d_bias)``; d_weight is the kernel's per-block partials summed here,
    d_bias the sum of ``grad_out``."""
    return _backward("deform_bwd", x, offset, weight, mask, grad_out,
                     padding)


def deform_bwd_dx(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  mask: torch.Tensor, grad_out: torch.Tensor,
                  padding: int = 1):
    """Launch the backward kernel with the input gradient: as
    ``deform_bwd``, and returns ``(d_offset, d_mask, d_weight, d_bias,
    d_x)``. d_x is summed in fixed point, scaled per image on the device,
    so every output is the same, bit for bit, on every run."""
    return _backward("deform_bwd_dx", x, offset, weight, mask, grad_out,
                     padding)


def dx_atomics(offset: torch.Tensor, h: int, w: int, padding: int = 1,
               tile=DX_TILE, margin: int = DX_MARGIN) -> dict:
    """Where K3's d_x contributions go for these offsets (B, 18, H, W), on
    their device: one per in-bounds corner of every tap (``corners``),
    into the block's shared-memory window (``shared``) when the corner lies
    within ``margin`` of its pixel's output tile, else straight to global
    memory (``direct``). ``flush`` counts the in-image window cells that
    receive a contribution, one global atomic each (an upper bound: the
    kernel skips a cell whose sum is exactly 0); ``global`` is ``direct +
    flush``. Plain PyTorch. Without the window every corner would go
    global."""
    b = offset.shape[0]
    th, tw = tile
    win_h, win_w = th + 2 * margin, tw + 2 * margin
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    dev = offset.device
    yy = torch.arange(h, device=dev).view(1, 1, h, 1)
    xx = torch.arange(w, device=dev).view(1, 1, 1, w)
    # each output pixel's window origin and block
    wy0, wx0 = (yy // th) * th - margin, (xx // tw) * tw - margin
    block = (torch.arange(b, device=dev).view(b, 1, 1, 1) * tiles_y
             + yy // th) * tiles_x + xx // tw
    corners, _, _ = _corners(*_positions(offset, padding), h, w)
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
