"""K4: the kk x kk stride-1 "same" convolution of the TPU im2col probe.

``conv_same(x, w)`` takes NHWC ``x`` and HWIO ``w`` (the probe's layouts,
``scripts/bench_pallas_conv.py::pallas_conv_same``) in bf16 or fp32, sums in
fp32 and returns x's dtype. On a CUDA tensor it launches one of the
hand-written kernels (built by ``ops/cuda_build.py``) or raises: bf16 takes
``csrc/conv_same_bf16.cu`` (wgmma, TMA halos, a persistent grid; its launch
plan is ``plan_bf16``), fp32 ``csrc/conv_same_f32.cu`` (a cp.async
double-buffered FFMA implicit GEMM). On a CPU tensor it runs
``conv_same_plain``, the same function in plain PyTorch: the im2col patch
matrix the TPU kernel builds in VMEM, times the (kk*kk*Cin, Cout) weight
matrix, in fp32.

No model layer calls it: the probe's decision rule (an op-level win below
about 1.3x does not ship) stands, and the JAX models do not use it either.
Its caller is the probe's port, ``jspsr_torch/scripts/bench_conv_same.py``.
``LAUNCHES["conv_same"]`` counts launches (one per wrapper call on CUDA).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from jspsr_torch.ops.cuda_build import build

LAUNCHES = {"conv_same": 0}
MAX_CHANNELS = 128
MAX_PIXELS = 2**31  # B*H*W: the kernels index pixels with 32-bit ints
_DTYPES = (torch.float32, torch.bfloat16)
_fns: dict = {}

# The bf16 kernel's fixed geometry (csrc/conv_same_bf16.cu, which checks
# the first two at launch): a tile is BF16_ROWS output rows of BF16_TILE_W
# pixels (wgmma's M is 64), two rows for each of two consumer warpgroups,
# whose BF16_WARPS warps each stage 16 pixels for the epilogue.
BF16_TILE_W = 64
BF16_ROWS = 4
BF16_WARPS = 8
MAX_STAGES = 4
SMEM_LIMIT = 232_448  # shared memory a block may have on an H100 (sm_90)
SMEM_ALIGN = 128  # TMA boxes and the shared-memory base: 128-byte aligned


@dataclass(frozen=True)
class PlanBf16:
    """The bf16 kernel's launch plan. Each of the ``grid`` blocks keeps
    output channels ``[s * ns, (s + 1) * ns)`` of every tap's weights
    resident, s = block % n_split, and walks the spatial tiles first, first
    + step, ... (first = block // n_split, step = grid // n_split) of the
    ``n_tiles = B * tiles_y * tiles_x`` tiles, ordered batch, tile row,
    tile column: tile t covers rows ``BF16_ROWS * ty`` onward and columns
    ``BF16_TILE_W * tx`` onward of image b. Byte offsets are into the
    block's 128-byte aligned shared memory (``smem`` bytes, which include
    the alignment slack): the ``stages`` x 2 mbarriers at 0, the ring of
    halos at ``ring`` (each stage Cin/8 chunks of ``pitch`` bytes), the
    weights at ``weights`` and the epilogue's staging tiles at
    ``staging``."""
    tiles_x: int
    tiles_y: int
    n_tiles: int
    n_split: int
    ns: int
    stages: int
    pitch: int
    ring: int
    weights: int
    staging: int
    smem: int
    grid: int


def _align(n: int) -> int:
    return -(-n // SMEM_ALIGN) * SMEM_ALIGN


@functools.lru_cache(maxsize=256)
def plan_bf16(b: int, h: int, w: int, cin: int, cout: int, kk: int,
              n_sms: int) -> PlanBf16:
    """The launch plan of the bf16 kernel on a card with ``n_sms`` SMs:
    the fewest Cout slices whose weights fit beside a ring of at least two
    halo stages (one where even 16 channels' weights leave no room for two:
    Cin 128 at kk 3), then as many stages (up to 4) as fit; one block per
    SM (a multiple of the slices), never more than there is work for."""
    tiles_x, tiles_y = -(-w // BF16_TILE_W), -(-h // BF16_ROWS)
    n_tiles = b * tiles_x * tiles_y
    pitch = _align((BF16_ROWS + kk - 1) * (BF16_TILE_W + kk - 1) * 16)
    stage = cin // 8 * pitch
    ring = SMEM_ALIGN  # after 2 x MAX_STAGES mbarriers of 8 bytes
    for least in (2, 1):
        for n_split in range(1, cout // 16 + 1):
            ns = cout // n_split
            if cout % n_split or ns % 16:
                continue
            weights_b = kk * kk * cin * ns * 2
            staging_b = BF16_WARPS * 16 * (2 * ns + 16)
            for stages in range(MAX_STAGES, least - 1, -1):
                weights = ring + stages * stage
                staging = _align(weights + weights_b)
                smem = SMEM_ALIGN + staging + staging_b
                if smem <= SMEM_LIMIT:
                    grid = n_split * max(1, min(n_sms // n_split, n_tiles))
                    return PlanBf16(tiles_x, tiles_y, n_tiles, n_split, ns,
                                    stages, pitch, ring, weights, staging,
                                    smem, grid)
    raise ValueError(f"conv_same: no bf16 plan fits {SMEM_LIMIT} bytes for "
                     f"Cin {cin}, Cout {cout}, kk {kk}")


def reset_launches() -> None:
    LAUNCHES["conv_same"] = 0


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> int:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv_same: x must be NHWC and w HWIO, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    kk = w.shape[0]
    if w.shape[1] != kk or kk % 2 == 0 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv_same: w must be (kk, kk, Cin, Cout) with kk "
                         f"odd and Cin = {x.shape[3]}, got {tuple(w.shape)}")
    return kk


def conv_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The function in plain PyTorch: zero-pad, gather the kk*kk shifted
    views into the (B, H, W, kk*kk*Cin) patch matrix (tap-major, channel
    minor, as ``w.reshape(kk*kk*Cin, Cout)`` orders K), one fp32 matmul,
    cast to x's dtype."""
    kk = _check_shapes(x, w)
    b, h, wd, cin = x.shape
    pad = kk // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, pad, pad, pad, pad))
    patches = torch.cat([xp[:, dy:dy + h, dx:dx + wd, :]
                         for dy in range(kk) for dx in range(kk)], dim=-1)
    out = patches.reshape(-1, kk * kk * cin) @ w.float().reshape(
        kk * kk * cin, -1)
    return out.reshape(b, h, wd, -1).to(x.dtype)


def _load(dtype: torch.dtype):
    if dtype not in _fns:
        name = "conv_same_bf16" if dtype == torch.bfloat16 else \
            "conv_same_f32"
        fn = getattr(ctypes.CDLL(str(build()[name][0])), f"jspsr_{name}")
        n_int = 18 if dtype == torch.bfloat16 else 5
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [
            ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def check_kernel_shape(dtype: torch.dtype, b: int, h: int, w: int, cin: int,
                       cout: int, kk: int) -> None:
    """Raise unless the CUDA kernels take this shape: kk 1 or 3, B*H*W <
    2^31; bf16 Cin and Cout in [16, 128], multiples of 16 (wgmma's K step
    is 16 channels, and TMA wants the pixel stride Cin * 2 bytes a multiple
    of 16); fp32 Cin in [1, 128] and Cout in [8, 128], a multiple of 8."""
    if kk not in (1, 3):
        raise ValueError(f"conv_same kernel: kk must be 1 or 3, got {kk}")
    if dtype == torch.bfloat16:
        ok = (16 <= cin <= MAX_CHANNELS and cin % 16 == 0
              and 16 <= cout <= MAX_CHANNELS and cout % 16 == 0)
        takes = (f"Cin and Cout in [16, {MAX_CHANNELS}], each a multiple of "
                 f"16")
    else:
        ok = (1 <= cin <= MAX_CHANNELS and 8 <= cout <= MAX_CHANNELS
              and cout % 8 == 0)
        takes = (f"Cin in [1, {MAX_CHANNELS}] and Cout in [8, "
                 f"{MAX_CHANNELS}] (a multiple of 8)")
    if not ok:
        raise ValueError(f"conv_same kernel: {dtype} takes {takes}; got Cin "
                         f"{cin}, Cout {cout}")
    if b * h * w >= MAX_PIXELS:
        raise ValueError(f"conv_same kernel: B*H*W = {b * h * w} pixels, "
                         f"the kernels take fewer than 2^31")


def _check_cuda(x: torch.Tensor, w: torch.Tensor, kk: int) -> None:
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"conv_same: {name} must be on {x.device} "
                             f"(CUDA), got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(f"conv_same: x and w must both be float32 or "
                            f"both bfloat16, got {x.dtype} and {w.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv_same: {name} must be contiguous and "
                             f"16-byte aligned")
    check_kernel_shape(x.dtype, *x.shape, w.shape[3], kk)


def conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """kk x kk stride-1 'same' conv of NHWC ``x`` with HWIO ``w``, summed in
    fp32, in x's dtype. CPU tensors take ``conv_same_plain``; CUDA tensors
    launch the kernel or raise (see ``check_kernel_shape``)."""
    kk = _check_shapes(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv_same_plain(x, w)
    _check_cuda(x, w, kk)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty(b, h, wd, cout, device=x.device, dtype=x.dtype)
    if out.numel() == 0:  # nothing to compute: no launch, none counted
        return out
    fn = _load(x.dtype)
    args = [x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, cin, cout,
            kk]
    if x.dtype == torch.bfloat16:
        props = torch.cuda.get_device_properties(x.device)
        p = plan_bf16(b, h, wd, cin, cout, kk, props.multi_processor_count)
        args += [BF16_TILE_W, BF16_ROWS, p.tiles_x, p.tiles_y, p.n_tiles,
                 p.ns, p.stages, p.pitch, p.ring, p.weights, p.staging,
                 p.smem, p.grid]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"conv_same launch failed: cudaError {rc}")
    LAUNCHES["conv_same"] += 1
    return out
