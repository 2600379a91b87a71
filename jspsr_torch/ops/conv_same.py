"""K4: the kk x kk stride-1 "same" convolution of the TPU im2col probe.

``conv_same(x, w)`` takes NHWC ``x`` and HWIO ``w`` (the probe's layouts,
``scripts/bench_pallas_conv.py::pallas_conv_same``) in bf16 or fp32, sums in
fp32 and returns x's dtype. On a CUDA tensor it launches the hand-written
kernel (``csrc/conv_same.cu``, built by ``ops/cuda_build.py``) or raises;
on a CPU tensor it runs ``conv_same_plain``, the same function in plain
PyTorch: the im2col patch matrix the TPU kernel builds in VMEM, times the
(kk*kk*Cin, Cout) weight matrix, in fp32.

No model layer calls it: the probe's decision rule (an op-level win below
about 1.3x does not ship) stands, and the JAX models do not use it either.
Its caller is the probe's port, ``jspsr_torch/scripts/bench_conv_same.py``.
``LAUNCHES["conv_same"]`` counts launches (one per wrapper call on CUDA).
"""

from __future__ import annotations

import ctypes

import torch

from jspsr_torch.ops.cuda_build import build

LAUNCHES = {"conv_same": 0}
MAX_CHANNELS = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn: list = []


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


def _load():
    if not _fn:
        lib = ctypes.CDLL(str(build()["conv_same"][0]))
        fn = lib.jspsr_conv_same
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


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
    b, _, _, cin = x.shape
    cout = w.shape[3]
    mult = 16 if x.dtype == torch.bfloat16 else 1
    if kk not in (1, 3):
        raise ValueError(f"conv_same kernel: kk must be 1 or 3, got {kk}")
    if not (1 <= cin <= MAX_CHANNELS and cin % mult == 0
            and 8 <= cout <= MAX_CHANNELS and cout % max(mult, 8) == 0):
        raise ValueError(
            f"conv_same kernel: {x.dtype} takes Cin in [1, {MAX_CHANNELS}] "
            f"(a multiple of {mult}) and Cout in [8, {MAX_CHANNELS}] (a "
            f"multiple of {max(mult, 8)}); got Cin {cin}, Cout {cout}")
    if b > 65535:
        raise ValueError(f"conv_same kernel: batch {b} > 65535")


def conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """kk x kk stride-1 'same' conv of NHWC ``x`` with HWIO ``w``, summed in
    fp32, in x's dtype. CPU tensors take ``conv_same_plain``; CUDA tensors
    launch the kernel or raise (kk 1 or 3, see ``_check_cuda``)."""
    kk = _check_shapes(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv_same_plain(x, w)
    _check_cuda(x, w, kk)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty(b, h, wd, cout, device=x.device, dtype=x.dtype)
    if out.numel() == 0:  # nothing to compute: no launch, none counted
        return out
    fn = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
                b, h, wd, cin, cout, kk, stream)
    if rc != 0:
        raise RuntimeError(f"conv_same launch failed: cudaError {rc}")
    LAUNCHES["conv_same"] += 1
    return out
