"""Build, bind and launch the deformable-conv kernels:

- ``deform_fwd`` (``csrc/deform_fwd.cu``), replacing
  ``jspsr_tpu/ops/pallas_deform.py::_fwd_kernel``;
- ``deform_bwd`` (``csrc/deform_bwd.cu``), replacing ``_bwd_kernel`` with
  ``need_dx=False``: d_offset, d_mask and per-block d_weight partials;
- ``deform_bwd_dx`` (the same source, its ``kNeedDx`` form), replacing
  ``_bwd_kernel`` with ``need_dx=True``: the same outputs plus the input
  gradient d_x, scattered with float atomics.

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

TAPS = 9

KERNELS = ("deform_fwd", "deform_bwd", "deform_bwd_dx")
LAUNCHES = {name: 0 for name in KERNELS}

_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# kernel -> (library, number of pointer arguments before batch, h, w, pad)
_ENTRY = {"deform_fwd": ("deform_fwd", 6), "deform_bwd": ("deform_bwd", 8),
          "deform_bwd_dx": ("deform_bwd", 9)}


def _load(name: str):
    """The kernel's ctypes function; for the backward kernels with the
    threads per block, which sizes the d_weight partials."""
    if name not in _fns:
        source, n_ptr = _ENTRY[name]
        lib = ctypes.CDLL(str(build()[source][0]))
        fn = getattr(lib, f"jspsr_{name}")
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if source == "deform_bwd":
            threads = lib.jspsr_deform_bwd_threads
            threads.argtypes = []
            threads.restype = ctypes.c_int
            fn = (fn, threads())
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


def _backward(name, x, offset, weight, mask, grad_out, padding):
    _check({"x": x, "offset": offset, "weight": weight, "mask": mask,
            "grad_out": grad_out}, x)
    if grad_out.shape != x.shape:
        raise ValueError(f"grad_out must be {tuple(x.shape)}, got "
                         f"{tuple(grad_out.shape)}")
    b, _, h, w = x.shape
    fn, threads = _load(name)
    d_offset = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    blocks = -(-b * h * w // threads)
    partial = torch.empty(blocks, TAPS, device=x.device, dtype=torch.float32)
    # the input gradient is accumulated with atomics: it starts at zero
    d_x = [torch.zeros_like(x)] if name == "deform_bwd_dx" else []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                weight.data_ptr(), grad_out.data_ptr(), d_offset.data_ptr(),
                d_mask.data_ptr(), partial.data_ptr(),
                *(t.data_ptr() for t in d_x), b, h, w, int(padding), stream)
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
    d_x)``. d_x is summed with float atomics, so its low bits change from
    run to run."""
    return _backward("deform_bwd_dx", x, offset, weight, mask, grad_out,
                     padding)
