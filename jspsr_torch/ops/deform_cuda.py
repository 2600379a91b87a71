"""Build, bind and launch the deformable-conv kernels:

- ``deform_fwd`` (``csrc/deform_fwd.cu``), replacing
  ``jspsr_tpu/ops/pallas_deform.py::_fwd_kernel``;
- ``deform_bwd`` (``csrc/deform_bwd.cu``), replacing ``_bwd_kernel`` with
  ``need_dx=False``: d_offset, d_mask and per-block d_weight partials.

Each source is compiled with ``nvcc`` for ``sm_90a`` at first use into a
shared library of its own with a plain C entry point, loaded with
``ctypes``; ``build`` starts one ``nvcc`` per source, all at once. Nothing
is built or loaded when this module is imported, so it imports on a host
without CUDA. Every library's file name carries a hash of all the sources
and flags, so an edited source is rebuilt and a stale build is never
loaded.

``LAUNCHES`` counts kernel launches by kernel name (one per wrapper call);
a run resets it to show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"deform_fwd": CSRC / "deform_fwd.cu",
           "deform_bwd": CSRC / "deform_bwd.cu"}
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
TAPS = 9

LAUNCHES = {name: 0 for name in SOURCES}

_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (torch CUDA_HOME is None); "
                           "nvcc is needed to build the deform kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path(name: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES.values():
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> dict:
    """Compile every kernel whose library does not exist yet, one ``nvcc``
    per source, all started together. Returns ``{name: (library path,
    seconds compiling)}`` (0.0 for a cached library); with ``verbose`` it
    prints each build's ``-Xptxas -v`` report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not library_path(n).exists() for n in SOURCES) \
        else None
    running = {}
    for name, src in SOURCES.items():
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True),
                         tmp, time.perf_counter())
    out = {n: (library_path(n), 0.0) for n in SOURCES if n not in running}
    failed = []
    for name, (proc, tmp, t0) in running.items():
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(f"{name}: {err.strip()}")
        # atomic publish: a concurrent build never loads a half-written file
        tmp.replace(library_path(name))
        out[name] = (library_path(name), seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _load(name: str):
    if name not in _fns:
        lib = ctypes.CDLL(str(build()[name][0]))
        if name == "deform_fwd":
            fn = lib.jspsr_deform_fwd
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[name] = fn
        else:
            fn = lib.jspsr_deform_bwd
            fn.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            threads = lib.jspsr_deform_bwd_threads
            threads.argtypes = []
            threads.restype = ctypes.c_int
            _fns[name] = (fn, threads())
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


def deform_bwd(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
               mask: torch.Tensor, grad_out: torch.Tensor,
               padding: int = 1):
    """Launch the backward kernel (no input gradient) on CUDA tensors:
    x (B,1,H,W), offset (B,18,H,W), weight (1,1,3,3), mask (B,9,H,W),
    grad_out (B,1,H,W). Returns ``(d_offset, d_mask, d_weight, d_bias)``;
    d_weight is the kernel's per-block partials summed here, d_bias the
    sum of ``grad_out``."""
    _check({"x": x, "offset": offset, "weight": weight, "mask": mask,
            "grad_out": grad_out}, x)
    if grad_out.shape != x.shape:
        raise ValueError(f"grad_out must be {tuple(x.shape)}, got "
                         f"{tuple(grad_out.shape)}")
    b, _, h, w = x.shape
    fn, threads = _load("deform_bwd")
    d_offset = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    blocks = -(-b * h * w // threads)
    partial = torch.empty(blocks, TAPS, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                weight.data_ptr(), grad_out.data_ptr(), d_offset.data_ptr(),
                d_mask.data_ptr(), partial.data_ptr(), b, h, w, int(padding),
                stream)
    if rc != 0:
        raise RuntimeError(f"deform_bwd launch failed: cudaError {rc}")
    LAUNCHES["deform_bwd"] += 1
    d_weight = partial.sum(0).view_as(weight)
    return d_offset, d_mask, d_weight, grad_out.sum().view(1)
