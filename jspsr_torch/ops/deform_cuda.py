"""Build, bind and launch the deformable-conv forward kernel
(``csrc/deform_fwd.cu``, replacing ``jspsr_tpu/ops/pallas_deform.py::
_fwd_kernel``).

The source is compiled with ``nvcc`` for ``sm_90a`` at first use into a
shared library with a plain C entry point, loaded with ``ctypes``. Nothing
is built or loaded when this module is imported, so it imports on a host
without CUDA. The library's file name carries a hash of the source, so an
edited source is rebuilt and a stale build is never loaded.

``LAUNCHES`` counts kernel launches (one per ``deform_fwd`` call); a run
resets it to show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "deform_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = 0

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (torch CUDA_HOME is None); "
                           "nvcc is needed to build the deform kernel")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdeform_fwd_{digest.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the kernel unless this source's library exists. Returns the
    library path and the seconds spent compiling (0.0 when cached)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    # atomic publish: concurrent builders never load a half-written file
    tmp.replace(lib)
    return lib, seconds


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        fn = lib.jspsr_deform_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def deform_fwd(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, mask: torch.Tensor,
               padding: int = 1) -> torch.Tensor:
    """Launch the kernel on CUDA tensors of the shapes that
    ``ops.deform_conv.check_deform_args`` admits; raises on anything else.

    Forward only: there is no backward kernel yet, so inputs that require
    grad under grad mode are refused (the serving path runs under
    ``torch.inference_mode``)."""
    global LAUNCHES
    tensors = {"x": x, "offset": offset, "weight": weight, "bias": bias,
               "mask": mask}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"deform kernel: {name} must be on {x.device} "
                             f"(CUDA), got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"deform kernel: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"deform kernel: {name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise RuntimeError("deform kernel has no backward yet: call it "
                           "under torch.inference_mode() or no_grad()")
    b, _, h, w = x.shape
    if h * w >= 2**31:
        raise ValueError(f"deform kernel: H*W={h * w} exceeds int32 indexing")
    out = torch.empty_like(x)
    fn = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                b, h, w, int(padding), stream)
    if rc != 0:
        raise RuntimeError(f"deform kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
