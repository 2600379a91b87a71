"""Build the port's CUDA kernels with ``nvcc`` (sm_90a).

Each source in ``SOURCES`` is compiled at first use into a shared library of
its own with a plain C entry point, loaded with ``ctypes`` by its wrapper
module (``ops/deform_cuda.py``, ``ops/conv_same.py``). ``build`` starts one
``nvcc`` per source, all at once. Nothing is built when this module is
imported, so it imports on a host without CUDA. Every library's file name
carries a hash of the flags and of every file under ``csrc/`` (``*.cu``
and the headers they share, ``*.cuh``), so an edited source or header is
rebuilt and a stale build is never loaded.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"deform_fwd": CSRC / "deform_fwd.cu",
           "deform_bwd": CSRC / "deform_bwd.cu",
           "conv_same_bf16": CSRC / "conv_same_bf16.cu",
           "conv_same_f32": CSRC / "conv_same_f32.cu"}
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (torch CUDA_HOME is None); "
                           "nvcc is needed to build the port's kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def sources() -> list:
    """Every kernel source and shared header under ``CSRC``, by name."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")],
                  key=lambda p: p.name)


def library_path(name: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
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


def build_source(name: str, text: str) -> Path:
    """A shared library built with ``nvcc`` (``NVCC_FLAGS``) from the CUDA
    source ``text``, under ``BUILD_DIR`` and a name that hashes the text;
    built once. For the measurement scripts' kernels built on the fly."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode() + text.encode())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(text)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       check=True)
        tmp.replace(lib)
    return lib


def sass_atomics(lib: Path) -> dict:
    """The atomic instructions in the machine code (SASS) of the library
    ``lib``, by kernel: ``{kernel: {opcode: count}}`` for every opcode that
    starts with ``ATOM`` or ``RED`` (``ATOMS.ADD`` a native shared add,
    ``ATOMS.CAST.SPIN*`` the compare-and-swap of a loop), read with the
    toolkit's ``cuobjdump -sass``."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            out[kernel] = {}
            continue
        if kernel is None or "*/" not in line:
            continue
        # "/*0a10*/  @P0 ATOMS.ADD RZ, [R3], R4 ;  /* 0x... */"
        words = line.split("*/", 1)[1].strip().split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words and words[0].startswith(("ATOM", "RED")):
            out[kernel][words[0]] = out[kernel].get(words[0], 0) + 1
    return out
