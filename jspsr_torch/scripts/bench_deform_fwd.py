#!/usr/bin/env python3
"""K1, the deform forward (``deform_cuda.deform_fwd``), timed on the card
at the main paths' shapes.

    python -m jspsr_torch.scripts.bench_deform_fwd [--reps N]

For each shape of ``KERNEL_SHAPES`` (whole JSPSR scenes of 336^2 and
1024^2, the 16, 50 and 70 x 128^2 train batches, a 352^2 CompletionFormer
scene, the tiled server's chunks of 72, 81 and 28 x 128^2), offsets of
1.5 px: the wrapper's device time (``time_ms``: median of 25, the L2
flushed before each call), one ``grid_sample`` call computing the same
function, the bound on this card, and the read ceiling: the device time of
a kernel that does nothing but read the same x, offset and mask once (16
bytes a thread, all of a thread's 28 loads in flight together) and write
one float per pixel, which is what this layout of the bytes allows; then
the wrapper's host time per call (1,000 calls at 1 x 128^2, no
synchronise between them). Prints the card's name and power limit and one
JSON line per shape, then one for the host time.

It uses only ``deform_fwd`` and ``ops.deform_conv._positions`` of the
package, so a copy of this file placed in an earlier checkout's
``jspsr_torch/scripts/`` times that checkout's K1 the same way; run the
two in turns in one call to compare them. ``chip_smoke.py`` takes its
timing and yardstick functions from here. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.deform_conv import _positions
from jspsr_torch.utils.device import resolve_device, set_strict_fp32

# Published peaks (NVIDIA data sheets; dense, at the full power limit):
# device-memory bytes/s, fp32 FLOP/s outside the tensor cores, and bf16
# FLOP/s on the tensor cores.
CARDS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),  # SXM, "NVIDIA H100 80GB HBM3"
    "H200": (4.8e12, 67e12, 989e12),
}

# K1's shapes on the main paths: whole scenes, the train batches, the
# CompletionFormer scene, and the tiled server's chunks of 128^2 tiles
# (8 x 334^2 in one run, one 1024^2 scene, the 500 x 700 scene)
KERNEL_SHAPES = [(1, 336, 336), (1, 1024, 1024), (16, 128, 128),
                 (50, 128, 128), (70, 128, 128), (1, 352, 352),
                 (72, 128, 128), (81, 128, 128), (28, 128, 128)]
TIMED_SCALE = 1.5
HOST_SHAPE, HOST_CALLS = (1, 128, 128), 1000
# A spin on the card between the L2 flush and the start event, long enough
# (about 0.5 ms) for the host to enqueue a whole wrapper call behind it.
SPIN_CYCLES = 1_000_000


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def card_peaks(name: str):
    for key, peaks in CARDS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no published peaks for card {name!r}")


def time_ms(fn, flush: torch.Tensor, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), with
    the L2 cache flushed before each run. The spin keeps the card busy
    while the host enqueues ``fn``, so the time is the device's, also where
    the host takes longer to launch the call than the card to run it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """The host's µs per call of ``fn`` over ``calls`` calls, with no
    synchronise between them (at a shape whose device time is below the
    host's, so the launch queue never fills)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def deform_inputs(b, h, w, scale, gen, dev):
    x = torch.rand(b, 1, h, w, generator=gen, device=dev)
    offset = torch.randn(b, 18, h, w, generator=gen, device=dev) * scale
    aff = torch.rand(b, 9, h, w, generator=gen, device=dev)
    mask = aff - aff.mean(dim=1, keepdim=True)  # zero-sum, signed
    weight = torch.randn(1, 1, 3, 3, generator=gen, device=dev)
    bias = torch.randn(1, generator=gen, device=dev)
    return x, offset, weight, bias, mask


def deform_library(x, offset, weight, bias, mask, y0: int = 0):
    """The same function as one ``grid_sample`` call (bilinear, zero
    padding, align_corners=True puts pixel centres on integer positions)
    plus the mask-weight reduction, on the row slab of ``offset`` and
    ``mask`` whose first row is image row ``y0``: a yardstick, never called
    by the port."""
    b, _, h, w = x.shape
    hs = offset.shape[2]
    py, px = _positions(offset, 1, y0)  # (B, 9, Hs, W)
    grid = torch.stack([px * (2.0 / (w - 1)) - 1.0,
                        py * (2.0 / (h - 1)) - 1.0], dim=-1)
    val = F.grid_sample(x, grid.view(b, 9 * hs, w, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return (val.view(b, 9, hs, w) * mask * weight.view(1, 9, 1, 1)).sum(
        1, keepdim=True) + bias


def k1_bound(b, h, w, bandwidth, fp32_peak):
    """K1's least time on this card, ms, and what sets it: each input read
    once, the output written once (x 4 B, offset 72 B, mask 36 B, out 4 B
    per pixel; weight and bias 40 B), against about 17 fp32 operations per
    tap, 9 taps."""
    pixels = b * h * w
    bytes_ms = (pixels * (4 + 72 + 36 + 4) + 40) / bandwidth * 1e3
    ops_ms = pixels * 150 / fp32_peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


# The read ceiling's kernel: per thread, 4 pixels of x, their 18 offset
# and 9 mask planes as 16-byte loads, summed into one output.
CEILING_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) read_planes(
    const float4* __restrict__ x, const float4* __restrict__ off,
    const float4* __restrict__ msk, float4* __restrict__ out, int64_t n4,
    int64_t hw4) {
  const int64_t i = blockIdx.x * int64_t{256} + threadIdx.x;
  if (i >= n4) return;
  const int64_t b = i / hw4, p = i - b * hw4;
  float4 v[28];
  v[27] = __ldg(x + i);
#pragma unroll
  for (int k = 0; k < 18; ++k) v[k] = __ldg(off + (b * 18 + k) * hw4 + p);
#pragma unroll
  for (int k = 0; k < 9; ++k) v[18 + k] = __ldg(msk + (b * 9 + k) * hw4 + p);
  float4 a = v[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    a.x += v[k].x; a.y += v[k].y; a.z += v[k].z; a.w += v[k].w;
  }
  out[i] = a;
}
extern "C" int read_planes_launch(const void* x, const void* off,
                                  const void* msk, void* out, int64_t n4,
                                  int64_t hw4, void* stream) {
  const int64_t blocks = (n4 + 255) / 256;
  read_planes<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float4*)off, (const float4*)msk,
      (float4*)out, n4, hw4);
  return (int)cudaGetLastError();
}
"""


def read_ceiling():
    """The read ceiling's launcher, ``fn(x, offset, mask, out)``: its
    kernel built with ``nvcc`` for sm_90a into the port's build directory.
    Takes W % 4 == 0."""
    import ctypes

    from jspsr_torch.ops import cuda_build

    lib_path = cuda_build.build_source("read_ceiling", CEILING_SRC)
    fn = ctypes.CDLL(str(lib_path)).read_planes_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(x, offset, mask, out):
        b, _, h, w = x.shape
        if w % 4:
            raise ValueError("the read ceiling takes W % 4 == 0")
        rc = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                out.data_ptr(), b * h * w // 4, h * w // 4,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"read ceiling launch failed: cudaError {rc}")

    return launch


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    set_strict_fp32()
    card = card_line()
    print(card, flush=True)
    _, (bandwidth, fp32_peak, _) = card_peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    fwd_path = getattr(deform_cuda, "fwd_path", None)
    ceiling = read_ceiling()
    rows = []
    for b, h, w in KERNEL_SHAPES:
        inputs = deform_inputs(b, h, w, TIMED_SCALE, gen, dev)
        with torch.inference_mode():
            row = {"shape": [b, 1, h, w], "card": card,
                   "kernel_ms": time_ms(lambda: deform_cuda.deform_fwd(
                       *inputs), flush, reps=args.reps),
                   "library_ms": time_ms(lambda: deform_library(*inputs),
                                         flush, reps=args.reps)}
            out = torch.empty_like(inputs[0])
            row["read_ceiling_ms"] = time_ms(lambda: ceiling(
                inputs[0], inputs[1], inputs[4], out), flush, reps=args.reps)
        row["bound_ms"], row["bound_by"] = k1_bound(b, h, w, bandwidth,
                                                    fp32_peak)
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        row["kernel_over_read_ceiling"] = (row["kernel_ms"]
                                           / row["read_ceiling_ms"])
        if fwd_path is not None:
            row["path"] = fwd_path(inputs[0], inputs[1], inputs[4])
        rows.append(row)
        print(json.dumps(row), flush=True)
        del inputs
    inputs = deform_inputs(*HOST_SHAPE, TIMED_SCALE, gen, dev)
    with torch.inference_mode():
        host = {"host_us_per_call": host_us(
                    lambda: deform_cuda.deform_fwd(*inputs)),
                "shape": [HOST_SHAPE[0], 1, *HOST_SHAPE[1:]],
                "calls": HOST_CALLS, "card": card}
    rows.append(host)
    print(json.dumps(host), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
