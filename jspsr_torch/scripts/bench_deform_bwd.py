#!/usr/bin/env python3
"""K2, the deform backward without the input gradient
(``deform_cuda.deform_bwd``), timed on the card at the main paths' shapes.

    python -m jspsr_torch.scripts.bench_deform_bwd [--reps N] [--shapes L,..]

For each shape of ``SHAPES`` (the 50, 70, 25 and 16 x 128^2 train batches:
the flagship's, EDSR+SPN's and LRRU's, a data-parallel rank's,
CompletionFormer's; one 334^2 scene; the row slabs 2 x 64 x 128 and 25 x
64 x 128 of 128^2 images, image rows 64-127, a spatially sharded rank's)
in the fp32 and the bf16-sampling mode, offsets of 1.5 px: the wrapper's
device time (``time_ms``: median of 25, the L2 flushed before each call),
the bound on this card (``k2_bound``), autograd's backward through the
``grid_sample`` form of the same function (fp32), the read-write ceiling
(the device time of a kernel that does nothing but read the pixels' x,
their 18 offset, 9 mask and 1 gradient planes once, 16 bytes a thread,
and write 27 planes, which is what K2's bytes allow), and the device
kernels of one call, counted and timed by ``torch.profiler`` (every
kernel, memset and copy the call puts on the card: the kernel's own time
beside the wrapper's); then the wrapper's host time per call
(1,000 calls at 1 x 128^2, no synchronise between them). Prints the card's
name and power limit and one JSON line per shape and mode, then one for
the host time.

It uses only ``deform_bwd`` and the plain helpers of the package (and
``bench_deform_fwd``'s timing), so a copy of this file placed in an
earlier checkout's ``jspsr_torch/scripts/`` times that checkout's K2 the
same way; run the two in turns in one call to compare them.
``chip_smoke.py`` takes ``k2_bound`` from here, and runs
``kernels_per_call`` in a process of its own.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from jspsr_torch.ops import deform_cuda
from jspsr_torch.scripts.bench_deform_fwd import (
    HOST_SHAPE,
    TIMED_SCALE,
    card_line,
    card_peaks,
    deform_inputs,
    deform_library,
    host_us,
    time_ms,
)
from jspsr_torch.utils.device import resolve_device, set_strict_fp32

# label -> (batch, image side, slab rows, y0): the whole image where the
# slab rows are the side
SHAPES = {"50x128": (50, 128, 128, 0), "70x128": (70, 128, 128, 0),
          "25x128": (25, 128, 128, 0), "16x128": (16, 128, 128, 0),
          "1x334": (1, 334, 334, 0), "slab_2x64of128": (2, 128, 64, 64),
          "slab_25x64of128": (25, 128, 64, 64)}
MODES = {"fp32": None, "bf16": "bfloat16"}
PROFILED_CALLS = 5


def k2_bound(b, h, w, bandwidth, fp32_peak):
    """K2's least time on this card, ms, and what sets it, for ``b`` x
    ``h`` x ``w`` output pixels (a row slab's own): each input read once,
    each output written once: x 4 B, offset 72 B, mask 36 B, g 4 B in;
    d_offset 72 B, d_mask 36 B out per pixel; weight in and d_weight out
    36 B each; about 35 fp32 operations per tap, 9 taps."""
    pixels = b * h * w
    nbytes = pixels * (4 + 72 + 36 + 4 + 72 + 36) + 72
    bytes_ms = nbytes / bandwidth * 1e3
    ops_ms = pixels * 315 / fp32_peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def device_profile(fn, calls: int = PROFILED_CALLS) -> dict:
    """The device work of one call of ``fn``, by name: every kernel, memset
    and copy that ``torch.profiler`` records on the card over ``calls``
    calls (after one untraced call), as ``{name: (count, device µs)}`` per
    call. Run it in a process of its own: in one that had run a process
    group and other profiler runs, the events came back without their
    device."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            n, us = out.get(event.name, (0, 0.0))
            us += getattr(event, "device_time_total", 0.0)
            out[event.name] = (n + 1, us)
    return {name: (n / calls, us / calls)
            for name, (n, us) in sorted(out.items())}


def device_kernels(fn, calls: int = PROFILED_CALLS) -> dict:
    """``device_profile``'s counts alone: ``{name: count}`` per call."""
    return {name: n for name, (n, _) in device_profile(fn, calls).items()}


def kernels_per_call(specs) -> list:
    """K2's device kernels per call (``device_kernels``) for each of
    ``specs``, ``[batch, image side, slab rows, y0, sample dtype]``, on
    fresh inputs (``bwd_inputs``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    out = []
    for b, side, hs, y0, sample_dtype in specs:
        x, offset, weight, _, mask, g = bwd_inputs(b, side, hs, y0, gen, dev)
        out.append(device_kernels(lambda: deform_cuda.deform_bwd(
            x, offset, weight, mask, g, sample_dtype=sample_dtype, y0=y0)))
    return out


# The read-write ceiling's kernel: per thread, 4 pixels of x, their 18
# offset, 9 mask and 1 gradient planes as 16-byte loads, all in flight
# together, then 27 planes written from them.
CEILING_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) read_write_planes(
    const float4* __restrict__ x, const float4* __restrict__ off,
    const float4* __restrict__ msk, const float4* __restrict__ g,
    float4* __restrict__ doff, float4* __restrict__ dmsk, int64_t n4,
    int64_t hw4, int64_t xhw4, int64_t x0) {
  const int64_t i = blockIdx.x * int64_t{256} + threadIdx.x;
  if (i >= n4) return;
  const int64_t b = i / hw4, p = i - b * hw4;
  float4 v[29];
  v[27] = __ldg(x + b * xhw4 + x0 + p);
  v[28] = __ldg(g + i);
#pragma unroll
  for (int k = 0; k < 18; ++k) v[k] = __ldg(off + (b * 18 + k) * hw4 + p);
#pragma unroll
  for (int k = 0; k < 9; ++k) v[18 + k] = __ldg(msk + (b * 9 + k) * hw4 + p);
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const float4 a = v[k], c = k < 18 ? v[28] : v[27];
    const float4 o = make_float4(a.x * c.x, a.y * c.y, a.z * c.z, a.w * c.w);
    if (k < 18) doff[(b * 18 + k) * hw4 + p] = o;
    else dmsk[(b * 9 + k - 18) * hw4 + p] = o;
  }
}
extern "C" int read_write_planes_launch(
    const void* x, const void* off, const void* msk, const void* g,
    void* doff, void* dmsk, int64_t n4, int64_t hw4, int64_t xhw4,
    int64_t x0, void* stream) {
  const int64_t blocks = (n4 + 255) / 256;
  read_write_planes<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float4*)off, (const float4*)msk,
      (const float4*)g, (float4*)doff, (float4*)dmsk, n4, hw4, xhw4, x0);
  return (int)cudaGetLastError();
}
"""


def read_write_ceiling():
    """The read-write ceiling's launcher, ``fn(x, offset, mask, g, d_offset,
    d_mask, y0)`` (offset, mask and g a slab of x's image from row ``y0``):
    its kernel built with ``nvcc`` for sm_90a into the port's build
    directory. A plane is read as one run of floats, so it takes any
    shape whose image, slab and slab origin are whole 16-byte groups."""
    import ctypes

    from jspsr_torch.ops import cuda_build

    lib_path = cuda_build.build_source("read_write_ceiling", CEILING_SRC)
    fn = ctypes.CDLL(str(lib_path)).read_write_planes_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(x, offset, mask, g, d_offset, d_mask, y0=0):
        b, _, hs, w = offset.shape
        if (hs * w) % 4 or (x.shape[2] * w) % 4 or (y0 * w) % 4:
            raise ValueError("the read-write ceiling takes whole 16-byte "
                             "groups per plane")
        rc = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                g.data_ptr(), d_offset.data_ptr(), d_mask.data_ptr(),
                b * hs * w // 4, hs * w // 4, x.shape[2] * w // 4,
                y0 * w // 4, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"read-write ceiling launch failed: "
                               f"cudaError {rc}")

    return launch


def bwd_inputs(b, side, hs, y0, gen, dev):
    """K2's inputs at offsets of TIMED_SCALE: x the whole image, the rest
    the slab of ``hs`` rows from image row ``y0`` (contiguous)."""
    x, offset, weight, bias, mask = deform_inputs(b, side, side, TIMED_SCALE,
                                                  gen, dev)
    g = torch.randn(b, 1, side, side, generator=gen, device=dev)
    rows = slice(y0, y0 + hs)
    offset, mask, g = (t[:, :, rows].contiguous() for t in (offset, mask, g))
    return x, offset, weight, bias, mask, g


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated labels of SHAPES")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    set_strict_fp32()
    card = card_line()
    print(card, flush=True)
    _, (bandwidth, fp32_peak, _) = card_peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    ceiling = read_write_ceiling()
    rows = []
    for label in args.shapes.split(","):
        b, side, hs, y0 = SHAPES[label]
        x, offset, weight, bias, mask, g = bwd_inputs(b, side, hs, y0, gen,
                                                      dev)
        bound = k2_bound(b, hs, side, bandwidth, fp32_peak)
        d_offset, d_mask = torch.empty_like(offset), torch.empty_like(mask)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (offset, weight, bias, mask)]
        out = deform_library(x, *leaves, y0)
        library_ms = time_ms(lambda: torch.autograd.grad(
            out, leaves, g, retain_graph=True), flush, reps=args.reps)
        del out, leaves
        ceiling_ms = time_ms(lambda: ceiling(x, offset, mask, g, d_offset,
                                             d_mask, y0), flush,
                             reps=args.reps)
        for mode, sample_dtype in MODES.items():
            def call():
                return deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                              sample_dtype=sample_dtype,
                                              y0=y0)

            row = {"shape": [b, 1, hs, side], "image": [b, 1, side, side],
                   "y0": y0, "mode": mode, "card": card,
                   "kernel_ms": time_ms(call, flush, reps=args.reps),
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "library_ms": library_ms,
                   "read_write_ceiling_ms": ceiling_ms}
            row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
            row["kernel_over_ceiling"] = row["kernel_ms"] / ceiling_ms
            work = device_profile(call)
            row["kernels_per_call"] = {k: n for k, (n, _) in work.items()}
            row["device_us_per_call"] = {k: us for k, (_, us) in
                                         work.items()}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x, offset, mask, g, d_offset, d_mask
    b, h, w = HOST_SHAPE
    x, offset, weight, _, mask, g = bwd_inputs(b, h, h, 0, gen, dev)
    host = {"host_us_per_call": host_us(lambda: deform_cuda.deform_bwd(
                x, offset, weight, mask, g)),
            "shape": [b, 1, h, w], "calls": 1000, "card": card}
    rows.append(host)
    print(json.dumps(host), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
