#!/usr/bin/env python3
"""Device time of each hand-written kernel alone, apart from the work its
wrapper launches around it.

    python -m jspsr_torch.scripts.profile_kernels

``chip_smoke.py`` times a whole wrapper call: for K2 and K3 that includes
the d_x zero fill and the d_weight and d_bias reductions, for K1 the
output's allocation, for K4 nothing else. This script runs each wrapper
20 times at its main shapes (K1 at 16 x 128² and 1 x 1024², K2 at 50 x
128², K3 at 16 x 128², offsets of 1.5 px; K4 at the TPU probe's four
cases, beside cuDNN's ``F.conv2d``), the L2 cache flushed before each
call, under ``torch.profiler``, and prints the card's name and power limit
and then one JSON line per case: the mean device µs per call of every
kernel that ran, the flush's left out. Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.conv_same import conv_same
from jspsr_torch.scripts import bench_conv_same as bench
from jspsr_torch.utils.device import resolve_device, set_strict_fp32

CALLS = 20


def _totals(prof) -> dict:
    return {e.key: getattr(e, "self_device_time_total", 0.0)
            for e in prof.key_averages()}


def device_us(fn, flush: torch.Tensor) -> dict:
    """Mean device µs per call of ``fn``, by kernel name. The flush is a
    negation, an op no wrapper launches, so its kernel can be left out by
    name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush.neg_()
        torch.cuda.synchronize()
    flush_keys = set(_totals(prof))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            flush.neg_()
            fn()
        torch.cuda.synchronize()
    return {k: t / CALLS for k, t in _totals(prof).items()
            if t > 0 and k not in flush_keys}


def deform_case(b, h, w, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(b, 1, h, w, generator=gen, device=dev)
    offset = torch.randn(b, 18, h, w, generator=gen, device=dev) * 1.5
    aff = torch.rand(b, 9, h, w, generator=gen, device=dev)
    mask = aff - aff.mean(dim=1, keepdim=True)
    weight = torch.randn(1, 1, 3, 3, generator=gen, device=dev)
    g = torch.randn(b, 1, h, w, generator=gen, device=dev)
    return x, offset, weight, mask, g


def main(argv=None) -> list:
    del argv
    dev = resolve_device(None)
    set_strict_fp32()
    print(bench.card_line(), flush=True)
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    rows = []
    for shape in ((16, 128, 128), (1, 1024, 1024)):
        x, offset, weight, mask, _ = deform_case(*shape, dev)
        bias = torch.zeros(1, device=dev)
        with torch.inference_mode():
            us = device_us(lambda: deform_cuda.deform_fwd(
                x, offset, weight, bias, mask), flush)
        rows.append({"kernel": "deform_fwd", "shape": list(shape),
                     "device_us": us})
    for name, shape in (("deform_bwd", (50, 128, 128)),
                        ("deform_bwd_dx", (16, 128, 128))):
        args = deform_case(*shape, dev)
        fn = getattr(deform_cuda, name)
        rows.append({"kernel": name, "shape": list(shape),
                     "device_us": device_us(lambda: fn(*args), flush)})
    for tag, b, h, w, cin, cout, kk, dt in bench.CASES:
        x, w1, _ = bench.case_inputs(b, h, w, cin, cout, kk, dt, dev)
        w_oihw = bench.oihw(w1)
        rows.append({"kernel": "conv_same", "case": tag,
                     "device_us": device_us(lambda: conv_same(x, w1), flush),
                     "cudnn_device_us": device_us(
                         lambda: bench.cudnn_conv(x, w_oihw), flush)})
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
