#!/usr/bin/env python3
"""Probe: does the hand-written im2col-free conv (K4, ``ops/conv_same.py``)
beat cuDNN at the narrow 64-channel full-resolution shapes?

    python -m jspsr_torch.scripts.bench_conv_same

The port of ``scripts/bench_pallas_conv.py``, which asked the same of a
Pallas kernel against XLA's conv on a TPU. Its four cases (16 x 128^2 at
64->64 in bf16 and fp32, 32->64 and 64->32 in bf16), then for each:

1. numerics first: ``conv_same`` against the fp32 ``F.conv2d`` of the
   same (bf16-valued) inputs, TF32 off, at the probe's tolerances (max
   |err| <= 0.03 in bf16, 1e-4 in fp32, times max(1, max |reference|));
2. chained timing as the probe does it: each iteration feeds
   tanh(1x1 conv(conv(s))) back in, 30 iterations, 2 warm-up, best of 3
   trials on the host clock after a synchronise; the reference chain runs
   cuDNN's ``F.conv2d`` on a channels-last view of the same NHWC bytes in
   place of ``xla_conv``, and both chains use cuDNN for the 1x1 back
   projection.

Prints the card's name and power limit (``nvidia-smi``), then one JSON line
per case, which repeats them. The probe's decision rule stands: an
op-level win below about 1.3x does not ship, and none is wired into a model
layer here (the JAX models do not use the Pallas kernel either). Needs a
CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from jspsr_torch.ops.conv_same import conv_same
from jspsr_torch.utils.device import resolve_device, set_strict_fp32

# (tag, B, H, W, Cin, Cout, kk, dtype), scripts/bench_pallas_conv.py:118-124
CASES = [
    ("stage1_64ch_bf16", 16, 128, 128, 64, 64, 3, torch.bfloat16),
    ("stage1_64ch_fp32", 16, 128, 128, 64, 64, 3, torch.float32),
    ("gen_32to64_bf16", 16, 128, 128, 32, 64, 3, torch.bfloat16),
    ("gen_64to32_bf16", 16, 128, 128, 64, 32, 3, torch.bfloat16),
]
TOL = {torch.bfloat16: 0.03, torch.float32: 1e-4}


def cudnn_conv(x: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
    """'Same' conv of NHWC ``x`` by cuDNN, through the channels-last NCHW
    view of the same bytes; returns the NHWC view of its output."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw,
                 padding=w_oihw.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights as channels-last OIHW, the layout cuDNN takes with a
    channels-last input."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def case_inputs(b, h, w, cin, cout, kk, dtype, device, seed=0):
    """The probe's inputs: x ~ N(0, 1), w1 ~ N(0, 0.05), the 1x1 back
    projection wb ~ N(0, 0.05), drawn in float32 and cast."""
    rng = np.random.default_rng(seed)

    def draw(scale, shape):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    return (draw(1.0, (b, h, w, cin)), draw(0.05, (kk, kk, cin, cout)),
            draw(0.05, (1, 1, cout, cin)))


def check_numerics(x, w1) -> dict:
    """``conv_same`` against the fp32 cuDNN conv at the probe's tolerance."""
    ref = cudnn_conv(x.float(), oihw(w1.float()))
    got = conv_same(x, w1).float()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = TOL[x.dtype]
    if not err <= tol * max(scale, 1.0):
        raise AssertionError(f"conv_same {tuple(x.shape)} {x.dtype}: max "
                             f"|err| {err} > {tol} x max(1, {scale})")
    return {"max_abs_err": err, "ref_max_abs": scale, "tol": tol}


def timed(fn, x0, iters: int = 30, trials: int = 3, warmup: int = 2) -> float:
    """Best ms per iteration of the chain s -> fn(s), synchronised."""
    s = x0
    for _ in range(warmup):
        s = fn(s)
    torch.cuda.synchronize()
    best = None
    for _ in range(trials):
        s0 = s
        t0 = time.perf_counter()
        for _ in range(iters):
            s0 = fn(s0)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0) / iters
        best = ms if best is None else min(best, ms)
    return best


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> list:
    del argv
    dev = resolve_device(None)
    set_strict_fp32()
    card = card_line()
    print(card, flush=True)
    rows = []
    for tag, b, h, w, cin, cout, kk, dt in CASES:
        x, w1, wb = case_inputs(b, h, w, cin, cout, kk, dt, dev)
        row = {"case": tag, "shape": [b, h, w, cin, cout, kk],
               "dtype": str(dt).replace("torch.", ""), "card": card}
        row.update(check_numerics(x, w1))
        w1_oihw, wb_oihw = oihw(w1), oihw(wb)

        def chain(conv):
            return lambda s: torch.tanh(cudnn_conv(conv(s), wb_oihw))

        flops = 2 * b * h * w * kk * kk * cin * cout
        row["cudnn_ms"] = timed(chain(lambda s: cudnn_conv(s, w1_oihw)), x)
        row["kernel_ms"] = timed(
            chain(lambda s: conv_same(s.contiguous(), w1)), x)
        for k in ("cudnn", "kernel"):
            row[f"{k}_tflops"] = flops / row[f"{k}_ms"] / 1e9
        row["kernel_speedup"] = row["cudnn_ms"] / row["kernel_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
