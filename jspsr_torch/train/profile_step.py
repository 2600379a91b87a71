#!/usr/bin/env python3
"""Where the time of one train step of the PyTorch port goes, on one CUDA
card.

    python -m jspsr_torch.train.profile_step [--batch 50] [--side 128]
                                             [--steps 10]

Builds the flagship JSPSR of configs/jspsr_r8_img_msk.yml (3 branches,
num_feature 32, num_block 2) with seeded random weights, its criterion
(L1 + L2 + 0.1 Grad) and AdamW, fp32 with TF32 off, and a resident batch
of random tiles on the card. Then:

- times ``--steps`` warm train steps with the host clock around a
  ``torch.cuda.synchronize()`` (ms/step, tiles/s) and reads the peak
  device memory of one step;
- traces the forward (with the loss), the backward and the optimizer
  step of three warm steps with ``torch.profiler``, each phase in a trace
  of its own, and prints the device time per step by phase and kernel
  group (convolutions, BatchNorm, elementwise, K1, K2, ...), the top
  kernels, and the device's idle share of three whole traced steps (one
  minus the union of kernel intervals over the wall time).

In the backward, cuDNN kernels named ``dgrad`` / ``wgrad`` are the data
and weight gradients; its GEMM and FFT kernels serve either and are
counted as 'conv backward, gemm/fft'. cuDNN runs a transposed
convolution's forward as a dgrad kernel, so the decoder's three
``ConvTranspose2d`` forwards count as 'conv' in the forward phase. Prints
one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from jspsr_torch.config.loader import AttrDict
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.factory import build_model
from jspsr_torch.ops import deform_cuda
from jspsr_torch.train.optim import build_optimizer
from jspsr_torch.train.step import make_train_step
from jspsr_torch.utils.device import set_strict_fp32

CONV_KEYS = ("conv", "xmma", "gemm", "cutlass", "sm80", "sm90", "winograd",
             "fft", "implicit", "region_transform", "DSE::")
GROUPS = (  # first match wins; names are CUDA kernel names
    ("K1 deform_fwd", ("deform_fwd",)),
    ("K2 deform_bwd", ("deform_bwd",)),
    ("optimizer (foreach AdamW)", ("multi_tensor_apply",)),
    ("conv wgrad", ("wgrad",)),
    ("conv dgrad", ("dgrad",)),
    ("batchnorm", ("bn_", "batch_norm", "batchnorm")),
    ("conv", CONV_KEYS),
    ("memcpy/memset", ("Memcpy", "Memset")),
    ("concat/copy", ("cat", "copy", "Copy")),
    ("reduce", ("reduce", "Reduce")),
)


def group_of(name: str, phase: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            if phase == "forward" and group in ("conv dgrad", "conv wgrad"):
                return "conv"  # a transposed conv's forward
            if phase == "backward" and group == "conv":
                return "conv backward, gemm/fft"
            return group
    return "elementwise/other"


def _kernels(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_ms(kernels) -> float:
    """Union of the kernels' device intervals, in ms."""
    spans = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def flagship_config() -> AttrDict:
    """The model, loss and optimizer keys of configs/jspsr_r8_img_msk.yml."""
    return AttrDict({
        "model_name": "JSPSR", "seed": 0,
        "input_data": {"lr_dem": 1, "image": 3, "mask": 15},
        "model_kwargs": {"num_block": 2, "num_feature": 32},
        "loss": {"L1": 1, "L2": 1, "Grad": 0.1},
        "optimizer": "AdamW",
        "optimizer_kwargs": {"lr": 0.001, "weight_decay": 0.000001,
                             "momentum": 0.9, "diff_lr": False},
    })


def random_batch(b: int, side: int, dev, seed: int = 0):
    """A train batch in [0, 1] as the loader makes it: DEM, RGB, a one-hot
    15-class mask scaled by (i+1)/16, and the target DEM."""
    rng = np.random.default_rng(seed)
    dem = rng.uniform(0.3, 0.7, (b, 1, side, side))
    img = rng.uniform(0, 1, (b, 3, side, side))
    cls = rng.integers(0, 15, (b, side, side))
    mask = (np.arange(15)[None, :, None, None] == cls[:, None]) \
        * (np.arange(1, 16)[None, :, None, None] / 16.0)
    gt = dem + rng.normal(0, 0.01, dem.shape)
    return ([torch.from_numpy(a.astype(np.float32)).to(dev)
             for a in (dem, img, mask)],
            torch.from_numpy(gt.astype(np.float32)).to(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    set_strict_fp32()
    p = flagship_config()
    model = build_model(p).to(dev)
    optimizer = build_optimizer(p, model)
    step = make_train_step(model, build_criterion(dict(p.loss)), optimizer)
    inputs, gt = random_batch(args.batch, args.side, dev)

    for _ in range(3):  # warm-up: cuDNN algorithms, optimizer state
        step(inputs, gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        losses = step(inputs, gt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    step_ms = float(np.median(times))

    traced = 3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    criterion = build_criterion(dict(p.loss))
    phases = {ph: defaultdict(float)
              for ph in ("forward", "backward", "optimizer")}
    kernels = defaultdict(float)
    deform_cuda.reset_launches()
    model.train()
    for _ in range(traced):
        optimizer.zero_grad(set_to_none=True)
        with torch.profiler.profile(activities=acts) as prof:
            total = criterion(model(inputs), gt)["Total"]
            torch.cuda.synchronize()
        traces = [("forward", prof)]
        with torch.profiler.profile(activities=acts) as prof:
            total.backward()
            torch.cuda.synchronize()
        traces.append(("backward", prof))
        with torch.profiler.profile(activities=acts) as prof:
            optimizer.step()
            torch.cuda.synchronize()
        traces.append(("optimizer", prof))
        for phase, pr in traces:
            for k in _kernels(pr):
                us = k.time_range.elapsed_us()
                phases[phase][group_of(k.name, phase)] += us / 1e3 / traced
                kernels[k.name] += us / 1e3 / traced
    launches = dict(deform_cuda.LAUNCHES)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            step(inputs, gt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(_kernels(prof))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "card": card, "batch": args.batch, "side": args.side,
        "step_ms_median": step_ms, "step_ms_all": times,
        "tiles_per_s": args.batch / step_ms * 1e3, "peak_mb": peak_mb,
        "loss": float(losses["Total"]), "traced_steps": traced,
        "phase_ms_per_step": {ph: sum(g.values())
                              for ph, g in phases.items()},
        "device_ms_per_step": {ph: dict(sorted(g.items(),
                                               key=lambda kv: -kv[1]))
                               for ph, g in phases.items()},
        "launches_in_phase_traces": launches,
        "whole_step_wall_ms": wall_ms / traced,
        "whole_step_busy_ms": busy / traced,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top_kernels_ms_per_step": [[n[:100], v] for n, v in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
