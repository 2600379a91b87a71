#!/usr/bin/env python3
"""Where the time of one train step of the PyTorch port goes, on one CUDA
card.

    python -m jspsr_torch.train.profile_step [--config <yml>] [--batch N]
                                             [--side 128] [--steps 10]

Builds the model, criterion and optimizer of a config (by default the
flagship JSPSR of configs/jspsr_r8_img_msk.yml; any shipped config of the
four families: configs/edsr_r8_img.yml and configs/lrru_r8_img.yml train at
batch 70) with seeded random weights, fp32 with TF32 off, and a resident
batch of random tiles on the card in the model's input order
(``data.loader.build_batch_inputs``), of the config's train batch size
unless ``--batch`` is given. Then:

- times ``--steps`` warm train steps with the host clock around a
  ``torch.cuda.synchronize()`` (ms/step, tiles/s) and reads the peak
  device memory of one step;
- traces the forward (with the loss), the backward and the optimizer
  step of three warm steps with ``torch.profiler``, each phase in a trace
  of its own, and prints the device time per step by phase and kernel
  group (convolutions, BatchNorm, elementwise, K1, K2, K3, ...), the
  device time of the kernels that matmul ops launched (the Linear layers
  and attention of a transformer), the top kernels, and the device's idle
  share of three whole traced steps (one minus the union of kernel
  intervals over the wall time) and of the untraced steps (one minus the
  traced busy time over the untraced step time).

In the backward, cuDNN kernels named ``dgrad`` / ``wgrad`` are the data
and weight gradients; its GEMM and FFT kernels serve either and are
counted as 'conv backward, gemm/fft'. cuDNN runs a transposed
convolution's forward as a dgrad kernel, so the decoder's three
``ConvTranspose2d`` forwards count as 'conv' in the forward phase. A GEMM
kernel's name does not say whether cuDNN or a matmul launched it, so the
groups count every GEMM as 'conv'; ``matmul_ms_per_step`` gives the share
that matmul ops launched, from the CPU op each kernel ran under. K2 and K3
are the two instances of one templated kernel, told apart by their
template argument. Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.config.loader import create_config
from jspsr_torch.data.loader import build_batch_inputs, input_kinds
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.factory import build_model
from jspsr_torch.ops import deform_cuda
from jspsr_torch.train.optim import build_optimizer
from jspsr_torch.train.step import fill_unreached_grads, make_train_step
from jspsr_torch.utils.device import set_strict_fp32

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" \
    / "jspsr_r8_img_msk.yml"
CONV_KEYS = ("conv", "xmma", "gemm", "cutlass", "sm80", "sm90", "winograd",
             "fft", "implicit", "region_transform", "DSE::")
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
GROUPS = (  # first match wins; names are CUDA kernel names
    ("K1 deform_fwd", ("deform_fwd",)),
    ("K3 deform_bwd_dx", ("deform_bwd_dx_kernel", "dx_bounds_kernel",
                          "dx_fixed_to_float_kernel")),
    ("K2 deform_bwd", ("deform_bwd",)),
    ("optimizer (foreach AdamW)", ("multi_tensor_apply",)),
    ("conv wgrad", ("wgrad",)),
    ("conv dgrad", ("dgrad",)),
    ("batchnorm", ("bn_", "batch_norm", "batchnorm")),
    ("layernorm", ("layer_norm", "LayerNorm")),
    ("softmax", ("softmax", "Softmax")),
    ("bilinear resize", ("upsample_bilinear",)),
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
    """The trace's kernels and copies on the device. User annotations are
    left out: the profiler also puts spans such as ``Optimizer.step#...``
    on the device timeline, and counting them would add their whole
    length, gaps included, to the device time."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def matmul_ms(prof) -> float:
    """Device time, in ms, of the kernels that matmul ops launched."""
    total = 0.0
    for e in prof.key_averages():
        if e.key in MATMUL_OPS:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3


def busy_ms(kernels) -> float:
    """Union of the kernels' device intervals, in ms."""
    spans = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def random_batch(p, b: int, side: int, dev, seed: int = 0):
    """A train batch in [0, 1] as the loader makes it, in the model's input
    order (``build_batch_inputs``): DEM, RGB, a one-hot mask with class i
    scaled by (i+1)/(n+1), uniform canopy / coordinate channels, and the
    target DEM; NCHW on ``dev``."""
    rng = np.random.default_rng(seed)
    dem = rng.uniform(0.3, 0.7, (b, side, side, 1))
    batch = {"lr_dem": dem, "hr_dem": dem + rng.normal(0, 0.01, dem.shape)}
    for kind in input_kinds(p.input_data)[1:]:
        n = int(p.input_data[kind])
        if kind == "mask":
            cls = rng.integers(0, n, (b, side, side))
            batch[kind] = (np.arange(n) == cls[..., None]) \
                * ((np.arange(n) + 1) / (n + 1))
        else:
            batch[kind] = rng.uniform(0, 1, (b, side, side, n))
    inputs, gt, _, _ = build_batch_inputs(batch, p.model_name, p.input_data)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(0, 3, 1, 2), np.float32)).to(dev)

    return [nchw(a) for a in inputs], nchw(gt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=str(DEFAULT_CONFIG))
    ap.add_argument("--batch", type=int, default=None,
                    help="default: the config's train_batch_size")
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
    p = create_config(args.config)
    batch = args.batch or p.train_batch_size
    model = build_model(p).to(dev)
    optimizer = build_optimizer(p, model)
    generator = torch.Generator(dev).manual_seed(int(p.get("seed") or 0))
    step = make_train_step(model, build_criterion(dict(p.loss)), optimizer,
                           generator=generator)
    inputs, gt = random_batch(p, batch, args.side, dev)

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
    matmuls = defaultdict(float)
    deform_cuda.reset_launches()
    model.train()
    for _ in range(traced):
        optimizer.zero_grad(set_to_none=True)
        with torch.profiler.profile(activities=acts) as prof:
            total = criterion(model(inputs, generator=generator),
                              gt)["Total"]
            torch.cuda.synchronize()
        traces = [("forward", prof)]
        with torch.profiler.profile(activities=acts) as prof:
            total.backward()
            fill_unreached_grads(model.parameters())
            torch.cuda.synchronize()
        traces.append(("backward", prof))
        with torch.profiler.profile(activities=acts) as prof:
            optimizer.step()
            torch.cuda.synchronize()
        traces.append(("optimizer", prof))
        for phase, pr in traces:
            matmuls[phase] += matmul_ms(pr) / traced
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
        "card": card, "config": args.config, "model": p.model_name,
        "parameters": sum(q.numel() for q in model.parameters()),
        "batch": batch, "side": args.side,
        "step_ms_median": step_ms, "step_ms_all": times,
        "tiles_per_s": batch / step_ms * 1e3, "peak_mb": peak_mb,
        "loss": float(losses["Total"]), "traced_steps": traced,
        "phase_ms_per_step": {ph: sum(g.values())
                              for ph, g in phases.items()},
        "device_ms_per_step": {ph: dict(sorted(g.items(),
                                               key=lambda kv: -kv[1]))
                               for ph, g in phases.items()},
        "matmul_ms_per_step": dict(matmuls),
        "launches_in_phase_traces": launches,
        "whole_step_wall_ms": wall_ms / traced,
        "whole_step_busy_ms": busy / traced,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "device_idle_share_untraced": max(0.0, 1.0 - busy / traced
                                          / step_ms),
        "top_kernels_ms_per_step": [[n[:100], v] for n, v in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
