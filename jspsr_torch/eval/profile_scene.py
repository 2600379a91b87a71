#!/usr/bin/env python3
"""Where the time of one whole-scene ``--infer`` goes in the PyTorch port,
on one CUDA card.

    python -m jspsr_torch.eval.profile_scene [--config <yml>]
                                             [--sides 334 1024] [--reps 5]

Builds the flagship JSPSR (configs/jspsr_r8_img_msk.yml widths: 3
branches, num_feature 32, num_block 2), or the model of ``--config`` (any
shipped config, e.g. configs/lrru_r8_img.yml or configs/edsr_r8_img.yml,
at its widths), with seeded random weights, then for each scene side:

- times ``run_scene_inference`` end to end (raster read, pad, normalize,
  host->device, forward, device->host, descale, write) and the forward
  alone (``upscale_dem``'s CUDA-synchronised latency), warm, best of
  ``--reps``;
- traces one warm ``upscale_dem`` with ``torch.profiler`` and prints the
  device time by kernel group, the top kernels, the host->device copies
  (made before the forward's timer starts) and the device's idle share of
  the forward's wall time (1 - kernel time / forward time).

Prints one JSON line per side. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.config.loader import AttrDict, create_config
from jspsr_torch.data.raster_io import write_raster
from jspsr_torch.eval.inference import (
    load_scene,
    make_forward,
    run_scene_inference,
    upscale_dem,
)
from jspsr_torch.models.factory import build_model
from jspsr_torch.utils.device import set_strict_fp32

GROUPS = (  # first match wins; names are CUDA kernel names
    ("deform_fwd", ("deform_fwd",)),
    ("batchnorm (cuDNN eval)", ("bn_fw",)),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "gemm", "implicit", "winograd",
                      "fft", "dgrad", "sm90", "cutlass")),
    ("memcpy", ("Memcpy", "Memset")),
    ("concat/copy", ("cat", "copy", "Copy")),
    ("reduce", ("reduce", "Reduce", "max", "mean")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise/other"


def flagship_config() -> AttrDict:
    """The serving keys of configs/jspsr_r8_img_msk.yml at its widths."""
    return AttrDict({
        "model_name": "JSPSR", "relative": True, "patch_size": 128,
        "input_data": {"lr_dem": 1, "image": 3, "mask": 15},
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_kwargs": {"num_block": 2, "num_feature": 32},
    })


def write_scene(root: Path, side: int, rng) -> Path:
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    dem = 150 + 120 * np.sin(4 * np.pi * xx) * np.cos(3 * np.pi * yy) + 60 * xx
    scene = root / f"scene_{side}"
    write_raster(scene / "COP30" / "dem.npy",
                 dem.astype(np.float32)[..., None])
    write_raster(scene / "BDORTHO" / "ortho.npy",
                 rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
    write_raster(scene / "UA2012" / "ua.npy", np.eye(15, dtype=np.uint8)[
        rng.integers(0, 15, (side, side))])
    return scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="default: the flagship JSPSR's serving keys")
    ap.add_argument("--sides", type=int, nargs="+", default=[334, 1024])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scene: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    set_strict_fp32()
    p = flagship_config() if args.config is None \
        else create_config(args.config)
    model = build_model(p, generator=torch.Generator().manual_seed(0)).to(dev)
    fwd = make_forward(model)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="jspsr_profile_") as tmp:
        for side in args.sides:
            scene = write_scene(Path(tmp), side, rng)
            sample, _ = load_scene(scene, p)
            for _ in range(2):  # warm-up: cuDNN handles and algorithms
                upscale_dem(fwd, sample, p, dev)
            e2e = []
            for i in range(args.reps):
                t0 = time.perf_counter()
                _, fwd_ms, peak = run_scene_inference(
                    model, p, scene, Path(tmp) / f"out_{side}_{i}.npy",
                    device=dev)
                e2e.append(((time.perf_counter() - t0) * 1e3, fwd_ms))
            best_e2e, best_fwd = min(e2e)[0], min(f for _, f in e2e)

            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                _, traced_ms, _ = upscale_dem(fwd, sample, p, dev)
            by_group = defaultdict(float)
            kernels = defaultdict(float)
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    us = evt.time_range.elapsed_us()
                    by_group[group_of(evt.name)] += us
                    kernels[evt.name] += us
            busy_ms = sum(v for k, v in by_group.items()
                          if k != "memcpy") / 1e3
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
            print(json.dumps({
                "side": side, "card": torch.cuda.get_device_name(0),
                "model": p.model_name,
                "end_to_end_ms": best_e2e, "forward_ms": best_fwd,
                "peak_mb": peak, "traced_forward_ms": traced_ms,
                "kernel_busy_ms": busy_ms,
                "device_idle_share": max(0.0, 1.0 - busy_ms / traced_ms),
                "device_ms_by_group": {k: v / 1e3 for k, v in sorted(
                    by_group.items(), key=lambda kv: -kv[1])},
                "top_kernels_ms": [[n[:90], v / 1e3] for n, v in top],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
