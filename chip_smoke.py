#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jspsr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), CUDA
   version; TF32 off for cuDNN and matmul (fp32 means fp32);
2. build: compile every kernel of the served path from the sources in the
   checkout (``nvcc`` for sm_90a);
3. kernel check: each kernel against its plain PyTorch version on the card
   at the main path's shapes (rtol = atol = 1e-5: the same fp32
   arithmetic, only the order of the 9-term sum differs), timed with CUDA
   events (median of 25 runs, L2 flushed before each) beside its plain
   version, a PyTorch library call that computes the same function, and
   its bound on this card;
4. serving: the flagship JSPSR (configs/jspsr_r8_img_msk.yml: lr_dem +
   RGB + 15-channel mask, num_feature 32, num_block 2) at full width with
   seeded random weights and non-trivial BatchNorm statistics, serving a
   directory of five scenes (4 x 334^2, 1 x 1024^2) through the port's
   CLI (``--infer``), with the kernel launch counts read around that run;
   then one 334^2 scene on the card against the port on the CPU
   (rtol 1e-4 / atol 2e-5, the JAX suite's whole-model tolerance).

It prints a ``{"kernels": [...]}`` line and a ``{"serving": ...}`` line,
and ends with ``{"ok": true, "device": {...}}``. Without CUDA it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from jspsr_torch.cli.main import main as cli_main
from jspsr_torch.config.loader import create_config
from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.eval.inference import load_scene, make_forward, upscale_dem
from jspsr_torch.models.factory import build_model
from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.deform_conv import _positions, deform_conv2d_plain
from jspsr_torch.train.checkpoint import load_model_params
from jspsr_torch.utils.device import set_strict_fp32

# Published peaks (NVIDIA data sheets; dense, at the full power limit):
# device-memory bytes/s and fp32 FLOP/s outside the tensor cores.
CARDS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),  # SXM, "NVIDIA H100 80GB HBM3"
    "H200": (4.8e12, 67e12),
}

KERNEL_SHAPES = [(1, 336, 336), (1, 1024, 1024), (16, 128, 128)]
OFFSET_SCALES = (0.0, 1.5, 20.0)
TIMED_SCALE = 1.5
SCENES = [("scene_0", 334), ("scene_1", 334), ("scene_2", 334),
          ("scene_3", 334), ("scene_4", 1024)]


def card_peaks(name: str):
    for key, peaks in CARDS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no published peaks for card {name!r}")


def time_ms(fn, flush: torch.Tensor, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), with
    the L2 cache flushed before each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def deform_library(x, offset, weight, bias, mask):
    """The same function as one ``grid_sample`` call (bilinear, zero
    padding, align_corners=True puts pixel centres on integer positions)
    plus the mask-weight reduction: a yardstick, never called by the port."""
    b, _, h, w = x.shape
    py, px = _positions(offset, 1)  # (B, 9, H, W)
    grid = torch.stack([px * (2.0 / (w - 1)) - 1.0,
                        py * (2.0 / (h - 1)) - 1.0], dim=-1)
    val = F.grid_sample(x, grid.view(b, 9 * h, w, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return (val.view(b, 9, h, w) * mask * weight.view(1, 9, 1, 1)).sum(
        1, keepdim=True) + bias


def deform_inputs(b, h, w, scale, gen, dev):
    x = torch.rand(b, 1, h, w, generator=gen, device=dev)
    offset = torch.randn(b, 18, h, w, generator=gen, device=dev) * scale
    aff = torch.rand(b, 9, h, w, generator=gen, device=dev)
    mask = aff - aff.mean(dim=1, keepdim=True)  # zero-sum, signed
    weight = torch.randn(1, 1, 3, 3, generator=gen, device=dev)
    bias = torch.randn(1, generator=gen, device=dev)
    return x, offset, weight, bias, mask


def check_deform_kernel(dev, bandwidth, fp32_peak):
    """K1 against its plain version at the main path's shapes; returns one
    row per shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    rows = []
    for b, h, w in KERNEL_SHAPES:
        row = {"shape": [b, 1, h, w], "max_abs_err": 0.0}
        for scale in OFFSET_SCALES:
            args = deform_inputs(b, h, w, scale, gen, dev)
            with torch.inference_mode():
                got = deform_cuda.deform_fwd(*args)
                ref = deform_conv2d_plain(*args)
                lib = deform_library(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5):
                raise AssertionError(
                    f"deform_fwd disagrees with its plain version at "
                    f"{(b, h, w)} offset scale {scale}: max |err| {err}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row.setdefault("library_max_abs_err", 0.0)
            row["library_max_abs_err"] = max(
                row["library_max_abs_err"], (lib - ref).abs().max().item())
            if scale == TIMED_SCALE:
                with torch.inference_mode():
                    row["kernel_ms"] = time_ms(
                        lambda: deform_cuda.deform_fwd(*args), flush)
                    row["plain_ms"] = time_ms(
                        lambda: deform_conv2d_plain(*args), flush)
                    row["library_ms"] = time_ms(
                        lambda: deform_library(*args), flush)
        pixels = b * h * w
        # each input read once, the output written once: x 4 B, offset
        # 72 B, mask 36 B, out 4 B per pixel; weight and bias 40 B
        nbytes = pixels * (4 + 72 + 36 + 4) + 40
        flops = pixels * 150  # ~17 fp32 operations per tap, 9 taps
        bytes_ms, ops_ms = nbytes / bandwidth * 1e3, flops / fp32_peak * 1e3
        row["bound_ms"] = max(bytes_ms, ops_ms)
        row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        rows.append(row)
        print(f"deform_fwd {row}", flush=True)
    return rows


def write_scenes(root: Path, seed: int = 0):
    """Smooth synthetic terrain in metres, a 0-255 RGB orthophoto and a
    15-channel one-hot land-use mask per scene, as .npy rasters in the
    DFC30 subdirectory layout."""
    rng = np.random.default_rng(seed)
    for name, side in SCENES:
        yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
        fx, fy, ph = rng.uniform(2, 6, 3)
        dem = (150 + 120 * np.sin(fx * np.pi * xx + ph)
               * np.cos(fy * np.pi * yy) + 60 * xx
               + rng.normal(0, 0.5, (side, side)))
        img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
        mask = np.eye(15, dtype=np.uint8)[rng.integers(0, 15, (side, side))]
        scene = root / name
        write_raster(scene / "COP30" / "dem.npy", dem.astype(np.float32)[..., None])
        write_raster(scene / "BDORTHO" / "ortho.npy", img)
        write_raster(scene / "UA2012" / "ua.npy", mask)


def flagship_config(ckpt: Path) -> dict:
    """The serving keys of configs/jspsr_r8_img_msk.yml."""
    return {
        "name": "chip_smoke_jspsr_r8_img_msk", "dataset": "DFC30",
        "resolution": 8, "input_data": {"COP30": 1, "image": 3, "mask": 15},
        "relative": True, "patch_size": 128,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_name": "JSPSR",
        "model_kwargs": {"num_block": 2, "num_feature": 32,
                         "checkpoint": str(ckpt)},
        "optimizer_kwargs": {"lr": 0.001}, "metric": {},
    }


def serve(work: Path, dev: torch.device):
    """The main path: the port's CLI over a directory of scenes."""
    ckpt = work / "jspsr_flagship.pt"
    cfg_path = work / "jspsr_r8_img_msk.json"
    cfg_path.write_text(json.dumps(flagship_config(ckpt)))
    p = create_config(cfg_path)
    model = build_model(p, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    torch.save(model.state_dict(), ckpt)
    n_params = sum(t.numel() for t in model.parameters())
    print(f"flagship JSPSR: {n_params} parameters", flush=True)
    write_scenes(work / "scenes")

    out_dir, res_dir = work / "out", work / "result"
    real_stdout = sys.stdout
    deform_cuda.LAUNCHES = 0
    try:
        paths = cli_main(["--config", str(cfg_path), "--infer",
                          str(work / "scenes"), "--out", str(out_dir),
                          "--result-dir", str(res_dir)])
    finally:
        logger, sys.stdout = sys.stdout, real_stdout
        if logger is not real_stdout:
            logger.close()
    launches = {"deform_fwd": deform_cuda.LAUNCHES}
    print(f"main-path launches: {launches}", flush=True)
    if launches["deform_fwd"] != len(SCENES):
        raise AssertionError(f"deform_fwd launched {launches['deform_fwd']} "
                             f"times for {len(SCENES)} scenes")

    if len(paths) != len(SCENES):
        raise AssertionError(f"{len(paths)} rasters for {len(SCENES)} scenes")
    for path, (name, side) in zip(paths, SCENES):
        arr = read_raster(path)
        dem = read_raster(work / "scenes" / name / "COP30" / "dem.npy")
        if arr.shape != (side, side, 1) or not np.isfinite(arr).all():
            raise AssertionError(f"{path}: shape {arr.shape}, finite "
                                 f"{np.isfinite(arr).all()}")
        # metres: the refined DEM stays within the input's elevation range
        lo, hi = float(dem.min()), float(dem.max())
        if not (lo - 50 < float(arr.mean()) < hi + 50):
            raise AssertionError(f"{path}: mean {arr.mean()} outside the "
                                 f"input's range [{lo}, {hi}] m")

    log = (res_dir / "train.log").read_text()
    per_scene = {m[1]: {"ms": float(m[2]), "peak_mb": float(m[3])}
                 for m in re.finditer(r"Scene (\S+): ([\d.]+) ms, peak ([\d.]+) MB",
                                      log)}
    total = re.search(r"Inference: \d+ scenes -> .* \(([\d.]+) ms, ([\d.]+) "
                      r"scenes/s\)", log)

    # warm re-runs of each scene size (not counted): steady latency
    fwd_gpu = make_forward(load_model_params(build_model(p), ckpt).to(dev))
    warm = {}
    for name, side in (SCENES[0], SCENES[-1]):
        sample, _ = load_scene(work / "scenes" / name, p)
        warm[f"{side}x{side}"] = min(upscale_dem(fwd_gpu, sample, p, dev)[1]
                                     for _ in range(3))

    # one 334^2 scene: the card against the port on the CPU
    sample, _ = load_scene(work / "scenes" / SCENES[0][0], p)
    got = upscale_dem(fwd_gpu, sample, p, dev)[0]
    fwd_cpu = make_forward(load_model_params(build_model(p), ckpt))
    ref = upscale_dem(fwd_cpu, sample, p, "cpu")[0]
    err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5,
                               err_msg="card vs CPU, 334^2 scene")
    return {
        "scenes": [f"{s}x{s}" for _, s in SCENES],
        "per_scene": per_scene,
        "total_ms": float(total[1]), "scenes_per_s": float(total[2]),
        "warm_ms": warm, "cpu_max_abs_err": err,
    }, launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card")
    dev = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}",
          flush=True)
    set_strict_fp32()
    card, (bandwidth, fp32_peak) = card_peaks(kind)

    # 2. build every kernel of the path
    t0 = time.perf_counter()
    lib, nvcc_s = deform_cuda.build(verbose=True)
    print(f"built {lib.name}: nvcc {nvcc_s:.2f} s, total "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernel against its plain version
    rows = check_deform_kernel(dev, bandwidth, fp32_peak)

    # 4. serving through the CLI
    with tempfile.TemporaryDirectory(prefix="jspsr_chip_smoke_") as tmp:
        serving, launches = serve(Path(tmp), dev)
    serving["peak_source"] = "torch.cuda.max_memory_allocated per scene"
    serving["card"] = card

    main_row = next(r for r in rows if r["shape"] == [1, 1, 1024, 1024])
    kernels = [{
        "name": "deform_fwd", "route": "cuda",
        "source": "jspsr_torch/ops/csrc/deform_fwd.cu",
        "replaces": "jspsr_tpu/ops/pallas_deform.py:108",
        "tpu_kernel": "jspsr_tpu/ops/pallas_deform.py::_fwd_kernel",
        "launches": launches["deform_fwd"],
        "shape": main_row["shape"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,
    }]
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
