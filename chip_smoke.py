#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jspsr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), CUDA
   version; TF32 off for cuDNN and matmul (fp32 means fp32);
2. build: compile every kernel of the served and trained paths from the
   sources in the checkout, one ``nvcc`` per source, all at once (sm_90a),
   printing each one's ``-Xptxas -v`` report (registers, spills);
3. kernel check, forward (K1): against its plain PyTorch version on the
   card at the main paths' shapes (rtol = atol = 1e-5: the same fp32
   arithmetic, only the order of the 9-term sum differs), timed with CUDA
   events (median of 25 runs, L2 flushed before each) beside its plain
   version, a PyTorch library call that computes the same function, and
   its bound on this card;
3b. kernel check, backward (K2): against its plain backward at the train
   batch (50 x 128^2), 16 x 128^2 and one 334^2 scene, offsets at 0, 1.5
   and 20 px; d_offset and d_mask at rtol = atol = 1e-5 (the same fp32
   arithmetic per element); the batch-summed d_weight within 1e-5 of the
   sum of its terms' magnitudes (it sums B*H*W terms in another order);
   timed as K1, the library yardstick being autograd's backward through
   the ``grid_sample`` form;
4. serving: the flagship JSPSR (configs/jspsr_r8_img_msk.yml: lr_dem +
   RGB + 15-channel mask, num_feature 32, num_block 2) at full width with
   seeded random weights and non-trivial BatchNorm statistics, serving a
   directory of five scenes (4 x 334^2, 1 x 1024^2) through the port's
   CLI (``--infer``), with the kernel launch counts read around that run;
   then one 334^2 scene on the card against the port on the CPU
   (rtol 1e-4 / atol 2e-5, the JAX suite's whole-model tolerance);
5. training: the same config, read from configs/jspsr_r8_img_msk.yml, on
   a synthetic DFC30 tree with its 13 train cities (12 samples of 128^2
   each, the 8 m DFC30 sample size, which the config's tile crop keeps
   whole: 3 steps of batch 50 per epoch, flip/rot90 augmentation) and its
   3 valid cities, through
   ``Trainer(p, device="cuda").train_one_epoch`` for epochs 0 and 1, with
   the launch counts read around that run (exactly one K1 and one K2 per
   step); then one full-width train step on 4 x 128^2 on the card against
   the port on the CPU, and both against the CPU in float64, from the same
   weights and batch: the loss within rtol 1e-4 of the CPU's; every
   gradient and BatchNorm running statistic no further (relative L2) from
   float64 than three times the CPU fp32 run's distance plus 5e-3 (the
   step is ill-conditioned in fp32 at init, see ``CARD_FP64_FLOOR``); the
   largest errors are printed.

It prints a ``{"serving": ...}``, a ``{"training": ...}`` and a
``{"kernels": [...]}`` line, and ends with ``{"ok": true, "device":
{...}}``. Without CUDA it exits non-zero before printing any result.
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
from jspsr_torch.data.synthetic import generate_city, generate_mini_dfc30
from jspsr_torch.eval.inference import load_scene, make_forward, upscale_dem
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.factory import build_model
from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.deform_conv import (
    _positions,
    deform_conv2d_backward_plain,
    deform_conv2d_plain,
)
from jspsr_torch.train.checkpoint import load_model_params
from jspsr_torch.train.optim import build_optimizer
from jspsr_torch.train.profile_step import random_batch
from jspsr_torch.train.step import make_train_step
from jspsr_torch.train.trainer import Trainer
from jspsr_torch.utils.device import set_strict_fp32

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "configs" / "jspsr_r8_img_msk.yml"

# Published peaks (NVIDIA data sheets; dense, at the full power limit):
# device-memory bytes/s and fp32 FLOP/s outside the tensor cores.
CARDS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),  # SXM, "NVIDIA H100 80GB HBM3"
    "H200": (4.8e12, 67e12),
}

KERNEL_SHAPES = [(1, 336, 336), (1, 1024, 1024), (16, 128, 128),
                 (50, 128, 128)]
BWD_SHAPES = [(50, 128, 128), (16, 128, 128), (1, 336, 336)]
OFFSET_SCALES = (0.0, 1.5, 20.0)
TIMED_SCALE = 1.5
SCENES = [("scene_0", 334), ("scene_1", 334), ("scene_2", 334),
          ("scene_3", 334), ("scene_4", 1024)]
TRAIN_SCENES_PER_CITY = 12  # x 13 cities = 156 samples: 3 steps of 50
TRAIN_SIDE = 128  # an 8 m DFC30 sample
# One train step, per tensor (relative L2): the card's distance from
# float64 may be three times the CPU fp32 run's, plus this floor. At init
# the step is ill-conditioned in fp32 (the CPU's own fp32 gradients are up
# to 2 % from float64); cuDNN picks other conv algorithms than the CPU
# (FFT among them); and the SPN kernel's 9 weight gradients are sums of
# B*H*W signed terms that cancel.
CARD_FP64_FLOOR = 5e-3


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


def check_deform_backward(dev, bandwidth, fp32_peak):
    """K2 against its plain backward at the train path's shapes; returns
    one row per shape."""
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 2**20, device=dev)
    rows = []
    for b, h, w in BWD_SHAPES:
        row = {"shape": [b, 1, h, w], "max_abs_err": 0.0,
               "d_weight_err_over_abs_sum": 0.0}
        for scale in OFFSET_SCALES:
            x, offset, weight, bias, mask = deform_inputs(b, h, w, scale, gen,
                                                          dev)
            g = torch.randn(b, 1, h, w, generator=gen, device=dev)
            got = deform_cuda.deform_bwd(x, offset, weight, mask, g)
            ref = deform_conv2d_backward_plain(x, offset, weight, mask, g)
            # |d_weight| <= this bound on the sum of the terms' magnitudes
            abs_sum = deform_conv2d_backward_plain(
                x.abs(), offset, weight, mask.abs(), g.abs())[2]
            torch.cuda.synchronize()
            for name, a, r in zip(("d_offset", "d_mask", "d_bias"),
                                  got[:2] + got[3:], ref[:2] + ref[3:]):
                if not torch.allclose(a, r, rtol=1e-5, atol=1e-5):
                    raise AssertionError(
                        f"deform_bwd {name} disagrees with the plain backward"
                        f" at {(b, h, w)} offset scale {scale}: max |err| "
                        f"{(a - r).abs().max().item()}")
            w_err = ((got[2] - ref[2]).abs() / abs_sum).max().item()
            if w_err > 1e-5:
                raise AssertionError(
                    f"deform_bwd d_weight at {(b, h, w)} offset scale "
                    f"{scale}: error {w_err} of the terms' magnitude sum")
            row["max_abs_err"] = max(
                row["max_abs_err"], (got[0] - ref[0]).abs().max().item(),
                (got[1] - ref[1]).abs().max().item())
            row["d_weight_err_over_abs_sum"] = max(
                row["d_weight_err_over_abs_sum"], w_err)
            if scale == TIMED_SCALE:
                row["kernel_ms"] = time_ms(lambda: deform_cuda.deform_bwd(
                    x, offset, weight, mask, g), flush)
                row["plain_ms"] = time_ms(
                    lambda: deform_conv2d_backward_plain(x, offset, weight,
                                                         mask, g), flush)
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (offset, weight, bias, mask)]
                out = deform_library(x, *leaves)
                row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True), flush)
                del out, leaves
        pixels = b * h * w
        # each input read once, each output written once: x 4 B, offset
        # 72 B, mask 36 B, g 4 B in; d_offset 72 B, d_mask 36 B out per
        # pixel; weight in and d_weight out 36 B each
        nbytes = pixels * (4 + 72 + 36 + 4 + 72 + 36) + 72
        flops = pixels * 315  # ~35 fp32 operations per tap, 9 taps
        bytes_ms, ops_ms = nbytes / bandwidth * 1e3, flops / fp32_peak * 1e3
        row["bound_ms"] = max(bytes_ms, ops_ms)
        row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        rows.append(row)
        print(f"deform_bwd {row}", flush=True)
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
    """The serving path: the port's CLI over a directory of scenes."""
    work.mkdir(parents=True, exist_ok=True)
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
    deform_cuda.reset_launches()
    try:
        paths = cli_main(["--config", str(cfg_path), "--infer",
                          str(work / "scenes"), "--out", str(out_dir),
                          "--result-dir", str(res_dir)])
    finally:
        logger, sys.stdout = sys.stdout, real_stdout
        if logger is not real_stdout:
            logger.close()
    launches = dict(deform_cuda.LAUNCHES)
    print(f"serving-path launches: {launches}", flush=True)
    if launches != {"deform_fwd": len(SCENES), "deform_bwd": 0}:
        raise AssertionError(f"launches {launches} for {len(SCENES)} scenes")

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


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 error of one tensor (absolute where ``ref`` is 0)."""
    diff = (got.double().cpu() - ref.double().cpu()).norm()
    return float(diff / max(float(ref.double().norm()), 1e-12))


def step_state(p, device, dtype, inputs, gt):
    """One full-width train step of the port from the config's seeded
    weights: (loss, {param: grad}, {BatchNorm buffer: value})."""
    model = build_model(p).to(device=device, dtype=dtype)
    step = make_train_step(model, build_criterion(dict(p.loss)),
                           build_optimizer(p, model))
    losses = step([x.to(device, dtype) for x in inputs], gt.to(device, dtype))
    return (float(losses["Total"]),
            {n: q.grad.cpu() for n, q in model.named_parameters()},
            {n: b.cpu() for n, b in model.named_buffers() if "running" in n})


def compare_train_step(p, dev):
    """One train step on 4 x 128^2 on the card against the port on the CPU,
    both against float64 on the CPU: the loss, every gradient and the
    BatchNorm running statistics. Returns the errors, the largest (by the
    card's distance from float64) first."""
    inputs, gt = random_batch(4, 128, "cpu", seed=3)
    card = step_state(p, dev, torch.float32, inputs, gt)
    cpu = step_state(p, "cpu", torch.float32, inputs, gt)
    f64 = step_state(p, "cpu", torch.float64, inputs, gt)
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    if loss_err > 1e-4:
        raise AssertionError(f"train-step loss: card {card[0]} vs CPU "
                             f"{cpu[0]}")
    out = {"loss_rel_err": loss_err}
    for i, what in ((1, "grad"), (2, "bn")):
        rows = []
        for name, ref in f64[i].items():
            e_card = _rel_err(card[i][name], ref)
            e_fp32 = _rel_err(cpu[i][name], ref)
            rows.append((e_card, e_fp32, _rel_err(card[i][name],
                                                  cpu[i][name]), name))
            if e_card > CARD_FP64_FLOOR + 3 * e_fp32:
                raise AssertionError(
                    f"train-step {what} {name}: card vs fp64 {e_card}, CPU "
                    f"fp32 vs fp64 {e_fp32}")
        rows.sort(reverse=True)
        out[what] = {
            "tensors": len(rows),
            "card_vs_fp64_max": rows[0][0],
            "card_vs_fp64_median": statistics.median(r[0] for r in rows),
            "cpu_fp32_vs_fp64_max": max(r[1] for r in rows),
            "card_vs_cpu_max": max(r[2] for r in rows),
            "largest": [{"name": n, "card_vs_fp64": a, "cpu_fp32_vs_fp64": b,
                         "card_vs_cpu": c} for a, b, c, n in rows[:4]],
        }
    return out


def train(work: Path, dev: torch.device):
    """The training path: the flagship config through the port's Trainer
    for two epochs on a synthetic DFC30 tree."""
    p = create_config(FLAGSHIP)
    root = work / "DFC30_8m"
    t0 = time.perf_counter()
    generate_mini_dfc30(root, train_cities=p.train_set, valid_cities=(),
                        n_per_city=TRAIN_SCENES_PER_CITY, size=TRAIN_SIDE)
    for city in p.valid_set:
        generate_city(root, city, 1, size=TRAIN_SIDE)
    data_s = time.perf_counter() - t0
    p.dataset_path = str(root)

    trainer = Trainer(p, result_dir=work / "train", device=dev)
    inner, steps = trainer.train_step, []

    def timed_step(inputs, gt):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = inner(inputs, gt)
        end.record()
        steps.append((start, end, losses["Total"]))
        return losses

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats(dev)
    deform_cuda.reset_launches()
    epochs = []
    for epoch in (0, 1):
        loss, lr = trainer.train_one_epoch(epoch)
        epochs.append({"epoch": epoch, "loss": loss, "lr": lr,
                       "tiles_per_s": trainer.last_throughput})
    torch.cuda.synchronize()
    launches = dict(deform_cuda.LAUNCHES)
    n_steps = len(steps)
    print(f"training-path launches: {launches} in {n_steps} steps",
          flush=True)
    if n_steps < 6 or launches != {"deform_fwd": n_steps,
                                   "deform_bwd": n_steps}:
        raise AssertionError(f"launches {launches} for {n_steps} steps")
    step_losses = [float(t) for _, _, t in steps]
    if not all(np.isfinite(step_losses + [e["loss"] for e in epochs])):
        raise AssertionError(f"non-finite loss: {step_losses} {epochs}")
    step_ms = [s.elapsed_time(e) for s, e, _ in steps]
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    n_params = sum(q.numel() for q in trainer.model.parameters())
    batch = p.train_batch_size
    del trainer

    errs = compare_train_step(p, dev)
    return {
        "config": str(FLAGSHIP.relative_to(REPO)), "parameters": n_params,
        "batch": batch, "patch": p.patch_size,
        "train_samples": len(p.train_set) * TRAIN_SCENES_PER_CITY,
        "data_gen_s": data_s, "steps": n_steps, "step_losses": step_losses,
        "step_ms": step_ms,
        "step_ms_warm_median": statistics.median(step_ms[1:]),
        "tiles_per_s_warm": batch / statistics.median(step_ms[1:]) * 1e3,
        "epochs": epochs, "peak_mb": peak_mb,
        "peak_source": "torch.cuda.max_memory_allocated over both epochs",
        "launches": launches, "card_vs_cpu_step": errs,
    }, launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

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

    # 2. build every kernel of the paths, one nvcc per source, together
    t0 = time.perf_counter()
    built = deform_cuda.build(verbose=True)
    for name, (lib, nvcc_s) in built.items():
        print(f"built {lib.name}: nvcc {nvcc_s:.2f} s", flush=True)
    print(f"build total {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. each kernel against its plain version
    fwd_rows = check_deform_kernel(dev, bandwidth, fp32_peak)
    bwd_rows = check_deform_backward(dev, bandwidth, fp32_peak)

    with tempfile.TemporaryDirectory(prefix="jspsr_chip_smoke_") as tmp:
        # 4. serving through the CLI
        serving, serve_launches = serve(Path(tmp) / "serve", dev)
        serving["peak_source"] = "torch.cuda.max_memory_allocated per scene"
        serving["card"] = card
        # 5. training through the Trainer
        training, train_launches = train(Path(tmp) / "train", dev)
        training["card"] = card

    def kernel_line(name, source, replaces, tpu_kernel, rows, main_shape):
        main = next(r for r in rows if r["shape"] == main_shape)
        by_path = {"serving": serve_launches[name],
                   "training": train_launches[name]}
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape": main["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": rows,
        }

    kernels = [
        kernel_line("deform_fwd", "jspsr_torch/ops/csrc/deform_fwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:108",
                    "jspsr_tpu/ops/pallas_deform.py::_fwd_kernel", fwd_rows,
                    [1, 1, 1024, 1024]),
        kernel_line("deform_bwd", "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=False)", bwd_rows, [50, 1, 128, 128]),
    ]
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
