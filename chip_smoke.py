#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jspsr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), CUDA
   version; TF32 off for cuDNN and matmul (fp32 means fp32);
2. build: compile every kernel of the served and trained paths from the
   sources in the checkout, one ``nvcc`` per source, all at once (sm_90a),
   printing each one's ``-Xptxas -v`` report (registers, spills); the
   atomic instructions of each kernel of ``deform_bwd.cu``, read from its
   SASS (``cuda_build.sass_atomics``), asserting that none holds a
   compare-and-swap loop (``ATOMS.CAST.SPIN*``: K3's window adds 32-bit
   words, which sm_90a adds natively);
3. kernel check, forward (K1): against its plain PyTorch version on the
   card at the main paths' shapes (336^2 and 1024^2 JSPSR scenes, the
   50, 70 (EDSR, LRRU) and 16 x 128^2 train batches, a 352^2
   CompletionFormer scene, the
   tiled server's chunks of 72, 81 and 28 x 128^2), untimed at the eval
   loop's (each config's valid batch of 128^2 samples, phase 10), at the
   whole scenes of phases 11-12 as their models pad them (EDSR+SPN's 334^2,
   unpadded, and LRRU's 500 x 700 scene at 512 x 704) and at
   two shapes that its tile does not divide (2 x 13 x 20, and 1 x 333 x
   335, whose W % 4 != 0 takes the copy path in place of TMA), offsets at
   0, 1.5 and 20 px (rtol = atol = 1e-5: the same fp32
   arithmetic, only the order of the 9-term sum differs); at each, the
   share of corners read from the tile's shared-memory window and from
   global memory (``deform_cuda.fwd_window``); the main shapes timed with
   CUDA events (``bench_deform_fwd.time_ms``: median of 25 runs, L2
   flushed before each) beside its plain version, a PyTorch library call
   that computes the same function, and its bound on this card; then the
   wrapper's host µs per call (1,000 calls, no synchronise);
3b. kernel check, backward (K2): against its plain backward at the train
   batches (50 and 70 x 128^2), 16 x 128^2 and one 334^2 scene, offsets
   at 0, 1.5
   and 20 px; d_offset and d_mask at rtol = atol = 1e-5 (the same fp32
   arithmetic per element); the batch-summed d_weight within 1e-5 of the
   sum of its terms' magnitudes (it sums B*H*W terms in another order);
   timed as K1, the library yardstick being autograd's backward through
   the ``grid_sample`` form;
3c. kernel check, backward with the input gradient (K3): against its
   plain backward at the CompletionFormer train batch (16 x 128^2),
   2 x 128^2 and one 334^2 scene padded to 352^2, offsets at 0, 1.5 and
   20 px; d_offset and d_mask at rtol = atol = 1e-5; d_weight and d_x
   within 1e-5 of the sums of their terms' magnitudes (``DX_ERR_LIMIT``:
   d_weight sums in another order, d_x in fixed point), each shape's d_x
   error printed beside that limit; and against itself: two launches on
   the same inputs must give bit-equal d_x, d_offset, d_mask, d_weight
   and d_bias; then, at 20 px, a heavy-tailed g (``HEAVY_TAILS``: a few
   entries 10^4 and 10^6 times the rest, which set the fixed point's
   scale), d_x and d_weight within the same limit and bit-equal across
   two launches; timed as K2, the library yardstick being autograd's
   backward through the ``grid_sample`` form with ``x`` requiring grad,
   and, after phase 10, the device time of each of its three kernels (the
   bounds pass that sets the fixed point's scale, the scatter, the pass
   back to fp32) read by name from ``torch.profiler``
   (``profile_kernels.device_us``); where this run's d_x contributions go
   (``deform_cuda.dx_atomics``: into the block's shared-memory window, or
   global, and the window's flush) is counted at every offset scale and
   printed per shape beside the one global atomic per in-bounds corner
   that a scatter without the window sends;
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
   largest errors are printed; then one step at the train batch run twice
   from the same weights and batch: with cuDNN held to deterministic
   algorithms (the Trainer's ``set_deterministic_cudnn``) and K1 and K2
   free of atomics, every parameter and BatchNorm buffer must come out
   bit-equal; the warm step median is printed beside the one of a further
   epoch through the same Trainer with cuDNN free to choose
   non-deterministic algorithms (in every training phase);
6. CompletionFormer training: configs/completionformer_r8_img_msk.yml as
   it is (PVT backbone + NLSPN, 83,689,176 parameters, batch 16, drop
   path on) on the same synthetic tree (9 steps of 16 per epoch) through
   ``Trainer(p, device="cuda").train_one_epoch`` for epochs 0 and 1, with
   exactly 6 K1 and 6 K3 launches and no K2 per step (NLSPN's 6
   propagation steps on a feature that needs its gradient); then one train
   step at 2 x 128^2 held against the CPU and float64 by the same rule
   (the CBAM SpatialAttention convs' weight gradients at a wider floor,
   ``SA_CONV_FLOOR``), from the seeded weights with NLSPN's
   offset/affinity conv perturbed away from its zero init (which makes the
   propagation the identity); then one step run twice from one state, as
   in phase 5, which must come out bit-equal in all 783 parameters and
   buffers (K3 sums d_x in fixed point, the resizes' backward is two
   matrix products, NLSPN's confidence sampling differentiates through
   sorted indexing);
7. CompletionFormer serving: one 334^2 scene (padded to 352^2, the
   backbone's /32) through the CLI's ``--infer`` with a seeded checkpoint
   whose BatchNorm statistics and offset/affinity conv are perturbed:
   exactly 6 K1 launches, and the card against the CPU at rtol 1e-3 /
   atol 1e-4 (the JAX suite's CompletionFormer tolerance, for outputs in
   the scaled DEM's [0, 1]), atol times the output's largest magnitude
   (random weights put it above 1);
8. K4 kernel check: ``conv_same`` against ``conv_same_plain`` on the card
   at the TPU probe's four cases (16 x 128^2 at 64->64 in bf16 and fp32,
   32->64 and 64->32 in bf16), at the probe's tolerances (max |err| <=
   0.03 in bf16, 1e-4 in fp32, times max(1, max |plain|)), timed as K1
   beside the plain version, cuDNN's ``F.conv2d`` on the channels-last view
   of the same bytes and the bound, with the kernel's time over cuDNN's
   and both achieved TFLOP/s; then the probe's port
   (``jspsr_torch/scripts/bench_conv_same.py``) once, its launches counted
   on the path ``conv_probe``;
9. tiled serving: the flagship with phase 4's checkpoint through the CLI's
   ``--infer --tile``: (a) a directory of 8 x 334^2 scenes, (b) one of 2 x
   1024^2 scenes, each run twice through the pipelined server, (c) one
   500 x 700 scene (an exact grid down, a padded generalized grid across)
   on its own; K1 launches exactly the rule's count per run (the sum over
   scene groups of ceil(S * n / infer_tile_batch): 1, 2 and 1 with the
   defaults); every served raster against the same scene through
   ``tile_inference_device`` on the card at rtol 2e-4 / atol 5e-3 m (the
   JAX suite's tolerance between tile batch sizes, which change cuDNN's
   reduction order); one 334^2 scene and scene (c) on the card against the
   port on the CPU at rtol 1e-3 / atol 1e-2 m (test_torch_infer.py's
   rtol for metres); warm scenes/s, one 1024^2 scene's warm end-to-end ms
   through ``--tile`` against whole-scene (best of 5) and the peaks;
10. fit: the flagship config as it is but its epochs (300 -> 2, printed
   as a cut) on phase 5's tree (its 3 valid cities at 4 samples each)
   through ``Trainer(p, device="cuda").fit(initial_eval=True)``: the best
   checkpoint named with its RMSE, one raster per valid sample under
   ``predictions/``, ``summary.json`` and ``summary.csv``, one
   ``metrics.jsonl`` line per epoch, and exactly one K1 and one K2 per
   step plus one K1 per sample of each of the 4 eval passes; then --val
   through the port's CLI on that checkpoint (its scores equal to the
   final eval's at rtol 1e-5), the checkpoint evaluated by the port on
   the CPU (rtol 1e-4, the JAX package's reload tolerance); then the
   resume gate for the flagship and for CompletionFormer: a fit of 2
   epochs against a fit of 1 whose checkpoint a new Trainer resumes to
   epoch 2, their last parameters and buffers, best result and epoch
   losses bit-equal; each epoch's and each eval pass's seconds;
11. EDSR: configs/edsr_r8_img.yml (16 blocks x 64, batch 70) as shipped
   and with ``spn: true``, each trained one epoch (``CUT_EPOCHS``) on
   phase 5's tree
   through the Trainer (no K1/K2 launch as shipped; one K1 and one K2 per
   step with the head), its step against the CPU and float64 and twice
   from one state (bit-equal), as in phase 5; then a seeded checkpoint of
   each served through the CLI's ``--infer`` over phase 4's directory
   (K1 once per scene with the head) and ``--infer --tile`` over phase
   9's 8 x 334^2 (K1 once per chunk with the head), the card against the
   CPU in float64 (``hold_to_float64``: the tolerance plus three times the
   CPU fp32 run's distance from float64) at rtol 1e-4 / atol 2e-5 (the
   first whole scene, the scaled output, atol times its largest
   magnitude, at least 1) and phase 9's rtol 1e-3 / atol 1e-2 m (the first
   and last served rasters), and every served raster against its scene
   alone as in phase 9;
12. LRRU: configs/lrru_r8_img.yml as shipped (20,843,342 parameters,
   batch 70) trained the same way, with exactly 4 K1 + 1 K2 per step and
   no K3; its step against the CPU and float64 and twice from one state
   on DEMs with 3 % of their pixels at no data (``LRRU_HOLES``: where the
   DEM is > 0, ``preserve`` puts the input back before each round, and
   rounds 1-3 could not show); after one step, every parameter of the
   heads of rounds 1-3 with a zero gradient and AdamW's step taken on
   every parameter; then a seeded checkpoint served, on scenes with 3 %
   of their DEM in contiguous voids at -80 m (0 on the serving config's
   linear scale), by
   ``--infer`` over 4 x 334^2 and 1 x 1024^2, then one 500 x 700 scene
   (padded to 512 x 704, LRRU's /16), 4 K1 per scene, and ``--infer
   --tile`` over 8 x 334^2 (4 K1 per chunk), held as in phase 11 at the
   LRRU tolerance, rtol 1e-4 / atol 3e-5 (scaled, times the output's
   largest magnitude; in metres atol x 1009 m, the served rasters being
   clipped to [0, 1]), on two whole scenes and the first and last served
   rasters, and every served raster against its scene alone at twice the
   atol those two were held to float64 at (both are card runs held that
   close to float64; a batch of 72 tiles and one of 9 take other cuDNN
   algorithms, ``LRRU_ATOL``).

It prints ``{"serving": ...}``, ``{"training": ...}``,
``{"cf_training": ...}``, ``{"cf_serving": ...}``, ``{"tiled_serving":
...}``, ``{"fit": ...}``, ``{"edsr": ...}``, ``{"lrru": ...}`` (with
the card's name and power limit) and ``{"kernels": [...]}`` lines, and
ends with ``{"ok": true, "device":
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

from jspsr_torch.cli.main import main as cli_main
from jspsr_torch.config.loader import create_config
from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.data.synthetic import generate_city, generate_mini_dfc30
from jspsr_torch.eval.inference import (
    load_scene,
    make_forward,
    model_stride_multiple,
    pads_for_multiple,
    run_scene_inference,
    upscale_dem,
)
from jspsr_torch.eval.scene import tile_grid, tile_inference_device
from jspsr_torch.eval.serve import auto_scene_batch
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.factory import build_model
from jspsr_torch.ops import conv_same as conv_same_mod
from jspsr_torch.ops import cuda_build, deform_cuda
from jspsr_torch.ops.conv_same import conv_same, conv_same_plain
from jspsr_torch.ops.deform_conv import (
    deform_conv2d_backward_plain,
    deform_conv2d_plain,
)
from jspsr_torch.scripts import bench_conv_same
from jspsr_torch.scripts.bench_deform_fwd import (
    HOST_SHAPE,
    KERNEL_SHAPES,
    TIMED_SCALE,
    card_peaks,
    deform_inputs,
    deform_library,
    host_us,
    k1_bound,
    time_ms,
)
from jspsr_torch.scripts.profile_kernels import device_us
from jspsr_torch.train.checkpoint import load_model_params
from jspsr_torch.train.optim import build_optimizer
from jspsr_torch.train.profile_step import random_batch
from jspsr_torch.train.step import make_train_step, seed_step_generator
from jspsr_torch.train.trainer import Trainer
from jspsr_torch.utils.device import set_deterministic_cudnn, set_strict_fp32
from jspsr_torch.utils.perturb import perturb_weights

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "configs" / "jspsr_r8_img_msk.yml"
CF_CONFIG = REPO / "configs" / "completionformer_r8_img_msk.yml"
EDSR_CONFIG = REPO / "configs" / "edsr_r8_img.yml"
LRRU_CONFIG = REPO / "configs" / "lrru_r8_img.yml"

# K1's correctness-only shapes: sides that are not multiples of its 4 x 64
# tile, the first smaller than one tile (TMA), the second with W % 4 != 0
# (a row pitch a tensor map cannot take: the copy path)
CHECK_SHAPES = [(2, 13, 20), (1, 333, 335)]
BWD_SHAPES = [(50, 128, 128), (70, 128, 128), (16, 128, 128),
              (1, 336, 336)]
DX_SHAPES = [(16, 128, 128), (2, 128, 128), (1, 352, 352)]
# K3's d_weight and d_x against the plain backward: the largest error
# relative to the sum of the terms' magnitudes (the sums run in another
# order; d_x's fixed point resolves about 2^-61 of its image's L1 norm of
# contributions)
DX_ERR_LIMIT = 1e-5
# K3 with a heavy-tailed g: HEAVY_COUNT entries of g, anywhere in the
# batch, scaled by each factor (they set their images' fixed-point scale),
# at this offset scale
HEAVY_TAILS, HEAVY_COUNT, HEAVY_SCALE = (1e4, 1e6), 4, 20.0
# K3's three kernels, by the names the profiler gives them
DX_PASSES = {"bounds": "dx_bounds_kernel", "scatter": "deform_bwd_dx_kernel",
             "fixed_to_float": "dx_fixed_to_float_kernel"}
OFFSET_SCALES = (0.0, 1.5, 20.0)
SCENES = [("scene_0", 334), ("scene_1", 334), ("scene_2", 334),
          ("scene_3", 334), ("scene_4", 1024)]
CF_SCENE = ("scene_cf", 334)
# Tiled serving: 8 x 334^2 (auto batch 8: one 72-tile run), 2 x 1024^2
# (auto batch 1: two 81-tile runs), and one 500 x 700 scene
TILED_SMALL = [(f"tile_{i}", 334) for i in range(8)]
TILED_LARGE = [(f"big_{i}", 1024) for i in range(2)]
TILED_RECT = ("rect", (500, 700))
# Between tile batch sizes cuDNN may change its reduction order: the JAX
# suite's tolerance for that (tests/test_scene_device.py), in metres.
BATCH_RTOL, BATCH_ATOL = 2e-4, 5e-3
TRAIN_SCENES_PER_CITY = 12  # x 13 cities = 156 samples: 3 steps of 50
VALID_SCENES_PER_CITY = 4  # x 3 cities = 12 samples per eval pass
TRAIN_SIDE = 128  # an 8 m DFC30 sample
# fit on the card: the configs' 300 epochs cut to 2
FIT_EPOCHS = 2
# K1 launches per eval sample (valid batch 1): the flagship's SPN head once,
# NLSPN's 6 propagation steps
PER_EVAL_SAMPLE = {"JSPSR": 1, "CompletionFormer": 6}
# One train step, per tensor (relative L2): the card's distance from
# float64 may be three times the CPU fp32 run's, plus a floor. At init the
# step is ill-conditioned in fp32 (the CPU's own fp32 gradients are up to
# 2 % from float64); cuDNN picks other conv algorithms than the CPU (FFT
# among them); and the SPN kernel's 9 weight gradients are sums of B*H*W
# signed terms that cancel.
CARD_FP64_FLOOR = 5e-3
# The one wider floor: the weight gradients of CompletionFormer's CBAM
# SpatialAttention convs (``*.sa.conv1.weight``, a 7x7 conv from 2
# channels to 1) are small sums of cancelling terms, and cuDNN's
# algorithms leave them up to 2.8 % from float64 where the CPU's are 0.4 %
# (an excess over 3x the CPU's of up to 1.6e-2 on an H100). With cuDNN off
# they hold CARD_FP64_FLOOR, as every other tensor does with it on.
SA_CONV_SUFFIX, SA_CONV_FLOOR = ".sa.conv1.weight", 2.5e-2
# Launches per train step: JSPSR's SPN head runs one deform forward and,
# as it detaches the DEM, the backward without the input gradient (K2);
# NLSPN propagates 6 times a feature that needs its gradient (K3).
PER_STEP = {"JSPSR": {"deform_fwd": 1, "deform_bwd": 1, "deform_bwd_dx": 0},
            "CompletionFormer": {"deform_fwd": 6, "deform_bwd": 0,
                                 "deform_bwd_dx": 6},
            # EDSR as shipped runs no SPN head; with it, JSPSR's head on
            # the detached DEM. LRRU runs its post-process in each of 4
            # rounds on a detached depth; only round 4's output reaches
            # the loss undetached.
            "EDSR": {"deform_fwd": 0, "deform_bwd": 0, "deform_bwd_dx": 0},
            "EDSR+SPN": {"deform_fwd": 1, "deform_bwd": 1,
                         "deform_bwd_dx": 0},
            "LRRU": {"deform_fwd": 4, "deform_bwd": 1, "deform_bwd_dx": 0}}
# Phases 11-12 train one epoch each (2 steps of 70), a cut: with two, as
# phases 5-6 train, the whole script ran 359.5 s (NVIDIA H100 80GB HBM3,
# 700 W), where phases 1-10 alone had taken 227.9 s
CUT_EPOCHS = (0,)
# K1 launches per forward (a served scene, a tile chunk, an eval sample)
PER_FORWARD = {"EDSR": 0, "EDSR+SPN": 1, "LRRU": 4}
# LRRU's heads of rounds 1-3: their outputs enter the loss only detached
UNREACHED = ("upproj0.", "upproj1.", "upproj2.", "weight_offset0.",
             "weight_offset1.", "weight_offset2.")
# The share of LRRU's input DEM pixels set to no data (0 once scaled)
# wherever its output is compared: ``preserve`` puts the input back at
# every pixel where the DEM is > 0 before each round, so elsewhere rounds
# 1-3 would not reach the output and a fault there could not show.
LRRU_HOLES = 0.03
# LRRU's tolerance, the JAX suite's (tests/test_parity_lrru.py:45), in
# its scaled output (atol times the output's largest magnitude, at least
# 1), and carried into metres by the linear descale of the serving config
# below (x 1009 m; a served raster is clipped to [0, 1] before it, so its
# magnitude is at most 1). The full-width LRRU with random weights is
# ill-conditioned in fp32: on these scenes the CPU's own fp32 output is
# 0.3-0.75 of this tolerance from float64 and the card's up to 1.1 of it,
# so two fp32 runs may differ by more than it. The card is held to float64
# on the CPU, with three times the CPU fp32 run's distance added
# (``hold_to_float64``), as phase 5 holds a train step.
LRRU_RTOL, LRRU_ATOL = 1e-4, 3e-5
# The serving inputs of the image-only configs (configs/edsr_r8_img.yml,
# configs/lrru_r8_img.yml)
IMG_ONLY = {"COP30": 1, "image": 3}
# LRRU serves with the linear elevation scale and no relative base, so a
# no-data pixel at the range's minimum (-80 m) scales to 0 and
# ``preserve`` leaves it to rounds 1-3 (configs/lrru_r8_img.yml's log scale
# maps every elevation above 0.63, so no pixel would be left to them)
LRRU_SCALING = {"relative": False,
                "tensor_kwargs": {"log": False, "min": -80, "max": 929}}


def eval_shapes() -> list:
    """K1's shapes in the eval loop of phase 10: each config's valid
    batch of TRAIN_SIDE^2 samples (a remainder batch is padded to it)."""
    return sorted({(create_config(c).valid_batch_size, TRAIN_SIDE,
                    TRAIN_SIDE) for c in (FLAGSHIP, CF_CONFIG)})


def serving_shapes() -> list:
    """K1's shapes on the whole-scene serving paths of phases 11-12: each
    scene served whole, padded to its model's stride multiple (EDSR's 1,
    LRRU's 16); the tiled paths' chunks are in KERNEL_SHAPES."""
    shapes = set()
    for config, scenes in ((EDSR_CONFIG, SCENES),
                           (LRRU_CONFIG, SCENES + [TILED_RECT])):
        mult = model_stride_multiple(create_config(config))
        for _, side in scenes:
            h, w = (side, side) if isinstance(side, int) else side
            t, b, l, r = pads_for_multiple(h, w, mult)
            shapes.add((1, h + t + b, w + l + r))
    return sorted(shapes)


def check_deform_kernel(dev, bandwidth, fp32_peak):
    """K1 against its plain version at the main path's shapes (timed), the
    eval loop's, the whole-scene serving paths' of phases 11-12 and the
    correctness-only shapes, each once; returns one row per shape and the
    wrapper's host µs per call."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    rows = []
    for b, h, w in dict.fromkeys(KERNEL_SHAPES + eval_shapes()
                                 + serving_shapes() + CHECK_SHAPES):
        row = {"shape": [b, 1, h, w], "max_abs_err": 0.0, "window": {}}
        for scale in OFFSET_SCALES:
            args = deform_inputs(b, h, w, scale, gen, dev)
            row["path"] = deform_cuda.fwd_path(args[0], args[1], args[4])
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
            # where this data's corners are read: per pixel, from the
            # tile's shared-memory window or from global memory
            counts = deform_cuda.fwd_window(args[1], h, w)
            row["window"][str(scale)] = {
                k: counts[k] / (b * h * w)
                for k in ("window", "global", "corners")}
            print(f"deform_fwd window at {b} x {h} x {w}, {scale} px: "
                  f"{counts['window_taps'] / counts['taps']:.4f} of taps in "
                  f"the window; corners per pixel: window "
                  f"{row['window'][str(scale)]['window']:.3f}, global "
                  f"{row['window'][str(scale)]['global']:.3f} (a direct "
                  f"gather {row['window'][str(scale)]['corners']:.3f})",
                  flush=True)
            if scale == TIMED_SCALE and (b, h, w) in KERNEL_SHAPES:
                with torch.inference_mode():
                    row["kernel_ms"] = time_ms(
                        lambda: deform_cuda.deform_fwd(*args), flush)
                    row["plain_ms"] = time_ms(
                        lambda: deform_conv2d_plain(*args), flush)
                    row["library_ms"] = time_ms(
                        lambda: deform_library(*args), flush)
        row["bound_ms"], row["bound_by"] = k1_bound(b, h, w, bandwidth,
                                                    fp32_peak)
        if "kernel_ms" in row:
            row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        rows.append(row)
        print(f"deform_fwd {row}", flush=True)
    args = deform_inputs(*HOST_SHAPE, TIMED_SCALE, gen, dev)
    with torch.inference_mode():
        host = host_us(lambda: deform_cuda.deform_fwd(*args))
    print(f"deform_fwd host {host:.2f} us per call (1,000 calls at "
          f"{HOST_SHAPE}, no synchronise)", flush=True)
    return rows, host


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


def _err_over_abs_sum(got, ref, abs_sum) -> float:
    """The largest |got - ref| relative to the sum of the terms' magnitudes
    (0 where there are no terms and both are 0)."""
    return ((got - ref).abs() / abs_sum.clamp_min(1e-30)).max().item()


def dx_pass_times(dev, rows) -> None:
    """The device time of each of K3's three kernels at each of its rows'
    shapes (offsets of TIMED_SCALE), read by name from ``torch.profiler``,
    into the row's ``pass_device_ms``. It runs after every other phase:
    once the profiler has traced the card, the CompletionFormer step, which
    waits on its host's launches, ran slower in this script."""
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(64 * 2**20, device=dev)
    for row in rows:
        b, _, h, w = row["shape"]
        x, offset, weight, _, mask = deform_inputs(b, h, w, TIMED_SCALE, gen,
                                                   dev)
        g = torch.randn(b, 1, h, w, generator=gen, device=dev)
        us = device_us(lambda: deform_cuda.deform_bwd_dx(
            x, offset, weight, mask, g), flush)
        row["pass_device_ms"] = {
            part: sum(t for k, t in us.items() if kernel in k) / 1e3
            for part, kernel in DX_PASSES.items()}
        print(f"deform_bwd_dx at {b} x {h} x {w}: device ms by kernel "
              f"{row['pass_device_ms']}", flush=True)


def heavy_tails(b, h, w, gen) -> dict:
    """K3 with HEAVY_COUNT entries of g scaled by each of HEAVY_TAILS:
    bit-equal across two launches, and d_x and d_weight within
    DX_ERR_LIMIT of the terms' magnitude sums against the plain backward,
    as at the other scales (a reference in float64 would differ by the
    fp32 rounding of the sample positions, which both versions share);
    returns each factor's two errors."""
    dev = gen.device
    x, offset, weight, _, mask = deform_inputs(b, h, w, HEAVY_SCALE, gen, dev)
    out = {}
    for factor in HEAVY_TAILS:
        g = torch.randn(b, 1, h, w, generator=gen, device=dev)
        idx = torch.randint(0, g.numel(), (HEAVY_COUNT,), generator=gen,
                            device=dev)
        g.view(-1)[idx] *= factor
        got = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
        again = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
        ref = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                           need_dx=True)
        abs_sum = deform_conv2d_backward_plain(
            x.abs(), offset, weight.abs(), mask.abs(), g.abs(), need_dx=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"deform_bwd_dx at {(b, h, w)}, g with "
                                 f"{factor:g} tails: two launches differ")
        w_err = _err_over_abs_sum(got[2], ref[2], abs_sum[2])
        x_err = _err_over_abs_sum(got[4], ref[4], abs_sum[4])
        print(f"deform_bwd_dx at {b} x {h} x {w}, {HEAVY_SCALE:g} px, g with "
              f"{HEAVY_COUNT} entries x {factor:g}: bit-equal across two "
              f"launches; d_x error {x_err:.3e}, d_weight error "
              f"{w_err:.3e} of the terms' magnitude sums (limit "
              f"{DX_ERR_LIMIT:g})", flush=True)
        if w_err > DX_ERR_LIMIT or x_err > DX_ERR_LIMIT:
            raise AssertionError(f"deform_bwd_dx at {(b, h, w)}, g with "
                                 f"{factor:g} tails: d_weight error {w_err}, "
                                 f"d_x error {x_err}")
        out[f"{factor:g}"] = {"d_x_err_over_abs_sum": x_err,
                              "d_weight_err_over_abs_sum": w_err}
    return out


def check_deform_backward_dx(dev, bandwidth, fp32_peak):
    """K3 against its plain backward at NLSPN's shapes, and against itself:
    two launches on the same inputs must agree bit for bit; returns one
    row per shape."""
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(64 * 2**20, device=dev)
    rows = []
    for b, h, w in DX_SHAPES:
        row = {"shape": [b, 1, h, w], "max_abs_err": 0.0,
               "d_weight_err_over_abs_sum": 0.0,
               "d_x_err_over_abs_sum": 0.0, "bit_equal_twice": True}
        for scale in OFFSET_SCALES:
            x, offset, weight, bias, mask = deform_inputs(b, h, w, scale, gen,
                                                          dev)
            g = torch.randn(b, 1, h, w, generator=gen, device=dev)
            got = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
            again = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
            ref = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                               need_dx=True)
            # d_weight and d_x bounded by the sums of their terms' magnitudes
            abs_sum = deform_conv2d_backward_plain(
                x.abs(), offset, weight.abs(), mask.abs(), g.abs(),
                need_dx=True)
            torch.cuda.synchronize()
            unequal = [name for name, a, c in zip(
                ("d_offset", "d_mask", "d_weight", "d_bias", "d_x"), got,
                again) if not torch.equal(a, c)]
            if unequal:
                raise AssertionError(
                    f"deform_bwd_dx at {(b, h, w)} offset scale {scale}: "
                    f"{unequal} differ between two launches on the same "
                    f"inputs")
            for name, a, r in zip(("d_offset", "d_mask", "d_bias"),
                                  got[:2] + got[3:4], ref[:2] + ref[3:4]):
                if not torch.allclose(a, r, rtol=1e-5, atol=1e-5):
                    raise AssertionError(
                        f"deform_bwd_dx {name} disagrees with the plain "
                        f"backward at {(b, h, w)} offset scale {scale}: max "
                        f"|err| {(a - r).abs().max().item()}")
            w_err = _err_over_abs_sum(got[2], ref[2], abs_sum[2])
            x_err = _err_over_abs_sum(got[4], ref[4], abs_sum[4])
            if w_err > DX_ERR_LIMIT or x_err > DX_ERR_LIMIT:
                raise AssertionError(
                    f"deform_bwd_dx at {(b, h, w)} offset scale {scale}: "
                    f"d_weight error {w_err}, d_x error {x_err} of the "
                    f"terms' magnitude sums")
            print(f"deform_bwd_dx at {b} x {h} x {w}, {scale} px: bit-equal "
                  f"across two launches; d_x error {x_err:.3e} of its "
                  f"terms' magnitude sum (limit {DX_ERR_LIMIT:g})",
                  flush=True)
            row["max_abs_err"] = max(
                row["max_abs_err"], (got[0] - ref[0]).abs().max().item(),
                (got[1] - ref[1]).abs().max().item(),
                (got[4] - ref[4]).abs().max().item())
            row["d_weight_err_over_abs_sum"] = max(
                row["d_weight_err_over_abs_sum"], w_err)
            row["d_x_err_over_abs_sum"] = max(row["d_x_err_over_abs_sum"],
                                              x_err)
            # where this data's d_x contributions go: those inside the
            # block's window to shared memory, plus one flush per cell, the
            # rest global (without the window, every in-bounds corner)
            counts = deform_cuda.dx_atomics(offset, h, w)
            row.setdefault("dx_atomics_per_pixel", {})[str(scale)] = {
                k: v / (b * h * w) for k, v in counts.items()}
            if scale == TIMED_SCALE:
                atomics = counts["corners"]
                row["dx_atomics"] = counts
                row["kernel_ms"] = time_ms(lambda: deform_cuda.deform_bwd_dx(
                    x, offset, weight, mask, g), flush)
                row["plain_ms"] = time_ms(
                    lambda: deform_conv2d_backward_plain(
                        x, offset, weight, mask, g, need_dx=True), flush)
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (x, offset, weight, bias, mask)]
                out = deform_library(*leaves)
                row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True), flush)
                del out, leaves
        pixels = b * h * w
        # each input read once, each output written once: K2's 224 B per
        # pixel plus d_x (4 B); weight in and d_weight out 36 B each
        nbytes = pixels * (4 + 72 + 36 + 4 + 72 + 36 + 4) + 72
        # K2's ~35 operations per tap, 2 more per tap for the scatter's
        # row weights, and a multiply and an add per atomic
        flops = pixels * (315 + 18) + 2 * atomics
        bytes_ms, ops_ms = nbytes / bandwidth * 1e3, flops / fp32_peak * 1e3
        row["bound_ms"] = max(bytes_ms, ops_ms)
        row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        row["atomics"] = atomics
        row["atomics_per_pixel"] = atomics / pixels
        row["global_atomics_per_pixel"] = row["dx_atomics"]["global"] / pixels
        row["shared_atomics_per_pixel"] = row["dx_atomics"]["shared"] / pixels
        row["atomics_per_us"] = atomics / (row["kernel_ms"] * 1e3)
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        print(f"deform_bwd_dx atomics at {b} x {h} x {w}, {TIMED_SCALE} px: "
              f"global {row['global_atomics_per_pixel']:.3f} per pixel "
              f"(without the window {row['atomics_per_pixel']:.3f}), shared "
              f"{row['shared_atomics_per_pixel']:.3f}", flush=True)
        row["heavy_tails"] = heavy_tails(b, h, w, gen)
        rows.append(row)
        print(f"deform_bwd_dx {row}", flush=True)
    return rows


def write_scenes(root: Path, scenes, seed: int = 0, holes: float = 0.0):
    """Smooth synthetic terrain in metres, a 0-255 RGB orthophoto and a
    15-channel one-hot land-use mask per scene, as .npy rasters in the
    DFC30 subdirectory layout; the share ``holes`` of the DEM's pixels at
    -80 m (no data, the configs' minimum elevation), in contiguous voids
    (DEM voids are regions: radar shadow, water)."""
    rng = np.random.default_rng(seed)
    for name, side in scenes:
        h, w = (side, side) if isinstance(side, int) else side
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy, xx = yy / h, xx / w
        fx, fy, ph = rng.uniform(2, 6, 3)
        dem = (150 + 120 * np.sin(fx * np.pi * xx + ph)
               * np.cos(fy * np.pi * yy) + 60 * xx
               + rng.normal(0, 0.5, (h, w)))
        if holes:
            fv = rng.uniform(3, 9, 2)
            voids = (np.sin(fv[0] * np.pi * xx + ph)
                     * np.sin(fv[1] * np.pi * yy))
            dem[voids > np.quantile(voids, 1.0 - holes)] = -80.0
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = np.eye(15, dtype=np.uint8)[rng.integers(0, 15, (h, w))]
        scene = root / name
        write_raster(scene / "COP30" / "dem.npy", dem.astype(np.float32)[..., None])
        write_raster(scene / "BDORTHO" / "ortho.npy", img)
        write_raster(scene / "UA2012" / "ua.npy", mask)


def serving_config(name: str, model_name: str, model_kwargs: dict,
                   ckpt: Path, **keys) -> dict:
    """The serving keys of the r8 configs (configs/*_r8_img_msk.yml), with
    ``keys`` in place of theirs."""
    return {
        "name": f"chip_smoke_{name}", "dataset": "DFC30",
        "resolution": 8, "input_data": {"COP30": 1, "image": 3, "mask": 15},
        "relative": True, "patch_size": 128,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_name": model_name,
        "model_kwargs": {**model_kwargs, "checkpoint": str(ckpt)},
        "optimizer_kwargs": {"lr": 0.001}, "metric": {}, **keys,
    }


def seeded_checkpoint(work: Path, name: str, model_name: str,
                      model_kwargs: dict, **keys):
    """A serving config (``serving_config``'s, ``keys`` in place of its
    own) and a checkpoint of its model's seeded weights, perturbed;
    returns (config, config path, checkpoint path)."""
    work.mkdir(parents=True, exist_ok=True)
    ckpt = work / f"{name}.pt"
    cfg_path = work / f"{name}.json"
    cfg_path.write_text(json.dumps(serving_config(name, model_name,
                                                  model_kwargs, ckpt,
                                                  **keys)))
    p = create_config(cfg_path)
    model = perturb_weights(
        build_model(p, generator=torch.Generator().manual_seed(0)), seed=1)
    torch.save(model.state_dict(), ckpt)
    n_params = sum(t.numel() for t in model.parameters())
    print(f"{model_name}: {n_params} parameters", flush=True)
    return p, cfg_path, ckpt


def run_cli(argv):
    """The port's CLI, its stdout logger closed afterwards."""
    real_stdout = sys.stdout
    try:
        return cli_main(argv)
    finally:
        logger, sys.stdout = sys.stdout, real_stdout
        if logger is not real_stdout:
            logger.close()


def check_outputs(paths, scenes, scene_root: Path, near_input: bool,
                  relative: bool = True):
    """One finite raster of each scene's shape in metres: with
    ``near_input`` its mean within the input's elevation range (JSPSR's
    SPN head refines the input even at random weights), else every value
    within the range the configs' descaling gives the clipped [0, 1]
    prediction above the scene's base (random weights need not refine);
    without ``relative`` (LRRU's serving scale) the base is 0 m and the
    descaling linear."""
    if len(paths) != len(scenes):
        raise AssertionError(f"{len(paths)} rasters for {len(scenes)} scenes")
    for path, (name, side) in zip(paths, scenes):
        arr = read_raster(path)
        dem = read_raster(scene_root / name / "COP30" / "dem.npy")
        if arr.shape != dem.shape or not np.isfinite(arr).all():
            raise AssertionError(f"{path}: shape {arr.shape}, finite "
                                 f"{np.isfinite(arr).all()}")
        lo, hi = float(dem.min()), float(dem.max())
        if near_input and not (lo - 50 < float(arr.mean()) < hi + 50):
            raise AssertionError(f"{path}: mean {arr.mean()} outside the "
                                 f"input's range [{lo}, {hi}] m")
        # log-minmax over [-80, 929] m: descale(0) = -79, descale(1) = 929;
        # linear: -80 and 929
        base, bottom = (lo, 79.5) if relative else (0.0, 80.5)
        if not (base - bottom <= float(arr.min()) and
                float(arr.max()) <= base + 929.5):
            raise AssertionError(f"{path}: values [{arr.min()}, {arr.max()}]"
                                 f" outside the descaled range above {lo} m")


def card_vs_cpu_scene(p, ckpt, scene_dir, dev, rtol, atol,
                      scale_atol=False):
    """One scene through ``upscale_dem`` on the card and on the CPU from the
    same checkpoint, at ``rtol`` and ``atol`` (times the output's largest
    magnitude, at least 1, with ``scale_atol``): (max |card - CPU|, warm
    card ms (best of 3), the output's largest magnitude)."""
    sample, _ = load_scene(scene_dir, p)
    fwd_gpu = make_forward(load_model_params(build_model(p), ckpt).to(dev))
    got = upscale_dem(fwd_gpu, sample, p, dev)[0]
    warm_ms = min(upscale_dem(fwd_gpu, sample, p, dev)[1] for _ in range(3))
    fwd_cpu = make_forward(load_model_params(build_model(p), ckpt))
    ref = upscale_dem(fwd_cpu, sample, p, "cpu")[0]
    scale = float(np.abs(ref).max())
    if scale_atol:
        atol *= max(1.0, scale)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                               err_msg=f"card vs CPU, {scene_dir.name}")
    return float(np.abs(got - ref).max()), warm_ms, scale


class Float64(torch.nn.Module):
    """``model`` in float64 behind its fp32 interface: the inputs cast up,
    the output cast back (a rounding of 6e-8, far below the checks)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model.double()

    def forward(self, inputs, generator=None):
        return self.model([x.double() for x in inputs]).float()


def hold_to_float64(got, fp32, ref, rtol, atol, what: str) -> dict:
    """``got`` (the card's fp32) against ``ref`` (the CPU's float64) at
    rtol ``rtol`` and an atol of ``atol`` plus three times the largest
    distance of ``fp32`` (the CPU's fp32 on the same input) from
    ``ref``: the elementwise form of phase 5's rule. A random-weight
    LRRU is ill-conditioned in fp32 (``LRRU_ATOL``); the distances are
    returned and printed."""
    cpu = float(np.abs(fp32 - ref).max())
    out = {"card_vs_fp64_max_abs": float(np.abs(got - ref).max()),
           "cpu_fp32_vs_fp64_max_abs": cpu,
           "card_vs_cpu_max_abs": float(np.abs(got - fp32).max()),
           "atol": atol + 3 * cpu}
    print(f"{what} against float64: {out}", flush=True)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol + 3 * cpu,
                               err_msg=f"card vs float64, {what}")
    return out


def card_vs_float64_scene(p, ckpt, scene_dir, dev, rtol, atol) -> dict:
    """One scene through ``upscale_dem`` on the card, and on the CPU in
    float64 and in fp32, from the same checkpoint, held by
    ``hold_to_float64`` with ``atol`` times the output's largest magnitude
    (at least 1); with the warm card ms (best of 3) and that
    magnitude."""
    sample, _ = load_scene(scene_dir, p)
    fwd_gpu = make_forward(load_model_params(build_model(p), ckpt).to(dev))
    got = upscale_dem(fwd_gpu, sample, p, dev)[0]
    warm_ms = min(upscale_dem(fwd_gpu, sample, p, dev)[1] for _ in range(3))
    cpu = load_model_params(build_model(p), ckpt)
    fp32 = upscale_dem(make_forward(cpu), sample, p, "cpu")[0]
    ref = upscale_dem(make_forward(Float64(cpu)), sample, p, "cpu")[0]
    scale = max(1.0, float(np.abs(ref).max()))
    out = hold_to_float64(got, fp32, ref, rtol, atol * scale,
                          f"{p.model_name} {scene_dir.name}")
    return {**out, "warm_ms": warm_ms, "output_max_abs": scale}


def reset_launches() -> None:
    deform_cuda.reset_launches()
    conv_same_mod.reset_launches()


def launch_counts() -> dict:
    return {**deform_cuda.LAUNCHES, **conv_same_mod.LAUNCHES}


def serve(work: Path, dev: torch.device, flagship):
    """The serving path: the flagship JSPSR through the port's CLI over a
    directory of scenes; ``flagship`` is ``seeded_checkpoint``'s triple."""
    p, cfg_path, ckpt = flagship
    write_scenes(work / "scenes", SCENES)

    out_dir, res_dir = work / "out", work / "result"
    reset_launches()
    paths = run_cli(["--config", str(cfg_path), "--infer",
                     str(work / "scenes"), "--out", str(out_dir),
                     "--result-dir", str(res_dir)])
    launches = dict(deform_cuda.LAUNCHES)
    print(f"serving-path launches: {launches}", flush=True)
    if launches != {"deform_fwd": len(SCENES), "deform_bwd": 0,
                    "deform_bwd_dx": 0}:
        raise AssertionError(f"launches {launches} for {len(SCENES)} scenes")
    check_outputs(paths, SCENES, work / "scenes", near_input=True)

    log = (res_dir / "train.log").read_text()
    per_scene = {m[1]: {"ms": float(m[2]), "peak_mb": float(m[3])}
                 for m in re.finditer(r"Scene (\S+): ([\d.]+) ms, peak ([\d.]+) MB",
                                      log)}
    total = re.search(r"Inference: \d+ scenes -> .* \(([\d.]+) ms, ([\d.]+) "
                      r"scenes/s\)", log)

    # warm re-runs of each scene size (not counted): steady latency; one
    # 334^2 scene on the card against the port on the CPU
    warm = {}
    for name, side in (SCENES[-1], SCENES[0]):
        err, warm[f"{side}x{side}"], _ = card_vs_cpu_scene(
            p, ckpt, work / "scenes" / name, dev, rtol=1e-4, atol=2e-5)
    return {
        "scenes": [f"{s}x{s}" for _, s in SCENES],
        "per_scene": per_scene,
        "total_ms": float(total[1]), "scenes_per_s": float(total[2]),
        "warm_ms": warm, "cpu_max_abs_err": err,
    }, launches


def serve_cf(work: Path, dev: torch.device):
    """CompletionFormer serving: one 334^2 scene through the port's CLI."""
    mk = dict(create_config(CF_CONFIG).model_kwargs)
    mk = {k: v for k, v in mk.items() if k not in ("checkpoint", "pretrained")}
    p, cfg_path, ckpt = seeded_checkpoint(work, "completionformer_r8_img_msk",
                                          "CompletionFormer", mk)
    write_scenes(work / "scenes", [CF_SCENE], seed=1)
    scene = work / "scenes" / CF_SCENE[0]
    out, res_dir = work / "out" / f"{CF_SCENE[0]}_sr.npy", work / "result"
    reset_launches()
    path = run_cli(["--config", str(cfg_path), "--infer", str(scene),
                    "--out", str(out), "--result-dir", str(res_dir)])
    launches = dict(deform_cuda.LAUNCHES)
    print(f"cf-serving-path launches: {launches}", flush=True)
    if launches != {"deform_fwd": 6, "deform_bwd": 0, "deform_bwd_dx": 0}:
        raise AssertionError(f"launches {launches} for one scene")
    check_outputs([path], [CF_SCENE], work / "scenes", near_input=False)
    m = re.search(r"Inference: .* \(([\d.]+) ms, peak ([\d.]+) MB\)",
                  (res_dir / "train.log").read_text())
    # the JAX suite's CompletionFormer tolerance, rtol 1e-3 / atol 1e-4, set
    # for outputs in the [0, 1] range of a scaled DEM; atol scales with the
    # output's range, which random weights widen
    err, warm_ms, scale = card_vs_cpu_scene(p, ckpt, scene, dev, rtol=1e-3,
                                            atol=1e-4, scale_atol=True)
    return {"scene": f"{CF_SCENE[1]}x{CF_SCENE[1]}", "cold_ms": float(m[1]),
            "peak_mb": float(m[2]), "warm_ms": warm_ms,
            "cpu_max_abs_err": err, "output_max_abs": scale,
            "launches": launches}, launches


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 error of one tensor (absolute where ``ref`` is 0)."""
    diff = (got.double().cpu() - ref.double().cpu()).norm()
    return float(diff / max(float(ref.double().norm()), 1e-12))


def step_state(p, state, device, dtype, inputs, gt):
    """One full-width train step of the port from the weights ``state``:
    (loss, {param: grad}, {BatchNorm buffer: value})."""
    model = build_model(p)
    model.load_state_dict(state)
    model = model.to(device=device, dtype=dtype)
    step = make_train_step(model, build_criterion(dict(p.loss)),
                           build_optimizer(p, model))
    losses = step([x.to(device, dtype) for x in inputs], gt.to(device, dtype))
    return (float(losses["Total"]),
            {n: q.grad.cpu() for n, q in model.named_parameters()
             if q.grad is not None},
            {n: b.cpu() for n, b in model.named_buffers() if "running" in n})


def fp64_floor(name: str) -> float:
    """The floor of the train-step rule for the tensor ``name``."""
    return SA_CONV_FLOOR if name.endswith(SA_CONV_SUFFIX) else CARD_FP64_FLOOR


def train_batch(p, batch: int, seed: int, holes: float = 0.0):
    """``random_batch``'s batch of ``batch`` x 128^2 on the CPU, with the
    share ``holes`` of the DEM's pixels set to 0 (no data)."""
    inputs, gt = random_batch(p, batch, 128, "cpu", seed=seed)
    if holes:
        gen = torch.Generator().manual_seed(seed)
        inputs[0] = inputs[0].masked_fill(
            torch.rand(inputs[0].shape, generator=gen) < holes, 0.0)
    return inputs, gt


def compare_train_step(p, dev, state, batch: int, holes: float = 0.0):
    """One train step on ``batch`` x 128^2 on the card against the port on
    the CPU, both against float64 on the CPU, from the weights ``state``:
    the loss, and every gradient and BatchNorm running statistic no
    further (relative L2) from float64 than three times the CPU fp32
    run's distance plus its floor (``fp64_floor``). Returns the errors,
    the tensors furthest beyond three times the CPU's distance first."""
    inputs, gt = train_batch(p, batch, 3, holes)
    card = step_state(p, state, dev, torch.float32, inputs, gt)
    cpu = step_state(p, state, "cpu", torch.float32, inputs, gt)
    f64 = step_state(p, state, "cpu", torch.float64, inputs, gt)
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    if loss_err > 1e-4:
        raise AssertionError(f"train-step loss: card {card[0]} vs CPU "
                             f"{cpu[0]}")
    out = {"batch": [batch, 128, 128], "loss_rel_err": loss_err}
    for i, what in ((1, "grad"), (2, "bn")):
        if set(card[i]) != set(f64[i]):
            raise AssertionError(f"train-step {what}: card and float64 "
                                 "differ in which tensors they have")
        rows = []
        for name, ref in f64[i].items():
            e_card = _rel_err(card[i][name], ref)
            e_fp32 = _rel_err(cpu[i][name], ref)
            rows.append((e_card - 3 * e_fp32, e_card, e_fp32,
                         _rel_err(card[i][name], cpu[i][name]), name))
        rows.sort(reverse=True)  # the furthest beyond the rule first
        if not rows:  # EDSR as shipped holds no BatchNorm
            out[what] = {"tensors": 0}
            continue
        out[what] = {
            "tensors": len(rows),
            "card_vs_fp64_max": max(r[1] for r in rows),
            "card_vs_fp64_median": statistics.median(r[1] for r in rows),
            "cpu_fp32_vs_fp64_max": max(r[2] for r in rows),
            "card_vs_cpu_max": max(r[3] for r in rows),
            "largest_excess": [
                {"name": n, "card_vs_fp64": a, "cpu_fp32_vs_fp64": b,
                 "card_vs_cpu": c} for _, a, b, c, n in rows[:4]],
        }
        bad = [r[4] for r in rows if r[0] > fp64_floor(r[4])]
        if bad:
            raise AssertionError(
                f"train-step {what}: {bad} beyond 3 x the CPU fp32 distance "
                f"from fp64 + their floor: {out[what]}")
    return out


def step_twice(p, dev, state, batch: int, holes: float = 0.0) -> dict:
    """The same train step twice on the card, each time from a fresh model
    holding the weights ``state`` and a fresh optimizer, on one batch of
    ``batch`` x 128^2, the model's generator seeded for global step 0 both
    times: how many parameters and BatchNorm buffers differ after the two
    steps, and by how much at most."""
    inputs, gt = train_batch(p, batch, 4, holes)
    after = []
    for _ in range(2):
        model = build_model(p)
        model.load_state_dict(state)
        model = model.to(dev)
        gen = torch.Generator(dev)
        seed_step_generator(gen, p.get("seed", 0), 0)
        step = make_train_step(model, build_criterion(dict(p.loss)),
                               build_optimizer(p, model), generator=gen)
        step([x.to(dev) for x in inputs], gt.to(dev))
        torch.cuda.synchronize()
        after.append({n: t.detach().clone() for n, t in
                      [*model.named_parameters(), *model.named_buffers()]})
        del model, step
    first, second = after
    unequal = [n for n in first if not torch.equal(first[n], second[n])]
    diff = max(((first[n].double() - second[n].double()).abs().max().item()
                for n in unequal), default=0.0)
    return {"batch": [batch, 128, 128], "tensors": len(first),
            "unequal": len(unequal), "max_abs_diff": diff,
            "unequal_names": unequal[:8]}


def make_train_tree(root: Path) -> float:
    """The synthetic DFC30 tree of the r8 configs' 13 train cities (12
    samples of 128^2 each) and 3 valid cities (4 samples each); returns the
    seconds taken."""
    p = create_config(FLAGSHIP)
    t0 = time.perf_counter()
    generate_mini_dfc30(root, train_cities=p.train_set, valid_cities=(),
                        n_per_city=TRAIN_SCENES_PER_CITY, size=TRAIN_SIDE)
    for city in p.valid_set:
        generate_city(root, city, VALID_SCENES_PER_CITY, size=TRAIN_SIDE)
    return time.perf_counter() - t0


def unreached_heads(p, dev, state) -> dict:
    """One LRRU train step on the card from the weights ``state``: every
    parameter of the heads of rounds 1-3 (``UNREACHED``) must hold a zero
    gradient, and AdamW must have taken its step on every parameter (the
    step count of each is 1), as optax's does on the JAX package's exact
    zero gradients."""
    model = build_model(p)
    model.load_state_dict(state)
    model = model.to(dev)
    opt = build_optimizer(p, model)
    step = make_train_step(model, build_criterion(dict(p.loss)), opt)
    inputs, gt = train_batch(p, 4, 5, LRRU_HOLES)
    step([x.to(dev) for x in inputs], gt.to(dev))
    heads = [(n, q) for n, q in model.named_parameters()
             if n.startswith(UNREACHED)]
    nonzero = [n for n, q in heads if bool(q.grad.any())]
    steps = sorted({int(opt.state[q]["step"]) for q in model.parameters()
                    if q in opt.state})
    out = {"head_tensors": len(heads), "nonzero_grads": nonzero,
           "adam_state_tensors": len(opt.state),
           "parameters": len(list(model.parameters())), "adam_steps": steps}
    print(f"LRRU unreached heads after one step: {out}", flush=True)
    if (nonzero or not heads or steps != [1]
            or out["adam_state_tensors"] != out["parameters"]):
        raise AssertionError(f"LRRU's unreached heads: {out}")
    return out


def train(config: Path, root: Path, work: Path, dev: torch.device,
          compare_batch: int, perturbed: bool, label: str | None = None,
          model_kwargs: dict | None = None, holes: float = 0.0,
          epochs: tuple = (0, 1)):
    """A training path: ``config`` as it is (``model_kwargs`` over its
    own), on the synthetic tree at ``root``, through the port's Trainer
    for ``epochs``, with exactly ``PER_STEP[label]`` launches per step
    (``label`` defaults to the model's name); then one more epoch through
    the same Trainer with cuDNN free to choose non-deterministic
    algorithms (PyTorch's defaults), whose warm steps are printed beside
    the deterministic ones; then one train step on the
    card held against the CPU and float64 (from the seeded weights,
    ``perturbed`` or not); then one step at the train batch run twice from
    the same state (``step_twice``): every parameter and buffer must come
    out bit-equal. The two checks' DEMs have the share ``holes`` of their
    pixels set to 0."""
    p = create_config(config)
    p.dataset_path = str(root)
    p.model_kwargs.update(model_kwargs or {})
    label = label or p.model_name
    trainer = Trainer(p, result_dir=work, device=dev)
    inner, steps = trainer.train_step, []
    timed = steps

    def timed_step(inputs, gt):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = inner(inputs, gt)
        end.record()
        timed.append((start, end, losses["Total"]))
        return losses

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    ran = []
    for epoch in epochs:
        loss, lr = trainer.train_one_epoch(epoch)
        ran.append({"epoch": epoch, "loss": loss, "lr": lr,
                    "tiles_per_s": trainer.last_throughput})
    torch.cuda.synchronize()
    launches = dict(deform_cuda.LAUNCHES)
    n_steps = len(steps)
    print(f"{label} training-path launches: {launches} in {n_steps} "
          f"steps", flush=True)
    n_samples = len(p.train_set) * TRAIN_SCENES_PER_CITY
    want = {k: v * n_steps for k, v in PER_STEP[label].items()}
    if (n_steps != len(epochs) * (n_samples // p.train_batch_size)
            or launches != want):
        raise AssertionError(f"launches {launches} for {n_steps} steps")
    step_losses = [float(t) for _, _, t in steps]
    if not all(np.isfinite(step_losses + [e["loss"] for e in ran])):
        raise AssertionError(f"non-finite loss: {step_losses} {ran}")
    step_ms = [s.elapsed_time(e) for s, e, _ in steps]
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    n_params = sum(q.numel() for q in trainer.model.parameters())
    batch = p.train_batch_size
    # the same Trainer's next epoch with cuDNN free (its first step carries
    # the new algorithms' set-up: the warm steps follow)
    timed = []
    torch.backends.cudnn.deterministic = False
    trainer.train_one_epoch(max(epochs) + 1)
    torch.cuda.synchronize()
    set_deterministic_cudnn()
    free = statistics.median(s.elapsed_time(e) for s, e, _ in timed[1:])
    del trainer

    model = build_model(p)
    state = (perturb_weights(model, seed=2) if perturbed
             else model).state_dict()
    errs = compare_train_step(p, dev, state, compare_batch, holes)
    # epoch 0's first step carries cuDNN's set-up: the warm steps follow
    warm = statistics.median(step_ms[1:])
    twice = step_twice(p, dev, state, batch, holes)
    print(f"{label} step twice from one state at batch {batch}: "
          f"{twice['unequal']} of {twice['tensors']} tensors differ, max "
          f"|diff| {twice['max_abs_diff']}; warm step median {warm:.1f} ms, "
          f"{batch / warm * 1e3:.1f} tiles/s, peak {peak_mb:.0f} MB (cuDNN "
          f"free to choose its algorithms, the next epoch: {free:.1f} ms)",
          flush=True)
    if twice["unequal"]:
        raise AssertionError(f"{label}: the same step from the same "
                             f"state is not bit-equal: {twice}")
    out = {
        "config": str(config.relative_to(REPO)), "model": label,
        "model_kwargs_over_config": model_kwargs or {},
        "parameters": n_params, "batch": batch, "patch": p.patch_size,
        "train_samples": n_samples, "steps": n_steps,
        "step_losses": step_losses, "step_ms": step_ms,
        "step_ms_warm_median": warm, "tiles_per_s_warm": batch / warm * 1e3,
        "step_ms_warm_median_cudnn_free": free,
        "epochs": ran, "peak_mb": peak_mb,
        "peak_source": "torch.cuda.max_memory_allocated over the epochs",
        "launches": launches, "card_vs_cpu_step": errs,
        "step_twice": twice,
    }
    if label == "LRRU":
        out["unreached_heads"] = unreached_heads(p, dev, state)
    return out, launches


def check_conv_same(dev, bandwidth, fp32_peak, bf16_peak):
    """K4 against its plain version at the TPU probe's four cases; returns
    one row per case."""
    flush = torch.empty(64 * 2**20, device=dev)
    rows = []
    for tag, b, h, w, cin, cout, kk, dt in bench_conv_same.CASES:
        x, w1, _ = bench_conv_same.case_inputs(b, h, w, cin, cout, kk, dt, dev)
        got = conv_same(x, w1)
        ref = conv_same_plain(x, w1)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = bench_conv_same.TOL[dt]
        if not err <= tol * max(scale, 1.0):
            raise AssertionError(f"conv_same {tag}: max |err| {err} against "
                                 f"its plain version > {tol} x max(1, "
                                 f"{scale})")
        w_oihw = bench_conv_same.oihw(w1)
        lib_err = (bench_conv_same.cudnn_conv(x, w_oihw).float()
                   - ref.float()).abs().max().item()
        row = {"case": tag, "shape": [b, h, w, cin, cout, kk],
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "plain_max_abs": scale, "tol": tol,
               "library_max_abs_err": lib_err,
               "kernel_ms": time_ms(lambda: conv_same(x, w1), flush),
               "plain_ms": time_ms(lambda: conv_same_plain(x, w1), flush),
               "library_ms": time_ms(
                   lambda: bench_conv_same.cudnn_conv(x, w_oihw), flush)}
        # x and w read once, y written once, in the working type; the
        # products on the tensor cores (bf16) or the FFMA units (fp32)
        nbytes = (b * h * w * (cin + cout) + kk * kk * cin * cout) \
            * x.element_size()
        flops = 2 * b * h * w * kk * kk * cin * cout
        peak = bf16_peak if dt == torch.bfloat16 else fp32_peak
        bytes_ms, ops_ms = nbytes / bandwidth * 1e3, flops / peak * 1e3
        row["bound_ms"] = max(bytes_ms, ops_ms)
        row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        row["library_tflops"] = flops / row["library_ms"] / 1e9
        row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        rows.append(row)
        print(f"conv_same {row}", flush=True)
    return rows


def conv_probe():
    """The TPU probe's port, once: its rows and the K4 launches it made."""
    reset_launches()
    rows = bench_conv_same.main()
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"conv-probe launches: {launches}", flush=True)
    if launches["conv_same"] == 0 or launches["deform_fwd"] != 0:
        raise AssertionError(f"the probe ran with launches {launches}")
    return rows, launches


def expected_tiled_launches(p, shapes) -> int:
    """K1 launches of one ``--infer <dir> --tile`` run over scenes of
    ``shapes`` (one JSPSR forward per chunk): the sum over scene groups of
    ceil(S * n / infer_tile_batch), S the padded group size and n the
    tiles per scene."""
    tile, cap = p.patch_size, int(p.get("infer_tile_batch") or 96)
    sb = auto_scene_batch(shapes[0], tile=tile, n_scenes=len(shapes))
    n = tile_grid(shapes[0][0], tile)[1] * tile_grid(shapes[0][1], tile)[1]
    groups = -(-len(shapes) // sb)
    return groups * -(-sb * n // cap)


def _scenes_per_s(log: str) -> float:
    m = re.findall(r"Inference: \d+ scenes -> .* \(([\d.]+) ms, ([\d.]+) "
                   r"scenes/s\)", log)
    return float(m[-1][1])


def serve_tiled(work: Path, dev: torch.device, flagship):
    """Phase 9: the flagship through ``--infer --tile`` (the pipelined
    server over two directories, then one rectangular scene)."""
    p, cfg_path, ckpt = flagship
    dirs = {"334": TILED_SMALL, "1024": TILED_LARGE}
    for seed, (name, scenes) in enumerate(dirs.items()):
        write_scenes(work / name, scenes, seed=2 + seed)
    write_scenes(work / "rect", [TILED_RECT], seed=4)
    model = load_model_params(build_model(p), ckpt).to(dev)
    out, launches, expected = {}, {}, {}

    def served_vs_single(paths, scenes, root):
        err = 0.0
        for path, (name, _) in zip(paths, scenes):
            sample, _ = load_scene(root / name, p)
            single = tile_inference_device(model, sample, p, tile=p.patch_size,
                                           device=dev)[0]
            served = read_raster(path)
            np.testing.assert_allclose(served, single, rtol=BATCH_RTOL,
                                       atol=BATCH_ATOL,
                                       err_msg=f"served vs single, {name}")
            err = max(err, float(np.abs(served - single).max()))
        return err

    for name, scenes in dirs.items():
        shapes = [(s, s) for _, s in scenes]
        expected[name] = expected_tiled_launches(p, shapes)
        rates = []
        for run in range(2):
            res_dir = work / f"result_{name}_{run}"
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            paths = run_cli(["--config", str(cfg_path), "--infer",
                             str(work / name), "--tile", "--out",
                             str(work / f"out_{name}_{run}"),
                             "--result-dir", str(res_dir)])
            torch.cuda.synchronize()
            got = launch_counts()
            if run == 0:
                launches[f"tiled_{name}"] = got
            want = {"deform_fwd": expected[name], "deform_bwd": 0,
                    "deform_bwd_dx": 0, "conv_same": 0}
            if got != want:
                raise AssertionError(f"tiled {name}: launches {got}, "
                                     f"expected {want}")
            rates.append(_scenes_per_s((res_dir / "train.log").read_text()))
            peak = torch.cuda.max_memory_allocated(dev) / 2**20
        check_outputs(paths, scenes, work / name, near_input=True)
        out[name] = {"scenes": len(scenes), "scene_batch": auto_scene_batch(
                         shapes[0], tile=p.patch_size, n_scenes=len(scenes)),
                     "scenes_per_s": rates, "warm_scenes_per_s": rates[1],
                     "peak_mb": peak,
                     "served_vs_single_max_abs_err": served_vs_single(
                         paths, scenes, work / name)}

    # (c) one rectangular scene on its own
    rect = work / "rect" / TILED_RECT[0]
    reset_launches()
    path = run_cli(["--config", str(cfg_path), "--infer", str(rect), "--tile",
                    "--out", str(work / "out_rect.npy"), "--result-dir",
                    str(work / "result_rect")])
    torch.cuda.synchronize()
    launches["tiled_rect"] = launch_counts()
    expected["rect"] = expected_tiled_launches(p, [TILED_RECT[1]])
    if launches["tiled_rect"]["deform_fwd"] != expected["rect"]:
        raise AssertionError(f"rect: launches {launches['tiled_rect']}")
    check_outputs([path], [TILED_RECT], work / "rect", near_input=True)
    out["rect"] = {"shape": list(TILED_RECT[1]),
                   "served_vs_single_max_abs_err": served_vs_single(
                       [path], [TILED_RECT], work / "rect")}
    print(f"tiled-serving launches: {launches}, expected K1 {expected}",
          flush=True)

    # the card against the port on the CPU, in metres
    cpu_model = load_model_params(build_model(p), ckpt)
    cpu_err = {}
    for key, scene in (("334", work / "334" / TILED_SMALL[0][0]),
                       ("rect", rect)):
        sample, _ = load_scene(scene, p)
        got = tile_inference_device(model, sample, p, tile=p.patch_size,
                                    device=dev)[0]
        ref = tile_inference_device(cpu_model, sample, p, tile=p.patch_size,
                                    device="cpu")[0]
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-2,
                                   err_msg=f"tiled card vs CPU, {key}")
        cpu_err[key] = float(np.abs(got - ref).max())
    out["cpu_max_abs_err_m"] = cpu_err

    # one 1024^2 scene end to end (read, run, write), tiled and whole
    big = work / "1024" / TILED_LARGE[0][0]
    e2e = {}
    for tile in (True, False):
        times, peaks = [], []
        for i in range(5):
            t0 = time.perf_counter()
            _, _, peak = run_scene_inference(
                model, p, big, work / f"e2e_{tile}_{i}.npy", tile=tile,
                device=dev)
            times.append((time.perf_counter() - t0) * 1e3)
            peaks.append(peak)
        e2e["tiled" if tile else "whole"] = {"best_ms": min(times),
                                             "ms": times,
                                             "peak_mb": max(peaks)}
    out["e2e_1024"] = e2e
    out["launches"] = launches
    out["expected_k1"] = expected
    return out, launches


def serve_family(work: Path, dev: torch.device, label: str,
                 model_name: str, model_kwargs: dict, whole, tiled,
                 rect=None, tol_scaled=(1e-4, 2e-5), tol_tiled=(1e-3, 1e-2),
                 tol_batch=(BATCH_RTOL, BATCH_ATOL), **keys):
    """A seeded checkpoint of ``model_name`` (``label`` a key of
    PER_FORWARD) through the port's CLI: ``--infer`` over ``whole`` (a
    scene directory and its scenes), then over ``rect`` (one scene, a
    directory and its scene) alone, then ``--infer --tile`` over ``tiled``
    twice; exactly ``PER_FORWARD[label]`` K1 launches per whole scene and
    per tile chunk. Every comparison holds the card to the port on the CPU
    in float64 by ``hold_to_float64``: the first scene of ``whole`` and
    ``rect`` (scaled outputs, ``tol_scaled``, atol times the output's
    largest magnitude, at least 1) and the first and last served rasters
    (metres, ``tol_tiled``: the rasters are clipped to [0, 1] before the
    descale, so their magnitude is at most 1). Every served raster is also
    held to its scene through ``tile_inference_device`` on the card alone
    at ``tol_batch`` (rtol, atol in metres; ``None``: rtol
    ``tol_tiled[0]`` and twice the largest atol the served rasters were
    held to float64 at, as the two are card runs each held that close to
    float64). ``keys`` go into the serving config."""
    p, cfg_path, ckpt = seeded_checkpoint(
        work, label.lower().replace("+", "_"), model_name, model_kwargs,
        input_data=dict(IMG_ONLY), **keys)
    relative = bool(p.get("relative"))
    k1 = PER_FORWARD[label]
    none = {"deform_fwd": 0, "deform_bwd": 0, "deform_bwd_dx": 0,
            "conv_same": 0}
    launches, out = {}, {"config": dict(model_kwargs)}

    runs = [("whole", whole)] + ([("rect", rect)] if rect else [])
    for tag, (root, scenes) in runs:
        res_dir = work / f"result_{tag}"
        target = root / scenes[0][0] if tag == "rect" else root
        reset_launches()
        got_paths = run_cli(["--config", str(cfg_path), "--infer",
                             str(target), "--out",
                             str(work / (f"out_{tag}.npy" if tag == "rect"
                                         else f"out_{tag}")),
                             "--result-dir", str(res_dir)])
        torch.cuda.synchronize()
        got = launch_counts()
        launches[f"{label}_{tag}"] = got
        if got != dict(none, deform_fwd=k1 * len(scenes)):
            raise AssertionError(f"{label} {tag}: launches {got} for "
                                 f"{len(scenes)} scenes")
        got_paths = got_paths if isinstance(got_paths, list) else [got_paths]
        check_outputs(got_paths, scenes, root, near_input=False,
                      relative=relative)
        log = (res_dir / "train.log").read_text()
        out[tag] = {
            "scenes": [list(s) if isinstance(s, tuple) else [s, s]
                       for _, s in scenes],
            "per_scene": {m[1]: {"ms": float(m[2]), "peak_mb": float(m[3])}
                          for m in re.finditer(
                              r"Scene (\S+): ([\d.]+) ms, peak ([\d.]+) MB",
                              log)}}
        total = re.search(r"Inference: \d+ scenes -> .* \(([\d.]+) ms, "
                          r"([\d.]+) scenes/s\)", log)
        if total:
            out[tag]["scenes_per_s"] = float(total[2])
        else:  # one scene: its cold ms and peak
            one = re.search(r"Inference: .* \(([\d.]+) ms, peak "
                            r"([\d.]+|nan) MB\)", log)
            out[tag].update(cold_ms=float(one[1]), peak_mb=float(one[2]))
        out[tag].update(card_vs_float64_scene(
            p, ckpt, root / scenes[0][0], dev, *tol_scaled))

    root, scenes = tiled
    shapes = [(s, s) for _, s in scenes]
    want = dict(none, deform_fwd=k1 * expected_tiled_launches(p, shapes))
    rates = []
    for run in range(2):
        res_dir = work / f"result_tiled_{run}"
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        paths = run_cli(["--config", str(cfg_path), "--infer", str(root),
                         "--tile", "--out", str(work / f"out_tiled_{run}"),
                         "--result-dir", str(res_dir)])
        torch.cuda.synchronize()
        got = launch_counts()
        if run == 0:
            launches[f"{label}_tiled"] = got
        if got != want:
            raise AssertionError(f"{label} tiled: launches {got}, expected "
                                 f"{want}")
        rates.append(_scenes_per_s((res_dir / "train.log").read_text()))
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check_outputs(paths, scenes, root, near_input=False, relative=relative)
    model = load_model_params(build_model(p), ckpt).to(dev)
    cpu_model = load_model_params(build_model(p), ckpt)
    f64_model = Float64(load_model_params(build_model(p), ckpt))
    tiled = {"scenes": len(scenes), "scenes_per_s": rates,
             "warm_scenes_per_s": rates[1], "peak_mb": peak,
             "against_float64": {}}
    samples = [load_scene(root / name, p)[0] for name, _ in scenes]
    for i in (0, len(scenes) - 1):
        fp32, ref = (tile_inference_device(m, samples[i], p,
                                           tile=p.patch_size,
                                           device="cpu")[0]
                     for m in (cpu_model, f64_model))
        tiled["against_float64"][scenes[i][0]] = hold_to_float64(
            read_raster(paths[i]), fp32, ref, *tol_tiled,
            f"{label} served {scenes[i][0]}")
    if tol_batch is None:
        tol_batch = (tol_tiled[0], 2 * max(
            h["atol"] for h in tiled["against_float64"].values()))
    served_err = 0.0
    for path, (name, _), sample in zip(paths, scenes, samples):
        served = read_raster(path)
        single = tile_inference_device(model, sample, p, tile=p.patch_size,
                                       device=dev)[0]
        np.testing.assert_allclose(
            served, single, rtol=tol_batch[0], atol=tol_batch[1],
            err_msg=f"{label} served vs single {name}")
        served_err = max(served_err, float(np.abs(served - single).max()))
    tiled.update(served_vs_single_max_abs_err_m=served_err,
                 served_vs_single_tol=list(tol_batch),
                 expected_k1=want["deform_fwd"])
    out["tiled"] = tiled
    out["launches"] = launches
    print(f"{label} serving: launches {launches}; "
          + ", ".join(f"{tag} {out[tag]['scenes_per_s']} scenes/s"
                      if "scenes_per_s" in out[tag]
                      else f"{tag} {out[tag]['cold_ms']} ms cold"
                      for tag, _ in runs)
          + f", tiled {rates[1]:.2f} scenes/s (peak {peak:.0f} MB); "
          f"served vs single {served_err:.4g} m (tolerance {tol_batch})",
          flush=True)
    return out, launches


def phase_edsr(work: Path, root: Path, dev: torch.device, scenes_dir: Path,
               tiled_dir: Path):
    """Phase 11: configs/edsr_r8_img.yml as shipped and with its SPN head,
    trained (one epoch each, ``CUT_EPOCHS``) and served whole and
    tiled."""
    out, paths = {}, {}
    shipped = {k: v for k, v in create_config(EDSR_CONFIG).model_kwargs.items()
               if k not in ("checkpoint", "pretrained")}
    for label, over in (("EDSR", {}), ("EDSR+SPN", {"spn": True})):
        key = label.lower().replace("+", "_")
        mk = {**shipped, **over}
        out[f"{key}_training"], paths[f"{key}_training"] = train(
            EDSR_CONFIG, root, work / f"train_{key}", dev, compare_batch=2,
            perturbed=False, label=label, model_kwargs=over,
            epochs=CUT_EPOCHS)
        torch.backends.cudnn.deterministic = False  # serving, as phase 7
        out[f"{key}_serving"], launches = serve_family(
            work / f"serve_{key}", dev, label, "EDSR", mk,
            (scenes_dir, SCENES), (tiled_dir, TILED_SMALL))
        paths.update(launches)
    return out, paths


def phase_lrru(work: Path, root: Path, dev: torch.device):
    """Phase 12: configs/lrru_r8_img.yml as shipped, trained (one epoch),
    then served whole (4 x 334^2 and 1 x 1024^2, then one 500 x 700 scene
    padded to 512 x 704) and tiled (8 x 334^2) on DEMs with LRRU_HOLES of
    their pixels at no data."""
    paths = {}
    training, paths["lrru_training"] = train(
        LRRU_CONFIG, root, work / "train", dev, compare_batch=2,
        perturbed=True, holes=LRRU_HOLES, epochs=CUT_EPOCHS)
    torch.backends.cudnn.deterministic = False  # serving, as phase 7
    write_scenes(work / "scenes", SCENES, seed=5, holes=LRRU_HOLES)
    write_scenes(work / "rect", [TILED_RECT], seed=6, holes=LRRU_HOLES)
    write_scenes(work / "tiled", TILED_SMALL, seed=7, holes=LRRU_HOLES)
    mk = {k: v for k, v in create_config(LRRU_CONFIG).model_kwargs.items()
          if k not in ("checkpoint", "pretrained")}
    serving, launches = serve_family(
        work / "serve", dev, "LRRU", "LRRU", mk, (work / "scenes", SCENES),
        (work / "tiled", TILED_SMALL), rect=(work / "rect", [TILED_RECT]),
        tol_scaled=(LRRU_RTOL, LRRU_ATOL),
        tol_tiled=(LRRU_RTOL, LRRU_ATOL * 1009.0), tol_batch=None,
        **LRRU_SCALING)
    paths.update(launches)
    return {"lrru_training": training, "lrru_serving": serving}, paths


def fit_config(config: Path, root: Path, epochs: int = FIT_EPOCHS):
    """``config`` as it is on the synthetic tree at ``root``, but for its
    epochs (the one cut)."""
    p = create_config(config)
    p.dataset_path = str(root)
    p.epochs = epochs
    return p


class FitRecorder:
    """Wraps a Trainer's ``train_one_epoch``, ``evaluate`` and ``finish``:
    each epoch's seconds and losses, each eval pass's seconds, and every
    parameter and buffer as ``finish`` starts (the state the last epoch
    left, before the best checkpoint is reloaded)."""

    def __init__(self, trainer):
        self.epoch_s, self.eval_s, self.losses = [], [], []
        self.final_state = None
        train_one_epoch, evaluate = trainer.train_one_epoch, trainer.evaluate
        finish = trainer.finish

        def timed_epoch(epoch):
            t0 = time.perf_counter()
            out = train_one_epoch(epoch)
            torch.cuda.synchronize()
            self.epoch_s.append(time.perf_counter() - t0)
            self.losses.append(dict(trainer.last_epoch_losses))
            return out

        def timed_eval(*args, **kwargs):
            t0 = time.perf_counter()
            out = evaluate(*args, **kwargs)
            self.eval_s.append(time.perf_counter() - t0)
            return out

        def snapshot_finish():
            self.final_state = {
                n: t.detach().clone() for n, t in
                [*trainer.model.named_parameters(),
                 *trainer.model.named_buffers()]}
            return finish()

        trainer.train_one_epoch = timed_epoch
        trainer.evaluate = timed_eval
        trainer.finish = snapshot_finish


def fit_run(config: Path, root: Path, work: Path, dev: torch.device,
            epochs: int = FIT_EPOCHS, initial_eval: bool = False,
            resume_from=None):
    """``Trainer(p, device=dev).fit(initial_eval)`` for ``epochs`` (after
    ``load(resume_from, resume=True)`` when given): (fit's result, its
    recorder, the trainer)."""
    trainer = Trainer(fit_config(config, root, epochs), result_dir=work,
                      device=dev)
    if resume_from is not None:
        trainer.load(resume_from, resume=True)
    rec = FitRecorder(trainer)
    return trainer.fit(initial_eval=initial_eval), rec, trainer


def resume_gate(config: Path, root: Path, work: Path, dev: torch.device):
    """Run A fits FIT_EPOCHS epochs; run B fits 1 (its checkpoint, saved at
    the end of epoch 0 as the first best, is renamed by ``finish``), then a
    new Trainer loads it with ``resume=True`` and fits to FIT_EPOCHS. A's
    and B's last parameters and buffers, best result and epoch losses must
    be bit-equal: no tolerance."""
    _, rec_a, a = fit_run(config, root, work / "A", dev)
    out_b1, rec_b1, _ = fit_run(config, root, work / "B1", dev, epochs=1)
    _, rec_b2, b2 = fit_run(config, root, work / "B2", dev,
                            resume_from=out_b1["checkpoint"])
    unequal = [n for n in rec_a.final_state
               if not torch.equal(rec_a.final_state[n], rec_b2.final_state[n])]
    b_losses = rec_b1.losses + rec_b2.losses
    gate = {"tensors": len(rec_a.final_state), "unequal": len(unequal),
            "unequal_names": unequal[:8],
            "best_result_equal": a.best_result == b2.best_result,
            "epoch_losses_equal": rec_a.losses == b_losses,
            "start_epoch_after_load": b2.start_epoch,
            "global_step": [a.global_step, b2.global_step]}
    print(f"resume gate {a.p.model_name}: {gate}", flush=True)
    if (unequal or not gate["best_result_equal"]
            or not gate["epoch_losses_equal"]
            or a.global_step != b2.global_step):
        raise AssertionError(f"{a.p.model_name}: a resumed fit is not "
                             f"bit-equal to an uninterrupted one: {gate}, "
                             f"A {a.best_result} {rec_a.losses}, B "
                             f"{b2.best_result} {b_losses}")
    return gate


def fit(root: Path, work: Path, dev: torch.device, smi: str):
    """Phase 10: the flagship's ``fit`` on the card on phase 5's tree (its
    config as it is but for the epochs), with the exact launches of its
    steps and eval samples; the best checkpoint validated through the CLI's
    --val, and on the CPU; then the resume gate for both families."""
    p = fit_config(FLAGSHIP, root)
    print(f"fit: {FLAGSHIP.relative_to(REPO)} as it is but epochs "
          f"{create_config(FLAGSHIP).epochs} -> {FIT_EPOCHS} (a cut)",
          flush=True)
    reset_launches()
    out, rec, trainer = fit_run(FLAGSHIP, root, work / "run", dev,
                                initial_eval=True)
    torch.cuda.synchronize()
    launches = dict(deform_cuda.LAUNCHES)
    n_valid = len(p.valid_set) * VALID_SCENES_PER_CITY
    steps = FIT_EPOCHS * (len(p.train_set) * TRAIN_SCENES_PER_CITY
                          // p.train_batch_size)
    evals = len(rec.eval_s)  # initial, one per epoch, final
    want = {k: v * steps for k, v in PER_STEP["JSPSR"].items()}
    want["deform_fwd"] += PER_EVAL_SAMPLE["JSPSR"] * n_valid * evals
    print(f"fit-path launches: {launches} for {steps} steps and {evals} eval "
          f"passes of {n_valid} samples", flush=True)
    if launches != want or evals != FIT_EPOCHS + 2:
        raise AssertionError(f"fit launches {launches}, expected {want}")
    run = work / "run"
    ckpt = Path(out["checkpoint"])
    preds = [f for f in (run / "predictions").iterdir()
             if f.suffix in (".tif", ".npy")]
    lines = (run / "metrics.jsonl").read_text().splitlines()
    if ("RMSE" not in ckpt.name or not ckpt.exists()
            or len(preds) != n_valid or len(lines) != FIT_EPOCHS
            or not (run / "summary.json").exists()
            or not (run / "summary.csv").exists()):
        raise AssertionError(f"fit products: {ckpt.name}, {len(preds)} "
                             f"predictions, {len(lines)} metrics lines, "
                             f"{sorted(f.name for f in run.iterdir())}")
    scores = {k: v for k, v in out["result"].items() if k != "input"}
    if not all(np.isfinite(list(scores.values()))):
        raise AssertionError(f"fit final eval {scores}")
    del trainer

    # --val through the CLI on the best checkpoint
    cfg = dict(fit_config(FLAGSHIP, root))
    # the loader derives dataset_path from data_root (root is its DFC30_8m)
    cfg["data_root"] = str(root.parent)
    cfg["model_kwargs"] = dict(cfg["model_kwargs"], checkpoint=str(ckpt))
    cfg_path = work / "val.json"
    cfg_path.write_text(json.dumps(cfg, default=str))
    val = run_cli(["--config", str(cfg_path), "--val", "--result-dir",
                   str(work / "val")])
    for k, v in scores.items():
        np.testing.assert_allclose(val[k], v, rtol=1e-5,
                                   err_msg=f"--val {k} vs fit's final eval")

    # the same checkpoint evaluated by the port on the CPU
    cpu = Trainer(fit_config(FLAGSHIP, root), result_dir=work / "cpu",
                  device="cpu", verbose=False)
    cpu.load(ckpt)
    cpu_scores = cpu.evaluate()
    for k, v in scores.items():
        np.testing.assert_allclose(cpu_scores[k], v, rtol=1e-4,
                                   err_msg=f"CPU {k} vs the card's")
    del cpu

    gates = {name: resume_gate(config, root, work / f"gate_{name}", dev)
             for name, config in (("JSPSR", FLAGSHIP),
                                  ("CompletionFormer", CF_CONFIG))}
    return {
        "config": str(FLAGSHIP.relative_to(REPO)),
        "cut": {"epochs": [create_config(FLAGSHIP).epochs, FIT_EPOCHS]},
        "train_samples": len(p.train_set) * TRAIN_SCENES_PER_CITY,
        "valid_samples": n_valid, "steps": steps,
        "epoch_s": rec.epoch_s, "eval_pass_s": rec.eval_s,
        "eval_ms_per_sample": [t / n_valid * 1e3 for t in rec.eval_s],
        "checkpoint": ckpt.name, "final_eval": scores,
        "best_result": out["best_result"],
        "offline_summary": out["summary"]["offline"] if out["summary"]
        else None,
        "val_cli": {k: val[k] for k in scores},
        "cpu_eval": {k: cpu_scores[k] for k in scores},
        "launches": launches, "resume_gate": gates, "card": smi,
    }, launches


def phase(n: int, t_start: float) -> None:
    print(f"phase {n} starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)


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
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}",
          flush=True)
    set_strict_fp32()
    card, (bandwidth, fp32_peak, bf16_peak) = card_peaks(kind)

    # 2. build every kernel of the paths, one nvcc per source, together
    t0 = time.perf_counter()
    built = cuda_build.build(verbose=True)
    for name, (lib, nvcc_s) in built.items():
        print(f"built {lib.name}: nvcc {nvcc_s:.2f} s", flush=True)
    print(f"build total {time.perf_counter() - t0:.2f} s", flush=True)
    sass = cuda_build.sass_atomics(cuda_build.library_path("deform_bwd"))
    for kernel, ops in sass.items():
        print(f"SASS atomics of {kernel}: {ops}", flush=True)
    spins = {k: o for k, o in sass.items()
             if any(op.startswith("ATOMS.CAST.SPIN") for op in o)}
    if spins:
        raise AssertionError(f"deform_bwd.cu compiles a shared-memory "
                             f"atomic to a compare-and-swap loop: {spins}")

    phase(3, t_start)
    # 3. each kernel against its plain version
    fwd_rows, fwd_host_us = check_deform_kernel(dev, bandwidth, fp32_peak)
    bwd_rows = check_deform_backward(dev, bandwidth, fp32_peak)
    dx_rows = check_deform_backward_dx(dev, bandwidth, fp32_peak)

    paths = {}
    with tempfile.TemporaryDirectory(prefix="jspsr_chip_smoke_") as tmp:
        tmp = Path(tmp)
        phase(4, t_start)
        # 4. serving the flagship through the CLI
        flagship = seeded_checkpoint(tmp / "flagship", "jspsr_r8_img_msk",
                                     "JSPSR", {"num_block": 2,
                                               "num_feature": 32})
        serving, paths["serving"] = serve(tmp / "serve", dev, flagship)
        serving["peak_source"] = "torch.cuda.max_memory_allocated per scene"
        phase(5, t_start)
        # 5. training the flagship through the Trainer
        root = tmp / "DFC30_8m"
        data_s = make_train_tree(root)
        training, paths["training"] = train(
            FLAGSHIP, root, tmp / "train", dev, compare_batch=4,
            perturbed=False)
        training["data_gen_s"] = data_s
        phase(6, t_start)
        # 6. training CompletionFormer through the Trainer
        cf_training, paths["cf_training"] = train(
            CF_CONFIG, root, tmp / "train_cf", dev, compare_batch=2,
            perturbed=True)
        # the Trainer asked cuDNN for deterministic algorithms, a
        # process-wide setting; serving runs as a process of its own, with
        # cuDNN's defaults, as in phase 4
        torch.backends.cudnn.deterministic = False
        phase(7, t_start)
        # 7. serving CompletionFormer through the CLI
        cf_serving, paths["cf_serving"] = serve_cf(tmp / "serve_cf", dev)
        phase(8, t_start)
        # 8. K4 against its plain version, then the TPU probe's port
        conv_rows = check_conv_same(dev, bandwidth, fp32_peak, bf16_peak)
        probe_rows, paths["conv_probe"] = conv_probe()
        phase(9, t_start)
        # 9. tiled serving of the flagship through the CLI
        tiled, tiled_paths = serve_tiled(tmp / "tiled", dev, flagship)
        paths.update(tiled_paths)
        phase(10, t_start)
        # 10. fit, --val, the CPU's scores and the resume gate
        fitted, paths["fit"] = fit(root, tmp / "fit", dev, smi_line)
        phase(11, t_start)
        # 11. EDSR, as shipped and with its SPN head: train and serve
        edsr, edsr_paths = phase_edsr(tmp / "edsr", root, dev,
                                      tmp / "serve" / "scenes",
                                      tmp / "tiled" / "334")
        paths.update(edsr_paths)
        phase(12, t_start)
        # 12. LRRU: train and serve
        lrru, lrru_paths = phase_lrru(tmp / "lrru", root, dev)
        paths.update(lrru_paths)
    # K3's three kernels apart, under the profiler, after every phase
    dx_pass_times(dev, dx_rows)
    tiled["conv_probe"] = probe_rows
    for result in (serving, training, cf_training, cf_serving, tiled,
                   *edsr.values(), *lrru.values()):
        result["card"] = card

    def kernel_line(name, source, replaces, tpu_kernel, rows, main_shape,
                    sources=None):
        """One kernel's entry; with ``sources`` ({dtype: path}) the main
        shape has a row per dtype: the first gives the line's numbers and
        every one its own under ``main_by_dtype``."""
        mains = [r for r in rows if r["shape"] == main_shape]
        main = mains[0]
        by_path = {path: launches.get(name, 0)
                   for path, launches in paths.items()}
        line = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape": main["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": rows,
        }
        if sources:
            line["main_by_dtype"] = {r["dtype"]: {
                "source": sources[r["dtype"]],
                **{k: r[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "tflops",
                                     "kernel_over_library")}}
                for r in mains}
        return line

    kernels = [
        kernel_line("deform_fwd", "jspsr_torch/ops/csrc/deform_fwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:108",
                    "jspsr_tpu/ops/pallas_deform.py::_fwd_kernel", fwd_rows,
                    [1, 1, 1024, 1024]),
        kernel_line("deform_bwd", "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=False)", bwd_rows, [50, 1, 128, 128]),
        kernel_line("deform_bwd_dx", "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=True, d_x at :227-242)", dx_rows,
                    [16, 1, 128, 128]),
        kernel_line("conv_same", "jspsr_torch/ops/csrc/conv_same_bf16.cu",
                    "scripts/bench_pallas_conv.py:38",
                    "scripts/bench_pallas_conv.py::pallas_conv_same",
                    conv_rows, [16, 128, 128, 64, 64, 3], sources={
                        "bfloat16": "jspsr_torch/ops/csrc/conv_same_bf16.cu",
                        "float32": "jspsr_torch/ops/csrc/conv_same_f32.cu"}),
    ]
    kernels[0]["host_us_per_call"] = fwd_host_us
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"cf_training": cf_training}), flush=True)
    print(json.dumps({"cf_serving": cf_serving}), flush=True)
    print(json.dumps({"tiled_serving": tiled}), flush=True)
    print(json.dumps({"fit": fitted}, default=float), flush=True)
    print(json.dumps({"edsr": edsr}, default=float), flush=True)
    print(json.dumps({"lrru": lrru}, default=float), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
