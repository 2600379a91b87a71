#!/usr/bin/env python3
"""The ``scene_batch`` sweep of the pipelined server on one CUDA card.

    python -m jspsr_torch.eval.profile_serve [--passes 3] [--small 16]
                                             [--large 4]

Builds the flagship JSPSR (configs/jspsr_r8_img_msk.yml widths: 3
branches, num_feature 32, num_block 2) with seeded random weights, writes
``--small`` 334^2 scenes and ``--large`` 1024^2 scenes, and for each size:

- serves the scenes through ``serve_scenes`` at scene_batch {1, 2, 4, 8}
  (334^2) and {1, 2, 4} (1024^2), ``--passes`` times each after one
  warm-up pass per batch (cuDNN plans, pinned-memory pools), and prints
  scenes/s per pass and the peak device memory;
- runs the same scenes back to back without the pipeline (load, prepare,
  upload, run, download, write, one scene at a time through
  ``tile_inference_device``): the yardstick for the overlap; and back to
  back whole, untiled (``run_scene_inference``, the CLI's route without
  --tile): the yardstick for tiling;
- traces one pass at each size's fastest batch with ``torch.profiler``
  and prints the device's idle share of that pass's wall time (1 - the
  union of its kernels' intervals / wall time).

Batch size does not change outputs, so the sweep tunes a constant:
``auto_scene_batch``'s ``cap_tiles`` (``eval/serve.CAP_TILES``). The last
line gives the range of ``cap_tiles`` that picks each size's fastest
batch. One JSON line per arm. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.data.raster_io import write_raster
from jspsr_torch.eval.inference import load_scene, run_scene_inference
from jspsr_torch.eval.profile_scene import flagship_config, write_scene
from jspsr_torch.eval.scene import tile_grid, tile_inference_device
from jspsr_torch.eval.serve import serve_scenes
from jspsr_torch.models.factory import build_model
from jspsr_torch.train.profile_step import _kernels, busy_ms
from jspsr_torch.utils.device import set_strict_fp32

SWEEP = {334: (1, 2, 4, 8), 1024: (1, 2, 4)}
TILE = 128


def sequential(model, p, scenes, out_dir: Path, dev) -> float:
    """The scenes back to back, one whole round trip each; scenes/s."""
    t0 = time.perf_counter()
    for s in scenes:
        sample, profile = load_scene(s, p)
        arr, _ = tile_inference_device(model, sample, p, tile=TILE,
                                       device=dev)
        write_raster(out_dir / f"{s.name}_sr.npy", arr, dict(profile))
    return len(scenes) / (time.perf_counter() - t0)


def whole(model, p, scenes, out_dir: Path, dev) -> float:
    """The scenes back to back through the whole-scene path; scenes/s."""
    t0 = time.perf_counter()
    for s in scenes:
        run_scene_inference(model, p, s, out_dir / f"{s.name}_whole.npy",
                            device=dev)
    return len(scenes) / (time.perf_counter() - t0)


def idle_share(model, p, scenes, out_dir: Path, sb: int, dev) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_ms, sps = serve_scenes(model, p, scenes, out_dir, tile=TILE,
                                       scene_batch=sb, device=dev)
    busy = busy_ms(_kernels(prof))
    return {"traced_wall_ms": wall_ms, "traced_scenes_per_s": sps,
            "kernel_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--small", type=int, default=16,
                    help="number of 334^2 scenes")
    ap.add_argument("--large", type=int, default=4,
                    help="number of 1024^2 scenes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    set_strict_fp32()
    p = flagship_config()
    model = build_model(p, generator=torch.Generator().manual_seed(0)).to(dev)
    model.eval()
    rng = np.random.default_rng(0)
    best = {}
    with tempfile.TemporaryDirectory(prefix="jspsr_profile_serve_") as tmp:
        tmp = Path(tmp)
        for side, count in ((334, args.small), (1024, args.large)):
            scenes = [write_scene(tmp / f"{side}_{i:02d}", side, rng)
                      for i in range(count)]
            out_dir = tmp / f"out_{side}"
            out_dir.mkdir()
            n_tiles = tile_grid(side, TILE)[1] ** 2
            rates = {}
            for sb in SWEEP[side]:
                serve_scenes(model, p, scenes, out_dir, tile=TILE,
                             scene_batch=sb, device=dev)  # warm-up
                torch.cuda.reset_peak_memory_stats(dev)
                passes = [serve_scenes(model, p, scenes, out_dir, tile=TILE,
                                       scene_batch=sb, device=dev)[2]
                          for _ in range(args.passes)]
                rates[sb] = statistics.median(passes)
                print(json.dumps({
                    "side": side, "scenes": count, "scene_batch": sb,
                    "tiles_per_run": sb * n_tiles,
                    "scenes_per_s": passes, "median": rates[sb],
                    "peak_mb": torch.cuda.max_memory_allocated(dev) / 2**20,
                    "card": torch.cuda.get_device_name(0)}), flush=True)
            for arm, fn in (("back_to_back", sequential),
                            ("whole_back_to_back", whole)):
                fn(model, p, scenes[:1], out_dir, dev)  # warm-up
                rate = [fn(model, p, scenes, out_dir, dev)
                        for _ in range(args.passes)]
                print(json.dumps({"side": side, "scenes": count, "arm": arm,
                                  "scenes_per_s": rate,
                                  "median": statistics.median(rate)}),
                      flush=True)
            best[side] = max(rates, key=rates.get)
            print(json.dumps({"side": side, "scene_batch": best[side],
                              **idle_share(model, p, scenes, out_dir,
                                           best[side], dev)}), flush=True)
    # cap_tiles picks batch sb at n tiles per scene iff sb * n <= cap
    # < 2 * sb * n (sb < 8), and sb = 8 iff 8 * n <= cap
    lo, hi = 0, float("inf")
    for side, sb in best.items():
        n = tile_grid(side, TILE)[1] ** 2
        lo = max(lo, sb * n)
        if sb < 8:
            hi = min(hi, 2 * sb * n - 1)
    print(json.dumps({"fastest_scene_batch": best,
                      "cap_tiles_range": [lo, hi if hi < float("inf")
                                          else None]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
