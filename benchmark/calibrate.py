"""Readings for the limits that decide ``correct``, on the card at a cell's
own size:

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...]

For each seed, one JSON line with the cell's numbers (``compare.py``) for

- ``program``: the port, as a run of the cell computes them (train: the
  Trainer's first three steps; serve: one call over 64 scene entries,
  its seed's sample of ``check_scenes`` rasters), against the reference;
- ``control``: the reference computed with TF32 on (the configs' fp32
  with TF32 off, one precision down), in the port's place;
- the planted faults, the reference with the fault in the port's place:
  train ``half_batch`` (each step on the first half of its batch, the
  mean over those rows); serve ``tile_dropped`` (one tile of each scene
  left out of the blend, an answer altered where it is produced). A state
  left unchanged reads 1 on ``change`` by the measure itself.

The lower reading of a number is the largest ``program`` reading over the
seeds, its upper reading the least of ``control`` and the faults; the
limits in ``workloads/<cell>.json`` lie between (PERF.md)."""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

from benchmark import cells, compare


class _Stop(Exception):
    pass


def train_seed(ctx) -> dict:
    from benchmark.drivers import train as drv

    p, trainer = drv.build(ctx)
    cap = drv.capture(trainer)
    inner, count = trainer.train_step, [0]

    def stopping(inputs, gt):
        out = inner(inputs, gt)
        count[0] += 1
        if count[0] == drv.CAPTURED:
            raise _Stop
        return out

    trainer.train_step = stopping
    try:
        trainer.train_one_epoch(0)
    except _Stop:
        pass
    prog = drv.readings(cap)
    del trainer, cap, inner
    gc.collect()
    torch.cuda.empty_cache()
    ref = drv.reference(ctx, p)
    half = int(p.train_batch_size) // 2
    out = {"program": compare.train_numbers(prog, ref),
           "control": compare.train_numbers(drv.reference(ctx, p, tf32=True),
                                             ref),
           "half_batch": compare.train_numbers(
               drv.reference(ctx, p, rows=slice(0, half)), ref)}
    return {k: {n: v for n, (v, _) in d.items()} for k, d in out.items()}


def serve_seed(ctx) -> dict:
    import numpy as np

    from benchmark.drivers import serve as drv
    from jspsr_torch.eval import scene as scene_mod

    p, dirs, model = drv.build(ctx)
    scenes = drv.entries(ctx, dirs, "cal", len(dirs))
    drv.serve(ctx, p, model, scenes, ctx.tmp / "out")
    del model
    scene_mod._RUNNER_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    sample = [scenes[i] for i in drv.check_sample(ctx, len(scenes))]
    ref = drv.reference_rasters(ctx, p, sample)

    def err(rasters):
        return max(float(np.abs(a - b).max()) for a, b in zip(rasters, ref))

    got = [np.load(ctx.tmp / "out" / f"{s.name}_sr.npy")[..., 0]
           .astype(np.float64) for s in sample]
    return {"program": {"raster_m": err(got)},
            "control": {"raster_m": err(drv.reference_rasters(
                ctx, p, sample, tf32=True))},
            "tile_dropped": {"raster_m": err(drv.reference_rasters(
                ctx, p, sample, drop_centre=True))}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    kind = cells.cell(args.workload)["driver"]
    fn = {"train": train_seed, "serve": serve_seed}[kind]
    for seed in args.seeds:
        tmp = Path(tempfile.mkdtemp(prefix="jspsr_cal_"))
        try:
            ctx = cells.Ctx.load(args.workload, seed=seed, seconds=0,
                                 trace=False, tmp=tmp)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              **fn(ctx)}), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
