"""CLI entry point (counterpart of ``jspsr_tpu/cli/main.py``):

  python -m jspsr_torch.cli.main --config c.yml --infer <scene> [--out o.npy]
  python -m jspsr_torch.cli.main --config c.yml --infer <dir of scenes>

--infer runs whole-scene inference on a raster, a scene directory (one
raster per modality) or a directory of scene directories (one after the
other), and writes the upscaled DEM in metres. It runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given.
--tile, --val, --export and training through the CLI (which needs the
eval loop for ``Trainer.fit``) are not yet ported and raise; the epoch
loop is ``jspsr_torch.train.trainer.Trainer(p).train_one_epoch``.
"""

from __future__ import annotations

import argparse
import sys
import time
from datetime import datetime
from pathlib import Path

from jspsr_torch.config.loader import create_config
from jspsr_torch.utils.logging import Logger


def parse_args(argv=None):
    ap = argparse.ArgumentParser("jspsr-torch")
    ap.add_argument("--config", required=True, help="experiment yaml/json")
    ap.add_argument("--val", action="store_true",
                    help="validate only (not yet ported)")
    ap.add_argument("--result-dir", default=None)
    ap.add_argument("--infer", default=None, metavar="SCENE",
                    help="whole-scene inference: LR-DEM raster, scene dir or "
                         "dir of scene dirs (needs model_kwargs.checkpoint)")
    ap.add_argument("--out", default=None,
                    help="--infer output: raster path for a single scene, "
                         "output DIRECTORY for a batch of scenes")
    ap.add_argument("--tile", action="store_true",
                    help="tile-parallel inference (not yet ported)")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="deployment artifact (not yet ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag in ("tile", "val", "export"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not yet ported")
    if not args.infer:
        raise NotImplementedError(
            "training through the CLI is not yet ported (Trainer.fit needs "
            "the eval loop); use --infer, or Trainer(p).train_one_epoch")
    p = create_config(args.config)
    ckpt = p.model_kwargs.get("checkpoint")
    if not ckpt:
        raise ValueError("--infer requires model_kwargs.checkpoint")

    from jspsr_torch.eval.inference import run_scene_inference
    from jspsr_torch.eval.serve import discover_scenes, scene_ext
    from jspsr_torch.models.factory import build_model
    from jspsr_torch.train.checkpoint import load_model_params
    from jspsr_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    stamp = datetime.now().strftime("%m%d_%H%M")
    result_dir = Path(args.result_dir or
                      Path(p.get("work_root", ".")) / "results" / f"{stamp}_{p.name}")
    result_dir.mkdir(parents=True, exist_ok=True)
    sys.stdout = Logger(result_dir / "train.log")

    model = load_model_params(build_model(p), ckpt)

    scenes = discover_scenes(args.infer)
    if scenes:
        # a directory of scene directories: whole-scene inference per scene
        out_dir = Path(args.out or result_dir / "predictions")
        t0 = time.perf_counter_ns()
        paths = []
        for s in scenes:
            path, ms, mem = run_scene_inference(
                model, p, s, out_dir / f"{s.name}_sr{scene_ext(s)}",
                device=device)
            print(f"Scene {s.name}: {ms:.1f} ms, peak {mem:.0f} MB")
            paths.append(path)
        t_ms = (time.perf_counter_ns() - t0) // 1000 / 1000
        sps = len(paths) / max(t_ms, 1e-9) * 1000
        print(f"Inference: {len(paths)} scenes -> {out_dir} "
              f"({t_ms:.1f} ms, {sps:.2f} scenes/s)")
        return paths

    out = args.out or str(result_dir / "upscaled_dem.tif")
    path, t_ms, mem = run_scene_inference(model, p, args.infer, out,
                                          device=device)
    print(f"Inference: {path} ({t_ms:.1f} ms, peak {mem:.0f} MB)")
    return path


if __name__ == "__main__":
    main()
