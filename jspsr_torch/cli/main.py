"""CLI entry point (counterpart of ``jspsr_tpu/cli/main.py``):

  python -m jspsr_torch.cli.main --config c.yml            # train (fit)
  python -m jspsr_torch.cli.main --config c.yml --val      # validate only
  python -m jspsr_torch.cli.main --config c.yml --infer <scene> [--out o.npy]
  python -m jspsr_torch.cli.main --config c.yml --infer <dir of scenes>
  python -m jspsr_torch.cli.main --config c.yml --infer <scene|dir> --tile

--infer runs inference on a raster, a scene directory (one raster per
modality) or a directory of scene directories, and writes the upscaled DEM
in metres. Without --tile each scene runs whole, one after the other. With
--tile a scene runs device-tiled (``eval/scene.py``) and a directory of
scenes goes through the pipelined server (``eval/serve.py``), batching
``infer_scene_batch`` scenes per run (default: ``auto_scene_batch``); a
config the device-tiled path does not cover falls back to the host tiled
path, scene by scene. It runs on the card (``--device cuda``, the default)
unless ``--device cpu`` is given.

Without --infer it trains: ``Trainer(p).fit()``, after
``trainer.load(model_kwargs.checkpoint, resume=p.resume)`` when the config
names a checkpoint. --val (or ``val_weight: true`` in the config)
validates that checkpoint instead: the eval with the bicubic-input
baseline, the predictions saved, then the whole-split summary. --export is
not yet ported and raises.
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
                    help="validate model_kwargs.checkpoint only")
    ap.add_argument("--result-dir", default=None)
    ap.add_argument("--infer", default=None, metavar="SCENE",
                    help="inference: LR-DEM raster, scene dir or dir of "
                         "scene dirs (needs model_kwargs.checkpoint)")
    ap.add_argument("--out", default=None,
                    help="--infer output: raster path for a single scene, "
                         "output DIRECTORY for a batch of scenes")
    ap.add_argument("--tile", action="store_true",
                    help="device-tiled inference; pipelined batch serving "
                         "for a directory of scenes")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="deployment artifact (not yet ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.export:
        raise NotImplementedError("--export is not yet ported")
    p = create_config(args.config)
    ckpt = p.model_kwargs.get("checkpoint")

    from jspsr_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    stamp = datetime.now().strftime("%m%d_%H%M")
    result_dir = Path(args.result_dir or
                      Path(p.get("work_root", ".")) / "results" / f"{stamp}_{p.name}")
    result_dir.mkdir(parents=True, exist_ok=True)
    sys.stdout = Logger(result_dir / "train.log")
    if not args.infer:
        return _train_or_validate(p, args, ckpt, result_dir, device)
    if not ckpt:
        raise ValueError("--infer requires model_kwargs.checkpoint")

    from jspsr_torch.eval.inference import run_scene_inference
    from jspsr_torch.eval.scene import device_tiling_supported
    from jspsr_torch.eval.serve import (
        auto_scene_batch,
        discover_scenes,
        probe_scene_hw,
        scene_ext,
        serve_scenes,
    )
    from jspsr_torch.models.factory import build_model
    from jspsr_torch.train.checkpoint import load_model_params

    model = load_model_params(build_model(p), ckpt)
    tile = p.get("patch_size", 128)

    scenes = discover_scenes(args.infer)
    if scenes:
        out_dir = Path(args.out or result_dir / "predictions")
        if (args.tile and device_tiling_supported(p)
                and p.get("infer_device_tiling", True)):
            # the pipelined server; infer_scene_batch overrides the
            # size-aware default
            sb = int(p.get("infer_scene_batch") or 0)
            if not sb:
                try:
                    sb = auto_scene_batch(probe_scene_hw(scenes[0]),
                                          tile=tile, n_scenes=len(scenes))
                except Exception as e:
                    print(f"[serve] scene probe failed ({e}); "
                          f"scene_batch=4")
                    sb = min(4, len(scenes))
            paths, t_ms, sps = serve_scenes(
                model, p, scenes, out_dir, tile=tile, scene_batch=sb,
                loader_threads=int(p.get("infer_loader_threads") or 1),
                device=device)
        else:
            # whole-scene per scene (no --tile), or the host tiled path
            # for config surfaces the device-tiled path does not cover
            t0 = time.perf_counter_ns()
            paths = []
            for s in scenes:
                path, ms, mem = run_scene_inference(
                    model, p, s, out_dir / f"{s.name}_sr{scene_ext(s)}",
                    tile=args.tile, device=device)
                print(f"Scene {s.name}: {ms:.1f} ms, peak {mem:.0f} MB")
                paths.append(path)
            t_ms = (time.perf_counter_ns() - t0) // 1000 / 1000
            sps = len(paths) / max(t_ms, 1e-9) * 1000
        print(f"Inference: {len(paths)} scenes -> {out_dir} "
              f"({t_ms:.1f} ms, {sps:.2f} scenes/s)")
        return paths

    out = args.out or str(result_dir / "upscaled_dem.tif")
    path, t_ms, mem = run_scene_inference(model, p, args.infer, out,
                                          tile=args.tile, device=device)
    print(f"Inference: {path} ({t_ms:.1f} ms, peak {mem:.0f} MB)")
    return path


def _train_or_validate(p, args, ckpt, result_dir, device):
    """Training (``Trainer.fit``), or with --val / ``val_weight`` the
    validation of ``ckpt`` (reference main.py:148-161)."""
    from jspsr_torch.train.trainer import Trainer

    if args.val or p.get("val_weight"):
        if not ckpt:
            raise ValueError(
                "val_weight/--val requires model_kwargs.checkpoint")
        trainer = Trainer(p, result_dir=result_dir, device=device)
        trainer.load(ckpt, resume=False)
        pred_dir = result_dir / "predictions"
        result = trainer.evaluate(compare_input=True, save_dir=pred_dir)
        print(f"Validation: {result}")
        trainer.summarise(pred_dir)
        return result
    trainer = Trainer(p, result_dir=result_dir, device=device)
    if ckpt:
        trainer.load(ckpt, resume=bool(p.get("resume")))
    return trainer.fit()


if __name__ == "__main__":
    main()
