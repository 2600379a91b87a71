"""Scene discovery for batch ``--infer`` (``scene_ext`` and
``discover_scenes`` from ``jspsr_tpu/eval/serve.py``). The pipelined
``serve_scenes`` loop is not yet ported."""

from __future__ import annotations

from pathlib import Path

from jspsr_torch.eval.inference import _SCENE_ALIASES, _find_modality


def scene_ext(path) -> str:
    """Output raster extension for a scene: mirror the LR-DEM raster's
    format (flat and <modality>/<file> subdir layouts alike) so .npy
    scenes round-trip without a raster backend."""
    path = Path(path)
    if path.is_file():
        return ".npy" if path.suffix == ".npy" else ".tif"
    lr = _find_modality(path, _SCENE_ALIASES["lr_dem"])
    return ".npy" if (lr is not None and lr.suffix == ".npy") else ".tif"


def discover_scenes(batch_dir) -> list:
    """A batch directory holds one subdirectory per scene (each in the
    load_scene layout). Returns the sorted scene dirs; empty if
    ``batch_dir`` itself looks like a single scene."""
    batch_dir = Path(batch_dir)
    if not batch_dir.is_dir():
        return []
    if _find_modality(batch_dir, _SCENE_ALIASES["lr_dem"]) is not None:
        return []  # single scene
    return [d for d in sorted(batch_dir.iterdir())
            if d.is_dir()
            and _find_modality(d, _SCENE_ALIASES["lr_dem"]) is not None]
