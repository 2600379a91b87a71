"""Dataset preparation (copy of ``jspsr_tpu/utils/geo_prep.py``): crop
sample subsets out of large rasters (reference utils/utils.py:758-799
gen_crop_subset, which used rioxarray).

Backend-agnostic: works on (array, plain-dict profile) pairs from raster_io;
uses real GeoTIFF IO when rasterio is present.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from jspsr_torch.data.raster_io import read_raster, write_raster


def crop_raster(arr: np.ndarray, profile: dict, row0: int, col0: int,
                height: int, width: int):
    """Pixel-window crop with geo-profile update."""
    out = arr[row0:row0 + height, col0:col0 + width]
    prof = dict(profile)
    if prof.get("transform"):
        a, b, c, d, e, f = prof["transform"]
        prof["transform"] = [a, b, c + a * col0, d, e, f + e * row0]
    prof["height"] = int(out.shape[0])
    prof["width"] = int(out.shape[1])
    return out, prof


def gen_crop_subset(src_path, out_dir, crop_size: int, stride: int | None = None,
                    prefix: str | None = None, suffix: str = ".npy"):
    """Split one large raster into a regular grid of crop_size tiles,
    writing each with its shifted geo profile. Returns written paths."""
    arr, profile = read_raster(src_path, with_profile=True)
    stride = stride or crop_size
    prefix = prefix or Path(src_path).stem
    out_dir = Path(out_dir)
    paths = []
    h, w = arr.shape[:2]
    idx = 0
    for r0 in range(0, h - crop_size + 1, stride):
        for c0 in range(0, w - crop_size + 1, stride):
            tile, prof = crop_raster(arr, profile, r0, c0, crop_size, crop_size)
            path = out_dir / f"{prefix}-{idx:04d}{suffix}"
            write_raster(path, np.ascontiguousarray(tile), prof)
            paths.append(path)
            idx += 1
    return paths
