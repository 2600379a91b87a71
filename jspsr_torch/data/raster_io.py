"""Host-side raster IO (copy of the reading, writing and naming half of
``jspsr_tpu/data/raster_io.py``).

rasterio when available (keeps real GeoTIFF profiles), tifffile or cv2
otherwise, and a pure-numpy ``.npy`` format with a JSON sidecar profile
that needs nothing but numpy.

A 'profile' is a plain dict (not a rasterio object):
  {transform: [a, b, c, d, e, f], width, height, count, dtype, crs}
with the affine coefficient order of rasterio.Affine
(x_res, 0, x_origin, 0, -y_res, y_origin).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

try:
    import rasterio  # type: ignore

    HAS_RASTERIO = True
except ImportError:  # pragma: no cover
    rasterio = None
    HAS_RASTERIO = False

try:
    import tifffile  # type: ignore

    HAS_TIFFFILE = True
except ImportError:  # pragma: no cover
    tifffile = None
    HAS_TIFFFILE = False

try:
    import cv2  # type: ignore

    HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    HAS_CV2 = False


def default_profile(h: int, w: int, count: int = 1, dtype: str = "float32",
                    x0: float = 0.0, y0: float = 0.0, res: float = 1.0):
    return {
        "transform": [res, 0.0, x0, 0.0, -res, y0],
        "width": int(w),
        "height": int(h),
        "count": int(count),
        "dtype": dtype,
        "crs": "EPSG:2154",
    }


def affine_xy(transform, col: float, row: float):
    """Apply the affine profile transform to (col, row) -> (x, y)."""
    a, b, c, d, e, f = transform
    return a * col + b * row + c, d * col + e * row + f


def read_raster(path, with_profile: bool = False):
    """Read HWC numpy array (+ plain-dict profile)."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if not with_profile:
            return arr
        side = path.with_suffix(".json")
        if side.exists():
            profile = json.loads(side.read_text())
        else:
            profile = default_profile(arr.shape[0], arr.shape[1], arr.shape[2],
                                      str(arr.dtype))
        return arr, profile

    if HAS_RASTERIO:
        with rasterio.open(path) as ds:
            arr = np.transpose(ds.read(), (1, 2, 0))
            if not with_profile:
                return arr
            t = ds.transform
            profile = {
                "transform": [t.a, t.b, t.c, t.d, t.e, t.f],
                "width": ds.width,
                "height": ds.height,
                "count": ds.count,
                "dtype": str(arr.dtype),
                "crs": str(ds.crs),
            }
            return arr, profile
    if HAS_TIFFFILE:
        arr = tifffile.imread(str(path))
        if arr.ndim == 2:
            arr = arr[:, :, None]
        elif arr.ndim == 3 and arr.shape[0] < arr.shape[2] and arr.shape[0] <= 16:
            arr = np.transpose(arr, (1, 2, 0))  # CHW tiffs
    elif HAS_CV2:
        arr = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise IOError(f"cv2 failed to read {path}")
        if arr.ndim == 2:
            arr = arr[:, :, None]
        elif arr.shape[2] == 3:
            arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    else:  # pragma: no cover
        raise ImportError("No raster backend available (rasterio/tifffile/cv2)")
    if not with_profile:
        return arr
    return arr, default_profile(arr.shape[0], arr.shape[1], arr.shape[2],
                                str(arr.dtype))


def write_raster(path, arr: np.ndarray, profile: dict | None = None):
    """Write HWC array; .npy+sidecar always works, .tif needs rasterio."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if path.suffix == ".npy":
        np.save(path, arr)
        if profile is not None:
            path.with_suffix(".json").write_text(json.dumps(profile))
        return
    if HAS_RASTERIO:
        profile = profile or default_profile(arr.shape[0], arr.shape[1],
                                             arr.shape[2], str(arr.dtype))
        t = profile["transform"]
        with rasterio.open(
            path, "w", driver="GTiff", height=arr.shape[0], width=arr.shape[1],
            count=arr.shape[2], dtype=arr.dtype,
            transform=rasterio.Affine(*t), crs=profile.get("crs"),
        ) as ds:
            ds.write(np.transpose(arr, (2, 0, 1)))
        return
    if HAS_TIFFFILE:
        tifffile.imwrite(str(path), arr)
        return
    raise ImportError(f"No writer for {path.suffix}")


_NAT_RE = re.compile(r"(\d+)")


def natsort_key(s: str):
    """Natural-sort key (replacement for the natsort dependency)."""
    return [int(t) if t.isdigit() else t.lower() for t in _NAT_RE.split(str(s))]


def natsorted(seq):
    return sorted(seq, key=natsort_key)
