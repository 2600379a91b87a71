"""Procedural mini-DFC30 fixture generator (copy of
``jspsr_tpu/data/synthetic.py``).

Writes a scaled-down dataset matching the DFC30 directory schema
(reference ReadMe.md:28-68, dfc30.py:103-141) as .npy rasters with JSON
geo-profile sidecars: smooth fractal terrain for RGEALTI (GT), a blurred +
biased version for COP30/FABDEM (LR), a terrain-shaded RGB orthophoto,
a 15-channel one-hot land-use mask and a canopy-height raster.

Used by tests and ``chip_smoke.py``; no GDAL required. One change from the
JAX package's copy: the per-city seed is ``zlib.crc32`` of the city name,
not ``hash()``, which string-hash randomisation changes from process to
process, so the same arguments write the same tree in every process.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

from jspsr_torch.data.raster_io import default_profile, write_raster


def _fractal_terrain(rng, size, octaves=4, base=100.0, amp=120.0):
    """Smooth multi-octave value noise via bilinear-upsampled random grids."""
    out = np.zeros((size, size), np.float32)
    for o in range(octaves):
        n = 2 ** (o + 2)
        grid = rng.normal(size=(n, n)).astype(np.float32)
        ys = np.linspace(0, n - 1, size)
        xs = np.linspace(0, n - 1, size)
        y0 = np.clip(ys.astype(int), 0, n - 2)
        x0 = np.clip(xs.astype(int), 0, n - 2)
        ty = (ys - y0)[:, None]
        tx = (xs - x0)[None, :]
        g = (
            grid[y0][:, x0] * (1 - ty) * (1 - tx)
            + grid[y0][:, x0 + 1] * (1 - ty) * tx
            + grid[y0 + 1][:, x0] * ty * (1 - tx)
            + grid[y0 + 1][:, x0 + 1] * ty * tx
        )
        out += g * (amp / (2**o))
    return base + out


def _box_blur(x, k=5):
    pad = k // 2
    xp = np.pad(x, pad, mode="edge")
    c = np.cumsum(np.cumsum(xp, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)
    return s.astype(np.float32)


def generate_city(root, city: str, n_samples: int, size: int = 128,
                  seed: int = 0, resolution: int = 8):
    """Write one city folder with all six modalities."""
    root = Path(root)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(city.encode())]))
    for i in range(n_samples):
        sid = f"DFC-2022-{city[:3].upper()}-{i:04d}"
        gt = _fractal_terrain(rng, size)
        gt = np.clip(gt, -70.0, 900.0)
        # LR DEM: blurred GT + canopy/building bias + noise (bare-earth error)
        canopy = np.clip(
            _fractal_terrain(rng, size, octaves=3, base=0.0, amp=12.0), 0, 67
        )
        lr = _box_blur(gt, 7) + 0.5 * canopy + rng.normal(0, 0.5, gt.shape)
        lr = np.clip(lr, -70.0, 900.0).astype(np.float32)
        # RGB orthophoto: shaded relief + noise
        gy, gx = np.gradient(gt)
        shade = np.clip(128 + 40 * gx - 30 * gy + rng.normal(0, 8, gt.shape),
                        1, 255)
        img = np.stack([shade, 0.9 * shade + 10, 0.8 * shade + 5],
                       axis=2).astype(np.uint8)
        # 15-channel one-hot land-use mask from canopy/elevation bins
        cls = np.clip((gt - gt.min()) / (np.ptp(gt) + 1e-6) * 14.99, 0, 14)
        mask = (np.arange(15)[None, None, :] == cls.astype(int)[:, :, None])
        mask = mask.astype(np.uint8)

        x0 = 300000 + 5000 * i
        y0 = 6600000
        res = float(resolution)
        prof = lambda c, dt: default_profile(size, size, c, dt, x0, y0, res)
        write_raster(root / city / "RGEALTI" / f"{sid}_RGEALTI.npy",
                     gt.astype(np.float32), prof(1, "float32"))
        write_raster(root / city / "COP30" / f"{sid}_COP30.npy",
                     lr, prof(1, "float32"))
        write_raster(root / city / "FABDEM" / f"{sid}_FABDEM.npy",
                     lr + rng.normal(0, 0.2, lr.shape).astype(np.float32),
                     prof(1, "float32"))
        # FATHOM flood-model terrain: a third public product present next
        # to the GT — never loaded as a training modality, but discovered
        # by the offline summary (reference utils/utils.py:1001-1004)
        write_raster(root / city / "FATHOM" / f"{sid}_FATHOM.npy",
                     _box_blur(gt, 9) + rng.normal(0, 1.0, gt.shape)
                     .astype(np.float32),
                     prof(1, "float32"))
        write_raster(root / city / "BDORTHO" / f"{sid}_BDORTHO.npy",
                     img, prof(3, "uint8"))
        write_raster(root / city / "UA2012" / f"{sid}_UA2012.npy",
                     mask, prof(15, "uint8"))
        write_raster(root / city / "CHM" / f"{sid}_CHM.npy",
                     canopy.astype(np.uint8), prof(1, "uint8"))


def generate_mini_dfc30(root, train_cities=("Brest", "Caen"),
                        valid_cities=("Vannes",), n_per_city: int = 3,
                        size: int = 128, seed: int = 0, resolution: int = 8):
    """Generate a miniature DFC30 tree; returns (root, train_set, valid_set)."""
    root = Path(root)
    for c in list(train_cities) + list(valid_cities):
        generate_city(root, c, n_per_city, size=size, seed=seed,
                      resolution=resolution)
    return root, list(train_cities), list(valid_cities)
