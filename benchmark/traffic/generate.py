"""The benchmark's one traffic generator: synthetic terrain in the DFC30
layout, from a seed, vectorised over samples.

A traffic file (``benchmark/traffic/<name>.json``) has a ``kind``:

- ``dfc30_tree``: a training tree, ``<root>/<city>/{COP30,BDORTHO,RGEALTI,
  UA2012}/<id>_<modality>.npy`` for each city of ``train_cities`` and
  ``valid_cities``, ``n_per_city`` (``n_valid_per_city``) samples of
  ``size``² each (the modalities the shipped configs read: the LR DEM,
  the RGB orthophoto, the ground truth and the 15-class one-hot land-use
  mask);
- ``scenes``: ``n_scenes`` distinct scene directories
  ``<root>/s<i>/{lr_dem,image,mask}.npy`` of ``side``², as
  ``--infer <dir> --tile`` reads them.

The terrain is a base height (U(0, ``base_max``) m) plus four octaves of
bilinearly upsampled Gaussian grids (4² to 32² nodes, amplitude 120 m
halving per octave), clipped to +-300 m of relief so that every sample
lies inside the configs' elevation range. The LR DEM is the terrain box
blurred over 7 px plus half a canopy layer (three octaves, 0-67 m) plus
N(0, 0.5) m noise; the image a shaded relief; the mask the terrain's
height bins. Each city (or the scene set) draws from
``SeedSequence([seed, crc32(name)])``."""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def _interp(size: int, n: int) -> np.ndarray:
    """(size, n) bilinear upsampling matrix of n nodes onto size pixels."""
    pos = np.linspace(0, n - 1, size)
    i0 = np.clip(pos.astype(int), 0, n - 2)
    t = pos - i0
    m = np.zeros((size, n), np.float32)
    m[np.arange(size), i0] = 1 - t
    m[np.arange(size), i0 + 1] = t
    return m


def _octaves(rng, n: int, size: int, octaves: int, amp: float) -> np.ndarray:
    out = np.zeros((n, size, size), np.float32)
    for o in range(octaves):
        g = 2 ** (o + 2)
        m = _interp(size, g)
        grid = rng.standard_normal((n, g, g), dtype=np.float32)
        out += (amp / 2 ** o) * (m @ grid @ m.T)
    return out


def _box_blur(x: np.ndarray, k: int) -> np.ndarray:
    """Mean over a k x k window with edge padding, per sample (N, H, W)."""
    pad = k // 2
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
    c = np.pad(xp.cumsum(1).cumsum(2), ((0, 0), (1, 0), (1, 0)))
    return ((c[:, k:, k:] - c[:, :-k, k:] - c[:, k:, :-k] + c[:, :-k, :-k])
            / (k * k)).astype(np.float32)


def terrain(rng, n: int, size: int, base_max: float = 500.0) -> dict:
    """``n`` samples of ``size``²: {gt, lr (N, S, S) float32 m, image
    (N, S, S, 3) uint8, mask (N, S, S, 15) uint8 one-hot}."""
    base = rng.uniform(0.0, base_max, (n, 1, 1)).astype(np.float32)
    gt = base + np.clip(_octaves(rng, n, size, 4, 120.0), -300.0, 300.0)
    canopy = np.clip(_octaves(rng, n, size, 3, 12.0), 0.0, 67.0)
    lr = (_box_blur(gt, 7) + 0.5 * canopy
          + rng.normal(0.0, 0.5, gt.shape).astype(np.float32))
    gy, gx = np.gradient(gt, axis=(1, 2))
    shade = np.clip(128 + 40 * gx - 30 * gy
                    + rng.normal(0.0, 8.0, gt.shape), 1, 255)
    image = np.stack([shade, 0.9 * shade + 10, 0.8 * shade + 5],
                     axis=-1).astype(np.uint8)
    lo = gt.min(axis=(1, 2), keepdims=True)
    span = gt.max(axis=(1, 2), keepdims=True) - lo + 1e-6
    cls = np.clip((gt - lo) / span * 14.99, 0, 14).astype(np.int64)
    mask = (np.arange(15) == cls[..., None]).astype(np.uint8)
    return {"gt": gt.astype(np.float32), "lr": lr.astype(np.float32),
            "image": image, "mask": mask}


def _rng(seed: int, name: str):
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), zlib.crc32(name.encode())]))


def write_tree(root, spec: dict, seed: int) -> Path:
    """A DFC30 tree for a ``dfc30_tree`` traffic spec; returns its root."""
    root = Path(root)
    cities = [(c, spec["n_per_city"]) for c in spec["train_cities"]]
    cities += [(c, spec["n_valid_per_city"]) for c in spec["valid_cities"]]
    for city, n in cities:
        t = terrain(_rng(seed, city), n, spec["size"], spec["base_max"])
        for mod, key in (("RGEALTI", "gt"), ("COP30", "lr"),
                         ("BDORTHO", "image"), ("UA2012", "mask")):
            d = root / city / mod
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                arr = t[key][i]
                np.save(d / f"DFC-{city[:3].upper()}-{i:04d}_{mod}.npy",
                        arr[..., None] if arr.ndim == 2 else arr)
    return root


def tree_files(root, spec: dict, cities: list) -> list:
    """The tree's training samples in the loader's order, the cities in the
    order of ``cities`` (the config's ``train_set``) that the tree holds:
    a list of {lr_dem, image, mask, hr_dem: path}."""
    root = Path(root)
    n = spec["n_per_city"]
    cities = [c for c in cities if c in spec["train_cities"]]
    out = []
    for city in cities:
        for i in range(n):
            sid = f"DFC-{city[:3].upper()}-{i:04d}"
            out.append({k: root / city / mod / f"{sid}_{mod}.npy"
                        for k, mod in (("lr_dem", "COP30"),
                                       ("image", "BDORTHO"),
                                       ("mask", "UA2012"),
                                       ("hr_dem", "RGEALTI"))})
    return out


def write_scenes(root, spec: dict, seed: int) -> list:
    """The scene directories of a ``scenes`` traffic spec, in order."""
    root = Path(root)
    t = terrain(_rng(seed, "scenes"), spec["n_scenes"], spec["side"],
                spec["base_max"])
    dirs = []
    for i in range(spec["n_scenes"]):
        d = root / f"s{i:03d}"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "lr_dem.npy", t["lr"][i][..., None])
        np.save(d / "image.npy", t["image"][i])
        np.save(d / "mask.npy", t["mask"][i])
        dirs.append(d)
    return dirs
