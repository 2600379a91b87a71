"""Tiled scene inference in plain PyTorch and numpy, as the reference's
r3 protocol defines it (xandercai/JSPSR ``utils/utils.py``): a scene of
side S is cut into an n x n grid of ``tile``² tiles at stride
(S - tile) / (n - 1), n = (S - S mod tile) / tile + 1 (334 -> 3 x 3 at
stride 103); each tile is predicted; the tiles are blended with linear
cross-fade weights over each overlap strip (ones inside, a ramp of
``overlap`` steps excluding its end points toward a neighbour), clipped
to [0, 1], descaled from log-minmax to metres and shifted by the scene's
base (the minimum of its low-resolution DEM).

Inputs are scaled as the training feed scales them
(``reference/feed.py``). Only exact grids are supported."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.feed import model_inputs


def grid(size: int, tile: int):
    n = (size - size % tile) // tile + 1
    if n < 2 or (size - tile) % (n - 1):
        raise ValueError(f"no exact tile grid for {size} at tile {tile}")
    return (size - tile) // (n - 1), n


def ramp(tile: int, overlap: int, lo: bool, hi: bool) -> np.ndarray:
    w = np.ones(tile)
    r = np.linspace(1, 0, overlap + 2)[1:-1]
    if hi:
        w[-overlap:] = r
    if lo:
        w[:overlap] = r[::-1]
    return w


def scene_inputs(scene_dir, tk: dict):
    """([lr_dem, image, mask] (1, C, S, S) float32 tensors, base)."""
    lr = np.load(scene_dir / "lr_dem.npy").astype(np.float64)
    base = float(lr.min())
    emin, emax = tk["min"], tk["max"]
    dem = np.log(lr - base - emin) / np.log(emax - emin) + 1e-8
    img = np.load(scene_dir / "image.npy").astype(np.float64) / 255.0
    mask = np.load(scene_dir / "mask.npy").astype(np.float64)
    mask = mask * np.arange(1, mask.shape[-1] + 1) / (mask.shape[-1] + 1)
    return [torch.from_numpy(a.transpose(2, 0, 1)[None].astype(np.float32))
            for a in (dem, img, mask)], base


def serve(model, scene_dirs: list, tk: dict, device, tile: int = 128,
          drop_centre: bool = False, model_name: str = "JSPSR"):
    """The metre rasters (S, S) float64 of ``scene_dirs``, their tiles in
    one batch per call; ``drop_centre`` leaves the grid's centre tile of
    every scene out of the blend (a planted fault)."""
    inputs, bases = zip(*(scene_inputs(d, tk) for d in scene_dirs))
    size = inputs[0][0].shape[-1]
    stride, n = grid(size, tile)
    tiles = [torch.cat([x[k][..., stride * (t // n):stride * (t // n) + tile,
                             stride * (t % n):stride * (t % n) + tile]
                        for x in inputs for t in range(n * n)]).to(device)
             for k in range(3)]
    model.eval()
    with torch.no_grad():
        pred = model(model_inputs(tiles, model_name))
    pred = pred.double().cpu().numpy()[:, 0]
    overlap = tile - stride
    out = []
    for s, base in enumerate(bases):
        mos = np.zeros((size, size))
        for t in range(n * n):
            if drop_centre and t == n * n // 2:
                continue
            r, c = t // n, t % n
            w = ramp(tile, overlap, r > 0, r < n - 1)[:, None] \
                * ramp(tile, overlap, c > 0, c < n - 1)[None, :]
            mos[stride * r:stride * r + tile,
                stride * c:stride * c + tile] += pred[s * n * n + t] * w
        mos = np.clip(mos, 0.0, 1.0)
        out.append(np.exp(mos * math.log(tk["max"] - tk["min"]))
                   + tk["min"] + base)
    return out
