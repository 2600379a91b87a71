"""Feathered tile-mosaic machinery (copy of ``jspsr_tpu/eval/mosaic.py``;
reference utils/utils.py:802-967).

The r3 eval protocol predicts 9 overlapping 128x128 tiles per 334x334 scene
and blends them back with linear cross-fade weights over the overlap
strips; the 1D ramps sum to 1 in every overlap by construction. Pure numpy
(the JAX package's native C++ branch is not carried over: the numpy loop
is the function). Generalized to any square n_x x n_x grid.
"""

from __future__ import annotations

import numpy as np

from jspsr_torch.config.loader import get_tile


def edge_ramp(tile_size: int, overlap: int, fade_lo: bool, fade_hi: bool):
    """1D cross-fade weights for one tile edge: ones inside, linear ramp of
    length ``overlap`` (excluding the 1 and 0 endpoints, reference
    utils.py:817-825) toward a neighboring tile."""
    w = np.ones(tile_size, np.float64)
    ramp = np.linspace(1, 0, overlap + 2)[1:-1]
    if fade_hi:
        w[-overlap:] = ramp
    if fade_lo:
        w[:overlap] = ramp[::-1]
    return w


def tile_weight(tile_size: int, overlap: int, row: int, col: int, n_x: int):
    """2D feathering weight for tile (row, col) in an n_x x n_x grid."""
    wr = edge_ramp(tile_size, overlap, row > 0, row < n_x - 1)
    wc = edge_ramp(tile_size, overlap, col > 0, col < n_x - 1)
    return wr[:, None] * wc[None, :]


def merge_tiles(tiles, full_size: int | None = None):
    """Blend n_x^2 equally-sized square tiles (row-major order) into the full
    mosaic with feathered overlaps. tiles: list of (k, k[, C]) arrays."""
    n = len(tiles)
    n_x = int(round(n**0.5))
    assert n_x * n_x == n, f"{n} tiles is not a square grid"
    t0 = np.asarray(tiles[0])
    squeeze = t0.ndim == 2
    k = t0.shape[0]
    if n_x == 1:
        return t0
    if full_size is None:
        raise ValueError("full_size required for multi-tile merge")
    stride, _ = get_tile(full_size, k, n)
    overlap = k - stride
    c = 1 if squeeze else t0.shape[2]
    out = np.zeros((full_size, full_size, c), np.float64)
    for i, tile in enumerate(tiles):
        row, col = i // n_x, i % n_x
        t = np.asarray(tile, np.float64)
        if t.ndim == 2:
            t = t[:, :, None]
        w = tile_weight(k, overlap, row, col, n_x)
        out[stride * row:stride * row + k,
            stride * col:stride * col + k] += t * w[:, :, None]
    out = out.astype(np.float32)
    return out[:, :, 0] if squeeze else out
