"""Elevation scaling (copy of ``jspsr_tpu/data/normalize.py``; reference
data/data_utils.py:289-312,441-457).

- minmax:       y = (x - min) / (max - min)
- log-minmax:   y = log(x - min) / log(max - min) + 1e-8

with an optional relative base (x -> x - base) applied before scaling.
``scale_data`` and ``descale_data`` take numpy arrays (the host pipeline)
or torch tensors; ``modality_scale`` and ``unpack_mask_bits`` are the
device half, on torch tensors. ``make_device_normalize`` (the Trainer's
``device_normalize`` feed) is not yet ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def scale_data(data, elev_min, elev_max, elev_log: bool = False,
               base_elev=0.0):
    """``base_elev`` is a number or, for tensors, a tensor that broadcasts
    against ``data`` (always applied)."""
    if isinstance(base_elev, torch.Tensor) or float(base_elev) != 0.0:
        data = data - base_elev
    if elev_log:
        if isinstance(data, torch.Tensor):
            return torch.log(data - elev_min) / math.log(
                elev_max - elev_min) + 1e-8
        return np.log(data - elev_min) / np.log(elev_max - elev_min) + 1e-8
    return (data - elev_min) / (elev_max - elev_min)


def descale_data(data, elev_min, elev_max, elev_log: bool = False):
    if elev_log:
        if isinstance(data, torch.Tensor):
            return torch.exp(data * math.log(elev_max - elev_min)) + elev_min
        return np.exp(data * np.log(elev_max - elev_min)) + elev_min
    return data * (elev_max - elev_min) + elev_min


def modality_scale(kind: str, x: torch.Tensor, base, *, emin, emax, elog,
                   scale_mask: bool, n_div: int,
                   relative: bool) -> torch.Tensor:
    """ToArray's per-modality scaling (data/transforms.py) on channels-last
    float tensors: the elevation scaling with the relative base, /255
    images, mask channel i scaled by (i+1)/n_div, canopy /68; coordinates
    and unscaled masks pass through."""
    if kind in ("lr_dem", "hr_dem"):
        return scale_data(x, emin, emax, elog,
                          base_elev=base if relative else 0.0)
    if kind == "image":
        return x / 255.0
    if kind == "mask" and scale_mask:
        chans = torch.arange(1, x.shape[-1] + 1, dtype=torch.float32,
                             device=x.device)
        return x * chans / n_div
    if kind == "canopy":
        return x / 68.0
    return x


def unpack_mask_bits(x: torch.Tensor, n_ch: int) -> torch.Tensor:
    """Inverse of np.packbits over the last axis: [..., ceil(C/8)] uint8
    bytes -> [..., C] {0, 1} uint8, big-endian (channel 0 in the MSB)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x.device)
    bits = (x[..., None] >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8)[..., :n_ch]
