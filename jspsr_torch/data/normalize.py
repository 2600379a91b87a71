"""Elevation scaling (copy of ``jspsr_tpu/data/normalize.py``; reference
data/data_utils.py:289-312,441-457).

- minmax:       y = (x - min) / (max - min)
- log-minmax:   y = log(x - min) / log(max - min) + 1e-8

with an optional relative base (x -> x - base) applied before scaling.
``scale_data`` and ``descale_data`` take numpy arrays (the host pipeline)
or torch tensors; ``modality_scale``, ``unpack_mask_bits`` and
``make_device_normalize`` (the raw feed of ``device_normalize``) are the
device half, on torch tensors.
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


def modality_scaling(p) -> dict:
    """``modality_scale``'s keyword arguments, from config ``p``."""
    tk = p.tensor_kwargs or {}
    return {"emin": tk.get("min"), "emax": tk.get("max"),
            "elog": tk.get("log", False),
            "scale_mask": tk.get("scale_mask", False),
            "n_div": len(p.get("mask_channel") or list(range(15))) + 1,
            "relative": bool(p.get("relative"))}


def unpack_mask_bits(x: torch.Tensor, n_ch: int) -> torch.Tensor:
    """Inverse of np.packbits over the last axis: [..., ceil(C/8)] uint8
    bytes -> [..., C] {0, 1} uint8, big-endian (channel 0 in the MSB)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x.device)
    bits = (x[..., None] >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8)[..., :n_ch]


def make_device_normalize(p):
    """The raw feed's normaliser (``device_normalize: true``; the JAX
    package's ``make_device_normalize``): ``normalize(inputs, gt, base)``
    takes a batch of RAW channels-last crops on the device, as the host
    ships them (uint8 images, masks and canopy, fp32 DEMs; with
    ``pack_mask`` the mask bit-packed by ``data.loader.pack_mask_np``),
    in ``data.loader.input_kinds`` order, the (B, H, W, 1) ground truth and
    the (B,) relative bases, and returns ``(inputs, gt)`` as NCHW fp32
    tensors in [0, 1] with canonical strides: ToArray's arithmetic (/255 images, the
    log-minmax elevation scaling with the relative base, the mask's
    channel scaling, canopy /68) on the device, as ``modality_scale``.

    Supported case (the Trainer asserts it): per-modality input models
    (JSPSR, LRRU), no stats Normalize list, the default [0, 1] ranges."""
    from jspsr_torch.data.loader import input_kinds

    kinds = input_kinds(p.input_data)
    scale = modality_scaling(p)
    mask_ch = scale["n_div"] - 1
    pack_mask = bool(p.get("pack_mask"))

    def nchw(x):
        # canonical NCHW strides: ``.contiguous()`` keeps a one-channel
        # view's (H*W, 1, W, 1), which cuDNN reads as channels-last and
        # then runs other algorithms than for the host feed's tensors
        return x.permute(0, 3, 1, 2).clone(
            memory_format=torch.contiguous_format)

    def normalize(inputs, gt, base):
        b = base.to(torch.float32).view(-1, 1, 1, 1)
        out = []
        for x, kind in zip(inputs, kinds):
            if kind == "mask" and pack_mask:
                x = unpack_mask_bits(x, mask_ch)
            out.append(nchw(modality_scale(kind, x.to(torch.float32), b,
                                           **scale)))
        return out, nchw(modality_scale("hr_dem", gt.to(torch.float32), b,
                                        **scale))

    return normalize
