"""Modulated deformable 3x3 convolution of one channel (DCNv2), plain
PyTorch with autograd: the op that the SPN head and NLSPN run.

``offset`` (B, 18, H, W) holds tap-major (dy, dx) pairs in row-major kernel
order, ``mask`` (B, 9, H, W) multiplies each tap's bilinear sample, and a
sample takes only its corners that lie on the image (zero elsewhere). The
gradient reaches the positions through the fractional parts only (the
corners stay fixed), as the closed forms of the port's kernels take it.

``CALLS`` records each call's (x shape, offset shape, x needs grad) while
``counting`` is on: the FLOP and byte count (``benchmark.roofline``) reads
it, since ``FlopCounterMode`` sees no op of this gather form."""

from __future__ import annotations

import contextlib

import torch

TAPS = 9
CALLS: list = []
_COUNTING = [False]


@contextlib.contextmanager
def counting():
    """Record every call's shapes into ``CALLS`` (cleared first)."""
    CALLS.clear()
    _COUNTING[0] = True
    try:
        yield CALLS
    finally:
        _COUNTING[0] = False


def positions(offset: torch.Tensor, padding: int = 1):
    """Sampling positions (py, px), each (B, 9, H, W)."""
    b, _, h, w = offset.shape
    dev, dt = offset.device, offset.dtype
    k = torch.arange(3, device=dev, dtype=dt)
    ty = k.repeat_interleave(3).view(1, TAPS, 1, 1)
    tx = k.repeat(3).view(1, TAPS, 1, 1)
    oy = (torch.arange(h, device=dev, dtype=dt) - padding).view(1, 1, h, 1)
    ox = (torch.arange(w, device=dev, dtype=dt) - padding).view(1, 1, 1, w)
    off = offset.view(b, TAPS, 2, h, w)
    return oy + ty + off[:, :, 0], ox + tx + off[:, :, 1]


def bilinear(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """Bilinear samples of x (B, 1, H, W) at (py, px) (B, K, H', W'), zero
    off the image."""
    b, _, h, w = x.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    flat = x.reshape(b, h * w)
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yc, xc = y0 + dy, x0 + dx
        inside = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
        idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
        v = torch.gather(flat, 1, idx.reshape(b, -1)).view_as(idx)
        out = out + wgt * v * inside.to(x.dtype)
    return out


def deform_conv2d(x, offset, weight, bias, mask, padding: int = 1):
    """x (B,1,H,W), offset (B,18,H,W), weight (1,1,3,3), bias (1,), mask
    (B,9,H,W) -> (B,1,H,W)."""
    if _COUNTING[0]:
        CALLS.append((tuple(x.shape), tuple(offset.shape),
                      bool(x.requires_grad)))
    cols = bilinear(x, *positions(offset, padding)) * mask
    y = (cols * weight.reshape(1, TAPS, 1, 1)).sum(1, keepdim=True)
    return y + bias.view(1, 1, 1, 1)


def insert_zero_center_offset(offset: torch.Tensor) -> torch.Tensor:
    """(B, 16, H, W) offsets of the eight outer taps -> (B, 18, H, W) with
    a zero pair at the centre tap."""
    zero = offset.new_zeros(offset.shape[0], 2, *offset.shape[2:])
    return torch.cat([offset[:, :8], zero, offset[:, 8:]], dim=1)
