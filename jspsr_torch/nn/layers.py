"""Core layers (counterpart of ``jspsr_tpu/nn/layers.py``).

The port's models use torch's NCHW / OIHW ``nn.Conv2d``,
``nn.ConvTranspose2d``, ``nn.BatchNorm2d``, ``nn.Linear`` (the JAX
``Dense``, whose (in, out) weight is torch's transposed) and
``nn.LayerNorm`` (eps 1e-5 unless a module says otherwise) directly: their
padding, output-size and normalisation semantics are the ones the JAX
package reproduces. What remains here is the JAX package's init, its global
pools and its bilinear and bicubic resizes.

The JAX package's TPU lowering levers (space-to-depth stride-2 convs, the
stride-1 conv custom VJP, the wgrad dot) are exact re-expressions of the
same functions and have no counterpart here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jspsr_torch.nn.initializers import trunc_normal_fan_in_


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, 1, 1) mean pool (AdaptiveAvgPool2d(1))."""
    return x.mean(dim=(2, 3), keepdim=True)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, 1, 1) max pool (AdaptiveMaxPool2d(1))."""
    return x.amax(dim=(2, 3), keepdim=True)


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0))


def resize_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """Dense (out, in) float64 interpolation matrix of ``F.interpolate``
    without antialias: ``'bilinear'`` and ``'bicubic'`` (a = -0.75) at
    half-pixel centres with clamped borders, ``'bilinear_ac'`` with
    ``align_corners=True`` (the JAX package's ``_resize_matrix`` and
    ``_resize_matrix_ac``, which round it to fp32; the callers round it to
    their type)."""
    if mode == "bilinear_ac":
        src = (np.zeros(1) if out_size == 1 else
               np.arange(out_size) * (in_size - 1) / (out_size - 1))
        i0 = np.clip(np.floor(src).astype(np.int64), 0, max(in_size - 2, 0))
        t = src - i0
        mat = np.zeros((out_size, in_size))
        mat[np.arange(out_size), i0] += 1 - t
        mat[np.arange(out_size), np.minimum(i0 + 1, in_size - 1)] += t
        return mat
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    if mode == "bicubic":
        idx = np.floor(src).astype(np.int64)[:, None] - 1 + np.arange(4)
        w = _cubic_kernel(src[:, None] - idx, -0.75)
    elif mode == "bilinear":
        idx = np.floor(src).astype(np.int64)[:, None] + np.arange(2)
        w = np.maximum(0.0, 1.0 - np.abs(src[:, None] - idx))
    else:
        raise ValueError(mode)
    idx = np.clip(idx, 0, in_size - 1)
    mat = np.zeros((out_size, in_size))
    np.add.at(mat, (np.repeat(np.arange(out_size), idx.shape[1]),
                    idx.ravel()), w.ravel())
    return mat


class _Resize(torch.autograd.Function):
    """``F.interpolate``'s values (no antialias), and their gradient as the
    JAX package computes a resize (``_matmul_resize``): two products with
    the transposed interpolation matrices, rows then columns. No atomics,
    so the backward gives the same bits on every run on the card, where
    ``F.interpolate``'s own backward sums with atomics.

    The forward stays ``F.interpolate``: as two matrix products it gives
    the same values up to fp32 rounding, but that rounding moved two of
    CompletionFormer's ill-conditioned weight gradients on the card
    (``chip_smoke.py`` phase 6) past the rule that holds each within three
    times the CPU's distance from float64 plus 5e-3, which they meet with
    ``F.interpolate``'s forward; serving's forward also keeps the values it
    had."""

    @staticmethod
    def forward(ctx, x, h, w, mode):
        ctx.mode, ctx.in_hw = mode, tuple(x.shape[-2:])
        return F.interpolate(x, size=(h, w),
                             mode="bicubic" if mode == "bicubic"
                             else "bilinear",
                             align_corners=mode == "bilinear_ac")

    @staticmethod
    def backward(ctx, g):
        (in_h, in_w), (h, w) = ctx.in_hw, g.shape[-2:]
        ah = _device_matrix(in_h, h, ctx.mode, g.device, g.dtype)
        aw = _device_matrix(in_w, w, ctx.mode, g.device, g.dtype)
        return torch.matmul(torch.matmul(ah.T, g), aw), None, None, None


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size: int, out_size: int, mode: str,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``resize_matrix`` on ``device`` in ``dtype``, made once per shape: a
    copy from pageable host memory on every call would hold the host until
    the card caught up. Read only."""
    return torch.from_numpy(resize_matrix(in_size, out_size, mode)).to(
        device, dtype)


def _resize(x: torch.Tensor, h: int, w: int, mode: str) -> torch.Tensor:
    if tuple(x.shape[-2:]) == (h, w):
        return x
    return _Resize.apply(x, h, w, mode)


def bilinear_resize(x: torch.Tensor, h: int, w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """NCHW bilinear resize to (h, w): ``F.interpolate`` without antialias
    (the JAX package's ``bilinear_resize`` reproduces it, when shrinking
    too), with a backward that has no atomics (``_Resize``); the input
    itself when the size already matches."""
    return _resize(x, h, w, "bilinear_ac" if align_corners else "bilinear")


def bicubic_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW bicubic resize to (h, w): ``F.interpolate(mode='bicubic',
    align_corners=False)`` (a = -0.75, half-pixel centres; the JAX
    package's ``bicubic_resize``), with ``_Resize``'s backward."""
    return _resize(x, h, w, "bicubic")


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init, in module registration order: truncated-normal
    fan-in conv weights (fan-in = kh*kw*in_channels for both conv kinds),
    zero conv biases, BatchNorm at scale 1, bias 0, mean 0, var 1; Linear
    weights normal at std 0.02 with zero bias, LayerNorm at scale 1, bias 0;
    and the PVT position embeddings (parameters named ``pos_embed*``)
    normal at std 0.02."""
    for m in module.modules():
        for name, param in m.named_parameters(recurse=False):
            if name.startswith("pos_embed"):
                param.normal_(0.0, 0.02, generator=generator)
        if isinstance(m, nn.Conv2d):
            trunc_normal_fan_in_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, nn.ConvTranspose2d):
            kh, kw = m.kernel_size
            trunc_normal_fan_in_(m.weight, kh * kw * m.in_channels, generator)
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
