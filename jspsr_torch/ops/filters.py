"""Fixed-kernel depthwise image filters on NCHW tensors (counterpart of
``jspsr_tpu/ops/filters.py``): the normalized Sobel gradient of the
``Grad`` loss and the gaussian-window SSIM of the ``SSIM`` loss.

The metric-only filters of the JAX module (``sobel_magnitude``, the
reference's exponential window, the skimage row SSIM, Horn slope) come with
the eval slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def _depthwise(x: torch.Tensor, kernel: torch.Tensor,
               padding: int = 0) -> torch.Tensor:
    """Apply one 2D kernel to every channel of NCHW ``x`` (cross-correlation,
    as ``lax.conv_general_dilated``)."""
    c = x.shape[1]
    w = kernel.to(x.dtype).expand(c, 1, *kernel.shape).contiguous()
    return F.conv2d(x, w, padding=padding, groups=c)


def replicate_pad1(x: torch.Tensor) -> torch.Tensor:
    """``F.pad(x, (1, 1, 1, 1), mode="replicate")`` of NCHW ``x`` from its
    edge rows and columns. The values are the same; the backward is a sum
    of slices in a fixed order, where replicate padding's CUDA backward
    sums with atomics (non-deterministic unless
    ``torch.use_deterministic_algorithms`` is on)."""
    x = torch.cat([x[..., :1, :], x, x[..., -1:, :]], dim=-2)
    return torch.cat([x[..., :1], x, x[..., -1:]], dim=-1)


def spatial_gradient(x: torch.Tensor):
    """kornia-style normalized Sobel gradient: NCHW -> (gx, gy), each NCHW.
    Replicate-padded, kernels divided by sum(|k|) = 8."""
    xp = replicate_pad1(x)
    gx = _depthwise(xp, torch.tensor(_SOBEL_X, device=x.device) / 8.0)
    gy = _depthwise(xp, torch.tensor(_SOBEL_Y, device=x.device) / 8.0)
    return gx, gy


def gaussian_window(size: int = 11, sigma: float = 1.5,
                    device=None) -> torch.Tensor:
    """Normalized 2D gaussian window (size, size), fp32."""
    g = torch.tensor([math.exp(-((i - size // 2) ** 2) / (2 * sigma**2))
                      for i in range(size)], device=device)
    g = g / g.sum()
    return g[:, None] @ g[None, :]


def ssim(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 1.0,
         window_size: int = 11, sigma: float = 1.5, padding: str = "valid",
         window: torch.Tensor | None = None,
         per_sample: bool = False) -> torch.Tensor:
    """SSIM over NCHW with a 2D window. ``padding='valid'`` with the
    gaussian window is the reference's ``piq.ssim(..., downsample=False)``;
    ``'same'`` zero-pads by half the window. ``per_sample`` returns (B,)."""
    win = (gaussian_window(window_size, sigma, pred.device) if window is None
           else window)
    pad = window_size // 2 if padding == "same" else 0

    def f(v):
        return _depthwise(v, win, pad)

    mu1, mu2 = f(pred), f(gt)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = f(pred * pred) - mu1_sq
    s2 = f(gt * gt) - mu2_sq
    s12 = f(pred * gt) - mu12
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    if per_sample:
        return ssim_map.mean(dim=(1, 2, 3))
    return ssim_map.mean()
