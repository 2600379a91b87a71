"""Fixed-kernel depthwise image filters on NCHW tensors (counterpart of
``jspsr_tpu/ops/filters.py``): the normalized Sobel gradient of the
``Grad`` loss and the gaussian-window SSIM of the ``SSIM`` loss, and the
metric-only filters of the meters (``metrics/meters.py``): the reference's
2x Sobel magnitude, its exponential SSIM window, skimage's row SSIM and
Horn's slope.
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


def sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """The reference's 'local' slope operator: 2x-scaled Sobel, valid
    padding (the output shrinks by 2), magnitude sqrt(gx^2 + gy^2)."""
    kx = torch.tensor(((2.0, 0.0, -2.0), (4.0, 0.0, -4.0), (2.0, 0.0, -2.0)),
                      device=x.device)
    ky = torch.tensor(((2.0, 4.0, 2.0), (0.0, 0.0, 0.0), (-2.0, -4.0, -2.0)),
                      device=x.device)
    gx, gy = _depthwise(x, kx), _depthwise(x, ky)
    return torch.sqrt(gx * gx + gy * gy)


def gaussian_window(size: int = 11, sigma: float = 1.5,
                    device=None) -> torch.Tensor:
    """Normalized 2D gaussian window (size, size), fp32."""
    g = torch.tensor([math.exp(-((i - size // 2) ** 2) / (2 * sigma**2))
                      for i in range(size)], device=device)
    g = g / g.sum()
    return g[:, None] @ g[None, :]


def reference_exp_window(size: int = 11, sigma: float = 1.5,
                         device=None) -> torch.Tensor:
    """The reference's 'gaussian' SSIM window, with its bug: ``exp(-(x -
    size//2) * 2 / (2*sigma*2))`` is linear in x, not squared, so the
    window is a one-sided decaying exponential (what the 'local' SSIM
    package computes)."""
    g = torch.tensor([math.exp(-(i - size // 2) * 2 / float(2 * sigma * 2))
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


def _uniform_filter_w(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """scipy.ndimage.uniform_filter along W of NCHW, mode 'reflect' (the
    edge value repeated: numpy's 'symmetric')."""
    half = size // 2
    xp = torch.cat([x[..., :half].flip(-1), x, x[..., -half:].flip(-1)],
                   dim=-1)
    k = torch.full((1, size), 1.0 / size, device=x.device)
    return _depthwise(xp, k)


def ssim_skimage_rows(pred: torch.Tensor, gt: torch.Tensor,
                      data_range: float = 1.0, win_size: int = 7,
                      per_sample: bool = False) -> torch.Tensor:
    """skimage's SSIM as the reference calls it on an (H, W) array with
    ``channel_axis=0``: every ROW is a channel, so it is a 1-D SSIM along W
    per row (uniform 7-tap filter, sample covariance N/(N-1), borders
    cropped by (win-1)//2), averaged. ``per_sample`` returns (B,)."""
    cov_norm = win_size / (win_size - 1.0)

    def uf(v):
        return _uniform_filter_w(v, win_size)

    ux, uy = uf(pred), uf(gt)
    uxx, uyy, uxy = uf(pred * pred), uf(gt * gt), uf(pred * gt)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    half = (win_size - 1) // 2
    s = s[..., half: s.shape[-1] - half]
    if per_sample:
        return s.mean(dim=(1, 2, 3))
    return s.mean()


def horn_slope(dem: torch.Tensor, cell_x: float,
               cell_y: float) -> torch.Tensor:
    """Horn (1981) slope_riserun of NCHW ``dem`` (richdem's
    ``TerrainAttribute(attrib='slope_riserun')``):

        dz/dx = ((c + 2f + i) - (a + 2d + g)) / (8 cell_x)
        dz/dy = ((g + 2h + i) - (a + 2b + c)) / (8 cell_y)

    with neighbours off the grid taking the focal cell's value."""
    h, w = dem.shape[-2:]
    rows = torch.arange(h, device=dem.device)
    cols = torch.arange(w, device=dem.device)

    def nb(dy, dx):
        # nb[r, c] = dem[r+dy, c+dx], the focal value off the grid
        v = torch.roll(dem, shifts=(-dy, -dx), dims=(-2, -1))
        ok = (((rows + dy >= 0) & (rows + dy < h))[:, None]
              & ((cols + dx >= 0) & (cols + dx < w))[None, :])
        return torch.where(ok, v, dem)

    a, b, c = nb(-1, -1), nb(-1, 0), nb(-1, 1)
    d, f = nb(0, -1), nb(0, 1)
    g, hh, i = nb(1, -1), nb(1, 0), nb(1, 1)
    dzdx = ((c + 2 * f + i) - (a + 2 * d + g)) / (8.0 * cell_x)
    dzdy = ((g + 2 * hh + i) - (a + 2 * b + c)) / (8.0 * cell_y)
    return torch.sqrt(dzdx * dzdx + dzdy * dzdy)
