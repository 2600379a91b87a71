"""Modulated deformable convolution (DCNv2), NCHW — the SPN refinement
primitive (counterpart of ``jspsr_tpu/ops/deform_conv.py``).

Semantics match the JAX package and torchvision.ops.deform_conv2d:

- ``offset`` channels are tap-major interleaved ``(dy, dx)`` pairs in
  row-major kernel order: channel ``2t`` is the y-offset of tap ``t``;
- ``mask`` multiplies each tap's bilinear sample;
- bilinear sampling is zero off the image: a sample contributes only its
  in-bounds corners.

The case carried here is the one the framework runs: one input and one
output channel, 3x3 kernel, stride 1, dilation 1 (the SPN head).
``deform_conv2d`` runs the CUDA kernel (``deform_cuda``) for CUDA tensors
and the plain version ``deform_conv2d_plain`` for CPU tensors. The JAX
package's ``mxu`` form exists only to avoid TPU gathers and is not ported.
"""

from __future__ import annotations

import torch

KERNEL = 3
TAPS = KERNEL * KERNEL


def check_deform_args(x, offset, weight, bias, mask) -> None:
    """Raise unless the arguments are the supported case: x (B,1,H,W),
    offset (B,18,H,W), mask (B,9,H,W), weight (1,1,3,3), bias (1,)."""
    if x.dim() != 4 or x.shape[1] != 1:
        raise ValueError(f"x must be (B, 1, H, W), got {tuple(x.shape)}")
    b, _, h, w = x.shape
    want = {"offset": (offset, (b, 2 * TAPS, h, w)),
            "mask": (mask, (b, TAPS, h, w)),
            "weight": (weight, (1, 1, KERNEL, KERNEL)),
            "bias": (bias, (1,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _positions(offset: torch.Tensor, padding: int):
    """Sampling positions py, px of shape (B, K, H, W)."""
    b, _, h, w = offset.shape
    dev, dt = offset.device, offset.dtype
    oy = torch.arange(h, device=dev, dtype=dt) - padding
    ox = torch.arange(w, device=dev, dtype=dt) - padding
    k = torch.arange(KERNEL, device=dev, dtype=dt)
    tap_y = k.repeat_interleave(KERNEL)  # row-major taps
    tap_x = k.repeat(KERNEL)
    off = offset.view(b, TAPS, 2, h, w)
    py = oy[None, None, :, None] + tap_y[None, :, None, None] + off[:, :, 0]
    px = ox[None, None, None, :] + tap_x[None, :, None, None] + off[:, :, 1]
    return py, px


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  padding: int = 1) -> torch.Tensor:
    """Deformable im2col by four corner gathers, modulated by the mask:
    columns (B, K, H, W)."""
    b, _, h, w = x.shape
    py, px = _positions(offset, padding)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ty = py - y0
    tx = px - x0
    img = x.reshape(b, h * w)

    def corner(yc, xc):
        # bounds tested in float, before any int conversion
        valid = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
        yi = yc.clamp(0, h - 1).long()
        xi = xc.clamp(0, w - 1).long()
        g = torch.gather(img, 1, (yi * w + xi).reshape(b, -1))
        return g.view(yc.shape) * valid.to(x.dtype)

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    cols = (1.0 - ty) * ((1.0 - tx) * v00 + tx * v01) \
        + ty * ((1.0 - tx) * v10 + tx * v11)
    return cols * mask


def deform_conv2d_plain(x, offset, weight, bias, mask,
                        padding: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather im2col, times the mask,
    contracted with the 3x3 weight, plus bias. Any device."""
    check_deform_args(x, offset, weight, bias, mask)
    cols = deform_im2col(x, offset, mask, padding)  # (B, K, H, W)
    y = torch.einsum("bkhw,k->bhw", cols, weight.reshape(TAPS))
    return (y + bias).unsqueeze(1)


def deform_conv2d(x, offset, weight, bias, mask,
                  padding: int = 1) -> torch.Tensor:
    """Modulated deformable conv: x (B,1,H,W), offset (B,18,H,W),
    weight (1,1,3,3), bias (1,), mask (B,9,H,W) -> (B,1,H,W).

    A CUDA tensor launches the CUDA kernel (``deform_cuda.deform_fwd``) or
    raises; there is no fallback. Only CPU tensors take
    ``deform_conv2d_plain``. The kernel is forward-only: with grad mode on,
    inputs that require grad are refused on CUDA until the backward kernel
    lands."""
    check_deform_args(x, offset, weight, bias, mask)
    if x.device.type == "cuda":
        from jspsr_torch.ops import deform_cuda

        return deform_cuda.deform_fwd(x, offset, weight, bias, mask, padding)
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offset, weight, bias, mask, padding)
    raise ValueError(f"deform_conv2d: unsupported device {x.device}")


def insert_zero_center_offset(offset: torch.Tensor,
                              kernel_size: int = KERNEL) -> torch.Tensor:
    """Insert a zero (dy, dx) pair at the center tap: (B, 2(K-1), H, W) ->
    (B, 2K, H, W). The SPN generator predicts offsets for the K-1
    non-center taps only; the center samples the pixel itself."""
    b, c, h, w = offset.shape
    k = kernel_size * kernel_size
    if c != 2 * (k - 1):
        raise ValueError(f"expected {2 * (k - 1)} offset channels, got {c}")
    ctr = 2 * ((k - 1) // 2)
    zero = offset.new_zeros(b, 2, h, w)
    return torch.cat([offset[:, :ctr], zero, offset[:, ctr:]], dim=1)
