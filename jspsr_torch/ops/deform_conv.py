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
``deform_conv2d`` is a ``torch.autograd.Function`` (the counterpart of
``deform_conv2d_pallas``, a ``jax.custom_vjp``): on CUDA tensors its
forward launches the forward kernel and its backward the backward kernel
(``deform_cuda``); on CPU tensors they are the plain versions
``deform_conv2d_plain`` and ``deform_conv2d_backward_plain``. The backward
gives no input gradient (the SPN head detaches the DEM); an ``x`` that
requires grad raises at backward. The JAX package's ``mxu`` form exists
only to avoid TPU gathers and is not ported.
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


def _bilinear_corners(x: torch.Tensor, offset: torch.Tensor, padding: int):
    """The four corners around every tap's position and its fractional
    parts: (v00, v01, v10, v11, ty, tx), each (B, K, H, W). A corner off the
    image is 0."""
    b, _, h, w = x.shape
    py, px = _positions(offset, padding)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    img = x.reshape(b, h * w)

    def corner(yc, xc):
        # bounds tested in float, before any int conversion
        valid = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
        yi = yc.clamp(0, h - 1).long()
        xi = xc.clamp(0, w - 1).long()
        g = torch.gather(img, 1, (yi * w + xi).reshape(b, -1))
        return g.view(yc.shape) * valid.to(x.dtype)

    return (corner(y0, x0), corner(y0, x0 + 1), corner(y0 + 1, x0),
            corner(y0 + 1, x0 + 1), py - y0, px - x0)


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  padding: int = 1) -> torch.Tensor:
    """Deformable im2col by four corner gathers, modulated by the mask:
    columns (B, K, H, W)."""
    v00, v01, v10, v11, ty, tx = _bilinear_corners(x, offset, padding)
    cols = (1.0 - ty) * ((1.0 - tx) * v00 + tx * v01) \
        + ty * ((1.0 - tx) * v10 + tx * v11)
    return cols * mask


def deform_conv2d_plain(x, offset, weight, bias, mask,
                        padding: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: gather im2col, times the
    mask, contracted with the 3x3 weight, plus bias. Any device."""
    check_deform_args(x, offset, weight, bias, mask)
    cols = deform_im2col(x, offset, mask, padding)  # (B, K, H, W)
    y = torch.einsum("bkhw,k->bhw", cols, weight.reshape(TAPS))
    return (y + bias).unsqueeze(1)


def deform_conv2d_backward_plain(x, offset, weight, mask, grad_out,
                                 padding: int = 1):
    """Plain PyTorch version of the backward kernel, the same closed forms
    on tensors: returns (d_offset, d_mask, d_weight, d_bias) for
    ``grad_out`` (B,1,H,W). The offset derivative is floor-based (the
    corners stay fixed, only the fractional part moves), so at integer
    positions it is the forward difference; off-image corners are 0. Any
    device."""
    b, _, h, w = x.shape
    v00, v01, v10, v11, ty, tx = _bilinear_corners(x, offset, padding)
    top = (1.0 - tx) * v00 + tx * v01
    bot = (1.0 - tx) * v10 + tx * v11
    val = (1.0 - ty) * top + ty * bot
    gw = grad_out * weight.reshape(1, TAPS, 1, 1)
    gwm = gw * mask
    d_py = gwm * (bot - top)
    d_px = gwm * ((1.0 - ty) * (v01 - v00) + ty * (v11 - v10))
    d_offset = torch.stack([d_py, d_px], dim=2).reshape(b, 2 * TAPS, h, w)
    d_weight = (grad_out * mask * val).sum(dim=(0, 2, 3)).view_as(weight)
    return d_offset, gw * val, d_weight, grad_out.sum().view(1)


class DeformConv2dFunction(torch.autograd.Function):
    """Forward K1, backward K2 on CUDA tensors; the plain versions on CPU
    tensors. The backward gives no gradient for ``x``."""

    @staticmethod
    def forward(ctx, x, offset, weight, bias, mask, padding):
        if x.device.type == "cuda":
            from jspsr_torch.ops import deform_cuda

            out = deform_cuda.deform_fwd(x, offset, weight, bias, mask,
                                         padding)
        elif x.device.type == "cpu":
            out = deform_conv2d_plain(x, offset, weight, bias, mask, padding)
        else:
            raise ValueError(f"deform_conv2d: unsupported device {x.device}")
        ctx.save_for_backward(x, offset, weight, mask)
        ctx.padding = padding
        return out

    @staticmethod
    def backward(ctx, grad_out):
        if ctx.needs_input_grad[0]:
            raise NotImplementedError(
                "deform_conv2d: the input gradient (the TPU kernel's "
                "need_dx=True backward, K3) is not yet ported; it comes with "
                "the CompletionFormer slice. Detach x, as the SPN head does.")
        x, offset, weight, mask = ctx.saved_tensors
        # autograd may hand over an expanded (stride-0) gradient
        grad_out = grad_out.contiguous()
        if x.device.type == "cuda":
            from jspsr_torch.ops import deform_cuda

            grads = deform_cuda.deform_bwd(x, offset, weight, mask, grad_out,
                                           ctx.padding)
        else:
            grads = deform_conv2d_backward_plain(x, offset, weight, mask,
                                                 grad_out, ctx.padding)
        d_offset, d_mask, d_weight, d_bias = grads
        need = ctx.needs_input_grad
        return (None, d_offset if need[1] else None,
                d_weight if need[2] else None, d_bias if need[3] else None,
                d_mask if need[4] else None, None)


def deform_conv2d(x, offset, weight, bias, mask,
                  padding: int = 1) -> torch.Tensor:
    """Modulated deformable conv: x (B,1,H,W), offset (B,18,H,W),
    weight (1,1,3,3), bias (1,), mask (B,9,H,W) -> (B,1,H,W).

    A CUDA tensor launches the kernels (``deform_cuda.deform_fwd``, and
    ``deform_bwd`` in the backward) or raises; there is no fallback. Only
    CPU tensors take the plain versions. Gradients flow to offset, weight,
    bias and mask; an ``x`` that requires grad raises at backward."""
    check_deform_args(x, offset, weight, bias, mask)
    return DeformConv2dFunction.apply(x, offset, weight, bias, mask,
                                      int(padding))


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
