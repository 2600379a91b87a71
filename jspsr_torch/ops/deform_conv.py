"""Modulated deformable convolution (DCNv2), NCHW — the SPN refinement
primitive (counterpart of ``jspsr_tpu/ops/deform_conv.py``).

Semantics match the JAX package and torchvision.ops.deform_conv2d:

- ``offset`` channels are tap-major interleaved ``(dy, dx)`` pairs in
  row-major kernel order: channel ``2t`` is the y-offset of tap ``t``;
- ``mask`` multiplies each tap's bilinear sample;
- bilinear sampling is zero off the image: a sample contributes only its
  in-bounds corners.

The case carried here is the one the framework runs: one input and one
output channel, 3x3 kernel, stride 1, dilation 1 (the SPN head and NLSPN's
propagation). ``deform_conv2d`` is a ``torch.autograd.Function`` (the
counterpart of ``deform_conv2d_pallas``, a ``jax.custom_vjp``): on CUDA
tensors its forward launches the forward kernel and its backward one of
the two backward kernels (``deform_cuda``): ``deform_bwd_dx`` where ``x``
needs its gradient (NLSPN), ``deform_bwd`` where it does not (the SPN head
detaches the DEM). On CPU tensors they are the plain versions
``deform_conv2d_plain`` and ``deform_conv2d_backward_plain``.

``bilinear_sample`` is the plain bilinear gather at given positions, with
autograd to the image: NLSPN's 1x1 confidence taps, which the JAX package
also leaves to XLA. The JAX package's ``mxu`` form exists only to avoid
TPU gathers and is not ported.
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


def _corner(yc, xc, h: int, w: int):
    """Flat index into an (H*W) image of the integer corner (yc, xc) and
    whether it lies on the image; the bounds are tested in float, before
    any int conversion, and the index is clamped."""
    valid = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
    return yc.clamp(0, h - 1).long() * w + xc.clamp(0, w - 1).long(), valid


def _corners(py, px, h: int, w: int):
    """The four corners (v00, v01, v10, v11 order) around every position,
    as ``_corner`` pairs, and the positions' fractional parts ty, tx."""
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    return ([_corner(y0 + dy, x0 + dx, h, w)
             for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))],
            py - y0, px - x0)


def _bilinear_corners(x: torch.Tensor, py, px):
    """The corner values around every position, 0 off the image, and the
    fractional parts: (v00, v01, v10, v11, ty, tx), each shaped like
    ``py``. The corners are read by indexing the flat image, whose
    backward (``index_put_`` with accumulation) sorts the indices on CUDA
    and sums each target's terms in one order on every run, where
    ``torch.gather``'s backward (``scatter_add_``) sums with atomics (the
    confidence sampling of NLSPN's affinities differentiates through
    this)."""
    b, _, h, w = x.shape
    corners, ty, tx = _corners(py, px, h, w)
    base = (torch.arange(b, device=x.device) * (h * w)).view(
        b, *([1] * (py.dim() - 1)))
    img = x.reshape(-1)
    vals = [img[idx + base] * valid.to(x.dtype) for idx, valid in corners]
    return (*vals, ty, tx)


def bilinear_sample(x: torch.Tensor, py: torch.Tensor,
                    px: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of x (B,1,H,W) at the positions py, px (B,K,H',W'),
    zero off the image: (B,K,H',W'). Plain PyTorch; autograd reaches ``x``
    through the gathers and the positions through the fractional parts."""
    v00, v01, v10, v11, ty, tx = _bilinear_corners(x, py, px)
    return (1.0 - ty) * ((1.0 - tx) * v00 + tx * v01) \
        + ty * ((1.0 - tx) * v10 + tx * v11)


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  padding: int = 1) -> torch.Tensor:
    """Deformable im2col by four corner gathers, modulated by the mask:
    columns (B, K, H, W)."""
    return bilinear_sample(x, *_positions(offset, padding)) * mask


def deform_conv2d_plain(x, offset, weight, bias, mask,
                        padding: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: gather im2col, times the
    mask, contracted with the 3x3 weight, plus bias. Any device."""
    check_deform_args(x, offset, weight, bias, mask)
    cols = deform_im2col(x, offset, mask, padding)  # (B, K, H, W)
    y = torch.einsum("bkhw,k->bhw", cols, weight.reshape(TAPS))
    return (y + bias).unsqueeze(1)


def deform_conv2d_backward_plain(x, offset, weight, mask, grad_out,
                                 padding: int = 1, need_dx: bool = False):
    """Plain PyTorch version of the backward kernels, the same closed forms
    on tensors: returns (d_offset, d_mask, d_weight, d_bias) for
    ``grad_out`` (B,1,H,W), and with ``need_dx`` also d_x (B,1,H,W), each
    tap's g·w_t·m_t times its bilinear weights scattered onto its in-bounds
    corners with ``index_add_``. The offset derivative is floor-based (the
    corners stay fixed, only the fractional part moves), so at integer
    positions it is the forward difference; off-image corners read 0 and
    receive nothing. Any device."""
    b, _, h, w = x.shape
    py, px = _positions(offset, padding)
    v00, v01, v10, v11, ty, tx = _bilinear_corners(x, py, px)
    top = (1.0 - tx) * v00 + tx * v01
    bot = (1.0 - tx) * v10 + tx * v11
    val = (1.0 - ty) * top + ty * bot
    gw = grad_out * weight.reshape(1, TAPS, 1, 1)
    gwm = gw * mask
    d_py = gwm * (bot - top)
    d_px = gwm * ((1.0 - ty) * (v01 - v00) + ty * (v11 - v10))
    d_offset = torch.stack([d_py, d_px], dim=2).reshape(b, 2 * TAPS, h, w)
    d_weight = (grad_out * mask * val).sum(dim=(0, 2, 3)).view_as(weight)
    grads = (d_offset, gw * val, d_weight, grad_out.sum().view(1))
    if not need_dx:
        return grads
    corners, _, _ = _corners(py, px, h, w)
    base = torch.arange(b, device=x.device).view(b, 1, 1, 1) * (h * w)
    d_x = x.new_zeros(b * h * w)
    for (idx, valid), wgt in zip(corners, ((1.0 - ty) * (1.0 - tx),
                                           (1.0 - ty) * tx, ty * (1.0 - tx),
                                           ty * tx)):
        d_x.index_add_(0, (idx + base).reshape(-1),
                       (gwm * wgt * valid.to(x.dtype)).reshape(-1))
    return (*grads, d_x.view_as(x))


class DeformConv2dFunction(torch.autograd.Function):
    """Forward K1 on CUDA tensors, backward K3 where ``x`` needs its
    gradient and K2 where it does not; the plain versions on CPU
    tensors."""

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
        x, offset, weight, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        # autograd may hand over an expanded (stride-0) gradient
        grad_out = grad_out.contiguous()
        if x.device.type == "cuda":
            from jspsr_torch.ops import deform_cuda

            kernel = deform_cuda.deform_bwd_dx if need[0] \
                else deform_cuda.deform_bwd
            grads = kernel(x, offset, weight, mask, grad_out, ctx.padding)
        else:
            grads = deform_conv2d_backward_plain(x, offset, weight, mask,
                                                 grad_out, ctx.padding,
                                                 need_dx=need[0])
        d_offset, d_mask, d_weight, d_bias = grads[:4]
        return (grads[4] if need[0] else None,
                d_offset if need[1] else None,
                d_weight if need[2] else None, d_bias if need[3] else None,
                d_mask if need[4] else None, None)


def deform_conv2d(x, offset, weight, bias, mask,
                  padding: int = 1) -> torch.Tensor:
    """Modulated deformable conv: x (B,1,H,W), offset (B,18,H,W),
    weight (1,1,3,3), bias (1,), mask (B,9,H,W) -> (B,1,H,W).

    A CUDA tensor launches the kernels (``deform_cuda.deform_fwd``, and
    ``deform_bwd_dx`` or ``deform_bwd`` in the backward) or raises; there is
    no fallback. Only CPU tensors take the plain versions. Gradients flow
    to every tensor argument that requires one."""
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
