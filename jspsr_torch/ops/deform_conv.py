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
propagation). ``deform_conv2d`` calls the custom op
``jspsr::deform_conv2d`` (``torch.library.custom_op``; the counterpart of
``deform_conv2d_pallas``, a ``jax.custom_vjp``), whose autograd calls one
of two more ops: ``jspsr::deform_conv2d_backward_dx`` where ``x`` needs
its gradient (NLSPN), ``jspsr::deform_conv2d_backward`` where it does not
(the SPN head detaches the DEM). A custom op cannot return ``None``, so
d_x is the fifth output of an op of its own rather than an optional one.
On CUDA tensors the three ops launch K1, K3 and K2 (``deform_cuda``); on
CPU tensors they are the plain versions ``deform_conv2d_plain`` and
``deform_conv2d_backward_plain``; any other device raises. Each op has a
fake (``register_fake``: contiguous outputs of the kernels' shapes, no
device work), so ``torch.export`` and ``torch.compile`` see the forward as
one node (``eval/export.py``); importing this module registers them,
and the forward's FLOP formula for ``FlopCounterMode``
(``deform_flops``, read by ``utils/summary.model_summary``).

``sample_dtype="bfloat16"`` is the TPU kernels' bf16-sampling mode
(``spn_sample_dtype``): each tap's row product rounds the image's corners
and the row weights to bf16 and sums in fp32,

    tmp_c = bf16(v[y0, c]) bf16(1 - ty) + bf16(v[y0+1, c]) bf16(ty)
    val   = tmp_x0 (1 - tx) + tmp_x1 tx

(the products of two bf16 values are exact in fp32, so each tmp is one
rounding); positions, the column weights, the mask, the weight and the
9-tap sum stay fp32. The backward takes the same ``val`` for d_mask,
d_weight and d_px (tmp_x1 - tmp_x0) and the rounded corners against the
exact row derivative for d_py. d_x, where ``x`` needs it (K3's mode),
scatters each tap's g w_t m_t with the fp32 bilinear weights, exactly as
the fp32 mode does: the TPU kernel rounds only its two image products.
On CUDA tensors the ops launch the three kernels' bf16 modes.

A row slab (``y0``; the spatially sharded forward of
``parallel/spatial.py``): ``x`` stays the whole image (B,1,H,W) while
``offset``, ``mask``, the output and its gradient are a slab (B,·,Hs,W)
whose row h is image row ``y0 + h``: its positions are those rows' (exact
integers in fp32), so a slab's output, d_offset and d_mask are the same
rows of the whole image's, bit for bit, and its d_weight and d_bias are
the slab's share of the whole image's sums. Where ``x`` needs its
gradient, the slab's d_x is the whole image's (B,1,H,W): the slab's own
contributions scattered onto every image row they reach, so the slabs'
d_x summed (the space group's sum in ``parallel.spatial.gather_rows``'s
backward) is the whole image's. K1, K2 and K3 take a slab in either mode
(their launches count as ``deform_fwd_slab``, ``deform_bwd_slab`` and
``deform_bwd_dx_slab``, and ``deform_fwd_bf16_slab``,
``deform_bwd_bf16_slab`` and ``deform_bwd_dx_bf16_slab``).

``bilinear_sample`` is the plain bilinear gather at given positions, with
autograd to the image: NLSPN's 1x1 confidence taps, which the JAX package
also leaves to XLA. The JAX package's ``mxu`` form exists only to avoid
TPU gathers and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "jspsr"
KERNEL = 3
TAPS = KERNEL * KERNEL
SAMPLE_DTYPES = (None, "float32", "bfloat16")


def bf16_sampling(sample_dtype) -> bool:
    """Whether ``sample_dtype`` asks for the bf16-sampling mode (``None``
    and ``"float32"`` ask for the exact fp32 one); raises on any other."""
    if sample_dtype not in SAMPLE_DTYPES:
        raise ValueError(f"sample_dtype must be one of {SAMPLE_DTYPES}, got "
                         f"{sample_dtype!r}")
    return sample_dtype == "bfloat16"


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and back to its type."""
    return t.to(torch.bfloat16).to(t.dtype)


def check_deform_args(x, offset, weight, bias, mask, y0: int = 0) -> None:
    """Raise unless the arguments are the supported case: x (B,1,H,W),
    offset (B,18,Hs,W), mask (B,9,Hs,W), weight (1,1,3,3), bias (1,), the
    slab of image rows [y0, y0 + Hs) within the image (Hs = H, y0 = 0: the
    whole image). A ``bias`` of None is not checked (the backward's)."""
    if x.dim() != 4 or x.shape[1] != 1:
        raise ValueError(f"x must be (B, 1, H, W), got {tuple(x.shape)}")
    b, _, h, w = x.shape
    hs = offset.shape[2] if offset.dim() == 4 else h
    if not 0 <= y0 <= h - hs:
        raise ValueError(f"the slab of rows [{y0}, {y0 + hs}) is not within "
                         f"the image's {h} rows")
    want = {"offset": (offset, (b, 2 * TAPS, hs, w)),
            "mask": (mask, (b, TAPS, hs, w)),
            "weight": (weight, (1, 1, KERNEL, KERNEL)),
            "bias": (bias, (1,))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _positions(offset: torch.Tensor, padding: int, y0: int = 0):
    """Sampling positions py, px of shape (B, K, H, W); the offsets' row h
    is image row ``y0 + h``."""
    b, _, h, w = offset.shape
    dev, dt = offset.device, offset.dtype
    oy = torch.arange(y0, y0 + h, device=dev, dtype=dt) - padding
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
                  padding: int = 1, y0: int = 0) -> torch.Tensor:
    """Deformable im2col by four corner gathers, modulated by the mask:
    columns (B, K, H, W), of the slab whose first row is image row
    ``y0``."""
    return bilinear_sample(x, *_positions(offset, padding, y0)) * mask


def _bf16_rows(v00, v01, v10, v11, ty):
    """The bf16 mode's row products of the left and right corner columns:
    (tmp_x0, tmp_x1), and the rounded corners."""
    b00, b01, b10, b11 = (_bf16(v) for v in (v00, v01, v10, v11))
    r0, r1 = _bf16(1.0 - ty), _bf16(ty)
    return b00 * r0 + b10 * r1, b01 * r0 + b11 * r1, (b00, b01, b10, b11)


def deform_conv2d_plain(x, offset, weight, bias, mask, padding: int = 1,
                        sample_dtype=None, y0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: gather im2col, times the
    mask, contracted with the 3x3 weight, plus bias; with ``sample_dtype``
    the bf16-sampling mode; the output rows of the slab of ``offset`` and
    ``mask`` whose first row is image row ``y0``. Any device."""
    check_deform_args(x, offset, weight, bias, mask, y0)
    if bf16_sampling(sample_dtype):
        v00, v01, v10, v11, ty, tx = _bilinear_corners(
            x, *_positions(offset, padding, y0))
        tmp0, tmp1, _ = _bf16_rows(v00, v01, v10, v11, ty)
        cols = (tmp0 * (1.0 - tx) + tmp1 * tx) * mask
    else:
        cols = deform_im2col(x, offset, mask, padding, y0)  # (B, K, Hs, W)
    y = torch.einsum("bkhw,k->bhw", cols, weight.reshape(TAPS))
    return (y + bias).unsqueeze(1)


def deform_conv2d_backward_plain(x, offset, weight, mask, grad_out,
                                 padding: int = 1, need_dx: bool = False,
                                 sample_dtype=None, y0: int = 0):
    """Plain PyTorch version of the backward kernels, the same closed forms
    on tensors: returns (d_offset, d_mask, d_weight, d_bias) for
    ``grad_out`` (B,1,H,W), and with ``need_dx`` also d_x (B,1,H,W), each
    tap's g·w_t·m_t times its bilinear weights scattered onto its in-bounds
    corners with ``index_add_``. The offset derivative is floor-based (the
    corners stay fixed, only the fractional part moves), so at integer
    positions it is the forward difference; off-image corners read 0 and
    receive nothing. With ``sample_dtype`` the bf16-sampling mode's
    gradients (the module's docstring); its d_x is the fp32 mode's, as the
    TPU kernel keeps the scatter in fp32. On a row slab (``offset``,
    ``mask`` and ``grad_out`` of Hs rows, the first image row ``y0``)
    d_offset and d_mask are the slab's and d_weight and d_bias its share;
    d_x is the whole image's, from the slab's contributions. Any
    device."""
    bf16 = bf16_sampling(sample_dtype)
    b, _, h, w = x.shape
    py, px = _positions(offset, padding, y0)
    v00, v01, v10, v11, ty, tx = _bilinear_corners(x, py, px)
    gw = grad_out * weight.reshape(1, TAPS, 1, 1)
    gwm = gw * mask
    if bf16:
        tmp0, tmp1, (b00, b01, b10, b11) = _bf16_rows(v00, v01, v10, v11, ty)
        val = tmp0 * (1.0 - tx) + tmp1 * tx
        d_py = gwm * ((b10 - b00) * (1.0 - tx) + (b11 - b01) * tx)
        d_px = gwm * (tmp1 - tmp0)
    else:
        top = (1.0 - tx) * v00 + tx * v01
        bot = (1.0 - tx) * v10 + tx * v11
        val = (1.0 - ty) * top + ty * bot
        d_py = gwm * (bot - top)
        d_px = gwm * ((1.0 - ty) * (v01 - v00) + ty * (v11 - v10))
    d_offset = torch.stack([d_py, d_px], dim=2).reshape(b, 2 * TAPS,
                                                        *offset.shape[2:])
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


def is_slab(x: torch.Tensor, offset: torch.Tensor, y0: int) -> bool:
    """Whether ``offset`` is a row slab of ``x``'s image and not the whole
    image."""
    return y0 != 0 or offset.shape[2] != x.shape[2]


def _kernels(device: torch.device):
    """``deform_cuda`` for a CUDA device, ``None`` (the plain versions)
    for the CPU; any other device raises."""
    if device.type == "cuda":
        from jspsr_torch.ops import deform_cuda

        return deform_cuda
    if device.type == "cpu":
        return None
    raise ValueError(f"deform_conv2d: unsupported device {device}")


@torch.library.custom_op(f"{NAMESPACE}::deform_conv2d", mutates_args=())
def deform_conv2d_op(x: torch.Tensor, offset: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor, padding: int,
                     sample_dtype: Optional[str], y0: int = 0) -> torch.Tensor:
    """The forward: K1 on CUDA tensors, ``deform_conv2d_plain`` on CPU
    tensors, in the mode ``sample_dtype`` asks for, on the row slab that
    starts at image row ``y0``."""
    cuda = _kernels(x.device)
    if cuda is not None:
        return cuda.deform_fwd(x, offset, weight, bias, mask, padding,
                               sample_dtype=sample_dtype, y0=y0)
    return deform_conv2d_plain(x, offset, weight, bias, mask, padding,
                               sample_dtype=sample_dtype, y0=y0)


@torch.library.custom_op(f"{NAMESPACE}::deform_conv2d_backward",
                         mutates_args=())
def deform_conv2d_backward_op(
        x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
        mask: torch.Tensor, grad_out: torch.Tensor, padding: int,
        sample_dtype: Optional[str], y0: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward without the input gradient: K2 on CUDA tensors,
    ``deform_conv2d_backward_plain`` on CPU tensors, on the row slab that
    starts at image row ``y0``; (d_offset, d_mask, d_weight, d_bias)."""
    cuda = _kernels(x.device)
    if cuda is not None:
        return cuda.deform_bwd(x, offset, weight, mask, grad_out, padding,
                               sample_dtype=sample_dtype, y0=y0)
    return deform_conv2d_backward_plain(x, offset, weight, mask, grad_out,
                                        padding, sample_dtype=sample_dtype,
                                        y0=y0)


@torch.library.custom_op(f"{NAMESPACE}::deform_conv2d_backward_dx",
                         mutates_args=())
def deform_conv2d_backward_dx_op(
        x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
        mask: torch.Tensor, grad_out: torch.Tensor, padding: int,
        sample_dtype: Optional[str], y0: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """The backward with the input gradient: K3 on CUDA tensors, the plain
    backward with ``need_dx`` on CPU tensors, on the row slab that starts
    at image row ``y0``; (d_offset, d_mask, d_weight, d_bias, d_x), d_x the
    whole image's."""
    cuda = _kernels(x.device)
    if cuda is not None:
        return cuda.deform_bwd_dx(x, offset, weight, mask, grad_out, padding,
                                  sample_dtype=sample_dtype, y0=y0)
    return deform_conv2d_backward_plain(x, offset, weight, mask, grad_out,
                                        padding, need_dx=True,
                                        sample_dtype=sample_dtype, y0=y0)


def _new(like: torch.Tensor, *shape) -> torch.Tensor:
    """A contiguous tensor of ``shape`` in ``like``'s type and device: the
    ops' fake outputs (fp32 where the kernels run), no device work."""
    return torch.empty(shape, dtype=like.dtype, device=like.device)


@deform_conv2d_op.register_fake
def _(x, offset, weight, bias, mask, padding, sample_dtype, y0=0):
    check_deform_args(x, offset, weight, bias, mask, y0)
    bf16_sampling(sample_dtype)
    return _new(x, x.shape[0], 1, *offset.shape[2:])


def _fake_backward(x, offset, weight, mask):
    return (_new(x, *offset.shape), _new(x, *mask.shape),
            _new(x, *weight.shape), _new(x, 1))


@deform_conv2d_backward_op.register_fake
def _(x, offset, weight, mask, grad_out, padding, sample_dtype, y0=0):
    bf16_sampling(sample_dtype)
    return _fake_backward(x, offset, weight, mask)


@deform_conv2d_backward_dx_op.register_fake
def _(x, offset, weight, mask, grad_out, padding, sample_dtype, y0=0):
    bf16_sampling(sample_dtype)
    return (*_fake_backward(x, offset, weight, mask), _new(x, *x.shape))


def _setup_context(ctx, inputs, output):
    x, offset, weight, _, mask, padding, sample_dtype, y0 = inputs
    ctx.save_for_backward(x, offset, weight, mask)
    ctx.padding = padding
    ctx.sample_dtype = sample_dtype
    ctx.y0 = y0


def _backward(ctx, grad_out):
    """K3 (``deform_conv2d_backward_dx``) where ``x`` needs its gradient,
    K2 (``deform_conv2d_backward``) where it does not, in the forward's
    mode and on its row slab."""
    x, offset, weight, mask = ctx.saved_tensors
    need = ctx.needs_input_grad
    # autograd may hand over an expanded (stride-0) gradient
    args = (x, offset, weight, mask, grad_out.contiguous(), ctx.padding,
            ctx.sample_dtype, ctx.y0)
    if need[0]:
        *grads, d_x = deform_conv2d_backward_dx_op(*args)
    else:
        grads = deform_conv2d_backward_op(*args)
        d_x = None
    d_offset, d_mask, d_weight, d_bias = grads
    return (d_x, d_offset if need[1] else None,
            d_weight if need[2] else None, d_bias if need[3] else None,
            d_mask if need[4] else None, None, None, None)


deform_conv2d_op.register_autograd(_backward, setup_context=_setup_context)

# FLOPs of one tap at one output pixel (``deform_flops``)
FLOPS_PER_TAP = 4 + 8 + 3


@register_flop_formula(torch.ops.jspsr.deform_conv2d)
def deform_flops(x_shape, offset_shape, weight_shape, bias_shape, mask_shape,
                 padding, sample_dtype, y0=0, *, out_shape=None, **_) -> int:
    """The forward's FLOPs for ``FlopCounterMode``, from the shapes alone
    (the same on the CPU and on the card, in either sampling mode): for
    each output pixel and each of the 9 taps,

    - the bilinear corners' weights (1-ty)(1-tx), (1-ty)tx, ty(1-tx),
      ty tx: 4 products;
    - the sample, the 4 corners times their weights summed: 4
      multiply-adds, 8 FLOPs;
    - the modulation, the tap's weight times its mask (1 product) times
      the sample, summed into the output (1 multiply-add): 3 FLOPs;

    so FLOPS_PER_TAP = 15 and B x Hs x W x 9 x 15 in all. As a conv's
    count, it leaves out the bias and the sampling positions' arithmetic.
    Only the forward has a formula."""
    b, _, hs, w = out_shape
    return b * hs * w * TAPS * FLOPS_PER_TAP


def deform_conv2d(x, offset, weight, bias, mask, padding: int = 1,
                  sample_dtype=None, y0: int = 0) -> torch.Tensor:
    """Modulated deformable conv: x (B,1,H,W), offset (B,18,H,W),
    weight (1,1,3,3), bias (1,), mask (B,9,H,W) -> (B,1,H,W);
    ``sample_dtype="bfloat16"`` the bf16-sampling mode. With offset and
    mask a row slab (B,·,Hs,W) whose first row is image row ``y0``, the
    output is that slab's (B,1,Hs,W), the same rows of the whole image's
    output (the module's docstring).

    The op ``jspsr::deform_conv2d``: a CUDA tensor launches the kernels
    (``deform_cuda.deform_fwd``, and ``deform_bwd_dx`` or ``deform_bwd``
    in the backward) in the mode asked for, or raises; there is no
    fallback. Only CPU tensors take the plain versions. Gradients flow to
    every tensor argument that requires one, in either mode."""
    check_deform_args(x, offset, weight, bias, mask, y0)
    return deform_conv2d_op(x, offset, weight, bias, mask, int(padding),
                            sample_dtype, int(y0))


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
