"""Core layers (counterpart of ``jspsr_tpu/nn/layers.py``).

The port's models use torch's NCHW / OIHW ``nn.Conv2d``,
``nn.ConvTranspose2d``, ``nn.BatchNorm2d``, ``nn.Linear`` (the JAX
``Dense``, whose (in, out) weight is torch's transposed) and
``nn.LayerNorm`` (eps 1e-5 unless a module says otherwise): their
padding, output-size and normalisation semantics are the ones the JAX
package reproduces. The modules of a mixed-precision body (JSPSR's
``compute_dtype``) take the subclasses ``Conv2d``, ``ConvTranspose2d`` and
``BatchNorm2d`` here, which keep fp32 parameters and the same state_dict
keys and, on a bf16 input, compute as the JAX layers do
(``jspsr_tpu/nn/layers.py:242,264,319,326,355-385``): a conv casts its
weight and bias to the input's dtype at use; BatchNorm takes its
statistics in fp32 and normalises in the input's dtype. On fp32 (or
float64) inputs each is its torch parent, unchanged. What remains here is
the JAX package's init, its global pools and its bilinear and bicubic
resizes.

Under an open spatial sharding (``parallel.mesh.SpatialSharding.active``;
a process per row slab) the convs take their neighbours' halo rows, the
global pools reduce over the space group and train-mode BatchNorm takes
its statistics over the whole mesh (``parallel/spatial.py``), so that a
slab computes its rows of the whole batch's forward.

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

from jspsr_torch.nn import remat
from jspsr_torch.nn.initializers import trunc_normal_fan_in_
from jspsr_torch.parallel import spatial
from jspsr_torch.parallel.mesh import active_sharding, step_group


def _bf16(x: torch.Tensor) -> bool:
    """Whether ``x`` is a bf16 activation (the parameters stay fp32)."""
    return x.dtype == torch.bfloat16


def _cast(module, x: torch.Tensor):
    """The module's weight and bias in a bf16 input's dtype (else as they
    are)."""
    if not _bf16(x):
        return module.weight, module.bias
    return (module.weight.to(x.dtype),
            None if module.bias is None else module.bias.to(x.dtype))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to a bf16 input's dtype
    at use (the parameters stay fp32, their gradients too); on a row slab
    under a spatial sharding, with its halo (``parallel.spatial.conv2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if active_sharding() is not None:
            return spatial.conv2d(self, x, *_cast(self, x))
        if not _bf16(x):
            return super().forward(x)
        return self._conv_forward(x, *_cast(self, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose weight and bias are cast to a
    bf16 input's dtype at use; on a row slab under a spatial sharding, with
    its halo (``parallel.spatial.conv_transpose2d``)."""

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        if active_sharding() is not None and output_size is None:
            return spatial.conv_transpose2d(self, x, *_cast(self, x))
        if not _bf16(x) or output_size is not None:
            return super().forward(x, output_size)
        return F.conv_transpose2d(
            x, *_cast(self, x), self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d``; on a bf16 input, the JAX package's
    arithmetic: in training the batch statistics in fp32 (from the input
    cast to fp32; the running statistics, fp32, updated as torch does, the
    variance unbiased), then ``(x - mean) * inv + bias`` in the input's
    dtype, with ``mean``, ``inv = rsqrt(var + eps) * weight`` and ``bias``
    rounded to it. ``F.batch_norm`` on a bf16 input would normalise in
    fp32 and round once; this rounds where the JAX package does.

    In the recompute of a checkpointed region (``nn.remat``) a train-mode
    forward normalises as the first forward did and updates nothing: the
    running statistics move once per step, as JAX's do.

    In training inside a data-parallel train step
    (``parallel.mesh.data_parallel``, which the train step enters under a
    process group) the statistics are the global batch's, as the JAX
    step's over its batch-sharded array (``jspsr_tpu/nn/layers.py:355-378``):
    ``_global_stats``. Under a spatial sharding, over the whole data x
    space mesh."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        replay = (self.training and self.track_running_stats
                  and remat.recomputing())
        sharding = active_sharding()
        group = None
        if self.training:
            group = (sharding.mesh.group if sharding is not None
                     else step_group())
        if group is not None:
            return self._forward_global(x, replay, group)
        if not _bf16(x) or not self.track_running_stats:
            if not replay:
                return super().forward(x)
            # the first forward's call, its updates written to copies
            return F.batch_norm(
                x, self.running_mean.clone(), self.running_var.clone(),
                self.weight, self.bias, True, self.momentum or 0.0, self.eps)
        if self.training:
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            if not replay:
                n = x.numel() // x.shape[1]
                with torch.no_grad():
                    self.num_batches_tracked.add_(1)
                    m = (self.momentum if self.momentum is not None
                         else 1.0 / float(self.num_batches_tracked))
                    self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1 - m).add_(
                        var * (n / max(n - 1, 1)), alpha=m)
        else:
            mean, var = self.running_mean, self.running_var
        return batch_norm_apply(x, mean, var, self.weight, self.bias,
                                self.eps)


    def _forward_global(self, x: torch.Tensor, replay: bool,
                        group) -> torch.Tensor:
        """Training in a data-parallel step: the global batch's mean and
        biased variance (two passes, ``_global_stats``), the
        running statistics updated with the global count's unbiased
        variance, then ``(x - mean) * inv + bias`` in the input's dtype
        (differentiable in the statistics, whose all-reduces carry the
        gradient back to every rank)."""
        mean, var, n = _global_stats(x, group)
        if self.track_running_stats and not replay:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (self.momentum if self.momentum is not None
                     else 1.0 / float(self.num_batches_tracked))
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(
                    var.detach() * (n / (n - 1).clamp_min(1)), alpha=m)
        inv = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            inv = inv * self.weight
        y = (x - mean.to(x.dtype).view(1, -1, 1, 1)) * \
            inv.to(x.dtype).view(1, -1, 1, 1)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).view(1, -1, 1, 1)
        return y


def _global_stats(x: torch.Tensor, group):
    """(mean, biased variance, count) per channel of NCHW ``x`` over the
    batches of every rank of ``group``, in fp32 for a bf16 ``x``
    (else in its dtype): one differentiable all-reduce of the channel sums
    and the count, then one of the summed squared deviations from the
    global mean."""
    from torch.distributed.nn.functional import all_reduce

    xf = x.float() if _bf16(x) else x
    n_local = x.numel() // x.shape[1]
    sums = all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)),
                                 xf.new_full((1,), float(n_local))]),
                      group=group)
    n = sums[-1]
    mean = sums[:-1] / n
    sq = all_reduce(
        (xf - mean.view(1, -1, 1, 1)).square().sum(dim=(0, 2, 3)),
        group=group)
    return mean, sq / n, n.detach()


def batch_norm_apply(x: torch.Tensor, mean, var, weight, bias,
                     eps: float) -> torch.Tensor:
    """Normalise NCHW ``x`` with fixed per-channel statistics: on fp32 (or
    float64) ``F.batch_norm`` in eval mode, on bf16 the JAX package's
    ``(x - mean) * inv + bias`` in the input's dtype, with ``mean``,
    ``inv = rsqrt(var + eps) * weight`` and ``bias`` rounded to it."""
    if not _bf16(x):
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
    inv = torch.rsqrt(var + eps) * weight

    def c(t):
        return t.to(x.dtype).view(1, -1, 1, 1)

    return (x - c(mean)) * c(inv) + c(bias)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, 1, 1) mean pool (AdaptiveAvgPool2d(1)); of the whole
    images under a spatial sharding."""
    if active_sharding() is not None:
        return spatial.global_avg_pool(x)
    return x.mean(dim=(2, 3), keepdim=True)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, 1, 1) max pool (AdaptiveMaxPool2d(1)); of the whole
    images under a spatial sharding."""
    if active_sharding() is not None:
        return spatial.global_max_pool(x)
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
