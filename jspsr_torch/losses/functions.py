"""Loss functions (counterpart of ``jspsr_tpu/losses/functions.py``;
reference losses/loss_functions.py) on NCHW tensors.

All take (pred, gt) and return a scalar tensor. The channel axis is dim 1
where the JAX package, on NHWC, reduces over the last axis.

Under a spatial sharding (``parallel/spatial.py``) L1, L2, Charbonnier and
Grad are this rank's share of the whole batch's loss (its sum over the
whole count; Grad's Sobel with its halo row), so that the ranks' losses
sum to it; every other loss is refused there.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from jspsr_torch.ops.filters import spatial_gradient, ssim
from jspsr_torch.parallel import spatial
from jspsr_torch.parallel.mesh import active_sharding


def _mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean()``; under a spatial sharding, this rank's share of the
    whole batch's mean."""
    if active_sharding() is not None:
        return spatial.mean(t)
    return t.mean()


def _unsharded(fn):
    """A loss that is refused under a spatial sharding."""
    @functools.wraps(fn)
    def loss(*args, **kwargs):
        spatial.refuse(f"the {fn.__name__}", "losses")
        return fn(*args, **kwargs)
    return loss


def l1_loss(pred, gt):
    return _mean((pred - gt).abs())


def l2_loss(pred, gt):
    return _mean((pred - gt).square())


def edge_loss(pred, gt):
    """L1 between normalized-Sobel gradients ('Grad' in shipped configs;
    reference loss_functions.py:171-185)."""
    px, py = spatial_gradient(pred)
    gx, gy = spatial_gradient(gt)
    return 0.5 * (_mean((px - gx).abs()) + _mean((py - gy).abs()))


def charbonnier_loss(pred, gt, eps: float = 1e-9):
    d = pred - gt
    return _mean(torch.sqrt(d * d + eps))


@_unsharded
def berhu_loss(pred, gt, delta: float = 0.6):
    """Reversed Huber; threshold = delta * max|err|, detached (the
    reference's ``.item()`` at loss_functions.py:197)."""
    diff = (pred - gt).abs()
    th = (delta * diff.max()).detach()
    return torch.where(diff <= th, diff, (diff**2 + th**2) / (2 * th)).mean()


@_unsharded
def tv_loss(pred, gt=None, weight: float = 1.0):
    """Total variation (reference loss_functions.py:126-149). gt ignored."""
    x = pred
    b = x.shape[0]
    h_tv = (x[:, :, 1:] - x[:, :, :-1]).square().sum()
    w_tv = (x[:, :, :, 1:] - x[:, :, :, :-1]).square().sum()
    count_h = x[:, :, 1:].numel() // b
    count_w = x[:, :, :, 1:].numel() // b
    return weight * 2 * (h_tv / count_h + w_tv / count_w) / b


@_unsharded
def surface_normal_loss(pred, gt):
    """1 - cosine similarity over the channel axis
    (loss_functions.py:211-226)."""
    eps = 1e-12
    pn = pred / pred.norm(dim=1, keepdim=True).clamp_min(eps)
    gn = gt / gt.norm(dim=1, keepdim=True).clamp_min(eps)
    return (1.0 - (pn * gn).sum(dim=1)).mean()


@_unsharded
def ssim_loss(pred, gt):
    """1 - SSIM (reference loss_functions.py:232-239; piq semantics:
    gaussian 11/1.5, valid padding, data_range 1)."""
    return 1.0 - ssim(pred.clamp(0.0, 1.0), gt, padding="valid")


@_unsharded
def bce_with_logits_loss(pred, gt):
    return (pred.clamp_min(0) - pred * gt
            + torch.log1p(torch.exp(-pred.abs()))).mean()


@_unsharded
def softmax_ce_loss(pred, label, ignore_index: int = 255):
    """Semantic-seg cross entropy with an ignore label (reference
    loss_functions.py:11-28). pred (N, C, H, W) logits; label (N, 1, H, W)
    or (N, H, W) integers."""
    label = label.squeeze(1) if label.ndim == pred.ndim else label
    label = label.long()
    valid = label != ignore_index
    logp = F.log_softmax(pred, dim=1)
    safe = torch.where(valid, label, torch.zeros_like(label))
    nll = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
    return (nll * valid).sum() / valid.sum().clamp_min(1)


@_unsharded
def balanced_bce_loss(pred, gt, pos_weight=None):
    """HED-style class-balanced BCE-with-logits (reference
    loss_functions.py:31-80), size-averaged."""
    labels = (gt >= 0.5).to(pred.dtype)
    if pos_weight is None:
        n_pos = labels.sum()
        n_neg = (1.0 - labels).sum()
        w = n_neg / (n_pos + n_neg).clamp_min(1.0)
    else:
        w = pos_weight
    gt0 = (pred >= 0).to(pred.dtype)
    loss_val = pred * (labels - gt0) - torch.log1p(
        torch.exp(pred - 2.0 * pred * gt0))
    loss_pos = -(labels * loss_val).sum()
    loss_neg = -((1.0 - labels) * loss_val).sum()
    return (w * loss_pos + (1.0 - w) * loss_neg) / gt.numel()


_REGISTRY = {
    "l1": l1_loss,
    "l2": l2_loss,
    "mse": l2_loss,
    "edge": edge_loss,
    "grad": edge_loss,
    "charbonnier": charbonnier_loss,
    "berhu": berhu_loss,
    "tv": tv_loss,
    "norm": surface_normal_loss,
    "ssim": ssim_loss,
    "vanilla": bce_with_logits_loss,
    "bce": bce_with_logits_loss,
    "softmax": softmax_ce_loss,
    "balanced_bce": balanced_bce_loss,
}


def get_loss(name: str):
    """Name-keyed loss registry (reference losses/loss_schemes.py:6-33)."""
    key = name.lower()
    if key not in _REGISTRY:
        raise NotImplementedError(f"Undefined loss: {name}")
    return _REGISTRY[key]
