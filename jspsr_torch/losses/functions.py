"""Loss functions (counterpart of ``jspsr_tpu/losses/functions.py``;
reference losses/loss_functions.py) on NCHW tensors.

All take (pred, gt) and return a scalar tensor. The channel axis is dim 1
where the JAX package, on NHWC, reduces over the last axis.

Under a spatial sharding (``parallel/spatial.py``) each loss is this
rank's share of the whole batch's loss, so that the ranks' losses sum to
it and their summed gradients are its gradients: the means are sums over
the whole batch's count (``_mean``); Grad's Sobel and TV's vertical
differences take halo rows from the slab below (and above, for the
Sobel); SSIM's valid window ten rows below (``ops.filters.ssim``), a slab
owning the window positions that start in it; BerHu's threshold is the
mesh's largest error, and softmax CE's valid count and balanced BCE's
class counts are the mesh's, all detached, as they are constants of the
one-process gradient.
"""

from __future__ import annotations

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


def _count(t: torch.Tensor) -> torch.Tensor:
    """``t.sum()``; under a spatial sharding, the whole batch's, detached
    (a count: no gradient flows through it)."""
    if active_sharding() is not None:
        return spatial.mesh_sum(t)
    return t.sum()


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


def berhu_loss(pred, gt, delta: float = 0.6):
    """Reversed Huber; threshold = delta * max|err| over the whole batch,
    detached (the reference's ``.item()`` at loss_functions.py:197)."""
    diff = (pred - gt).abs()
    top = (spatial.mesh_max(diff) if active_sharding() is not None
           else diff.max())
    th = (delta * top).detach()
    return _mean(torch.where(diff <= th, diff,
                             (diff**2 + th**2) / (2 * th)))


def tv_loss(pred, gt=None, weight: float = 1.0):
    """Total variation (reference loss_functions.py:126-149). gt ignored.
    On a row slab the vertical differences take the first row of the slab
    below (the image's last row has none), the counts the whole batch's."""
    x = pred
    if active_sharding() is None:
        b, c, h, w = x.shape
        h_tv = (x[:, :, 1:] - x[:, :, :-1]).square().sum()
    else:
        b, c, h, w = spatial.whole_shape(x)
        xp = spatial.halo(x, 0, 1)
        dh = (xp[:, :, 1:] - xp[:, :, :-1]).square()
        # the same graph on every rank: the last slab's last difference
        # (with the zeros below the image) is sliced off, not branched on
        h_tv = dh[:, :, :dh.shape[2] - int(spatial.last_slab())].sum()
    w_tv = (x[:, :, :, 1:] - x[:, :, :, :-1]).square().sum()
    count_h = c * (h - 1) * w
    count_w = c * h * (w - 1)
    return weight * 2 * (h_tv / count_h + w_tv / count_w) / b


def surface_normal_loss(pred, gt):
    """1 - cosine similarity over the channel axis
    (loss_functions.py:211-226)."""
    eps = 1e-12
    pn = pred / pred.norm(dim=1, keepdim=True).clamp_min(eps)
    gn = gt / gt.norm(dim=1, keepdim=True).clamp_min(eps)
    return _mean(1.0 - (pn * gn).sum(dim=1))


def ssim_loss(pred, gt):
    """1 - SSIM (reference loss_functions.py:232-239; piq semantics:
    gaussian 11/1.5, valid padding, data_range 1); on a row slab, this
    rank's share of 1 less its share of the whole batch's SSIM."""
    one = (1.0 / spatial.world() if active_sharding() is not None
           else 1.0)
    return one - ssim(pred.clamp(0.0, 1.0), gt, padding="valid")


def bce_with_logits_loss(pred, gt):
    return _mean(pred.clamp_min(0) - pred * gt
                 + torch.log1p(torch.exp(-pred.abs())))


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
    return (nll * valid).sum() / _count(valid).clamp_min(1)


def balanced_bce_loss(pred, gt, pos_weight=None):
    """HED-style class-balanced BCE-with-logits (reference
    loss_functions.py:31-80), size-averaged."""
    labels = (gt >= 0.5).to(pred.dtype)
    if pos_weight is None:
        n_pos = _count(labels)
        n_neg = _count(1.0 - labels)
        w = n_neg / (n_pos + n_neg).clamp_min(1.0)
    else:
        w = pos_weight
    gt0 = (pred >= 0).to(pred.dtype)
    loss_val = pred * (labels - gt0) - torch.log1p(
        torch.exp(pred - 2.0 * pred * gt0))
    loss_pos = -(labels * loss_val).sum()
    loss_neg = -((1.0 - labels) * loss_val).sum()
    numel = (gt.numel() * spatial.world() if active_sharding() is not None
             else gt.numel())
    return (w * loss_pos + (1.0 - w) * loss_neg) / numel


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
