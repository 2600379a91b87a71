"""Weighted loss composition (counterpart of ``jspsr_tpu/losses/schemes.py``;
reference losses/loss_schemes.py).

Returns a dict of named loss scalars plus 'Total' (the weighted sum), which
the train step differentiates.
"""

from __future__ import annotations

import torch

from jspsr_torch.losses.functions import get_loss


class SingleLoss:
    def __init__(self, name: str, weight: float = 1.0):
        self.name = name
        self.weight = weight
        self.fn = get_loss(name)

    def __call__(self, pred, gt):
        v = self.fn(pred, gt)
        return {self.name: v, "Total": v}


class MultiLoss:
    def __init__(self, loss_weights: dict):
        self.loss_weights = dict(loss_weights)
        self.fns = {name: get_loss(name) for name in self.loss_weights}

    def __call__(self, pred, gt):
        out = {name: fn(pred, gt) for name, fn in self.fns.items()}
        out["Total"] = torch.stack(
            [self.loss_weights[n] * out[n] for n in self.fns]).sum()
        return out


def build_criterion(loss_cfg: dict):
    """loss_cfg: {name: weight}, e.g. {'L1': 1, 'L2': 1, 'Grad': 0.1}
    (reference utils/common_config.py:209-233)."""
    if len(loss_cfg) == 1:
        ((name, weight),) = loss_cfg.items()
        return SingleLoss(name, weight)
    return MultiLoss(loss_cfg)
