"""Seeded perturbation of a model's state away from its init, so that a
comparison of two runs (card against CPU, the port against JAX) exercises
every part of the forward and backward.

At init, BatchNorm's running statistics are 0/1 and NLSPN's
offset/affinity conv is zero, which makes the propagation the identity
and the deform input gradient trivial.
"""

from __future__ import annotations

import torch

from jspsr_torch.models.nlspn import NLSPN


def perturb_weights(model: torch.nn.Module, seed: int,
                    affine: bool = False) -> torch.nn.Module:
    """BatchNorm running statistics (and with ``affine`` its scale and
    shift) away from 0/1, and NLSPN's offset/affinity conv away from its
    zero init: offsets of about 1 px, affinity logits of about 100
    (tanh(aff / 100) near +-0.8). Draws from a ``torch.Generator`` seeded
    with ``seed``; changes ``model`` in place and returns it."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                if affine:
                    m.weight.uniform_(0.5, 1.5, generator=gen)
                    m.bias.normal_(0, 0.1, generator=gen)
            elif isinstance(m, NLSPN):
                conv, n = m.conv_offset_aff, 2 * m.num
                conv.weight.normal_(0, 0.05, generator=gen)
                conv.bias[:n].normal_(0, 1.0, generator=gen)
                conv.bias[n:].normal_(0, 100.0, generator=gen)
    return model
