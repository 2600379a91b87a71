"""Weight initializers matching the reference's schemes
(counterpart of ``jspsr_tpu/nn/initializers.py``).

The reference initializes every conv in JSPSR with a truncated normal,
std = sqrt(1.3 * 2 / n), n = kh*kw*in_channels, truncated at +/-2 std
(reference models/JSPSR.py:494-517), and EDSR's own convs with a plain
normal, std = sqrt(2 / n), n = kh*kw*out_channels (models/EDSR.py:113-118).
Draws come from an explicit ``torch.Generator``, so a seed fixes the
weights.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def trunc_normal_fan_in_(weight: torch.Tensor, fan_in: int,
                         generator: torch.Generator,
                         scale: float = 1.3 * 2.0) -> torch.Tensor:
    """In place: truncated normal at +/-2 std, std = sqrt(scale / fan_in)."""
    std = math.sqrt(scale / fan_in)
    return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


@torch.no_grad()
def normal_fan_out_(weight: torch.Tensor, generator: torch.Generator,
                    scale: float = 2.0) -> torch.Tensor:
    """In place, for an OIHW conv weight: normal, std = sqrt(scale /
    (kh*kw*out_channels))."""
    fan_out = weight.shape[0] * weight[0, 0].numel()
    return weight.normal_(0.0, math.sqrt(scale / fan_out),
                          generator=generator)
