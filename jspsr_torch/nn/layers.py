"""Core layers (counterpart of ``jspsr_tpu/nn/layers.py``).

The port's models use torch's NCHW / OIHW ``nn.Conv2d``,
``nn.ConvTranspose2d`` and ``nn.BatchNorm2d`` directly: their padding,
output-size and BatchNorm (eps 1e-5, momentum 0.1) semantics are the ones
the JAX package reproduces. What remains here is the JAX package's init
and its global pools.

The JAX package's TPU lowering levers (space-to-depth stride-2 convs, the
stride-1 conv custom VJP, the wgrad dot) are exact re-expressions of the
same functions and have no counterpart here.
"""

from __future__ import annotations

import torch
from torch import nn

from jspsr_torch.nn.initializers import trunc_normal_fan_in_


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, 1, 1) mean pool (AdaptiveAvgPool2d(1))."""
    return x.mean(dim=(2, 3), keepdim=True)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, 1, 1) max pool (AdaptiveMaxPool2d(1))."""
    return x.amax(dim=(2, 3), keepdim=True)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init, in module registration order: truncated-normal
    fan-in conv weights (fan-in = kh*kw*in_channels for both conv kinds),
    zero conv biases, BatchNorm at scale 1, bias 0, mean 0, var 1."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            trunc_normal_fan_in_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, nn.ConvTranspose2d):
            kh, kw = m.kernel_size
            trunc_normal_fan_in_(m.weight, kh * kw * m.in_channels, generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
