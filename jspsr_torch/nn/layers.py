"""Core layers (counterpart of ``jspsr_tpu/nn/layers.py``).

The port's models use torch's NCHW / OIHW ``nn.Conv2d``,
``nn.ConvTranspose2d``, ``nn.BatchNorm2d``, ``nn.Linear`` (the JAX
``Dense``, whose (in, out) weight is torch's transposed) and
``nn.LayerNorm`` (eps 1e-5 unless a module says otherwise) directly: their
padding, output-size and normalisation semantics are the ones the JAX
package reproduces. What remains here is the JAX package's init, its global
pools and its bilinear resize.

The JAX package's TPU lowering levers (space-to-depth stride-2 convs, the
stride-1 conv custom VJP, the wgrad dot) are exact re-expressions of the
same functions and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jspsr_torch.nn.initializers import trunc_normal_fan_in_


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, 1, 1) mean pool (AdaptiveAvgPool2d(1))."""
    return x.mean(dim=(2, 3), keepdim=True)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, 1, 1) max pool (AdaptiveMaxPool2d(1))."""
    return x.amax(dim=(2, 3), keepdim=True)


def bilinear_resize(x: torch.Tensor, h: int, w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """NCHW bilinear resize to (h, w), torch's ``F.interpolate`` without
    antialias (the JAX package's ``bilinear_resize`` reproduces it, when
    shrinking too); the input itself when the size already matches."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=align_corners)


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
