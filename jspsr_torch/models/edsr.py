"""EDSR baseline (counterpart of ``jspsr_tpu/models/edsr.py``; reference
models/EDSR.py): a residual CNN super-resolution network, optionally with
the SPN refinement head on the DEM channel.

The shipped DEM configs run it at scale 1 (the LR DEM is resampled onto the
target grid first), so the factory never builds the ``Upscaler``; it is
kept for scale 2/4 image SR. Parameter names follow the reference torch
layout: ``ResBlock`` -> ``body.0`` / ``body.2``, ``Upscaler`` -> ``0`` (and
``2`` at scale 4). EDSR's own convs are initialised with the reference's
normal fan-out scheme; the SPN head's with the JSPSR scheme, as in the JAX
package.
"""

from __future__ import annotations

import torch
from torch import nn

from jspsr_torch import nn as jnn
from jspsr_torch.models.spn import Generator, PostProcessor
from jspsr_torch.nn.initializers import normal_fan_out_

# default public-checkpoint path for ``model_kwargs.pretrained: true``
# (reference models/EDSR.py:87), loaded by tensor position
# (``utils/pretrained.py``)
DEFAULT_PRETRAINED = "./models/pretrained/EDSR-b32f128x2.bin"


def _conv(cin: int, cout: int, k: int = 3) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=True)


class ResBlock(nn.Module):
    """conv-ReLU-conv with a scaled residual (reference EDSR.py:13-44)."""

    def __init__(self, n_feat: int, kernel_size: int = 3,
                 res_scale: float = 1.0):
        super().__init__()
        self.body = nn.Sequential(_conv(n_feat, n_feat, kernel_size),
                                  nn.ReLU(),
                                  _conv(n_feat, n_feat, kernel_size))
        self.res_scale = res_scale

    def forward(self, x):
        return self.body(x) * self.res_scale + x


class Upscaler(nn.Sequential):
    """conv + PixelShuffle(2), twice at scale 4 (reference EDSR.py:47-63)."""

    def __init__(self, n_feat: int, scale: int):
        if scale not in (2, 4):
            raise ValueError(f"Upscaler scale must be 2 or 4, got {scale}")
        mods = []
        for _ in range(scale // 2):
            mods += [_conv(n_feat, n_feat * 4, 3), nn.PixelShuffle(2)]
        super().__init__(*mods)


class EDSR(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 n_resblocks: int = 16, n_features: int = 64, scale: int = 1,
                 res_scale: float = 0.1, spn: bool = False,
                 generator: torch.Generator | None = None):
        """``generator`` seeds the init; ``None`` draws from a generator
        seeded with 0."""
        super().__init__()
        self.url = DEFAULT_PRETRAINED
        self.res_scale = res_scale
        self.spn = spn
        self.entry = _conv(in_channels, n_features, 3)
        self.encoder = nn.Sequential(
            *[ResBlock(n_features, 3, res_scale) for _ in range(n_resblocks)],
            _conv(n_features, n_features, 3))
        self.decoder = Upscaler(n_features, scale) if scale > 1 else None
        if spn:
            self.generator = Generator(n_features, 3, bc=n_features // 2)
            self.post_layer = PostProcessor(3, residual=True)
        else:
            self.head = _conv(n_features, out_channels, 3)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        head = set(self.generator.modules()) if spn else set()
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d) and m not in head:
                    normal_fan_out_(m.weight, gen)
                    m.bias.zero_()
        if spn:
            jnn.init_weights(self.generator, gen)

    def forward(self, x, generator=None):
        """``x``: the channel-stacked inputs (B, C, H, W), or a list of
        tensors to stack, the DEM first. ``generator`` is accepted as every
        model's forward accepts it; EDSR draws nothing."""
        if isinstance(x, (list, tuple)):
            x = torch.cat(list(x), dim=1)
        xs = self.entry(x)
        y = self.encoder(xs) + self.res_scale * xs
        if self.decoder is not None:
            y = self.decoder(y)
        if not self.spn:
            return self.head(y)
        dem = x.detach()[:, :1]
        weight, offset = self.generator(dem, y)
        return self.post_layer(dem, weight, offset)
