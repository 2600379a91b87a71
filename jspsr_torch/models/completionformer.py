"""CompletionFormer (counterpart of ``jspsr_tpu/models/completionformer.py``;
reference models/CompletionFormer.py and
models/components/completion_former_backbone.py): a PVT-transformer
backbone producing an initial depth, a guidance map and a confidence,
followed by NLSPN propagation.

Inputs are explicit, as in the JAX package: ``[dem, guidance]`` with the
guidance channels (image, then mask / canopy / coord) stacked, as
``data.loader.build_batch_inputs`` assembles them. The backbone halves the
resolution five times: H and W must be multiples of 32.

Under a spatial sharding (``parallel/spatial.py``) every conv, pool and
BatchNorm takes its hooks, PVT attends over the whole image
(``models/pvt.py``) and NLSPN samples the whole feature
(``models/nlspn.py``); the slabs' rows must start on rows that all five
halvings keep, and stage 1's spatial-reduction conv of 8 at H / 4 needs
slab rows there that divide by 8: H divides by ``ROW_MULTIPLE`` (32) times
the space axis.
"""

from __future__ import annotations

import torch
from torch import nn

from jspsr_torch import nn as jnn
from jspsr_torch.models.components import CBAMBasicBlock
from jspsr_torch.models.nlspn import NLSPN
from jspsr_torch.models.pvt import PVT

GUIDANCE_KEYS = ("image", "mask", "canopy", "coord")


def conv_bn_relu(cin, cout, kernel, stride=1, padding=0, bn=True,
                 relu=True) -> nn.Sequential:
    mods = [jnn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                       bias=not bn)]
    if bn:
        mods.append(jnn.BatchNorm2d(cout))
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


def convt_bn_relu(cin, cout, kernel, stride=1, padding=0, output_padding=0,
                  bn=True, relu=True) -> nn.Sequential:
    mods = [jnn.ConvTranspose2d(cin, cout, kernel, stride=stride,
                                padding=padding,
                                output_padding=output_padding, bias=not bn)]
    if bn:
        mods.append(jnn.BatchNorm2d(cout))
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


def _concat(fd, fe):
    """The decoder feature resized to the encoder's size (bilinear,
    align_corners=True; the sizes are equal, so the feature itself, on a
    row slab too), then concatenated before it."""
    fd = jnn.bilinear_resize(fd, fe.shape[-2], fe.shape[-1],
                             align_corners=True)
    return torch.cat([fd, fe], dim=1)


class Backbone(nn.Module):
    def __init__(self, guidance_channels: int, prop_kernel: int = 3,
                 conf_prop: bool = True):
        super().__init__()
        self.conf_prop = conf_prop
        num_neighbors = prop_kernel * prop_kernel - 1
        ic = guidance_channels

        self.conv1_rgb = conv_bn_relu(ic, ic * 16, 3, 1, 1, bn=False)
        self.conv1_dep = conv_bn_relu(1, 16, 3, 1, 1, bn=False)
        self.conv1 = conv_bn_relu((ic + 1) * 16, 64, 3, 1, 1, bn=False)

        self.former = PVT(in_chans=128, patch_size=2)

        ch = [64, 128, 64, 128, 320, 512]
        self.dec6 = nn.Sequential(convt_bn_relu(ch[5], 256, 3, 2, 1, 1),
                                  CBAMBasicBlock(256, 256, ratio=16))
        self.dec5 = nn.Sequential(convt_bn_relu(256 + ch[4], 128, 3, 2, 1, 1),
                                  CBAMBasicBlock(128, 128, ratio=8))
        self.dec4 = nn.Sequential(convt_bn_relu(128 + ch[3], 64, 3, 2, 1, 1),
                                  CBAMBasicBlock(64, 64, ratio=4))
        self.dec3 = nn.Sequential(convt_bn_relu(64 + ch[2], 64, 3, 2, 1, 1),
                                  CBAMBasicBlock(64, 64, ratio=4))
        self.dec2 = nn.Sequential(convt_bn_relu(64 + ch[1], 64, 3, 2, 1, 1),
                                  CBAMBasicBlock(64, 64, ratio=4))
        self.dep_dec1 = conv_bn_relu(64 + 64, 64, 3, 1, 1)
        self.dep_dec0 = conv_bn_relu(64 + 64, 1, 3, 1, 1, bn=False, relu=True)
        self.gd_dec1 = conv_bn_relu(64 + ch[0], 64, 3, 1, 1)
        self.gd_dec0 = conv_bn_relu(64 + 64, num_neighbors, 3, 1, 1, bn=False,
                                    relu=False)
        if conf_prop:
            self.cf_dec1 = conv_bn_relu(64 + ch[0], 32, 3, 1, 1)
            self.cf_dec0 = nn.Sequential(
                jnn.Conv2d(32 + 64, 1, 3, padding=1, bias=True),
                nn.Sigmoid())

    def forward(self, rgb, depth, generator=None):
        """-> (initial depth, guidance, confidence or None), NCHW."""
        fe1 = self.conv1(torch.cat([self.conv1_rgb(rgb),
                                    self.conv1_dep(depth)], dim=1))
        fe2, fe3, fe4, fe5, fe6, fe7 = self.former(fe1, generator=generator)

        fd6 = self.dec6(fe7)
        fd5 = self.dec5(_concat(fd6, fe6))
        fd4 = self.dec4(_concat(fd5, fe5))
        fd3 = self.dec3(_concat(fd4, fe4))
        fd2 = self.dec2(_concat(fd3, fe3))

        init_depth = self.dep_dec0(_concat(self.dep_dec1(_concat(fd2, fe2)),
                                           fe1))
        guide = self.gd_dec0(_concat(self.gd_dec1(_concat(fd2, fe2)), fe1))
        confidence = None
        if self.conf_prop:
            confidence = self.cf_dec0(
                _concat(self.cf_dec1(_concat(fd2, fe2)), fe1))
        return init_depth, guide, confidence


class CompletionFormer(nn.Module):
    # H divides by this times a spatial sharding's space axis
    ROW_MULTIPLE = 32

    def __init__(self, in_channels: dict, out_channels: int = 1,
                 prop_time: int = 6, prop_kernel: int = 3,
                 conf_prop: bool = True, affinity: str = "TGASS",
                 affinity_gamma: float = 0.5, preserve_input: bool = False,
                 generator: torch.Generator | None = None):
        """``generator`` seeds the init (the JAX package's schemes: conv
        truncated-normal fan-in, Linear and position embeddings normal at
        0.02, NLSPN's offset/affinity conv at zero); ``None`` draws from a
        generator seeded with 0."""
        super().__init__()
        guidance_ch = sum(v for k, v in in_channels.items()
                          if k in GUIDANCE_KEYS)
        self.prop_time = prop_time
        self.backbone = Backbone(guidance_ch, prop_kernel, conf_prop)
        if prop_time > 0:
            self.prop_layer = NLSPN(prop_kernel * prop_kernel - 1, 1, 3,
                                    prop_kernel, prop_time, affinity,
                                    affinity_gamma, conf_prop, preserve_input)
        jnn.init_weights(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))
        if prop_time > 0:
            self.prop_layer.reset_parameters()

    def input_keys(self):
        return ["lr_dem", "guidance"]

    def forward(self, inputs, generator: torch.Generator | None = None):
        """inputs: [dem (B,1,H,W), guidance (B,C,H,W)] -> (B,1,H,W).
        ``generator`` draws the backbone's drop-path masks in training."""
        if len(inputs) != 2:
            raise ValueError(f"expected inputs {self.input_keys()}, got "
                             f"{len(inputs)}")
        dep, rgb = inputs
        pred_init, guide, confidence = self.backbone(rgb, dep,
                                                     generator=generator)
        pred_init = pred_init + dep
        if self.prop_time <= 0:
            return pred_init
        return self.prop_layer(pred_init, guide, confidence, dep)[0]
