"""LRRU baseline (counterpart of ``jspsr_tpu/models/lrru.py``; reference
models/LRRU.py): long-range recurrent-update guided depth/DEM completion.

A dual image / DEM ("lidar") encoder of stochastic-depth BasicBlocks over
5 stages (survival probability annealed linearly across the blocks), the
DEM branch fused with the image branch after every stage but the last; a
decoder that runs 4 refinement rounds, each predicting affinities and
offsets from the PREVIOUS round's output, detached, and applying the shared
modulated deformable post-process (reference LRRU.py:453,467,481,496).

Rounds 1-3 reach the loss only through a detached output, so their heads
(``upproj0-2``, ``weight_offset0-2``) run without autograd here: they get
no gradient in either package (the train step gives them a zero one, as
``jax.grad`` does). Each round detaches its input depth, so the
post-process's deform backward never needs the input gradient.

StoDepth as the JAX package runs it: its ``LRRU.__call__`` passes no key to
the blocks, so a block never draws. In training a block is ``relu(out +
idt)``; in eval ``relu(prob * out + idt)`` under ``mult_flag``.

Parameter names follow the reference torch layout (the layout
``jspsr_tpu/utils/torch_import.py`` reads): the JAX ``LBasic2d`` is the
port's ``Basic2d`` (``conv.0`` / ``conv.bn``) and its ``PostProcess`` the
port's ``PostProcessor``, ``LBasic2dTrans`` -> ``conv`` / ``bn``, ``LDownsample`` ->
``0`` / ``1``, ``BasicDepthEncoder``'s heads -> ``conv_weight`` /
``conv_offset`` (plain convs). ``conv1x1``, ``conv3x3``, ``LDownsample``
and ``LBasicBlock`` are also PVT's building blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jspsr_torch import nn as jnn
from jspsr_torch.models.components import (  # noqa: F401 (re-exported)
    Basic2d,
    BasicBlock as LBasicBlock,
    Downsample as LDownsample,
    conv1x1,
    conv3x3,
)
from jspsr_torch.models.spn import PostProcessor
from jspsr_torch.ops.deform_conv import insert_zero_center_offset


class LBasic2dTrans(nn.Module):
    """ConvTranspose2d(k3, s2, p1, op1, no bias) + BN + ReLU: upsamples 2x.
    Its children are ``conv`` / ``bn``, not JSPSR's ``dconv.*``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class StoDepthBlock(nn.Module):
    """Stochastic-depth BasicBlock (reference LRRU.py:125-185), without
    draws (see the module docstring)."""

    def __init__(self, prob: float, mult_flag: bool, cin: int, planes: int,
                 stride: int = 1, downsample: nn.Module | None = None):
        super().__init__()
        self.prob = float(prob)
        self.mult_flag = mult_flag
        self.conv1 = conv3x3(cin, planes, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if not self.training and self.mult_flag:
            out = self.prob * out
        return F.relu(out + idt)


class LGuide(nn.Module):
    """Channel concat + Basic2d fusion (reference LRRU.py:187-201)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv = Basic2d(planes * 2, planes)

    def forward(self, feat, weight):
        return self.conv(torch.cat([feat, weight], dim=1))


class BasicDepthEncoder(nn.Module):
    """Per-round affinity / offset generator (reference LRRU.py:203-247)."""

    def __init__(self, kernel_size: int = 3, bc: int = 16):
        super().__init__()
        self.kernel_size = kernel_size
        num = kernel_size * kernel_size - 1
        self.convd1 = Basic2d(1, bc * 2, bn=False)
        self.convd2 = Basic2d(bc * 2, bc * 2, bn=False)
        self.convf1 = Basic2d(bc * 2, bc * 2, bn=False)
        self.convf2 = Basic2d(bc * 2, bc * 2, bn=False)
        self.conv = Basic2d(bc * 4, bc * 4, bn=False)
        self.ref = LBasicBlock(bc * 4, bc * 4, act=False)
        self.conv_weight = nn.Conv2d(bc * 4, kernel_size ** 2, 1)
        self.conv_offset = nn.Conv2d(bc * 4, 2 * num, 1)

    def forward(self, depth, context):
        d = self.convd2(self.convd1(depth))
        f = self.convf2(self.convf1(context))
        feat = self.ref(self.conv(torch.cat([d, f], dim=1)))
        # Both 1x1 heads in one conv (exact: the concatenated output
        # channels are independent), as the JAX package runs them: the
        # full-resolution feature map is read once per round, not twice.
        k2 = self.kernel_size ** 2
        heads = F.conv2d(
            feat, torch.cat([self.conv_weight.weight,
                             self.conv_offset.weight]),
            torch.cat([self.conv_weight.bias, self.conv_offset.bias]))
        weight = torch.sigmoid(heads[:, :k2])
        offset = insert_zero_center_offset(heads[:, k2:], self.kernel_size)
        return weight, offset


class LRRU(nn.Module):
    def __init__(self, in_channels: dict, out_channels: int = 1,
                 kernel_size: int = 3, bc: int = 16, prob: float = 1.0,
                 dkn_residual: bool = True, layers=(2, 2, 2, 2, 2),
                 mult_flag: bool = True, preserve_input: bool = True,
                 generator: torch.Generator | None = None):
        """``generator`` seeds the init (the JAX package's truncated-normal
        fan-in); ``None`` draws from a generator seeded with 0."""
        super().__init__()
        if "lr_dem" not in in_channels or "image" not in in_channels:
            raise ValueError("LRRU needs the lr_dem and image inputs")
        self.preserve_input = preserve_input
        ic = bc * 2
        self.conv_img = Basic2d(3, ic, kernel_size=5, padding=2)
        self.conv_lidar = Basic2d(1, ic, kernel_size=5, padding=2, bn=False)

        # survival probability annealed linearly over the blocks, the
        # image and DEM branches' blocks in step (the JAX package's running
        # ``_prob_now``, subtraction by subtraction)
        step, prob_now, probs = (1.0 - prob) / (sum(layers) - 1), 1.0, []
        for _ in range(sum(layers)):
            probs.append(prob_now)
            prob_now -= step
        chans = [ic * 2, ic * 4, ic * 8, ic * 8, ic * 8]
        strides = [1, 2, 2, 2, 2]
        inplanes, first = ic, 0
        for i in range(5):
            stage_probs = probs[first:first + layers[i]]
            first += layers[i]
            for branch in ("img", "lidar"):
                setattr(self, f"layer{i + 1}_{branch}",
                        self._make_layer(inplanes, chans[i], stage_probs,
                                         strides[i], mult_flag))
            if i < 4:
                setattr(self, f"guide{i + 1}", LGuide(chans[i]))
            inplanes = chans[i]

        self.layer4d = LBasic2dTrans(ic * 8, ic * 8)
        self.upproj0 = nn.Sequential(LBasic2dTrans(ic * 8, ic * 4),
                                     LBasic2dTrans(ic * 4, ic * 2),
                                     LBasic2dTrans(ic * 2, ic))
        self.weight_offset0 = BasicDepthEncoder(kernel_size, bc)
        self.layer3d = LBasic2dTrans(ic * 8, ic * 8)
        self.upproj1 = nn.Sequential(LBasic2dTrans(ic * 8, ic * 4),
                                     LBasic2dTrans(ic * 4, ic))
        self.weight_offset1 = BasicDepthEncoder(kernel_size, bc)
        self.layer2d = LBasic2dTrans(ic * 8, ic * 4)
        self.upproj2 = nn.Sequential(LBasic2dTrans(ic * 4, ic))
        self.weight_offset2 = BasicDepthEncoder(kernel_size, bc)
        self.layer1d = LBasic2dTrans(ic * 4, ic * 2)
        self.conv = Basic2d(ic * 2, ic)
        self.weight_offset3 = BasicDepthEncoder(kernel_size, bc)
        # the shared deformable post-process (reference LRRU.py:250-298):
        # zero-mean affinities under ``dkn_residual``, a kernel of ones
        self.Post_process = PostProcessor(kernel_size, residual=dkn_residual)
        jnn.init_weights(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))

    @staticmethod
    def _make_layer(inplanes, planes, probs, stride, mult_flag):
        """One encoder stage of one branch, a block per survival
        probability in ``probs``."""
        ds = (LDownsample(inplanes, planes, stride)
              if stride != 1 or inplanes != planes else None)
        mods = [StoDepthBlock(probs[0], mult_flag, inplanes, planes, stride,
                              ds)]
        mods += [StoDepthBlock(q, mult_flag, planes, planes)
                 for q in probs[1:]]
        return nn.Sequential(*mods)

    def input_keys(self):
        return ["lr_dem", "image"]

    def _preserve(self, out, depth):
        """Every pixel where the input DEM is > 0 replaced by the input."""
        if not self.preserve_input:
            return out
        mask = (depth > 0.0).any(dim=1, keepdim=True).to(depth.dtype)
        return (1.0 - mask) * out + mask * depth

    def _round(self, output, depth, encoder, context):
        """One refinement round on the previous output, detached (so the
        post-process's deform backward never needs the input gradient)."""
        output = self._preserve(output, depth).detach()
        weight, offset = encoder(output, context)
        return self.Post_process(output, weight, offset)

    def forward(self, inputs, generator=None):
        """``inputs``: [lr_dem (B,1,H,W), image (B,3,H,W)], H and W
        multiples of 16. ``generator`` is accepted as every model's forward
        accepts it; LRRU draws nothing (see the module docstring)."""
        depth, img = inputs[0], inputs[1]
        c0_img = self.conv_img(img)
        c0_lidar = self.conv_lidar(depth)
        c_img, c_dyn, dyns = c0_img, c0_lidar, {}
        for i in range(1, 6):
            new_img = getattr(self, f"layer{i}_img")(c_img)
            new_dep = getattr(self, f"layer{i}_lidar")(c_dyn)
            if i < 5:
                c_dyn = dyns[i] = getattr(self, f"guide{i}")(new_dep, new_img)
            c_img = new_img
        c5 = new_img + new_dep

        c4 = self.layer4d(c5) + dyns[4]
        c3 = self.layer3d(c4) + dyns[3]
        c2 = self.layer2d(c3) + dyns[2]
        # rounds 1-3 reach the loss only through a detached output
        with torch.no_grad():
            output = self._round(depth, depth, self.weight_offset0,
                                 self.upproj0(c4))
            output = self._round(output, depth, self.weight_offset1,
                                 self.upproj1(c3))
            output = self._round(output, depth, self.weight_offset2,
                                 self.upproj2(c2))
        c0 = self.conv(self.layer1d(c2) + dyns[1]) + c0_lidar
        return self._round(output, depth, self.weight_offset3, c0)
