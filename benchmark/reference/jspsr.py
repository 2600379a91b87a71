"""JSPSR in plain PyTorch (the flagship of xandercai/JSPSR,
``models/JSPSR.py``, as ``jspsr_torch/models/jspsr.py`` reproduces it):
per-branch 5x5 stems, four encoder stages of ResNet blocks whose branches
are fused by channel concat after each stage, a decoder of transposed
convs with channel attention and concat skips, and the SPN head (an
affinity and offset generator, then one modulated deformable conv over the
detached raw DEM, residual). The state_dict keys are the port's.

Only what the shipped config runs: ``cat_only``, ``spn``, ``res_scale`` 1,
fp32. No remat, fused stems, grouped eval, bf16 or sharding."""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.deform import deform_conv2d, \
    insert_zero_center_offset

AUX_KEYS = ("mask", "canopy", "coord")


class ChannelAttention(nn.Module):
    def __init__(self, planes: int, ratio: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Conv2d(planes, planes // ratio, 1,
                                          bias=False), nn.ReLU(),
                                nn.Conv2d(planes // ratio, planes, 1,
                                          bias=False))

    def forward(self, x):
        return torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True))
                             + self.fc(x.amax((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                               bias=False)

    def forward(self, x):
        return torch.sigmoid(self.conv1(torch.cat(
            [x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)))


class Basic2d(nn.Module):
    """conv [+ BN] [+ ReLU / LeakyReLU(0.2)], with an optional channel
    attention multiplied into the input; a bias only without BN."""

    def __init__(self, cin, cout, k=3, padding=1, bn=True, relu=True,
                 camb=False, leaky=False):
        super().__init__()
        self.camb = ChannelAttention(cin) if camb else None
        layers = OrderedDict([("0", nn.Conv2d(cin, cout, k, padding=padding,
                                              bias=not bn))])
        if bn:
            layers["bn"] = nn.BatchNorm2d(cout)
        self.conv = nn.Sequential(layers)
        self.relu, self.leaky = relu, leaky

    def forward(self, x):
        if self.camb is not None:
            x = self.camb(x) * x
        x = self.conv(x)
        if self.relu:
            x = F.leaky_relu(x, 0.2) if self.leaky else F.relu(x)
        return x


class Basic2dTrans(nn.Module):
    """Basic2d, then a 3x3 stride-2 transposed conv, BN, ReLU: 2x up."""

    def __init__(self, cin, cout, camb=False):
        super().__init__()
        self.dconv = nn.Sequential(OrderedDict([
            ("0", Basic2d(cin, cout, 3, 1, bn=True, camb=camb)),
            ("1", nn.ConvTranspose2d(cout, cout, 3, stride=2, padding=1,
                                     output_padding=1, bias=False)),
            ("bn", nn.BatchNorm2d(cout))]))

    def forward(self, x):
        return F.relu(self.dconv(x))


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, downsample=None, act=True):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample
        self.act = act

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        out = out + (x if self.downsample is None else self.downsample(x))
        return F.relu(out) if self.act else out


def downsample(cin, cout, stride):
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


class Guide(nn.Module):
    """Branch fusion by channel concat (``cat_only``): no parameters."""

    def forward(self, feats):
        return torch.cat(list(feats), 1)


def branch_layer(inplanes, planes, blocks, stride, fused_in):
    ds = (downsample(fused_in, planes, stride)
          if stride != 1 or inplanes != planes else None)
    mods = [BasicBlock(fused_in, planes, stride, ds)]
    mods += [BasicBlock(planes, planes) for _ in range(1, blocks)]
    return nn.Sequential(*mods)


class Generator(nn.Module):
    """Affinity and offset generator of the SPN head."""

    def __init__(self, cin, bc=16, leaky=False):
        super().__init__()
        self.convd1 = Basic2d(1, bc * 2, 3, 1, bn=False, leaky=leaky)
        self.convd2 = Basic2d(bc * 2, bc * 2, 3, 1, bn=False, leaky=leaky)
        self.convf1 = Basic2d(cin, bc * 2, 3, 1, bn=False, leaky=leaky)
        self.convf2 = Basic2d(bc * 2, bc * 2, 3, 1, bn=False, leaky=leaky)
        self.conv = Basic2d(bc * 4, bc * 4, 3, 1, bn=False, leaky=leaky)
        self.block = BasicBlock(bc * 4, bc * 4)
        self.conv_weight = nn.Sequential(nn.Conv2d(bc * 4, 9, 1))
        self.conv_offset = Basic2d(bc * 4, 16, 1, 0, bn=False, relu=False)

    def forward(self, dem, context):
        d = self.convd2(self.convd1(dem))
        f = self.convf2(self.convf1(context))
        feat = self.block(self.conv(torch.cat([d, f], 1)))
        weight = torch.sigmoid(self.conv_weight(feat))
        offset = insert_zero_center_offset(self.conv_offset(feat))
        return weight, offset


class PostProcessor(nn.Module):
    """One modulated deformable conv over the raw DEM with a zero-sum
    affinity, plus the DEM (residual)."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.w = nn.Parameter(torch.ones(1, 1, 3, 3))
        self.b = nn.Parameter(torch.zeros(1))

    def forward(self, dem, weight, offset):
        weight = weight - weight.mean(1, keepdim=True)
        return deform_conv2d(dem, offset, self.w, self.b, weight) \
            + self.scale * dem


class JSPSR(nn.Module):
    def __init__(self, in_channels: dict, num_feature=32, num_block=2,
                 spn_scale=1.0, generator_leaky=False):
        super().__init__()
        self.has_img = "image" in in_channels
        aux = [k for k in AUX_KEYS if k in in_channels]
        self.aux_key = aux[0] if aux else None
        nb = 1 + int(self.has_img) + int(self.aux_key is not None)
        nf = num_feature
        self.conv_dem = Basic2d(in_channels["lr_dem"], nf, 5, 2, bn=False)
        self.conv_img = (Basic2d(in_channels["image"], nf, 5, 2, bn=True)
                         if self.has_img else None)
        self.conv_aux = (Basic2d(in_channels[self.aux_key], nf, 5, 2,
                                 bn=False) if self.aux_key else None)
        s_in, s_out = [nf, nf * 2, nf * 4, nf * 8], [nf * 2, nf * 4, nf * 8,
                                                    nf * 16]
        stride, mult = [1, 2, 2, 2], [1, nb, nb, nb]
        for s in range(4):
            setattr(self, f"layer{s + 1}_dem", branch_layer(
                s_in[s], s_out[s], num_block, stride[s], s_in[s] * mult[s]))
            for branch, present in (("img", self.has_img),
                                    ("aux", self.aux_key)):
                if present:
                    setattr(self, f"layer{s + 1}_{branch}", branch_layer(
                        s_in[s], s_out[s], num_block, stride[s], s_in[s]))
            setattr(self, f"guide{s + 1}", Guide())
        self.layer3d = Basic2dTrans(nf * 16 * nb, nf * 8, camb=True)
        self.layer2d = Basic2dTrans(nf * 8 + nf * 8 * nb, nf * 4, camb=True)
        self.layer1d = Basic2dTrans(nf * 4 + nf * 4 * nb, nf * 2, camb=True)
        self.conv0 = Basic2d(nf * 2 + nf * 2 * nb, nf * 2, 3, 1, bn=True,
                             camb=True)
        self.generator = Generator(nf * 2, bc=nf, leaky=generator_leaky)
        self.postprocessor = PostProcessor(spn_scale)

    def forward(self, inputs, generator=None):
        dem = inputs[0]
        feats = {"dem": self.conv_dem(dem)}
        if self.has_img:
            feats["img"] = self.conv_img(inputs[1])
        if self.aux_key:
            feats["aux"] = self.conv_aux(inputs[-1])
        fused, dem_in = {}, feats["dem"]
        for s in range(1, 5):
            out = {b: getattr(self, f"layer{s}_{b}")(
                dem_in if b == "dem" else x) for b, x in feats.items()}
            fused[s] = getattr(self, f"guide{s}")(out.values())
            feats, dem_in = out, fused[s]
        c = torch.cat([self.layer3d(fused[4]), fused[3]], 1)
        c = torch.cat([self.layer2d(c), fused[2]], 1)
        c = torch.cat([self.layer1d(c), fused[1]], 1)
        c0 = self.conv0(c)
        dem_sg = dem.detach()
        weight, offset = self.generator(dem_sg, c0)
        return self.postprocessor(dem_sg, weight, offset)


def build(program: dict) -> JSPSR:
    """The model of a port config (its ``input_data`` and
    ``model_kwargs``), on the meta device: load weights with
    ``load_state_dict(..., assign=True)``."""
    mk = program.get("model_kwargs") or {}
    chans = {"lr_dem": 1}
    chans.update({k: v for k, v in (program.get("input_data") or {}).items()
                  if k in ("image",) + AUX_KEYS and v})
    with torch.device("meta"):
        return JSPSR(chans, num_feature=mk.get("num_feature", 32),
                     num_block=mk.get("num_block", 2),
                     spn_scale=mk.get("spn_scale", 1.0),
                     generator_leaky=mk.get("generator_leaky", False))
