"""Shared model building blocks (counterpart of
``jspsr_tpu/models/components.py``; reference models/components/basics.py,
models/components/resnet_cbam.py:36-53).

NCHW ``nn.Module``s whose parameter names follow the reference torch
state_dict layout (the layout ``jspsr_tpu/utils/torch_import.py`` reads):
``Basic2d`` -> ``conv.0`` / ``conv.bn``, ``Basic2dTrans`` -> ``dconv.0`` /
``dconv.1`` / ``dconv.bn``, ``Downsample`` -> ``0`` / ``1``,
``ChannelAttention`` -> ``fc.0`` / ``fc.2``, ``SpatialAttention`` ->
``conv1``, ``CBAMBasicBlock`` -> ``conv1`` / ``bn1`` / ``conv2`` / ``bn2`` /
``ca`` / ``sa`` / ``downsample``.

Their convs and BatchNorms are ``jspsr_torch.nn``'s ``Conv2d``,
``ConvTranspose2d`` and ``BatchNorm2d``: torch's own on fp32 inputs, and
on a bf16 input (JSPSR's ``compute_dtype``) the JAX package's mixed
precision, parameters cast at use; every block then runs in its input's
dtype, the attention's pools and means included.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from jspsr_torch import nn as jnn


def conv1x1(cin, cout, stride=1):
    return jnn.Conv2d(cin, cout, 1, stride=stride, padding=0, bias=False)


def conv3x3(cin, cout, stride=1):
    return jnn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class ChannelAttention(nn.Module):
    """CBAM channel attention: sigmoid(fc(avg_pool) + fc(max_pool)),
    fc = 1x1 conv -> ReLU -> 1x1 conv."""

    def __init__(self, in_planes: int, ratio: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            jnn.Conv2d(in_planes, in_planes // ratio, 1, bias=False),
            nn.ReLU(),
            jnn.Conv2d(in_planes // ratio, in_planes, 1, bias=False),
        )

    def forward(self, x):
        return torch.sigmoid(self.fc(jnn.global_avg_pool(x))
                             + self.fc(jnn.global_max_pool(x)))


class SpatialAttention(nn.Module):
    """CBAM spatial attention: sigmoid(conv7x7([mean_c(x), max_c(x)]))."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv1 = jnn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                               bias=False)

    def forward(self, x):
        y = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv1(y))


class Basic2d(nn.Module):
    """conv [+ BN] [+ ReLU/LeakyReLU(0.2)], optional pre-multiplied channel
    attention. Bias present iff no BN."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: int = 1, bn: bool = True,
                 relu: bool = True, camb: bool = False, leaky: bool = False):
        super().__init__()
        self.camb = ChannelAttention(in_channels, ratio=16) if camb else None
        layers = OrderedDict(
            [("0", jnn.Conv2d(in_channels, out_channels, kernel_size,
                             padding=padding, bias=not bn))])
        if bn:
            layers["bn"] = jnn.BatchNorm2d(out_channels)
        self.conv = nn.Sequential(layers)
        self.relu = relu
        self.leaky = leaky

    def forward(self, x):
        if self.camb is not None:
            x = self.camb(x) * x
        x = self.conv(x)
        if self.relu:
            x = F.leaky_relu(x, 0.2) if self.leaky else F.relu(x)
        return x


class Basic2dTrans(nn.Module):
    """Basic2d -> ConvTranspose2d(k3 s2 p1 op1) -> BN -> ReLU. Upsamples 2x."""

    def __init__(self, in_channels: int, out_channels: int, bn: bool = True,
                 camb: bool = False):
        super().__init__()
        layers = OrderedDict([
            ("0", Basic2d(in_channels, out_channels, 3, 1, bn=bn, camb=camb)),
            ("1", jnn.ConvTranspose2d(out_channels, out_channels, 3, stride=2,
                                     padding=1, output_padding=1,
                                     bias=not bn)),
        ])
        if bn:
            layers["bn"] = jnn.BatchNorm2d(out_channels)
        self.dconv = nn.Sequential(layers)

    def forward(self, x):
        return F.relu(self.dconv(x))


class BasicBlock(nn.Module):
    """ResNet BasicBlock with residual scale."""

    def __init__(self, inplanes, planes, stride=1,
                 downsample: nn.Module | None = None, act: bool = True,
                 scale: float = 1.0):
        super().__init__()
        self.conv1 = conv3x3(inplanes, planes, stride)
        self.bn1 = jnn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = jnn.BatchNorm2d(planes)
        self.downsample = downsample
        self.act = act
        self.scale = scale

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        out = out * self.scale + residual
        return F.relu(out) if self.act else out


class CBAMBasicBlock(nn.Module):
    """ResNet BasicBlock with CBAM channel then spatial attention on the
    residual branch."""

    def __init__(self, inplanes, planes, stride=1,
                 downsample: nn.Module | None = None, ratio: int = 16):
        super().__init__()
        self.conv1 = conv3x3(inplanes, planes, stride)
        self.bn1 = jnn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = jnn.BatchNorm2d(planes)
        self.ca = ChannelAttention(planes, ratio=ratio)
        self.sa = SpatialAttention()
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        out = self.ca(out) * out
        out = self.sa(out) * out
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Downsample(nn.Sequential):
    """conv1x1 + BN shortcut projection: keys ``0`` / ``1``, the JAX
    module's ``conv`` / ``bn`` (``utils/weights.py`` maps them by this
    class)."""

    def __init__(self, cin, cout, stride):
        super().__init__(conv1x1(cin, cout, stride), jnn.BatchNorm2d(cout))


class Guide(nn.Module):
    """Branch fusion: channel concat, followed by a 3x3 Basic2d when
    cat_only=False."""

    def __init__(self, in_channels, out_channels, bn: bool = True,
                 cat_only: bool = True):
        super().__init__()
        self.conv = (None if cat_only
                     else Basic2d(in_channels, out_channels, 3, 1, bn=bn))

    def forward(self, feats):
        out = torch.cat(list(feats), dim=1)
        return out if self.conv is None else self.conv(out)
