"""Joint spatial-propagation refinement head (counterpart of
``jspsr_tpu/models/spn.py``; reference models/components/spn.py).

- ``Generator``: per-pixel 3x3 affinity (sigmoid, 9 channels) and
  deformable offsets for the 8 non-center taps (16 channels; a zero pair
  is inserted at the center tap).
- ``PostProcessor``: zero-sums the affinity (residual mode) and applies one
  modulated deformable conv to the raw DEM with a learnable 3x3 kernel
  (initialized to ones) and bias, adding ``scale * dem`` back; with
  ``sample_dtype="bfloat16"`` the conv's bf16-sampling mode
  (``ops.deform_conv``). On a row slab under a spatial sharding it samples
  the whole raw DEM of its images (gathered over the space group; the
  offsets are unbounded) for its own output rows (the op's ``y0``); where
  the DEM needs its gradient, the gather's backward returns each row's
  gradient (K3 on the slab) to the rank that owns it.

The Generator computes in its inputs' dtype (bf16 under JSPSR's
``compute_dtype``, its two 1x1 heads and the sigmoid included); the
caller casts the affinity and offsets to fp32 for the PostProcessor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jspsr_torch import nn as jnn
from jspsr_torch.models.components import Basic2d, BasicBlock
from jspsr_torch.ops.deform_conv import deform_conv2d, insert_zero_center_offset
from jspsr_torch.parallel import spatial
from jspsr_torch.parallel.mesh import active_sharding


class Generator(nn.Module):
    """Affinity/offset generator (reference spn.py:8-75)."""

    def __init__(self, in_channels: int, kernel_size: int = 3, bc: int = 16,
                 leaky: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        num = kernel_size * kernel_size - 1
        self.convd1 = Basic2d(1, bc * 2, 3, 1, bn=False, relu=True, leaky=leaky)
        self.convd2 = Basic2d(bc * 2, bc * 2, 3, 1, bn=False, relu=True,
                              leaky=leaky)
        self.convf1 = Basic2d(in_channels, bc * 2, 3, 1, bn=False, relu=True,
                              leaky=leaky)
        self.convf2 = Basic2d(bc * 2, bc * 2, 3, 1, bn=False, relu=True,
                              leaky=leaky)
        self.conv = Basic2d(bc * 4, bc * 4, 3, 1, bn=False, relu=True,
                            leaky=leaky)
        self.block = BasicBlock(bc * 4, bc * 4)
        self.conv_weight = nn.Sequential(
            jnn.Conv2d(bc * 4, kernel_size ** 2, 1, padding=0, bias=True))
        self.conv_offset = Basic2d(bc * 4, 2 * num, kernel_size=1, padding=0,
                                   bn=False, relu=False)

    def forward(self, dem, context):
        d = self.convd2(self.convd1(dem))
        f = self.convf2(self.convf1(context))
        feat = self.block(self.conv(torch.cat([d, f], dim=1)))
        # Both 1x1 heads in one conv (exact: the concatenated output
        # channels are independent): the full-resolution feature map is
        # read once instead of twice. The parameters stay the reference's
        # separate conv_weight / conv_offset modules.
        k2 = self.kernel_size ** 2
        head_w, off_conv = self.conv_weight[0], self.conv_offset.conv[0]
        heads = F.conv2d(
            feat, torch.cat([head_w.weight, off_conv.weight]).to(feat.dtype),
            torch.cat([head_w.bias, off_conv.bias]).to(feat.dtype))
        weight = torch.sigmoid(heads[:, :k2])
        offset = insert_zero_center_offset(heads[:, k2:], self.kernel_size)
        return weight, offset


class PostProcessor(nn.Module):
    """Deformable refinement of the raw DEM (reference spn.py:79-118)."""

    def __init__(self, kernel_size: int = 3, residual: bool = True,
                 scale: float = 1.0, sample_dtype: str | None = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.residual = residual
        self.scale = scale
        self.sample_dtype = sample_dtype
        self.w = nn.Parameter(torch.ones(1, 1, kernel_size, kernel_size))
        self.b = nn.Parameter(torch.zeros(1))

    def forward(self, init_dem, weight, offset):
        if self.residual:
            # zero-sum affinity: refinement is a pure neighbour correction
            weight = weight - weight.mean(dim=1, keepdim=True)
        else:
            weight = weight / weight.sum(dim=1, keepdim=True)
        pad = (self.kernel_size - 1) // 2
        x, y0 = init_dem.contiguous(), 0
        if active_sharding() is not None:
            x, y0 = spatial.gather_rows(x), spatial.row_origin(x)
        refined = deform_conv2d(x, offset, self.w, self.b, weight,
                                padding=pad, sample_dtype=self.sample_dtype,
                                y0=y0)
        if self.residual:
            refined = refined + self.scale * init_dem
        return refined
