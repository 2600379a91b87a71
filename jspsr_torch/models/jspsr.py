"""JSPSR: multi-branch guided DEM super-resolution network with a joint
spatial-propagation refinement head (counterpart of
``jspsr_tpu/models/jspsr.py``; reference models/JSPSR.py).

Architecture (cat_only fusion, nf=32, nb = number of branches):

- per-branch 5x5 stems (BN only on the image stem) -> nf
- 4 encoder stages of paired BasicBlocks; after every stage the branches are
  fused by channel concat (Guide), and the DEM branch's next stage consumes
  the fused tensor (nf*2^s * nb channels), strides 1,2,2,2
- decoder: 3 x Basic2dTrans with concat skips to the fused encoder
  features, then conv0
- SPN head: detached DEM -> Generator -> (affinity, offsets) ->
  PostProcessor (one modulated deformable conv over the raw DEM, residual)

Branches: lr_dem (required) + optional image + at most one aux of
{mask, canopy, coord}. NCHW; fp32 eval forward.
"""

from __future__ import annotations

import torch
from torch import nn

from jspsr_torch import nn as jnn
from jspsr_torch.models.components import (
    Basic2d,
    Basic2dTrans,
    BasicBlock,
    Downsample,
    Guide,
)
from jspsr_torch.models.spn import Generator, PostProcessor

AUX_KEYS = ("mask", "canopy", "coord")

# JAX-package options whose port has not landed: a config that asks for
# one fails loudly instead of running something else.
NOT_PORTED = ("remat_stages", "fuse_stems", "eval_grouped", "compute_dtype",
              "spn_sample_dtype")


def _make_branch_layer(inplanes, planes, blocks, stride, res_scale, fused_in):
    """One encoder stage for one branch: [block(fused_in -> planes, stride,
    downsample), block(planes -> planes), ...]."""
    need_ds = stride != 1 or inplanes != planes
    ds = Downsample(fused_in, planes, stride) if need_ds else None
    mods = [BasicBlock(fused_in, planes, stride, ds, act=True, scale=res_scale)]
    for _ in range(1, blocks):
        mods.append(BasicBlock(planes, planes, 1, None, act=True,
                               scale=res_scale))
    return nn.Sequential(*mods)


class JSPSR(nn.Module):
    def __init__(
        self,
        in_channels: dict,
        out_channels: int = 1,
        num_feature: int = 32,
        layers: tuple = (2, 2, 2, 2),
        res_scale: tuple = (1, 1, 1, 1),
        spn: bool = True,
        spn_scale: float = 1.0,
        cat_only: bool = True,
        generator_leaky: bool = False,
        generator: torch.Generator | None = None,
        **not_ported,
    ):
        """``generator`` seeds the init (the JAX package's truncated-normal
        fan-in); ``None`` draws from a generator seeded with 0."""
        super().__init__()
        for name, value in not_ported.items():
            if name not in NOT_PORTED:
                raise TypeError(f"JSPSR got an unexpected argument {name!r}")
            if value:
                raise NotImplementedError(f"JSPSR {name} is not yet ported")
        in_channels = dict(in_channels)
        if len(in_channels) < 2 or "lr_dem" not in in_channels:
            raise ValueError("JSPSR needs lr_dem and at least one guidance "
                             f"modality, got {sorted(in_channels)}")
        self.spn = spn
        self.cat_only = cat_only
        self.has_img = "image" in in_channels
        aux = [k for k in AUX_KEYS if k in in_channels]
        if len(aux) > 1:
            raise ValueError(f"at most one aux branch, got {aux}")
        self.aux_key = aux[0] if aux else None
        nb = 1 + int(self.has_img) + int(self.aux_key is not None)
        self.num_branch = nb

        nf = num_feature
        self.conv_dem = Basic2d(in_channels["lr_dem"], nf, 5, 2, bn=False)
        self.conv_img = (Basic2d(in_channels["image"], nf, 5, 2, bn=True)
                         if self.has_img else None)
        self.conv_aux = (Basic2d(in_channels[self.aux_key], nf, 5, 2, bn=False)
                         if self.aux_key else None)

        stage_in = [nf, nf * 2, nf * 4, nf * 8]
        stage_out = [nf * 2, nf * 4, nf * 8, nf * 16]
        stage_stride = [1, 2, 2, 2]
        stage_nb = [1, nb, nb, nb]  # fused-width multiplier of the dem input
        for s in range(4):
            fused_in = stage_in[s] * (stage_nb[s] if cat_only else 1)
            setattr(self, f"layer{s + 1}_dem", _make_branch_layer(
                stage_in[s], stage_out[s], layers[s], stage_stride[s],
                res_scale[s], fused_in))
            for branch, present in (("img", self.has_img),
                                    ("aux", self.aux_key)):
                if present:
                    setattr(self, f"layer{s + 1}_{branch}", _make_branch_layer(
                        stage_in[s], stage_out[s], layers[s], stage_stride[s],
                        res_scale[s], stage_in[s]))
            setattr(self, f"guide{s + 1}",
                    Guide(stage_out[s] * nb, stage_out[s], cat_only=cat_only))

        c4_ch = nf * 16 * nb if cat_only else nf * 16
        self.layer3d = Basic2dTrans(c4_ch, nf * 8, camb=cat_only)
        c3_ch = nf * 8 + nf * 8 * nb if cat_only else nf * 8
        self.layer2d = Basic2dTrans(c3_ch, nf * 4, camb=cat_only)
        c2_ch = nf * 4 + nf * 4 * nb if cat_only else nf * 4
        self.layer1d = Basic2dTrans(c2_ch, nf * 2, camb=cat_only)
        c1_ch = nf * 2 + nf * 2 * nb if cat_only else nf * 2
        c0_ch = nf * 2 if cat_only else nf
        self.conv0 = Basic2d(c1_ch, c0_ch, 3, 1, bn=True, relu=True,
                             camb=cat_only)

        bc = nf if cat_only else nf // 2
        if spn:
            self.generator = Generator(c0_ch, 3, bc=bc, leaky=generator_leaky)
            self.postprocessor = PostProcessor(3, residual=True,
                                               scale=spn_scale)
        else:
            self.generator = None
            self.postprocessor = Basic2d(c0_ch, out_channels, 3, 1, bn=False,
                                         relu=False)
        jnn.init_weights(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))

    def input_keys(self):
        """Canonical input order: dem, then image, then the aux modality."""
        keys = ["lr_dem"]
        if self.has_img:
            keys.append("image")
        if self.aux_key:
            keys.append(self.aux_key)
        return keys

    def _merge(self, up, skip):
        return torch.cat([up, skip], dim=1) if self.cat_only else up + skip

    def forward(self, inputs, generator=None):
        """inputs: list of NCHW tensors in input_keys() order -> (B,1,H,W).
        ``generator`` is accepted as every model's forward accepts it; JSPSR
        draws nothing."""
        keys = self.input_keys()
        if len(inputs) != len(keys):
            raise ValueError(f"expected inputs {keys}, got {len(inputs)}")
        dem = inputs[0]
        feats = {"dem": self.conv_dem(dem)}
        if self.has_img:
            feats["img"] = self.conv_img(inputs[1])
        if self.aux_key:
            feats["aux"] = self.conv_aux(inputs[-1])

        fused = {}
        dem_in = feats["dem"]
        for s in range(1, 5):
            out = {b: getattr(self, f"layer{s}_{b}")(dem_in if b == "dem" else x)
                   for b, x in feats.items()}
            fused[s] = getattr(self, f"guide{s}")(list(out.values()))
            feats = out
            dem_in = fused[s]
        del feats, dem_in

        c = self._merge(self.layer3d(fused[4]), fused[3])
        c = self._merge(self.layer2d(c), fused[2])
        c = self._merge(self.layer1d(c), fused[1])
        del fused
        c0 = self.conv0(c)
        del c

        if self.spn:
            # The refinement head treats the raw DEM as data, not as a
            # learnable path (reference JSPSR.py:372).
            dem_sg = dem.detach()
            weight, offset = self.generator(dem_sg, c0)
            del c0
            return self.postprocessor(dem_sg, weight, offset)
        return self.postprocessor(c0)
