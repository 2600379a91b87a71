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
{mask, canopy, coord}. NCHW.

``compute_dtype="bfloat16"`` is the JAX package's mixed-precision body:
the parameters stay fp32 and the stems take their inputs cast to bf16, so
the encoder, decoder, ``conv0`` and the SPN Generator run in bf16 (convs
cast their parameters at use, BatchNorm takes fp32 statistics,
``jspsr_torch.nn``); the Generator gets the detached DEM cast to bf16, and
its affinity and offsets are cast back to fp32 for the PostProcessor,
which samples the DEM the caller passed, in fp32, and adds the residual
in fp32. The casts are explicit, where the JAX package puts them
(``jspsr_tpu/models/jspsr.py:376,425,433,437``), not ``torch.autocast``,
whose per-op lists would also reach the head. ``spn_sample_dtype=
"bfloat16"`` runs the PostProcessor's deformable conv in its
bf16-sampling mode.

The JAX package's three execution options, each the same function:

- ``fuse_stems``: the per-branch 5x5 stems as one block-diagonal conv,
  its weight assembled at each forward from the per-branch parameters
  (their gradients flow back through the assembly), the image stem's
  BatchNorm and each stem's ReLU on its slice of the output; not under
  ``remat_stages`` in training, where each stem is checkpointed alone.
- ``eval_grouped``: in eval, the same-shape branch BasicBlocks of an
  encoder stage as one grouped conv (``groups`` = the blocks), their
  BatchNorms as one with the branches' statistics concatenated; a block
  whose input width, stride or downsample differs (the DEM branch's, fed
  the fused tensor at stages 2-4) runs alone. Training takes the separate
  path.
- ``remat_stages``: in training, the stems, encoder stages, decoder
  layers and ``conv0`` each recompute their activations in the backward
  (``nn.remat.checkpoint``), as the JAX package's ``run`` wraps each
  module whose name starts with ``layer``, ``conv`` or ``generator``; the
  Generator and the PostProcessor are called outside ``run`` there, and
  here, so they keep theirs.

Every parameter keeps its key: a checkpoint loads with or without them.

Under a spatial sharding (``parallel/spatial.py``) the forward runs
unchanged on a row slab, in either dtype and sampling mode and with each
option: the fused stems' and grouped blocks' convs take their halo rows
through ``spatial.conv2d`` (``_conv``), and ``remat_stages`` replays a
stage's collectives in one order on every rank. H must divide by
``ROW_MULTIPLE`` (three stride-2 stages) times the space axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jspsr_torch import nn as jnn
from jspsr_torch.nn.layers import batch_norm_apply
from jspsr_torch.nn.remat import checkpoint
from jspsr_torch.models.components import (
    Basic2d,
    Basic2dTrans,
    BasicBlock,
    Downsample,
    Guide,
)
from jspsr_torch.models.spn import Generator, PostProcessor
from jspsr_torch.parallel import spatial
from jspsr_torch.parallel.mesh import active_sharding

AUX_KEYS = ("mask", "canopy", "coord")
# module names that ``remat_stages`` recomputes (the JAX package's ``run``)
REMAT_PREFIXES = ("layer", "conv", "generator")
COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def _conv(x, like, weight, groups: int = 1):
    """``F.conv2d`` of ``x`` with an assembled ``weight`` (no bias) at
    ``like``'s (an ``nn.Conv2d``) stride, padding and dilation, in
    ``groups`` groups; on a row slab under a spatial sharding, with its
    halo rows."""
    if active_sharding() is not None:
        return spatial.conv2d(like, x, weight, None, groups=groups)
    return F.conv2d(x, weight, None, like.stride, like.padding,
                    like.dilation, groups)


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
    # an image's rows divide into equal slabs at every level of the
    # encoder's three stride-2 stages (``parallel.spatial.check_rows``)
    ROW_MULTIPLE = 8

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
        remat_stages: bool = False,
        fuse_stems: bool = False,
        eval_grouped: bool = False,
        compute_dtype: str | None = None,
        spn_sample_dtype: str | None = None,
        generator: torch.Generator | None = None,
    ):
        """``generator`` seeds the init (the JAX package's truncated-normal
        fan-in); ``None`` draws from a generator seeded with 0.
        ``compute_dtype`` (None, "float32" or "bfloat16") is the body's
        dtype, ``spn_sample_dtype`` the SPN head's sampling mode;
        ``remat_stages``, ``fuse_stems`` and ``eval_grouped``: see the
        module's docstring."""
        super().__init__()
        self.remat_stages = bool(remat_stages)
        self.fuse_stems = bool(fuse_stems)
        self.eval_grouped = bool(eval_grouped)
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"JSPSR compute_dtype must be one of "
                             f"{list(COMPUTE_DTYPES)}, got {compute_dtype!r}")
        # None: the body runs in its inputs' dtype (fp32, or float64)
        self.compute_dtype = COMPUTE_DTYPES[compute_dtype]
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
                                               scale=spn_scale,
                                               sample_dtype=spn_sample_dtype)
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

    def _run(self, name, *args):
        """Submodule ``name`` on ``args``, recomputed in the backward under
        ``remat_stages`` in training."""
        mod = getattr(self, name)
        if (self.remat_stages and self.training
                and name.startswith(REMAT_PREFIXES)):
            return checkpoint(mod, *args)
        return mod(*args)

    def _fused_stems(self, stems):
        """All stems as one block-diagonal 5x5 conv: ``stems`` is a list of
        (module name, branch, input); returns {branch: features}."""
        xs = torch.cat([x for _, _, x in stems], dim=1)
        nf = self.conv_dem.conv[0].out_channels
        w = xs.new_zeros((nf * len(stems), xs.shape[1], 5, 5))
        b = xs.new_zeros((nf * len(stems),))
        ci = 0
        for i, (name, _, x) in enumerate(stems):
            conv = getattr(self, name).conv[0]
            w[i * nf:(i + 1) * nf, ci:ci + x.shape[1]] = \
                conv.weight.to(xs.dtype)
            if conv.bias is not None:
                b[i * nf:(i + 1) * nf] = conv.bias.to(xs.dtype)
            ci += x.shape[1]
        y = _conv(xs, self.conv_dem.conv[0], w) + b.view(1, -1, 1, 1)
        feats = {}
        for i, (name, key, _) in enumerate(stems):
            sl = y[:, i * nf:(i + 1) * nf]
            bn = getattr(getattr(self, name).conv, "bn", None)
            feats[key] = F.relu(sl if bn is None else bn(sl))
        return feats

    @staticmethod
    def _grouped_block(blocks, xs):
        """Same-shape BasicBlocks on their inputs ``xs`` as one block of
        grouped convs (eval): group g sees branch g's channels with
        branch g's kernel, and eval BatchNorm is per channel, so the
        concatenated statistics normalise each branch as its own do."""
        nb, blk = len(blocks), blocks[0]
        x = torch.cat(xs, dim=1)

        def gconv(convs, xx):
            w = torch.cat([c.weight for c in convs]).to(xx.dtype)
            return _conv(xx, convs[0], w, groups=nb)

        def gbn(bns, xx):
            return batch_norm_apply(
                xx, *(torch.cat([getattr(m, k) for m in bns])
                      for k in ("running_mean", "running_var", "weight",
                                "bias")), bns[0].eps)

        out = F.relu(gbn([m.bn1 for m in blocks],
                         gconv([m.conv1 for m in blocks], x)))
        out = gbn([m.bn2 for m in blocks],
                  gconv([m.conv2 for m in blocks], out))
        if blk.downsample is not None:
            res = gbn([m.downsample[1] for m in blocks],
                      gconv([m.downsample[0] for m in blocks], x))
        else:
            res = x
        out = out * blk.scale + res
        if blk.act:
            out = F.relu(out)
        return list(out.chunk(nb, dim=1))

    def _grouped_stage(self, stage, feats):
        """Encoder stage ``stage`` with the same-signature branch blocks
        grouped (``eval_grouped``); ``feats`` {branch: input}."""
        names = list(feats)
        seqs = {b: getattr(self, f"layer{stage}_{b}") for b in names}
        acts = dict(feats)
        for bi in range(len(seqs[names[0]])):
            blocks = {b: seqs[b][bi] for b in names}
            sig = {b: (m.conv1.in_channels, m.conv1.stride,
                       m.downsample is not None) for b, m in blocks.items()}
            done = set()
            for b in names:
                if b in done:
                    continue
                grp = [g for g in names if g not in done and sig[g] == sig[b]]
                done.update(grp)
                if len(grp) == 1:
                    acts[b] = blocks[b](acts[b])
                    continue
                outs = self._grouped_block([blocks[g] for g in grp],
                                           [acts[g] for g in grp])
                acts.update(zip(grp, outs))
        return acts

    def forward(self, inputs, generator=None):
        """inputs: list of NCHW tensors in input_keys() order -> (B,1,H,W).
        ``generator`` is accepted as every model's forward accepts it; JSPSR
        draws nothing."""
        keys = self.input_keys()
        if len(inputs) != len(keys):
            raise ValueError(f"expected inputs {keys}, got {len(inputs)}")
        dem = inputs[0]
        cdt = self.compute_dtype

        def body(x):
            return x if cdt is None else x.to(cdt)

        stems = [("conv_dem", "dem", body(dem))]
        if self.has_img:
            stems.append(("conv_img", "img", body(inputs[1])))
        if self.aux_key:
            stems.append(("conv_aux", "aux", body(inputs[-1])))
        if self.fuse_stems and not (self.remat_stages and self.training):
            feats = self._fused_stems(stems)
        else:
            feats = {key: self._run(name, x) for name, key, x in stems}
        del stems

        grouped = (self.eval_grouped and not self.training and self.cat_only
                   and self.num_branch >= 2)
        fused = {}
        dem_in = feats["dem"]
        for s in range(1, 5):
            if grouped:
                out = self._grouped_stage(s, {**feats, "dem": dem_in})
            else:
                out = {b: self._run(f"layer{s}_{b}",
                                    dem_in if b == "dem" else x)
                       for b, x in feats.items()}
            fused[s] = getattr(self, f"guide{s}")(list(out.values()))
            feats = out
            dem_in = fused[s]
        del feats, dem_in

        c = self._merge(self._run("layer3d", fused[4]), fused[3])
        c = self._merge(self._run("layer2d", c), fused[2])
        c = self._merge(self._run("layer1d", c), fused[1])
        del fused
        c0 = self._run("conv0", c)
        del c

        if self.spn:
            # The refinement head treats the raw DEM as data, not as a
            # learnable path (reference JSPSR.py:372).
            dem_sg = dem.detach()
            weight, offset = self.generator(body(dem_sg), c0)
            del c0
            # the sampling of the raw DEM is precision-critical: the
            # affinity and offsets re-enter the DEM's dtype, the DEM itself
            # never left it
            return self.postprocessor(dem_sg, weight.to(dem.dtype),
                                      offset.to(dem.dtype))
        return self.postprocessor(c0).to(dem.dtype)
