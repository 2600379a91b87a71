"""CompletionFormer in plain PyTorch (Zhang et al., CVPR 2023, as the
JSPSR repository ships it for DEMs and ``jspsr_torch/models/
completionformer.py`` reproduces it): a convolutional stem over the DEM
and the stacked guidance, a PVT backbone (ResNet-style embedding layers,
four stages of spatial-reduction attention blocks each fused with a
parallel CBAM conv branch), a decoder of transposed convs with CBAM blocks
and skips, heads for an initial depth, a guidance map and a confidence,
then NLSPN: ``prop_time`` modulated deformable 3 x 3 convs of the depth
with offsets and TGASS-normalised affinities from the guidance, each
non-centre affinity weighted by the confidence sampled at its offset.

The state_dict keys are the port's. Drop path draws one keep mask (B, 1,
1) per block in training, from the generator handed to ``forward``, in
block order, for every block whose rate (``linspace(0, 0.1, 16)``) is
above 0; the same mask scales both residual branches. The stored
position grids (224-based) are resized bilinearly to the runtime grid;
stage 4's drops its first token."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.deform import bilinear, deform_conv2d
from benchmark.reference.jspsr import BasicBlock, ChannelAttention, \
    SpatialAttention, downsample

GUIDANCE_KEYS = ("image", "mask", "canopy", "coord")


def cbr(cin, cout, k, stride=1, padding=0, bn=True, relu=True):
    mods = [nn.Conv2d(cin, cout, k, stride, padding, bias=not bn)]
    mods += [nn.BatchNorm2d(cout)] if bn else []
    mods += [nn.ReLU()] if relu else []
    return nn.Sequential(*mods)


def ctbr(cin, cout):
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 3, 2, 1, 1,
                                            bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


class CBAMBasicBlock(nn.Module):
    def __init__(self, planes, ratio=16):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.ca = ChannelAttention(planes, ratio)
        self.sa = SpatialAttention()
        self.downsample = None

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        out = self.ca(out) * out
        out = self.sa(out) * out
        return F.relu(out + x)


def to_map(t, h, w):
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def to_tokens(x):
    return x.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim, heads, sr):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        self.scale = (dim // heads) ** -0.5
        self.q = nn.Linear(dim, dim, bias=True)
        self.kv = nn.Linear(dim, 2 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr, sr)
            self.norm = nn.LayerNorm(dim)

    def forward(self, x, h, w):
        b, n, c = x.shape
        nh = self.heads
        q = self.q(x).reshape(b, n, nh, c // nh).transpose(1, 2)
        kv_in = self.norm(to_tokens(self.sr(to_map(x, h, w)))) \
            if self.sr_ratio > 1 else x
        m = kv_in.shape[1]
        k, v = self.kv(kv_in).reshape(b, m, 2, nh, c // nh).permute(
            2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * self.scale, -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, drop, sr):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, sr)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.resblock = CBAMBasicBlock(dim, 16)
        self.concat_conv = nn.Conv2d(2 * dim, dim, 3, 1, 1, bias=False)
        self.drop_path = drop

    def forward(self, x, h, w, keep):
        inp = x
        s = 1.0 if keep is None else keep / (1.0 - self.drop_path)
        x = x + self.attn(self.norm1(x), h, w) * s
        x = x + self.mlp(self.norm2(x)) * s
        fused = self.concat_conv(torch.cat(
            [to_map(x, h, w), self.resblock(to_map(inp, h, w))], 1))
        return to_tokens(fused)


class PatchEmbed(nn.Module):
    def __init__(self, img, patch, cin, dim):
        super().__init__()
        self.grid = (img // patch, img // patch)
        self.num_patches = self.grid[0] * self.grid[1]
        self.proj = nn.Conv2d(cin, dim, patch, patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        y = self.proj(x)
        return self.norm(to_tokens(y)), y.shape[-2:]


class PVT(nn.Module):
    def __init__(self, dims=(64, 128, 320, 512), heads=(1, 2, 5, 8),
                 mlp=(8, 8, 4, 4), depths=(3, 4, 6, 3), srs=(8, 4, 2, 1)):
        super().__init__()
        self.embed_layer1 = nn.Sequential(*[BasicBlock(64, 64)
                                            for _ in range(3)])
        self.embed_layer2 = nn.Sequential(
            BasicBlock(64, 128, 2, downsample(64, 128, 2)),
            *[BasicBlock(128, 128) for _ in range(3)])
        dpr = torch.linspace(0, 0.1, sum(depths), device="cpu").tolist()
        cur = 0
        for i in range(4):
            pe = PatchEmbed(224 if i == 0 else 224 // 2 ** (i + 1),
                            2, 128 if i == 0 else dims[i - 1], dims[i])
            setattr(self, f"patch_embed{i + 1}", pe)
            setattr(self, f"pos_embed{i + 1}", nn.Parameter(torch.zeros(
                1, pe.num_patches + (1 if i == 3 else 0), dims[i])))
            setattr(self, f"block{i + 1}", nn.Sequential(*[
                Block(dims[i], heads[i], mlp[i], dpr[cur + j], srs[i])
                for j in range(depths[i])]))
            cur += depths[i]

    def forward(self, x, generator=None):
        outs = [self.embed_layer1(x)]
        outs.append(self.embed_layer2(outs[0]))
        y, b = outs[1], x.shape[0]
        for i in range(4):
            pe = getattr(self, f"patch_embed{i + 1}")
            tokens, (h, w) = pe(y)
            pos = getattr(self, f"pos_embed{i + 1}")
            pos = pos[:, 1:] if i == 3 else pos
            if h * w != self.patch_embed1.num_patches:
                pos = to_tokens(F.interpolate(to_map(pos, *pe.grid), (h, w),
                                              mode="bilinear"))
            tokens = tokens + pos
            for blk in getattr(self, f"block{i + 1}"):
                keep = None
                if (self.training and blk.drop_path > 0
                        and generator is not None):
                    keep = torch.empty(b, 1, 1, device=generator.device)
                    keep.bernoulli_(1.0 - blk.drop_path, generator=generator)
                tokens = blk(tokens, h, w, keep)
            y = to_map(tokens, h, w)
            outs.append(y)
        return outs


class Backbone(nn.Module):
    def __init__(self, ic, num_neighbors=8):
        super().__init__()
        self.conv1_rgb = cbr(ic, ic * 16, 3, 1, 1, bn=False)
        self.conv1_dep = cbr(1, 16, 3, 1, 1, bn=False)
        self.conv1 = cbr((ic + 1) * 16, 64, 3, 1, 1, bn=False)
        self.former = PVT()
        self.dec6 = nn.Sequential(ctbr(512, 256), CBAMBasicBlock(256, 16))
        self.dec5 = nn.Sequential(ctbr(256 + 320, 128), CBAMBasicBlock(128, 8))
        self.dec4 = nn.Sequential(ctbr(128 + 128, 64), CBAMBasicBlock(64, 4))
        self.dec3 = nn.Sequential(ctbr(64 + 64, 64), CBAMBasicBlock(64, 4))
        self.dec2 = nn.Sequential(ctbr(64 + 128, 64), CBAMBasicBlock(64, 4))
        self.dep_dec1 = cbr(128, 64, 3, 1, 1)
        self.dep_dec0 = cbr(128, 1, 3, 1, 1, bn=False, relu=True)
        self.gd_dec1 = cbr(128, 64, 3, 1, 1)
        self.gd_dec0 = cbr(128, num_neighbors, 3, 1, 1, bn=False, relu=False)
        self.cf_dec1 = cbr(128, 32, 3, 1, 1)
        self.cf_dec0 = nn.Sequential(nn.Conv2d(96, 1, 3, padding=1),
                                     nn.Sigmoid())

    def forward(self, rgb, dep, generator=None):
        fe1 = self.conv1(torch.cat([self.conv1_rgb(rgb),
                                    self.conv1_dep(dep)], 1))
        fe2, fe3, fe4, fe5, fe6, fe7 = self.former(fe1, generator)
        fd6 = self.dec6(fe7)
        fd5 = self.dec5(torch.cat([fd6, fe6], 1))
        fd4 = self.dec4(torch.cat([fd5, fe5], 1))
        fd3 = self.dec3(torch.cat([fd4, fe4], 1))
        fd2 = self.dec2(torch.cat([fd3, fe3], 1))
        skip = torch.cat([fd2, fe2], 1)
        init = self.dep_dec0(torch.cat([self.dep_dec1(skip), fe1], 1))
        guide = self.gd_dec0(torch.cat([self.gd_dec1(skip), fe1], 1))
        conf = self.cf_dec0(torch.cat([self.cf_dec1(skip), fe1], 1))
        return init, guide, conf


class NLSPN(nn.Module):
    def __init__(self, prop_time=6, gamma=0.5):
        super().__init__()
        self.prop_time = prop_time
        self.conv_offset_aff = nn.Conv2d(8, 24, 3, padding=1)
        self.aff_scale_const = nn.Parameter(torch.full((1,), gamma * 8))
        self.w = nn.Parameter(torch.ones(1, 1, 3, 3), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(1), requires_grad=False)
        self.w_conf = nn.Parameter(torch.ones(1, 1, 1, 1),
                                   requires_grad=False)

    def forward(self, feat, guidance, confidence):
        b, _, h, w = guidance.shape
        oa = self.conv_offset_aff(guidance)
        off = oa[:, :16].reshape(b, 8, 2, h, w)
        aff = torch.tanh(oa[:, 16:] / 100.0) / (self.aff_scale_const + 1e-8)
        pairs = torch.cat([off[:, :4], off.new_zeros(b, 1, 2, h, w),
                           off[:, 4:]], 1)
        offset = pairs.reshape(b, 18, h, w)
        taps = torch.cat([pairs[:, :4], pairs[:, 5:]], 1).detach()
        yy = torch.arange(h, device=feat.device, dtype=feat.dtype)
        xx = torch.arange(w, device=feat.device, dtype=feat.dtype)
        conf = bilinear(confidence, yy[:, None] + taps[:, :, 0],
                        xx[None, :] + taps[:, :, 1])
        aff = aff * (conf * self.w_conf.detach().reshape(()) + self.b.detach())
        aff = aff / torch.clamp(aff.abs().sum(1, keepdim=True) + 1e-4, min=1.0)
        aff = torch.cat([aff[:, :4], 1.0 - aff.sum(1, keepdim=True),
                         aff[:, 4:]], 1)
        for _ in range(self.prop_time):
            feat = deform_conv2d(feat, offset, self.w.detach(),
                                 self.b.detach(), aff)
        return feat


class CompletionFormer(nn.Module):
    def __init__(self, guidance_channels, prop_time=6, gamma=0.5):
        super().__init__()
        self.backbone = Backbone(guidance_channels)
        self.prop_layer = NLSPN(prop_time, gamma)

    def forward(self, inputs, generator=None):
        dep, rgb = inputs
        init, guide, conf = self.backbone(rgb, dep, generator)
        return self.prop_layer(init + dep, guide, conf)


def build(program: dict) -> CompletionFormer:
    """The shipped case only: prop_kernel 3, conf_prop, TGASS."""
    mk = program.get("model_kwargs") or {}
    if (mk.get("prop_kernel", 3) != 3 or not mk.get("conf_prop", True)
            or mk.get("affinity", "TGASS") != "TGASS"):
        raise NotImplementedError("reference CompletionFormer: prop_kernel "
                                  "3, conf_prop and TGASS only")
    data = program.get("input_data") or {}
    ic = sum(v for k, v in data.items() if k in GUIDANCE_KEYS and v)
    with torch.device("meta"):
        return CompletionFormer(ic, mk.get("prop_time", 6),
                                mk.get("affinity_gamma", 0.5))
