"""Pyramid Vision Transformer variant of CompletionFormer's backbone
(counterpart of ``jspsr_tpu/models/pvt.py``; reference
models/components/pvt.py).

PVT stages with spatial-reduction attention, each block fusing a parallel
CBAM conv branch by concat-conv; ResNet34 layer1/layer2 as the
convolutional embedding. Tokens are (B, N, C) with N the row-major
(h, w) grid; feature maps are NCHW.

Kept from the JAX package:

- position embeddings are stored at the 224-based grid and resized
  bilinearly (no antialias) to the runtime grid, comparing every stage's
  token count against STAGE 1's patch count; stage 4's drops its first
  token;
- drop path draws one keep mask of shape (B, 1, 1) per block in training
  and applies the same mask to both residual branches, at the rates
  ``linspace(0, 0.1, 16)`` over the 16 blocks. The masks come from a
  ``torch.Generator``; the JAX package draws them from ``jax.random`` keys,
  so the two streams differ, while the function given the masks is the
  same (``PVT.drop_path_keep`` is where they are drawn);
- attention is an explicit matmul and softmax (XLA in the JAX package, not
  a TPU kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jspsr_torch.models.components import CBAMBasicBlock
from jspsr_torch.models.lrru import LBasicBlock, LDownsample
from jspsr_torch.nn import bilinear_resize


def _to_map(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h*w, C) tokens -> (B, C, h, w)."""
    b, _, c = tokens.shape
    return tokens.transpose(1, 2).reshape(b, c, h, w)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, h*w, C) tokens."""
    return x.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Attention(nn.Module):
    """Spatial-reduction multi-head attention: keys and values come from
    the tokens shrunk by a ``sr_ratio``-strided conv and a LayerNorm."""

    def __init__(self, dim, num_heads=8, qkv_bias=False, sr_ratio=1):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} "
                             "heads")
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, dim * 2, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim)

    def forward(self, x, h, w):
        b, n, c = x.shape
        nh = self.num_heads
        q = self.q(x).reshape(b, n, nh, c // nh).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(_to_tokens(self.sr(_to_map(x, h, w))))
        kv = self.kv(kv_in)
        m = kv.shape[1]
        k, v = kv.reshape(b, m, 2, nh, c // nh).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * self.scale, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class PVTBlock(nn.Module):
    """Transformer block + parallel CBAM conv branch, concat-conv fusion."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 drop_path=0.0, sr_ratio=1):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.resblock = CBAMBasicBlock(dim, dim, ratio=16)
        self.concat_conv = nn.Conv2d(dim * 2, dim, 3, padding=1, bias=False)
        self.drop_path = drop_path

    def forward(self, x, h, w, keep: torch.Tensor | None = None):
        """``keep``: the drop-path keep mask (B, 1, 1) of 0/1, or None for
        no drop path (eval, or a rate of 0)."""
        inp = x
        scale = None if keep is None \
            else keep.to(x.dtype) / (1.0 - self.drop_path)
        y = self.attn(self.norm1(x), h, w)
        x = x + (y if scale is None else y * scale)
        y = self.mlp(self.norm2(x))
        x = x + (y if scale is None else y * scale)
        conv_out = self.resblock(_to_map(inp, h, w))
        fused = self.concat_conv(torch.cat([_to_map(x, h, w), conv_out], dim=1))
        return _to_tokens(fused)


class PatchEmbed(nn.Module):
    def __init__(self, img_size, patch_size, in_chans, embed_dim):
        super().__init__()
        self.grid = (img_size // patch_size, img_size // patch_size)
        self.num_patches = self.grid[0] * self.grid[1]
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        """NCHW -> (tokens (B, N, C), (h, w))."""
        y = self.proj(x)
        return self.norm(_to_tokens(y)), tuple(y.shape[-2:])


class PVT(nn.Module):
    def __init__(self, in_chans=128, patch_size=2, img_size=224,
                 embed_dims=(64, 128, 320, 512), num_heads=(1, 2, 5, 8),
                 mlp_ratios=(8, 8, 4, 4), qkv_bias=True,
                 depths=(3, 4, 6, 3), sr_ratios=(8, 4, 2, 1),
                 drop_path_rate=0.1):
        super().__init__()
        self.num_stages = len(depths)
        self.embed_layer1 = nn.Sequential(
            *[LBasicBlock(64, 64) for _ in range(3)])
        self.embed_layer2 = nn.Sequential(
            LBasicBlock(64, 128, 2, LDownsample(64, 128, 2)),
            *[LBasicBlock(128, 128) for _ in range(3)])

        dpr = torch.linspace(0, drop_path_rate, sum(depths)).tolist()
        cur = 0
        for i in range(self.num_stages):
            pe = PatchEmbed(
                img_size if i == 0 else img_size // (2 ** (i + 1)),
                patch_size if i == 0 else 2,
                in_chans if i == 0 else embed_dims[i - 1],
                embed_dims[i],
            )
            n_pos = pe.num_patches + (1 if i == self.num_stages - 1 else 0)
            setattr(self, f"patch_embed{i + 1}", pe)
            setattr(self, f"pos_embed{i + 1}",
                    nn.Parameter(torch.zeros(1, n_pos, embed_dims[i])))
            setattr(self, f"block{i + 1}", nn.Sequential(*[
                PVTBlock(embed_dims[i], num_heads[i], mlp_ratios[i], qkv_bias,
                         dpr[cur + j], sr_ratios[i])
                for j in range(depths[i])]))
            cur += depths[i]

    def _pos(self, pos, pe: PatchEmbed, h, w):
        """The stored position grid resized to the runtime (h, w); note the
        comparison with STAGE 1's patch count."""
        if h * w == self.patch_embed1.num_patches:
            return pos
        gh, gw = pe.grid
        pos2d = _to_map(pos, gh, gw)
        return _to_tokens(bilinear_resize(pos2d, h, w, align_corners=False))

    def drop_path_keep(self, stage: int, block: int, batch: int,
                       generator: torch.Generator | None):
        """The drop-path keep mask (B, 1, 1) of block ``block`` of stage
        ``stage`` (0-based), or None where drop path is off: in eval, at a
        rate of 0, or without a generator."""
        rate = getattr(self, f"block{stage + 1}")[block].drop_path
        if not self.training or rate <= 0.0 or generator is None:
            return None
        keep = torch.empty(batch, 1, 1, device=generator.device)
        return keep.bernoulli_(1.0 - rate, generator=generator)

    def forward(self, x, generator: torch.Generator | None = None):
        """x: NCHW (64 channels). Returns the six NCHW feature maps
        (fe2..fe7): the two embedding layers', then one per stage."""
        y = self.embed_layer1(x)
        outs = [y]
        y = self.embed_layer2(y)
        outs.append(y)
        b = x.shape[0]
        for i in range(self.num_stages):
            pe = getattr(self, f"patch_embed{i + 1}")
            tokens, (h, w) = pe(y)
            pos = getattr(self, f"pos_embed{i + 1}")
            if i == self.num_stages - 1:
                pos = pos[:, 1:]
            tokens = tokens + self._pos(pos, pe, h, w)
            for j, blk in enumerate(getattr(self, f"block{i + 1}")):
                tokens = blk(tokens, h, w,
                             keep=self.drop_path_keep(i, j, b, generator))
            y = _to_map(tokens, h, w)
            outs.append(y)
        return outs
