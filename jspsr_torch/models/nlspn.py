"""Non-local spatial propagation head (counterpart of
``jspsr_tpu/models/nlspn.py``; reference models/components/nlspn.py).

Predicts per-pixel non-local neighbour offsets and affinities from the
guidance, optionally modulates the affinities by the confidence sampled at
each tap's offset, then runs ``prop_time`` iterations of modulated
deformable propagation with a frozen all-ones 3x3 kernel. Affinity
normalisations: AS / ASS / TC / TGASS (tanh, gamma-scaled).

Kept from the JAX package:

- the offset convolution's first ``2*num`` output channels are read as
  ``num`` (dy, dx) pairs in channel order (the reference's cat(o1, o2)
  reinterpretation), and a zero pair is inserted at the centre tap;
- no gradient reaches the frozen kernels ``w``, ``b``, ``w_conf`` or the
  offsets used to sample the confidence; ``aff_scale_const`` is trainable;
- the eight confidence taps are 1x1 bilinear samples (``padding=0``),
  plain PyTorch with autograd to the confidence (XLA in the JAX package:
  its deform kernel takes only 3x3);
- each propagation step is ``ops.deform_conv.deform_conv2d`` on a feature
  that needs its gradient: on the card, the forward kernel and the
  backward kernel with the input gradient.

The frozen kernels are parameters that do not require grad, as in the
reference, so torch's AdamW leaves them alone; optax's AdamW (the JAX
package) decays them by lr·weight_decay per step (1e-9 at the shipped
settings).
"""

from __future__ import annotations

import torch
from torch import nn

from jspsr_torch.ops.deform_conv import bilinear_sample, deform_conv2d

AFFINITIES = ("AS", "ASS", "TC", "TGASS")


class NLSPN(nn.Module):
    def __init__(self, ch_g, ch_f=1, k_g=3, k_f=3, prop_time=6,
                 affinity="TGASS", affinity_gamma=0.5, conf_prop=True,
                 preserve_input=False):
        super().__init__()
        if ch_f != 1 or k_f != 3:
            raise ValueError("NLSPN: only ch_f == 1 and k_f == 3 are "
                             f"supported, got {ch_f}, {k_f}")
        if k_g % 2 != 1:
            raise ValueError(f"NLSPN: k_g must be odd, got {k_g}")
        if affinity not in AFFINITIES:
            raise ValueError(f"NLSPN: affinity {affinity!r} not in "
                             f"{AFFINITIES}")
        self.prop_time = prop_time
        self.affinity = affinity
        self.num = k_f * k_f - 1
        self.idx_ref = self.num // 2
        self.conf_prop = conf_prop
        self.preserve_input = preserve_input

        self.conv_offset_aff = nn.Conv2d(ch_g, 3 * self.num, k_g,
                                         padding=(k_g - 1) // 2, bias=True)
        scale = {"TC": float(self.num),
                 "TGASS": affinity_gamma * self.num}.get(affinity, 1.0)
        self.aff_scale_const = nn.Parameter(torch.full((1,), scale))
        self.w = nn.Parameter(torch.ones(1, 1, k_f, k_f), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(1), requires_grad=False)
        self.w_conf = nn.Parameter(torch.ones(1, 1, 1, 1),
                                   requires_grad=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The offset/affinity conv starts at zero (zero offsets, zero
        affinities), as in the reference."""
        self.conv_offset_aff.weight.zero_()
        self.conv_offset_aff.bias.zero_()

    def _offset_affinity(self, guidance, confidence):
        b, _, h, w = guidance.shape
        num, ref = self.num, self.idx_ref
        off_aff = self.conv_offset_aff(guidance)
        off = off_aff[:, :2 * num].reshape(b, num, 2, h, w)
        aff = off_aff[:, 2 * num:]
        zero = off.new_zeros(b, 1, 2, h, w)
        pairs = torch.cat([off[:, :ref], zero, off[:, ref:]], dim=1)
        offset = pairs.reshape(b, 2 * (num + 1), h, w)

        scale = self.aff_scale_const
        if self.affinity == "TC":
            aff = torch.tanh(aff / 100.0) / scale
        elif self.affinity == "TGASS":
            aff = torch.tanh(aff / 100.0) / (scale + 1e-8)

        if self.conf_prop and confidence is not None:
            # each non-centre tap's affinity times the confidence sampled
            # (1x1 tap, no padding) at that tap's offset
            taps = torch.cat([pairs[:, :ref], pairs[:, ref + 1:]],
                             dim=1).detach()
            yy = torch.arange(h, device=offset.device, dtype=offset.dtype)
            xx = torch.arange(w, device=offset.device, dtype=offset.dtype)
            conf = bilinear_sample(confidence, yy[:, None] + taps[:, :, 0],
                                   xx[None, :] + taps[:, :, 1])
            aff = aff * (conf * self.w_conf.detach().reshape(())
                         + self.b.detach())

        aff_abs_sum = aff.abs().sum(dim=1, keepdim=True) + 1e-4
        if self.affinity in ("ASS", "TGASS"):
            aff_abs_sum = torch.clamp(aff_abs_sum, min=1.0)
        if self.affinity in ("AS", "ASS", "TGASS"):
            aff = aff / aff_abs_sum
        aff_ref = 1.0 - aff.sum(dim=1, keepdim=True)
        aff = torch.cat([aff[:, :ref], aff_ref, aff[:, ref:]], dim=1)
        return offset, aff

    def forward(self, feat_init, guidance, confidence=None, feat_fix=None):
        """feat_init (B,1,H,W), guidance (B,ch_g,H,W), confidence (B,1,H,W)
        or None, feat_fix (B,1,H,W) or None -> (feat, offset, affinity)."""
        offset, aff = self._offset_affinity(guidance, confidence)
        w, b = self.w.detach(), self.b.detach()
        preserve = self.preserve_input and feat_fix is not None
        if preserve:
            mask_fix = ((feat_fix > 0.0).sum(dim=1, keepdim=True) > 0) \
                .to(feat_fix.dtype)
        feat = feat_init
        for _ in range(self.prop_time):
            if preserve:
                feat = (1.0 - mask_fix) * feat + mask_fix * feat_fix
            feat = deform_conv2d(feat, offset, w, b, aff, padding=1)
        return feat, offset, aff
