"""The pieces of LRRU that PVT builds on (counterpart of the first part of
``jspsr_tpu/models/lrru.py``): ``conv1x1``, ``conv3x3``, ``LDownsample``
(conv1x1 + BatchNorm, keys ``0`` / ``1``) and ``LBasicBlock`` (a ResNet
BasicBlock without residual scale: the JSPSR ``BasicBlock`` at its default
scale 1). The JAX package's LRRU model itself is not yet ported.
"""

from __future__ import annotations

from jspsr_torch.models.components import (  # noqa: F401 (re-exported)
    BasicBlock as LBasicBlock,
    Downsample as LDownsample,
    conv1x1,
    conv3x3,
)
