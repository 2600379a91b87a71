"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; without a
card and without an explicit CPU request they raise rather than carry on
quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_strict_fp32() -> None:
    """An fp32 config means fp32: turn TF32 off for cuDNN convolutions
    (on by default, it would silently run every conv in TF32) and for
    matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def set_deterministic_cudnn() -> None:
    """Ask cuDNN for deterministic algorithms only, and no benchmark search
    (which may pick another algorithm from run to run), so that a train
    step on the card is reproducible as the JAX package's is. The rest of
    both train steps sums in one order on every run too: the port's own
    kernels (the deform forward, and its backward without and with the
    input gradient, which sums that gradient in fixed point), the Grad
    loss's replicate padding (``ops/filters.replicate_pad1``), the resizes'
    backward (``nn/layers.py``, matrix products) and the confidence sampling
    of NLSPN (``ops/deform_conv._bilinear_corners``, sorted indexing)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
