"""Model summary (counterpart of ``count_parameters`` in
``jspsr_tpu/utils/summary.py``)."""

from __future__ import annotations

import torch


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
