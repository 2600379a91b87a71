"""Checkpoint reading (counterpart of ``load_checkpoint`` and
``load_model_params`` in ``jspsr_tpu/train/checkpoint.py``).

Two formats load into a port model:

- the JAX package's ``.npz``: ``/``-joined ``params/...`` and ``bn/...``
  arrays plus a ``__meta__`` JSON blob, read with numpy alone and carried
  across by ``utils.weights.state_dict_from_jax``;
- a reference ``.pt`` / ``.pth`` file: a torch state_dict, bare or under a
  ``state_dict`` entry, in the key layout the port's modules already use.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.utils.weights import state_dict_from_jax


def load_checkpoint(path) -> tuple[dict, dict]:
    """Read a JAX ``.npz`` checkpoint: (flat arrays, meta)."""
    if Path(path).is_dir() or str(path).endswith(".orbax"):
        raise NotImplementedError("orbax checkpoints are not yet ported")
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__").tobytes()).decode())
    return arrays, meta


def load_torch_checkpoint(path) -> tuple[dict, dict]:
    """Read a reference ``.pt`` / ``.pth`` file: (state_dict, meta)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        return blob["state_dict"], {k: blob.get(k)
                                    for k in ("epoch", "best_result")}
    return blob, {}


def load_model_params(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a checkpoint into ``model`` (strict: every key must match)."""
    if str(path).endswith((".pt", ".pth")):
        sd, _ = load_torch_checkpoint(path)
    else:
        flat, _ = load_checkpoint(path)
        sd = state_dict_from_jax(flat, model)
    model.load_state_dict(sd, strict=True)
    return model
