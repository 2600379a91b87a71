"""Checkpoints (counterpart of ``jspsr_tpu/train/checkpoint.py``).

The port writes and reads the JAX package's ``.npz`` layout, so that a
checkpoint crosses between the packages both ways:

- ``params/<jax path>`` and ``bn/<jax path>``: the model's parameters and
  BatchNorm statistics in the JAX names and layouts
  (``utils.weights.jax_flat_from_state_dict``; read back by
  ``state_dict_from_jax``);
- ``__meta__``: a JSON blob with ``epoch``, ``best_result`` and the
  caller's ``extra`` (the Trainer's ``global_step``);
- what only the port has, under prefixes of its own that the JAX loader
  never reads: the optimizer's state by parameter name,
  ``torch_opt/<name>/<key>`` (its hyperparameters in the meta's
  ``torch_opt_groups``), and each BatchNorm's ``num_batches_tracked``,
  ``torch_bn/<name>``. The JAX loader reads optax leaves by position
  under ``opt/``, which the port never writes: resuming the JAX package
  from a port checkpoint starts its optimizer fresh, as resuming the port
  from a JAX checkpoint does (optimizer state is not portable).

A reference ``.pt`` / ``.pth`` file (a torch state_dict, bare or under
``state_dict``) loads too, in the key layout the port's modules use.
Files are written through a temporary file and renamed, so a reader never
sees half of one. ``checkpoint_backend: orbax`` writes the same bytes
from a background thread (``train/orbax_ckpt.py``); ``load_checkpoint``
first waits for such a write to land. A JAX orbax directory is refused:
it needs orbax and tensorstore, which the port does not use.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.parallel.mesh import is_writer
from jspsr_torch.utils.weights import (
    jax_flat_from_state_dict,
    state_dict_from_jax,
)

OPT_PREFIX = "torch_opt/"
BN_COUNT_PREFIX = "torch_bn/"


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place updates do not reach."""
    return t.detach().to("cpu", copy=True).numpy()


def checkpoint_arrays(model: torch.nn.Module, optimizer=None,
                      epoch: int = 0, best_result=None,
                      extra: dict | None = None) -> dict:
    """The ``.npz`` entries of ``model`` (and ``optimizer``'s state) and
    the meta blob, as host copies."""
    arrays = jax_flat_from_state_dict(model)
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            arrays[BN_COUNT_PREFIX + name] = _host(t)
    meta = {"epoch": int(epoch), "best_result": best_result, **(extra or {})}
    if optimizer is not None:
        state, groups = _optimizer_arrays(model, optimizer)
        arrays.update(state)
        meta["torch_opt_groups"] = groups
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta, default=float).encode(), dtype=np.uint8)
    return arrays


def write_npz(path, arrays: dict) -> Path:
    """``arrays`` to the ``.npz`` at ``path``, through a temporary file
    that is renamed over it once written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path)
    return path


def save_checkpoint(path, model: torch.nn.Module, optimizer=None,
                    epoch: int = 0, best_result=None,
                    extra: dict | None = None) -> Path:
    """Write ``model`` (and ``optimizer``'s state) to the ``.npz`` at
    ``path``, atomically. Under a process group only rank 0 writes (the
    ranks hold the same state), as in the JAX package."""
    if not is_writer():
        return Path(path)
    return write_npz(path, checkpoint_arrays(model, optimizer, epoch,
                                             best_result, extra))


def load_checkpoint(path) -> tuple[dict, dict]:
    """Read a JAX or port ``.npz`` checkpoint: (flat arrays, meta), once
    an asynchronous save in flight has landed."""
    from jspsr_torch.train.orbax_ckpt import wait_for_checkpoint

    if Path(path).is_dir() or str(path).endswith(".orbax"):
        raise ValueError(
            f"{path} is a JAX orbax checkpoint directory: the port cannot "
            f"read it (orbax and tensorstore are JAX-side libraries). Save "
            f"it as .npz with the JAX package (checkpoint_backend: npz, or "
            f"jspsr_tpu.train.checkpoint.save_checkpoint on the loaded "
            f"state) and load that .npz")
    wait_for_checkpoint()
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


def _state_from_flat(model: torch.nn.Module, flat: dict) -> OrderedDict:
    """The port state_dict held by a flat ``.npz`` dict: its ``params/``
    and ``bn/`` entries that name a tensor of ``model``, and its
    ``torch_bn/`` counters."""
    sd = OrderedDict()
    for key, value in flat.items():
        if key.startswith(BN_COUNT_PREFIX):
            sd[key[len(BN_COUNT_PREFIX):]] = torch.from_numpy(
                np.array(value))
            continue
        try:
            sd.update(state_dict_from_jax({key: value}, model))
        except (AttributeError, KeyError):
            pass  # a path this model does not have: skipped below
    return sd


def load_params_filtered(model: torch.nn.Module, loaded: dict) -> OrderedDict:
    """Shape-filtered merge (reference utils/utils.py:352-370): ``model``'s
    state_dict with every tensor of ``loaded`` (a port state_dict) whose
    name and shape match; the rest keep the model's values and are named
    in a warning. Returns the merged state_dict."""
    merged, skipped = OrderedDict(), []
    for name, t in model.state_dict().items():
        v = loaded.get(name)
        if v is not None and tuple(v.shape) == tuple(t.shape):
            merged[name] = v.to(t.dtype)
        else:
            merged[name] = t
            skipped.append(name)
    if skipped:
        print(f"[checkpoint] skipped {len(skipped)} mismatched keys "
              f"(e.g. {skipped[:3]})")
    return merged


def load_model_state(model: torch.nn.Module, path) -> tuple[dict, dict]:
    """Load a checkpoint into ``model``: a ``.npz`` shape-filtered
    (``load_params_filtered``), as the JAX package loads one; a ``.pt`` /
    ``.pth`` strictly (every key must match). Returns the checkpoint's flat
    arrays (empty for a ``.pt``) and its meta, for a resume."""
    if str(path).endswith((".pt", ".pth")):
        sd, meta = load_torch_checkpoint(path)
        sd, flat = OrderedDict(sd), {}
    else:
        flat, meta = load_checkpoint(path)
        sd = load_params_filtered(model, _state_from_flat(model, flat))
    model.load_state_dict(sd, strict=True)
    return flat, meta


def load_model_params(model: torch.nn.Module, path) -> torch.nn.Module:
    """``load_model_state`` that returns ``model``."""
    load_model_state(model, path)
    return model


def _param_names(model: torch.nn.Module, optimizer) -> list:
    """The names of ``optimizer``'s parameters in its state_dict's order."""
    names = {id(q): n for n, q in model.named_parameters()}
    return [names[id(q)] for g in optimizer.param_groups for q in g["params"]]


def _optimizer_arrays(model, optimizer) -> tuple[dict, list]:
    osd = optimizer.state_dict()
    names = _param_names(model, optimizer)
    arrays = {}
    for idx, state in osd["state"].items():
        for key, v in state.items():
            arrays[f"{OPT_PREFIX}{names[idx]}/{key}"] = (
                _host(v) if isinstance(v, torch.Tensor) else np.asarray(v))
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in osd["param_groups"]]
    return arrays, groups


def has_optimizer_state(flat: dict) -> bool:
    return any(k.startswith(OPT_PREFIX) for k in flat)


def load_optimizer_state(model, optimizer, flat: dict, meta: dict) -> None:
    """Restore ``optimizer`` from a port checkpoint's ``torch_opt/``
    entries, matched to its parameters by name."""
    osd = optimizer.state_dict()
    index = {n: i for i, n in enumerate(_param_names(model, optimizer))}
    state = {}
    for key, arr in flat.items():
        if key.startswith(OPT_PREFIX):
            name, field = key[len(OPT_PREFIX):].rsplit("/", 1)
            state.setdefault(index[name], {})[field] = torch.from_numpy(
                np.array(arr))
    groups = [dict(saved, params=fresh["params"]) for saved, fresh in
              zip(meta["torch_opt_groups"], osd["param_groups"])]
    optimizer.load_state_dict({"state": state, "param_groups": groups})
