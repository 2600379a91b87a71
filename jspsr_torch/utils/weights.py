"""Weight bridge from the JAX package to the port: the inverse of
``jspsr_tpu/utils/torch_import.py``.

``state_dict_from_jax(flat, model)`` takes the JAX parameters and BatchNorm
state as numpy arrays, flattened with ``/``-joined keys under ``params/``
and ``bn/`` prefixes (the ``.npz`` checkpoint layout of
``jspsr_tpu/train/checkpoint.py``), and returns a state_dict for the port
module ``model`` (any family), in the reference torch key layout the
port's modules use. Each JAX key is walked down ``model``'s module tree,
and the port module it lands on decides both the name and the layout:

- names: ``Basic2d`` conv / bn -> ``conv.0`` / ``conv.bn``;
  ``Basic2dTrans`` -> ``dconv.0`` / ``dconv.1`` / ``dconv.bn``;
  ``ChannelAttention`` fc1 / fc2 -> ``fc.0`` / ``fc.2``; a (L)Downsample's
  conv / bn -> ``0`` / ``1``; ``Generator.conv_weight`` ->
  ``conv_weight.0``; a bare parameter (the JAX ``ParamLeaf``'s ``value``:
  ``pos_embed{i}``, NLSPN's ``aff_scale_const``, ``w``, ``b``, ``w_conf``)
  -> its own name;
- layouts: ``Conv2d`` HWIO -> OIHW; ``ConvTranspose2d`` (the JAX
  equivalent-forward HWIO kernel) -> torch (Cin, Cout, kh, kw) with its
  spatial flip undone; ``Linear`` (in, out) -> (out, in); BatchNorm and
  LayerNorm ``scale`` -> ``weight``; a bare 4-D kernel HWIO -> OIHW;
  BatchNorm state ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var``.

``state_dict_from_jax_tree(tree, model)`` does the same for any tree shaped
like the JAX parameters (its gradients, AdamW's ``mu``/``nu``): nested
dicts of arrays, flattened to ``params/...`` keys first.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from jspsr_torch.models.components import (
    Basic2d,
    Basic2dTrans,
    ChannelAttention,
)
from jspsr_torch.models.spn import Generator

_NORMS = (nn.BatchNorm2d, nn.LayerNorm)
_NORM_LEAVES = {"scale": "weight", "bias": "bias"}
_STATE_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _child(module: nn.Module, seg: str) -> str:
    """The port's name, below ``module``, of the JAX child ``seg``."""
    if isinstance(module, Basic2dTrans):
        return {"conv": "dconv.0", "dconv": "dconv.1", "bn": "dconv.bn"}[seg]
    if isinstance(module, Basic2d) and seg in ("conv", "bn"):
        return {"conv": "conv.0", "bn": "conv.bn"}[seg]
    if isinstance(module, ChannelAttention):
        return {"fc1": "fc.0", "fc2": "fc.2"}[seg]
    if isinstance(module, nn.Sequential) and seg in ("conv", "bn"):
        return {"conv": "0", "bn": "1"}[seg]  # Downsample, LDownsample
    if isinstance(module, Generator) and seg == "conv_weight":
        return "conv_weight.0"
    return seg


def _walk(model: nn.Module, parts: list[str]) -> tuple[str, nn.Module]:
    """JAX module path -> (port module path, port module)."""
    names, module = [], model
    for seg in parts:
        name = _child(module, seg)
        module = module.get_submodule(name)
        names.append(name)
    return ".".join(names), module


def _join(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


def _param(module: nn.Module, leaf: str, arr: np.ndarray):
    """(torch name, array in torch layout) of the JAX leaf ``leaf`` of
    ``module``."""
    if isinstance(module, nn.ConvTranspose2d):
        if leaf == "w":
            return "weight", np.flip(arr, (0, 1)).transpose(2, 3, 0, 1)
        return "bias", arr
    if isinstance(module, nn.Conv2d):
        return ("weight", arr.transpose(3, 2, 0, 1)) if leaf == "w" \
            else ("bias", arr)
    if isinstance(module, nn.Linear):
        return ("weight", arr.T) if leaf == "w" else ("bias", arr)
    if isinstance(module, _NORMS):
        return _NORM_LEAVES[leaf], arr
    # a bare parameter of a custom module (PostProcessor's w / b)
    return leaf, arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr


def state_dict_from_jax(flat: dict, model: nn.Module) -> OrderedDict:
    """Port state_dict (torch tensors) for ``model`` from a flat
    ``params/...``, ``bn/...`` dict of numpy arrays. Other keys
    (``opt/...``, ``__meta__``) are ignored."""
    sd = OrderedDict()
    for key, value in flat.items():
        prefix, _, rest = key.partition("/")
        if prefix not in ("params", "bn"):
            continue
        parts = rest.split("/")
        leaf = parts[-1]
        arr = np.asarray(value, np.float32)
        if prefix == "bn":
            path, _ = _walk(model, parts[:-1])
            sd[_join(path, "num_batches_tracked")] = torch.tensor(0)
            key = _join(path, _STATE_LEAVES[leaf])
        elif leaf == "value":  # a bare parameter, named by its own path
            parent, _ = _walk(model, parts[:-2])
            key = _join(parent, parts[-2])
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        else:
            path, module = _walk(model, parts[:-1])
            name, arr = _param(module, leaf, arr)
            key = _join(path, name)
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def flatten_jax_tree(tree, prefix: str = "params") -> dict:
    """Nested dicts (or lists) of arrays -> ``{prefix/a/b/leaf: ndarray}``,
    the ``.npz`` checkpoint layout."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_jax_tree(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_jax_tree(v, f"{prefix}/{i}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def state_dict_from_jax_tree(tree, model: nn.Module,
                             prefix: str = "params") -> OrderedDict:
    """A tree shaped like the JAX parameters (``prefix='params'``) or the
    BatchNorm state (``prefix='bn'``), in ``model``'s key names and
    layouts."""
    return state_dict_from_jax(flatten_jax_tree(tree, prefix), model)
