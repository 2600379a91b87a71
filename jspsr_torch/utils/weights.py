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
  ``conv_weight.0``; EDSR's ``ResBlock`` conv1 / conv2 -> ``body.0`` /
  ``body.2`` and ``Upscaler`` conv1 / conv2 -> ``0`` / ``2``; a bare
  parameter (the JAX ``ParamLeaf``'s ``value``: ``pos_embed{i}``, NLSPN's
  ``aff_scale_const``, ``w``, ``b``, ``w_conf``) -> its own name (the JAX
  LRRU's ``LBasic2d`` is the port's ``Basic2d`` and its ``PostProcess`` a
  ``PostProcessor``; its ``LBasic2dTrans`` keeps ``conv`` / ``bn``);
- layouts: ``Conv2d`` HWIO -> OIHW; ``ConvTranspose2d`` (the JAX
  equivalent-forward HWIO kernel) -> torch (Cin, Cout, kh, kw) with its
  spatial flip undone; ``Linear`` (in, out) -> (out, in); BatchNorm and
  LayerNorm ``scale`` -> ``weight``; a bare 4-D kernel HWIO -> OIHW;
  BatchNorm state ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var``.

``state_dict_from_jax_tree(tree, model)`` does the same for any tree shaped
like the JAX parameters (its gradients, AdamW's ``mu``/``nu``): nested
dicts of arrays, flattened to ``params/...`` keys first.

``jax_flat_from_state_dict(model)`` is the inverse: the port's state_dict
as the flat ``params/...`` and ``bn/...`` numpy arrays of the JAX layout
(the port's ``.npz`` checkpoints, which the JAX package loads). A port
name is walked down ``model`` the other way: the same renames and
layouts, inverted; ``Downsample``'s ``0`` / ``1`` are the JAX ``conv`` /
``bn`` and ``Upscaler``'s ``0`` / ``2`` its ``conv1`` / ``conv2`` (the
``nn.Sequential``s whose JAX counterparts name their children), a bare
parameter of ``PostProcessor`` (LRRU's post-process among them) is a
plain leaf (``w``, ``b``) and any other bare parameter a JAX
``ParamLeaf`` (``<name>/value``); ``num_batches_tracked`` has no JAX
counterpart.
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
    Downsample,
)
from jspsr_torch.models.edsr import ResBlock, Upscaler
from jspsr_torch.models.spn import Generator, PostProcessor

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
    if isinstance(module, ResBlock):
        return {"conv1": "body.0", "conv2": "body.2"}[seg]
    if isinstance(module, Upscaler):
        return {"conv1": "0", "conv2": "2"}[seg]
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


# port child names (two segments) -> the JAX child, by the port module
_PAIRS = ((Basic2dTrans, {("dconv", "0"): "conv", ("dconv", "1"): "dconv",
                          ("dconv", "bn"): "bn"}),
          (Basic2d, {("conv", "0"): "conv", ("conv", "bn"): "bn"}),
          (ChannelAttention, {("fc", "0"): "fc1", ("fc", "2"): "fc2"}),
          (ResBlock, {("body", "0"): "conv1", ("body", "2"): "conv2"}),
          (Generator, {("conv_weight", "0"): "conv_weight"}))
_STATE_NAMES = {v: k for k, v in _STATE_LEAVES.items()}
_NORM_NAMES = {v: k for k, v in _NORM_LEAVES.items()}


def _jax_path(model: nn.Module, name: str):
    """Port parameter or buffer name -> (JAX module path segments, the
    port module that holds it, its own name)."""
    segs, module, jax = name.split("."), model, []
    *parents, leaf = segs
    i = 0
    while i < len(parents):
        pair = tuple(parents[i:i + 2])
        for cls, table in _PAIRS:
            if isinstance(module, cls) and pair in table:
                jax.append(table[pair])
                i += 2
                break
        else:
            if isinstance(module, Downsample):
                jax.append({"0": "conv", "1": "bn"}[parents[i]])
            elif isinstance(module, Upscaler):
                jax.append({"0": "conv1", "2": "conv2"}[parents[i]])
            else:
                jax.append(parents[i])
            i += 1
        module = model.get_submodule(".".join(parents[:i]))
    return jax, module, leaf


def jax_flat_from_state_dict(model: nn.Module, state_dict=None) -> dict:
    """The port module ``model``'s state_dict (or ``state_dict``, in its
    key layout) as ``{"params/...": ndarray, "bn/...": ndarray}`` in the
    JAX package's key names and layouts (fp32; the inverse of
    ``state_dict_from_jax``)."""
    sd = model.state_dict() if state_dict is None else state_dict
    out = {}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = t.detach().cpu().numpy().astype(np.float32)
        path, module, leaf = _jax_path(model, name)
        if leaf in _STATE_NAMES:
            out["/".join(["bn", *path, _STATE_NAMES[leaf]])] = arr
            continue
        if isinstance(module, nn.ConvTranspose2d):
            jleaf = "w" if leaf == "weight" else "b"
            if leaf == "weight":
                arr = np.flip(arr.transpose(2, 3, 0, 1), (0, 1))
        elif isinstance(module, (nn.Conv2d, nn.Linear)):
            jleaf = "w" if leaf == "weight" else "b"
            if leaf == "weight":
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        elif isinstance(module, _NORMS):
            jleaf = _NORM_NAMES[leaf]
        else:  # a bare parameter: a plain leaf of PostProcessor, else a
            # ParamLeaf named by its own path
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            jleaf = leaf if isinstance(module, PostProcessor) \
                else f"{leaf}/value"
        out["/".join(["params", *path, jleaf])] = np.ascontiguousarray(arr)
    return out
