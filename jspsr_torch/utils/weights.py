"""Weight bridge from the JAX package to the port: the inverse of
``jspsr_tpu/utils/torch_import.py``.

``state_dict_from_jax(flat)`` takes the JAX parameters and BatchNorm state
as numpy arrays, flattened with ``/``-joined keys under ``params/`` and
``bn/`` prefixes (the ``.npz`` checkpoint layout of
``jspsr_tpu/train/checkpoint.py``), and returns a state_dict in the
reference torch key layout that the port's modules use:

- ``Basic2d`` -> ``conv.0`` / ``conv.bn``
- ``Basic2dTrans`` -> ``dconv.0`` / ``dconv.1`` / ``dconv.bn``
- ``Downsample`` -> ``0`` / ``1``
- ``ChannelAttention`` -> ``fc.0`` / ``fc.2``
- ``Generator.conv_weight`` -> ``conv_weight.0``
- ``PostProcessor`` -> ``w`` (1,1,3,3) and ``b``

Layouts: conv HWIO -> OIHW; the transposed conv's equivalent-forward HWIO
kernel -> torch (Cin, Cout, kh, kw) with its spatial flip undone; BN
``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

_TRANS = re.compile(r"layer\dd$")  # JSPSR decoder Basic2dTrans modules
_PARAM_LEAVES = {"w": "weight", "b": "bias", "scale": "weight",
                 "bias": "bias"}
_STATE_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _torch_module_path(parts: list[str]) -> tuple[str, bool]:
    """JAX module path -> (torch module path, whether the module is a
    decoder transposed conv)."""
    out = []
    parent = None  # 'trans', 'ds', 'camb' or None (generic / Basic2d)
    for i, seg in enumerate(parts):
        is_leaf = i == len(parts) - 1
        if parent == "camb":
            out.append({"fc1": "fc.0", "fc2": "fc.2"}[seg])
        elif parent == "ds":
            out.append({"conv": "0", "bn": "1"}[seg])
        elif parent == "trans":
            out.append({"conv": "dconv.0", "dconv": "dconv.1",
                        "bn": "dconv.bn"}[seg])
        elif is_leaf and seg == "conv":
            out.append("conv.0")  # a Basic2d's conv
        elif is_leaf and seg == "bn":
            out.append("conv.bn")  # a Basic2d's BatchNorm
        elif seg == "conv_weight":
            out.append("conv_weight.0")
        else:
            out.append(seg)
        parent = ("camb" if seg == "camb" else "ds" if seg == "downsample"
                  else "trans" if _TRANS.match(seg) else None)
    is_tconv = (len(parts) > 1 and parts[-1] == "dconv"
                and _TRANS.match(parts[-2]) is not None)
    return ".".join(out), is_tconv


def state_dict_from_jax(flat: dict) -> OrderedDict:
    """Port state_dict (torch tensors) from a flat ``params/...``,
    ``bn/...`` dict of numpy arrays. Other keys (``opt/...``,
    ``__meta__``) are ignored."""
    sd = OrderedDict()
    for key, value in flat.items():
        prefix, _, rest = key.partition("/")
        if prefix not in ("params", "bn"):
            continue
        parts = rest.split("/")
        leaf = parts[-1]
        arr = np.asarray(value, np.float32)
        if prefix == "bn":
            mod, _ = _torch_module_path(parts[:-1])
            name = _STATE_LEAVES[leaf]
            sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
        elif parts[:-1] == ["postprocessor"]:  # SPN head's bare 3x3 kernel
            mod, name = "postprocessor", leaf
            if leaf == "w":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        else:
            mod, is_tconv = _torch_module_path(parts[:-1])
            name = _PARAM_LEAVES[leaf]
            if leaf == "w" and is_tconv:
                arr = np.flip(arr, (0, 1)).transpose(2, 3, 0, 1)
            elif leaf == "w":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        sd[f"{mod}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    return sd
