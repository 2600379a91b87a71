"""Config-driven pretrained-weight bootstrap (counterpart of
``jspsr_tpu/utils/pretrained.py``), the reference's three entry points:

- ``model_kwargs.pretrained``: EDSR's public checkpoint (reference
  utils/common_config.py:100-102 -> utils/utils.py:338-349). Its module
  names differ from the model's, so its tensors are paired with the
  model's state_dict by position (``pair_state_dict``), then loaded where
  the shapes agree; a tensor of another shape leaves its parameter at
  init. ``True`` takes the model's default path (``model.url``); a string
  is the path.
- ``model_kwargs.pvt_pretrained``: CompletionFormer's PVT backbone
  (reference completion_former_backbone.py:82-88, ``strict=False``),
  matched by name.
- ``model_kwargs.resnet_pretrained``: torchvision ResNet34 weights for
  PVT's ``layer1`` / ``layer2`` embedding stems (reference
  pvt.py:13-34,249-252), matched by name.

The two name-matched loads are partial: where a file lacks a key, the
smallest enclosing submodule keeps its init whole (``load_matching``: a
conv, a BatchNorm or a norm layer with all of its tensors, PostProcessor's
kernel and bias together, any other bare parameter alone), so a BatchNorm
whose ``running_var`` is absent is not half loaded, as plain
``load_state_dict(strict=False)`` would leave it.

Files are local paths, or ``file://`` URLs copied once into a cache; any
other URL is read from the cache only. Nothing is downloaded.
"""

from __future__ import annotations

import hashlib
import shutil
import urllib.parse
import urllib.request
from pathlib import Path

import torch
from torch import nn

from jspsr_torch.models.spn import PostProcessor
from jspsr_torch.train.checkpoint import load_torch_checkpoint

# modules whose tensors load together or not at all
_UNITS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.BatchNorm2d,
          nn.LayerNorm, PostProcessor)


def resolve_pretrained_path(spec, cache_dir=None) -> str:
    """A local path passes through. A URL maps to a file in ``cache_dir``
    (default ``~/.cache/jspsr_torch/pretrained``; ``model_kwargs.
    pretrained_cache``), named as the JAX package names it: a ``file://``
    URL's file is copied there once; any other URL must already be there
    (``FileNotFoundError`` names the place)."""
    spec = str(spec)
    if "://" not in spec:
        return spec
    url = urllib.parse.urlparse(spec)
    cache_dir = Path(cache_dir or
                     Path.home() / ".cache" / "jspsr_torch" / "pretrained")
    name = Path(url.path).name or "checkpoint"
    digest = hashlib.sha256(spec.encode()).hexdigest()[:12]
    dest = cache_dir / f"{digest}_{name}"
    if dest.exists():
        return str(dest)
    src = Path(urllib.request.url2pathname(url.path))
    if url.scheme != "file" or not src.is_file():
        raise FileNotFoundError(
            f"pretrained checkpoint {spec} is not in the cache and is not a "
            f"local file; nothing is downloaded: place it at {dest} or pass "
            f"a local path")
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_name(dest.name + ".part")
    shutil.copyfile(src, tmp)
    tmp.replace(dest)
    return str(dest)


def _own_keys(module: nn.Module) -> list:
    return [k for k in module.state_dict()
            if not k.endswith("num_batches_tracked")]


def pair_state_dict(module: nn.Module, foreign: dict) -> dict:
    """Positional re-keying of a foreign state_dict (reference
    utils/utils.py:324-349): its tensors, ``num_batches_tracked`` left out,
    take ``module``'s state_dict names in order; extra trailing tensors are
    dropped."""
    expected = _own_keys(module)
    values = [v for k, v in foreign.items()
              if not str(k).endswith("num_batches_tracked")]
    if len(values) < len(expected):
        raise ValueError(f"foreign checkpoint has {len(values)} tensors, "
                         f"need {len(expected)}")
    return dict(zip(expected, values))


def _unit(module: nn.Module, key: str) -> str:
    """The smallest enclosing submodule of the tensor ``key`` that loads
    as a whole (its path), or the key itself for a bare parameter."""
    owner = key.rpartition(".")[0]
    return owner if isinstance(module.get_submodule(owner), _UNITS) else key


def load_matching(module: nn.Module, state_dict: dict,
                  missing_ok: bool = False) -> list:
    """Load ``state_dict`` into ``module`` by name where shapes agree; keys
    ``module`` lacks are ignored. With ``missing_ok`` a submodule (see
    ``_unit``) with any key absent keeps its init whole; without it an
    absent key raises ``KeyError``. Returns the keys left at init for
    their shape."""
    own = module.state_dict()
    units = {}
    for key in _own_keys(module):
        units.setdefault(_unit(module, key), []).append(key)
    new, skipped = {}, []
    for keys in units.values():
        missing = [k for k in keys if k not in state_dict]
        if missing:
            if missing_ok:
                continue
            raise KeyError(f"missing keys: {missing}")
        for k in keys:
            value = torch.as_tensor(state_dict[k])
            if tuple(value.shape) == tuple(own[k].shape):
                new[k] = value
            else:
                skipped.append(k)
    module.load_state_dict(new, strict=False)
    return skipped


def apply_pretrained(p, model: nn.Module, verbose: bool = False):
    """Apply the configured pretrained weights to ``model`` in place (on
    the CPU, before it moves to its device); returns ``model``."""
    mk = p.model_kwargs
    cache = mk.get("pretrained_cache")

    def report(tag, skipped):
        if verbose:
            msg = f"Loaded pretrained {tag}"
            if skipped:
                msg += f" ({len(skipped)} mismatched tensors kept at init)"
            print(msg)

    pre = mk.get("pretrained")
    if pre:
        path = pre if isinstance(pre, str) else getattr(model, "url", None)
        if not path:
            raise ValueError(f"model_kwargs.pretrained: true, but "
                             f"{p.model_name} has no default pretrained "
                             f"path; pass the file's path instead")
        path = resolve_pretrained_path(path, cache)
        if not Path(path).is_file():
            raise FileNotFoundError(
                f"pretrained checkpoint {path} not found (the reference "
                f"downloads it; nothing is downloaded here: place the file "
                f"there)")
        sd = pair_state_dict(model, load_torch_checkpoint(path)[0])
        report(path, load_matching(model, sd))

    pvt_pre = mk.get("pvt_pretrained")
    if pvt_pre:
        path = resolve_pretrained_path(pvt_pre, cache)
        report(path, load_matching(model.backbone.former,
                                   load_torch_checkpoint(path)[0],
                                   missing_ok=True))

    rn_pre = mk.get("resnet_pretrained")
    if rn_pre:
        path = resolve_pretrained_path(rn_pre, cache)
        sd = load_torch_checkpoint(path)[0]
        for layer in ("layer1", "layer2"):
            sub = {k[len(layer) + 1:]: v for k, v in sd.items()
                   if k.startswith(layer + ".")}
            stem = getattr(model.backbone.former, f"embed_{layer}")
            report(f"{path}:{layer}", load_matching(stem, sub,
                                                    missing_ok=True))
    return model
