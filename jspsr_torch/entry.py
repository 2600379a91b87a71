"""The flagship's eval forward and its example inputs (counterpart of
``entry()`` in the JAX package's ``__graft_entry__.py``).

``entry(device)`` returns ``(fn, example_args)``: ``fn(dem, img, msk)`` is
the flagship JSPSR's eval forward (width 32, layers (2, 2, 2, 2), branches
lr_dem / image / 15-class mask, the SPN head) on NCHW tensors, and
``example_args`` one 128^2 tile of each, drawn as the JAX package draws
its example (``example_arrays``). The weights are seeded with an explicit
``torch.Generator``, or are the JAX package's own: ``params=`` (and
``bn_state=``) take the trees of its ``_flagship()`` through the weight
bridge (``utils/weights.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from jspsr_torch.utils.device import resolve_device, set_strict_fp32
from jspsr_torch.utils.weights import state_dict_from_jax_tree

IN_CHANNELS = {"lr_dem": 1, "image": 3, "mask": 15}


def flagship(num_feature: int = 32, layers=(2, 2, 2, 2), params=None,
             bn_state=None):
    """The flagship JSPSR on the CPU, seeded with 0; with ``params`` /
    ``bn_state`` (trees shaped like the JAX model's) holding those weights
    instead."""
    from jspsr_torch.models.jspsr import JSPSR

    model = JSPSR(dict(IN_CHANNELS), num_feature=num_feature,
                  layers=tuple(layers), spn=True,
                  generator=torch.Generator().manual_seed(0))
    if params is not None or bn_state is not None:
        sd = model.state_dict()
        if params is not None:
            sd.update(state_dict_from_jax_tree(params, model))
        if bn_state is not None:
            sd.update(state_dict_from_jax_tree(bn_state, model, prefix="bn"))
        model.load_state_dict(sd)
    return model


def example_arrays(batch: int, h: int, w: int, rng_seed: int = 0):
    """(dem, img, msk) NHWC float32 numpy: the DEM uniform in [0.3, 0.7),
    the RGB in [0, 1), a tenth of the mask's entries 0.5, the rest 0."""
    rng = np.random.default_rng(rng_seed)
    dem = rng.uniform(0.3, 0.7, (batch, h, w, 1)).astype(np.float32)
    img = rng.uniform(0, 1, (batch, h, w, 3)).astype(np.float32)
    msk = ((rng.uniform(0, 1, (batch, h, w, 15)) < 0.1)
           .astype(np.float32) * 0.5)
    return dem, img, msk


def example_inputs(batch: int, h: int, w: int, device="cpu") -> list:
    """``example_arrays`` (seed 0) as contiguous NCHW tensors on
    ``device``."""
    return [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
            .to(device) for a in example_arrays(batch, h, w)]


def entry(device="cuda", params=None, bn_state=None):
    """``(fn, example_args)``: ``fn(dem, img, msk)`` the flagship's eval
    forward on ``device`` (the card unless the CPU is asked for),
    returning the (B, 1, H, W) prediction; ``example_args`` one 1 x 128^2
    tile of each input on ``device``. On the card the convolutions run in
    strict fp32 (no TF32), as the Trainer's do."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_strict_fp32()
    model = flagship(params=params, bn_state=bn_state).to(dev).eval()

    def fn(dem, img, msk):
        with torch.inference_mode():
            return model([dem, img, msk])

    return fn, example_inputs(1, 128, 128, device=dev)
