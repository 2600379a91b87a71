"""Seeded weights, made on the device from ``--seed``.

One ``torch.Generator`` on the device draws every floating leaf of a
state_dict in one call, in sorted key order, so that two modules with the
same keys and shapes (the port's model and the reference's) get the same
weights. Each leaf is then scaled and shifted by its kind, in two more
calls over the whole buffer:

- a weight of two or more dimensions: uniform with variance 1 / fan_in,
  fan_in = numel / shape[0];
- a one-dimensional ``weight`` (BatchNorm, LayerNorm): 1 + U(-0.1, 0.1),
  and any other one-dimensional leaf (biases): U(-0.1, 0.1);
- a BatchNorm ``running_mean``: U(-0.1, 0.1); ``running_var``:
  1 + U(-0.25, 0.25), so that eval mode does not run at the identity;
- integer leaves (``num_batches_tracked``) are 0.
"""

from __future__ import annotations

import math

import torch


def seed_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any whole number;
    reduced into 63 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def _scale_shift(key: str, shape) -> tuple:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return 0.25, 1.0
    if leaf == "running_mean":
        return 0.1, 0.0
    if len(shape) >= 2:
        fan_in = math.prod(shape) // shape[0]
        return math.sqrt(3.0 / max(fan_in, 1)), 0.0
    if leaf == "weight":
        return 0.1, 1.0
    return 0.1, 0.0


def seeded_state_dict(template: dict, seed: int, device,
                      fixed: dict | None = None) -> dict:
    """A state_dict with ``template``'s keys, shapes and dtypes (tensors on
    any device, meta included) on ``device``, drawn from ``seed``; the
    leaves named in ``fixed`` (a configuration's ``fixed_leaves``: the
    model's structural constants) are filled with their value instead,
    after the draw."""
    keys = sorted(k for k, v in template.items() if v.is_floating_point())
    sizes = [template[k].numel() for k in keys]
    total = sum(sizes)
    flat = torch.rand(total, generator=seed_generator(seed, device),
                      device=device, dtype=torch.float32) * 2.0 - 1.0
    ss = torch.tensor([_scale_shift(k, template[k].shape) for k in keys],
                      dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    flat = flat * ss[:, 0].repeat_interleave(counts, output_size=total) \
        + ss[:, 1].repeat_interleave(counts, output_size=total)
    out, off = {}, 0
    for k, n in zip(keys, sizes):
        t = template[k]
        out[k] = flat[off:off + n].view(t.shape).to(t.dtype, copy=True)
        off += n
    for k, value in (fixed or {}).items():
        out[k] = torch.full(template[k].shape, float(value),
                            dtype=template[k].dtype, device=device)
    for k, v in template.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return out
