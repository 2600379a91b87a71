"""Model registry (counterpart of ``jspsr_tpu/models/factory.py``).
JSPSR and CompletionFormer are ported; the other families raise until
their slices land."""

from __future__ import annotations

import torch

BRANCH_KEYS = ("lr_dem", "image", "mask", "canopy", "coord")
NOT_YET_PORTED = ("edsr", "lrru")


def _branch_channels(input_data: dict) -> dict:
    return {k: v for k, v in input_data.items() if k in BRANCH_KEYS and v}


def build_model(p, generator: torch.Generator | None = None):
    """p: config with model_name / model_kwargs / input_data. ``generator``
    seeds the random init (default: seeded from ``p.seed`` or 0)."""
    name = p.model_name.lower()
    mk = p.model_kwargs
    if generator is None:
        generator = torch.Generator().manual_seed(int(p.get("seed") or 0))
    if name == "jspsr":
        from jspsr_torch.models.jspsr import JSPSR, NOT_PORTED

        nb = mk.get("num_block", 2)
        return JSPSR(
            in_channels=_branch_channels(p.input_data),
            out_channels=1,
            num_feature=mk.get("num_feature", 32),
            layers=(nb, nb, nb, nb),
            spn=mk.get("spn", True),
            spn_scale=mk.get("spn_scale", 1.0),
            cat_only=mk.get("cat_only", True),
            generator_leaky=mk.get("generator_leaky", False),
            generator=generator,
            **{k: mk.get(k) for k in NOT_PORTED},
        )
    if name == "completionformer":
        from jspsr_torch.models.completionformer import CompletionFormer

        return CompletionFormer(
            in_channels=_branch_channels(p.input_data),
            out_channels=1,
            prop_time=mk.get("prop_time", 6),
            prop_kernel=mk.get("prop_kernel", 3),
            conf_prop=mk.get("conf_prop", True),
            affinity=mk.get("affinity", "TGASS"),
            affinity_gamma=mk.get("affinity_gamma", 0.5),
            generator=generator,
        )
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"model {p.model_name} is not yet ported")
    raise NotImplementedError(f"Unsupported model name {p.model_name}")
