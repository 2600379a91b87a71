"""Model registry (counterpart of ``jspsr_tpu/models/factory.py``): the
four families, with the JAX factory's arguments."""

from __future__ import annotations

import torch

BRANCH_KEYS = ("lr_dem", "image", "mask", "canopy", "coord")


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
    if name == "edsr":
        from jspsr_torch.models.edsr import EDSR

        return EDSR(
            in_channels=sum(_branch_channels(p.input_data).values()),
            out_channels=1,
            n_resblocks=mk.get("num_block", 16),
            n_features=mk.get("num_feature", 64),
            scale=1,
            spn=mk.get("spn", False),
            generator=generator,
        )
    if name == "lrru":
        from jspsr_torch.models.lrru import LRRU

        return LRRU(
            in_channels=_branch_channels(p.input_data),
            out_channels=1,
            kernel_size=mk.get("kernel_size", 3),
            bc=mk.get("bc", 16),
            prob=mk.get("prob", 1.0),
            dkn_residual=mk.get("dkn_residual", True),
            generator=generator,
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
    raise NotImplementedError(f"Unsupported model name {p.model_name}")
