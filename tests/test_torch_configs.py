"""The eight shipped configs through the port's ``create_config`` and
model factory, against the JAX package's.

Each config, read by both loaders, gives the same keys and values (the r3
files' derived ``crop_mode: tile`` and ``patches_per_image`` included),
and the port's model of it has the JAX model's parameter count. The JAX
side is counted through ``jax.eval_shape`` of its ``init``, the port's on
the meta device: no arrays are made.
"""

from pathlib import Path

import jax
import pytest
import torch

from jspsr_tpu.config.loader import create_config as jax_create_config
from jspsr_tpu.models.factory import build_model as jax_build_model
from jspsr_torch.config.loader import create_config
from jspsr_torch.models.factory import build_model

CONFIGS = sorted(Path(__file__).resolve().parents[1].glob("configs/*.yml"))


def _plain(value):
    """A config value as plain dicts and lists, for comparison."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def test_the_eight_configs_are_shipped():
    assert [c.name for c in CONFIGS] == [
        "completionformer_r8_img_msk.yml", "edsr_r8_img.yml",
        "jspsr_r3_img.yml", "jspsr_r3_img_msk.yml", "jspsr_r8_img.yml",
        "jspsr_r8_img_msk.yml", "jspsr_r8_img_msk_bf16.yml",
        "lrru_r8_img.yml"]


@pytest.mark.parametrize("path", CONFIGS, ids=[c.stem for c in CONFIGS])
def test_config_and_model_match_jax(path):
    p, jp = create_config(path), jax_create_config(path)
    assert _plain(dict(p)) == _plain(dict(jp))
    if p.resolution == 3:
        assert p.crop_mode == "tile" and p.patches_per_image == 9
    with torch.device("meta"):
        model = build_model(p)
    params, _ = jax.eval_shape(jax_build_model(jp).init,
                               jax.random.PRNGKey(0))
    want = sum(leaf.size for leaf in jax.tree_util.tree_leaves(params))
    assert sum(q.numel() for q in model.parameters()) == want
