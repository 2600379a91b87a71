"""Weight bridge JAX -> PyTorch port (jspsr_torch/utils/weights.py).

The port's modules must reproduce the reference torch key layout that the
JAX package's importer reads, and ``state_dict_from_jax`` must invert that
importer exactly: JAX params -> port state_dict -> importer -> the same
JAX params, bit for bit.
"""

import numpy as np
import pytest
import jax
import torch

from jspsr_tpu.models.edsr import EDSR as JaxEDSR
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.models.lrru import LRRU as JaxLRRU
from jspsr_tpu.nn.module import param_count
from jspsr_tpu.train.checkpoint import flatten_tree
from jspsr_tpu.utils.torch_import import (
    expected_torch_keys,
    import_torch_state_dict,
)
from jspsr_torch.models.edsr import EDSR
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.models.lrru import LRRU
from jspsr_torch.utils.weights import jax_flat_from_state_dict, \
    state_dict_from_jax

torch.set_num_threads(2)

FLAGSHIP = {"lr_dem": 1, "image": 3, "mask": 15}
VARIANTS = {
    "flagship": {},
    "cat_only_false": {"cat_only": False},
    "spn_false": {"spn": False},
}


def _flat(params, bn_state):
    """The .npz checkpoint layout: '/'-joined keys under params/ and bn/."""
    flat = {f"params/{k}": v for k, v in flatten_tree(params).items()}
    flat.update({f"bn/{k}": v for k, v in flatten_tree(bn_state).items()})
    return flat


def _perturb_bn(tree, rng):
    """Non-trivial BatchNorm leaves, so a swapped or dropped one shows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_bn(v, rng)
        elif k in ("mean", "bias"):
            out[k] = np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k in ("var", "scale"):
            out[k] = np.asarray(v) * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def _port_keys(model):
    return [k for k in model.state_dict() if not k.endswith("num_batches_tracked")]


def _assert_same_flat(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


def test_flagship_jax_init_round_trip():
    """A JAX-initialised flagship JSPSR with perturbed BN state: the bridge
    loads into the port strictly and the importer gives it back exactly."""
    jax_model = JaxJSPSR(dict(FLAGSHIP), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = jax_model.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    params, bn = _perturb_bn(params, rng), _perturb_bn(bn, rng)

    port = JSPSR(dict(FLAGSHIP), num_feature=8, layers=(1, 1, 1, 1))
    port.load_state_dict(state_dict_from_jax(_flat(params, bn), port),
                         strict=True)

    assert _port_keys(port) == expected_torch_keys(jax_model)
    assert sum(p.numel() for p in port.parameters()) == param_count(params)
    back_p, back_bn = import_torch_state_dict(jax_model, port.state_dict())
    _assert_same_flat(back_p, params)
    _assert_same_flat(back_bn, bn)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bridge_inverts_importer(variant):
    """Port state_dict -> JAX (importer) -> port (bridge) is the identity,
    on every JSPSR surface the slice serves."""
    kw = VARIANTS[variant]
    port = JSPSR(dict(FLAGSHIP), num_feature=8, layers=(1, 1, 1, 1),
                 generator=torch.Generator().manual_seed(7), **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
    jax_model = JaxJSPSR(dict(FLAGSHIP), num_feature=8, layers=(1, 1, 1, 1),
                         **kw)
    assert _port_keys(port) == expected_torch_keys(jax_model)
    params, bn = import_torch_state_dict(jax_model, port.state_dict())
    assert sum(p.numel() for p in port.parameters()) == param_count(params)

    fresh = JSPSR(dict(FLAGSHIP), num_feature=8, layers=(1, 1, 1, 1), **kw)
    sd = state_dict_from_jax(_flat(params, bn), fresh)
    fresh.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0,
                                       atol=0, msg=k)


def _family(name):
    """(port model, JAX twin) of EDSR (with or without its SPN head) and
    LRRU, narrow."""
    if name.startswith("edsr"):
        kw = dict(in_channels=4, out_channels=1, n_resblocks=2,
                  n_features=8, spn=name == "edsr_spn")
        return (EDSR(**kw, generator=torch.Generator().manual_seed(2)),
                JaxEDSR(**kw))
    kw = dict(bc=4, layers=(2, 1, 1, 1, 1), prob=0.8)
    return (LRRU({"lr_dem": 1, "image": 3}, **kw,
                 generator=torch.Generator().manual_seed(2)),
            JaxLRRU({"lr_dem": 1, "image": 3}, **kw))


@pytest.mark.parametrize("family", ["edsr", "edsr_spn", "lrru"])
def test_family_round_trip(family):
    """JAX parameters (the port's init, BatchNorm perturbed) -> port
    (``state_dict_from_jax``, strict) -> JAX (the importer, and the port's
    own ``jax_flat_from_state_dict``): bit-equal, with the importer's key
    list and the JAX parameter count. EDSR's ``ResBlock`` (``body.0`` /
    ``body.2``), LRRU's ``LBasic2dTrans`` (``conv`` / ``bn``), its plain
    ``conv_weight`` / ``conv_offset`` heads and the post-process's bare
    ``w`` / ``b`` each have their own mapping."""
    seeded, jax_model = _family(family)
    params, bn = import_torch_state_dict(jax_model, seeded.state_dict())
    rng = np.random.default_rng(4)
    params, bn = _perturb_bn(params, rng), _perturb_bn(bn, rng)
    flat = _flat(params, bn)

    port, _ = _family(family)
    port.load_state_dict(state_dict_from_jax(flat, port), strict=True)
    assert _port_keys(port) == expected_torch_keys(jax_model)
    assert sum(p.numel() for p in port.parameters()) == param_count(params)
    back_p, back_bn = import_torch_state_dict(jax_model, port.state_dict())
    _assert_same_flat(back_p, params)
    _assert_same_flat(back_bn, bn)
    mine = jax_flat_from_state_dict(port)
    assert sorted(mine) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(mine[k], np.asarray(v), err_msg=k)
