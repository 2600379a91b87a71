"""Checkpoints across the packages: the port writes and reads the JAX
package's ``.npz`` layout (``params/``, ``bn/``, ``__meta__``), with its
own optimizer state under ``torch_opt/`` that the JAX loader never reads.

A JAX checkpoint loaded by the port and saved again must give the JAX
loader every ``params/`` and ``bn/`` array back bit for bit, for the
flagship JSPSR and for CompletionFormer (its PVT cut to one block per
stage: every kind of module and bare parameter, fewer of them); the port's
forward from a JAX checkpoint matches the JAX forward at the JAX suite's
whole-model tolerance, rtol 1e-4 / atol 2e-5.
"""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jspsr_tpu.models.completionformer import (
    CompletionFormer as JaxCompletionFormer,
)
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.models.pvt import PVT as JaxPVT
from jspsr_tpu.train.checkpoint import flatten_tree
from jspsr_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from jspsr_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from jspsr_tpu.train.step import make_forward as jax_make_forward
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.models.completionformer import CompletionFormer
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.models.pvt import PVT
from jspsr_torch.train.checkpoint import (
    OPT_PREFIX,
    load_checkpoint,
    load_model_params,
    load_optimizer_state,
    load_params_filtered,
    save_checkpoint,
)
from jspsr_torch.utils.perturb import perturb_weights

torch.set_num_threads(2)

INPUTS = {"lr_dem": 1, "image": 3, "mask": 15}


def _models(family, seed):
    """(port model, its JAX twin): seeded, BatchNorm (and NLSPN) perturbed."""
    gen = torch.Generator().manual_seed(seed)
    if family == "JSPSR":
        port = JSPSR(dict(INPUTS), num_feature=8, layers=(1, 1, 1, 1),
                     generator=gen)
        jax_model = JaxJSPSR(dict(INPUTS), num_feature=8, layers=(1, 1, 1, 1))
    else:
        port = CompletionFormer(dict(INPUTS), generator=gen)
        torch.manual_seed(seed)
        port.backbone.former = PVT(in_chans=128, patch_size=2,
                                   depths=(1, 1, 1, 1))
        jax_model = JaxCompletionFormer(dict(INPUTS))
        jax_model.backbone.former = JaxPVT(in_chans=128, patch_size=2,
                                           depths=(1, 1, 1, 1))
    return perturb_weights(port, seed=seed, affine=True), jax_model


def _assert_same_tree(got, want):
    fg, fw = flatten_tree(got), flatten_tree(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        np.testing.assert_array_equal(np.asarray(fg[k]), np.asarray(fw[k]),
                                      err_msg=k)


def _stepped_adamw(model):
    """AdamW after one step on a made-up loss: non-trivial state."""
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    loss = sum((q.float() ** 2).sum() for q in model.parameters()
               if q.requires_grad)
    loss.backward()
    opt.step()
    return opt


@pytest.mark.parametrize("family", ["JSPSR", "CompletionFormer"])
def test_jax_port_jax_round_trip_is_bit_equal(family, tmp_path):
    port, jax_model = _models(family, seed=3)
    params, bn = import_torch_state_dict(jax_model, port.state_dict())
    jax_save_checkpoint(tmp_path / "jax.npz", params, bn, epoch=4,
                        best_result={"RMSE": 1.25})

    fresh, _ = _models(family, seed=5)
    opt = _stepped_adamw(fresh)  # before the load, which sets the weights
    load_model_params(fresh, tmp_path / "jax.npz")
    save_checkpoint(tmp_path / "port.npz", fresh, opt, epoch=4,
                    best_result={"RMSE": 1.25}, extra={"global_step": 9})

    flat, meta = load_checkpoint(tmp_path / "port.npz")
    assert not any(k.startswith("opt/") for k in flat)
    assert any(k.startswith(OPT_PREFIX) for k in flat)
    assert (meta["epoch"], meta["best_result"], meta["global_step"]) == \
        (4, {"RMSE": 1.25}, 9)
    # the JAX loader, asked for an optimizer state, reads none from the
    # port's file (it takes optax leaves under opt/ by position)
    template = optax.adamw(1e-3).init(params)
    back = jax_load_checkpoint(tmp_path / "port.npz", template)
    assert back["opt_state"] is None
    assert (back["epoch"], back["best_result"]) == (4, {"RMSE": 1.25})
    _assert_same_tree(back["params"], params)
    _assert_same_tree(back["bn_state"], bn)


def test_optimizer_state_round_trip(tmp_path):
    """The port's optimizer state comes back by parameter name, bit for
    bit, into a fresh optimizer of a fresh model."""
    port, _ = _models("JSPSR", seed=1)
    opt = _stepped_adamw(port)
    save_checkpoint(tmp_path / "p.npz", port, opt, epoch=0)
    fresh, _ = _models("JSPSR", seed=2)
    load_model_params(fresh, tmp_path / "p.npz")
    opt2 = torch.optim.AdamW(fresh.parameters(), lr=5.0)
    flat, meta = load_checkpoint(tmp_path / "p.npz")
    load_optimizer_state(fresh, opt2, flat, meta)
    a, b = opt.state_dict(), opt2.state_dict()
    assert a["param_groups"][0]["lr"] == b["param_groups"][0]["lr"] == 1e-3
    assert a["state"].keys() == b["state"].keys()
    for i in a["state"]:
        for k, v in a["state"][i].items():
            assert torch.equal(v, b["state"][i][k]), (i, k)
    for name, t in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], t), name


def test_port_forward_from_jax_checkpoint_matches_jax(tmp_path):
    port, jax_model = _models("JSPSR", seed=7)
    params, bn = import_torch_state_dict(jax_model, port.state_dict())
    jax_save_checkpoint(tmp_path / "jax.npz", params, bn)
    fresh, _ = _models("JSPSR", seed=8)
    load_model_params(fresh, tmp_path / "jax.npz").eval()

    rng = np.random.default_rng(0)
    inputs = [rng.uniform(0.05, 0.95, (2, 32, 32, c)).astype(np.float32)
              for c in INPUTS.values()]
    want = np.asarray(jax_make_forward(jax_model)(
        params, bn, [jnp.asarray(x) for x in inputs]))
    with torch.no_grad():
        got = fresh([torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
                     for x in inputs]).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_load_params_filtered_skips_mismatched_keys(capsys):
    port, _ = _models("JSPSR", seed=1)
    src, _ = _models("JSPSR", seed=2)
    sd = src.state_dict()
    wrong = next(k for k in sd if k.endswith("weight") and sd[k].ndim == 4)
    sd[wrong] = torch.zeros(3, 3)
    missing = next(k for k in sd if k.endswith("running_mean"))
    del sd[missing]
    merged = load_params_filtered(port, sd)
    assert "skipped 2 mismatched keys" in capsys.readouterr().out
    for k, v in merged.items():
        want = port.state_dict()[k] if k in (wrong, missing) \
            else src.state_dict()[k]
        assert torch.equal(v, want), k


def test_meta_is_json_and_save_is_atomic(tmp_path):
    port, _ = _models("JSPSR", seed=1)
    path = save_checkpoint(tmp_path / "c.npz", port, epoch=2,
                           best_result={"RMSE": np.float32(1.5)})
    assert sorted(q.name for q in tmp_path.iterdir()) == ["c.npz"]
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
    assert meta == {"epoch": 2, "best_result": {"RMSE": 1.5}}
