"""Recomputation in the port's train step: ``remat`` (the whole forward
under one checkpoint, the JAX package's ``jax.checkpoint(fwd)``) and
JSPSR's ``remat_stages`` (each stage under its own).

A step with either is the step without, bit for bit (``torch.equal``) on
every parameter, BatchNorm buffer and ``num_batches_tracked``: BatchNorm
updates its running statistics in the first forward only, and the step's
generator replays its drop-path draws in the recompute
(``jspsr_torch/nn/remat.py``). Then the port's ``remat`` step against the
JAX package's ``remat=True`` step at the train-step tolerance of
tests/test_torch_train.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.losses import build_criterion as jax_build_criterion
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.nn import layers as jax_layers
from jspsr_tpu.train import optim as jax_optim
from jspsr_tpu.train.state import TrainState
from jspsr_tpu.train.step import make_train_step as jax_make_train_step
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.factory import build_model
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.nn import remat
from jspsr_torch.train import optim
from jspsr_torch.train.step import make_train_step, seed_step_generator
from tests.test_torch_train import (IN_CHANNELS, LOSS, LR, _batches,
                                    _check_step, _nchw, _resync, _to_jax)

torch.set_num_threads(2)

OPT_CFG = {"optimizer": "AdamW", "optimizer_kwargs": {
    "lr": LR, "weight_decay": 1e-6, "momentum": 0.9, "diff_lr": False}}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: on the CPU, the full-size CompletionFormer step
    differs from run to run with several (a parallel reduction's order),
    which would hide or fake a difference that recomputation makes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jspsr(**kw):
    return JSPSR(dict(IN_CHANNELS), num_feature=8, layers=(1, 1, 1, 1),
                 generator=torch.Generator().manual_seed(3), **kw)


def _run(model, batches, remat_step=False, accum_steps=1, seed=None):
    """Train ``model`` a step per batch from its state; returns its
    state_dict (parameters and every buffer) and the optimizer's."""
    opt = optim.build_optimizer(AttrDict(OPT_CFG), model)
    gen = None if seed is None else torch.Generator()
    step = make_train_step(model, build_criterion(LOSS), opt,
                           accum_steps=accum_steps, remat=remat_step,
                           generator=gen)
    for i, (inputs, gt) in enumerate(batches):
        seed_step_generator(gen, seed or 0, i)
        step([_nchw(x) for x in inputs], _nchw(gt))
    return model.state_dict(), opt.state_dict()


def _assert_equal_states(a, b):
    (sd_a, opt_a), (sd_b, opt_b) = a, b
    assert list(sd_a) == list(sd_b)
    differ = [k for k in sd_a if not torch.equal(sd_a[k], sd_b[k])]
    assert not differ, differ
    for idx, st in opt_a["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt_b["state"][idx][k]), (idx, k)


@pytest.mark.parametrize("remat_step,stages,accum", [
    (True, False, 1), (False, True, 1), (True, True, 2)],
    ids=["remat", "remat_stages", "both_accum2"])
def test_remat_step_is_bit_equal(remat_step, stages, accum):
    batches = _batches(2, np.random.default_rng(11))
    plain = _jspsr()
    state = {k: v.clone() for k, v in plain.state_dict().items()}
    want = _run(plain, batches, accum_steps=accum)
    model = _jspsr(remat_stages=stages)
    model.load_state_dict(state)
    got = _run(model, batches, remat_step=remat_step, accum_steps=accum)
    _assert_equal_states(got, want)
    counts = {int(v) for k, v in got[0].items()
              if k.endswith("num_batches_tracked")}
    assert counts == {2}  # one per step, not one per forward


def test_completionformer_drop_path_remat_is_bit_equal(monkeypatch):
    """CompletionFormer (its PVT cut to one block per stage, drop-path
    rates up to 0.9) with ``remat``: the recompute draws the forward's
    masks from the step's generator, so the step is the step without."""
    from jspsr_torch.models.pvt import PVT

    masks = []
    keep = PVT.drop_path_keep

    def recording_keep(self, *args):
        mask = keep(self, *args)
        if mask is not None:
            masks.append(mask.clone())
        return mask

    monkeypatch.setattr(PVT, "drop_path_keep", recording_keep)
    cfg = AttrDict({"model_name": "CompletionFormer",
                    "input_data": {"lr_dem": 1, "image": 3, "mask": 15},
                    "model_kwargs": {"prop_time": 2}})
    model = build_model(cfg)
    model.backbone.former = PVT(in_chans=128, patch_size=2,
                                depths=(1, 1, 1, 1), drop_path_rate=0.9)
    remat.check_recomputable(model)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(12)
    batches = [([rng.uniform(0.05, 0.95, (2, 32, 32, 1)).astype(np.float32),
                 rng.uniform(0.05, 0.95, (2, 32, 32, 18)).astype(np.float32)],
                rng.uniform(0.05, 0.95, (2, 32, 32, 1)).astype(np.float32))]
    want = _run(model, batches, seed=5)
    drawn, masks[:] = list(masks), []
    model.load_state_dict(state)
    got = _run(model, batches, remat_step=True, seed=5)
    assert any(float(m.min()) == 0.0 for m in drawn)  # a block was dropped
    # the forward and the recompute drew the same masks as the plain step
    assert len(masks) == 2 * len(drawn)
    for m, ref in zip(masks, drawn + drawn):
        assert torch.equal(m, ref)
    _assert_equal_states(got, want)


def test_check_recomputable_refuses_torch_batchnorm():
    """A module holding torch's own BatchNorm would update it twice."""
    with pytest.raises(TypeError, match="BatchNorm"):
        remat.check_recomputable(torch.nn.Sequential(
            torch.nn.Conv2d(1, 2, 3), torch.nn.BatchNorm2d(2)))
    remat.check_recomputable(_jspsr())


@pytest.fixture
def bn_two_pass():
    """JAX's train-mode BatchNorm in its two-pass form (ROADMAP §3
    note 5)."""
    jax_layers.set_bn_single_pass(False)
    yield
    jax_layers.set_bn_single_pass(True)


def test_remat_steps_match_jax(bn_two_pass):
    """Two steps at batch 4 (32²) of the flagship-shaped JSPSR with
    ``remat`` in both packages, each from the same state, at
    ``_check_step``'s tolerances."""
    port = _jspsr()
    jmodel = JaxJSPSR(dict(IN_CHANNELS), num_feature=8, layers=(1, 1, 1, 1))
    opt = optim.build_optimizer(AttrDict(OPT_CFG), port)
    step = make_train_step(port, build_criterion(LOSS), opt, remat=True)
    params, bn = _to_jax(jmodel, port.state_dict())
    jopt = jax_optim.build_optimizer(JaxAttrDict(OPT_CFG), params)
    jstep = jax_make_train_step(jmodel, jax_build_criterion(LOSS), jopt,
                                donate=False, remat=True)
    state = TrainState(params, bn, jopt.init(params), jnp.zeros((), jnp.int32))
    for inputs, gt in _batches(2, np.random.default_rng(13)):
        state = _resync(port, jmodel, opt, state)
        before = {n: p.detach().clone() for n, p in port.named_parameters()}
        losses = step([_nchw(x) for x in inputs], _nchw(gt))
        state, jlosses = jstep(state, [jnp.asarray(x) for x in inputs],
                               jnp.asarray(gt))
        _check_step(port, opt, before, state, losses, jlosses)
