"""The port's ``save_every_steps`` (mid-epoch preemption checkpoint and its
auto-resume) and ``profile_steps``, on the CPU, as
``tests/test_trainer_e2e.py`` drives the JAX Trainer's.

A run preempted mid-epoch and relaunched in the same result dir must
reproduce the uninterrupted run exactly: parameters and buffers,
optimizer moments, epoch losses and the final eval's RMSE, every one
compared with equality (no tolerance), in the JAX test's two cases: a
crash right after a save, and one between saves (a step of work replayed).
The JAX package's ``load_checkpoint`` reads the port's preemption file:
its parameters, BatchNorm statistics and meta.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.synthetic import generate_mini_dfc30
from jspsr_torch.train.trainer import Trainer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root, train, valid = generate_mini_dfc30(
        tmp_path_factory.mktemp("preempt") / "DFC30_8m",
        train_cities=("Brest",), valid_cities=("Vannes",), n_per_city=4,
        size=64)
    return AttrDict({
        "name": "preempt_test", "dataset": "DFC30",
        "dataset_path": str(root), "resolution": 8,
        "train_set": train, "valid_set": valid,
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3},
        "relative": True, "augment": True, "patch_size": 32,
        "crop_mode": "random", "patches_per_image": 1, "workers": 2,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_name": "JSPSR",
        "model_kwargs": {"num_block": 1, "num_feature": 8, "spn": True,
                         "pretrained": False, "checkpoint": None},
        "loss": {"L1": 1, "L2": 1, "Grad": 0.1},
        "optimizer": "AdamW",
        "optimizer_kwargs": {"lr": 1e-3, "weight_decay": 1e-6,
                             "momentum": 0.9, "diff_lr": False},
        "scheduler": "WarmupStepLR",
        "scheduler_kwargs": {"max_lr": 1e-3, "step_size": 100, "gamma": 0.5,
                             "warmup_epoch": 1},
        "train_batch_size": 2, "epochs": 2, "resume": False,
        "valid_batch_size": 1, "val_interval": 1, "val_start_epoch": 1,
        "metric": {
            "PSNR": {"package": "piq", "border": 0.05, "min": -80,
                     "max": 929},
            "RMSE": {"package": "local", "border": 0.05, "min": -80,
                     "max": 929}},
        "best_metric": "RMSE", "val_border": 0.05,
        "early_stop": {"patience": None, "monitor": "val_rmse"},
        "verbose": False, "seed": 0,
    })


class _Preempted(Exception):
    """A simulated preemption."""


def _state(trainer) -> dict:
    """Every parameter and buffer, and every optimizer moment, by name."""
    out = {f"model/{k}": v.detach().clone()
           for k, v in trainer.model.state_dict().items()}
    names = {id(q): n for n, q in trainer.model.named_parameters()}
    for q, st in trainer.optimizer.state.items():
        for k, v in st.items():
            out[f"opt/{names[id(q)]}/{k}"] = torch.as_tensor(v).clone()
    return out


@pytest.mark.parametrize("save_every,batch_size,crash_step,resume_step", [
    # N=1, a crash right after the save at epoch 1 step 1: nothing to
    # replay
    (1, 2, None, 1),
    # N=2, a crash after epoch 1 step 3 (train_step call 7 at 4 steps per
    # epoch), one step past the save at step 2: the resume replays it
    (2, 1, 7, 2),
])
def test_preemption_midepoch_resume_bitexact(env, tmp_path, save_every,
                                             batch_size, crash_step,
                                             resume_step):
    """``save_every_steps: N`` and a relaunch in the same result dir
    resume a preempted run mid-epoch and reproduce the uninterrupted run:
    every parameter, buffer and optimizer moment, the epoch losses and the
    final eval's RMSE equal (no tolerance); the completed run removes its
    preemption checkpoint."""
    p = copy.deepcopy(env)
    p["save_every_steps"] = save_every
    p["train_batch_size"] = batch_size

    a = Trainer(AttrDict(p), result_dir=tmp_path / "A", device="cpu")
    out_a = a.fit(initial_eval=False)
    state_a, losses_a = _state(a), dict(a.last_epoch_losses)
    assert not a._preempt_path().exists()

    b = Trainer(AttrDict(p), result_dir=tmp_path / "B", device="cpu")
    if crash_step is None:
        save = b._save_preempt

        def crash_after_save(epoch, steps_done, loss_sums, n_samples):
            save(epoch, steps_done, loss_sums, n_samples)
            if epoch == 1 and steps_done == 1:
                raise _Preempted

        b._save_preempt = crash_after_save
    else:
        step, calls = b.train_step, {"n": 0}

        def crashing_step(inputs, gt):
            out = step(inputs, gt)
            calls["n"] += 1
            if calls["n"] == crash_step:
                raise _Preempted
            return out

        b.train_step = crashing_step
    with pytest.raises(_Preempted):
        b.fit(initial_eval=False)
    assert b._preempt_path().exists()

    # the same command again in the same result dir; the initial eval and
    # a resume from an older checkpoint are skipped
    c = Trainer(AttrDict(p), result_dir=tmp_path / "B", device="cpu")
    assert c.start_epoch == 1 and c._mid_resume[1] == resume_step
    c.load(tmp_path / "never.npz", resume=True)
    evals = []
    evaluate = c.evaluate
    c.evaluate = lambda *args, **kw: evals.append(kw) or evaluate(*args,
                                                                   **kw)
    out_c = c.fit(initial_eval=True)
    assert all(not kw.get("compare_input") for kw in evals)
    state_c = _state(c)
    assert state_a.keys() == state_c.keys()
    unequal = [k for k in state_a if not torch.equal(state_a[k], state_c[k])]
    assert not unequal, unequal[:8]
    assert c.global_step == a.global_step
    for k, v in losses_a.items():
        assert c.last_epoch_losses[k] == v, (k, c.last_epoch_losses[k], v)
    assert out_c["result"]["RMSE"] == out_a["result"]["RMSE"]
    assert not c._preempt_path().exists()


def test_jax_reads_the_port_preemption_checkpoint(env, tmp_path):
    """The JAX package's ``load_checkpoint`` reads the port's
    ``_preempt_*.npz``: its parameters and BatchNorm statistics are the
    port's weights carried by the JAX importer, bit for bit, and its meta
    holds the epoch, the step in the epoch, the samples, the partial loss
    sums and the global step."""
    p = copy.deepcopy(env)
    p["save_every_steps"] = 1
    t = Trainer(AttrDict(p), result_dir=tmp_path, device="cpu")
    t.train_one_epoch(0)
    ck = jax_load_checkpoint(t._preempt_path())
    meta = ck["meta"]
    steps = len(t.train_loader)
    assert ck["epoch"] == 0 and meta["step_in_epoch"] == steps
    assert meta["global_step"] == t.global_step == steps
    assert meta["n_samples"] == steps * p.train_batch_size
    for k, v in t.last_epoch_losses.items():
        assert np.float32(meta["loss_sums"][k] / meta["n_samples"]) \
            == np.float32(v)
    jax_model = JaxJSPSR({"lr_dem": 1, "image": 3}, num_feature=8,
                         layers=(1, 1, 1, 1), spn=True)
    params, bn = import_torch_state_dict(jax_model, t.model.state_dict())
    for want, got in ((params, ck["params"]), (bn, ck["bn_state"])):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]),
                                          np.asarray(leaf))


def test_profile_steps_writes_trace(env, tmp_path):
    """``profile_steps: 2`` writes a ``torch.profiler`` trace of the first
    two train steps under ``<result_dir>/profile``; on the CPU it names the
    deformable op the SPN head runs."""
    p = AttrDict({**env, "epochs": 1, "profile_steps": 2, "val_interval": 99,
                  "name": "profile_test"})
    Trainer(p, result_dir=tmp_path / "run", device="cpu").fit(
        initial_eval=False)
    traces = list((tmp_path / "run" / "profile").glob("*.json"))
    assert len(traces) == 1
    assert "jspsr::deform_conv2d" in traces[0].read_text()
