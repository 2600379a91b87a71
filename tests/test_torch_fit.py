"""The port's ``Trainer.fit`` end to end on the CPU, as
``tests/test_trainer_e2e.py`` drives the JAX package's: a synthetic
mini-DFC30 tree, ``fit`` with the initial eval, the best checkpoint named
with its scores, the final eval's predictions and the whole-split
summary, a validate-only reload (rtol 1e-4, the JAX test's); a resumed
run bit-equal to an uninterrupted one (no tolerance); resuming from a
JAX checkpoint with a fresh optimizer; and training and --val through
the port's CLI (--val's scores equal to fit's final eval at rtol 1e-5).
"""

import json
import sys

import numpy as np
import pytest
import torch
import yaml

from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.cli.main import main as cli_main
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.synthetic import generate_mini_dfc30
from jspsr_torch.eval.summarise import summarise_run
from jspsr_torch.train.trainer import Trainer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit")
    root, train, valid = generate_mini_dfc30(
        tmp / "DFC30_8m", train_cities=("Brest",), valid_cities=("Vannes",),
        n_per_city=4, size=48)
    return tmp, {
        "name": "fit_test", "dataset": "DFC30", "dataset_path": str(root),
        "resolution": 8, "train_set": train, "valid_set": valid,
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
    }


def test_fit_end_to_end(env, tmp_path):
    _, cfg = env
    p = AttrDict(cfg)
    trainer = Trainer(p, result_dir=tmp_path / "run", device="cpu")
    out = trainer.fit(initial_eval=True)
    assert "RMSE" in out["best_result"]
    assert np.isfinite(out["result"]["RMSE"])
    assert "input" not in out["result"]  # the final eval, as the reference
    assert "RMSE" in out["checkpoint"] and out["checkpoint"].endswith(".npz")
    run = tmp_path / "run"
    assert len([q for q in (run / "predictions").iterdir()
                if q.suffix in (".npy", ".tif")]) == len(trainer.valid_set)
    assert (run / "summary.json").exists() and (run / "summary.csv").exists()
    for prod in ("SR", "COP30", "FABDEM", "FATHOM"):
        assert np.isfinite(out["summary"]["offline"][prod]["RMSE"]), prod
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1]
    assert (run / "config.json").exists()

    # the validate-only reload gives the same numbers
    t2 = Trainer(p, result_dir=tmp_path / "run2", device="cpu")
    t2.load(out["checkpoint"], resume=False)
    r2 = t2.evaluate(save_dir=tmp_path / "run2" / "predictions")
    np.testing.assert_allclose(r2["RMSE"], out["result"]["RMSE"], rtol=1e-4)
    s2 = summarise_run(p, t2.valid_set, tmp_path / "run2" / "predictions",
                       tmp_path / "run2", plots=False)
    np.testing.assert_allclose(s2["offline"]["SR"]["RMSE"],
                               out["summary"]["offline"]["SR"]["RMSE"],
                               rtol=1e-5)


def _fit(cfg, work, epochs, resume_from=None):
    """fit for ``epochs``: (result, trainer, its parameters and buffers as
    ``finish`` starts, its epoch losses)."""
    t = Trainer(AttrDict(dict(cfg, epochs=epochs)), result_dir=work,
                device="cpu")
    if resume_from is not None:
        t.load(resume_from, resume=True)
    seen, losses, finish, epoch = {}, [], t.finish, t.train_one_epoch

    def record_epoch(e):
        out = epoch(e)
        losses.append(dict(t.last_epoch_losses))
        return out

    def snapshot_finish():
        seen.update({n: v.detach().clone() for n, v in
                     [*t.model.named_parameters(), *t.model.named_buffers()]})
        return finish()

    t.train_one_epoch, t.finish = record_epoch, snapshot_finish
    return t.fit(initial_eval=False), t, seen, losses


def test_resumed_fit_is_bit_equal(env, tmp_path):
    """2 epochs in one run against 1 epoch, then a new Trainer resumed
    from its checkpoint to epoch 2: the same weights, BatchNorm buffers,
    optimizer step, best result and epoch losses, bit for bit."""
    _, cfg = env
    _, a, state_a, losses_a = _fit(cfg, tmp_path / "A", 2)
    out_b, _, _, losses_b1 = _fit(cfg, tmp_path / "B1", 1)
    _, b, state_b, losses_b2 = _fit(cfg, tmp_path / "B2", 2,
                                    resume_from=out_b["checkpoint"])
    steps = 2 * (len(a.train_set) // cfg["train_batch_size"])
    assert b.start_epoch == 1 and b.global_step == a.global_step == steps
    assert state_a.keys() == state_b.keys()
    for n in state_a:
        assert torch.equal(state_a[n], state_b[n]), n
    assert a.best_result == b.best_result
    assert losses_a == losses_b1 + losses_b2
    opt_a, opt_b = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in opt_a["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt_b["state"][i][k]), (i, k)


def test_resume_from_a_jax_checkpoint_starts_the_optimizer_fresh(
        env, tmp_path, capsys):
    _, cfg = env
    t = Trainer(AttrDict(cfg), result_dir=tmp_path, device="cpu")
    jax_model = JaxJSPSR({"lr_dem": 1, "image": 3}, num_feature=8,
                         layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(jax_model, t.model.state_dict())
    jax_save_checkpoint(tmp_path / "jax.npz", params, bn, epoch=4,
                        best_result={"RMSE": 9.5})
    t.load(tmp_path / "jax.npz", resume=True)
    assert "optimizer starts fresh" in capsys.readouterr().out
    assert (t.start_epoch, t.best_result, t.global_step) == \
        (5, {"RMSE": 9.5}, 0)
    assert not t.optimizer.state_dict()["state"]


def _run_cli(argv):
    real = sys.stdout
    try:
        return cli_main(argv)
    finally:
        logger, sys.stdout = sys.stdout, real
        if logger is not real:
            logger.close()


def test_cli_trains_and_validates_on_the_cpu(env, tmp_path):
    _, cfg = env
    cfg_path = tmp_path / "c.yml"
    # the loader sets dataset_path to data_root/DFC30_8m
    p = dict(cfg, epochs=1, data_root=str(env[0]))
    cfg_path.write_text(yaml.safe_dump(p))
    out = _run_cli(["--config", str(cfg_path), "--device", "cpu",
                    "--result-dir", str(tmp_path / "train")])
    assert "RMSE" in out["checkpoint"]
    assert len((tmp_path / "train" / "metrics.jsonl").read_text()
               .splitlines()) == 1

    p["model_kwargs"]["checkpoint"] = out["checkpoint"]
    cfg_path.write_text(yaml.safe_dump(p))
    val = _run_cli(["--config", str(cfg_path), "--device", "cpu", "--val",
                    "--result-dir", str(tmp_path / "val")])
    for k in ("loss", "PSNR", "RMSE"):
        np.testing.assert_allclose(val[k], out["result"][k], rtol=1e-5,
                                   err_msg=k)
    assert set(val["input"]) == {"PSNR", "RMSE"}
    assert (tmp_path / "val" / "summary.json").exists()
    log = (tmp_path / "val" / "train.log").read_text()
    assert "Validation:" in log

    p["model_kwargs"]["checkpoint"] = None
    cfg_path.write_text(yaml.safe_dump(p))
    with pytest.raises(ValueError, match="requires model_kwargs.checkpoint"):
        _run_cli(["--config", str(cfg_path), "--device", "cpu", "--val",
                  "--result-dir", str(tmp_path / "val2")])
