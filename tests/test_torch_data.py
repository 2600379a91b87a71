"""Data feed and trainer of the PyTorch port vs the JAX package.

On one synthetic DFC30 tree, the port's ``DFC30`` / ``build_transforms`` /
``DataLoader`` must yield the JAX package's batches bit for bit (the same
shuffle, crops, flips and scaling from the same seeds), and the port's
``Trainer.train_one_epoch`` must report the batch-weighted mean of its
steps' losses.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.data.dfc30 import DFC30 as JaxDFC30
from jspsr_tpu.data.loader import DataLoader as JaxDataLoader
from jspsr_tpu.data.loader import build_batch_inputs as jax_build_batch_inputs
from jspsr_tpu.data.transforms import build_transforms as jax_build_transforms
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.dfc30 import DFC30
from jspsr_torch.data.loader import DataLoader, build_batch_inputs
from jspsr_torch.data.synthetic import generate_mini_dfc30
from jspsr_torch.data.transforms import build_transforms
from jspsr_torch.ops import deform_cuda
from jspsr_torch.train import trainer as trainer_mod
from jspsr_torch.train.trainer import NOT_PORTED, Trainer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("DFC30_8m")
    root, train, valid = generate_mini_dfc30(
        root, train_cities=("Brest", "Caen"), valid_cities=("Vannes",),
        n_per_city=3, size=48)
    return {
        "name": "torch_data_test", "dataset": "DFC30",
        "dataset_path": str(root), "resolution": 8,
        "train_set": train, "valid_set": valid,
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3, "mask": 15},
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
        "train_batch_size": 2, "epochs": 2, "verbose": False, "seed": 0,
    }


def _loader(pkg, p, split):
    """(DFC30, build_transforms, DataLoader, build_batch_inputs) of one
    package, assembled as its Trainer assembles them."""
    dfc, tf, dl = ((DFC30, build_transforms, DataLoader) if pkg == "torch"
                   else (JaxDFC30, jax_build_transforms, JaxDataLoader))
    train_tf, eval_tf = tf(p)
    data_kwargs = {k: v for k, v in p.items() if k != "seed"}
    ds = dfc(split=split, transform=train_tf if split == "train" else eval_tf,
             seed=p["seed"], **data_kwargs)
    return dl(ds, p["train_batch_size"], shuffle=split == "train",
              drop_last=split == "train", num_workers=2, seed=p["seed"])


@pytest.mark.parametrize("split", ["train", "valid"])
def test_batches_equal_jax_bit_for_bit(cfg, split):
    port = _loader("torch", AttrDict(cfg), split)
    ref = _loader("jax", JaxAttrDict(cfg), split)
    assert len(port) == len(ref) > 1
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        n = 0
        for got, want in zip(port, ref):
            assert set(got) == set(want)
            for k in want:
                if k == "meta":
                    assert got[k] == want[k]
                else:
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            g_in, g_gt, g_base, _ = build_batch_inputs(
                got, cfg["model_name"], cfg["input_data"])
            w_in, w_gt, w_base, _ = jax_build_batch_inputs(
                want, cfg["model_name"], cfg["input_data"])
            for a, b in zip(g_in + [g_gt, g_base], w_in + [w_gt, w_base]):
                np.testing.assert_array_equal(a, b)
            n += 1
        assert n == len(ref)
    if split == "train":  # augmentation ran: some samples were flipped
        assert any(m["augmentation"]["rot90"] for b in port for m in b["meta"])


def test_train_one_epoch_loss_is_batch_weighted_mean(cfg, tmp_path):
    p = AttrDict(cfg)
    t = Trainer(p, result_dir=tmp_path / "run", device="cpu")
    assert (tmp_path / "run" / "config.json").exists()
    assert p["num_train_sample"] == 6 and p["num_val_sample"] == 3
    recorded = []
    inner = t.train_step

    def recording_step(inputs, gt):
        assert [x.shape[1] for x in inputs] == [1, 3, 15]  # NCHW
        losses = inner(inputs, gt)
        recorded.append((float(losses["Total"]), gt.shape[0]))
        return losses

    t.train_step = recording_step
    launches = dict(deform_cuda.LAUNCHES)
    epoch_loss, lr = t.train_one_epoch(0)
    assert deform_cuda.LAUNCHES == launches
    assert len(recorded) == 3
    want = sum(v * n for v, n in recorded) / sum(n for _, n in recorded)
    np.testing.assert_allclose(epoch_loss, want, rtol=1e-6)
    assert lr == pytest.approx(1e-4)  # WarmupStepLR, epoch 0 of 1 warm-up
    assert set(t.last_epoch_losses) == {"Total", "L1", "L2", "Grad"}
    assert t.last_throughput > 0
    # the synchronous staging path gives the same epoch
    t2 = Trainer(AttrDict(dict(cfg, device_prefetch=False)),
                 result_dir=tmp_path / "sync", device="cpu")
    assert t2.train_one_epoch(0)[0] == pytest.approx(epoch_loss, rel=1e-6)


@pytest.mark.parametrize("key", NOT_PORTED + ("checkpoint_backend",
                                              "pretrained"))
def test_trainer_refuses_what_is_not_ported(cfg, tmp_path, key):
    """Each option not yet ported raises; ``pretrained`` is ported now, and
    the Trainer reads its file: an absent one raises."""
    p = dict(cfg)
    error, match = NotImplementedError, "not yet ported"
    if key == "checkpoint_backend":
        p[key] = "orbax"
    elif key == "pretrained":
        p["model_kwargs"] = dict(p["model_kwargs"],
                                 pretrained=str(tmp_path / "edsr.pt"))
        error, match = FileNotFoundError, "edsr.pt"
    else:
        p[key] = 4
    with pytest.raises(error, match=match):
        Trainer(AttrDict(p), result_dir=tmp_path, device="cpu")


@pytest.mark.parametrize("method", ["fit", "evaluate", "finish"])
def test_trainer_eval_methods_are_not_yet_ported(cfg, tmp_path, method):
    """``fit``, ``evaluate`` and ``finish`` were refused until the eval loop
    and meters were ported; each now runs on the CPU: ``evaluate`` scores
    the valid split, ``finish`` saves a prediction per valid sample and
    the summary, ``fit`` does both around its epochs."""
    p = AttrDict(dict(cfg, epochs=1, metric={
        "RMSE": {"package": "local", "min": -80, "max": 929}}))
    t = Trainer(p, result_dir=tmp_path, device="cpu")
    out = getattr(t, method)()
    result = out if method == "evaluate" else out["result"]
    assert set(result) == {"loss", "RMSE"}
    assert np.isfinite(list(result.values())).all()
    if method != "evaluate":
        assert len(list((tmp_path / "predictions").iterdir())) == \
            2 * len(t.valid_set)  # a raster and its profile per sample
        assert (tmp_path / "summary.json").exists()
    if method == "fit":
        assert "RMSE" in Path(out["checkpoint"]).name
        assert t.global_step == len(t.train_set) // p.train_batch_size


def test_trainer_needs_a_card_unless_asked_for_the_cpu(cfg, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(trainer_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(AttrDict(cfg), result_dir=tmp_path)
