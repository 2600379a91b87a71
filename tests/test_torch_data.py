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
from jspsr_torch.train.trainer import Trainer

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


# the raw device feed's options, which raised until their slice ported them
RAW_FEED = ("device_normalize", "pack_mask", "device_cache")
# once refused (tests/test_torch_preempt.py holds them to the JAX
# Trainer's behaviour)
TRAINER_OPTIONS = ("save_every_steps", "profile_steps")


@pytest.mark.parametrize("key", ("remat",) + TRAINER_OPTIONS + RAW_FEED + (
    "checkpoint_backend", "pretrained",
    pytest.param("distributed", marks=pytest.mark.timeout(300))))
def test_trainer_refuses_what_is_not_ported(cfg, tmp_path, key):
    """Every key is ported. ``distributed`` trains on two ranks through
    the CLI (``_two_rank_cli``). ``pretrained`` is ported, and the Trainer
    reads its file: an absent one raises. The raw
    feed's options are ported: each (on the raw feed it rides) builds a
    Trainer that trains an epoch (tests/test_torch_device_cache.py holds
    them to the host feed and to JAX). ``save_every_steps`` and
    ``profile_steps`` are ported: an epoch writes the preemption checkpoint
    or the trace. ``remat`` trains an epoch with its step recomputed
    (tests/test_torch_remat.py holds it bit-equal to the step without);
    ``checkpoint_backend: orbax`` writes the preemption checkpoint from its
    background thread (tests/test_torch_async_ckpt.py)."""
    p = dict(cfg)
    if key in ("remat", "checkpoint_backend"):
        p.update({"remat": True} if key == "remat" else
                 {key: "orbax", "save_every_steps": 1})
        t = Trainer(AttrDict(p), result_dir=tmp_path, device="cpu")
        assert np.isfinite(t.train_one_epoch(0)[0])
        if key == "checkpoint_backend":
            from jspsr_torch.train.orbax_ckpt import wait_for_checkpoint

            wait_for_checkpoint()
            assert t._preempt_path().exists() and t.last_save_ms is not None
        return
    if key in TRAINER_OPTIONS:
        p[key] = 1
        t = Trainer(AttrDict(p), result_dir=tmp_path, device="cpu")
        assert np.isfinite(t.train_one_epoch(0)[0])
        assert (t._preempt_path().exists() if key == "save_every_steps"
                else any((tmp_path / "profile").glob("*.json")))
        return
    if key in RAW_FEED:
        p.update({"device_normalize": True, key: True})
        t = Trainer(AttrDict(p), result_dir=tmp_path, device="cpu")
        assert (t.scene_cache is not None) == (key == "device_cache")
        assert np.isfinite(t.train_one_epoch(0)[0])
        return
    if key == "distributed":
        _two_rank_cli(cfg, tmp_path)
        return
    p["model_kwargs"] = dict(p["model_kwargs"],
                             pretrained=str(tmp_path / "edsr.pt"))
    with pytest.raises(FileNotFoundError, match="edsr.pt"):
        Trainer(AttrDict(p), result_dir=tmp_path, device="cpu")


def _cli_rank(rank, world, cfg_path, run_dir):
    """The port's CLI on one rank of a group (``parallel.spawn``)."""
    import sys

    from jspsr_torch.cli.main import main

    stdout = sys.stdout
    try:
        out = main(["--config", cfg_path, "--result-dir", run_dir,
                    "--device", "cpu"])
    finally:
        sys.stdout.flush()  # the CLI's tee to the rank's log
        sys.stdout = stdout
    return {"rmse": out["result"]["RMSE"]}


def _cli_config(p, tmp_path):
    """``p`` as a config file for the CLI, which reads the tree at
    ``<data_root>/DFC30_8m``, with one RMSE meter."""
    import json

    data_root = tmp_path / "data"
    data_root.mkdir()
    (data_root / "DFC30_8m").symlink_to(p["dataset_path"])
    p = dict(p, data_root=str(data_root), verbose=True, metric={
        "RMSE": {"package": "local", "min": -80, "max": 929}})
    path = tmp_path / "c.json"
    path.write_text(json.dumps(p))
    return path


def _two_rank_cli(cfg, tmp_path):
    """``distributed: true`` through the CLI on two ranks of a gloo group
    sharing a result dir: both train and evaluate; rank 0 logs to
    ``train.log`` and writes the checkpoint, rank 1 logs to
    ``train.proc1.log``."""
    from jspsr_torch.parallel.spawn import run_ranks

    path = _cli_config(dict(cfg, epochs=1, distributed=True,
                            train_batch_size=1, workers=1), tmp_path)
    run = tmp_path / "run"
    out = run_ranks(_cli_rank, 2, str(path), str(run), device="cpu",
                    timeout_s=240)
    assert out[0] == out[1] and np.isfinite(out[0]["rmse"])
    logs = {q.name: q.read_text() for q in run.glob("train*.log")}
    assert set(logs) == {"train.log", "train.proc1.log"}
    assert all("Final eval" in text for text in logs.values())
    assert len(list(run.glob("JSPSR_r8_*.npz"))) == 1
    assert {q.name for q in run.glob("metrics*.jsonl")} == {
        "metrics.jsonl", "metrics.proc1.jsonl"}


@pytest.mark.parametrize("entry", ["trainer", "cli"])
@pytest.mark.parametrize("how", ["key", "env"])
def test_distributed_is_refused(cfg, tmp_path, monkeypatch, entry, how):
    """``distributed: true`` with ``distributed_kwargs`` (a coordinator
    address, one process, rank 0), or ``JSPSR_DISTRIBUTED`` with torchrun's
    environment (``env://``), joins a one-process gloo group on the CPU
    (the JAX CLI's ``jax.distributed.initialize``) in the Trainer and in
    the CLI, which then trains in it: the step's collectives run over the
    group of one, and the CLI logs to ``train.log``."""
    import sys

    import torch.distributed as dist

    from jspsr_torch.cli import main as cli
    from jspsr_torch.parallel.spawn import free_port

    p = dict(cfg, epochs=1, metric={"RMSE": {"package": "local", "min": -80,
                                             "max": 929}})
    if how == "key":
        p.update(distributed=True, distributed_kwargs={
            "coordinator_address": f"127.0.0.1:{free_port()}",
            "num_processes": 1, "process_id": 0})
    else:
        for k, v in {"JSPSR_DISTRIBUTED": "1", "MASTER_ADDR": "127.0.0.1",
                     "MASTER_PORT": str(free_port()), "RANK": "0",
                     "WORLD_SIZE": "1"}.items():
            monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the CLI tees it
    try:
        if entry == "trainer":
            t = Trainer(AttrDict(p), result_dir=tmp_path, device="cpu")
            assert dist.get_backend() == "gloo" and t.world == 1
            assert np.isfinite(t.train_one_epoch(0)[0])
            return
        path = _cli_config(p, tmp_path)
        out = cli.main(["--config", str(path), "--result-dir",
                        str(tmp_path / "run"), "--device", "cpu"])
        sys.stdout.flush()
        assert dist.get_backend() == "gloo"
        assert np.isfinite(out["result"]["RMSE"])
        assert "E000" in (tmp_path / "run" / "train.log").read_text()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_trainer_evaluates_over_a_mesh(cfg, tmp_path):
    """``Trainer(..., mesh=)`` splits each valid batch over the mesh's
    devices (``eval/loop.py``; tests/test_torch_parallel.py holds the
    split to the JAX package's mesh): the scores of the Trainer without
    one, at tests/test_eval_batched.py:81's rtol 3e-4."""
    p = dict(cfg, valid_batch_size=2, metric={
        "RMSE": {"package": "local", "min": -80, "max": 929}})
    got = Trainer(AttrDict(p), result_dir=tmp_path / "mesh", device="cpu",
                  mesh=["cpu", "cpu"]).evaluate()
    want = Trainer(AttrDict(p), result_dir=tmp_path / "one",
                   device="cpu").evaluate()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=3e-4, err_msg=k)


@pytest.mark.parametrize("y_only", [False, True])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_ycbcr_helpers_match_jax(dtype, y_only):
    """``RGB2YCbCr``, ``rgb2ycbcr`` and ``ycbcr2rgb`` against the JAX
    package's (exact: the same numpy arithmetic)."""
    from jspsr_tpu.data import transforms as jt
    from jspsr_tpu.data.transforms import TransformCtx as JaxCtx
    from jspsr_torch.data import transforms as pt

    rng = np.random.default_rng(7)
    img = (rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
           if dtype == "uint8" else rng.uniform(0, 1, (6, 5, 3))
           .astype(np.float32))
    np.testing.assert_array_equal(pt.rgb2ycbcr(img, y_only),
                                  jt.rgb2ycbcr(img, y_only))
    ycc = jt.rgb2ycbcr(img).astype(np.float32) / 255.0
    np.testing.assert_array_equal(pt.ycbcr2rgb(ycc), jt.ycbcr2rgb(ycc))
    sample = {"image": img, "lr_dem": img[..., :1].astype(np.float32)}
    got = pt.RGB2YCbCr(y_only)(dict(sample), pt.TransformCtx())
    want = jt.RGB2YCbCr(y_only)(dict(sample), JaxCtx())
    assert set(got) == set(want) and str(pt.RGB2YCbCr(y_only)) == \
        str(jt.RGB2YCbCr(y_only))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


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


@pytest.mark.parametrize("crop,stride", [(32, None), (24, 16), (64, 64)])
def test_gen_crop_subset_matches_jax(tmp_path, crop, stride):
    """The port's copy of ``utils/geo_prep.py`` crops the windows the JAX
    function crops from one georeferenced raster: the same files, arrays
    bit-equal, profiles equal."""
    from jspsr_tpu.data.raster_io import default_profile
    from jspsr_tpu.data.raster_io import read_raster as jax_read_raster
    from jspsr_tpu.data.raster_io import write_raster as jax_write_raster
    from jspsr_tpu.utils.geo_prep import gen_crop_subset as jax_crop
    from jspsr_torch.data.raster_io import read_raster
    from jspsr_torch.utils.geo_prep import gen_crop_subset

    rng = np.random.default_rng(crop)
    big = rng.normal(size=(70, 90, 2)).astype(np.float32)
    src = tmp_path / "big.npy"
    jax_write_raster(src, big, default_profile(70, 90, 2, "float32", 1000.0,
                                               2000.0, 8.0))
    want = jax_crop(src, tmp_path / "jax", crop, stride)
    got = gen_crop_subset(src, tmp_path / "port", crop, stride)
    assert [q.name for q in got] == [q.name for q in want] and got
    for g, w in zip(got, want):
        a, pa = read_raster(g, with_profile=True)
        b, pb = jax_read_raster(w, with_profile=True)
        np.testing.assert_array_equal(a, b)
        assert pa == pb
