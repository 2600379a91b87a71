"""The port's own spans (``jspsr_torch/utils/tracing.py``) on the CPU:
aggregation by unit of work and the bound on what a process keeps; spans
from two threads in one unit; profiler ranges entered only while a
``torch.profiler`` runs, found by name in a CPU Chrome trace (the
server's loader and writer threads among them); the units that a tiny
``serve_scenes`` call and a two-epoch ``Trainer`` leave behind."""

import json
import sys
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.raster_io import write_raster
from jspsr_torch.data.synthetic import generate_mini_dfc30
from jspsr_torch.eval.serve import discover_scenes, serve_scenes
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.ops import conv_same, deform_cuda
from jspsr_torch.train.step import make_train_step
from jspsr_torch.train.trainer import Trainer
from jspsr_torch.utils import tracing

torch.set_num_threads(2)

SERVE_P = {
    "model_name": "JSPSR", "relative": True, "normalize": False,
    "mask_channel": None, "patch_size": 64,
    "input_data": {"lr_dem": 1, "image": 3},
    "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                      "scale_mask": True},
    "model_kwargs": {"num_feature": 8, "num_block": 1},
}
SERVE_SPANS = ("serve.load", "serve.prep", "serve.wait_input",
               "serve.dispatch", "serve.wait_output")
STEP_RANGES = ("step.forward", "step.loss", "step.backward",
               "step.optimizer")


@pytest.fixture
def fresh(monkeypatch):
    """The module's closed units as a fresh deque, for this test alone."""
    monkeypatch.setattr(tracing, "_closed", deque(maxlen=tracing.KEEP))
    return tracing


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing_scenes")
    rng = np.random.default_rng(5)
    for i in range(5):
        d = root / f"scene{i}"
        write_raster(d / "lr_dem.npy",
                     rng.uniform(10, 200, (96, 96, 1)).astype(np.float32))
        write_raster(d / "image.npy",
                     rng.integers(0, 255, (96, 96, 3)).astype(np.uint8))
    model = JSPSR({"lr_dem": 1, "image": 3}, num_feature=8,
                  layers=(1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(3)).eval()
    return model, discover_scenes(root)


class _Net(torch.nn.Module):
    """A one-conv model with the port's forward signature."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 1, 3, padding=1)

    def forward(self, x, generator=None):
        return self.conv(x)


def _serve(model, scenes, out, **kw):
    return serve_scenes(model, AttrDict(dict(SERVE_P)), scenes, out,
                        tile=64, device="cpu", **kw)


def test_spans_aggregate_count_total_and_largest(fresh):
    with fresh.unit("work", tag="a") as work:
        for ns in (5, 20, 7):
            work.add("x", ns)
        with fresh.span("timed"):  # the innermost open unit
            pass
        with fresh.unit("inner") as inner:
            with fresh.span("timed"):
                pass
            with fresh.span("timed", work):  # a unit given explicitly
                pass
        work.count("steps")
        work.count("steps", 2)
    with fresh.span("timed"):  # no unit open: nothing kept
        pass
    assert work.spans["x"] == [3, 32, 20]
    assert work.total_ns("x") == 32 and work.total_ns("missing") == 0
    assert work.spans["timed"][0] == 2 and inner.spans["timed"][0] == 1
    assert work.spans["timed"][1] >= work.spans["timed"][2] > 0
    assert work.counts == {"steps": 3} and work.labels == {"tag": "a"}
    assert fresh.units("work") == [work] and fresh.units("inner") == [inner]


def test_kept_units_and_samples_are_bounded(fresh, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SAMPLES", 10)
    made = []
    for e in range(tracing.KEEP + 5):
        with fresh.unit("train.epoch", epoch=e) as u:
            made.append(u)
        with fresh.unit("other"):
            pass
    kept = fresh.units("train.epoch")
    assert len(kept) <= tracing.KEEP
    assert kept == made[-len(kept):]  # the newest, oldest first
    with fresh.unit("serve.call") as work:
        for ns in range(1, 101):
            work.sample("serve.scene", ns)
    got = work.samples["serve.scene"]
    assert len(got) == 10 and set(got) <= set(range(1, 101))
    assert work.spans["serve.scene"] == [100, 5050, 100]


def test_spans_from_two_threads_land_in_one_unit(fresh):
    n = 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with fresh.unit("serve.call") as work:
            def record(name):
                for _ in range(n):
                    with fresh.span(name, work):
                        pass
                    with fresh.span("shared", work):
                        pass
                    work.count("items")
                    work.sample("latency", 1)

            threads = [threading.Thread(target=record, args=(f"t{i}",))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert work.spans["t0"][0] == work.spans["t1"][0] == n
    assert work.spans["shared"][0] == 2 * n
    assert work.counts["items"] == 2 * n
    assert work.spans["latency"] == [2 * n, 2 * n, 1]


def test_ranges_only_while_a_profiler_runs(fresh, scenes, tmp_path,
                                           monkeypatch):
    model, paths = scenes
    net = _Net()
    step = make_train_step(
        net, lambda pred, gt: {"Total": (pred - gt).abs().mean()},
        torch.optim.SGD(net.parameters(), lr=0.1))
    x = torch.ones(1, 1, 8, 8)
    # off the profiler no range is entered, and the spans still count
    real = torch.profiler.record_function
    entered = []

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    step(x, x)
    _serve(model, paths[:2], tmp_path / "off")
    assert entered == []
    off = fresh.units("serve.call")[-1]
    assert all(off.spans[s][0] for s in SERVE_SPANS)
    # under a profiler of every thread, each name is a range in its trace
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(
            activities=acts,
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        step(x, x)
        _serve(model, paths[:3], tmp_path / "on", scene_batch=2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    tid = {e["name"]: e.get("tid") for e in events}
    names = set(tid)
    assert set(STEP_RANGES + SERVE_SPANS) <= names, names
    assert {"serve.write", "scene.stage", "scene.run"} <= names, names
    # the loader's and the writer's threads are not the dispatching one
    assert tid["serve.load"] != tid["serve.wait_input"]
    assert tid["serve.write"] != tid["serve.wait_input"]
    # every range the port entered is in the trace (torch adds its own)
    assert set(STEP_RANGES + SERVE_SPANS) <= set(entered) <= names
    assert not torch.autograd.profiler._is_profiler_enabled


def test_serve_call_counts_every_scene_group_and_sample(fresh, scenes,
                                                        tmp_path):
    model, paths = scenes
    out, _, _ = _serve(model, paths, tmp_path / "a", scene_batch=2)
    out2, _, _ = _serve(model, paths[:3], tmp_path / "b", scene_batch=1,
                        loader_threads=2)
    assert all(q is not None for q in out + out2)
    a, b = fresh.units("serve.call")
    assert a.counts == {"scenes": 5, "groups": 3}  # 2 + 2 + a padded 1
    assert b.counts == {"scenes": 3, "groups": 3}
    for u, n, g in ((a, 5, 3), (b, 3, 3)):
        assert u.spans["serve.load"][0] == u.spans["serve.prep"][0] == n
        assert u.spans["serve.dispatch"][0] == g
        assert u.spans["serve.wait_output"][0] == g
        assert u.spans["serve.wait_input"][0] == n + 1  # and the end
        assert len(u.samples["serve.scene"]) == n
        assert u.spans["serve.scene"][0] == n
        # a scene's latency holds its load and preparation
        assert u.total_ns("serve.scene") >= (u.total_ns("serve.load")
                                             + u.total_ns("serve.prep"))


def test_trainer_epochs_are_units(fresh, tmp_path):
    root, train, valid = generate_mini_dfc30(
        tmp_path / "DFC30_8m", train_cities=("Brest",),
        valid_cities=("Vannes",), n_per_city=3, size=48)
    p = AttrDict({
        "name": "tracing_test", "dataset": "DFC30",
        "dataset_path": str(root), "resolution": 8, "train_set": train,
        "valid_set": valid, "input_data": {"lr_dem": 1, "image": 3},
        "relative": True, "augment": False, "patch_size": 32,
        "crop_mode": "random", "patches_per_image": 1, "workers": 1,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_name": "JSPSR",
        "model_kwargs": {"num_block": 1, "num_feature": 8, "spn": True,
                         "pretrained": False, "checkpoint": None},
        "loss": {"L1": 1, "L2": 1, "Grad": 0.1}, "optimizer": "AdamW",
        "optimizer_kwargs": {"lr": 1e-3, "weight_decay": 1e-6,
                             "momentum": 0.9, "diff_lr": False},
        "scheduler": "WarmupStepLR",
        "scheduler_kwargs": {"max_lr": 1e-3, "step_size": 100,
                             "gamma": 0.5, "warmup_epoch": 1},
        "train_batch_size": 2, "epochs": 2, "resume": False,
        "valid_batch_size": 1, "verbose": False, "seed": 0})
    trainer = Trainer(p, result_dir=tmp_path / "run", device="cpu")
    steps = len(trainer.train_loader)
    for epoch in range(2):
        assert np.isfinite(trainer.train_one_epoch(epoch)[0])
    got = fresh.units("train.epoch")
    assert [u.labels for u in got] == [{"epoch": 0}, {"epoch": 1}]
    assert sum(u.spans["train.epoch_start"][0] for u in got) == 2
    for u in got:
        assert u.counts == {"steps": steps}
        # each later next, the one that ends the epoch included
        assert u.spans["train.feed_wait"][0] == steps
        assert u.total_ns("train.epoch_start") > 0


def test_launch_counters_are_registered():
    assert tracing.COUNTERS["deform_cuda"] is deform_cuda.LAUNCHES
    assert tracing.COUNTERS["conv_same"] is conv_same.LAUNCHES
    assert set(deform_cuda.LAUNCHES) == set(deform_cuda.KERNELS)
    assert tracing.counters("conv_same", ()) is conv_same.LAUNCHES
