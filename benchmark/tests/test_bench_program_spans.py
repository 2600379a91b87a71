"""The readers of the port's own spans (``jspsr_torch/utils/tracing.py``):
on units built by hand, the window's units picked and each number
computed; None for the other kind, for a trace-0 record and for a port
without the module; and on tiny CPU runs of both drivers, each reader's
number at least the benchmark's own span around the same calls."""

from __future__ import annotations

import sys
from collections import deque

import pytest

from benchmark import cells
from benchmark.drivers import serve as serve_drv
from benchmark.drivers import train as train_drv
from jspsr_torch.utils import tracing

TRAIN = ("epoch_start_ms.train", "steady_feed_wait_ms.train")
SERVE = ("loader_ms.serve", "input_wait_ms.serve", "output_wait_ms.serve",
         "group_dispatch_ms.serve", "scene_latency_p95_ms.serve")
MS = 1_000_000


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(tracing, "_closed", deque(maxlen=tracing.KEEP))


def read(metric, rec):
    return cells.reader(metric).read(rec)


def epoch(e, steps, start_ms, feed_ms):
    with tracing.unit("train.epoch", epoch=e) as u:
        u.count("steps", steps)
        u.add("train.epoch_start", start_ms * MS)
        for _ in range(steps):
            u.add("train.feed_wait", feed_ms * MS)


def call(scenes, groups, load_ms, wait_ms, latencies_ms):
    with tracing.unit("serve.call") as u:
        u.count("scenes", scenes)
        u.count("groups", groups)
        for _ in range(scenes):
            u.add("serve.load", load_ms * MS)
            u.add("serve.prep", 1 * MS)
            u.add("serve.wait_input", wait_ms * MS)
        for _ in range(groups):
            u.add("serve.dispatch", 2 * wait_ms * MS)
            u.add("serve.wait_output", 3 * wait_ms * MS)
        for ms in latencies_ms:
            u.sample("serve.scene", ms * MS)


def test_train_readers_take_the_window_epochs(fresh):
    epoch(0, 10, 900, 50)  # set-up
    epoch(1, 10, 1000, 2)
    epoch(2, 10, 1200, 4)
    epoch(3, 10, 5000, 90)  # the profiled epoch, after the window
    rec = {"kind": "train", "steps": 20}
    assert read("epoch_start_ms.train", rec) == pytest.approx(1100)
    # 10 + 10 waits over 20 steps less 2 epochs
    assert read("steady_feed_wait_ms.train", rec) == pytest.approx(
        (10 * 2 + 10 * 4) / 18)
    # epochs that do not add up to the record's steps: nothing
    assert read("epoch_start_ms.train", {"kind": "train",
                                         "steps": 25}) is None


def test_serve_readers_take_the_window_call(fresh):
    call(16, 2, 9, 9, [9] * 16)  # warm
    call(32, 4, 9, 9, [9] * 32)  # sizing
    call(64, 8, 30, 1, list(range(1, 65)))  # the window
    call(64, 8, 60, 5, [500] * 64)  # the profiled call, also 64 scenes
    rec = {"kind": "serve", "scenes": 64}
    assert read("loader_ms.serve", rec) == pytest.approx(31)
    assert read("input_wait_ms.serve", rec) == pytest.approx(64 * 1 / 8)
    assert read("group_dispatch_ms.serve", rec) == pytest.approx(2)
    assert read("output_wait_ms.serve", rec) == pytest.approx(3)
    assert read("scene_latency_p95_ms.serve", rec) == pytest.approx(61.75)


def test_readers_return_none_for_the_other_kind_and_trace_0(fresh):
    epoch(1, 10, 1000, 2)
    call(64, 8, 30, 1, [5, 6])
    train = {"kind": "train", "steps": 10}
    serve = {"kind": "serve", "scenes": 64}
    for metric in TRAIN:
        assert read(metric, train) is not None
        assert read(metric, serve) is None
        assert read(metric, {}) is None  # a trace-0 run's record
    for metric in SERVE:
        assert read(metric, serve) is not None
        assert read(metric, train) is None
        assert read(metric, {}) is None
    # a window call that the port did not record
    assert read("loader_ms.serve", {"kind": "serve", "scenes": 128}) is None


def test_readers_return_none_without_the_port_module(fresh, monkeypatch):
    epoch(1, 10, 1000, 2)
    call(64, 8, 30, 1, [5, 6])
    import jspsr_torch.utils

    # as on a tree without the module
    monkeypatch.delattr(jspsr_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "jspsr_torch.utils.tracing", None)
    for metric in TRAIN:
        assert read(metric, {"kind": "train", "steps": 10}) is None
    for metric in SERVE:
        assert read(metric, {"kind": "serve", "scenes": 64}) is None


def test_train_run_spans_hold_the_benchmarks_feed_wait(fresh, tiny,
                                                       tmp_path):
    r = train_drv.run(tiny("jspsr.train.b50", tmp_path, trace=True))
    rec = r.record
    start = read("epoch_start_ms.train", rec)
    steady = read("steady_feed_wait_ms.train", rec)
    epochs = r.notes["epochs"]
    # the port's spans enclose the benchmark's timed next of each batch
    outside = read("feed_wait_ms.train", rec) * rec["steps"]
    assert start * epochs + steady * (rec["steps"] - epochs) >= outside > 0


def test_serve_run_spans_hold_the_benchmarks_scene_load(fresh, tiny,
                                                       tmp_path):
    r = serve_drv.run(tiny("jspsr.serve.tile334", tmp_path, trace=True))
    rec = r.record
    got = {m: read(m, rec) for m in SERVE}
    assert all(v is not None and v >= 0 for v in got.values()), got
    # the port's spans enclose the benchmark's timed load and prep
    assert got["loader_ms.serve"] >= read("scene_load_ms.serve", rec) > 0
    assert got["scene_latency_p95_ms.serve"] >= got["loader_ms.serve"]
