"""Each driver's control flow on the CPU at a tiny size (the harness's
look for a card skipped): a sound run is correct and reports its metrics;
with the timed path broken underneath, ``correct`` comes out false, once
for each fault the cell can have; the control (the reference one precision
down, TF32 emulated here, in the port's place) fails a number too."""

from __future__ import annotations

import contextlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import cells, compare
from benchmark.drivers import serve as serve_drv
from benchmark.drivers import train as train_drv

TRAIN, SERVE = "jspsr.train.b50", "jspsr.serve.tile334"


def test_train_run_is_correct_and_reports(tiny, tmp_path):
    ctx = tiny(TRAIN, tmp_path, trace=True)
    r = train_drv.run(ctx)
    # the card's limits; at this size one small leaf's change (8 elements
    # of a BatchNorm) swings more under Adam than the card's leaves do
    assert r.compared["loss"][0] <= r.compared["loss"][1], r.compared
    assert r.compared["grad"][0] <= r.compared["grad"][1], r.compared
    assert r.compared["change"][0] <= 0.1, r.compared
    assert r.attempted >= 4 and r.failed == 0
    assert set(r.end_to_end) == {"train_tiles_per_s", "peak_mem_mb"}
    assert r.end_to_end["train_tiles_per_s"] > 0
    assert cells.reader("feed_wait_ms.train").read(r.record) >= 0
    assert cells.reader("mfu.train").read(r.record) > 0
    assert cells.reader("idle_share.train").read(r.record) is None  # CPU


def test_serve_run_is_correct_and_reports(tiny, tmp_path):
    ctx = tiny(SERVE, tmp_path, trace=True)
    r = serve_drv.run(ctx)
    assert r.correct, r.compared
    assert r.attempted == 4 and r.failed == 0
    assert r.end_to_end["serve_scenes_per_s"] > 0
    assert cells.reader("scene_load_ms.serve").read(r.record) > 0
    assert cells.reader("mfu.serve").read(r.record) > 0


def _unchanged(make):
    """A step that returns its state unchanged: it runs, then puts every
    parameter back."""
    def build(model, *args, **kwargs):
        step = make(model, *args, **kwargs)

        def broken(inputs, gt):
            before = [q.detach().clone() for q in model.parameters()]
            out = step(inputs, gt)
            with torch.no_grad():
                for q, b in zip(model.parameters(), before):
                    q.copy_(b)
            return out
        return broken
    return build


def _half_batch(make):
    """Half of the batch left out, the mean taken over the rest."""
    def build(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(inputs, gt):
            h = gt.shape[0] // 2
            return step([x[:h] for x in inputs], gt[:h])
        return broken
    return build


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(tiny, tmp_path, monkeypatch, fault):
    import jspsr_torch.train.trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "make_train_step",
                        fault(trainer_mod.make_train_step))
    r = train_drv.run(tiny(TRAIN, tmp_path, program={"train_batch_size": 4},
                           traffic={"n_per_city": 2}))
    assert not r.correct, r.compared


def test_serve_altered_answer_is_not_correct(tiny, tmp_path, monkeypatch):
    import jspsr_torch.eval.scene as scene_mod

    orig = scene_mod.scene_dispatch_batch

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        out = out.clone()
        out[:, 40:60, 40:60] += 0.5  # metres, where the mosaic is made
        return out

    monkeypatch.setattr(scene_mod, "scene_dispatch_batch", altered)
    r = serve_drv.run(tiny(SERVE, tmp_path))
    assert not r.correct, r.compared


def test_serve_missing_answer_is_not_correct(tiny, tmp_path, monkeypatch):
    import jspsr_torch.data.raster_io as rio

    orig, seen = rio.write_raster, []

    def drop_one(path, *args, **kwargs):
        if "out" in str(path) and "q00001_sr" in str(path) and not seen:
            seen.append(path)
            return None
        return orig(path, *args, **kwargs)

    monkeypatch.setattr(rio, "write_raster", drop_one)
    r = serve_drv.run(tiny(SERVE, tmp_path))
    assert seen and r.failed == 1 and not r.correct


def _tf32(t):
    """float32 rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class TF32(TorchDispatchMode):
    """The operands of convs and matrix products rounded to TF32: the
    card's TF32 arithmetic, emulated on the CPU."""

    OPS = {torch.ops.aten.convolution.default,
           torch.ops.aten.convolution_backward.default,
           torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            args = [_tf32(a) if isinstance(a, torch.Tensor)
                    and a.dtype == torch.float32 else a for a in args]
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_control_is_not_correct(tiny, tmp_path, cell):
    ctx = tiny(cell, tmp_path)
    limits = ctx.cell["limits"]
    if cell == TRAIN:
        from benchmark.traffic import generate

        generate.write_tree(tmp_path / "DFC30_8m", ctx.traffic, ctx.seed)
        p = ctx.port_config()
        ref = train_drv.reference(ctx, p)
        with TF32():
            ctl = train_drv.reference(ctx, p)
        nums = {k: v for k, (v, _) in compare.train_numbers(ctl, ref)
                .items()}
    else:
        import numpy as np
        from benchmark.traffic import generate

        dirs = generate.write_scenes(tmp_path / "scenes", ctx.traffic,
                                     ctx.seed)
        p = ctx.port_config()
        ref = serve_drv.reference_rasters(ctx, p, dirs)
        with TF32():
            ctl = serve_drv.reference_rasters(ctx, p, dirs)
        nums = {"raster_m": max(float(np.abs(a - b).max())
                                for a, b in zip(ctl, ref))}
    assert any(v > limits[k] for k, v in nums.items()), (nums, limits)


class _FakeTrainer:
    """Epochs of ``steps`` calls of an instance's ``train_step``, as the
    port's Trainer makes them."""

    def __init__(self, steps):
        self.steps, self.epochs = steps, []
        self.last_epoch_losses = {}
        self.train_step = self._step

    def _step(self, inputs, gt):
        return {"Total": inputs + gt}

    def train_one_epoch(self, epoch):
        self.epochs.append(epoch)
        for i in range(self.steps):
            self.train_step(float(i), 0.0)
        self.last_epoch_losses = {"Total": 1.0}


def test_train_window_then_profiled_epoch(monkeypatch, tmp_path):
    t = _FakeTrainer(steps=3)
    step_fn = t.train_step
    t0, ends, stamps, bad = train_drv.window(t, 0.0, cuda=False)
    assert t.train_step == step_fn  # the window puts the step back
    assert t.epochs == [1] and len(ends) == 1 and len(stamps) == 3
    assert bad == 0 and t0 <= stamps[0] <= stamps[-1] <= ends[-1]
    notes = train_drv._epoch_notes(t0, ends, stamps, 3)
    assert len(notes["epoch_s"]) == 1 and len(notes["step_ms"][0]) == 3
    # then the traced run's profiled epoch drives the same step
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(train_drv.trace, "start", lambda: "prof")
    monkeypatch.setattr(train_drv.trace, "stop",
                        lambda prof, path: {"prof": prof})
    assert train_drv.profiled_epoch(t, 2, 1, 2, tmp_path / "s.json") == \
        {"prof": "prof"}
    assert t.epochs == [1, 2] and t.train_step == step_fn
