"""Driver ``train``: epochs of the port's ``Trainer`` back to back, as
``fit()`` runs them (without its evaluation and checkpoints).

Set-up writes the cell's DFC30 tree from the seed, builds
``Trainer(p, device="cuda")`` on the configuration with the run's seed,
loads seeded weights into its model and runs epoch 0 through
``train_one_epoch``: its first three steps are captured for the check
(each step's loss; after step 1 the first gradient's per-leaf norms from
AdamW's exp_avg; after step 3 each parameter's change), the rest warm
every shape of the cell up. The window then runs whole epochs 1, 2, ...,
each ending in the Trainer's own sync, until the next would end further
from ``--seconds`` than stopping does (at least one);
``train_tiles_per_s`` is every tile stepped over the window's seconds and
``peak_mem_mb`` the peak allocation in it.

With ``--trace 1`` the window also records the host time of each wait in
the Trainer's batch iterator (``feed_wait``); after it, one more epoch is
profiled from step ``trace_start`` for ``trace_steps`` steps.

Once the window has closed and the peak is read, the Trainer is freed and
the plain reference (``benchmark/reference``) takes the seed's weights,
rebuilds epoch 0's first three batches from the raw tree and steps them
(``compare.train_numbers``)."""

from __future__ import annotations

import gc
import time

import torch

from benchmark import compare, roofline, trace
from benchmark.cells import Result
from benchmark.reference import feed, reference_model
from benchmark.reference import precision as ref_precision
from benchmark.reference import train as ref_train
from benchmark.spans import Spans
from benchmark.traffic import generate
from benchmark.weights import seeded_state_dict

CAPTURED = 3


def build(ctx):
    """(port config, Trainer with the seed's weights)."""
    from jspsr_torch.train.trainer import Trainer

    generate.write_tree(ctx.tmp / "DFC30_8m", ctx.traffic, ctx.seed)
    p = ctx.port_config()
    trainer = Trainer(p, result_dir=ctx.tmp / "result", device=ctx.device,
                      verbose=False)
    trainer.model.load_state_dict(seeded_state_dict(
        trainer.model.state_dict(), ctx.seed, ctx.device,
        ctx.config.get("fixed_leaves")))
    return p, trainer


def capture(trainer) -> dict:
    """Wrap ``trainer.train_step`` for its next ``CAPTURED`` calls; the
    dict fills in as they run and the wrapper then takes itself out."""
    orig = trainer.train_step
    named = [(n, q) for n, q in trainer.model.named_parameters()
             if q.requires_grad]
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    cap = {"losses": [], "names": [n for n, _ in named]}

    def step(inputs, gt):
        k = len(cap["losses"])
        if k == 0:
            cap["start"] = [q.detach().clone() for _, q in named]
        out = orig(inputs, gt)
        cap["losses"].append(out["Total"].detach().clone())
        if k == 0:
            st = trainer.optimizer.state
            cap["grad"] = torch.stack([st[q]["exp_avg"].norm()
                                       for _, q in named]) / (1.0 - beta1)
        if k == CAPTURED - 1:
            cap["change"] = torch.stack([
                (q.detach() - s).norm()
                for (_, q), s in zip(named, cap.pop("start"))])
            trainer.train_step = orig
        return out

    trainer.train_step = step
    return cap


def readings(cap: dict) -> dict:
    names = cap["names"]
    return {"losses": [float(x) for x in cap["losses"]],
            "grad": dict(zip(names, cap["grad"].tolist())),
            "change": dict(zip(names, cap["change"].tolist()))}


def reference(ctx, p, tf32: bool = False, rows=None) -> dict:
    """The reference's readings of epoch 0's first three steps; ``tf32``
    computes them with TF32 on (the control), ``rows`` steps only those
    rows of each batch (a planted fault)."""
    prog = ctx.reference_program()
    model = reference_model(prog)
    model.load_state_dict(seeded_state_dict(
        model.state_dict(), ctx.seed, ctx.device,
        ctx.config.get("fixed_leaves")), assign=True)
    files = generate.tree_files(ctx.tmp / "DFC30_8m", ctx.traffic,
                                 list(prog["train_set"]))

    def batches(t):
        inputs, gt = feed.batch(files, t, int(p.train_batch_size),
                                int(ctx.seed), 0, int(p.patch_size),
                                dict(p.tensor_kwargs), ctx.device, rows)
        return feed.model_inputs(inputs, prog["model_name"]), gt

    batches.steps = CAPTURED
    with ref_precision.precision(tf32):
        return ref_train.run_steps(model, batches, prog, epoch=0,
                                   seed=int(ctx.seed), device=ctx.device)


def flops_per_step(ctx, p) -> int:
    prog = ctx.reference_program()
    b, s = int(p.train_batch_size), int(p.patch_size)
    shapes = [(b, int(c), s, s) for c in _channels(prog)]
    return roofline.step_flops(
        reference_model(prog), shapes, True,
        lambda out: ref_train.losses(out, out.detach(), prog["loss"])[
            "Total"])


def _channels(prog: dict) -> list:
    """Input channels in the loader's order: lr_dem, image, then aux."""
    data = prog.get("input_data") or {}
    out = [1]
    if data.get("image"):
        out.append(data["image"])
    out += [data[k] for k in ("mask", "canopy", "coord") if data.get(k)]
    name = prog["model_name"].lower()
    return out if name in ("jspsr", "lrru") else [out[0], sum(out[1:])]


def profiled_epoch(trainer, epoch: int, start: int, steps: int, path):
    """One epoch whose steps [start, start + steps) are profiled; returns
    ``trace.summarize`` of them."""
    orig = trainer.train_step
    state = {"i": 0, "prof": None, "out": None}

    def step(inputs, gt):
        if state["i"] == start:
            torch.cuda.synchronize()
            state["prof"] = trace.start()
        with torch.profiler.record_function("bench.train_step"):
            out = orig(inputs, gt)
        if state["i"] == start + steps - 1:
            state["out"] = trace.stop(state["prof"], path)
        state["i"] += 1
        return out

    trainer.train_step = step
    try:
        trainer.train_one_epoch(epoch)
    finally:
        trainer.train_step = orig
    return state["out"]


def window(trainer, seconds: float, cuda: bool):
    """Whole epochs 1, 2, ... of ``trainer`` until the next would end
    further from ``seconds`` than stopping does (at least one); returns
    the window's start, each epoch's end (the last after a sync), every
    step's return on the host clock and the epochs whose loss was not
    finite. ``trainer.train_step`` is the same afterwards."""
    stamps, ends, bad = [], [], 0
    step_fn = trainer.train_step
    trainer.train_step = _stamped(step_fn, stamps)
    try:
        t0 = time.perf_counter()
        while True:
            # each epoch ends in a sync (the loss sums' .cpu())
            trainer.train_one_epoch(len(ends) + 1)
            ends.append(time.perf_counter())
            loss = trainer.last_epoch_losses.get("Total", float("nan"))
            bad += 0 if loss == loss and abs(loss) != float("inf") else 1
            spent = ends[-1] - t0
            if spent + 0.5 * spent / len(ends) >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
            ends[-1] = time.perf_counter()
    finally:
        trainer.train_step = step_fn
    return t0, ends, stamps, bad


def _stamped(step_fn, stamps: list):
    """``step_fn`` that also appends the host clock at each return."""
    def step(inputs, gt):
        out = step_fn(inputs, gt)
        stamps.append(time.perf_counter())
        return out
    return step


def _epoch_notes(t0: float, ends: list, stamps: list, per_epoch: int):
    """Each window epoch's seconds, and of its steps the host ms from the
    epoch's start to the first step's return and the median and largest
    gap between returns: where a slow run lost its time."""
    epoch_s, step_ms, start = [], [], t0
    for i, end in enumerate(ends):
        st = stamps[i * per_epoch:(i + 1) * per_epoch]
        gaps = sorted(1e3 * (b - a) for a, b in zip(st, st[1:]))
        epoch_s.append(round(end - start, 4))
        step_ms.append([round(1e3 * (st[0] - start), 1) if st else None,
                        round(gaps[len(gaps) // 2], 1) if gaps else None,
                        round(gaps[-1], 1) if gaps else None])
        start = end
    return {"epoch_s": epoch_s, "step_ms": step_ms}


def run(ctx) -> Result:
    cuda = ctx.device == "cuda"
    p, trainer = build(ctx)
    cap = capture(trainer)
    trainer.train_one_epoch(0)
    if len(cap["losses"]) < CAPTURED:
        raise RuntimeError(f"epoch 0 ran {len(cap['losses'])} steps; the "
                           f"check needs {CAPTURED}")
    prog_read = readings(cap)
    spans = Spans()
    if ctx.trace:
        batches_fn = trainer._batches

        def timed_batches(epoch):
            for item in spans.timed_iter("feed_wait", batches_fn(epoch)):
                yield item

        trainer._batches = timed_batches
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps_per_epoch = len(trainer.train_loader)
    bs = int(p.train_batch_size)
    t0, ends, stamps, bad = window(trainer, ctx.seconds, cuda)
    elapsed = ends[-1] - t0
    epochs, epoch = len(ends), len(ends) + 1
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    steps = epochs * steps_per_epoch
    record = {}
    if ctx.trace:
        del trainer._batches  # the class's method again
        record = {"kind": "train", "window_s": elapsed, "spans": spans,
                  "steps": steps, "tiles": steps * bs,
                  "flops_per_step": flops_per_step(ctx, p),
                  "peak_flops": roofline.PEAK_FLOPS[ctx.config["dtype"]],
                  "slice": None, "slice_steps": ctx.cell["trace_steps"]}
        if cuda:
            cell = ctx.cell
            record["slice"] = profiled_epoch(
                trainer, epoch, cell["trace_start"], cell["trace_steps"],
                ctx.tmp / "slice.json")
    del trainer, cap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_read = reference(ctx, p)
    numbers = compare.train_numbers(prog_read, ref_read)
    limits = ctx.cell["limits"]
    return Result(
        attempted=steps, failed=bad * steps_per_epoch,
        end_to_end={"train_tiles_per_s": steps * bs / elapsed,
                    "peak_mem_mb": window_peak / 1e6},
        record=record,
        compared={k: (v, limits[k]) for k, (v, _) in numbers.items()},
        memory_peak_bytes=max(setup_peak, window_peak),
        notes={"window_start": t0, "window_s": elapsed, "epochs": epochs,
               **_epoch_notes(t0, ends, stamps, steps_per_epoch),
               "worst_leaf": {k: leaf for k, (_, leaf) in numbers.items()
                              if leaf}})
