"""Driver ``serve``: the port's pipelined tiled server over a directory of
scenes, as ``python -m jspsr_torch.cli.main --infer <dir> --tile`` runs it
(``eval/serve.serve_scenes`` with ``scene_batch`` from
``auto_scene_batch`` unless the config sets ``infer_scene_batch``, and
``infer_loader_threads`` loader threads).

Set-up writes the traffic's distinct scenes from the seed, builds the
config's model with the seed's weights on the card, serves 16 scenes to
build the runner and warm every shape, then 32 more timed, to size the
window: one call over ``n`` scene entries (the distinct scenes cycled, each
entry a link of its own so that every answer is a file of its own), ``n``
the multiple of the number of distinct scenes nearest to ``--seconds``
times the warm rate. ``serve_scenes_per_s`` is the scenes written over the
call's seconds, from the call until its last output is written;
``peak_mem_mb`` the peak allocation in it.

With ``--trace 1`` the window also records the host time of each
``load_scene`` and ``prepare_scene`` in the loader stage; after it, one
more call is profiled from its group ``trace_start`` for ``trace_steps``
groups (batches of ``scene_batch`` scenes).

Once the window has closed and the peak is read, the model is freed and
the plain reference (``reference/serve.py``) recomputes a sample of
``check_scenes`` of the window's scenes, drawn from the seed, from their
raw rasters."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import roofline, trace
from benchmark.cells import Result
from benchmark.reference import precision as ref_precision
from benchmark.reference import reference_model
from benchmark.reference import serve as ref_serve
from benchmark.spans import Spans
from benchmark.traffic import generate
from benchmark.weights import seeded_state_dict

WARM, SIZING = 16, 32


def build(ctx):
    """(port config, the distinct scene dirs, the model with the seed's
    weights on the device)."""
    from jspsr_torch.models.factory import build_model

    dirs = generate.write_scenes(ctx.tmp / "scenes", ctx.traffic, ctx.seed)
    p = ctx.port_config()
    model = build_model(p).to(ctx.device)
    model.load_state_dict(seeded_state_dict(
        model.state_dict(), ctx.seed, ctx.device,
        ctx.config.get("fixed_leaves")))
    return p, dirs, model


def entries(ctx, dirs: list, tag: str, n: int) -> list:
    """``n`` scene entries cycling through ``dirs``, each a link of its own
    under ``<tmp>/<tag>``."""
    root = ctx.tmp / tag
    root.mkdir()
    out = []
    for i in range(n):
        link = root / f"q{i:05d}"
        link.symlink_to(dirs[i % len(dirs)], target_is_directory=True)
        out.append(link)
    return out


def serve(ctx, p, model, scenes: list, out_dir):
    """One call into the server as the CLI makes it; (paths, seconds)."""
    from jspsr_torch.eval.serve import auto_scene_batch, probe_scene_hw, \
        serve_scenes

    tile = p.get("patch_size", 128)
    sb = int(p.get("infer_scene_batch") or 0) or auto_scene_batch(
        probe_scene_hw(scenes[0]), tile=tile, n_scenes=len(scenes))
    t0 = time.perf_counter()
    paths, _, _ = serve_scenes(
        model, p, scenes, out_dir, tile=tile, scene_batch=sb,
        loader_threads=int(p.get("infer_loader_threads") or 1),
        device=ctx.device)
    return paths, time.perf_counter() - t0, sb


def _patch(module, name, wrapper):
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    return orig


def profiled_call(ctx, p, model, scenes, start: int, groups: int):
    """One call whose groups [start, start + groups) are profiled."""
    import jspsr_torch.eval.scene as scene_mod

    state = {"i": 0, "prof": None, "out": None}

    def wrap(orig):
        def dispatch(*args, **kwargs):
            if state["i"] == start:
                torch.cuda.synchronize()
                state["prof"] = trace.start()
            if state["i"] == start + groups:
                state["out"] = trace.stop(state["prof"],
                                          ctx.tmp / "slice.json")
            state["i"] += 1
            with torch.profiler.record_function("bench.dispatch_group"):
                return orig(*args, **kwargs)
        return dispatch

    orig = _patch(scene_mod, "scene_dispatch_batch", wrap)
    try:
        serve(ctx, p, model, scenes, ctx.tmp / "out_slice")
    finally:
        scene_mod.scene_dispatch_batch = orig
    return state["out"]


def flops_per_tile(ctx, p) -> int:
    prog = ctx.reference_program()
    s = int(p.get("patch_size", 128))
    data = prog.get("input_data") or {}
    shapes = [(1, 1, s, s)] + [(1, int(data[k]), s, s)
                               for k in ("image", "mask") if data.get(k)]
    if prog["model_name"].lower() == "completionformer":
        shapes = [shapes[0], (1, sum(x[1] for x in shapes[1:]), s, s)]
    return roofline.step_flops(reference_model(prog), shapes, False)


def reference_rasters(ctx, p, scenes: list, tf32: bool = False,
                      drop_centre: bool = False) -> list:
    prog = ctx.reference_program()
    model = reference_model(prog)
    model.load_state_dict(seeded_state_dict(
        model.state_dict(), ctx.seed, ctx.device,
        ctx.config.get("fixed_leaves")), assign=True)
    tk = dict(p.tensor_kwargs)
    out, batch = [], int(ctx.cell.get("check_batch", 8))
    with ref_precision.precision(tf32):
        for i in range(0, len(scenes), batch):
            out += ref_serve.serve(model, [s.resolve() for s in
                                           scenes[i:i + batch]], tk,
                                   ctx.device, int(p.get("patch_size", 128)),
                                   drop_centre, prog["model_name"])
    return out


def check_sample(ctx, n_window: int) -> list:
    k = min(int(ctx.cell["check_scenes"]), n_window)
    rng = np.random.default_rng(np.random.SeedSequence([int(ctx.seed), 7]))
    return sorted(rng.choice(n_window, size=k, replace=False).tolist())


def run(ctx) -> Result:
    cuda = ctx.device == "cuda"
    p, dirs, model = build(ctx)
    serve(ctx, p, model, entries(ctx, dirs, "warm", WARM), ctx.tmp / "o_w")
    _, t_size, _ = serve(ctx, p, model, entries(ctx, dirs, "size", SIZING),
                         ctx.tmp / "o_s")
    rate = SIZING / t_size
    quantum = len(dirs)
    n = max(quantum, int(round(ctx.seconds * rate / quantum)) * quantum)
    scenes = entries(ctx, dirs, "window", n)
    out_dir = ctx.tmp / "out"
    spans = Spans()
    restore = []
    if ctx.trace:
        import jspsr_torch.eval.inference as inf_mod
        import jspsr_torch.eval.scene as scene_mod

        restore = [(inf_mod, "load_scene", _patch(
            inf_mod, "load_scene",
            lambda f: spans.timed_call("scene_read", f))),
            (scene_mod, "prepare_scene", _patch(
                scene_mod, "prepare_scene",
                lambda f: spans.timed_call("scene_prep", f)))]
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paths, elapsed, sb = serve(ctx, p, model, scenes, out_dir)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    for mod, name, orig in restore:
        setattr(mod, name, orig)
    n_tiles = None
    record = {}
    if ctx.trace:
        from jspsr_torch.eval.scene import tile_grid

        side = int(ctx.traffic["side"])
        per = tile_grid(side, int(p.get("patch_size", 128)))[1] ** 2
        n_tiles = per * n
        record = {"kind": "serve", "window_s": elapsed, "spans": spans,
                  "scenes": n, "tiles": n_tiles,
                  "flops_per_tile": flops_per_tile(ctx, p),
                  "peak_flops": roofline.PEAK_FLOPS[ctx.config["dtype"]],
                  "slice": None}
        if cuda:
            start, groups = ctx.cell["trace_start"], ctx.cell["trace_steps"]
            record["slice"] = profiled_call(
                ctx, p, model,
                entries(ctx, dirs, "slice", (start + groups + 1) * sb),
                start, groups)
    del model
    from jspsr_torch.eval import scene as scene_mod

    scene_mod._RUNNER_CACHE.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = check_sample(ctx, n)
    written = [out_dir / f"{scenes[i].name}_sr.npy" for i in sample]
    missing = [w for w in written if not w.is_file()]
    have = [i for i, w in zip(sample, written) if w.is_file()]
    ref = reference_rasters(ctx, p, [scenes[i] for i in have])
    err = 0.0
    for i, r in zip(have, ref):
        got = np.load(out_dir / f"{scenes[i].name}_sr.npy")[..., 0]
        err = max(err, float(np.abs(got.astype(np.float64) - r).max()))
    not_written = sum(1 for s in scenes
                      if not (out_dir / f"{s.name}_sr.npy").is_file())
    limits = ctx.cell["limits"]
    return Result(
        attempted=n, failed=not_written,
        end_to_end={"serve_scenes_per_s": sum(x is not None for x in paths)
                    / elapsed,
                    "peak_mem_mb": window_peak / 1e6},
        record=record,
        compared={"raster_m": (err, limits["raster_m"]),
                  "missing": (float(len(missing) + not_written),
                              limits["missing"])},
        memory_peak_bytes=max(setup_peak, window_peak),
        notes={"window_start": t0, "window_s": elapsed, "scenes": n,
               "scene_batch": sb})
