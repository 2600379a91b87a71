"""The benchmark's profiled slice: a ``torch.profiler`` trace (host ops
with their input shapes, and the card's activity) of a few steps or tile
batches, reduced to what the per-layer readers and ``breakdown`` take.

``summarize`` reads the Chrome trace that the profiler exports:

- device activity: every kernel, memcpy and memset (``cat`` ``kernel``,
  ``gpu_memcpy``, ``gpu_memset``); the profiler's user annotations on the
  device timeline are left out;
- ``busy_s``: the union of their intervals; ``span_s``: from the first to
  the last event of the slice, host or device (``idle = 1 - busy / span``);
- each kernel is put under the host op that launched it: the launch (the
  runtime call with the kernel's correlation id) lies inside the op's
  interval on the launching thread. The ops kept are the convs
  (``aten::convolution``, ``aten::convolution_backward``) and the deform
  op's three (``jspsr::deform_conv2d*``), each call with its input dims,
  concrete scalar inputs, types and the device seconds of its kernels;
- ``dispatch_s``: on each host thread that launched a kernel, the union
  of its outermost host ops' intervals less the time inside CUDA runtime
  and driver calls (where a full launch queue or a sync waits), summed
  over those threads: the host's own work of dispatching the slice,
  inflated by the profiler's per-op cost;
- ``device_ops``: the 10 kernels with the most device time, summed by name;
- ``idle_gaps``: the 10 longest gaps between device activity, each named
  by the innermost host op or annotation that was running at its middle
  (``host: none`` where none was)."""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from pathlib import Path

from benchmark.roofline import CONV_OPS, DEFORM_OPS

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
KEPT_OPS = tuple(CONV_OPS) + tuple(DEFORM_OPS)
NAME_LEN = 160


def start():
    """A started profiler of the host (with shapes) and the card."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, record_shapes=True)
    prof.start()
    return prof


def stop(prof, path) -> dict:
    """Wait for the card, stop ``prof``, export its trace to ``path``,
    summarize it and delete the file."""
    import torch

    torch.cuda.synchronize()
    prof.stop()
    path = Path(path)
    prof.export_chrome_trace(str(path))
    try:
        return summarize(json.loads(path.read_text()))
    finally:
        os.unlink(path)


def _union(intervals):
    """Merged (start, end) intervals of a list, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a: list, b: list) -> float:
    """Total length of the intersection of two merged interval lists."""
    total, j = 0.0, 0
    for x0, x1 in a:
        while j < len(b) and b[j][1] <= x0:
            j += 1
        k = j
        while k < len(b) and b[k][0] < x1:
            total += min(x1, b[k][1]) - max(x0, b[k][0])
            k += 1
    return total


def summarize(trace: dict) -> dict:
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in (e.get("args") or {})}
    if not device:
        return {"busy_s": 0.0, "span_s": 0.0, "kernels": 0, "ops": [],
                "dispatch_s": 0.0,
                "device_ops": [], "idle_gaps": []}
    ts = [e["ts"] for e in events]
    ends = [e["ts"] + e.get("dur", 0) for e in events]
    span_us = max(ends) - min(ts)
    merged = _union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in device])
    busy_us = sum(b - a for a, b in merged)

    # the kept ops per thread, sorted: they do not nest in one another
    kept = defaultdict(list)
    for e in host:
        if e.get("name") in KEPT_OPS:
            kept[e.get("tid")].append(e)
    starts = {}
    for tid, ops in kept.items():
        ops.sort(key=lambda e: e["ts"])
        starts[tid] = [e["ts"] for e in ops]
    op_time = defaultdict(float)
    by_name = defaultdict(float)
    for k in device:
        by_name[k.get("name", "?")[:NAME_LEN]] += k.get("dur", 0)
        launch = launches.get((k.get("args") or {}).get("correlation"))
        if launch is None or launch.get("tid") not in kept:
            continue
        tid = launch["tid"]
        i = bisect.bisect_right(starts[tid], launch["ts"]) - 1
        if i >= 0:
            op = kept[tid][i]
            if launch["ts"] <= op["ts"] + op.get("dur", 0):
                op_time[id(op)] += k.get("dur", 0)
    ops = []
    for tid_ops in kept.values():
        for e in tid_ops:
            a = e.get("args") or {}
            ops.append({"name": e["name"], "dims": a.get("Input Dims"),
                        "concrete": a.get("Concrete Inputs"),
                        "types": a.get("Input type"),
                        "device_s": op_time.get(id(e), 0.0) / 1e6})

    runtime_by_tid = defaultdict(list)
    for e in launches.values():
        runtime_by_tid[e.get("tid")].append(
            (e["ts"], e["ts"] + e.get("dur", 0)))
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "correlation" not in (e.get("args") or {}):
            runtime_by_tid[e.get("tid")].append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    launching = {launches[c].get("tid") for c in
                 ((k.get("args") or {}).get("correlation") for k in device)
                 if c in launches}
    dispatch_us = 0.0
    for tid in launching:
        busy = _union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in host
                      if e.get("tid") == tid and e.get("cat") == "cpu_op"])
        waits = _union(runtime_by_tid.get(tid, []))
        dispatch_us += sum(b - a for a, b in busy) - _overlap(busy, waits)

    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    named = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inside = [e for e in host
                  if e["ts"] <= mid <= e["ts"] + e.get("dur", 0)]
        best = min(inside, key=lambda e: e.get("dur", 0), default=None)
        named.append([("host: " + best["name"])[:NAME_LEN] if best
                      else "host: none", length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "span_s": span_us / 1e6,
            "kernels": len(device), "ops": ops,
            "dispatch_s": dispatch_us / 1e6,
            "device_ops": [[n, t / 1e6] for n, t in top],
            "idle_gaps": named}
