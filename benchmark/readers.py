"""Shared arithmetic of the per-layer readers (``metrics/<metric>.py``):
each reads the run's record and returns a number, or None where the run
recorded nothing for it (the harness then leaves the metric out).

The record: ``kind`` (the driver's), ``window_s`` (the traced window),
``spans`` (``benchmark.spans.Spans``), ``steps``, ``tiles``, ``scenes``,
``flops_per_step`` / ``flops_per_tile`` (``roofline.step_flops``),
``peak_flops`` (the configuration's) and ``slice``
(``trace.summarize`` of the profiled slice)."""

from __future__ import annotations

from benchmark import roofline


def of_kind(rec: dict, kind: str) -> bool:
    return rec.get("kind") == kind


def span_ms(rec: dict, kind: str, name: str):
    if not of_kind(rec, kind):
        return None
    return rec["spans"].mean_ms(name)


def mfu(rec: dict, kind: str, per: str, count: str):
    """Percent of the peak: FLOPs per unit x units over the window."""
    if not of_kind(rec, kind) or not rec.get(count) or not rec.get("window_s"):
        return None
    return 100.0 * rec[per] * rec[count] / (rec["window_s"]
                                            * rec["peak_flops"])


def roofline_share(rec: dict, kind: str, family: str):
    """Percent: the least time of the slice's ``family`` ops (``conv`` or
    ``deform``) from their shapes, over the device time of the kernels
    launched under them."""
    if not of_kind(rec, kind) or not rec.get("slice"):
        return None
    least = device = 0.0
    for op in rec["slice"]["ops"]:
        if family == "conv" and op["name"] in roofline.CONV_OPS:
            flops, nbytes = roofline.conv_cost(op["name"], op["dims"],
                                               op["concrete"], op["types"])
        elif family == "deform" and op["name"] in roofline.DEFORM_OPS:
            flops, nbytes = roofline.deform_cost(op["name"], op["dims"])
        else:
            continue
        least += roofline.least_seconds(flops, nbytes, rec["peak_flops"])
        device += op["device_s"]
    return 100.0 * least / device if device > 0 else None


def idle_share(rec: dict, kind: str):
    s = rec.get("slice") if of_kind(rec, kind) else None
    if not s or not s["span_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["span_s"])


def dispatch_ms(rec: dict, kind: str):
    """Host ms per step (or group) of the slice outside runtime calls."""
    s = rec.get("slice") if of_kind(rec, kind) else None
    if not s or not s.get("dispatch_s") or not rec.get("slice_steps"):
        return None
    return 1e3 * s["dispatch_s"] / rec["slice_steps"]
