"""The trace reduction and the per-layer readers on a recorded synthetic
profile (a Chrome trace as ``torch.profiler`` exports it)."""

from __future__ import annotations

import pytest

from benchmark import cells, readers, roofline, trace
from benchmark.spans import Spans

CONV = ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1"]


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def synthetic():
    """Host thread 1: a conv (0-100 us) launching kernel A (corr 1), a
    deform op (200-260) launching B (corr 2); thread 2 (autograd): a conv
    backward (300-340) launching C (corr 3). Device: A 50-150, B 250-300,
    C 350-450, a memcpy 460-470; annotation on the device ignored."""
    return {"traceEvents": [
        ev("cpu_op", "aten::convolution", 0, 100,
           **{"Input Dims": [[2, 4, 8, 8], [8, 4, 3, 3], [8], [], [], [],
                             [], [], []],
              "Concrete Inputs": CONV, "Input type": ["float"] * 3}),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 20, correlation=1),
        ev("cpu_op", "jspsr::deform_conv2d", 200, 60,
           **{"Input Dims": [[2, 1, 8, 8], [2, 18, 8, 8], [1, 1, 3, 3], [1],
                             [2, 9, 8, 8], [], [], []],
              "Concrete Inputs": [], "Input type": ["float"] * 5}),
        ev("cuda_runtime", "cudaLaunchKernel", 210, 10, correlation=2),
        ev("cpu_op", "aten::convolution_backward", 300, 40, tid=2,
           **{"Input Dims": [[2, 8, 8, 8], [2, 4, 8, 8], [8, 4, 3, 3]],
              "Concrete Inputs": ["", "", "", "[8]", "[1, 1]", "[1, 1]",
                                  "[1, 1]", "False", "[0, 0]", "1",
                                  "[True, True, False]"],
              "Input type": ["float"] * 3}),
        ev("cuda_runtime", "cudaLaunchKernel", 305, 5, tid=2, correlation=3),
        ev("kernel", "A", 50, 100, tid=7, correlation=1),
        ev("kernel", "B", 250, 50, tid=7, correlation=2),
        ev("kernel", "C", 350, 100, tid=7, correlation=3),
        ev("gpu_memcpy", "Memcpy HtoD", 460, 10, tid=7),
        ev("gpu_user_annotation", "bench.train_step", 0, 500, tid=7),
    ]}


def test_summarize_busy_span_and_attribution():
    s = trace.summarize(synthetic())
    assert s["busy_s"] == pytest.approx(260e-6)
    assert s["span_s"] == pytest.approx(500e-6)  # the annotation's end too
    assert s["kernels"] == 4
    by = {o["name"]: o["device_s"] for o in s["ops"]}
    assert by == pytest.approx({"aten::convolution": 100e-6,
                                "jspsr::deform_conv2d": 50e-6,
                                "aten::convolution_backward": 100e-6})
    # host ops outside runtime calls: (100 - 20) + (60 - 10) + (40 - 5)
    assert s["dispatch_s"] == pytest.approx(165e-6)
    assert s["device_ops"][0] == ["A", pytest.approx(100e-6)]
    # gaps: 150-250 under the deform op, 300-350 under the conv backward
    assert s["idle_gaps"][0] == ["host: jspsr::deform_conv2d",
                                 pytest.approx(100e-6)]
    assert s["idle_gaps"][1] == ["host: aten::convolution_backward",
                                 pytest.approx(50e-6)]


def test_roofline_readers_by_hand():
    s = trace.summarize(synthetic())
    rec = {"kind": "train", "slice": s, "peak_flops": 67e12,
           "slice_steps": 1}
    conv_f = 2 * (8 * 4 * 9) * (2 * 8 * 8)
    conv_b = 4 * (2 * 4 * 64 + 8 * 36 + 8 + 2 * 8 * 64)
    bwd_f, bwd_b = 2 * conv_f, 4 * (2 * 8 * 64 + 2 * 4 * 64 + 8 * 36
                                   + 2 * 4 * 64 + 8 * 36)
    least = (max(conv_f / 67e12, conv_b / 3.35e12)
             + max(bwd_f / 67e12, bwd_b / 3.35e12))
    assert readers.roofline_share(rec, "train", "conv") == pytest.approx(
        100 * least / 200e-6)
    pix = 2 * 8 * 8
    assert readers.roofline_share(rec, "train", "deform") == pytest.approx(
        100 * max(135 * pix / 67e12, 116 * pix / 3.35e12) / 50e-6)
    assert readers.idle_share(rec, "train") == pytest.approx(
        100 * (1 - 260 / 500))
    assert readers.dispatch_ms(rec, "train") == pytest.approx(0.165)
    assert readers.roofline_share(rec, "serve", "conv") is None


def test_no_device_activity_reads_nothing():
    s = trace.summarize({"traceEvents": [ev("cpu_op", "aten::add", 0, 5)]})
    rec = {"kind": "train", "slice": s, "peak_flops": 67e12,
           "slice_steps": 2}
    assert readers.idle_share(rec, "train") is None
    assert readers.roofline_share(rec, "train", "conv") is None
    assert readers.dispatch_ms(rec, "train") is None


def test_span_and_mfu_readers():
    sp = Spans()
    for ns in (2_000_000, 4_000_000):
        sp.add("feed_wait", ns)
    sp.add("scene_read", 3_000_000)
    sp.add("scene_prep", 1_000_000)
    train = {"kind": "train", "spans": sp, "steps": 10, "window_s": 2.0,
             "flops_per_step": 6.7e12, "peak_flops": 67e12}
    assert cells.reader("feed_wait_ms.train").read(train) == 3.0
    assert cells.reader("mfu.train").read(train) == pytest.approx(50.0)
    assert cells.reader("mfu.serve").read(train) is None
    rate = cells.reader("train_tiles_per_s.launch_bound")
    assert rate.read({**train, "tiles": 160}) == pytest.approx(80.0)
    assert rate.read(train) is None  # no tiles recorded
    serve = {"kind": "serve", "spans": sp, "tiles": 9, "window_s": 1.0,
             "flops_per_tile": 1e12, "peak_flops": 67e12}
    assert cells.reader("scene_load_ms.serve").read(serve) == 4.0
    assert cells.reader("mfu.serve").read(serve) == pytest.approx(
        100 * 9e12 / 67e12)
