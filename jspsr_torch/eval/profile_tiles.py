#!/usr/bin/env python3
"""Why the tiled path's fp32 forward is slower and larger per pixel than
the whole-scene forward, on one CUDA card.

    python -m jspsr_torch.eval.profile_tiles

With the flagship JSPSR (configs/jspsr_r8_img_msk.yml widths, seeded
random weights, fp32, TF32 off):

1. the eval forward at the tiled path's batch shapes (1, 9, 18, 72, 81 and
   96 tiles of 128^2) and at whole 336^2 and 1024^2 scenes: best of 3 ms
   and the allocator's peak above the resident weights, per pixel;
2. at 9 and 81 tiles, the conv layers with the largest transient
   allocations (peak minus what was allocated when the layer started: the
   layer's output plus cuDNN's workspace);
3. the forward at 9 and 81 tiles as a loop of batch-1 forwards;
4. the same forward at 9 and 81 tiles in TF32 (a different result, not
   the port's: the contrast shows what cuDNN picks for fp32);
5. the generator's 128 -> 128 3x3 conv alone at N = 1, 9 and 81 x 128^2
   and 1 x 1024^2: ms, us per pixel and transient MB, as it runs, in
   channels-last memory, with ``cudnn.benchmark`` and with
   ``cudnn.deterministic``.

One JSON line per measurement. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from jspsr_torch.eval.profile_scene import flagship_config
from jspsr_torch.models.factory import build_model
from jspsr_torch.utils.device import set_strict_fp32

SHAPES = ((1, 336), (1, 1024), (1, 128), (9, 128), (18, 128), (72, 128),
          (81, 128), (96, 128))


def measure(fn, reps: int = 3):
    """(best ms, peak MB above what was allocated before) of ``fn``."""
    with torch.inference_mode():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times), (torch.cuda.max_memory_allocated() - base) / 2**20


def model_inputs(b: int, side: int, dev) -> list:
    g = torch.Generator(device=dev).manual_seed(0)
    return [torch.rand(b, c, side, side, generator=g, device=dev)
            for c in (1, 3, 15)]


def conv_transients(model, inputs, top: int = 6) -> list:
    """[name, input shape, transient MB] of the conv layers with the
    largest transient allocations in one forward."""
    rows, hooks = [], []

    def pre(mod, _):
        torch.cuda.synchronize()
        mod.alloc_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def post(name):
        def hook(mod, inp, _):
            torch.cuda.synchronize()
            rows.append([name, list(inp[0].shape),
                         (torch.cuda.max_memory_allocated()
                          - mod.alloc_before) / 2**20])
        return hook

    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            hooks.append(mod.register_forward_pre_hook(pre))
            hooks.append(mod.register_forward_hook(post(name)))
    with torch.inference_mode():
        model(inputs)
    for h in hooks:
        h.remove()
    return sorted(rows, key=lambda r: -r[2])[:top]


def main(argv=None) -> int:
    del argv
    if not torch.cuda.is_available():
        raise SystemExit("profile_tiles: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    set_strict_fp32()
    model = build_model(flagship_config(),
                        generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    for b, side in SHAPES:
        inputs = model_inputs(b, side, dev)
        ms, peak = measure(lambda: model(inputs))
        px = b * side * side
        print(json.dumps({"forward": [b, side], "ms": ms,
                          "us_per_px": ms * 1e3 / px, "peak_mb": peak,
                          "kb_per_px": peak * 1024 / px}), flush=True)
    for b in (9, 81):
        inputs = model_inputs(b, 128, dev)
        print(json.dumps({"conv_transients": b, "top_mb": conv_transients(
            model, inputs)}), flush=True)
        ms, peak = measure(lambda: [model([x[j:j + 1] for x in inputs])
                                    for j in range(b)], reps=2)
        print(json.dumps({"batch1_loop": b, "ms": ms, "peak_mb": peak}),
              flush=True)
        torch.backends.cudnn.allow_tf32 = True
        ms, peak = measure(lambda: model(inputs))
        set_strict_fp32()
        print(json.dumps({"forward_tf32": [b, 128], "ms": ms,
                          "peak_mb": peak}), flush=True)
    w = torch.randn(128, 128, 3, 3, device=dev) * 0.03
    for n, side in ((1, 128), (9, 128), (81, 128), (1, 1024)):
        x = torch.randn(n, 128, side, side, device=dev)
        for variant in ("as_is", "channels_last", "benchmark",
                        "deterministic"):
            cl = variant == "channels_last"
            xv = x.contiguous(memory_format=torch.channels_last) if cl else x
            wv = w.contiguous(memory_format=torch.channels_last) if cl else w
            torch.backends.cudnn.benchmark = variant == "benchmark"
            torch.backends.cudnn.deterministic = variant == "deterministic"
            ms, peak = measure(lambda: F.conv2d(xv, wv, padding=1), reps=5)
            print(json.dumps({"conv_128_3x3": [n, side], "variant": variant,
                              "ms": ms,
                              "us_per_px": ms * 1e3 / (n * side * side),
                              "transient_mb": peak}), flush=True)
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
