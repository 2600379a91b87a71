#!/usr/bin/env python3
"""K3, the deform backward with the input gradient
(``deform_cuda.deform_bwd_dx``), timed on the card at the main paths'
shapes.

    python -m jspsr_torch.scripts.bench_deform_bwd_dx [--reps N] [--shapes L,..]

For each shape of ``SHAPES`` (CompletionFormer's train batch of 16 x 128^2,
2 x 128^2, one 352^2 scene; the row slabs 2 x 64 x 128 and 8 x 64 x 128 of
128^2 images, image rows 64-127: a spatially sharded rank's) in the fp32
and the bf16-sampling mode, offsets of 1.5 px, on inputs made from a fixed
seed: the wrapper's device time (``time_ms``: median of 25, the L2 flushed
before each call), the bound on this card (``k3_bound``, on a slab
``k3_slab_bound``), autograd's backward through the ``grid_sample`` form of
the same function with ``x`` requiring grad (fp32), the device kernels of
one call, counted and timed by ``torch.profiler`` in a process of its own
(every kernel, memset and copy the call puts on the card), where the
call's d_x contributions go (``deform_cuda.dx_atomics``), and a SHA-256
digest of each output's bytes. Prints the card's name and power limit and
one JSON line per shape and mode.

It uses only ``deform_bwd_dx``, ``dx_atomics`` and the plain helpers of
the package (and ``bench_deform_fwd``'s and ``bench_deform_bwd``'s timing
and inputs), so a copy of this file placed in an earlier checkout's
``jspsr_torch/scripts/`` times that checkout's K3 the same way, on the same
inputs: equal digests of d_offset, d_mask and d_x show equal bits. Run the
two in turns in one call to compare them. ``chip_smoke.py`` takes
``k3_bound`` and ``k3_slab_bound`` from here, and runs
``kernels_per_call`` in a process of its own. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from jspsr_torch.ops import deform_cuda
from jspsr_torch.scripts.bench_deform_bwd import bwd_inputs, device_profile
from jspsr_torch.scripts.bench_deform_fwd import (
    card_line,
    card_peaks,
    deform_library,
    time_ms,
)
from jspsr_torch.utils.device import resolve_device, set_strict_fp32

# label -> (batch, image side, slab rows, y0): the whole image where the
# slab rows are the side
SHAPES = {"16x128": (16, 128, 128, 0), "2x128": (2, 128, 128, 0),
          "1x352": (1, 352, 352, 0), "slab_2x64of128": (2, 128, 64, 64),
          "slab_8x64of128": (8, 128, 64, 64)}
MODES = {"fp32": None, "bf16": "bfloat16"}
OUTPUTS = ("d_offset", "d_mask", "d_weight", "d_bias", "d_x")
# every shape's inputs are made from this seed, in either checkout
SEED = 18


def k3_bound(b, h, w, atomics, bandwidth, fp32_peak):
    """K3's least time on this card for ``b`` x ``h`` x ``w`` output
    pixels, ms, and what sets it: each input read once, each output
    written once: K2's 224 B per pixel plus d_x (4 B); weight in and
    d_weight out 36 B each; K2's ~35 operations per tap, 2 more per tap for
    the scatter's row weights, and a multiply and an add per atomic
    (``atomics`` the in-image corners)."""
    pixels = b * h * w
    nbytes = pixels * (4 + 72 + 36 + 4 + 72 + 36 + 4) + 72
    flops = pixels * (315 + 18) + 2 * atomics
    bytes_ms, ops_ms = nbytes / bandwidth * 1e3, flops / fp32_peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def k3_slab_bound(b, h, w, hs, atomics, bandwidth, fp32_peak):
    """K3's least time on a slab of ``hs`` of an image's ``h`` rows, ms,
    and what sets it: each input read once, each output written once, x
    and d_x the whole images' (4 B each per image pixel), the offsets, the
    mask, g, d_offset and d_mask the slab's (220 B per slab pixel), weight
    in and d_weight out 36 B each; K3's operations on the slab's pixels
    (``check_deform_backward_dx``'s count, ``atomics`` the slab's in-image
    corners)."""
    nbytes = b * hs * w * (72 + 36 + 4 + 72 + 36) + b * h * w * 8 + 72
    flops = b * hs * w * (315 + 18) + 2 * atomics
    bytes_ms, ops_ms = nbytes / bandwidth * 1e3, flops / fp32_peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def digests(outputs) -> dict:
    """SHA-256 of each output's bytes, by name (``OUTPUTS``)."""
    return {name: hashlib.sha256(t.detach().cpu().numpy().tobytes())
            .hexdigest() for name, t in zip(OUTPUTS, outputs)}


def seeded_inputs(b, side, hs, y0, dev):
    """``bwd_inputs`` from ``SEED``: the same tensors in any checkout."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return bwd_inputs(b, side, hs, y0, gen, dev)


def kernels_per_call(specs) -> list:
    """K3's device work per call (``device_profile``: ``{name: [count,
    device µs]}``) for each of ``specs``, ``[batch, image side, slab rows,
    y0, sample dtype]``, on seeded inputs. A side that is not a multiple of
    4 takes the copy path. Run it in a process of its own: each spec is
    profiled twice and the second kept (a process's first profile on an
    H100 once recorded 3 of its 5 kernels)."""
    dev = torch.device("cuda")
    out = []
    for b, side, hs, y0, sample_dtype in specs:
        x, offset, weight, _, mask, g = seeded_inputs(b, side, hs, y0, dev)

        def call():
            return deform_cuda.deform_bwd_dx(x, offset, weight, mask, g,
                                             sample_dtype=sample_dtype, y0=y0)

        device_profile(call)
        out.append(device_profile(call))
    return out


def kernels_per_call_child(specs) -> list:
    """``kernels_per_call`` in a fresh Python process (this module with
    ``--kernels-per-call``, from the checkout that holds it)."""
    root = Path(__file__).resolve().parents[2]
    run = subprocess.run(
        [sys.executable, "-m", "jspsr_torch.scripts.bench_deform_bwd_dx",
         "--kernels-per-call", json.dumps(specs)], capture_output=True,
        text=True, cwd=root, env={**os.environ, "PYTHONPATH": str(root)})
    if run.returncode:
        raise RuntimeError(f"K3's kernel count failed: {run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated labels of SHAPES")
    ap.add_argument("--kernels-per-call", default=None,
                    help="JSON specs: print kernels_per_call's list only")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    set_strict_fp32()
    if args.kernels_per_call is not None:
        rows = kernels_per_call(json.loads(args.kernels_per_call))
        print(json.dumps(rows), flush=True)
        return rows
    card = card_line()
    print(card, flush=True)
    _, (bandwidth, fp32_peak, _) = card_peaks(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    rows = []
    for label in args.shapes.split(","):
        b, side, hs, y0 = SHAPES[label]
        x, offset, weight, bias, mask, g = seeded_inputs(b, side, hs, y0,
                                                         dev)
        counts = deform_cuda.dx_atomics(offset, side, side, y0=y0)
        bound = (k3_bound(b, side, side, counts["corners"], bandwidth,
                          fp32_peak) if hs == side else
                 k3_slab_bound(b, side, side, hs, counts["corners"],
                               bandwidth, fp32_peak))
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, offset, weight, bias, mask)]
        out = deform_library(*leaves, y0)
        library_ms = time_ms(lambda: torch.autograd.grad(
            out, leaves, g, retain_graph=True), flush, reps=args.reps)
        del out, leaves
        for mode, sample_dtype in MODES.items():
            def call():
                return deform_cuda.deform_bwd_dx(x, offset, weight, mask, g,
                                                 sample_dtype=sample_dtype,
                                                 y0=y0)

            got = call()
            torch.cuda.synchronize()
            row = {"label": label, "shape": [b, 1, hs, side],
                   "image": [b, 1, side, side], "y0": y0, "mode": mode,
                   "card": card, "time_ms": time_ms(call, flush,
                                                    reps=args.reps),
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "library_ms": library_ms,
                   "global_atomics_per_pixel":
                       counts["global"] / (b * hs * side),
                   "digests": digests(got)}
            row["time_over_bound"] = row["time_ms"] / row["bound_ms"]
            rows.append(row)
        del x, offset, mask, g
    work = kernels_per_call_child([[*SHAPES[r["label"]], MODES[r["mode"]]]
                                   for r in rows])
    for row, kinds in zip(rows, work):
        row["kernels_per_call"] = {k: n for k, (n, _) in kinds.items()}
        row["device_us_per_call"] = {k: us for k, (_, us) in kinds.items()}
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
