"""Run one cell of the benchmark once, on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (``workloads/<cell>.json``) names
its configuration, traffic and driver; the driver sets up, measures for
``--seconds`` and checks the window's output against the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, each read by
``metrics/<metric>.py``, and ``breakdown``), ``device`` and, last,
``compared``: each number that decided ``correct`` with its limit, also
printed as the last lines of standard error.

A run without a CUDA card, or with fewer cards than the cell asks for,
exits with code 2 and prints no result; so does a run whose process holds
``jax``, ``jaxlib``, ``flax`` or ``jspsr_tpu`` after the window (code 3).
Scratch files go under the temporary directory (``TMPDIR``) and are
removed at the end; the port's kernels are built into its own package
directory in the checkout, once."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "jspsr_tpu")
ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    import torch

    from benchmark import cells

    man = cells.manifest()
    cell = cells.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; {power_limit()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr)
    tmp = Path(tempfile.mkdtemp(prefix="jspsr_bench_"))
    try:
        ctx = cells.Ctx.load(args.workload, seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             tmp=tmp)
        result = cells.driver(cell["driver"]).run(ctx)
        found = forbidden_modules()
        if found:
            print(f"benchmark: the process holds {found} after the window",
                  file=sys.stderr)
            return 3
        metrics = {}
        out = {}
        if args.trace:
            rec = result.record
            for m in cells.cell_metrics(man, args.workload, "per_layer"):
                v = cells.reader(m["name"]).read(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            sl = rec.get("slice") or {}
            if sl:
                out["breakdown"] = {"device_ops": sl["device_ops"],
                                    "idle_gaps": sl["idle_gaps"]}
            busy, window = sl.get("busy_s", 0.0), sl.get("span_s", 0.0)
        else:
            e2e = dict(result.end_to_end)
            e2e["setup_s"] = result.notes["window_start"] - T_START
            for m in cells.cell_metrics(man, args.workload, "end_to_end"):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        device = {"platform": "gpu", "kind": kind, "count": 1,
                  "memory_peak_bytes": int(result.memory_peak_bytes)}
        if args.trace:
            device.update(busy_s=busy, window_s=window)
        compared = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in result.compared.items()}
        notes = {k: v for k, v in result.notes.items()
                 if k != "window_start"}
        line = {"correct": result.correct, "attempted": result.attempted,
                "failed": result.failed, "metrics": metrics,
                "device": device, **out, "notes": notes,
                "compared": compared}
        for k, c in compared.items():
            print(f"compared {k}: {c['value']!r} (limit {c['limit']!r})",
                  file=sys.stderr)
        print(json.dumps(line))
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
