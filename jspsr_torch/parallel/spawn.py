"""Run a function on every rank of a fresh process group.

    results = run_ranks(fn, world, *args)               # on the card
    results = run_ranks(fn, world, *args, device="cpu")  # on the CPU

starts ``world`` Python processes (``python -m jspsr_torch.parallel.spawn``),
joins them in one process group through ``mesh.init_distributed`` (a
``tcp://127.0.0.1`` rendezvous on a free port, ``distributed_kwargs`` as a
config gives them), calls ``fn(rank, world, *args)`` in each and returns
their results in rank order. ``fn`` is a module-level function, found in
the child by its module's name or, where that does not import (a test
file), by its file. Arguments and results travel as pickles in a
temporary directory that this process made; keep them to numpy arrays and
plain values.

Every rank runs on ``device``: by default ``cuda``, the card of the rank's
local index (``mesh.local_rank``: on a host with one card every rank
shares ``cuda:0``, on a host with a card per rank each takes its own, as
``mesh.process_device`` maps it); ``cpu`` where the caller asks for it.
Each has ``backend`` (``gloo`` by default: NCCL refuses two ranks on one
GPU), one intra-op thread, and an init timeout of
``init_timeout_s``. The whole run has one deadline, ``timeout_s``: at it,
or when a rank fails, every rank still running is killed and the failure
raised with the end of each failed rank's output.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, world: int, *args, device: str = "cuda",
              backend: str = "gloo", init_timeout_s: float = 60,
              timeout_s: float = 600) -> list:
    """``fn(rank, world, *args)`` on each rank of a new ``world``-process
    group; returns the results in rank order."""
    spec = {"module": fn.__module__, "file": inspect.getfile(fn),
            "name": fn.__qualname__, "args": args, "world": world,
            "device": device, "backend": backend,
            "init_timeout_s": init_timeout_s,
            "address": f"127.0.0.1:{free_port()}"}
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [x for x in [child_env.get("PYTHONPATH")] if x])
    with tempfile.TemporaryDirectory(prefix="jspsr_ranks_") as td:
        with open(Path(td) / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        logs = [open(Path(td) / f"rank{r}.log", "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "jspsr_torch.parallel.spawn", td, str(r)],
            cwd=REPO, env=child_env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        try:
            _wait_all(procs, timeout_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            outs = []
            for log in logs:
                log.seek(0)
                outs.append(log.read())
                log.close()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("ranks {} of {} failed:\n{}".format(
                failed, world, "\n".join(
                    f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                    f"{outs[r][-6000:]}" for r in failed)))
        results = []
        for r in range(world):
            with open(Path(td) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


def _wait_all(procs, timeout_s: float) -> None:
    """Wait for every process under one deadline; stop at the first
    failure (the others would wait in a collective until their timeout)."""
    deadline = time.monotonic() + timeout_s
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes) or any(c for c in codes):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"ranks still running after {timeout_s} s")
        time.sleep(0.05)


def _resolve(spec):
    try:
        if spec["module"] == "__main__":  # the parent's script: by file
            raise ImportError(spec["file"])
        module = importlib.import_module(spec["module"])
    except ImportError:
        loader_spec = importlib.util.spec_from_file_location(
            f"_ranks_{Path(spec['file']).stem}", spec["file"])
        module = importlib.util.module_from_spec(loader_spec)
        loader_spec.loader.exec_module(module)
    obj = module
    for part in spec["name"].split("."):
        obj = getattr(obj, part)
    return obj


def _child(td: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from jspsr_torch.config.loader import AttrDict
    from jspsr_torch.parallel.mesh import init_distributed

    with open(Path(td) / "spec.pkl", "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)  # the ranks share the host's cores
    world = spec["world"]
    init_distributed(AttrDict({"distributed": True, "distributed_kwargs": {
        "coordinator_address": spec["address"], "num_processes": world,
        "process_id": rank}}), spec["device"], backend=spec["backend"],
        timeout_s=spec["init_timeout_s"])
    try:
        out = _resolve(spec)(rank, world, *spec["args"])
    finally:
        dist.destroy_process_group()
    with open(Path(td) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
