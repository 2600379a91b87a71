"""Recomputation in the backward (counterpart of ``jax.checkpoint``, which
the JAX package's ``remat`` and ``remat_stages`` use).

``checkpoint(fn, *args, generators=...)`` is
``torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)``: the
activations inside ``fn`` are dropped after the forward and computed again
in the backward. Two things differ between torch and JAX there, and this
module covers both, so that a step with recomputation is the step without,
bit for bit:

- torch's BatchNorm updates its running statistics and
  ``num_batches_tracked`` in place on every train-mode forward, the
  recompute included; JAX's state is functional, so ``jax.checkpoint``
  updates it once. While a recompute runs, ``recomputing()`` is true on
  its thread, and ``jspsr_torch.nn.BatchNorm2d`` then normalises with the
  batch statistics and updates nothing.
- ``torch.utils.checkpoint`` restores the global generators for the
  recompute, not an explicit ``torch.Generator`` (the step's, which
  CompletionFormer's drop path draws from). Each of ``generators`` is set
  back to its state at the start of the forward while the recompute runs,
  then to the state it had before the recompute.

A module that holds a BatchNorm of another class (torch's own) would
update twice: ``check_recomputable`` refuses it.

Under a spatial sharding (``parallel/spatial.py``) the recompute replays
the region's collectives (halo ``all_gather``s, the pools' gathers,
BatchNorm's all-reduces): every rank builds the same graph, so every
rank replays them in one order, and the replayed BatchNorm, whose
statistics are the mesh's, again updates nothing.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.utils.checkpoint

_STATE = threading.local()


def recomputing() -> bool:
    """Whether this thread is running the recompute of a checkpointed
    region (autograd runs a CUDA backward on a thread of its own)."""
    return getattr(_STATE, "depth", 0) > 0


@contextlib.contextmanager
def _recompute(generators, states):
    saved = [g.get_state() for g in generators]
    for g, s in zip(generators, states):
        g.set_state(s)
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        yield
    finally:
        _STATE.depth -= 1
        for g, s in zip(generators, saved):
            g.set_state(s)


def checkpoint(fn, *args, generators=(), **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward; ``generators``: the explicit generators ``fn`` draws from."""
    gens = [g for g in generators if g is not None]

    def context_fn():
        # called as the forward starts: the generators' states to replay
        states = [g.get_state() for g in gens]
        return contextlib.nullcontext(), _recompute(gens, states)

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)


def check_recomputable(module: torch.nn.Module) -> None:
    """Raise if ``module`` holds a BatchNorm that would update its running
    statistics again in a recompute."""
    from jspsr_torch.nn.layers import BatchNorm2d

    foreign = [name for name, m in module.named_modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
               and m.track_running_stats and not isinstance(m, BatchNorm2d)]
    if foreign:
        raise TypeError(f"recomputation needs jspsr_torch.nn.BatchNorm2d; "
                        f"{len(foreign)} BatchNorm(s) of another class, "
                        f"e.g. {foreign[:3]}")
