"""Spans, counts and latency samples that the port records about its own
work, by unit of work, and profiler ranges under the same names.

- ``unit(kind, **labels)`` opens a unit of work (``train.epoch`` with its
  ``epoch``, ``serve.call``). A closed unit joins the last ``KEEP`` units
  of the process, which ``units(kind)`` returns in order: the whole read
  API. A unit keeps per name the count, total and largest duration of its
  spans (``spans``: name -> [count, total ns, largest ns]), its counts
  (``counts``) and up to ``MAX_SAMPLES`` latency samples a name
  (``samples``, in ns; past that a uniform reservoir of them), so memory
  stays bounded over any number of epochs or scenes.
- ``span(name, unit=None)`` times a block on the host clock
  (``time.perf_counter_ns``) into ``unit``, or else into the innermost
  unit open in the process (none open: nothing is kept). A thread that
  serves a unit (a server's loader or writer) is handed the unit and
  passes it. While a ``torch.profiler`` runs, and only then, the span also
  enters ``torch.profiler.record_function(name)``, so that the block sits
  in the profiler's trace on the clock of the device's events.
- ``ranged(name)`` is that profiler half alone, for blocks that no metric
  reads.
- ``counters(group, names)``: the kernel-launch counters, one dict of
  counts by kernel name for each library (``COUNTERS``).

Updates to a unit take its lock; spans from several threads may land in
one unit.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from array import array
from collections import deque

import torch
from torch.autograd import profiler as _profiler

KEEP = 64  # closed units kept by the process
MAX_SAMPLES = 8192  # latency samples kept a name in a unit

COUNTERS: dict = {}
_NO_RANGE = contextlib.nullcontext()
_lock = threading.Lock()
_open: list = []  # the open units, innermost last
_closed: deque = deque(maxlen=KEEP)


def counters(group: str, names) -> dict:
    """The launch counters of ``group`` (a dict of ``names`` at 0, made
    once and registered as ``COUNTERS[group]``); the caller increments
    them in place."""
    return COUNTERS.setdefault(group, dict.fromkeys(names, 0))


class Unit:
    """One unit of work and what was recorded in it."""

    def __init__(self, kind: str, labels: dict):
        self.kind = kind
        self.labels = labels
        self.spans: dict = {}
        self.counts: dict = {}
        self.samples: dict = {}
        self._lock = threading.Lock()
        self._rng = random.Random(0)

    def add(self, name: str, ns: int) -> None:
        with self._lock:
            self._add(name, ns)

    def _add(self, name: str, ns: int) -> int:
        agg = self.spans.get(name)
        if agg is None:
            self.spans[name] = agg = [0, 0, 0]
        agg[0] += 1
        agg[1] += ns
        if ns > agg[2]:
            agg[2] = ns
        return agg[0]

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def sample(self, name: str, ns: int) -> None:
        """One latency sample of ``name``, also added to its span
        aggregate."""
        with self._lock:
            seen = self._add(name, ns)
            kept = self.samples.setdefault(name, array("q"))
            if len(kept) < MAX_SAMPLES:
                kept.append(ns)
            else:
                j = self._rng.randrange(seen)
                if j < MAX_SAMPLES:
                    kept[j] = ns

    def total_ns(self, name: str) -> int:
        agg = self.spans.get(name)
        return agg[1] if agg else 0


@contextlib.contextmanager
def unit(kind: str, **labels):
    work = Unit(kind, labels)
    with _lock:
        _open.append(work)
    try:
        yield work
    finally:
        with _lock:
            _open.remove(work)
            _closed.append(work)


def units(kind: str) -> list:
    """The closed units of ``kind``, oldest first."""
    with _lock:
        return [u for u in _closed if u.kind == kind]


def ranged(name: str):
    """``record_function(name)`` while a profiler runs; else nothing."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_RANGE


class span:
    """Time a block as ``name`` in ``unit`` (default: the innermost open
    unit); a profiler range of the same name while a profiler runs."""

    __slots__ = ("name", "unit", "_range", "_t0")

    def __init__(self, name: str, unit: Unit | None = None):
        self.name = name
        self.unit = unit

    def __enter__(self):
        if self.unit is None:
            try:
                self.unit = _open[-1]
            except IndexError:  # no unit open
                pass
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.unit is not None:
            self.unit.add(self.name, ns)
        return False
