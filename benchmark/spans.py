"""Spans that the benchmark records around its calls into the port, in a
traced run (``--trace 1``): host-clock durations in nanoseconds by name,
kept in memory and handed to the per-layer readers with the run's
record."""

from __future__ import annotations

import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.ns = defaultdict(list)

    def add(self, name: str, ns: int) -> None:
        self.ns[name].append(int(ns))

    def timed_iter(self, name: str, iterable):
        """``iterable``, each ``next`` timed on the host clock as ``name``."""
        it = iter(iterable)
        while True:
            t0 = time.perf_counter_ns()
            try:
                item = next(it)
            except StopIteration:
                return
            self.add(name, time.perf_counter_ns() - t0)
            yield item

    def timed_call(self, name: str, fn):
        """``fn`` wrapped so that each call's host time is ``name``."""
        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, time.perf_counter_ns() - t0)
        return call

    def mean_ms(self, name: str):
        v = self.ns.get(name)
        return sum(v) / len(v) / 1e6 if v else None
