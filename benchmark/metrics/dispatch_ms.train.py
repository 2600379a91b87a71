"""Host ms per train step of dispatching work to the card: in the
profiled slice, the time the launching threads (the step's and autograd's)
spend in host ops outside CUDA runtime calls (a full launch queue or a
sync waits inside those), per step; the profiler's per-op cost is in it."""

from benchmark import readers


def read(rec):
    return readers.dispatch_ms(rec, "train")
