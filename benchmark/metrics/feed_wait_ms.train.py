"""Host ms per train step spent waiting in the batch iterator's next (the
Trainer's prefetching feed), over the traced window."""

from benchmark import readers


def read(rec):
    return readers.span_ms(rec, "train", "feed_wait")
