"""Host ms a step waiting for the next batch within an epoch (the port's
``train.feed_wait`` span: every ``next`` after an epoch's first), over the
traced window's steps less its epochs: the feed's wait once an epoch
runs."""

from benchmark import cells


def read(rec):
    epochs = cells.reader("epoch_start_ms.train").window_epochs(rec)
    if not epochs or rec["steps"] <= len(epochs):
        return None
    return sum(u.total_ns("train.feed_wait") for u in epochs) \
        / (rec["steps"] - len(epochs)) / 1e6
