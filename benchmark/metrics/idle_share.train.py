"""Percent of the profiled slice (a few train steps) in which no kernel,
copy or fill ran on the card."""

from benchmark import readers


def read(rec):
    return readers.idle_share(rec, "train")
