"""Percent: the least time of the profiled slice's dense convs
(aten::convolution) from their shapes, over the device time of the
kernels launched under them; serve cells."""

from benchmark import readers


def read(rec):
    return readers.roofline_share(rec, "serve", "conv")
