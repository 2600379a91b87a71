"""Percent: the least time of the profiled slice's dense convs
(aten::convolution and its backward) from their shapes, over the device
time of the kernels launched under them; train cells."""

from benchmark import readers


def read(rec):
    return readers.roofline_share(rec, "train", "conv")
