"""Percent: the least time of the profiled slice's deform op calls
(jspsr::deform_conv2d) from their shapes, over the device time under
them; serve cells."""

from benchmark import readers


def read(rec):
    return readers.roofline_share(rec, "serve", "deform")
