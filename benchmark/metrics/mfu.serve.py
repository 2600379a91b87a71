"""Percent of the configuration's peak: the eval forward's FLOPs per tile
(roofline.step_flops) times the tiles served in the traced window, over
its seconds."""

from benchmark import readers


def read(rec):
    return readers.mfu(rec, "serve", "flops_per_tile", "tiles")
