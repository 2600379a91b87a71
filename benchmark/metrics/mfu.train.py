"""Percent of the configuration's peak: the train step's FLOPs
(roofline.step_flops) times the steps of the traced window, over its
seconds."""

from benchmark import readers


def read(rec):
    return readers.mfu(rec, "train", "flops_per_step", "steps")
