"""Every tile the Trainer stepped over the traced window's seconds: the
rate of ``train_tiles_per_s``, reported per layer in cells whose step is
launch-bound, where the host's speed swings it from run to run by more
than an end-to-end bound can hold."""

from benchmark import readers


def read(rec):
    if not readers.of_kind(rec, "train") or not rec.get("tiles") \
            or not rec.get("window_s"):
        return None
    return rec["tiles"] / rec["window_s"]
