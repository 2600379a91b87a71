"""Host ms an epoch from ``train_one_epoch``'s call to its first batch in
hand (the port's ``train.epoch_start`` span), the mean over the traced
window's epochs: the epoch boundary's share of the feed wait."""


def window_epochs(rec):
    """The traced window's ``train.epoch`` units, for every train reader:
    epochs 1, 2, ... in order while their steps add up to the record's
    (epoch 0 is set-up; the profiled epoch comes after); None where the
    port records none (a tree without ``utils/tracing.py``) or they do not
    add up."""
    if rec.get("kind") != "train" or not rec.get("steps"):
        return None
    try:
        from jspsr_torch.utils import tracing
    except ImportError:
        return None
    picked, steps = [], 0
    for u in tracing.units("train.epoch"):
        if steps < rec["steps"] and u.labels.get("epoch") == len(picked) + 1:
            picked.append(u)
            steps += u.counts.get("steps", 0)
    return picked if picked and steps == rec["steps"] else None


def read(rec):
    epochs = window_epochs(rec)
    if not epochs:
        return None
    return sum(u.total_ns("train.epoch_start") for u in epochs) \
        / len(epochs) / 1e6
