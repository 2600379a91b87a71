"""Early stopping and the eval cadence (copy of
``jspsr_tpu/train/early_stop.py``; reference train/train_utils.py:12-81,
utils/utils.py:40-77, evaluation/evaluate_utils.py:121-239).

Sign-aware, as the JAX package: ``val_psnr`` and ``val_ssim`` are higher
is better (the reference took every monitor as lower is better).
"""

from __future__ import annotations

_HIGHER_BETTER = {"val_psnr", "val_ssim"}


class EarlyStopper:
    def __init__(self, patience=None, monitor: str = "val_loss",
                 min_delta: float = 0.0):
        self.patience = patience
        self.monitor = (monitor or "val_loss").lower()
        self.min_delta = min_delta
        self.best = None
        self.counter = 0

    def metric_from(self, val_loss, eval_result, train_loss=None):
        m = self.monitor
        if m == "val_loss":
            return val_loss
        if m == "trainval_loss":
            return (val_loss + train_loss) if train_loss is not None \
                else val_loss
        if m == "val_psnr":
            return eval_result.get("PSNR")
        if m == "val_ssim":
            return eval_result.get("SSIM")
        if m == "val_rmse":
            return eval_result.get("RMSE")
        raise NotImplementedError(
            f"Undefined early-stop monitor: {self.monitor}")

    def __call__(self, metric) -> bool:
        """True when training should stop."""
        if self.patience is None or metric is None:
            return False
        better = (
            self.best is None
            or (metric > self.best + self.min_delta
                if self.monitor in _HIGHER_BETTER
                else metric < self.best - self.min_delta))
        if better:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
        return self.counter >= self.patience


class AverageMeter:
    """Running average. It takes 0-d device tensors without a host sync per
    update; reading ``val``, ``sum`` or ``avg`` brings the value back."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self._val = 0.0
        self._sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self._val = val
        self._sum = self._sum + val * n
        self.count += n

    @property
    def val(self):
        return float(self._val)

    @property
    def sum(self):
        return float(self._sum)

    @property
    def avg(self):
        return float(self._sum) / max(self.count, 1)


def validate_results(best, current, best_metric: str = "RMSE"):
    """Is ``current`` better than ``best``? RMSE lower, PSNR/SSIM higher;
    without ``best_metric`` in ``current``, its first key decides."""
    if best is None:
        return True
    key = best_metric
    if key not in current:
        key = next(iter(current))
    if key.upper() in ("PSNR", "SSIM"):
        return current[key] > best[key]
    return current[key] < best[key]


def do_eval(epoch: int, epochs: int, val_interval: int = 1,
            val_start_epoch: int = 1, warmup_epoch: int = 0) -> bool:
    """Eval cadence: every ``val_interval`` epochs from ``val_start_epoch``
    on, always the last 3 epochs, and the first epoch after the warm-up."""
    e = epoch + 1  # 1-based
    if e >= epochs - 2:
        return True
    if warmup_epoch and e == warmup_epoch + 1:
        return True
    if e < val_start_epoch:
        return False
    return e % val_interval == 0
