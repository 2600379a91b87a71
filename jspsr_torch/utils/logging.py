"""Stdout tee the CLI installs, the Trainer's metric log and its config dump
(copies of ``Logger``, ``MetricLogger`` and ``serialize_config`` from
``jspsr_tpu/utils/logging.py``; reference utils/logger.py)."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class Logger:
    """Tee stdout to console + a log file (reference utils/logger.py:8-43)."""

    def __init__(self, path):
        self.terminal = sys.stdout
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.log = open(path, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


class MetricLogger:
    """An append-only ``metrics.jsonl`` (one JSON object per ``log`` call:
    the step, the wall time and every numeric scalar) and, with
    ``use_tensorboard`` (the config's ``monitor_app: tensorboard``), the
    same scalars in TensorBoard when ``torch.utils.tensorboard`` imports."""

    def __init__(self, result_dir, use_tensorboard: bool = False):
        self.dir = Path(result_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "metrics.jsonl"
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir=str(self.dir / "tb"))
            except Exception as e:  # not installed, or does not import
                print(f"[metrics] TensorBoard off: {e}")
                self.tb = None

    def log(self, step: int, **scalars):
        values = {k: float(v) for k, v in scalars.items()
                  if v is not None and _is_num(v)}
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "time": time.time(),
                                **values}) + "\n")
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(k, v, step)

    def close(self):
        if self.tb is not None:
            self.tb.close()


def _is_num(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def serialize_config(p, path):
    """Dump the resolved config as JSON (reference utils/utils.py:444-465)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(p, f, indent=2, default=str)
