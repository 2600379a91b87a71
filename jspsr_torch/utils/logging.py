"""Stdout tee the CLI installs and the config dump the trainer writes
(copies of ``Logger`` and ``serialize_config`` from
``jspsr_tpu/utils/logging.py``; reference utils/logger.py)."""

from __future__ import annotations

import json
import sys
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


def serialize_config(p, path):
    """Dump the resolved config as JSON (reference utils/utils.py:444-465)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(p, f, indent=2, default=str)
