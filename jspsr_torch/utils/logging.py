"""Stdout tee the CLI installs (copy of ``Logger`` from
``jspsr_tpu/utils/logging.py``; reference utils/logger.py)."""

from __future__ import annotations

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
