"""Run logging (copied from `smilecode_tpu/utils/logging.py`): a stdout tee
to ``logfile.log`` and per-step JSON lines in ``metrics.jsonl``."""

from __future__ import annotations

import json
import os
import sys
import time


class Logger:
    """Tees stdout to ``<save_dir>/logfile.log``; `close` restores stdout
    when this logger is installed as ``sys.stdout``."""

    def __init__(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        self.terminal = sys.stdout
        self.log = open(os.path.join(save_dir, "logfile.log"), "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        if sys.stdout is self:
            sys.stdout = self.terminal
        self.log.close()


class MetricsWriter:
    """Appends one JSON object per step to ``<save_dir>/metrics.jsonl``."""

    def __init__(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def write(self, **fields):
        fields.setdefault("ts", time.time())
        self._f.write(json.dumps(fields) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
