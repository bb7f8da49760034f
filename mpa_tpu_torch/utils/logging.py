"""Experiment logging: the console, a per-experiment log file and JSONL
metrics (counterpart of ``mpa_tpu/utils/logging.py``).

``{name}.log`` gets every line with its time, ``{name}_metrics.jsonl`` one
record a call of :meth:`ExperimentLogger.metrics` (``time``, ``step``, then
the keys), both appended to, as ``mpa_tpu`` writes them. The console lines
go to standard output, where the port's trainer has always printed them
(``mpa_tpu``'s go to standard error). A logger without a directory writes
nothing at all: the data-parallel ranks other than 0 take one.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


class ExperimentLogger:
    def __init__(self, log_dir: Optional[str], name: str = "train"):
        self.log_dir = log_dir
        self.logger = logging.getLogger(f"mpa_tpu_torch.{name}.{id(self)}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False  # no second line through the root logger
        self.logger.handlers.clear()
        self._jsonl = None
        if log_dir is None:
            self.logger.addHandler(logging.NullHandler())
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f"{name}_metrics.jsonl"), "a")
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        self.logger.addHandler(fh)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter("%(message)s"))
        self.logger.addHandler(sh)

    def info(self, msg: str) -> None:
        self.logger.info(msg)

    def metrics(self, step: int, **kv) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"time": time.time(), "step": step, **kv}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        """Close the files; the logger writes nothing afterwards."""
        for handler in list(self.logger.handlers):
            handler.close()
            self.logger.removeHandler(handler)
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self) -> "ExperimentLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_logger(log_dir: Optional[str], name: str = "train") -> ExperimentLogger:
    return ExperimentLogger(log_dir, name)
