"""Run logging (port of vacnic_tpu/core/logging.py): a stderr logger and a
JSON-lines metrics file with wandb's `log({...})` shape.

The card's machine has no wandb: `MetricsLogger(use_wandb=True)` imports it
and raises, naming the package, when it is missing (the JAX logger skips it
silently)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Mapping


def get_logger(name: str = "vacnic_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)
    return logger


class MetricsLogger:
    """One `{"_step": n, "_time": t, ...}` line per `log` call, appended to
    `<out_dir>/<run_name>.metrics.jsonl`."""

    def __init__(self, out_dir: str | None = None, run_name: str = "run",
                 use_wandb: bool = False):
        self._step = 0
        self._fh = None
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                raise ImportError("MetricsLogger(use_wandb=True) needs the 'wandb' package, "
                                  "which is not installed") from e
            self._wandb = wandb
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, f"{run_name}.metrics.jsonl"), "a")

    def log(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        step = self._step if step is None else step
        rec = {"_step": step, "_time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._wandb:
            self._wandb.log(dict(metrics), step=step)
        self._step = step + 1

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
