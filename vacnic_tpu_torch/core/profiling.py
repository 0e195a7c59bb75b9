"""Profiling and tracing hooks (port of vacnic_tpu/core/profiling.py).

* `trace(dir)`: a context manager around `torch.profiler` (CPU activity,
  and CUDA activity where a card is present) that writes one Chrome trace,
  `<dir>/trace.json`, when it exits (chrome://tracing or Perfetto).
* `annotate(name)`: a labelled range in that trace
  (`torch.profiler.record_function`).
* `sync(x)`: waits for the device work that produces `x`'s tensors
  (`torch.cuda.synchronize()` when any is on the card; nothing on the CPU).
* `StepTimer`: wall-clock step timing with that sync; `summary()` has the
  JAX package's keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import numpy as np
import torch

from vacnic_tpu_torch.core.tree import leaves_with_path

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    return torch.profiler.record_function(name)


def sync(x: Any) -> None:
    """Wait for the computation producing `x` (a tensor or a tree of them)."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda for _, t in leaves_with_path(x)):
        torch.cuda.synchronize()


class StepTimer:
    """Rolling step timer: `with timer.step(): ...` then `timer.summary()`."""

    def __init__(self, warmup: int = 1):
        self.times: list[float] = []
        self.warmup = warmup
        self._n = 0

    @contextlib.contextmanager
    def step(self, result: Any = None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            sync(result)
        self._n += 1
        if self._n > self.warmup:
            self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict[str, float]:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
