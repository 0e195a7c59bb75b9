"""Profiling and tracing hooks (port of vacnic_tpu/core/profiling.py).

* `trace(dir)`: a context manager around `torch.profiler` (CPU activity,
  and CUDA activity where a card is present) that writes one Chrome trace,
  `<dir>/trace.json`, when it exits (chrome://tracing or Perfetto). It
  records every thread, so the spans of `serve.CaptionService`'s batcher
  land in it beside the caller's.
* `annotate(name)`: the port's one span primitive. While a profiler
  records, a labelled range in its trace (`torch.profiler.record_function`,
  on the clock of the device activities it launches); otherwise a shared
  no-op context after one flag read, so the spans cost nothing untraced.

A profiler records the ranges of the thread that started it (and of the
threads it propagates its state to, such as autograd's); ranges opened on
another thread reach a trace only from a profiler started with
`profile_all_threads` in its experimental config, as `trace` starts it.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as autograd_profiler

TRACE_FILE = "trace.json"

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A span named `name` while a profiler records, else a no-op context.
    The flag is the Python profiler's process-wide one: it reads true on
    every thread while a profiler runs, where the C++ check reads only the
    calling thread's state."""
    if autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
