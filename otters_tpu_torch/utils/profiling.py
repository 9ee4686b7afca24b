"""Profiling integration.

The reference's observability contract is host wall-clock phase timers
surfaced in stats tables; the port keeps those (``MetaBuildStats`` /
``MetaQueryStats``) and adds optional tracing through ``torch.profiler``:
host operators and, on a CUDA device, kernel times, in a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed queries into ``log_dir``.

    >>> with otters_tpu_torch.utils.trace("otters-trace"):
    ...     store.query(q, Metric.Cosine).take(10).collect()

    Records CPU activity, and CUDA activity where a device is present, and
    writes ``trace_<pid>_<ms>.json`` (Chrome trace format: chrome://tracing
    or Perfetto) when the block ends. Yields the profiler, whose
    ``key_averages()`` sums time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        name = f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))
