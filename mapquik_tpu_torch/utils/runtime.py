"""Runtime helpers: peak host memory and a profiler trace around a phase
(counterpart of `mapquik_tpu/utils/runtime.py`)."""

from __future__ import annotations

import os
import resource
from contextlib import contextmanager

import torch


def max_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0 / 1024.0


@contextmanager
def profile_trace(trace_dir: str | None):
    """torch.profiler trace of the enclosed phase, written to
    `{trace_dir}/trace.json` (Chrome trace format: chrome://tracing or
    Perfetto). Records CPU activity, and CUDA activity when a card is present.
    No-op when trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Profiler trace written to {trace_dir}.")
