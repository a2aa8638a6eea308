"""Profiling hooks (port of decompdiff_tpu/utils/profiling.py, on
torch.profiler):

  * `start_trace()` / `stop_trace(profiler, logdir)` and the context manager
    `trace(logdir)`: a host and device trace, written as a Chrome trace
    (`<logdir>/trace.json`, viewable in Perfetto or chrome://tracing).
  * `annotate(name)`: a labelled range inside a trace
    (torch.profiler.record_function).
  * `Timer`: a named wall-clock accumulator for host phases.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Optional

import torch

TRACE_FILE = 'trace.json'


def start_trace() -> torch.profiler.profile:
    """Start tracing the host and, when CUDA is available, the device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, logdir: str) -> str:
    """Stop `prof` and write its Chrome trace into logdir; returns the
    file's path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a trace into logdir when it is set, else do nothing."""
    if not logdir:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, logdir)


def annotate(name: str):
    return torch.profiler.record_function(name)


class Timer:
    """Named wall-clock phase accumulator."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {'total_s': round(v, 4), 'count': self.counts[k],
                    'mean_ms': round(1000 * v / max(self.counts[k], 1), 3)}
                for k, v in self.totals.items()}
