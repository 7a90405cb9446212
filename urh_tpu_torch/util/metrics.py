"""Pipeline observability: per-stage throughput counters and profiling.

The reference has no structured tracing (SURVEY.md section 5); here
every pipeline stage can record processed samples and wall time, and
`profile_trace` wraps a region with ``torch.profiler`` (host and CUDA
activities) and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch


class StageMetrics:
    """Thread-safe samples/s counters per pipeline stage."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples = defaultdict(int)
        self._seconds = defaultdict(float)
        self._calls = defaultdict(int)

    def record(self, stage: str, num_samples: int, seconds: float):
        with self._lock:
            self._samples[stage] += int(num_samples)
            self._seconds[stage] += float(seconds)
            self._calls[stage] += 1

    @contextlib.contextmanager
    def measure(self, stage: str, num_samples: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, num_samples, time.perf_counter() - t0)

    def throughput(self, stage: str) -> float:
        """Mean samples/s for a stage (0 when nothing recorded)."""
        with self._lock:
            secs = self._seconds[stage]
            return self._samples[stage] / secs if secs > 0 else 0.0

    def report(self) -> dict:
        with self._lock:
            return {
                stage: {
                    "samples": self._samples[stage],
                    "seconds": round(self._seconds[stage], 6),
                    "calls": self._calls[stage],
                    "samples_per_second": round(
                        self._samples[stage] / self._seconds[stage], 1)
                    if self._seconds[stage] > 0 else 0.0,
                }
                for stage in self._samples
            }

    def clear(self):
        with self._lock:
            self._samples.clear()
            self._seconds.clear()
            self._calls.clear()


# process-wide default registry
metrics = StageMetrics()


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile a region with ``torch.profiler`` (the host and, where there
    is a card, CUDA activities) and write its Chrome trace to
    ``log_dir/trace.json`` (open it in chrome://tracing or Perfetto).
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
