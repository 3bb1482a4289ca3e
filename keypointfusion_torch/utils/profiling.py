"""Profiling and step-time metering (port of
keypointfusion_tpu/utils/profiling.py): torch.profiler traces in place
of jax.profiler's, and the same step timer.

    with trace('runs/trace'):
        with annotate('train_step'):
            step(...)

writes runs/trace/trace.json, a Chrome trace (chrome://tracing or
Perfetto) of the host's operators and, on the card, its kernels.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU activity, and CUDA
    activity where a card is present) and write log_dir/trace.json when
    it ends. Yields the profiler: key_averages() sums the time by
    operator and kernel."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def annotate(name: str):
    """A named range in the profiler's timeline
    (torch.profiler.record_function)."""
    return record_function(name)


class StepTimer:
    """Rolling step-time / throughput meter: tick() once a step, on the
    host's clock (synchronize with the card first to time its work)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: list = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        return float(np.mean(self.times)) if self.times else float('nan')

    def throughput(self, batch_size: int) -> float:
        m = self.mean_step_s
        return batch_size / m if m and np.isfinite(m) and m > 0 else 0.0
