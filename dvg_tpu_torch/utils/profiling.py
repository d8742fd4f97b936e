"""Profiling hooks (counterpart of `dvg_tpu/utils/profiling.py`):
`StepTimer`, wall time per step with a device fence, and `trace_context`,
a `torch.profiler` trace of a region written as a Chrome trace."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StepTimer:
    """Rolling step timer: `start()`, then `stop(device)`, which waits for
    the device's queued work (`torch.cuda.synchronize`) before reading the
    clock when `device` is a CUDA device. The first `warmup` steps are not
    kept."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times = []
        self._t0: Optional[float] = None
        self._n = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, device=None) -> float:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str] = None):
    """Profile the region (host, and the card when there is one) and write
    <trace_dir>/trace.json for chrome://tracing or Perfetto; a no-op
    without trace_dir."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
