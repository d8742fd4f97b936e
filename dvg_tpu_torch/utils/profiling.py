"""Profiling hooks (counterpart of `dvg_tpu/utils/profiling.py`):
`StepTimer`, wall time per step with a device fence; `trace_context`, a
`torch.profiler` trace of a region written as a Chrome trace; and `span`,
the port's one mark of where the host is in the program.

Spans are named `dvg.<layer>.<phase>`: `dvg.train.*` in the train step
(`train/step.py`, `train/optim.py`), `dvg.eval.*` in the rollout
(`generate/rollout.py`). While a `torch.profiler` session records, a span
is a `record_function`, so it lands in the session's trace beside the
kernels, on the same clock (and in every `trace_context` Chrome trace);
while none records it costs one flag check and does nothing, so it
changes no number and adds no node to an exported graph."""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.autograd import profiler as _profiler


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


class _Idle:
    """A span while no profiler records: enters and leaves doing nothing.
    One per name, shared by every call."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn: Callable) -> Callable:
        return _spanned(self.name, fn)


class _Recorded(_profiler.record_function):
    """A span while a profiler records: a `record_function`, which as a
    decorator asks `span` again at every call."""

    def __call__(self, fn: Callable) -> Callable:
        return _spanned(self.name, fn)


_IDLE: Dict[str, _Idle] = {}


def span(name: str):
    """`with span("dvg.layer.phase"):` or `@span("dvg.layer.phase")`: the
    region, or every call of the function, as one host event of that name
    in the recording profiler's trace; nothing while none records."""
    if _profiler._is_profiler_enabled:
        return _Recorded(name)
    idle = _IDLE.get(name)
    if idle is None:
        idle = _IDLE[name] = _Idle(name)
    return idle


def _spanned(name: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return run
