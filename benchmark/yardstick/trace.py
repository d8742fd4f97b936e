"""The profiler capture of a traced window and its reduction to numbers.

`capture(unit, n)` runs `unit()` n times under `torch.profiler` (host and
card) inside a `bench.window` span that ends with a `bench.sync`
synchronise, and returns a `Trace` of plain tuples: the device operations,
the host's CUDA runtime calls, the benchmark's own `bench.*` spans and the
host's other ops. Everything below it is arithmetic on those tuples, so
the tests drive it with synthetic events.

The card's idle share is 1 − (the union of the device operations'
intervals inside the window) / (the window, from its start to its
synchronised end, host gaps included); `chip_smoke.py::device_kernels`
summed durations over the first-to-last-kernel span instead, which hides
the host's gaps at both ends and counts overlapping operations twice.

`KERNEL_GROUPS` and `TRAIN_GROUPS` are frozen copies of chip_smoke.py's
tables: a kernel belongs to the first group one of whose keys its name
holds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]        # (name, start µs, end µs)

KERNEL_GROUPS = (("K1 ssim_kernel (cyclic mode)", ("ssim_kernel",)),
                 ("transposed conv (dgrad)", ("dgrad",)),
                 ("conv (fprop)", ("fprop", "cutlass")),
                 ("cuDNN layout/padding", ("Padding", "ToNhwc", "ToNchw")),
                 ("elementwise (bias, skip add, leaky_relu, tanh)",
                  ("elementwise",)))     # the rest: LSTM, GP, reductions

TRAIN_GROUPS = (("conv wgrad", ("wgrad",)),
                ("conv dgrad (incl. transposed-conv forward)", ("dgrad",)),
                ("conv fprop (incl. transposed-conv dgrad)",
                 ("fprop", "implicit_convolve", "conv2d", "xmma", "cutlass")),
                ("BN statistics (Welford)", ("Welford", "welford")),
                ("other reductions", ("reduce_kernel",)),
                ("LSTM (cuDNN RNN)", ("RNN", "rnn", "LSTM", "lstm",
                                      "elemWise")),
                ("GEMM / GP solves", ("gemm", "Gemm", "trsm", "potrf",
                                      "cholesky", "geqrf")),
                ("Adam (foreach)", ("multi_tensor_apply",)),
                ("index_select / index_add", ("index",)),
                ("copies and layout", ("copy", "Copy", "nchw", "nhwc",
                                       "Nhwc", "Nchw", "Padding")),
                ("elementwise", ("elementwise", "vectorized")))

GROUP_TABLES = {"eval": KERNEL_GROUPS, "train": TRAIN_GROUPS}
ELEMENTWISE = KERNEL_GROUPS[-1][0]

# the host's runtime calls that put work on the card: a captured graph
# counts once
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync")
WINDOW = "bench.window"
SPAN_PREFIX = "bench."
BREAKDOWN_ENTRIES = 10


@dataclasses.dataclass
class Trace:
    device: List[Interval]       # kernels, memcpy and memset on the card
    runtime: List[Interval]      # the host's CUDA runtime calls
    spans: List[Interval]        # the benchmark's bench.* spans
    host: List[Interval]         # the host's other ops (aten::*, ...)
    units: int                   # calls or steps inside the window

    @property
    def window(self) -> Tuple[float, float]:
        w = [s for s in self.spans if s[0] == WINDOW]
        if len(w) != 1:
            raise ValueError(f"a trace needs one {WINDOW} span, found "
                             f"{len(w)}")
        return w[0][1], w[0][2]

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) / 1e6

    def inside(self, events: Sequence[Interval]) -> List[Interval]:
        """The events clipped to the window; those outside it dropped."""
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e in events
                if e > a and s < b]


def union(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some operation ran on the card."""
    return sum(e - s for s, e in union(
        [(s, e) for _, s, e in trace.inside(trace.device)])) / 1e6


def idle_pct(trace: Trace) -> float:
    return 100.0 * (1.0 - busy_s(trace) / trace.window_s)


def group_of(name: str, groups) -> str:
    for label, keys in groups:
        if any(k in name for k in keys):
            return label
    return "other"


def device_ms_by_group(trace: Trace, groups) -> Dict[str, float]:
    """Summed device ms of the window's operations by group."""
    out: Dict[str, float] = {}
    for name, s, e in trace.inside(trace.device):
        g = group_of(name, groups)
        out[g] = out.get(g, 0.0) + (e - s) / 1e3
    return out


def kernels_named(trace: Trace, key: str) -> List[Interval]:
    return [k for k in trace.inside(trace.device) if key in k[0]]


def launches(trace: Trace) -> int:
    """The host's launch calls inside the window (LAUNCH_CALLS)."""
    return sum(1 for n, _, _ in trace.inside(trace.runtime)
               if n in LAUNCH_CALLS)


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The window's idle gaps, (start µs, end µs), when no operation ran on
    the card."""
    a, b = trace.window
    busy = union([(s, e) for _, s, e in trace.inside(trace.device)])
    edges = [a] + [x for iv in busy for x in iv] + [b]
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def host_doing(trace: Trace, t: float) -> str:
    """What the host was doing at t: the innermost bench.* span and the
    innermost host op or runtime call that cover it."""
    span = _innermost(trace.spans, t) or "no span"
    op = _innermost(trace.host + trace.runtime, t) or "no op"
    return f"{span} / {op}"


def _innermost(events: Sequence[Interval], t: float) -> Optional[str]:
    best = None
    for n, s, e in events:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (n, e - s)
    return None if best is None else best[0]


def breakdown(trace: Trace, groups) -> Dict[str, list]:
    """The traced window's device time by group, the largest first, and
    its longest idle gaps, each named by what the host was doing at its
    middle; seconds, at most ten entries each."""
    ops = sorted(device_ms_by_group(trace, groups).items(),
                 key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    longest = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])
    return {"device_ops": [[n, ms / 1e3] for n, ms in ops],
            "idle_gaps": [[host_doing(trace, 0.5 * (s + e)), (e - s) / 1e6]
                          for s, e in longest[:BREAKDOWN_ENTRIES]]}


def capture(unit: Callable[[], None], n: int) -> Trace:
    """Profile n calls of `unit` (host and card) in one window that ends
    with a synchronise. Without a card it profiles the host alone (the
    tests' CPU runs): the trace then holds no device operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                           else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                unit()
            with record_function("bench.sync"):
                sync()
    device, runtime, spans, host = [], [], [], []
    for ev in prof.events():
        iv = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device.append(iv)
        elif ev.name.startswith(SPAN_PREFIX):
            spans.append(iv)
        elif ev.name.startswith(("cuda", "cu")) and not ev.name.startswith(
                "cutlass"):
            runtime.append(iv)
        else:
            host.append(iv)
    return Trace(device, runtime, spans, host, n)
