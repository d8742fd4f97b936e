"""The program's own spans in a traced window: what the host was doing,
by the program's layers, while the card waited.

The port marks its passes with `dvg.<layer>.<phase>` spans
(`dvg_tpu_torch.utils.profiling.span`), which `trace.capture` keeps in
`Trace.host` with the host's ops. Everything here is arithmetic on those
intervals, clipped to the window, on the profiler's one clock, so it also
holds for work that another thread issues while the span's thread waits
in it (autograd's backward):

  * `idle_by_span`: each idle µs of `trace.idle_gaps` goes to the
    innermost `dvg.*` span that covers it, or to OUTSIDE; the parts sum
    to the window's idle time;
  * `host_waits`: the runtime calls that block the host (WAIT_CALLS)
    starting inside the spans of a prefix, none inside `bench.sync`;
  * `host_ms`: the union of a prefix's spans, in ms.

A trace that holds none of a prefix's spans gives None (`spans_of`
empty), and a reader passes that on: the program then has no such span.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.yardstick.trace import Interval, Trace, idle_gaps, union

PREFIX = "dvg."
OUTSIDE = "outside"
SYNC = "bench.sync"
# the runtime calls that return only once the card (or a copy) is done:
# synchronises, and the copies that are not Async
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemcpy3D", "cudaMemcpyPeer", "cudaMemcpyToSymbol",
              "cudaMemcpyFromSymbol")


def spans_of(trace: Trace, prefix: str = PREFIX) -> List[Interval]:
    """The window's program spans whose names start with `prefix`,
    clipped to it."""
    return [s for s in trace.inside(trace.host) if s[0].startswith(prefix)]


def _pieces(trace: Trace) -> List[Tuple[float, float, str]]:
    """The window cut at every dvg.* span's ends, each piece with the
    innermost span that covers it (the shortest; OUTSIDE where none)."""
    a, b = trace.window
    spans = spans_of(trace)
    cuts = sorted({a, b, *(x for _, s, e in spans for x in (s, e))})
    starts: Dict[float, List[Interval]] = {}
    for sp in spans:
        starts.setdefault(sp[1], []).append(sp)
    active: List[Interval] = []
    out = []
    for lo, hi in zip(cuts, cuts[1:]):
        active = [sp for sp in active + starts.get(lo, []) if sp[2] > lo]
        inner = min(active, key=lambda sp: sp[2] - sp[1], default=None)
        out.append((lo, hi, OUTSIDE if inner is None else inner[0]))
    return out


def idle_by_span(trace: Trace) -> Dict[str, float]:
    """The window's idle µs by the innermost dvg.* span over it (OUTSIDE
    where none is); the values sum to the idle gaps' total."""
    out: Dict[str, float] = {}
    pieces, gaps = _pieces(trace), idle_gaps(trace)
    i = 0
    for lo, hi, name in pieces:
        while i < len(gaps) and gaps[i][1] <= lo:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < hi:
            dt = min(hi, gaps[j][1]) - max(lo, gaps[j][0])
            if dt > 0:
                out[name] = out.get(name, 0.0) + dt
            j += 1
    return out


def idle_ms_per_unit(trace: Trace, prefixes: Sequence[str]
                     ) -> Optional[float]:
    """Idle ms per unit under the spans of any of `prefixes`; None where
    the trace holds none of them."""
    if not any(spans_of(trace, p) for p in prefixes):
        return None
    us = sum(v for k, v in idle_by_span(trace).items()
             if k.startswith(tuple(prefixes)))
    return us / 1e3 / trace.units


def _inside(t: float, intervals: Sequence[Tuple[float, float]]) -> bool:
    return any(s <= t < e for s, e in intervals)


def host_waits(trace: Trace, prefix: str) -> Optional[int]:
    """The WAIT_CALLS that start inside a span of `prefix` and outside
    the benchmark's `bench.sync`; None where the trace holds no such
    span."""
    spans = spans_of(trace, prefix)
    if not spans:
        return None
    inside = union([(s, e) for _, s, e in spans])
    sync = [(s, e) for n, s, e in trace.spans if n == SYNC]
    return sum(1 for n, s, _ in trace.inside(trace.runtime)
               if n in WAIT_CALLS and _inside(s, inside)
               and not _inside(s, sync))


def host_ms(trace: Trace, prefix: str) -> Optional[float]:
    """The union of the spans of `prefix`, in ms; None where there is
    none."""
    spans = spans_of(trace, prefix)
    if not spans:
        return None
    return sum(e - s for s, e in union([(s, e) for _, s, e in spans])) / 1e3
