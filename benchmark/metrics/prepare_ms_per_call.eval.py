"""Host ms per call inside the program's `dvg.eval.prepare` span: the
BatchNorm fold, the casts and the GP caches each call makes afresh."""

from benchmark.yardstick.spans import host_ms


def read(trace, ctx):
    ms = host_ms(trace, "dvg.eval.prepare")
    return None if ms is None else ms / trace.units
