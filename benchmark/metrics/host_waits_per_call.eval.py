"""The runtime calls that block the host (`spans.WAIT_CALLS`: synchronises
and copies that are not Async) starting inside the program's `dvg.eval.*`
spans, per call; the benchmark's own synchronise after each call is not
counted, and 0 is a reading."""

from benchmark.yardstick.spans import host_waits


def read(trace, ctx):
    n = host_waits(trace, "dvg.eval.")
    return None if n is None else n / trace.units
