"""The runtime calls that block the host (`spans.WAIT_CALLS`: synchronises
and copies that are not Async) starting inside the program's
`dvg.train.step` spans, per step; 0 is a reading."""

from benchmark.yardstick.spans import host_waits


def read(trace, ctx):
    n = host_waits(trace, "dvg.train.step")
    return None if n is None else n / trace.units
