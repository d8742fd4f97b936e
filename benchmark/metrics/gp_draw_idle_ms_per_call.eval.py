"""The card's idle ms per call while the host was innermost in the
program's `dvg.eval.gp_draw` spans: the fork steps' GP draws with their
seeded eps."""

from benchmark.yardstick.spans import idle_ms_per_unit


def read(trace, ctx):
    return idle_ms_per_unit(trace, ["dvg.eval.gp_draw"])
