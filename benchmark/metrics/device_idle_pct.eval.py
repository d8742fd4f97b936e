"""The card's idle share of the traced window: 1 − (the union of the
device operations' intervals) / (the window from its start to its
synchronised end, host gaps included)."""

from benchmark.yardstick.trace import idle_pct


def read(trace, ctx):
    return idle_pct(trace) if trace.device else None
