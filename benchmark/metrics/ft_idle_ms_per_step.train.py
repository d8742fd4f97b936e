"""The card's idle ms per step while the host was innermost in the
finetune passes' spans (`dvg.train.ft.encode`, `dvg.train.ft.lstm`,
`dvg.train.ft.gp`)."""

from benchmark.yardstick.spans import idle_ms_per_unit


def read(trace, ctx):
    return idle_ms_per_unit(trace, ["dvg.train.ft."])
