"""The card's idle ms per step while the host was innermost in the
updates' spans: the optimizer groups' (`dvg.train.optim`) and the
BatchNorm statistics folds (`dvg.train.bn_fold`)."""

from benchmark.yardstick.spans import idle_ms_per_unit


def read(trace, ctx):
    return idle_ms_per_unit(trace, ["dvg.train.optim", "dvg.train.bn_fold"])
