"""The card's idle ms per step while the host was innermost in the joint
pass's spans (`dvg.train.joint.forward`, `dvg.train.joint.backward`)."""

from benchmark.yardstick.spans import idle_ms_per_unit


def read(trace, ctx):
    return idle_ms_per_unit(trace, ["dvg.train.joint."])
