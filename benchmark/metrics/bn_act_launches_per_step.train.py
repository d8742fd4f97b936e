"""Launches per step of the train-mode BatchNorm and activation kernels
(the device kernels whose name holds `dvg_elementwise_bn`); None where the
program has no such kernel."""

from benchmark.yardstick.trace import kernels_named

KERNEL = "dvg_elementwise_bn"


def read(trace, ctx):
    n = len(kernels_named(trace, KERNEL))
    return n / trace.units if n else None
