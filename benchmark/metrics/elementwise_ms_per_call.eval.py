"""Device ms per call of the kernels the frozen KERNEL_GROUPS class as
elementwise (bias, skip-half add, leaky_relu, tanh)."""

from benchmark.yardstick.trace import (ELEMENTWISE, KERNEL_GROUPS,
                                       device_ms_by_group)


def read(trace, ctx):
    ms = device_ms_by_group(trace, KERNEL_GROUPS).get(ELEMENTWISE)
    return None if ms is None else ms / trace.units
