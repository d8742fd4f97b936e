"""The host's launch calls per step (cudaLaunchKernel, cuLaunchKernel,
cudaLaunchKernelExC, cudaGraphLaunch, cudaMemcpyAsync in the profiler's
runtime events): a captured graph counts once."""

from benchmark.yardstick.trace import launches


def read(trace, ctx):
    n = launches(trace)
    return n / trace.units if n else None
