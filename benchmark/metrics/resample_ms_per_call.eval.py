"""Device ms per call of the stock resampling kernels: those whose name
holds `upsample` (the nearest ×2 upsample before each VGG decoder group)
or `max_pool` (the 2×2 max-pool after each VGG encoder group); 0.0 where
the window ran device work but none of them."""

from benchmark.yardstick.trace import kernels_named

KEYS = ("upsample", "max_pool")


def read(trace, ctx):
    if not trace.inside(trace.device):
        return None
    ms = sum((e - s) / 1e3 for key in KEYS
             for _, s, e in kernels_named(trace, key))
    return ms / trace.units
