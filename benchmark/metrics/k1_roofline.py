"""K1's share of its roofline: the bound of `peaks.k1_cost` at the cell's
shapes (the larger of its operations at the f32 peak and its bytes at HBM
bandwidth) over K1's mean device time per launch in the window."""

from benchmark.yardstick import peaks
from benchmark.yardstick.trace import kernels_named


def read(trace, ctx):
    k1 = kernels_named(trace, "ssim_kernel")
    if not k1 or not ctx.get("k1_shape"):
        return None
    mean_ms = sum(e - s for _, s, e in k1) / len(k1) / 1e3
    bound_ms, _ = peaks.bound(*peaks.k1_cost(*ctx["k1_shape"]))
    return peaks.roofline_pct(bound_ms, mean_ms)
