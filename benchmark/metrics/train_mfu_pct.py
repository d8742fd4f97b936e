"""The train step's share of the bf16 peak: the FLOPs of one step's
convolutions and matrix products, forward and backward, with no
recomputation (counted at set-up on the first step) over the traced
window's time per step."""

from benchmark.yardstick import peaks


def read(trace, ctx):
    if not ctx.get("flops_per_unit"):
        return None
    return peaks.mfu_pct(ctx["flops_per_unit"] * trace.units, trace.window_s)
