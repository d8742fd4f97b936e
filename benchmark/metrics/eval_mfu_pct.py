"""The eval call's share of the bf16 peak: the FLOPs of one call's
convolutions and matrix products (counted at set-up from the ops' shapes;
K1 is not a torch op and is left out) over the traced window's time per
call."""

from benchmark.yardstick import peaks


def read(trace, ctx):
    if not ctx.get("flops_per_unit"):
        return None
    return peaks.mfu_pct(ctx["flops_per_unit"] * trace.units, trace.window_s)
