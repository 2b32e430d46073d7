"""The whole outer step's share of the card's float32 peak: the cell's
operations per outer step over the peak, divided by the wall time per
outer step of the traced window.  It bounds what any kernel's share can
gain end to end."""

UNIT = "%"


def read(ctx):
    if not (ctx.flops_per_step and ctx.peak_flop_per_s and ctx.ops
            and ctx.window_s > 0):
        return None
    least = ctx.flops_per_step * ctx.steps / ctx.peak_flop_per_s
    return 100.0 * least / ctx.window_s
