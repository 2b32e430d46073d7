"""The kernels' share of their roofline: the least time the cell's float32
operations of an outer step take at the card's float32 peak, over the
time per outer step in which a kernel ran on the device (the window's
copies and sets left out: they are the engine's, and the idle share and
the whole step's share see them).  Operations alone bound it: at 512x512
the state fits in L2, and a kernel may fuse outer steps, so bytes per
outer step are no floor."""

UNIT = "%"


def read(ctx):
    if not (ctx.flops_per_step and ctx.peak_flop_per_s
            and ctx.kernel_busy_s > 0):
        return None
    least = ctx.flops_per_step * ctx.steps / ctx.peak_flop_per_s
    return 100.0 * least / ctx.kernel_busy_s
