"""The share of the traced window in which no operation ran on the
device."""

UNIT = "%"


def read(ctx):
    if not ctx.ops or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
