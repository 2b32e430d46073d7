"""Device operations (kernels, copies, sets) per outer step of the traced
window: what the wrappers and the probes launch.  A count; it repeats
exactly for a traced window of fixed length."""

UNIT = "ops/step"


def read(ctx):
    return len(ctx.ops) / ctx.steps if ctx.ops and ctx.steps else None
