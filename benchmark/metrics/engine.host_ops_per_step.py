"""The host's operations per outer step of the traced window: every host
record inside the program's `fibtorch.enqueue` spans (each chunk's outer
steps put on the queue: step closures, wrapper launches, extra probes),
aten ops and CUDA runtime calls alike (`harness/spans.py`), over the
window's outer steps.  A count, the same from run to run: the profiler's
cost per record, which would swamp a host time read from the same spans,
cannot move it.  What a CUDA graph per chunk would take away.  None
without the program's spans."""

from harness import spans

UNIT = "ops/step"


def read(ctx):
    chunks = spans.named(ctx, "fibtorch.enqueue")
    if not chunks or not ctx.steps:
        return None
    return spans.host_ops(ctx, chunks) / ctx.steps
