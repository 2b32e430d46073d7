"""The host's operations per kernel launch through a wrapper: every host
record inside the program's `fibtorch.launch.<entry>` spans (the aten ops
that make the new state's planes, the runtime's `cudaLaunchKernel`;
`harness/spans.py`), over the window's launches.  A count, the same from
run to run, which the profiler's cost per record cannot move.  None
without the program's spans."""

from harness import spans

UNIT = "ops/launch"


def read(ctx):
    launches = spans.prefixed(ctx, "fibtorch.launch.")
    if not launches:
        return None
    return spans.host_ops(ctx, launches) / len(launches)
