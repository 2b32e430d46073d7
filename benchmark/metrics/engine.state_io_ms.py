"""The state's copies in and out of `simulate()`: the program's
`fibtorch.state_in` and `fibtorch.state_out` spans (host planes to the
device and back to host numpy, each copy's wait included) per
`fibtorch.simulate` call of the traced window, in ms.  None without the
program's spans."""

from harness import spans

UNIT = "ms"


def read(ctx):
    calls = spans.named(ctx, "fibtorch.simulate")
    if not calls:
        return None
    io = spans.named(ctx, "fibtorch.state_in") + spans.named(
        ctx, "fibtorch.state_out")
    return 1e3 * sum(b - a for a, b in io) / len(calls)
