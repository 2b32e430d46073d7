"""The program's spans in a traced window, for the readers of
`metrics/engine.*` and `metrics/wrappers.*` that read them.

The port (`fib_tf_tpu_torch/tracing.py`) records host-only spans under
fixed names: `fibtorch.simulate` around each `simulate()` call, and inside
it `fibtorch.state_in`, `fibtorch.enqueue` (a chunk's outer steps put on
the queue), `fibtorch.readback` (the chunk's one copy to the host, the
wait for the queue included), `fibtorch.event` (a pacing event) and
`fibtorch.state_out`; `fibtorch.launch.<entry>` around each kernel launch
through a wrapper.  They sit in `TraceContext.host` beside the profiler's
other host records: the aten ops (nested ones each recorded), the records
CUPTI adds for each CUDA runtime call (on an H100: `cudaLaunchKernel`,
`cudaMemcpyAsync`, `cudaMemsetAsync`, `cudaStreamSynchronize`,
`cudaStreamIsCapturing`, `cudaDeviceSynchronize`), and two records that
are no operation of the host's: `Command Buffer Full` (a launch waiting on
a full queue, as often as the host runs ahead) and the profiler's own
`Activity Buffer Request`.

The profiler adds its own cost to every record it takes, a few µs per aten
op on the card's host, so a host time read inside a span is mostly the
profiler's where a span holds many ops.  The readers therefore count the
host's operations (`host_ops`), which the profiler cannot inflate, and
take times only where the device's clock or a copy's length sets them.

A program without the spans (an older checkout) gives none of them, and
every reader then returns None.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Tuple

NOT_OPS = ("Command Buffer Full", "Activity Buffer Request")

Interval = Tuple[float, float]


def named(ctx, name: str) -> List[Interval]:
    """The window's spans called `name`, by start."""
    return sorted((a, b) for n, a, b in ctx.host if n == name)


def prefixed(ctx, prefix: str) -> List[Interval]:
    """The window's spans whose names start with `prefix`, by start."""
    return sorted((a, b) for n, a, b in ctx.host if n.startswith(prefix))


class Intervals:
    """Intervals merged where they overlap, sorted by start."""

    def __init__(self, intervals: Iterable[Interval]):
        merged: List[List[float]] = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.merged = merged
        self._starts = [a for a, _ in merged]

    def overlap(self, a: float, b: float) -> float:
        """Seconds of [a, b] inside the intervals."""
        i = max(0, bisect.bisect_right(self._starts, a) - 1)
        covered = 0.0
        while i < len(self.merged) and self.merged[i][0] < b:
            s, e = self.merged[i]
            covered += max(0.0, min(e, b) - max(s, a))
            i += 1
        return covered

    def holds(self, a: float, b: float) -> bool:
        """Whether one interval holds all of [a, b]."""
        i = bisect.bisect_right(self._starts, a) - 1
        return i >= 0 and b <= self.merged[i][1]


def host_ops(ctx, within: Iterable[Interval]) -> int:
    """The host's operations inside the spans `within`: every host record
    held by one of them, other than the program's spans and `NOT_OPS`."""
    inside = Intervals(within)
    return sum(1 for n, a, b in ctx.host
               if not n.startswith("fibtorch.") and n not in NOT_OPS
               and inside.holds(a, b))
