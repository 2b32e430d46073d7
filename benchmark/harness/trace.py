"""The device trace of a traced window and what the per-layer readers
take from it.

The window runs under `torch.profiler` (CPU and CUDA activity) inside a
user annotation `bench.window`; the annotation's span is the traced
window.  Every CUDA activity inside it (kernels, copies, sets) is a
device operation, whoever launched it: the program's ctypes launches show
as CUPTI records like PyTorch's own.  The copies and sets are the records
that CUPTI names `Memcpy ...` and `Memset ...`; the rest are kernels.  The
host side is read only to name what the host was doing while the device
sat idle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
TRANSFERS = ("Memcpy", "Memset")


def union(ops, window_s: float):
    """(seconds covered by the sorted intervals `ops`, the idle gaps
    between them within the window)."""
    busy, end, gaps = 0.0, 0.0, []
    for _, a, b in ops:
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if end < window_s:
        gaps.append((end, window_s))
    return busy, gaps


@dataclasses.dataclass
class TraceContext:
    """What the readers see.  Times in seconds from the window's start."""
    window_s: float
    ops: List[Tuple[str, float, float]]      # device (name, start, end)
    host: List[Tuple[str, float, float]]     # host ops inside the window
    steps: int                               # outer steps in the window
    flops_per_step: Optional[float]          # the cell's, by the counts
    peak_flop_per_s: Optional[float]         # the card's, by the table
    busy_s: float = 0.0                      # any device operation
    kernel_busy_s: float = 0.0               # kernels alone
    gaps: List[Tuple[float, float]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.ops.sort(key=lambda o: o[1])
        self.busy_s, self.gaps = union(self.ops, self.window_s)
        self.kernel_busy_s = union(
            [o for o in self.ops if not o[0].startswith(TRANSFERS)],
            self.window_s)[0]

    @property
    def between_ops(self) -> List[float]:
        """The idle time before each device operation after the first
        (zero where it starts as its predecessor ends or before)."""
        out, end = [], None
        for _, a, b in self.ops:
            if end is not None:
                out.append(max(0.0, a - end))
            end = b if end is None else max(end, b)
        return out


@contextlib.contextmanager
def capture(holder: dict):
    """Profile the block; `holder["prof"]` is the profiler after it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
    holder["prof"] = prof


def reduce(prof, steps: int, flops_per_step, peak) -> TraceContext:
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW
           and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    ops, host = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= w0 or a >= w1 or e.name() == WINDOW:
            continue
        item = (e.name(), (max(a, w0) - w0) * 1e-9, (min(b, w1) - w0) * 1e-9)
        (ops if e.device_type() == DeviceType.CUDA else host).append(item)
    return TraceContext((w1 - w0) * 1e-9, ops, host, steps,
                        flops_per_step, peak)


def _innermost(host: List[Tuple[str, float, float]]):
    """Sorted segments (start, end, name) of the innermost host op at
    each time, from properly nested spans."""
    spans = sorted(host, key=lambda h: (h[1], -h[2]))
    segs: List[Tuple[float, float, str]] = []
    stack: List[Tuple[str, float, float]] = []
    t = 0.0

    def emit(upto):
        nonlocal t
        if stack and upto > t:
            segs.append((t, upto, stack[-1][0]))
        t = max(t, upto)

    for name, a, b in spans:
        while stack and stack[-1][2] <= a:
            emit(stack[-1][2])
            stack.pop()
        emit(a)
        stack.append((name, a, b))
    while stack:
        emit(stack[-1][2])
        stack.pop()
    return segs


NAME_CHARS = 100


def breakdown(ctx: TraceContext, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, summed by name, and the
    device's idle time summed by what the host was doing at the middle of
    each gap (its innermost profiled op, or plain Python)."""
    by_op: Dict[str, float] = {}
    for name, a, b in ctx.ops:
        name = name[:NAME_CHARS]
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    segs = _innermost(ctx.host)
    starts = [s[0] for s in segs]
    by_host: Dict[str, float] = {}
    for a, b in ctx.gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = (segs[i][2] if i >= 0 and segs[i][1] > mid
                else "python (no profiled host op)")
        name = name[:NAME_CHARS]
        by_host[name] = by_host.get(name, 0.0) + (b - a)

    def rank(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}

