"""Spans of the port's host work, on the profiler's own clock.

`span(name)` is a context manager.  While a `torch.profiler` session
records, it opens a host-only record of the profiler
(`_RecordFunctionFast`): a CPU op under `name` in the trace, never a user
annotation, so it adds nothing to the device side of the trace (a
`record_function` range would: kineto derives a `gpu_user_annotation`
record for every annotation that launches device work).  With no
profiler recording it returns one shared no-op context.  The check reads
the flag torch keeps in Python for such fast checks
(`torch.autograd.profiler._is_profiler_enabled`, set while a profiler
session records); a call of `torch._C._autograd._profiler_enabled()`
in its place costs a fifth of the span.

Names are fixed strings under `fibtorch.`: the engine's `simulate`,
`state_in`, `enqueue`, `readback`, `event` and `state_out`, and
`launch.<entry>` for each kernel launch through a wrapper, named after the
wrapper's C entry when the wrapper is built.  The profiler keeps the
records and writes them out (`SimConfig.timeline`, or a caller's own
session).
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


class _Off:
    """The no-op context (a fifth cheaper than contextlib.nullcontext)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def span(name: str):
    """A context that records `name` around its block while a profiler
    records, and does nothing otherwise."""
    return (_RecordFunctionFast(name) if _profiler._is_profiler_enabled
            else _OFF)
