"""The port's spans (fib_tf_tpu_torch/tracing.py) on the CPU: the engine's
spans of one `simulate()` call, their order and nesting, that each is a
host op and no user annotation, and that no record is made while no
profiler records.  tests/test_torch_cuda.py holds the wrappers' launch
spans to their `launches` counters on the card."""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fib_tf_tpu_torch import SimConfig, tracing
from fib_tf_tpu_torch.engine import Simulation
from fib_tf_tpu_torch.models import BeelerReuter
from test_torch_fixtures import one_torch_thread  # noqa: F401

# 64x64 BR for 6 ms (12 outer steps), one pacing event after 2 ms: two
# chunks
CFG = SimConfig(width=64, height=64, dt=0.1, dt_per_plot=10, diff=0.809,
                duration=6, cheby=True, skip=True)
SCHEDULE = [(2.0, "s2")]


def _sim():
    sim = Simulation(BeelerReuter(CFG), device="cpu").define()
    sim.add_pace_op("s2", "luq", 10.0)
    return sim


def _spans(prof):
    """The trace's `fibtorch.` records as (name, start, end, record),
    in order of their start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("fibtorch."):
            a = e.start_ns()
            out.append((e.name(), a, a + e.duration_ns(), e))
    return sorted(out, key=lambda s: (s[1], -s[2]))


def test_simulate_records_its_spans_nested_and_in_order():
    sim = _sim()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = sim.simulate(schedule=SCHEDULE)
    assert res.steps == 12
    spans = _spans(prof)
    names = [s[0].removeprefix("fibtorch.") for s in spans]
    assert names == ["simulate", "state_in", "enqueue", "readback", "event",
                     "enqueue", "readback", "state_out"]
    _, a, b, _ = spans[0]
    for name, start, end, _ in spans[1:]:
        assert a <= start <= end <= b, name
    for (_, _, end, _), (name, start, _, _) in zip(spans[1:-1], spans[2:]):
        assert end <= start, name
    for name, _, _, e in spans:
        assert e.device_type() == DeviceType.CPU, name
        assert not e.is_user_annotation(), name


def test_span_makes_no_record_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a record of {name} with no profiler")

    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with tracing.span("fibtorch.simulate"):
        pass
    assert _sim().simulate(schedule=SCHEDULE).steps == 12
    # the patch is the record the span would make under a profiler
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="fibtorch.simulate"):
            tracing.span("fibtorch.simulate")
