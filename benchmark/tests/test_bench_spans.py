"""The readers of the program's spans (`metrics/engine.state_io_ms`,
`engine.host_ops_per_step`, `engine.boundary_idle_us`,
`wrappers.host_ops_per_launch`; `harness/spans.py`) on hand-built traced
windows, and once on a CPU run through `harness.trace.capture` /
`reduce`.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
sys.path[:0] = [str(BENCH), str(CHECKOUT)]

from harness import spans  # noqa: E402
from harness import spec  # noqa: E402
from harness import trace as tr  # noqa: E402

READERS = spec.metric_readers()
NEW = ("engine.state_io_ms", "engine.host_ops_per_step",
       "engine.boundary_idle_us", "wrappers.host_ops_per_launch")
MS = 1e-3


def ms(name, a, b):
    return (name, a * MS, b * MS)


def read(ctx):
    return {name: READERS[name].read(ctx) for name in NEW}


def one_call(drain=((3.0, 3.1), (3.2, 3.4))):
    """One simulate() of 4 outer steps in two chunks around an event: its
    host spans and records, and the device's operations.  `drain` is the
    first chunk's kernels that run after its enqueue span has ended, while
    the host waits in the read-back."""
    host = [
        ms("fibtorch.simulate", 0.0, 10.0),
        ms("fibtorch.state_in", 0.0, 1.0),
        ms("fibtorch.enqueue", 1.0, 3.0),
        ms("fibtorch.launch.br_substep", 1.1, 1.5),
        ms("aten::empty", 1.15, 1.2),
        ms("aten::unbind", 1.2, 1.3),
        ms("aten::select", 1.22, 1.25),          # nested: an op of its own
        ms("cudaLaunchKernel", 1.3, 1.5),
        ms("Activity Buffer Request", 1.6, 1.7),  # the profiler's
        ms("fibtorch.launch.br_substep", 2.0, 2.6),
        ms("aten::empty_like", 2.05, 2.1),
        ms("cudaLaunchKernel", 2.2, 2.6),
        ms("Command Buffer Full", 2.3, 2.5),     # a wait, not an op
        ms("aten::stack", 2.7, 2.8),             # an extra probe's op
        ms("fibtorch.readback", 3.0, 4.0),
        ms("aten::isfinite", 3.02, 3.05),
        ms("cudaMemcpyAsync", 3.1, 3.9),
        ms("fibtorch.event", 4.0, 4.5),
        ms("fibtorch.enqueue", 5.0, 7.0),
        ms("fibtorch.launch.br_substep", 5.5, 5.6),
        ms("cudaLaunchKernel", 5.52, 5.58),
        ms("fibtorch.readback", 7.0, 8.0),
        ms("fibtorch.state_out", 8.0, 9.5),
    ]
    ops = ([ms("kernel", 1.2, 1.6), ms("kernel", 2.3, 2.9)]
           + [ms("kernel", a, b) for a, b in drain]
           + [ms("Memcpy DtoH", 3.45, 3.8), ms("kernel", 5.2, 7.0),
              ms("Memcpy DtoH", 7.1, 7.2)])
    return host, ops


def test_readers_on_one_call():
    host, ops = one_call()
    got = read(tr.TraceContext(10.0 * MS, ops, host, 4, None, None))
    assert got["engine.state_io_ms"] == pytest.approx(1.0 + 1.5)
    # 7 ops in the first enqueue (no wait, no profiler record), 1 in the
    # second, over 4 steps
    assert got["engine.host_ops_per_step"] == pytest.approx(8 / 4)
    # 4, 2 and 1 ops in the three launches
    assert got["wrappers.host_ops_per_launch"] == pytest.approx(7 / 3)
    # from the drain's last kernel (3.4 ms) to the next enqueue (5 ms):
    # idle [3.4, 3.45] and [3.8, 5.0]; the drain's own gap [3.1, 3.2] not
    assert got["engine.boundary_idle_us"] == pytest.approx(1250.0)


@pytest.mark.parametrize("kernels", [1, 40, 400])
def test_boundary_leaves_out_the_drain(kernels):
    """However many queued kernels drain in the read-back, with a gap
    before each, the boundary reads the same."""
    step = 0.4 / kernels
    drain = [(3.0 + i * step, 3.0 + (i + 0.5) * step) for i in range(kernels)]
    drain[-1] = (drain[-1][0], 3.4)
    host, ops = one_call(drain)
    ctx = tr.TraceContext(10.0 * MS, ops, host, 4, None, None)
    assert READERS["engine.boundary_idle_us"].read(ctx) == pytest.approx(
        1250.0)


def test_boundary_without_a_device_copy_starts_at_the_readback():
    """The plain path on a CPU copies nothing on a device: the boundary
    runs from the read-back span's start."""
    host, _ = one_call()
    ctx = tr.TraceContext(10.0 * MS, [], host, 4, None, None)
    assert READERS["engine.boundary_idle_us"].read(ctx) == pytest.approx(
        2000.0)


def test_boundaries_stay_inside_one_simulate_call():
    """Two calls of one chunk each: no boundary between them; state copies
    per call."""
    host = [ms("fibtorch.simulate", 0.0, 4.0),
            ms("fibtorch.state_in", 0.0, 1.0),
            ms("fibtorch.enqueue", 1.0, 3.0),
            ms("fibtorch.readback", 3.0, 3.5),
            ms("fibtorch.state_out", 3.5, 4.0),
            ms("fibtorch.simulate", 5.0, 9.0),
            ms("fibtorch.state_in", 5.0, 6.0),
            ms("fibtorch.enqueue", 6.0, 8.0),
            ms("aten::empty", 6.5, 6.6),
            ms("fibtorch.readback", 8.0, 8.5),
            ms("fibtorch.state_out", 8.5, 9.0)]
    got = read(tr.TraceContext(10.0 * MS, [], host, 8, None, None))
    assert got["engine.boundary_idle_us"] is None
    assert got["engine.state_io_ms"] == pytest.approx(1.5)
    assert got["engine.host_ops_per_step"] == pytest.approx(1 / 8)
    assert got["wrappers.host_ops_per_launch"] is None


def test_no_program_spans_read_none():
    """A program without spans (an older checkout) reads nothing, and the
    host's other records alone make no span."""
    _, ops = one_call()
    host = [ms("cudaLaunchKernel", 1.3, 1.5), ms("aten::copy_", 3.0, 4.0),
            ms("Command Buffer Full", 2.3, 2.5)]
    got = read(tr.TraceContext(10.0 * MS, ops, host, 4, None, None))
    assert got == dict.fromkeys(NEW)


def test_intervals():
    iv = spans.Intervals([(2.0, 3.0), (0.0, 1.0), (0.5, 1.5)])
    assert iv.merged == [[0.0, 1.5], [2.0, 3.0]]
    assert iv.overlap(1.0, 2.5) == pytest.approx(1.0)
    assert iv.overlap(-1.0, 4.0) == pytest.approx(2.5)
    assert iv.overlap(1.6, 1.9) == 0.0
    assert iv.holds(0.2, 1.4) and iv.holds(2.0, 3.0)
    assert not iv.holds(1.0, 2.1) and not iv.holds(-0.1, 0.5)


def test_the_readers_read_a_captured_cpu_run(monkeypatch):
    """A 64x64 BR run on the CPU with one pacing event, and a launch
    through the substep kernel's wrapper on a stub library (the CPU has no
    kernel), traced as the harness traces a window: every reader returns a
    number (the CPU run records no device operation, so its boundary is
    idle throughout)."""
    from fib_tf_tpu_torch import SimConfig, interop
    from fib_tf_tpu_torch.engine import Simulation
    from fib_tf_tpu_torch.models import BeelerReuter
    from fib_tf_tpu_torch.ops import cuda_step

    cfg = SimConfig(width=64, height=64, dt=0.1, dt_per_plot=10,
                    diff=0.809, duration=4, cheby=True, skip=True)
    model = BeelerReuter(cfg)
    sim = Simulation(model, device="cpu").define()
    sim.add_pace_op("s2", "luq", 10.0)
    kernel = cuda_step.SubstepKernel("br")

    class Stub:
        br_substep = staticmethod(lambda *args: 0)

    monkeypatch.setattr(kernel, "library", lambda: Stub)
    state = interop.state_from_numpy(model.initial_state(), "cpu")
    holder = {}
    with tr.capture(holder):
        res = sim.simulate(schedule=[(1.0, "s2")])
        kernel.launch(cuda_step.pack_params(model), state, True, None,
                      model.probe_pixel, 0, 0)
    assert kernel.launches == {"slow": 1, "frozen": 0}
    ctx = tr.reduce(holder["prof"], res.steps, None, None)
    got = read(ctx)
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["engine.boundary_idle_us"] <= 1e6 * ctx.window_s
    assert torch.isfinite(state["V"]).all()
