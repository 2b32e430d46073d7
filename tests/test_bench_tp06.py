"""The benchmark's ten Tusscher-Panfilov 2006 cell on the CPU: its plain
reference (benchmark/reference/tp06.py) against the port's plain path at
64x64 over four seeds with an S2, the bfloat16 control against the same
tolerance, the frozen operation count against chip_smoke.py's, and the
cell's files.

    python -m pytest tests/test_bench_tp06.py -q
"""

import ast
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[1]
BENCH = CHECKOUT / "benchmark"
sys.path[:0] = [str(BENCH), str(CHECKOUT)]

from harness import compare, spec  # noqa: E402
from harness import traffic as gen  # noqa: E402
from test_torch_fixtures import one_torch_thread  # noqa: E402,F401

CELL = "tp06.2048.spiral"
SMALL = 64
SEEDS = (11, 12, 13, 14)
# Over the 10-20 outer steps of the cell's checked stages, every plane
# agrees to float32 rounding in another order, grown a little by the
# upstroke: the widest gap relative to each plane's magnitude.  xs reads
# the most (2.3e-4): its plane's largest value is still near 0.01 there,
# so one ulp of its rate is a large share of it.
SHORT_STEPS, SHORT_TOLERANCE = 20, 1e-3
# Over 200 outer steps (40 ms: the S1 past the probe, an S2 at 30 ms) the
# same tolerance holds: the Ca release has not yet amplified an ulp, and
# every plane keeps cells away from its clip (the rest and the plateau)
LONG_STEPS = 200
RUNS = {"short": (SHORT_STEPS, [(1.0, "s2")]),
        "long": (LONG_STEPS, [(30.0, "s2")])}


def cell_files():
    w = spec._read(BENCH / "workloads" / f"{CELL}.json")
    config = spec._read(BENCH / "configs" / f"{w['config']}.json")
    traffic = spec._read(BENCH / "traffic" / f"{w['traffic']}.json")
    return config, dict(traffic, grid=[SMALL, SMALL])


def port_run(config, traffic, n_steps, events, state):
    from fib_tf_tpu_torch.config import SimConfig
    from fib_tf_tpu_torch.engine import Simulation
    from fib_tf_tpu_torch.models import MODEL_REGISTRY
    cfg = SimConfig(height=SMALL, width=SMALL, kernel="xla",
                    duration=(n_steps + 0.5) * 0.2, **config["sim"])
    sim = Simulation(MODEL_REGISTRY[config["model"]](cfg), device="cpu")
    sim.define(state=state)
    for name, op in traffic["pace_ops"].items():
        sim.add_pace_op(name, op["loc"], op["v"])
    sim.cl_observer = lambda i, cl: None
    return sim.simulate(schedule=events)


def reference_run(config, traffic, state, n_steps, events,
                  dtype=torch.float32):
    ref = spec.family_module("reference", "tp06")
    step_ms = ref.DT_PER_STEP * config["sim"]["dt"]
    cell = types.SimpleNamespace(config=config, traffic=traffic)
    return compare.reference_run(
        ref, cell, None, state, n_steps,
        [(gen.event_step(t, step_ms), op) for t, op in events], "cpu",
        dtype=dtype)


def seed_state(traffic, seed):
    return gen.initial_state(spec.family_module("reference", "tp06"),
                             traffic, seed, "cpu")


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_follows_the_port_plain_path(seed, run):
    config, traffic = cell_files()
    n, events = RUNS[run]
    state = seed_state(traffic, seed)
    res = port_run(config, traffic, n, events, state)
    ref = reference_run(config, traffic, state, n, events)
    gap, where = compare.stage_gap(res.state, res.probes, ref)
    assert gap <= SHORT_TOLERANCE, (gap, where)
    assert set(ref.probes) == set(res.probes) == set(ref.pixels)
    assert len(res.probes["v"]) == n
    if run == "long":
        # the S1 crossed the probe; the S2 raised the upper-left quadrant
        assert res.probes["v"].max() > 0.5
        assert ref.state["V"][10, 10] > -20.0


def test_the_bfloat16_reference_fails_the_tolerance():
    """The control: the reference computed in bfloat16 in the port's
    place reads far outside the short run's tolerance."""
    config, traffic = cell_files()
    n, events = RUNS["short"]
    state = seed_state(traffic, SEEDS[0])
    ref = reference_run(config, traffic, state, n, events)
    low = reference_run(config, traffic, state, n, events, torch.bfloat16)
    gap, _ = compare.stage_gap(
        {k: v.float().numpy() for k, v in low.state.items()},
        {k: v.float().numpy() for k, v in low.probes.items()}, ref)
    assert gap > 100 * SHORT_TOLERANCE


def test_the_reference_rest_state_equals_the_ports():
    """Worked out again from the paper, the resting planes (the gates at
    their float64 steady states) round to the port's; the S1 is column 1
    at +20 mV on both."""
    from fib_tf_tpu_torch.config import SimConfig
    from fib_tf_tpu_torch.models import TenTusscher06
    from reference import tp06
    ours = tp06.initial_state(8, 8)
    theirs = TenTusscher06(SimConfig(height=8, width=8, dt=0.02)
                           ).initial_state()
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6, atol=0,
                                   err_msg=k)


def test_the_count_equals_chip_smokes():
    import chip_smoke as cs
    from counts import tp06
    config, _ = cell_files()
    assert tp06.flops_per_cell_step(config["sim"], False) == (
        10 * cs.LRTP_FLOPS[("tp06", True)]) == 5450
    for sim, phase in ((dict(config["sim"], skip=True), False),
                       (dict(config["sim"], cell_type="transmural"), False),
                       (config["sim"], True)):
        with pytest.raises(ValueError):
            tp06.flops_per_cell_step(sim, phase)


def test_the_reference_imports_no_program_and_no_jax():
    tree = ast.parse((BENCH / "reference" / "tp06.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"__future__", "typing", "numpy", "torch", "reference"}
    from reference import tp06  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_the_cell_loads_with_a_limit_per_checked_stage():
    from harness import window
    cell = spec.load_cell(CELL)
    assert (cell.family, cell.chips, cell.traffic["grid"]) == (
        "tp06", 1, [2048, 2048])
    ref = spec.family_module("reference", cell.family)
    step = ref.DT_PER_STEP * cell.config["sim"]["dt"]
    stages = gen.pre_window(cell.traffic, step)
    names = {s.name for s in stages if s.checked} | {"end"}
    assert set(cell.limits) == names | set(window.names(cell.traffic))
    assert names == {"start", "event.s2", "end"}
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    (entry,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        cell.config_name, cell.traffic_name, 1)
    assert cell.config_name in {c["name"] for c in bench["configs"]}
