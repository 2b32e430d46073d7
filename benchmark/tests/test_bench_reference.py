"""The plain references against the port's plain path, and the frozen
operation counts against chip_smoke.py's, on the CPU.

    python -m pytest benchmark/tests -q
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
sys.path[:0] = [str(BENCH), str(CHECKOUT)]

from harness import compare, spec  # noqa: E402
from harness import traffic as gen  # noqa: E402
from test_bench_harness import SMALL, small_traffic  # noqa: E402

# (config, traffic, outer steps, events as (ms, op)); a few hundred outer
# steps with an event, at 64x64
CASES = {
    "br": ("br_cheby_skip", "paced.512", 300, [(60.0, "pace")]),
    "court": ("court", "annulus.512", 200, [(30.0, "s2")]),
}
# Over the 10-40 outer steps that the benchmark's checked stages take,
# every plane agrees to float32 rounding in another order, grown a little
# by the upstroke: the widest gap relative to each plane's magnitude.
SHORT_STEPS, SHORT_TOLERANCE = 20, 1e-3
# Over hundreds of outer steps Courtemanche's Ca-release gates (u, v) part
# by O(1) at cells near the release threshold, from one ulp of V alone
# (the port against itself parts alike), so the long run holds the
# potential (mV) and the "v" probe (on [0, 1]) to their sameness.
LONG_V_MV, LONG_PROBE = 1.0, 0.01


def port_run(config, traffic, n_steps, events, state):
    from fib_tf_tpu_torch.config import SimConfig
    from fib_tf_tpu_torch.engine import Simulation
    from fib_tf_tpu_torch.models import MODEL_REGISTRY
    model_cls = MODEL_REGISTRY[config["model"]]
    probe = model_cls(SimConfig(**config["sim"]))
    step_ms = probe.dt_per_step * probe.cfg.dt
    cfg = SimConfig(height=SMALL, width=SMALL, kernel="xla",
                    duration=(n_steps + 0.5) * step_ms, **config["sim"])
    sim = Simulation(model_cls(cfg), device="cpu")
    for x, y, r, outside in traffic["holes"]:
        sim.add_hole_to_phase_field(x, y, r, neg=bool(outside))
    sim.define(state=state)
    for name, op in traffic["pace_ops"].items():
        sim.add_pace_op(name, op["loc"], op["v"])
    sim.cl_observer = lambda i, cl: None
    return sim.simulate(schedule=events), step_ms


def both_runs(family, n, events):
    cfg_name, traffic_name, _, _ = CASES[family]
    config = spec._read(BENCH / "configs" / f"{cfg_name}.json")
    traffic = small_traffic(traffic_name)
    ref = spec.family_module("reference", family)
    state = gen.initial_state(ref, traffic, 11, "cpu")
    res, step_ms = port_run(config, traffic, n, events, state)
    ref_events = [(gen.event_step(t, step_ms), op) for t, op in events]
    cell = types.SimpleNamespace(config=config, traffic=traffic)
    return res, compare.reference_run(ref, cell, gen.geometry(traffic),
                                      state, n, ref_events, "cpu")


@pytest.mark.parametrize("family", sorted(CASES))
def test_reference_follows_the_port_plain_path(family):
    res, ref = both_runs(family, SHORT_STEPS, [])
    gap, where = compare.stage_gap(res.state, res.probes, ref)
    assert gap <= SHORT_TOLERANCE, (gap, where)

    _, _, n, events = CASES[family]
    res, ref = both_runs(family, n, events)
    dv = np.abs(res.state["V"] - ref.state["V"].numpy()).max()
    dp = np.abs(res.probes["v"] - ref.probes["v"].numpy()).max()
    assert dv <= LONG_V_MV and dp <= LONG_PROBE, (dv, dp)
    # the run did what the traffic asks: a wave crossed the probe
    assert res.probes["v"].max() > 0.5
    assert set(ref.probes) == set(res.probes) == set(ref.pixels)


def test_frozen_operation_counts_equal_chip_smokes():
    import chip_smoke as cs
    from counts import br, court
    sim_br = spec._read(BENCH / "configs" / "br_cheby_skip.json")["sim"]
    sim_court = spec._read(BENCH / "configs" / "court.json")["sim"]
    assert br.flops_per_cell_step(sim_br, False) == (
        cs.substep_flops(True, False) + 4 * cs.substep_flops(False, False))
    assert br.flops_per_cell_step(sim_br, False) == 919
    maps = types.SimpleNamespace(phase=np.ones((4, 4)), dmap=None,
                                 fiber=None)
    for phase, geom in ((False, 0), (True, cs.geometry_flops(maps))):
        assert court.flops_per_cell_step(sim_court, phase) == (
            cs.COURT_FLOPS["slow"] + 10 * (cs.COURT_FLOPS["fast"] + geom))
    assert court.flops_per_cell_step(sim_court, True) == 2462


def test_the_reference_derives_its_own_inputs():
    """The phase field and the pacing masks equal the port's host-side
    builders; the fitted coefficients round to the port's in float32."""
    from fib_tf_tpu_torch.models import BeelerReuter
    from fib_tf_tpu_torch.config import SimConfig
    from fib_tf_tpu_torch.ops import stencil
    from reference import br, common
    for n, holes in ((64, [[32, 32, 4, 0], [32, 32, 26, 1]]),
                     (512, [[256, 256, 30, 0], [256, 256, 250, 1]])):
        phase = None
        for x, y, r, o in holes:
            phase = stencil.add_hole_to_phase_field(phase, n, n, x, y, r,
                                                    bool(o))
        ours = common.phase_field(n, n, holes)
        np.testing.assert_allclose(ours, phase, rtol=1e-6, atol=0)
        for loc in stencil.PACE_LOCATIONS:
            np.testing.assert_array_equal(
                common.pace_mask(n, n, loc, 10.0, -90.0),
                stencil.pace_mask(n, n, loc, 10.0, -90.0))
    model = BeelerReuter(SimConfig(cheby=True, skip=True, dt=0.1))
    fits = br.fits(0.1, 5)
    for g in br.RATES:
        for ours, theirs in ((g + "_inf", g + "_inf"), (g + "_r", g + "_rl")):
            np.testing.assert_allclose(
                np.float32(fits[ours]), np.float32(model.cheby_coef[theirs]),
                rtol=1e-6, atol=1e-9)
