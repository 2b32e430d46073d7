"""The port's Courtemanche-ultra held against fib_tf_tpu's on the CPU, and
both Courtemanche models through the port's entry points: `Simulation` on a
small annulus with an S2 (the "v", "trend" and "ultra" probe streams, the
crossings and `probe_at_step` inside a `cl_observer`) and `run_volume`
against the JAX engines, and the volume substep kernel's plain version
against the JAX model's step on the reference's volume geometry (its
whole-volume Pallas kernel takes 33 s to run in interpret mode here, so
the test holds the plain version to the reference's own XLA path).

Tolerances: a step and the kernels' plain versions rtol 1e-3 / atol 1e-5,
the JAX package's kernel-vs-XLA bound (tests/test_pallas.py:90-97); whole
runs 1e-3 of the model's 150 mV range (tests/test_golden.py) on V and the
probes' potentials, rtol 1e-4 on the `ultra` means (sums over the grid in
another order)."""

import os

import numpy as np
import pytest
import torch

import fib_tf_tpu.models.courtemanche as jc
from fib_tf_tpu.engine import Simulation as JaxSimulation
from fib_tf_tpu.engine.volume import run_volume as jax_run_volume
from fib_tf_tpu.models import grid_geometry as jax_grid_geometry
from fib_tf_tpu.models.base import volume_geometry as jax_volume_geometry
import fib_tf_tpu_torch.models.courtemanche as tc
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation, run_volume, volume
from fib_tf_tpu_torch.models import cell_geometry
from fib_tf_tpu_torch.ops import bodies, cuda_step, cuda_volume
from fib_tf_tpu_torch.parallel import make_mesh

from test_torch_court import (GOLDEN, TOL, V_ATOL, assert_states_close, cfg,
                              jax_cfg, models, seeded_state, to_jax)
from test_torch_fixtures import one_torch_thread  # noqa: F401

ULTRA_TOL = dict(rtol=1e-4, atol=1e-6)


def test_ultra_constants_and_probes_equal_jax():
    jm, tm = models("CourtemancheUltra")
    assert tm.name == "court_ultra" and tm.cfg.ultra_slow
    for attr in ("trend_points", "ULTRA_KEYS", "probe_pixel",
                 "dt_per_step"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.state_keys() == jm.state_keys()
    assert len(tm.state_keys()) == 22 and "us" in tm.state_keys()
    st = jm.initial_state()
    for k, v in tm.initial_state().items():
        np.testing.assert_array_equal(v, st[k])
    assert {tm.dt_for(k) for k in tm.state_keys()} == {0.1}
    assert tm.launch_schedule == (True,) * 10
    body = bodies.cell_body(tm)
    assert body.name == "court_ultra" and body.writes_potential(True)
    assert body.planes == bodies.COURT_ULTRA_PLANES
    assert set(body.planes) - {"_p_chronic"} == set(tm.state_keys()) - {"V"}
    with pytest.raises(ValueError, match="one substep body"):
        cuda_step.plain_substep(tm, interop.state_from_numpy(
            tm.initial_state(), "cpu"), False)
    state = interop.state_from_numpy(seeded_state(tm, seed=7), "cpu")
    phase = np.random.RandomState(8).uniform(0.0, 1.0, (16, 16)).astype(
        np.float32)
    want = jm.ultra_observables(to_jax({k: v.numpy()
                                        for k, v in state.items()}), phase)
    got = tm.ultra_observables(state, torch.tensor(phase))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ULTRA_TOL)
    np.testing.assert_array_equal(tm.trend_probe(state).numpy(),
                                  np.asarray(jm.trend_probe(to_jax(
                                      {k: v.numpy()
                                       for k, v in state.items()}))))


@pytest.mark.parametrize("flags", [{}, dict(court_cheby=True),
                                   dict(table=True)],
                         ids=["direct", "cheby", "table"])
def test_ultra_step_matches_jax(flags):
    """16x16 from a seeded state, one outer step (ten full commits)."""
    jm, tm = models("CourtemancheUltra", **flags)
    st = seeded_state(tm, seed=9)
    want = jm.step(to_jax(st), jax_grid_geometry())
    got = cuda_step.plain_step(tm, interop.state_from_numpy(st, "cpu"))
    assert_states_close(got, want, **TOL)


def test_golden_court_ultra_ap():
    """tests/golden/court_ultra_ap.npy, as tests/test_golden.py drives it:
    V = 20 mV, 400 outer steps (one cell)."""
    model = tc.CourtemancheUltra(SimConfig(width=8, height=8, dt=0.1,
                                           duration=1))
    st = model.initial_state(s1=False)
    st["V"][:] = 20.0
    state = interop.state_from_numpy({k: v[:1, :1] for k, v in st.items()},
                                     "cpu")
    geom = cell_geometry()
    trace = []
    with torch.inference_mode():
        for _ in range(400):
            state = model.step(state, geom)
            trace.append(float(state["V"][0, 0]))
    want = np.load(os.path.join(GOLDEN, "court_ultra_ap.npy"))
    np.testing.assert_allclose(np.float32(trace), want, atol=V_ATOL, rtol=0)


# -- the entry points --------------------------------------------------------------


def _annulus_run(sim_cls, model, n, **kw):
    """examples/court_ultra_run.py's domain at n x n: a disk hole and a neg
    ring, an S2 on the upper left quadrant at 19 ms (so that both chunks
    are 20 outer steps), 40 ms; the `cl_observer` reads the live probes
    at each crossing."""
    sim = sim_cls(model, **kw)
    sim.add_hole_to_phase_field(n // 2, n // 2, max(n // 17, 3))
    sim.add_hole_to_phase_field(n // 2, n // 2, n // 2 - 6, neg=True)
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0)
    seen = []
    sim.cl_observer = lambda i, cl: seen.append(
        (i, cl, sim.probe_at_step(i, "ultra")))
    return sim.simulate(schedule=[(19.0, "s2")]), seen


def test_simulate_matches_jax_engine():
    """Courtemanche-ultra at 64x64, diff 1.5 (court_ultra_run.py): the
    three probe streams ("v", "trend", "ultra"), the crossings, the live
    reads and the final state against the JAX engine.  (One model: the
    JAX engine's compile of the ten-substep step is this file's largest
    cost, and Courtemanche's own engine path differs only in its step,
    held to the JAX model's in tests/test_torch_court.py.)"""
    c = cfg(width=64, height=64, dt_per_plot=10, duration=40, diff=1.5)
    want, want_seen = _annulus_run(
        JaxSimulation, jc.CourtemancheUltra(jax_cfg(c)), 64)
    sim_model = tc.CourtemancheUltra(c)
    got, got_seen = _annulus_run(lambda m: Simulation(m, device="cpu"),
                                 sim_model, 64)
    assert got.steps == want.steps == 40
    assert got.cycle_lengths == want.cycle_lengths
    assert len(got.cycle_lengths) >= 1
    assert set(got.probes) == set(want.probes) == {"v", "trend", "ultra"}
    np.testing.assert_allclose(got.probes["v"], want.probes["v"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.probes["trend"][:, 0],
                               want.probes["trend"][:, 0], atol=V_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.probes["trend"][:, 1],
                               want.probes["trend"][:, 1], rtol=1e-4)
    np.testing.assert_allclose(got.probes["ultra"], want.probes["ultra"],
                               **ULTRA_TOL)
    assert [s[:2] for s in got_seen] == [s[:2] for s in want_seen]
    for (_, _, g), (_, _, w) in zip(got_seen, want_seen):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    for k in want.state:
        np.testing.assert_allclose(
            got.state[k], want.state[k], err_msg=k,
            **(dict(atol=V_ATOL, rtol=0) if k == "V" else
               dict(rtol=1e-3, atol=1e-5)))
    with pytest.raises(RuntimeError, match="only valid"):
        Simulation(sim_model, device="cpu").probe_at_step(0, "trend")


def test_run_volume_matches_jax():
    """Courtemanche at 4x16x24, 3 outer steps, against the JAX engine's
    run_volume (kernel='xla')."""
    c = cfg(width=24, height=16, dt=0.05)
    jm, tm = models(width=24, height=16, dt=0.05)
    st = volume.volume_state(tm, 4)
    st["V"][0] += 5.0
    want = jax_run_volume(jm, 4, 3, state=st, kernel="xla")
    got = run_volume(tm, 4, 3, state=st, device="cpu")
    assert volume.volume_route(tm, 4, "cuda", "auto") == "substep"
    assert volume.volume_route(tm, 4, "cpu", "auto") == "plain"
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-5,
                               rtol=0)
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], np.asarray(want[0][k]),
                                   err_msg=k, **TOL)
    tab = tc.Courtemanche(c.replace(table=True))
    assert volume.volume_route(tab, 4, "cuda", "auto") == "plain"
    with pytest.raises(ValueError, match="table-mode gathers"):
        volume.volume_route(tab, 4, "cuda", "pallas")
    assert volume._use_shard_kernel(tm, "cuda", "auto")
    assert not volume._use_shard_kernel(tab, "cuda", "auto")
    with pytest.raises(ValueError, match="table-mode gathers"):
        volume._use_shard_kernel(tab, "cuda", "pallas")
    final, probes, _ = run_volume(tm, 20, 1, mesh=make_mesh(
        devices=["cpu"] * 2), wide_halo=True)
    assert final["V"].shape == (20,) + tm.state_shape()


@pytest.mark.parametrize("cls", ["Courtemanche", "CourtemancheUltra"])
def test_volume_kernel_plain_matches_jax_volume_step(cls):
    """4x24x32, dz_ratio 0.5, 2 outer steps: the plain version of the
    volume substep kernel (probe included) against the JAX model's step on
    its volume geometry."""
    jm, tm = models(cls, width=32, height=24, dt=0.05)
    plane = seeded_state(tm, seed=10)
    rng = np.random.RandomState(11)
    st = {k: np.repeat(v[None], 4, axis=0) for k, v in plane.items()}
    st["V"] = (st["V"] + rng.uniform(-2.0, 2.0, st["V"].shape)).astype(
        np.float32)
    jgeom = jax_volume_geometry(dz_ratio=0.5)
    jstep = lambda s: jm.step(s, jgeom)
    step = cuda_volume.make_volume_step(tm, 4, dz_ratio=0.5)
    want, got = to_jax(st), interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(2)
    pixel = cuda_volume.volume_probe_pixel(tm, 4)
    for i in range(2):
        want = jstep(want)
        got = step(got, probe, i)
        ref = (float(want["V"][pixel]) - jm.min_v) / (jm.max_v - jm.min_v)
        assert abs(float(probe[i]) - ref) <= 1e-5
    assert_states_close(got, want, **TOL)
