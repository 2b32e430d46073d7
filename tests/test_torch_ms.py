"""The port's Mitchell-Schaeffer model and the plain versions of its cell
body's kernels, held against fib_tf_tpu's model and its Pallas kernels (in
interpret mode, as tests/test_pallas.py runs them) on the CPU, plus the
model's analytic APD relation (tests/test_mitchell_schaeffer.py), the
engine and the routes that raise.

Tolerance: rtol 1e-3 / atol 1e-5 on both planes over one substep or two
outer steps, the JAX package's own kernel-vs-XLA bound
(tests/test_pallas.py:90-97); whole runs 1e-3 of the model's [0, 1] range
(tests/test_golden.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.mitchell_schaeffer as jms
import fib_tf_tpu_torch.models.mitchell_schaeffer as tms
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.engine import Simulation as JaxSimulation
from fib_tf_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from fib_tf_tpu.models import grid_geometry as jax_grid_geometry
from fib_tf_tpu.ops.pallas_step import make_pallas_step
from fib_tf_tpu.ops.pallas_tiled import block_geometry as jax_block_geometry
from fib_tf_tpu.ops.pallas_tiled import make_tiled_pallas_step
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation, simulation
from fib_tf_tpu_torch.models import MODEL_REGISTRY, cell_geometry, grid_geometry
from fib_tf_tpu_torch.ops import bodies, cuda_block, cuda_step, cuda_tiled
from test_torch_fixtures import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=1e-5)
U_ATOL = 1e-3 * (tms.MitchellSchaeffer.max_v - tms.MitchellSchaeffer.min_v)
K = tms.MitchellSchaeffer.dt_per_step


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


def cfg(**kw):
    base = dict(width=40, height=24, dt=0.1, diff=1.5, duration=1)
    base.update(kw)
    return SimConfig(**base)


def models(**kw):
    c = cfg(**kw)
    return jms.MitchellSchaeffer(jax_cfg(c)), tms.MitchellSchaeffer(c)


def seeded_state(model, seed=0):
    """Both planes drawn per cell from a seed (so the border differs from
    its neighbours), u on both sides of the gate threshold."""
    rng = np.random.RandomState(seed)
    shape = model.state_shape()
    return {"u": rng.uniform(0.0, 1.0, shape).astype(np.float32),
            "h": rng.uniform(0.1, 1.0, shape).astype(np.float32)}


def to_jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def assert_states_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, np.asarray(want[k]), err_msg=k, **tol)


def test_constants_equal_jax():
    for n in ("TAU_IN", "TAU_OUT", "TAU_OPEN", "TAU_CLOSE", "U_GATE"):
        assert getattr(tms, n) == getattr(jms, n), n
    assert tms.apd_max_analytic() == jms.apd_max_analytic()
    jm, tm = models()
    for attr in ("name", "min_v", "max_v", "depol", "dt_per_step",
                 "pot_key", "SCALE_PARAMS", "probe_pixel"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.state_keys() == jm.state_keys() == ("h", "u")
    for s1 in (True, False):
        want, got = jm.initial_state(s1), tm.initial_state(s1)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    # the gate's decay factors: the reference's float32 exp, to an ulp
    for dt in (0.1, 0.05):
        m = tms.MitchellSchaeffer(cfg(dt=dt))
        for got, tau in ((m.decay_open, tms.TAU_OPEN),
                         (m.decay_close, tms.TAU_CLOSE)):
            want = np.float32(jnp.exp(-dt / tau))
            assert abs(np.float32(got) - want) <= np.spacing(want)


def test_registry_names_match_reference():
    for name, cls in MODEL_REGISTRY.items():
        assert JAX_REGISTRY[name].__name__ == cls.__name__
    assert set(MODEL_REGISTRY) == {"br", "beeler_reuter", "fenton", "ms",
                                   "mitchell_schaeffer", "court",
                                   "courtemanche", "court_ultra", "lr1",
                                   "luo_rudy", "tp06", "tentusscher"}
    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)


def test_plain_solve_matches_jax_and_takes_the_raw_u():
    """One substep on a 24x40 state whose border differs from its
    neighbours.  The rates and the gate's threshold take the raw u, the
    diffusion u0: a body fed u0 for both fails on the border and nowhere
    else."""
    jm, tm = models()
    st = seeded_state(tm, seed=1)
    want = jm.solve(to_jax(st), jax_grid_geometry())
    state = interop.state_from_numpy(st, "cpu")
    got = cuda_step.plain_substep(tm, interop.state_from_numpy(st, "cpu"),
                                  True)
    assert_states_close(got, want, **TOL)

    geom = grid_geometry()
    wrong = tm.solve({**state, "u": geom.enforce_boundary(state["u"])},
                     geom)
    for k in ("u", "h"):
        bad = ~np.isclose(wrong[k].numpy(), np.asarray(want[k]), **TOL)
        assert bad.any(), k
        assert not bad[1:-1, 1:-1].any(), k


def _two_steps(jstep, step, st, jm, has_probe=True):
    want = to_jax(st)
    got = interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(2)
    for i in range(2):
        want = jstep(want)
        got = step(got, probe, i) if has_probe else step(got)
        if has_probe:
            assert abs(float(probe[i]) - float(jm.probe(want))) <= 1e-5
    assert_states_close(got, want, **TOL)


def test_substep_kernel_plain_matches_jax_pallas_step():
    jm, tm = models(height=16, width=128)
    _two_steps(make_pallas_step(jm, interpret=True),
               cuda_step.make_cuda_step(tm), seeded_state(tm, seed=2), jm,
               has_probe=False)


def test_tiled_kernel_plain_matches_jax_tiled_kernel():
    jm, tm = models(height=64, width=128)
    _two_steps(make_tiled_pallas_step(jm, 32, interpret=True),
               cuda_tiled.make_tiled_cuda_step(tm), seeded_state(tm, seed=3),
               jm)


@pytest.mark.parametrize("two_d", [False, True], ids=["4x1", "2x2"])
def test_block_kernel_plain_matches_jax_wide_halo_step(two_d):
    """The shard at (16, 24) of a 64x48 domain, extended by K = 10
    ghost rows (and columns), two outer steps: the plain block step
    against the JAX wide-halo step (`model.step` under the reference's
    `block_geometry`)."""
    jm, tm = models(height=64, width=48)
    rstart, cstart = 16 - K, (24 - K if two_d else 0)
    ext_h, ext_w = 16 + 2 * K, (24 + 2 * K if two_d else 48)
    rg = jnp.arange(rstart, rstart + ext_h, dtype=jnp.int32)[:, None]
    cg = (jnp.arange(cstart, cstart + ext_w, dtype=jnp.int32)[None, :]
          if two_d else None)
    jgeom = jax_block_geometry(rg, 64, cg, 48 if two_d else None)
    step = cuda_block.make_block_step(tm, two_d)
    full = seeded_state(tm, seed=4)
    for _ in range(2):
        # the ghosts past the domain's edge wrap, as the ring exchange's
        rows = np.arange(rstart, rstart + ext_h) % 64
        cols = np.arange(cstart, cstart + ext_w) % 48
        ext = {k: np.ascontiguousarray(v[np.ix_(rows, cols)])
               for k, v in full.items()}
        want = jm.step(to_jax(ext), jgeom)
        ext_in = interop.state_from_numpy(ext, "cpu")
        ext_out = {k: torch.zeros_like(v) for k, v in ext_in.items()}
        step(ext_in, ext_out, rstart, cstart)
        for k in want:
            np.testing.assert_allclose(
                cuda_block.centre(ext_out[k], K, two_d).numpy(),
                np.asarray(cuda_block.centre(want[k], K, two_d)),
                err_msg=k, **TOL)
        full = {k: np.asarray(v) for k, v in
                jm.step(to_jax(full), jax_grid_geometry()).items()}


def test_apd_matches_the_exact_gate_relation():
    """The 0D action potential from rest with a 0.3 kick (as
    tests/test_mitchell_schaeffer.py drives it): h closes exactly with
    tau_close, so the time above U_GATE is tau_close * ln(h_start / h_min),
    and it lies between APD_max and 1.3 APD_max."""
    m = tms.MitchellSchaeffer(SimConfig(width=4, height=4, dt=0.1))
    st = m.initial_state(s1=False)
    st["u"] = st["u"] + 0.3
    state = interop.state_from_numpy(st, "cpu")
    geom = cell_geometry()
    us, hs = [], []
    for _ in range(500):
        state = m.step(state, geom)
        us.append(float(state["u"][0, 0]))
        hs.append(float(state["h"][0, 0]))
    us, hs = np.array(us), np.array(hs)
    above = us > tms.U_GATE
    apd = above.sum() * 1.0   # outer step = 1 ms
    predicted = tms.TAU_CLOSE * np.log(hs[np.argmax(above)] / hs.min())
    assert apd == pytest.approx(predicted, rel=0.02)
    assert tms.apd_max_analytic() == pytest.approx(241.4, abs=0.5)
    assert tms.apd_max_analytic() < apd < 1.3 * tms.apd_max_analytic()
    assert 0.9 < us.max() <= 1.0 and us[-1] < 1e-3


def test_simulate_matches_jax_engine():
    c = cfg(width=64, height=64, dt_per_plot=10, duration=30)
    want = JaxSimulation(jms.MitchellSchaeffer(jax_cfg(c))).define().simulate()
    sim = Simulation(tms.MitchellSchaeffer(c), device="cpu").define()
    got = sim.simulate()
    assert got.steps == want.steps == 30
    assert got.cycle_lengths == want.cycle_lengths
    assert len(got.cycle_lengths) >= 1
    for k in want.state:
        np.testing.assert_allclose(got.state[k], want.state[k], err_msg=k,
                                   atol=U_ATOL, rtol=0)


def test_g_scale_matches_jax():
    scale = {"g_in": 0.7, "g_out": 1.3}
    jm, tm = models(g_scale=scale)
    assert tm.scales == jm.scales == scale
    st = seeded_state(tm, seed=5)
    want, got = to_jax(st), interop.state_from_numpy(st, "cpu")
    for _ in range(2):
        want = jm.step(want, jax_grid_geometry())
        got = cuda_step.plain_step(tm, got)
    assert_states_close(got, want, **TOL)
    np.testing.assert_array_equal(
        bodies.pack_params(tm),
        np.float32([0.1, 1.5 * 0.1, 0.7, 1.3, tm.decay_open, tm.decay_close,
                    0.0, 1.0]))


def test_cell_body_schedule_and_routes():
    _, tm = models()
    body = bodies.cell_body(tm)
    assert body.name == "ms" and body.planes == ("h",)
    assert body.param_floats == 8
    assert tm.launch_schedule == (True,) * 10
    large = tms.MitchellSchaeffer(cfg(width=4096, height=2048))
    assert simulation.state_mb(large) == 64.0
    assert simulation.route(large, "cuda", "auto") == "tiled"
    assert simulation.route(tm, "cuda", "auto") == "substep"
    assert simulation.spmd_route(tm, "cuda", "auto", True) == "block"


def test_unported_variants():
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        tms.MitchellSchaeffer(cfg(adaptive_dv=1.0))
    # the reference's model has no ab2 variant and ignores the flag
    assert tms.MitchellSchaeffer(cfg(ab2=True)).state_keys() == ("h", "u")
