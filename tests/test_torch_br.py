"""The port's Beeler-Reuter model and the plain version of its CUDA
substep, held against fib_tf_tpu's model and its fused Pallas kernel (run
in interpret mode on the CPU, as tests/test_pallas.py runs it)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.beeler_reuter as jbr
import fib_tf_tpu_torch.models.beeler_reuter as tbr
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.models import grid_geometry as jax_grid_geometry
from fib_tf_tpu.ops.pallas_step import make_pallas_step
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.models import cell_geometry, grid_geometry
from fib_tf_tpu_torch.ops import bodies, cuda_step
from test_torch_fixtures import one_torch_thread  # noqa: F401


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MODEL_TOL = dict(rtol=1e-3, atol=1e-5)   # tests/test_pallas.py:90-97


def cfg(**kw):
    base = dict(width=32, height=32, dt=0.1, diff=0.809, duration=1,
                cheby=True, skip=True)
    base.update(kw)
    return SimConfig(**base)


def seeded_state(model, seed=0):
    """The initial state (with S1 stripe), perturbed from a seed."""
    rng = np.random.RandomState(seed)
    st = model.initial_state()
    shape = model.state_shape()
    st["V"] = st["V"] + rng.normal(0, 2.0, shape).astype(np.float32)
    for g in tbr.GATES:
        st[g] = np.clip(st[g] * rng.uniform(0.9, 1.1, shape),
                        1e-5, 0.99999).astype(np.float32)
    st["C"] = (st["C"] * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
    return st


def assert_states_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, np.asarray(want[k]), err_msg=k, **tol)


def test_constants_equal_jax():
    assert tbr.RATE_PARAMS == jbr.RATE_PARAMS
    for name in ("G_S", "G_NA", "G_NAC", "E_NA", "C_M", "V_CLIP_LO",
                 "V_CLIP_HI", "CHEBY_DEG", "CHEBY_SAMPLES", "GATES",
                 "FAST_GATES", "SLOW_GATES"):
        assert getattr(tbr, name) == getattr(jbr, name), name
    for attr in ("name", "min_v", "max_v", "depol", "dt_per_step",
                 "pot_key", "SCALE_PARAMS"):
        assert getattr(tbr.BeelerReuter, attr) == getattr(
            jbr.BeelerReuter, attr), attr
    v = np.linspace(-90, 30, 7)
    for key, c in tbr.RATE_PARAMS.items():
        assert np.array_equal(tbr.rate_np(v, c), jbr.rate_np(v, c)), key


@pytest.mark.parametrize("skip,dt", [(True, 0.1), (False, 0.1), (True, 0.05)])
def test_cheby_coef_bit_equal_jax(skip, dt):
    c = cfg(skip=skip, dt=dt)
    want = jbr.BeelerReuter(jax_cfg(c))._cheby_coef
    got = tbr.BeelerReuter(c).cheby_coef
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_cheby_coef_from_numpy():
    c = cfg()
    jm = jbr.BeelerReuter(jax_cfg(c))
    coef = interop.cheby_coef_from_numpy(jm._cheby_coef)
    assert all(np.array_equal(coef[k], jm._cheby_coef[k]) for k in coef)
    assert coef["m_rl"] is not jm._cheby_coef["m_rl"]
    bad = dict(coef)
    del bad["i_k1"]
    with pytest.raises(ValueError, match="missing"):
        interop.cheby_coef_from_numpy(bad)
    with pytest.raises(ValueError):
        interop.cheby_coef_from_numpy({**coef, "m_inf": coef["m_inf"][:5]})
    # handed-over constants drive the port's model
    tm = tbr.BeelerReuter(c)
    tm.cheby_coef = interop.cheby_coef_from_numpy(
        {k: v * 0 + (k == "m_inf") for k, v in jm._cheby_coef.items()})
    st = interop.state_from_numpy(tm.initial_state(), "cpu")
    m1 = tm.solve(st, grid_geometry(), n=5)["m"]
    # m_inf == 1 and r == 0 everywhere: m stays put
    torch.testing.assert_close(m1, st["m"])


@pytest.mark.parametrize("n", [5, 0])
def test_plain_substep_matches_jax_solve(n):
    c = cfg()
    jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
    st = seeded_state(tm)
    want = jm.solve({k: jnp.asarray(v) for k, v in st.items()},
                    jax_grid_geometry(), n=n)
    got = cuda_step.plain_substep(
        tm, interop.state_from_numpy(st, "cpu"), slow=(n > 0))
    assert_states_close(got, want, **MODEL_TOL)
    if n == 0:
        for g in tbr.SLOW_GATES:
            np.testing.assert_array_equal(got[g].numpy(), st[g])


@pytest.mark.parametrize("skip", [True, False])
def test_two_outer_steps_match_jax_pallas_kernel(skip):
    """The port's plain step vs the JAX fused kernel as the engine routes
    BR (one substep per launch), interpreted on the CPU."""
    c = cfg(skip=skip)
    jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
    st = seeded_state(tm, seed=1)
    pstep = make_pallas_step(jm, substeps_per_launch=1)
    want = {k: jnp.asarray(v) for k, v in st.items()}
    got = interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(2)
    step = cuda_step.make_cuda_step(tm)
    for i in range(2):
        want = pstep(want)
        got = step(got, probe, i)
        assert abs(float(probe[i]) - float(jm.probe(want))) <= 1e-5
    assert_states_close(got, want, **MODEL_TOL)


def test_g_scale_matches_jax():
    scale = {"g_Na": 0.8, "g_NaC": 0.9, "g_s": 1.2, "g_K1": 0.5,
             "g_x1": 0.7}
    c = cfg(g_scale=scale)
    jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
    assert tm.scales == jm.scales == scale
    st = seeded_state(tm, seed=2)
    want = {k: jnp.asarray(v) for k, v in st.items()}
    got = interop.state_from_numpy(st, "cpu")
    for _ in range(2):
        want = jm.step(want, jax_grid_geometry())
        got = cuda_step.plain_step(tm, got)
    assert_states_close(got, want, **MODEL_TOL)
    # the kernel's parameters carry the same folded factors
    p = bodies.pack_params(tm)[len(bodies.FIT_ORDER) * 9:]
    np.testing.assert_array_equal(
        p[:5], np.float32([0.8 * 4.0, 0.9 * 0.005, 1.2 * 0.09, 0.5, 0.7]))
    with pytest.raises(ValueError):
        tm.set_scale(g_Kr=0.5)
    with pytest.raises(ValueError):
        tm.set_scale(g_Na=-1.0)


def test_golden_br_cheby_skip_ap():
    """0D action potential vs tests/golden/br_cheby_skip_ap.npy, as
    tests/test_golden.py drives it (stim -30 mV, 700 outer steps)."""
    model = tbr.BeelerReuter(
        SimConfig(width=8, height=8, dt=0.1, duration=1, cheby=True,
                  skip=True))
    geom = cell_geometry()
    st = model.initial_state(s1=False)
    st["V"][:] = -30.0
    state = interop.state_from_numpy(st, "cpu")
    trace = []
    for _ in range(700):
        state = model.step(state, geom)
        trace.append(float(state["V"][0, 0]))
    want = np.load(os.path.join(GOLDEN, "br_cheby_skip_ap.npy"))
    np.testing.assert_allclose(
        np.asarray(trace, np.float32), want,
        atol=1e-3 * (model.max_v - model.min_v), rtol=0)


@pytest.mark.parametrize("kw", [
    dict(cheby=False), dict(cheby_fold=False), dict(cheby_currents=False),
    dict(ab2=True), dict(adaptive_dv=1.0),
])
def test_unported_variants_raise(kw):
    """adaptive_dv still raises; the variants that raised before the rest
    of BR was ported construct and match the JAX model over two outer
    steps (tests/test_torch_br_variants.py holds the whole grid)."""
    if "adaptive_dv" in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tbr.BeelerReuter(cfg(**kw))
        return
    c = cfg(**kw)
    jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
    st = jm.initial_state() if c.ab2 else seeded_state(tm)
    st = {k: np.asarray(v, np.float32) for k, v in st.items()}
    want = {k: jnp.asarray(v) for k, v in st.items()}
    got = interop.state_from_numpy(st, "cpu")
    for _ in range(2):
        want = jm.step(want, jax_grid_geometry())
        got = cuda_step.plain_step(tm, got)
    assert_states_close(got, want, **MODEL_TOL)


def test_fold_guard_raises_on_mismatched_n():
    tm = tbr.BeelerReuter(cfg(skip=True))
    st = interop.state_from_numpy(tm.initial_state(), "cpu")
    with pytest.raises(ValueError, match="baked"):
        tm.solve(st, grid_geometry(), n=1)


def test_substep_schedule_and_state_keys():
    tm = tbr.BeelerReuter(cfg(skip=True))
    assert tm.launch_schedule == (True, False, False, False, False)
    assert tbr.BeelerReuter(
        cfg(skip=False)).launch_schedule == (True,) * 5
    assert tm.state_keys() == jbr.BeelerReuter(jax_cfg(cfg())).state_keys()


def test_pack_params_layout():
    tm = tbr.BeelerReuter(cfg())
    p = bodies.pack_params(tm)
    assert p.dtype == np.float32 and p.size == bodies.PARAM_FLOATS
    # each fit twice: its constant term apart and d1..d8, then all nine
    n = len(bodies.FIT_ORDER)
    rest = p[n:n * 9].reshape(-1, 8)
    rows = p[n * 9 + 12:].reshape(-1, 9)
    for i, key in enumerate(bodies.FIT_ORDER):
        want = tm.cheby_coef[key].astype(np.float32)
        np.testing.assert_array_equal(np.concatenate([p[i:i + 1], rest[i]]),
                                      want)
        np.testing.assert_array_equal(rows[i], want)
    np.testing.assert_array_equal(
        p[n * 9 + 5:n * 9 + 12],
        np.float32([0.1, 0.809 * 0.1, -30.0, 60.0, -90.0, 120.0, 0.0]))


def test_wrapper_routes_cpu_tensors_to_plain_version():
    tm = tbr.BeelerReuter(cfg())
    st = seeded_state(tm, seed=3)
    for slow in (True, False):
        probe_a, probe_b = torch.zeros(3), torch.zeros(3)
        a = cuda_step.substep(tm, interop.state_from_numpy(st, "cpu"), slow,
                              probe_a, 2)
        b = cuda_step.plain_substep(tm, interop.state_from_numpy(st, "cpu"),
                                    slow, probe_b, 2)
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert float(probe_a[2]) == float(probe_b[2]) != 0.0


def test_substep_updates_state_in_place():
    tm = tbr.BeelerReuter(cfg())
    st = interop.state_from_numpy(seeded_state(tm, seed=4), "cpu")
    m_before, v_before = st["m"], st["V"]
    m_old, v_old = m_before.clone(), v_before.clone()
    out = cuda_step.substep(tm, st, True)
    assert out is st
    assert st["m"] is m_before and not torch.equal(m_before, m_old)
    assert st["V"] is not v_before and torch.equal(v_before, v_old)


@pytest.mark.parametrize("breakage", [
    "dtype", "shape", "contiguity", "missing", "device_mix"])
def test_wrapper_rejects_bad_state(breakage):
    tm = tbr.BeelerReuter(cfg())
    st = interop.state_from_numpy(tm.initial_state(), "cpu")
    if breakage == "dtype":
        st["m"] = st["m"].double()
        err = TypeError
    elif breakage == "shape":
        st["h"] = st["h"][:-1]
        err = ValueError
    elif breakage == "contiguity":
        st["j"] = st["j"].t().contiguous().t()
        err = ValueError
    elif breakage == "missing":
        del st["C"]
        err = ValueError
    else:
        st["d"] = st["d"].to("meta")
        err = ValueError
    with pytest.raises(err):
        cuda_step.substep(tm, st, True)
    with pytest.raises(err):
        cuda_step.make_cuda_step(tm)(st)


def test_wrapper_rejects_bad_probe():
    tm = tbr.BeelerReuter(cfg())
    st = interop.state_from_numpy(tm.initial_state(), "cpu")
    with pytest.raises(IndexError):
        cuda_step.substep(tm, st, True, torch.zeros(2), 2)
    with pytest.raises(ValueError):
        cuda_step.substep(tm, st, True, torch.zeros(2, dtype=torch.float64))
    small = tbr.BeelerReuter(cfg(height=16))   # probe row 20 is off-grid
    st = interop.state_from_numpy(small.initial_state(), "cpu")
    with pytest.raises(ValueError, match="probe pixel"):
        cuda_step.substep(small, st, True, torch.zeros(1))


def test_interop_round_trip():
    tm = tbr.BeelerReuter(cfg())
    st = seeded_state(tm, seed=5)
    back = interop.state_to_numpy(interop.state_from_numpy(st, "cpu"))
    assert set(back) == set(st)
    for k in st:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], st[k])
