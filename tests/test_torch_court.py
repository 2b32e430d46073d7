"""The port's Courtemanche model held against fib_tf_tpu's on the CPU: the
constants, the intermediates (their singular points included), the table
and the Chebyshev fits, one solve and one outer step in every rate mode and
flag set, the chronic plane, the goldens, the substep kernel's plain
version against the JAX whole-grid Pallas kernel (interpret mode, as
tests/test_pallas.py runs it), the cell body's host side, the interop
carrier and the routes.

Tolerances: numpy float64 copies bit for bit; float32 intermediates rtol
1e-4 (elementwise float32 arithmetic, one libm against another); a solve, a
step and the kernel's plain version rtol 1e-3 / atol 1e-5 on every plane,
the JAX package's kernel-vs-XLA bound (tests/test_pallas.py:90-97); the
goldens 1e-3 of the model's 150 mV range (tests/test_golden.py).
Courtemanche-ultra and the engine are tests/test_torch_court_ultra.py."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.courtemanche as jc
import fib_tf_tpu.ops.table as jtable
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.models import grid_geometry as jax_grid_geometry
from fib_tf_tpu.ops.pallas_step import make_pallas_step
import fib_tf_tpu_torch.models.courtemanche as tc
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation, simulation
from fib_tf_tpu_torch.kernels import build
from fib_tf_tpu_torch.models import MODEL_REGISTRY, cell_geometry, grid_geometry
from fib_tf_tpu_torch.ops import (bodies, cuda_block, cuda_step, cuda_tiled,
                                  cuda_volume, stencil, table)
from fib_tf_tpu_torch.parallel import make_mesh
from test_torch_fixtures import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = dict(rtol=1e-3, atol=1e-5)
INTER_TOL = dict(rtol=1e-4, atol=1e-30)
# us_infinity's alpha is 1 - tanh near saturation, where one ulp of tanh is
# up to 1% of it (3.6e-7 apart at V = 50 mV between the two libms)
US_INF_TOL = dict(rtol=1e-4, atol=1e-6)
V_ATOL = 1e-3 * (tc.Courtemanche.max_v - tc.Courtemanche.min_v)
# every flag set of the model the kernels and the plain path carry
FLAGS = {
    "direct": {},
    "cheby": dict(court_cheby=True),
    "cheby-unfolded": dict(court_cheby=True, cheby_fold=False),
    "table": dict(table=True),
    "healthy": dict(chronic=False),
    "g_scale": dict(g_scale={"g_Na": 0.6, "g_CaL": 0.7, "g_Kr": 1.3,
                             "g_Ks": 0.5, "g_to": 0.8, "g_Kur": 0.9,
                             "g_K1": 1.2, "g_NaK": 1.1, "g_NaCa": 0.95,
                             "g_pCa": 0.9, "g_bNa": 1.05, "g_bCa": 1.1,
                             "g_bK": 2.0}),
    "dv_max": dict(dv_max=2.0),
}


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


def cfg(**kw):
    base = dict(width=16, height=16, dt=0.1, diff=0.809, duration=1)
    base.update(kw)
    return SimConfig(**base)


def models(cls_name="Courtemanche", chronic_plane=None, **kw):
    """The JAX model and the port's, the port's given the JAX model's
    parameters through the interop carrier."""
    c = cfg(**kw)
    jm = getattr(jc, cls_name)(jax_cfg(c))
    if chronic_plane is not None:
        jm.set_het(chronic=chronic_plane)
    tm = carry(jm, getattr(tc, cls_name)(c))
    return jm, tm


def carry(jm, tm):
    return interop.court_params_from_numpy(
        tm,
        cheby=(None if jm._cheby is None
               else {k: np.asarray(v) for k, v in jm._cheby.items()}),
        table=None if jm._table is None else np.asarray(jm._table),
        het=dict(jm.het), scales=dict(jm.scales))


def seeded_state(model, seed=0):
    """The initial state with V drawn per cell over [-90, 40] mV (the
    upstroke and the plateau) and every gate and concentration scaled per
    cell by up to 5%."""
    rng = np.random.RandomState(seed)
    st = model.initial_state()
    shape = model.state_shape()
    for k, v in st.items():
        if k.startswith("_p_"):
            continue
        st[k] = (v * rng.uniform(0.95, 1.05, shape)).astype(np.float32)
    st["V"] = rng.uniform(-90.0, 40.0, shape).astype(np.float32)
    st["u_gate"] = rng.uniform(0.0, 0.2, shape).astype(np.float32)
    return st


def to_jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def assert_states_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, np.asarray(want[k]), err_msg=k, **tol)


# -- the pinned copies -------------------------------------------------------------


def test_constants_equal_jax():
    names = [n for n in dir(jc) if n.isupper()]
    assert len(names) == 52
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n
    jm, tm = models()
    for attr in ("name", "min_v", "max_v", "depol", "dt_per_step",
                 "pot_key", "fast_states", "HET_PARAMS", "SCALE_PARAMS",
                 "INITIAL_VALUES", "FITTED_GATES", "HET_PREFIX",
                 "probe_pixel", "trend_points"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.state_keys() == jm.state_keys()
    assert len(tm.state_keys()) == 21
    for s1 in (True, False):
        want, got = jm.initial_state(s1), tm.initial_state(s1)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for k in tm.state_keys():
        assert tm.dt_for(k) == jm.dt_for(k), k
    assert MODEL_REGISTRY["court"] is MODEL_REGISTRY["courtemanche"] is (
        tc.Courtemanche)
    assert MODEL_REGISTRY["court_ultra"] is tc.CourtemancheUltra


def test_intermediates_match_jax_over_the_voltage_range():
    """V over [-100, 50] mV and at the singular points: the float64 numpy
    forms bit for bit, the float32 torch forms at INTER_TOL."""
    v = np.concatenate([
        np.linspace(-100.0, 50.0, 3001),
        [-10.0001, 7.9, -47.13, -47.1305, -14.1, 3.3328, 19.9, -40.0,
         -40.0001, -39.9999],
    ])
    want = jc.calc_intermediates_np(v)
    got = tc.calc_intermediates_np(v)
    assert tuple(want) == tuple(got) or set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    v32 = v.astype(np.float32)
    want = jc.calc_intermediates(jnp.asarray(v32), ultra_slow=True)
    got = tc.calc_intermediates(torch.tensor(v32), ultra_slow=True)
    assert set(got) == set(want) == set(jc.INTER_KEYS) | {"us_infinity",
                                                          "tau_us"}
    for k in want:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), err_msg=k,
            **(US_INF_TOL if k == "us_infinity" else INTER_TOL))
    us_inf, tau_us = tc.us_rates(torch.tensor(v32))
    ref_inf, ref_tau = jc.us_rates(jnp.asarray(v32))
    np.testing.assert_allclose(us_inf.numpy(), np.asarray(ref_inf),
                               **US_INF_TOL)
    np.testing.assert_allclose(tau_us.numpy(), np.asarray(ref_tau),
                               **INTER_TOL)
    hj = tc.calc_hj_rates(torch.tensor(v32))
    for k, t in hj.items():
        np.testing.assert_array_equal(t.numpy(), got[k].numpy(), err_msg=k)


def test_table_matches_jax():
    """build_table bit for bit; row_index truncates toward zero and
    clamps; lookup picks the same rows."""
    assert (table.TABLE_ROWS, table.V_OFFSET) == (jtable.TABLE_ROWS,
                                                  jtable.V_OFFSET)
    want = jtable.build_table(jc.calc_intermediates_np, jc.INTER_KEYS)
    got = table.build_table(tc.calc_intermediates_np, tc.INTER_KEYS)
    assert got.dtype == np.float32 and got.shape == (150, 30)
    np.testing.assert_array_equal(got, want)
    v = np.float32([-130.0, -100.5, -100.0, -99.99, -0.5, 0.0, 0.7, 48.9,
                    49.0, 49.5, 60.0])
    rows = table.row_index(torch.tensor(v)).numpy()
    np.testing.assert_array_equal(rows, np.asarray(jtable.row_index(
        jnp.asarray(v))))
    assert list(rows[:4]) == [0, 0, 0, 0] and rows[-1] == 149
    picked = table.lookup(torch.tensor(got), torch.tensor(v), tc.INTER_KEYS)
    ref = jtable.lookup(jnp.asarray(want), jnp.asarray(v), jc.INTER_KEYS)
    for k in ref:
        np.testing.assert_array_equal(picked[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("fold", [True, False])
def test_chebyshev_fits_match_jax(fold):
    assert (tc.CHEBY_SMOOTH_KEYS, tc.CHEBY_DEG_COURT,
            tc.CHEBY_SAMPLES_COURT) == (jc.CHEBY_SMOOTH_KEYS,
                                        jc.CHEBY_DEG_COURT,
                                        jc.CHEBY_SAMPLES_COURT)
    c = cfg(court_cheby=True, cheby_fold=fold)
    jm, tm = jc.Courtemanche(jax_cfg(c)), tc.Courtemanche(c)
    assert set(tm.cheby_coef) == set(jm._cheby)
    assert len(tm.cheby_coef) == 26 + (10 if fold else 0)
    for k, want in jm._cheby.items():
        np.testing.assert_array_equal(tm.cheby_coef[k], want, err_msg=k)
    assert tm.rate_mode == ("fold" if fold else "cheby")


# -- one solve and one step -----------------------------------------------------------


@pytest.mark.parametrize("flags", sorted(FLAGS) + ["chronic-plane"])
def test_solve_and_step_match_jax(flags):
    """16x16 from a seeded state: one solve (every plane advanced) and one
    outer step (the fast commit, the slow commit, nine fast commits), port
    plain against the JAX model."""
    plane = None
    if flags == "chronic-plane":
        plane = np.random.RandomState(3).uniform(0.0, 1.0, (16, 16)).astype(
            np.float32)
    jm, tm = models(chronic_plane=plane, **FLAGS.get(flags, {}))
    st = seeded_state(tm, seed=1)
    jgeom, geom = jax_grid_geometry(), grid_geometry()
    want = jm.solve(to_jax(st), jgeom)
    assert_states_close(tm.solve(interop.state_from_numpy(st, "cpu"), geom),
                        want, **TOL)
    want = jm.step(to_jax(st), jgeom)
    got = cuda_step.plain_step(tm, interop.state_from_numpy(st, "cpu"))
    assert_states_close(got, want, **TOL)
    if plane is not None:
        np.testing.assert_array_equal(got["_p_chronic"].numpy(), plane)


def test_constant_chronic_plane_equals_global_flag():
    """A chronic plane of ones (zeros) is the global flag chronic=True
    (False) bit for bit from the initial state, as tests/test_hetero.py
    holds the JAX model.  (Away from rest, the plane's prefactor formed in
    float32 and the flag's formed in double part by an ulp in both
    packages.)"""
    for val, flag in ((1.0, True), (0.0, False)):
        mf = tc.Courtemanche(cfg(chronic=flag))
        mp = tc.Courtemanche(cfg(chronic=not flag))
        mp.set_het(chronic=np.full((16, 16), val, np.float32))
        sf = interop.state_from_numpy(mf.initial_state(), "cpu")
        sp = interop.state_from_numpy(mp.initial_state(), "cpu")
        assert set(sp) == set(sf) | {"_p_chronic"}
        of = mf.step(sf, grid_geometry())
        op = mp.step(sp, grid_geometry())
        for k in of:
            assert torch.equal(of[k], op[k]), k


@pytest.mark.parametrize("name,kw", [("court_ap", {}),
                                     ("court_table_ap", dict(table=True))])
def test_golden(name, kw):
    """0D action potential against tests/golden/, as tests/test_golden.py
    drives it: V = 20 mV, 400 outer steps (one cell: the state's shape does
    not enter a 0D step)."""
    model = tc.Courtemanche(SimConfig(width=8, height=8, dt=0.1, duration=1,
                                      **kw))
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
    want = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    np.testing.assert_allclose(np.float32(trace), want, atol=V_ATOL, rtol=0)


# -- the substep kernel's plain version ---------------------------------------------


def test_substep_kernel_plain_matches_jax_pallas_step():
    """24x128 (an aligned grid that holds the probe pixel), the hybrid
    fits with folded gates, 2 outer steps: eleven launches' plain version
    (probe included) against the JAX whole-grid kernel in interpret
    mode."""
    jm, tm = models(width=128, height=24, court_cheby=True)
    st = seeded_state(tm, seed=2)
    jstep = make_pallas_step(jm, interpret=True)
    step = cuda_step.make_cuda_step(tm)
    want, got = to_jax(st), interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(2)
    for i in range(2):
        want = jstep(want)
        got = step(got, probe, i)
        assert abs(float(probe[i]) - float(jm.probe(want))) <= 1e-5
    assert_states_close(got, want, **TOL)


def test_plain_substeps_are_the_commits():
    """A launch's plain version: SLOW=false commits V, Na_i, m and h and
    SLOW=true the 17 slow planes, and the slow commit reads the new V."""
    _, tm = models()
    st = interop.state_from_numpy(seeded_state(tm, seed=5), "cpu")
    before = {k: v.clone() for k, v in st.items()}
    cuda_step.plain_substep(tm, st, False)
    changed = {k for k in st if not torch.equal(st[k], before[k])}
    assert changed == {"V", "Na_i", "m", "h"}
    mid = {k: v.clone() for k, v in st.items()}
    cuda_step.plain_substep(tm, st, True)
    changed = {k for k in st if not torch.equal(st[k], mid[k])}
    assert changed == set(tm.state_keys()) - {"V", "Na_i", "m", "h"}
    assert st["V"] is not before["V"] and torch.equal(st["V"], mid["V"])
    want = tm.slow_commit(tm.fast_commit(before, grid_geometry()),
                          grid_geometry())
    for k in want:
        assert torch.equal(st[k], want[k]), k


# kernel 1's cached forms, on the card test's cases and state
# (tests/test_torch_cuda.py COURT_FLAGS and _court_state)
CACHE_CASES = {
    "direct": {},
    "blocked": dict(chronic=False, dv_max=2.0, g_scale=(
        ("g_Na", 0.9), ("g_CaL", 0.7), ("g_Kr", 1.3), ("g_Ks", 1.1),
        ("g_to", 0.6), ("g_Kur", 0.5), ("g_K1", 1.2), ("g_NaK", 0.95),
        ("g_NaCa", 1.15), ("g_pCa", 0.85), ("g_bNa", 1.05), ("g_bCa", 0.9),
        ("g_bK", 2.0))),
    "chronic-plane": {},
}


def court_state(model):
    """The initial state with V raised per cell by a seeded N(0, 1) mV,
    then 12 plain outer steps."""
    rng = np.random.RandomState(1)
    st = model.initial_state()
    st["V"] = st["V"] + rng.normal(0, 1.0, st["V"].shape).astype(np.float32)
    s = interop.state_from_numpy(st, "cpu")
    for _ in range(12):
        cuda_step.plain_step(model, s)
    return s


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cached_fast_commits_equal_the_fast_commits(case):
    """The plain version of kernel 1's cached forms at 67x131: the cache
    that a slow commit stores (the model's `fast_invariants`) serves the
    nine fast commits after it (`plain_cached_substep`) bit for bit as the
    planes
    serve `plain_substep`'s, since no fast commit writes a plane it reads;
    and the cache is never part of the state."""
    model = tc.Courtemanche(SimConfig(height=67, width=131, dt=0.1,
                                      diff=0.809, **CACHE_CASES[case]))
    if case == "chronic-plane":
        plane = np.zeros((67, 131), np.float32)
        plane[:, :65] = 1.0
        model.set_het(chronic=plane)
    st = court_state(model)
    cuda_step.plain_substep(model, st, False)
    cuda_step.plain_substep(model, st, True)
    cache = model.fast_invariants(st)
    assert tuple(cache) == bodies.cell_body(model).cache
    cached = {k: v.clone() for k, v in st.items()}
    for i in range(9):
        cuda_step.plain_substep(model, st, False)
        cuda_step.plain_cached_substep(model, cached, cache)
        for k in st:
            assert torch.equal(cached[k], st[k]), (i, k)
    assert set(cached) == set(model.state_keys())
    assert set(interop.state_to_numpy(cached)) == set(model.state_keys())
    assert not set(cache) & set(model.state_keys())


def test_cache_schedule():
    """Court's outer step on kernel 1: the fast commit computes its terms,
    the slow commit stores the cache and the nine fast commits read it;
    ultra and every other body have no cache; the cache is made per
    device, and anew when the state's shape changes."""
    _, tm = models()
    assert cuda_step.cache_schedule(tm.launch_schedule) == (
        (False, False) + (True,) * 9)
    assert bodies.COURT_CACHE == ("e_k", "e_ca", "i_cap", "p_to", "p_ks",
                                     "p_cal")
    assert [b.name for b in bodies.BODIES.values() if b.cache] == [
        "court"]
    assert [k.entry for k in (*cuda_step.KERNELS.values(),
                              *cuda_step.GEOM_KERNELS.values())
            if k.cache is not None] == ["court_substep",
                                        "court_substep_geom"]
    cache = cuda_step.CommitCache(bodies.COURT_CACHE)
    v = torch.zeros(5, 7)
    planes = cache.planes(v)
    assert planes.shape == (6, 5, 7) and cache.planes(v) is planes
    assert cache.pointers(v) == tuple(p.data_ptr() for p in planes)
    assert cache.planes(torch.zeros(5, 9)).shape == (6, 5, 9)
    assert cache.planes(v).shape == (6, 5, 7)
    assert cache.pointers(v) == tuple(p.data_ptr() for p in cache.planes(v))
    # a cache is read only by a fast commit of a body that has one
    for name, slow in (("br", False), ("court", True)):
        with pytest.raises(ValueError, match="reads one"):
            cuda_step.KERNELS[name].launch(None, {}, slow, None, (0, 0), 0,
                                           0, (), True)


# -- the cell body's host side, interop and routes --------------------------------------


def test_pack_court_folds_every_scale_factor():
    """With chronic=False, a dV cap and a distinct factor on each of the
    13 channels, every scalar slot of the kernel's parameter block holds
    its own conductance (the plain path's product, rounded to float32
    once; tolerance 1e-7 relative), so that no two slots can swap."""
    factors = dict(zip(tc.Courtemanche.SCALE_PARAMS,
                       (0.9, 0.7, 1.3, 1.1, 0.6, 0.5, 1.2, 0.95, 1.15, 0.85,
                        1.05, 0.8, 2.0)))
    tm = tc.Courtemanche(SimConfig(width=16, height=16, dt=0.1, diff=0.5,
                                   chronic=False, dv_max=2.0,
                                   g_scale=tuple(factors.items())))
    f = factors
    want = [
        0.0, 0.0,                              # direct rates, no plane
        100.0 * (f["g_to"] * tc.G_TO),         # k_to, k_kur, k_cal
        100.0,
        100.0 * (f["g_CaL"] * tc.G_CA_L),
        f["g_to"] * tc.G_TO, f["g_CaL"] * tc.G_CA_L,
        f["g_Kur"], f["g_K1"], f["g_Kr"], f["g_NaCa"],
        100.0 * (f["g_Ks"] * tc.G_KS),
        100.0 * (f["g_NaK"] * tc.I_NAK_MAX),
        tc.K_O / (tc.K_O + tc.KM_K_O),
        100.0 * (f["g_bK"] * tc.G_B_K),
        100.0 * (f["g_Na"] * tc.G_NA),
        100.0 * (f["g_bNa"] * tc.G_B_NA),
        100.0 * (f["g_pCa"] * tc.I_CAP_MAX),
        100.0 * (f["g_bCa"] * tc.G_B_CA),
        0.1, 1.0, 0.5 * 0.1,                   # dt, dt_slow, diff * dt
        2.0, 1.0,                              # the dV cap, and set
        -25.0, 75.0, -100.0, 1.0 / 150.0,      # Chebyshev domain, probe
    ]
    got = bodies.pack_params(tm)[36 * 13:]
    np.testing.assert_allclose(got, np.float32(want), rtol=1e-7, atol=0)


def test_cell_body_and_schedule():
    _, tm = models()
    body = bodies.cell_body(tm)
    assert body.name == "court" and body.kernels == (1, 3, 4, 6)
    assert body.planes == bodies.COURT_PLANES
    assert set(body.planes) - {"_p_chronic"} == set(tm.state_keys()) - {"V"}
    assert not body.writes_potential(True) and body.writes_potential(False)
    assert tm.launch_schedule == (False, True) + (False,) * 9
    params = bodies.pack_params(tm)
    assert params.size == body.param_floats == 36 * 13 + 28
    # the fits are zero with direct rates; the mode, the het flag and the
    # chronic prefactors follow the scalars' order (_pack_court)
    assert not params[:36 * 13].any()
    scalars = params[36 * 13:]
    assert scalars[0] == 0 and scalars[1] == 0
    assert scalars[2] == np.float32(0.5 * 100.0 * 0.1652)
    assert scalars[3] == 50.0 and scalars[4] == np.float32(
        (1.0 - 0.7) * 100.0 * 0.12375)
    assert list(scalars[19:22]) == [np.float32(0.1), np.float32(1.0),
                                    np.float32(0.809 * 0.1)]
    for key, mode in (("cheby", 2), ("cheby-unfolded", 1)):
        _, m = models(**FLAGS[key])
        p = bodies.pack_params(m)
        assert p[36 * 13] == mode
        assert p[:26 * 13].any() and p[26 * 13:36 * 13].any() == (mode == 2)
    _, het = models(chronic_plane=np.ones((16, 16), np.float32))
    assert bodies.pack_params(het)[36 * 13 + 1] == 1.0
    assert het.state_keys() == tuple(sorted(tm.state_keys()
                                            + ("_p_chronic",)))
    _, tab = models(table=True)
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        bodies.cell_body(tab)
    with pytest.raises(NotImplementedError, match="never routes"):
        cuda_tiled.make_tiled_cuda_step(tm)
    cuda_block.make_block_step(tm, False)
    assert cuda_block.KERNELS["court"].library_name == "court_block"
    assert "court" not in cuda_tiled.KERNELS
    assert cuda_volume.KERNELS["court"].library_name == "court_volume"
    assert cuda_step.KERNELS["court"].library_name == "court_substep"
    # the court library rounds as the plain path: no FMA contraction
    court_lib = bodies.BODIES["court"].library
    assert court_lib is bodies.BODIES["court_ultra"].library
    assert court_lib.flags == ("-fmad=false",)
    assert bodies.BODIES["br"].library.flags == ()
    src = [cuda_step.SOURCE]
    assert (build.library_path("k", src, flags=court_lib.flags)
            != build.library_path("k", src))
    assert cuda_step.GEOM_KERNELS["court"].entry == "court_substep_geom"


def test_interop_carries_the_jax_models_parameters():
    """The fits, the table, the het plane and the g_scale factors of a JAX
    model, carried as numpy arrays, make the port compute what it does."""
    c = cfg(court_cheby=True, g_scale={"g_Na": 0.5})
    jm = jc.Courtemanche(jax_cfg(c))
    jm._cheby = {k: v * (1.0 + 1e-3) for k, v in jm._cheby.items()}
    plane = np.linspace(0.0, 1.0, 256, dtype=np.float32).reshape(16, 16)
    jm.set_het(chronic=plane)
    jm.set_scale(g_Kr=2.0)
    tm = carry(jm, tc.Courtemanche(c))
    assert tm.scales == {"g_Na": 0.5, "g_Kr": 2.0}
    np.testing.assert_array_equal(tm.het["chronic"], plane)
    st = seeded_state(tm, seed=6)
    want = jm.step(to_jax(st), jax_grid_geometry())
    got = cuda_step.plain_step(tm, interop.state_from_numpy(st, "cpu"))
    assert_states_close(got, want, **TOL)
    with pytest.raises(ValueError, match="no table"):
        interop.court_params_from_numpy(tm, table=np.zeros((150, 30)))
    with pytest.raises(ValueError, match="fits"):
        interop.court_params_from_numpy(tm, cheby={"d_infinity": np.zeros(13)})
    with pytest.raises(ValueError, match="13 finite"):
        interop.court_params_from_numpy(
            tm, cheby={k: np.zeros(9) for k in tm.cheby_coef})


def test_het_planes_are_checked():
    _, tm = models()
    with pytest.raises(ValueError, match="no heterogeneous"):
        tm.set_het(g_to=np.ones((16, 16)))
    with pytest.raises(ValueError, match="shape"):
        tm.set_het(chronic=np.ones((4, 4)))
    with pytest.raises(ValueError, match="finite"):
        tm.set_het(chronic=np.full((16, 16), np.nan))
    tm.set_het(chronic=np.ones((16, 16)))
    assert tm.het_keys() == ("_p_chronic",)
    assert "_p_chronic" in tm.initial_state()
    tm.set_het(chronic=None)
    assert tm.het_keys() == ()


def test_routes():
    """Kernel 1 at every size on a CUDA device (the reference runs XLA
    past its 32 MB VMEM cap); table mode on the plain path, and raising
    under kernel='pallas'; on a mesh the block kernel, and table mode the
    plain step."""
    big = tc.Courtemanche(cfg(width=2048, height=2048))
    assert simulation.state_mb(big) == 21 * 16.0
    assert simulation.route(big, "cuda", "auto") == "substep"
    assert simulation.route(big, "cuda", "pallas") == "substep"
    assert simulation.route(big, "cpu", "auto") == "plain"
    tab = tc.Courtemanche(cfg(table=True))
    assert simulation.route(tab, "cuda", "auto") == "plain"
    with pytest.raises(ValueError, match="table-mode gathers"):
        simulation.route(tab, "cuda", "pallas")
    sim = Simulation(tc.Courtemanche(cfg(width=32, height=40)),
                     mesh=make_mesh(devices=["cpu"] * 4), wide_halo=True)
    assert sim.route == "plain" and sim._mesh.grid == (4, 1)
    assert simulation.spmd_route(big, "cuda", "auto", True) == "block"
    assert simulation.spmd_route(tab, "cuda", "auto", True) == "plain"
    with pytest.raises(ValueError, match="table-mode gathers"):
        simulation.spmd_route(tab, "cuda", "pallas", True)
    for kw in (dict(ab2=True), dict(adaptive_dv=10.0)):
        with pytest.raises(NotImplementedError):
            tc.Courtemanche(cfg(**kw))


def test_simulate_trend_stream_is_the_steps_probe():
    """Simulation on the CPU, 48x48 with an S2 at 9 ms, 20 ms: the "trend"
    stream, its live read in a cl_observer and the final state are those
    of the model's own outer steps paced by hand, bit for bit (the JAX
    engine's streams are held in tests/test_torch_court_ultra.py)."""
    c = cfg(width=48, height=48, dt_per_plot=10, duration=20)
    sim = Simulation(tc.Courtemanche(c), device="cpu").define()
    sim.add_pace_op("s2", "luq", 10.0)
    seen = []
    sim.cl_observer = lambda i, cl: seen.append(
        (i, sim.probe_at_step(i, "trend")))
    res = sim.simulate(schedule=[(9.0, "s2")])
    assert res.probes["trend"].shape == (20, 2) and len(seen) >= 1
    model = tc.Courtemanche(c)
    state = interop.state_from_numpy(model.initial_state(), "cpu")
    mask = torch.tensor(stencil.pace_mask(48, 48, "luq", 10.0,
                                          model.min_v))
    trend = []
    for i in range(20):
        state = model.step(state, grid_geometry())
        if i + 1 == 10:
            state["V"] = torch.maximum(state["V"], mask)
        trend.append(model.trend_probe(state).numpy())
    np.testing.assert_array_equal(res.probes["trend"], np.stack(trend))
    for i, value in seen:
        np.testing.assert_array_equal(value, trend[i])
    for k, v in state.items():
        np.testing.assert_array_equal(res.state[k], v.numpy(), err_msg=k)
