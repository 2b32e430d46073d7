"""The port's ten Tusscher-Panfilov 2006 model held against fib_tf_tpu's on
the CPU: the constants, cell types and rate functions, the transmural
helpers, one solve for n in {10, 0, 1} in every cell type, with the
transmural planes, a g_kr plane alone and every g_scale factor, the GHK
drive and its declared window, the goldens, the kernels' plain versions
(the JAX model's outer step, the JAX whole-grid Pallas kernel in
interpret mode, the JAX volume step), the engine at 48x48, the cell
body's host side, the interop carrier and the routes.

Tolerances as tests/test_torch_lr1.py's: one solve rtol 1e-5 / atol 1e-7
(the two libms' exp part by an ulp at a few cells); an outer step, a
kernel's plain version and the engine rtol 1e-3 / atol 1e-5, V within 1e-3
of the model's range across an upstroke; the goldens 1e-3 of the model's
140 mV range.  The interpret-mode kernel evaluates expm1 by its Taylor /
exp - 1 form (fib_tf_tpu/ops/integrators.py): it meets the port at the
kernel tolerance."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.base as jbase
import fib_tf_tpu.models.tp06 as jt
import fib_tf_tpu_torch.models.tp06 as tt
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.models import MODEL_REGISTRY, grid_geometry
from fib_tf_tpu_torch.ops import bodies, cuda_step
from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_lr1 import (GOLDEN, RATE_TOL, SOLVE_TOL, TOL, V_SWEEP,
                            assert_states_close, cfg, check_pallas_step,
                            check_plain_step_matches_jax, check_routes,
                            check_simulate_matches_jax, check_volume_step,
                            geometries, golden_trace, models, seeded_state,
                            to_jax)

V_ATOL = 1e-3 * (tt.TenTusscher06.max_v - tt.TenTusscher06.min_v)
G_SCALE = {k: 0.8 + 0.05 * i
           for i, k in enumerate(tt.TenTusscher06.SCALE_PARAMS)}
# the configurations one solve is held in: each cell type (m also set
# after construction), the transmural planes, a g_kr plane alone, and every
# g_scale factor on the transmural planes
CASES = ("epi", "endo", "m", "m-after", "transmural", "g_kr", "g_scale")


def kr_plane(shape, seed=8):
    """A relative IKr dose plane drawn per cell in [0.2, 1]."""
    return np.random.RandomState(seed).uniform(0.2, 1.0, shape).astype(
        np.float32)


def case_models(case, **kw):
    """The JAX model and the port's for one of CASES (the port's given the
    JAX model's parameters through the interop carrier)."""
    flags = dict(kw)
    if case in ("epi", "endo", "m", "transmural"):
        flags["cell_type"] = case
    elif case == "g_scale":
        flags.update(cell_type="transmural", g_scale=G_SCALE)
    jm, tm = models(jt.TenTusscher06, tt.TenTusscher06, **flags)
    if case == "m-after":
        jm.cell_type = "m"
    if case == "g_kr":
        jm.set_het(g_kr=kr_plane(jm.state_shape()))
    interop.tp06_params_from_numpy(tm, cell_type=jm.cell_type,
                                   het=dict(jm.het), scales=dict(jm.scales))
    return jm, tm


# -- the pinned copies -------------------------------------------------------------


def test_constants_equal_jax():
    names = [n for n in dir(jt) if n.isupper()]
    assert len(names) == 54
    for n in names:
        assert getattr(tt, n) == getattr(jt, n), n
    for case in ("epi", "endo", "m", "transmural"):
        jm, tm = case_models(case)
        for attr in ("name", "min_v", "max_v", "depol", "dt_per_step",
                     "pot_key", "default_dt", "cell_type", "HET_PARAMS",
                     "SCALE_PARAMS", "positive_states", "probe_pixel"):
            assert getattr(tm, attr) == getattr(jm, attr), (case, attr)
        assert tm.state_keys() == jm.state_keys()
        assert set(tm.het) == set(jm.het)
        for s1 in (True, False):
            want, got = jm.initial_state(s1), tm.initial_state(s1)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(tm.state_keys()) == 22
    assert MODEL_REGISTRY["tp06"] is MODEL_REGISTRY["tentusscher"] is (
        tt.TenTusscher06)


@pytest.mark.parametrize("which", ["fast", "slow"])
def test_rates_match_jax_over_the_voltage_range(which):
    """gate_rates over V in [-110, 70] mV, each `which` half, in each cell
    type and with an endo blend plane; fcass_rates over CaSS; k1_inf over
    V and E_K: the float64 numpy forms bit for bit, the float32 torch
    forms at RATE_TOL."""
    gates = tt.FAST_GATES if which == "fast" else tt.SLOW_GATES
    assert (tt.FAST_GATES, tt.SLOW_GATES, tt.GATES_V) == (
        jt.FAST_GATES, jt.SLOW_GATES, jt.GATES_V)
    v32 = V_SWEEP.astype(np.float32)
    w = np.random.RandomState(2).uniform(0.0, 1.0, v32.shape).astype(
        np.float32)
    for kw in (dict(cell_type="epi"), dict(cell_type="endo"),
               dict(cell_type="m"), dict(endo_w=w)):
        np_kw = dict(kw, endo_w=w.astype(np.float64)) if "endo_w" in kw \
            else kw
        want = jt.gate_rates(V_SWEEP, xp=np, which=gates, **np_kw)
        got = tt.gate_rates(V_SWEEP, xp=np, which=gates, **np_kw)
        assert set(got) == set(want) == set(gates)
        for g in want:
            for a, b in zip(got[g], want[g]):
                np.testing.assert_array_equal(a, b, err_msg=g)
        jkw = dict(kw, endo_w=jnp.asarray(w)) if "endo_w" in kw else kw
        tkw = dict(kw, endo_w=torch.tensor(w)) if "endo_w" in kw else kw
        want = jt.gate_rates(jnp.asarray(v32), which=gates, **jkw)
        got = tt.gate_rates(torch.tensor(v32), which=gates, **tkw)
        for g in want:
            for a, b in zip(got[g], want[g]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           err_msg=(kw.keys(), g),
                                           **RATE_TOL)
    ca = np.geomspace(1e-6, 1e-1, 501)
    for a, b in zip(tt.fcass_rates(ca, xp=np), jt.fcass_rates(ca, xp=np)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tt.fcass_rates(torch.tensor(ca, dtype=torch.float32)),
                    jt.fcass_rates(jnp.asarray(ca, jnp.float32))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **RATE_TOL)
    e_k = np.linspace(-95.0, -80.0, V_SWEEP.size)
    np.testing.assert_array_equal(tt.k1_inf(V_SWEEP, e_k, xp=np),
                                  jt.k1_inf(V_SWEEP, e_k, xp=np))
    np.testing.assert_allclose(
        tt.k1_inf(torch.tensor(v32), torch.tensor(e_k.astype(np.float32)))
        .numpy(),
        np.asarray(jt.k1_inf(jnp.asarray(v32), jnp.asarray(
            e_k.astype(np.float32)))), **RATE_TOL)


def test_transmural_helpers_match_jax():
    """transmural_planes, blended_s_rest and transmural_volume_state bit
    for bit, at the default bands and at 0.3 / 0.7."""
    for bands in ((0.25, 0.60), (0.3, 0.7)):
        c = cfg(width=50, height=6, cell_type="transmural",
                cell_type_bands=bands)
        jm, tm = models(jt.TenTusscher06, tt.TenTusscher06,
                        width=50, height=6, cell_type="transmural",
                        cell_type_bands=bands)
        for a, b in zip(tt.transmural_planes(c), jt.transmural_planes(c)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        w = np.linspace(0.0, 1.0, 11, dtype=np.float32)
        np.testing.assert_array_equal(tt.blended_s_rest(w),
                                      jt.blended_s_rest(w))
        want = jt.transmural_volume_state(jm, 5)
        got = tt.transmural_volume_state(tm, 5)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="transmural"):
        tt.transmural_volume_state(tt.TenTusscher06(cfg()), 3)


# -- one solve, the GHK drive, the goldens ----------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_solve_matches_jax(case):
    """A 24x40 seeded state (its border differs from its neighbours): one
    solve for n in {10, 0, 1} against the JAX model's solve (SOLVE_TOL:
    the two libms' exp part by an ulp at a few cells); the het planes
    pass through unchanged, and n = 0 leaves the slow gates."""
    jm, tm = case_models(case)
    st = seeded_state(tm, seed=1)
    for n in (10, 0, 1):
        want = jm.solve(to_jax(st), jbase.grid_geometry(), n=n)
        got = tm.solve(interop.state_from_numpy(st, "cpu"), grid_geometry(),
                       n=n)
        assert_states_close(got, want, **SOLVE_TOL)
        for k in tm.het_keys() + (tt.SLOW_GATES if n == 0 else ()):
            np.testing.assert_array_equal(got[k].numpy(), st[k])


def test_ghk_limit_and_its_window():
    """The L-type drive at V = 15 mV exactly and at |x| just under and
    just over 1e-4 (x = 2 (V - 15) F/RT): the limit branch below, the
    formula above, both within float32 of the continuous function, and
    equal to the JAX model's I_CaL there.  The declared window is where
    float32 evaluation is ill-conditioned: the switch to the limit jumps
    by ~x/2 relative, so near V = 15 the float32 drive parts from the
    float64 function by more than 20x what it does elsewhere."""
    tm = tt.TenTusscher06(cfg())
    assert tm.ill_conditioned == ((15.0, 15.0),)
    assert tt.GHK_EPS == 1e-4
    dv = tt.GHK_EPS / (2.0 * tt.F_RT)
    v = np.float32([15.0, 15.0 + 0.98 * dv, 15.0 - 0.98 * dv,
                    15.0 + 1.02 * dv, 15.0 - 1.02 * dv])
    ca = np.float32([7e-5, 1e-4, 2e-4, 7e-5, 3e-4])
    x = 2.0 * (v.astype(np.float64) - 15.0) * tt.F_RT
    assert (np.abs(x[:3]) < 1e-4).all() and (np.abs(x[3:]) > 1e-4).all()

    def exact(v64, ca64):
        x = 2.0 * (v64 - 15.0) * tt.F_RT
        num = 0.25 * ca64 * np.exp(x) - 2.0
        with np.errstate(invalid="ignore"):
            f = (v64 - 15.0) * num / np.expm1(x)
        return np.where(x == 0.0, 0.5 * tt.RTF * (0.25 * ca64 - 2.0), f)

    got = tt.ghk_drive(torch.tensor(v), torch.tensor(ca)).numpy()
    limit = np.float32(0.5 * tt.RTF) * (np.float32(0.25) * ca - np.float32(2))
    np.testing.assert_array_equal(got[:3], limit[:3])
    np.testing.assert_allclose(got, exact(v.astype(np.float64),
                                          ca.astype(np.float64)), rtol=1e-4)
    # the JAX model's I_CaL at the same cells (gates at 0.5)
    jm = jt.TenTusscher06(JaxSimConfig(width=8, height=8, dt=0.02,
                                        duration=1))
    st = {k: np.full((1, 5), 0.5, np.float32) for k in jm.state_keys()}
    st.update(CaSS=ca[None], Cai=np.full((1, 5), 7e-5, np.float32),
              Nai=np.full((1, 5), 7.67, np.float32),
              Ki=np.full((1, 5), 138.3, np.float32))
    want = jm.currents(jnp.asarray(v[None]), to_jax(st))["i_cal"]
    mine = tm.currents(torch.tensor(v[None]),
                       interop.state_from_numpy(st, "cpu"))["i_cal"]
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), **RATE_TOL)

    def rel(vv):
        vv = vv.astype(np.float32)
        c = np.full(vv.shape, 7e-5, np.float32)
        d = tt.ghk_drive(torch.tensor(vv), torch.tensor(c)).double().numpy()
        e = exact(vv.astype(np.float64), c.astype(np.float64))
        return np.abs(d - e) / np.abs(e)

    near = rel(15.0 + np.linspace(-0.5, 0.5, 2001))
    far = np.linspace(-90.0, 50.0, 2001)
    far = rel(far[np.abs(far - 15.0) > 5.0])
    assert near.max() > 20 * far.max(), (near.max(), far.max())


@pytest.mark.parametrize("name,skip", [("tp06_ap", False),
                                       ("tp06_skip_ap", True)])
def test_golden(name, skip):
    """The goldens at 0D, as tests/test_golden.py drives them: V = 20 mV,
    2000 outer steps at dt 0.02."""
    model = tt.TenTusscher06(SimConfig(width=8, height=8, dt=0.02,
                                       duration=1, skip=skip))
    want = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    np.testing.assert_allclose(golden_trace(model, 20.0, 2000), want,
                               atol=V_ATOL, rtol=0)


# -- the kernels' plain versions ------------------------------------------------------


@pytest.mark.parametrize("case,skip", [("epi", True), ("epi", False),
                                       ("endo", True), ("transmural", True),
                                       ("g_kr", False), ("g_scale", True)])
def test_plain_step_matches_jax_step(case, skip):
    """Kernel 1's plain version, 2 outer steps at 24x40 (one slow launch
    and nine frozen ones under skip, ten slow without) against the JAX
    model's step; the transmural case also under the annulus, with and
    without fibers (the GEOM entries' plain version)."""
    jm, tm = case_models(case, skip=skip)
    assert tm.launch_schedule == (True,) + (not skip,) * 9
    st = seeded_state(tm, seed=2)
    check_plain_step_matches_jax(jm, tm, st)
    if case == "transmural":
        for _, phase, angle in geometries(24, 40):
            check_plain_step_matches_jax(jm, tm, st, phase=phase,
                                         angle=angle)


def test_plain_step_matches_jax_pallas_step():
    """Kernel 1's plain version against the JAX whole-grid kernel in
    interpret mode, transmural with skip."""
    jm, tm = case_models("transmural", width=128, skip=True)
    check_pallas_step(jm, tm, seeded_state(tm, seed=3))


@pytest.mark.parametrize("case", ["epi", "transmural-z"])
def test_plain_volume_step_matches_jax(case):
    """Kernel 4's plain version at 3x24x40, dz_ratio 0.5, 2 outer steps,
    epi with skip, and the depth-banded wedge of transmural_volume_state
    (its [D, H, W] het planes) without."""
    if case == "epi":
        jm, tm = case_models("epi", skip=True)
        check_volume_step(jm, tm)
        return
    jm, tm = case_models("transmural")
    st = tt.transmural_volume_state(tm, 3)
    st["V"][0] += 60.0
    jgeom = jbase.volume_geometry(dz_ratio=0.5)
    from fib_tf_tpu_torch.ops import cuda_volume
    step = cuda_volume.make_volume_step(tm, 3, dz_ratio=0.5)
    want, got = to_jax(st), interop.state_from_numpy(st, "cpu")
    for _ in range(2):
        want = jm.step(want, jgeom)
        got = step(got)
    assert_states_close(got, want, **TOL)


# -- the engine ----------------------------------------------------------------------


def test_simulate_matches_jax_engine():
    """Simulation at 48x48 without skip, an S2 at 3 ms, 40 outer steps."""
    jm, tm = models(jt.TenTusscher06, tt.TenTusscher06, width=48,
                    height=48, dt_per_plot=10, duration=8, kernel="xla")
    check_simulate_matches_jax(jm, tm)


def test_routes():
    check_routes(tt.TenTusscher06(cfg()), {})
    strip = tt.TenTusscher06(cfg(width=256, height=4,
                                 cell_type="transmural"))
    assert strip.probe_pixel == (3, 128)


# -- the cell body's host side and interop ---------------------------------------------


def test_pack_tp06_reads_cell_type_when_the_step_is_built():
    """Each slot of the parameter block holds its own value; cell_type set
    after construction reaches the block and the plain step; the het flags
    follow the attached planes."""
    tm = tt.TenTusscher06(cfg(skip=True, g_scale=G_SCALE))
    body = bodies.cell_body(tm)
    assert body.name == "tp06" and body.kernels == (1, 3, 4, 6)
    assert body.planes == bodies.TP06_PLANES
    assert set(body.planes) - set(bodies.TP06_HET_PLANES) == (
        set(tm.state_keys()) - {"V"})
    assert body.library is bodies.LRTP_LIBRARY
    assert cuda_step.KERNELS["tp06"].library_name == "lrtp_substep"
    f = G_SCALE
    want = [f["g_Na"] * 14.838, f["g_bNa"] * 0.00029, f["g_CaL"] * 3.98e-5,
            f["g_bCa"] * 0.000592, f["g_to"] * 0.294, f["g_Ks"] * 0.392,
            f["g_Kr"] * 0.153, f["g_K1"] * 5.405, f["g_NaCa"] * 1000.0,
            f["g_NaK"] * 2.724 * 5.4, f["g_pCa"] * 0.1238,
            f["g_pK"] * 0.0146, f["g_to"], f["g_Ks"], 0.0, 0.0, 0.0, 0.0,
            0.0, 0.02, 0.2, 0.809 * 0.02, -90.0, 1.0 / 140.0]
    params = bodies.pack_params(tm)
    assert params.size == body.param_floats == 24
    np.testing.assert_array_equal(params, np.float32(want))
    tm.cell_type = "endo"
    params = bodies.pack_params(tm)
    assert params[4] == np.float32(f["g_to"] * 0.073) and params[18] == 1.0
    st = interop.state_from_numpy(seeded_state(tt.TenTusscher06(tm.cfg),
                                               seed=6), "cpu")
    ref = tt.TenTusscher06(tm.cfg)
    ref.cell_type = "endo"
    got = cuda_step.make_cuda_step(tm)({k: v.clone() for k, v in st.items()})
    want = ref.step(st, grid_geometry())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    trans = tt.TenTusscher06(cfg(cell_type="transmural"))
    assert list(bodies.pack_params(trans)[14:19]) == [1, 1, 1, 0, 0]
    trans.set_het(g_kr=kr_plane(trans.state_shape()))
    assert list(bodies.pack_params(trans)[14:19]) == [1, 1, 1, 1, 0]
    alone = tt.TenTusscher06(cfg()).set_het(g_kr=kr_plane((24, 40)))
    assert list(bodies.pack_params(alone)[14:19]) == [0, 0, 0, 1, 0]
    assert alone.state_keys() == tuple(sorted(
        tt.TenTusscher06(cfg()).state_keys() + ("_p_g_kr",)))


def test_interop_carries_the_jax_models_parameters():
    """cell_type, the het planes and the g_scale factors of a JAX model
    make the port compute what it does; a wrong shape, an unknown plane
    and an unknown cell type are refused."""
    jm, tm = models(jt.TenTusscher06, tt.TenTusscher06,
                    cell_type="transmural", g_scale={"g_Na": 0.5})
    jm.set_het(g_kr=kr_plane(jm.state_shape()))
    jm.set_scale(g_Kr=0.4)
    interop.tp06_params_from_numpy(tm, het=dict(jm.het),
                                   scales=dict(jm.scales))
    assert tm.scales == {"g_Na": 0.5, "g_Kr": 0.4}
    assert set(tm.het) == {"g_to", "g_ks", "endo", "g_kr"}
    np.testing.assert_array_equal(tm.het["g_kr"], jm.het["g_kr"])
    st = seeded_state(tm, seed=7)
    want = jm.step(to_jax(st), jbase.grid_geometry())
    got = cuda_step.plain_step(tm, interop.state_from_numpy(st, "cpu"))
    assert_states_close(got, want, **TOL)
    with pytest.raises(ValueError, match="shape"):
        interop.tp06_params_from_numpy(tm, het={"g_kr": np.ones((4, 4))})
    with pytest.raises(ValueError, match="no heterogeneous"):
        interop.tp06_params_from_numpy(tm, het={"chronic": np.ones((24,
                                                                   40))})
    with pytest.raises(ValueError, match="cell_type"):
        interop.tp06_params_from_numpy(tm, cell_type="transmural")
