"""The port's Luo-Rudy 1991 model held against fib_tf_tpu's on the CPU: the
constants and rate functions, one solve for n in {10, 0, 1}, the golden,
the substep kernel's plain version against the JAX model's outer step and
the JAX whole-grid Pallas kernel (interpret mode, as tests/test_pallas.py
runs it), with and without skip and under a geometry, the volume kernel's
plain version, the engine at 48x48, the cell body's host side, the interop
carrier and the routes.  tests/test_torch_tp06.py imports its helpers.

Tolerances: numpy float64 copies bit for bit; float32 rates rtol 1e-5 (one
libm's exp against another's); one solve rtol 1e-5 / atol 1e-7 (the same:
the two packages' exp part by an ulp at a few cells, and the update adds
no more); an outer step, a kernel's plain version and the engine rtol
1e-3 / atol 1e-5 on every plane, the JAX package's kernel-vs-XLA bound
(tests/test_pallas.py:90-97), and V within 1e-3 of the model's range
(tests/test_golden.py) where the run crosses an upstroke, whose ~390 V/s
turns the libms' ulp into millivolts; the golden 1e-3 of the model's
140 mV range."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.base as jbase
import fib_tf_tpu.models.luo_rudy as jl
import fib_tf_tpu.ops.stencil as jstencil
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.engine import Simulation as JaxSimulation
from fib_tf_tpu.ops.pallas_step import make_pallas_step
import fib_tf_tpu_torch.models.luo_rudy as tl
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation, simulation, volume
from fib_tf_tpu_torch.models import MODEL_REGISTRY, cell_geometry, grid_geometry
from fib_tf_tpu_torch.ops import bodies, cuda_step, cuda_volume, stencil
from fib_tf_tpu_torch.parallel import make_mesh
from test_torch_fixtures import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RATE_TOL = dict(rtol=1e-5, atol=0)
SOLVE_TOL = dict(rtol=1e-5, atol=1e-7)
TOL = dict(rtol=1e-3, atol=1e-5)
V_ATOL = 1e-3 * (tl.LuoRudy91.max_v - tl.LuoRudy91.min_v)
# V over the rate tables' range, with the branch and singular points
V_SWEEP = np.concatenate([np.linspace(-110.0, 70.0, 3601),
                          [-47.13, -47.1305, -47.1295, -77.0, -77.0005,
                           -40.0, -40.0001, -39.9999, -100.0, -100.0001]])
G_SCALE = {"g_Na": 0.9, "g_si": 0.5, "g_K": 1.2, "g_K1": 1.1, "g_Kp": 0.8,
           "g_b": 1.3}


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


def cfg(**kw):
    base = dict(width=40, height=24, dt=0.02, diff=0.809, duration=1)
    base.update(kw)
    return SimConfig(**base)


def models(jcls, tcls, **kw):
    """The JAX model and the port's of the same configuration."""
    c = cfg(**kw)
    return jcls(jax_cfg(c)), tcls(c)


def seeded_state(model, seed=0):
    """The initial state with V drawn per cell over [-90, 40] mV (the
    upstroke and the plateau; the border differs from its neighbours) and
    every other plane scaled per cell by up to 5%."""
    rng = np.random.RandomState(seed)
    st = model.initial_state()
    shape = model.state_shape()
    for k, v in st.items():
        if k.startswith("_p_"):
            continue
        st[k] = (v * rng.uniform(0.95, 1.05, shape)).astype(np.float32)
    st["V"] = rng.uniform(-90.0, 40.0, shape).astype(np.float32)
    return st


def to_jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def assert_states_close(got, want, v_atol=None, **tol):
    """Every plane of `got` (tensors or arrays) within `tol` of `want`;
    with `v_atol`, V within that many mV instead."""
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        t = (dict(atol=v_atol, rtol=0) if k == "V" and v_atol is not None
             else tol)
        np.testing.assert_allclose(g, np.asarray(want[k]), err_msg=k, **t)


def annulus(h, w):
    """A phase field with a hole and a neg=True rim (examples/court_run.py's
    annulus, cut to h x w), made by the reference's
    add_hole_to_phase_field."""
    phase = jstencil.add_hole_to_phase_field(None, h, w, w // 2, h // 2,
                                             max(min(h, w) // 8, 2))
    return jstencil.add_hole_to_phase_field(phase, h, w, w // 2, h // 2,
                                            min(h, w) // 2 - 2, neg=True)


def geometries(h, w):
    """(label, phase, fiber angle) of the GEOM cases: the annulus, and the
    annulus with fibers at 30 degrees, ratio 0.25."""
    phase = annulus(h, w)
    return (("annulus", phase, None), ("annulus+fiber", phase,
                                       np.deg2rad(30.0)))


def check_plain_step_matches_jax(jm, tm, st, n_steps=2, phase=None,
                                 angle=None):
    """`n_steps` outer steps of kernel 1's plain version (cuda_step
    .make_cuda_step on CPU tensors, the probe included) against the JAX
    model's `step` under the same geometry."""
    ratio = 0.25 if angle is not None else 1.0
    jgeom = jbase.grid_geometry(phase, angle, ratio)
    fiber = (None if angle is None
             else stencil.fiber_tensor(angle, ratio))
    step = cuda_step.make_cuda_step(tm, phase, fiber)
    want, got = to_jax(st), interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(n_steps)
    for i in range(n_steps):
        want = jm.step(want, jgeom)
        got = step(got, probe, i)
        assert abs(float(probe[i]) - float(jm.probe(want))) <= 1e-5
    assert_states_close(got, want, **TOL)


def check_pallas_step(jm, tm, st):
    """Two outer steps of kernel 1's plain version against the JAX
    whole-grid kernel in interpret mode, one pallas_call per substep
    (substeps_per_launch=1: the model's own launch split), at 24x128 (an
    aligned grid that holds the probe pixel)."""
    jstep = make_pallas_step(jm, interpret=True, substeps_per_launch=1)
    step = cuda_step.make_cuda_step(tm)
    want, got = to_jax(st), interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(2)
    for i in range(2):
        want = jstep(want)
        got = step(got, probe, i)
        assert abs(float(probe[i]) - float(jm.probe(want))) <= 1e-5
    assert_states_close(got, want, **TOL)


def check_volume_step(jm, tm, depth=3, dz_ratio=0.5):
    """Two outer steps of kernel 4's plain version (cuda_volume
    .make_volume_step on CPU tensors) against the JAX model's step under
    its 3D geometry, from the volume state with V drawn per cell."""
    st = volume.volume_state(tm, depth)
    rng = np.random.RandomState(4)
    st["V"] = rng.uniform(-90.0, 40.0, st["V"].shape).astype(np.float32)
    jgeom = jbase.volume_geometry(dz_ratio=dz_ratio)
    step = cuda_volume.make_volume_step(tm, depth, dz_ratio=dz_ratio)
    want, got = to_jax(st), interop.state_from_numpy(st, "cpu")
    for _ in range(2):
        want = jm.step(want, jgeom)
        got = step(got)
    assert_states_close(got, want, **TOL)


def check_simulate_matches_jax(jm, tm, skip_s2_ms=3.0, steps=40):
    """Simulation on the CPU at 48x48 (40 outer steps, an S2 on the upper
    left quadrant) against the JAX engine (kernel='xla'): the crossings,
    the probe stream and the final state."""
    runs = []
    for sim in (JaxSimulation(jm), Simulation(tm, device="cpu")):
        sim.define()
        sim.add_pace_op("s2", "luq", 10.0)
        runs.append(sim.simulate(schedule=[(skip_s2_ms, "s2")]))
    want, got = runs
    assert got.steps == want.steps == steps
    assert got.cycle_lengths == want.cycle_lengths
    assert len(got.cycle_lengths) >= 1
    np.testing.assert_allclose(got.probes["v"], want.probes["v"],
                               atol=1e-3, rtol=0)
    assert_states_close(got.state, want.state, v_atol=V_ATOL, **TOL)


def golden_trace(model, stim, n_outer):
    """The 0D action potential of tests/test_golden.py: V = `stim`
    everywhere, `n_outer` outer steps on one cell."""
    st = model.initial_state(s1=False)
    st["V"][:] = stim
    state = interop.state_from_numpy({k: v[:1, :1] for k, v in st.items()},
                                     "cpu")
    geom = cell_geometry()
    trace = np.empty(n_outer, np.float32)
    with torch.inference_mode():
        for i in range(n_outer):
            state = model.step(state, geom)
            trace[i] = state["V"][0, 0]
    return trace


def check_routes(tm, small_kw):
    """Kernel 1 at every size on a CUDA device (the reference runs XLA
    past its 32 MB cap) and kernel 4 under 'auto' (the reference runs
    XLA), the plain path on the CPU and under kernel='xla', and on a mesh
    kernels 3 and 6 on the card, the plain step on the CPU."""
    cls = type(tm)
    big = cls(cfg(width=2048, height=2048, **small_kw))
    assert simulation.state_mb(big) > Simulation.WHOLE_GRID_STATE_MB_MAX
    for m in (tm, big):
        for kernel in ("auto", "pallas"):
            assert simulation.route(m, "cuda", kernel) == "substep"
            assert volume.volume_route(m, 8, "cuda", kernel) == "substep"
        assert simulation.route(m, "cpu", "auto") == "plain"
        assert simulation.route(m, "cuda", "xla") == "plain"
        assert volume.volume_route(m, 8, "cpu", "auto") == "plain"
        assert volume.volume_route(m, 8, "cuda", "xla") == "plain"
    sim = Simulation(cls(cfg(width=32, height=40, **small_kw)),
                     mesh=make_mesh(devices=["cpu"] * 4), wide_halo=True)
    assert sim.route == "plain" and sim._mesh.grid == (4, 1)
    assert simulation.spmd_route(tm, "cuda", "auto", True) == "block"
    assert volume._use_shard_kernel(tm, "cuda", "auto")
    final, probes, _ = volume.run_volume(
        cls(cfg(width=32, height=32, **small_kw)), 20, 1,
        mesh=make_mesh(devices=["cpu"] * 2), wide_halo=True)
    assert final["V"].shape == (20, 32, 32) and probes.shape == (1,)
    with pytest.raises(ValueError, match="explicit-Euler unstable"):
        cls(cfg(dt=0.1))
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        cls(cfg(adaptive_dv=10.0))
    assert not hasattr(tm, "sharded") and not tm.kernel_free


# -- the pinned copies -------------------------------------------------------------


def test_constants_equal_jax():
    names = [n for n in dir(jl) if n.isupper()]
    assert len(names) == 22
    for n in names:
        assert getattr(tl, n) == getattr(jl, n), n
    assert tl.XI_LIM == 2.837 * 0.04 * float(np.exp(1.68))
    jm, tm = models(jl.LuoRudy91, tl.LuoRudy91)
    for attr in ("name", "min_v", "max_v", "depol", "dt_per_step",
                 "pot_key", "default_dt", "g_si", "SCALE_PARAMS",
                 "positive_states", "probe_pixel"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.state_keys() == jm.state_keys()
    for s1 in (True, False):
        want, got = jm.initial_state(s1), tm.initial_state(s1)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert MODEL_REGISTRY["lr1"] is MODEL_REGISTRY["luo_rudy"] is (
        tl.LuoRudy91)


@pytest.mark.parametrize("which", ["fast", "slow"])
def test_rates_match_jax_over_the_voltage_range(which):
    """gate_rates over V in [-110, 70] mV with the branch and singular
    points, each `which` half, and xi_factor and k1_inf: the float64
    numpy forms bit for bit, the float32 torch forms at RATE_TOL."""
    gates = tl.FAST_GATES if which == "fast" else tl.SLOW_GATES
    assert (tl.FAST_GATES, tl.SLOW_GATES) == (jl.FAST_GATES, jl.SLOW_GATES)
    want = jl.gate_rates(V_SWEEP, xp=np, which=gates)
    got = tl.gate_rates(V_SWEEP, xp=np, which=gates)
    assert set(got) == set(want) == set(gates)
    for g in want:
        for a, b in zip(got[g], want[g]):
            np.testing.assert_array_equal(a, b, err_msg=g)
    v32 = V_SWEEP.astype(np.float32)
    want = jl.gate_rates(jnp.asarray(v32), which=gates)
    got = tl.gate_rates(torch.tensor(v32), which=gates)
    for g in want:
        for a, b in zip(got[g], want[g]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=g,
                                       **RATE_TOL)
    for fn in ("xi_factor", "k1_inf"):
        np.testing.assert_array_equal(getattr(tl, fn)(V_SWEEP, xp=np),
                                      getattr(jl, fn)(V_SWEEP, xp=np))
        np.testing.assert_allclose(
            getattr(tl, fn)(torch.tensor(v32)).numpy(),
            np.asarray(getattr(jl, fn)(jnp.asarray(v32))), err_msg=fn,
            **RATE_TOL)


# -- one solve, the golden ------------------------------------------------------------


@pytest.mark.parametrize("flags", ["default", "g_si", "g_scale"])
def test_solve_matches_jax(flags):
    """A 24x40 seeded state (its border differs from its neighbours): one
    solve for n in {10, 0, 1} against the JAX model's solve; `g_si` set on
    both models after construction, or a factor on every SCALE_PARAMS
    entry.  Not bit for bit: the two libms' exp part by an ulp at a few
    cells (SOLVE_TOL)."""
    kw = dict(g_scale=G_SCALE) if flags == "g_scale" else {}
    jm, tm = models(jl.LuoRudy91, tl.LuoRudy91, **kw)
    if flags == "g_si":
        jm.g_si = 0.02
        interop.lr1_params_from_numpy(tm, g_si=jm.g_si)
        assert tm.g_si == 0.02
    st = seeded_state(tm, seed=1)
    for n in (10, 0, 1):
        want = jm.solve(to_jax(st), jbase.grid_geometry(), n=n)
        got = tm.solve(interop.state_from_numpy(st, "cpu"), grid_geometry(),
                       n=n)
        assert_states_close(got, want, **SOLVE_TOL)
        for g in tl.SLOW_GATES:
            if n == 0:
                np.testing.assert_array_equal(got[g].numpy(), st[g])


def test_golden():
    """lr1_ap at 0D, as tests/test_golden.py drives it: V = -30 mV, 2200
    outer steps at dt 0.02."""
    model = tl.LuoRudy91(SimConfig(width=8, height=8, dt=0.02, duration=1))
    want = np.load(os.path.join(GOLDEN, "lr1_ap.npy"))
    np.testing.assert_allclose(golden_trace(model, -30.0, 2200), want,
                               atol=V_ATOL, rtol=0)


# -- the kernels' plain versions ------------------------------------------------------


@pytest.mark.parametrize("skip", [True, False])
def test_plain_step_matches_jax_step(skip):
    """Kernel 1's plain version, 2 outer steps at 24x40: one slow launch
    and nine frozen ones under skip, ten slow ones without, against the
    JAX model's step; and under the annulus, with and without fibers (the
    GEOM entries' plain version)."""
    jm, tm = models(jl.LuoRudy91, tl.LuoRudy91, skip=skip)
    assert tm.launch_schedule == (True,) + (not skip,) * 9
    st = seeded_state(tm, seed=2)
    check_plain_step_matches_jax(jm, tm, st)
    for _, phase, angle in geometries(24, 40):
        check_plain_step_matches_jax(jm, tm, st, phase=phase, angle=angle)


def test_plain_step_matches_jax_pallas_step():
    """Kernel 1's plain version against the JAX whole-grid kernel in
    interpret mode, skip on (the n=10 launch and the n=0 one)."""
    jm, tm = models(jl.LuoRudy91, tl.LuoRudy91, width=128, skip=True)
    check_pallas_step(jm, tm, seeded_state(tm, seed=3))


@pytest.mark.parametrize("skip", [True, False])
def test_plain_volume_step_matches_jax(skip):
    """Kernel 4's plain version at 3x24x40, dz_ratio 0.5, 2 outer
    steps."""
    jm, tm = models(jl.LuoRudy91, tl.LuoRudy91, skip=skip)
    check_volume_step(jm, tm)


def test_plain_substeps_are_the_commits():
    """A launch's plain version: SLOW advances every plane (x, d, f by
    slow_n dt), frozen leaves x, d, f; under skip slow_n is 10."""
    for skip, n in ((True, 10), (False, 1)):
        tm = tl.LuoRudy91(cfg(skip=skip))
        assert tm.slow_n == n
        st = interop.state_from_numpy(seeded_state(tm, seed=5), "cpu")
        for slow in (True, False):
            got = cuda_step.plain_substep(tm, {k: v.clone()
                                               for k, v in st.items()}, slow)
            want = tm.solve(st, grid_geometry(), n=n if slow else 0)
            for k in want:
                assert torch.equal(got[k], want[k]), k
            frozen = {k for k in tl.SLOW_GATES if torch.equal(got[k], st[k])}
            assert frozen == (set() if slow else set(tl.SLOW_GATES))


# -- the engine ----------------------------------------------------------------------


def test_simulate_matches_jax_engine():
    """Simulation at 48x48 with skip, an S2 at 3 ms, 40 outer steps."""
    jm, tm = models(jl.LuoRudy91, tl.LuoRudy91, width=48, height=48,
                    dt_per_plot=10, duration=8, skip=True, kernel="xla")
    check_simulate_matches_jax(jm, tm)


def test_routes():
    check_routes(tl.LuoRudy91(cfg()), {})


# -- the cell body's host side and interop ---------------------------------------------


def test_pack_lr1_reads_g_si_when_the_step_is_built():
    """Each slot of the parameter block holds its own value (the plain
    path's double products, rounded to float32 once), and g_si set after
    construction reaches the block and the plain step."""
    tm = tl.LuoRudy91(cfg(skip=True, g_scale=G_SCALE))
    body = bodies.cell_body(tm)
    assert body.name == "lr1" and body.kernels == (1, 3, 4, 6)
    assert body.planes == bodies.LR1_PLANES
    assert set(body.planes) == set(tm.state_keys()) - {"V"}
    assert body.library is bodies.LRTP_LIBRARY
    assert body.library.flags == ("-fmad=false",)
    assert cuda_step.KERNELS["lr1"].library_name == "lrtp_substep"
    assert cuda_step.GEOM_KERNELS["lr1"].entry == "lr1_substep_geom"
    assert cuda_volume.KERNELS["lr1"].library_name == "lrtp_volume"
    f = G_SCALE
    want = [0.9 * 23.0, 0.5 * 0.09, 1.2 * tl.G_K, 1.1 * tl.G_K1,
            0.8 * 0.0183, 1.3 * 0.03921, tl.E_NA, tl.E_K, tl.E_K1, tl.E_KP,
            -59.87, tl.XI_LIM, 0.02, 0.2, 0.809 * 0.02, -90.0, 1.0 / 140.0]
    assert f["g_si"] == 0.5
    params = bodies.pack_params(tm)
    assert params.size == body.param_floats == 17
    np.testing.assert_array_equal(params, np.float32(want))
    tm.g_si = 0.02
    assert bodies.pack_params(tm)[1] == np.float32(0.5 * 0.02)
    st = interop.state_from_numpy(seeded_state(tm, seed=6), "cpu")
    ref = tl.LuoRudy91(tm.cfg)
    ref.g_si = 0.02
    got = cuda_step.make_cuda_step(tm)({k: v.clone() for k, v in st.items()})
    want = ref.step(st, grid_geometry())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert bodies.pack_params(tl.LuoRudy91(cfg(skip=False)))[13] == \
        np.float32(0.02)


def test_interop_carries_the_jax_models_parameters():
    """g_si and the g_scale factors of a JAX model make the port compute
    what it does; a negative g_si is refused."""
    jm, tm = models(jl.LuoRudy91, tl.LuoRudy91, g_scale={"g_Na": 0.5})
    jm.g_si = 0.045
    jm.set_scale(g_K1=2.0)
    interop.lr1_params_from_numpy(tm, g_si=jm.g_si, scales=dict(jm.scales))
    assert tm.scales == {"g_Na": 0.5, "g_K1": 2.0} and tm.g_si == 0.045
    st = seeded_state(tm, seed=7)
    want = jm.step(to_jax(st), jbase.grid_geometry())
    got = cuda_step.plain_step(tm, interop.state_from_numpy(st, "cpu"))
    assert_states_close(got, want, **TOL)
    with pytest.raises(ValueError, match="g_si"):
        interop.lr1_params_from_numpy(tm, g_si=-1.0)
    with pytest.raises(ValueError, match="no scalable"):
        interop.lr1_params_from_numpy(tm, scales={"g_Kr": 0.5})


def test_ill_conditioned_windows():
    """alpha_m's and Xi's removable singularities, where the reference's
    float32 forms divide a difference by V minus the pole: within the
    guard (|dV| < 1e-3 mV) each takes its limit, and just outside it the
    float32 form parts from float64 by far more than elsewhere."""
    tm = tl.LuoRudy91(cfg())
    assert tm.ill_conditioned == ((-47.13, -47.13), (-77.0, -77.0))

    def rel_err(fn, v):
        v32 = torch.tensor(np.float32(v))
        got = fn(v32).double().numpy()
        want = fn(torch.tensor(np.float32(v), dtype=torch.float64)).numpy()
        return np.abs(got - want) / np.abs(want)

    a_m = lambda v: tl.gate_rates(v, which=("m",))["m"][0]
    for fn, pole in ((a_m, -47.13), (tl.xi_factor, -77.0)):
        near = rel_err(fn, pole + np.array([1.1e-3, -1.1e-3, 2e-3]))
        far = rel_err(fn, pole + np.array([5.0, -5.0, 10.0]))
        assert near.max() > 20 * far.max(), (pole, near, far)
