"""The port's Fenton 4v model and the plain versions of its cell body's
kernels, held against fib_tf_tpu's Fenton model and its Pallas kernels (in
interpret mode, as tests/test_pallas.py runs them) on the CPU, plus the
golden action potential, the conduction velocity, the engine and the
routes that raise.

Tolerance: rtol 1e-3 / atol 1e-5 on every plane over one substep or two
outer steps, the JAX package's own kernel-vs-XLA bound
(tests/test_pallas.py:90-97); whole runs 1e-3 of the model's [0, 1] range
(tests/test_golden.py)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.fenton as jfen
import fib_tf_tpu.ops.integrators as jint
import fib_tf_tpu_torch.models.fenton as tfen
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.engine import Simulation as JaxSimulation
from fib_tf_tpu.models import grid_geometry as jax_grid_geometry
from fib_tf_tpu.ops.pallas_step import make_pallas_step
from fib_tf_tpu.ops.pallas_tiled import block_geometry as jax_block_geometry
from fib_tf_tpu.ops.pallas_tiled import make_tiled_pallas_step
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation, simulation
from fib_tf_tpu_torch.models import MODEL_REGISTRY, cell_geometry, grid_geometry
from fib_tf_tpu_torch.ops import (bodies, cuda_block, cuda_step, cuda_tiled,
                                  integrators)
from test_torch_fixtures import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = dict(rtol=1e-3, atol=1e-5)
U_ATOL = 1e-3 * (tfen.Fenton4v.max_v - tfen.Fenton4v.min_v)
K = tfen.Fenton4v.dt_per_step


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


def cfg(**kw):
    base = dict(width=40, height=24, dt=0.1, diff=1.5, duration=1)
    base.update(kw)
    return SimConfig(**base)


def models(**kw):
    c = cfg(**kw)
    return jfen.Fenton4v(jax_cfg(c)), tfen.Fenton4v(c)


def seeded_state(model, seed=0, shape=None):
    """Every plane drawn per cell from a seed (so the border differs from
    its neighbours), u across both thresholds and the upstroke."""
    rng = np.random.RandomState(seed)
    shape = model.state_shape() if shape is None else shape
    draw = lambda hi: rng.uniform(0.0, hi, shape).astype(np.float32)
    return {"u": draw(1.0), "v": draw(1.0), "w": draw(1.0), "s": draw(0.6)}


def to_jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def assert_states_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, np.asarray(want[k]), err_msg=k, **tol)


# -- constants and step functions ---------------------------------------------------


def test_constants_equal_jax():
    names = [n for n in dir(jfen) if n.isupper()]
    assert len(names) == 21
    for n in names:
        assert getattr(tfen, n) == getattr(jfen, n), n
    jm, tm = models()
    for attr in ("name", "min_v", "max_v", "depol", "dt_per_step",
                 "pot_key", "SCALE_PARAMS", "probe_pixel"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.state_keys() == jm.state_keys() == ("s", "u", "v", "w")
    for s1 in (True, False):
        want, got = jm.initial_state(s1), tm.initial_state(s1)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert MODEL_REGISTRY["fenton"] is tfen.Fenton4v


def test_heaviside_matches_jax():
    x = np.float32([-2.0, -1e-30, -0.0, 0.0, 1e-30, 3.0, np.inf, -np.inf,
                    np.nan])
    for ours, ref in ((integrators.heaviside, jint.heaviside),
                      (integrators.heaviside_neg, jint.heaviside_neg)):
        got = ours(torch.tensor(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref(jnp.asarray(x))))
        assert got[2] == got[3] == 0.5 and np.isnan(got[-1])


# -- the plain substep --------------------------------------------------------------


def test_plain_solve_matches_jax_and_takes_the_raw_u():
    """One substep on a 24x40 state whose border differs from its
    neighbours.  The rates take the raw u and the diffusion u0: a body fed
    u0 for both (as BR's body takes v0) fails on the border and nowhere
    else."""
    jm, tm = models()
    st = seeded_state(tm, seed=1)
    want = jm.solve(to_jax(st), jax_grid_geometry())
    state = interop.state_from_numpy(st, "cpu")
    assert_states_close(tm.solve(state, grid_geometry()), want, **TOL)
    got = cuda_step.plain_substep(tm, interop.state_from_numpy(st, "cpu"),
                                  True)
    assert_states_close(got, want, **TOL)

    geom = grid_geometry()
    u0 = geom.enforce_boundary(state["u"])
    wrong = tm.solve({**state, "u": u0}, geom)
    for k in ("u", "v", "w", "s"):
        bad = ~np.isclose(wrong[k].numpy(), np.asarray(want[k]), **TOL)
        assert bad.any(), k
        assert not bad[1:-1, 1:-1].any(), k


# -- two outer steps of each kernel's plain version against the JAX kernels -------


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
    """16x128: ten launches' plain version against the JAX whole-grid
    kernel (interpret mode)."""
    jm, tm = models(height=16, width=128)
    _two_steps(make_pallas_step(jm, interpret=True),
               cuda_step.make_cuda_step(tm), seeded_state(tm, seed=2), jm,
               has_probe=False)


def test_tiled_kernel_plain_matches_jax_tiled_kernel():
    """64x128, tile_rows 32: the plain version of the tiled kernel (one
    launch, ten substeps) against the JAX row-tiled kernel."""
    jm, tm = models(height=64, width=128)
    _two_steps(make_tiled_pallas_step(jm, 32, interpret=True),
               cuda_tiled.make_tiled_cuda_step(tm), seeded_state(tm, seed=3),
               jm)


H_TOTAL, W_TOTAL, H_LOCAL, W_LOCAL = 64, 48, 16, 24


def _window(st, r0, n_rows, c0, n_cols):
    """Rows [r0, r0 + n_rows) x columns [c0, c0 + n_cols) of a host state,
    wrapped round the domain's edges as the ring exchange wraps them."""
    out = {}
    for k, v in st.items():
        rows = np.arange(r0, r0 + n_rows) % v.shape[0]
        cols = np.arange(c0, c0 + n_cols) % v.shape[1]
        out[k] = np.ascontiguousarray(v[np.ix_(rows, cols)])
    return out


@pytest.mark.parametrize("origin", [(0, None), (16, None), (48, None),
                                    (0, 0), (32, 24)],
                         ids=lambda o: f"r{o[0]}c{o[1]}")
def test_block_kernel_plain_matches_jax_wide_halo_step(origin):
    """One shard's block extended by K = 10 ghost rows (and columns), two
    outer steps, its ghosts cut from the JAX unsharded state each step:
    the plain block step against the JAX wide-halo step (`model.step`
    under the reference's `block_geometry`)."""
    two_d = origin[1] is not None
    jm, tm = models(height=H_TOTAL, width=W_TOTAL)
    rstart = origin[0] - K
    cstart = origin[1] - K if two_d else 0
    ext_h = H_LOCAL + 2 * K
    ext_w = W_LOCAL + 2 * K if two_d else W_TOTAL
    rg = jnp.arange(rstart, rstart + ext_h, dtype=jnp.int32)[:, None]
    cg = (jnp.arange(cstart, cstart + ext_w, dtype=jnp.int32)[None, :]
          if two_d else None)
    jgeom = jax_block_geometry(rg, H_TOTAL, cg, W_TOTAL if two_d else None)
    step = cuda_block.make_block_step(tm, two_d)
    full = seeded_state(tm, seed=4)
    for _ in range(2):
        ext = _window(full, rstart, ext_h, cstart, ext_w)
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


# -- golden, physics and the engine ---------------------------------------------------


def test_golden_fenton_ap():
    """0D action potential vs tests/golden/fenton_ap.npy, as
    tests/test_golden.py drives it (u = 0.3, 400 outer steps)."""
    model = tfen.Fenton4v(SimConfig(width=8, height=8, dt=0.1, duration=1))
    st = model.initial_state(s1=False)
    st["u"][:] = 0.3
    state = interop.state_from_numpy(st, "cpu")
    geom = cell_geometry()
    trace = []
    for _ in range(400):
        state = model.step(state, geom)
        trace.append(float(state["u"][0, 0]))
    want = np.load(os.path.join(GOLDEN, "fenton_ap.npy"))
    np.testing.assert_allclose(np.asarray(trace, np.float32), want,
                               atol=U_ATOL, rtol=0)


def test_conduction_velocity_at_diff_1_5():
    """A planar S1 wave on 128x16 at diff 1.5 runs 3.333 cells/ms, the
    reference's absolute pin (tests/test_physics.py:142): the front's
    first u > 0.5 at columns 30 and 90 of the middle row."""
    model = tfen.Fenton4v(cfg(width=128, height=16))
    state = interop.state_from_numpy(model.initial_state(), "cpu")
    arrival = {}
    for step in range(120):
        cuda_step.plain_step(model, state)
        for col in (30, 90):
            if col not in arrival and float(state["u"][8, col]) > 0.5:
                arrival[col] = step
        if len(arrival) == 2:
            break
    cv = 60.0 / ((arrival[90] - arrival[30]) * K * model.cfg.dt)
    assert cv == pytest.approx(3.333, rel=0.05)


def test_simulate_matches_jax_engine():
    """64x64 for 30 ms with an S2 quadrant at 15 ms: the crossing and the
    final state against the JAX engine."""
    c = cfg(width=64, height=64, dt_per_plot=10, duration=30)
    jsim = JaxSimulation(jfen.Fenton4v(jax_cfg(c))).define()
    jsim.add_pace_op("s2", "luq", 1.0)
    want = jsim.simulate(schedule=[(15.0, "s2")])
    sim = Simulation(tfen.Fenton4v(c), device="cpu").define()
    assert sim.route == "plain"
    sim.add_pace_op("s2", "luq", 1.0)
    got = sim.simulate(schedule=[(15.0, "s2")])
    assert got.steps == want.steps == 30
    assert got.cycle_lengths == want.cycle_lengths
    assert len(got.cycle_lengths) >= 1
    for k in want.state:
        np.testing.assert_allclose(got.state[k], want.state[k], err_msg=k,
                                   atol=U_ATOL, rtol=0)
    np.testing.assert_allclose(got.probes["v"], want.probes["v"],
                               atol=U_ATOL, rtol=0)


def test_g_scale_matches_jax():
    scale = {"g_fi": 0.8, "g_si": 1.2, "g_so": 0.9}
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
        np.float32([0.1, 1.5 * 0.1, 0.8, 1.2, 0.9, 0.0, 1.0]))
    with pytest.raises(ValueError):
        tm.set_scale(g_Na=0.5)


# -- the kernels' host side and the routes -------------------------------------------


def test_cell_body_and_schedule():
    _, tm = models()
    body = bodies.cell_body(tm)
    assert body.name == "fenton" and body.planes == ("v", "w", "s")
    assert bodies.pack_params(tm).size == body.param_floats == 7
    assert tm.launch_schedule == (True,) * 10
    assert cuda_tiled.tile_interior(10) == (44, 44)
    assert cuda_tiled.slow_mask(tm.launch_schedule) == 0x3FF
    for mod in (cuda_step, cuda_tiled, cuda_block):
        assert mod.KERNELS["fenton"].entry.startswith("fenton_")
    with pytest.raises(ValueError, match="one substep body"):
        cuda_step.plain_substep(tm, interop.state_from_numpy(
            tm.initial_state(), "cpu"), False)


def test_routes():
    """As the reference routes Fenton (simulation.py:463-492, :797-798):
    the substep kernel up to 32 MB of state, the tiled kernel past it,
    the block kernel on a mesh with wide halos."""
    small = tfen.Fenton4v(cfg(width=512, height=512))
    large = tfen.Fenton4v(cfg(width=2048, height=2048))
    assert simulation.state_mb(small) == 4.0
    assert simulation.state_mb(large) == 64.0
    assert simulation.route(small, "cuda", "auto") == "substep"
    assert simulation.route(large, "cuda", "auto") == "tiled"
    assert simulation.route(large, "cpu", "auto") == "plain"
    assert simulation.spmd_route(large, "cuda", "auto", True) == "block"


@pytest.mark.parametrize("kw,item", [
    (dict(ab2=True), "Queue 1 item 6"),
    (dict(adaptive_dv=1.0), "Queue 1 item 15"),
])
def test_unported_variants_raise(kw, item):
    """adaptive_dv still raises; ab2, which raised before it was ported,
    constructs and matches the JAX model over two outer steps (at dt 0.05:
    AB2's stability interval is half Euler's)."""
    if "adaptive_dv" in kw:
        with pytest.raises(NotImplementedError, match=item):
            tfen.Fenton4v(cfg(**kw))
        return
    jm, tm = models(dt=0.05, **kw)
    st = jm.initial_state()
    st = {k: np.asarray(v, np.float32) for k, v in st.items()}
    want, got = to_jax(st), interop.state_from_numpy(st, "cpu")
    for _ in range(2):
        want = jm.step(want, jax_grid_geometry())
        got = cuda_step.plain_step(tm, got)
    assert_states_close(got, want, **TOL)
