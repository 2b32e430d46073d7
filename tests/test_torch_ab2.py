"""The Adams-Bashforth-2 integrator of the port (SimConfig.ab2) for
Beeler-Reuter (V and C) and Fenton (all four planes), after
tests/test_ab2.py: accuracy against Euler, the derivative planes in the
state, resuming across the ab2 flag, the pacing refresh, the sharded paths
bit-equal to one device, and the plain versions of kernels 1-4 and 6 of
the two ab2 bodies (and kernel 6 of Fenton's and Mitchell-Schaeffer's
Euler bodies) against the JAX Pallas kernels in interpret mode.

Tolerances: kernels rtol 1e-3 / atol 1e-5 over two outer steps, the
derivative planes at the atol that moves V by 1e-5 in the next step
(tests/test_torch_br_variants.py); whole runs 1e-3 of the model's range
(tests/test_golden.py).  Fenton's ab2 runs at dt 0.05: the AB2 stability
interval is (-1, 0) against Euler's (-2, 0), and at dt 0.1 the diffusion
mode at diff 1.5 (dt * diff * 12 = 1.8) grows; in 3D (eigenvalue 20) BR's
ab2 runs at dt 0.05 and Fenton's at 0.025."""

import dataclasses

import numpy as np
import pytest

import fib_tf_tpu.models.beeler_reuter as jbr
import fib_tf_tpu.models.fenton as jfen
import fib_tf_tpu_torch.models.beeler_reuter as tbr
import fib_tf_tpu_torch.models.fenton as tfen
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.engine import Simulation as JaxSimulation
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation, run_volume, simulation
from fib_tf_tpu_torch.models import cell_geometry
from fib_tf_tpu_torch.parallel import make_mesh

import test_torch_br_variants as variants
from test_torch_fixtures import one_torch_thread  # noqa: F401

BR_ATOL = 1e-3 * (tbr.BeelerReuter.max_v - tbr.BeelerReuter.min_v)


def jax_cfg(c):
    return JaxSimConfig(**dataclasses.asdict(c))


def br_cfg(**kw):
    base = dict(width=32, height=32, dt=0.1, dt_per_plot=10, duration=10,
                diff=0.809, cheby=True, skip=True)
    base.update(kw)
    return SimConfig(**base)


def solve_0d(model, state, n_substeps):
    """`n_substeps` plain substeps of a 0D cell; the final state."""
    state = interop.state_from_numpy(state, "cpu")
    geom = cell_geometry()
    for _ in range(n_substeps):
        state = model.solve(state, geom)
    return state


# -- the integrator ---------------------------------------------------------------------


def fenton_final_u(dt, ab2, t_ms=5.0):
    """u(t_ms) from a smooth window: u starts at 0.4 and rises toward 1
    without crossing the sign() thresholds (tests/test_ab2.py:42-51)."""
    m = tfen.Fenton4v(SimConfig(width=8, height=8, dt=dt, duration=1,
                                ab2=ab2))
    st = m.initial_state(s1=False)
    st["u"][:] = 0.4
    if ab2:
        st = m.bootstrap_ab2(st)
    return float(solve_0d(m, st, int(round(t_ms / dt)))["u"][0, 0])


def br_final_v(dt, ab2, t_ms=5.0):
    m = tbr.BeelerReuter(SimConfig(width=8, height=8, dt=dt, duration=1,
                                   ab2=ab2, cheby=False, skip=False))
    st = m.initial_state(s1=False)
    st["V"][:] = -30.0
    if ab2:
        st = m.bootstrap_ab2(st)
    return float(solve_0d(m, st, int(round(t_ms / dt)))["V"][0, 0])


def test_fenton_ab2_much_more_accurate_than_euler():
    """At dt 0.1 the AB2 endpoint error against dt 0.001 is >= 20x below
    Euler's (tests/test_ab2.py:54-59)."""
    ref = fenton_final_u(0.001, ab2=False)
    err_euler = abs(fenton_final_u(0.1, ab2=False) - ref)
    err_ab2 = abs(fenton_final_u(0.1, ab2=True) - ref)
    assert err_ab2 < err_euler / 20.0


def test_br_ab2_more_accurate_than_euler():
    """The gates stay first-order Rush-Larsen, so the gain is bounded:
    >= 1.5x on the V endpoint (tests/test_ab2.py:112-119)."""
    ref = br_final_v(0.002, ab2=False)
    err_euler = abs(br_final_v(0.1, ab2=False) - ref)
    err_ab2 = abs(br_final_v(0.1, ab2=True) - ref)
    assert err_ab2 < err_euler / 1.5


@pytest.mark.parametrize("name", ["br", "fenton"])
def test_state_keys_and_bootstrap_match_jax(name):
    """The sorted plane names with the derivative planes, and the
    bootstrap of the initial state, as the JAX model's."""
    if name == "br":
        c = br_cfg(ab2=True)
        jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
        assert tm.state_keys() == jm.state_keys() == (
            "C", "V", "_dC_", "_dV_", "d", "f", "h", "j", "m", "x1")
    else:
        c = SimConfig(width=32, height=32, dt=0.05, diff=1.5, ab2=True)
        jm, tm = jfen.Fenton4v(jax_cfg(c)), tfen.Fenton4v(c)
        assert tm.state_keys() == jm.state_keys() == (
            "_ds_", "_du_", "_dv_", "_dw_", "s", "u", "v", "w")
    want, got = jm.initial_state(), tm.initial_state()
    assert tuple(sorted(got)) == tm.state_keys()
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_br_clip_stores_the_effective_derivative():
    """Where V's clip fires, _dV_ is (v1 - v0) / dt; elsewhere the
    derivative itself."""
    tm = tbr.BeelerReuter(SimConfig(width=8, height=8, dt=0.1, duration=1,
                                    ab2=True))
    st = tm.initial_state(s1=False)
    st["V"][:4] = -84.99
    st["V"][4:] = -30.0
    st = tm.bootstrap_ab2(st)
    st["_dV_"][:4] = 50.0    # pulls the upper cells below -85
    out = tm.solve(interop.state_from_numpy(st, "cpu"), cell_geometry())
    assert (out["V"][:4] == -85.0).all()
    np.testing.assert_allclose(out["_dV_"][:4].numpy(),
                               (-85.0 - np.float32(-84.99)) / 0.1,
                               rtol=1e-5)
    assert (out["V"][4:] > -85.0).all()
    assert (out["_dV_"][4:].numpy()
            != (out["V"][4:].numpy() - st["V"][4:]) / 0.1).all()


# -- the kernels' plain versions against the JAX Pallas kernels ----------------------------

AB2_CONFIGS = ["br-ab2-skip", "fenton-ab2"]
# which pairs meet the JAX Pallas kernel and which the JAX model's step:
# tests/test_torch_br_variants.py PALLAS


@pytest.mark.parametrize("name", AB2_CONFIGS)
def test_substep_kernel_plain_matches_jax_pallas_step(name):
    variants.substep_kernel_case(name)


@pytest.mark.parametrize("name", AB2_CONFIGS)
def test_tiled_kernel_plain_matches_jax_tiled_kernel(name):
    variants.tiled_kernel_case(name)


@pytest.mark.parametrize("name", AB2_CONFIGS)
def test_block_kernel_plain_matches_jax_block_kernel(name):
    variants.block_kernel_case(name)


@pytest.mark.parametrize("name", AB2_CONFIGS)
def test_volume_kernel_plain_matches_jax_volume_kernel(name):
    variants.volume_kernel_case(name)


@pytest.mark.parametrize("name", AB2_CONFIGS + ["fenton", "ms"])
def test_volume_block_kernel_plain_matches_jax_volume_block_kernel(name):
    """Kernel 6 hosts every body now, Fenton's and Mitchell-Schaeffer's
    Euler bodies too."""
    variants.volume_block_kernel_case(name)


# -- the engine ---------------------------------------------------------------------------


def test_resume_euler_state_into_ab2():
    """An Euler run's final state resumes an ab2 run: the derivative
    planes are rebuilt with bootstrap_ab2 (tests/test_ab2.py:232-241)."""
    r = Simulation(tbr.BeelerReuter(br_cfg()), device="cpu").define() \
        .simulate()
    sim = Simulation(tbr.BeelerReuter(br_cfg(ab2=True)),
                     device="cpu").define(state=r.state)
    boot = sim.model.bootstrap_ab2(r.state)
    for k in ("_dV_", "_dC_"):
        np.testing.assert_array_equal(sim._initial[k], boot[k])
    res = sim.simulate()
    assert np.isfinite(res.state["V"]).all() and "_dV_" in res.state


def test_resume_ab2_state_into_euler():
    r = Simulation(tbr.BeelerReuter(br_cfg(ab2=True)), device="cpu") \
        .define().simulate()
    assert "_dV_" in r.state
    res = Simulation(tbr.BeelerReuter(br_cfg()), device="cpu") \
        .define(state=r.state).simulate()
    assert np.isfinite(res.state["V"]).all() and "_dV_" not in res.state


def test_resume_unknown_or_missing_plane_rejected():
    st = tbr.BeelerReuter(br_cfg()).initial_state()
    st["bogus"] = st["V"]
    with pytest.raises(ValueError, match="unknown planes"):
        Simulation(tbr.BeelerReuter(br_cfg()), device="cpu").define(
            state=st)
    st = tbr.BeelerReuter(br_cfg()).initial_state()
    del st["m"]
    with pytest.raises(ValueError, match="missing planes"):
        Simulation(tbr.BeelerReuter(br_cfg(ab2=True)), device="cpu").define(
            state=st)


@pytest.mark.parametrize("name", ["br", "fenton"])
def test_pacing_refreshes_derivative_planes(name):
    """After a pacing op the derivative planes are a fresh bootstrap of
    the paced state at the paced pixels and keep their values elsewhere
    (tests/test_ab2.py:260-276, the reference's `_pace_fn`)."""
    model = (tbr.BeelerReuter(br_cfg(ab2=True)) if name == "br" else
             tfen.Fenton4v(SimConfig(width=32, height=32, dt=0.05, diff=1.5,
                                     duration=10, ab2=True)))
    sim = Simulation(model, device="cpu").define()
    sim.add_pace_op("s2", "luq", model.max_v)
    st = sim._to_device(sim._initial)
    st[model.pot_key] = st[model.pot_key] + 1e-3   # off the bootstrap
    before = {k: v.clone() for k, v in st.items()}
    paced = sim.fire_on(dict(st), "s2")
    fresh = model.bootstrap_ab2(interop.state_to_numpy(paced))
    mask = sim._pace_masks["s2"].numpy() > model.min_v
    for k in fresh:
        if not k.startswith("_d"):
            continue
        got = paced[k].numpy()
        np.testing.assert_allclose(got[mask], fresh[k][mask], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got[~mask], before[k].numpy()[~mask])
    dv = "_dV_" if name == "br" else "_du_"
    assert not np.allclose(paced[dv].numpy(), before[dv].numpy())


def test_simulate_with_s2_matches_jax_engine():
    """BR ab2 under skip, 64x64 for 30 ms with an S2 quadrant at 15 ms:
    the crossing and the final state against the JAX engine, whose pacing
    refreshes the derivative planes the same way."""
    c = br_cfg(width=64, height=64, duration=30, ab2=True)
    jsim = JaxSimulation(jbr.BeelerReuter(jax_cfg(c))).define()
    jsim.add_pace_op("s2", "luq", 10.0)
    want = jsim.simulate(schedule=[(15.0, "s2")])
    sim = Simulation(tbr.BeelerReuter(c), device="cpu").define()
    sim.add_pace_op("s2", "luq", 10.0)
    got = sim.simulate(schedule=[(15.0, "s2")])
    assert got.cycle_lengths == want.cycle_lengths
    assert len(got.cycle_lengths) >= 1
    for k in want.state:
        np.testing.assert_allclose(got.state[k], want.state[k], err_msg=k,
                                   atol=BR_ATOL if k in ("V", "_dV_")
                                   else 1e-3, rtol=1e-3)


# -- the sharded paths --------------------------------------------------------------------


@pytest.mark.parametrize("wide", [False, True], ids=["ring", "wide"])
@pytest.mark.parametrize("name", ["br", "fenton"])
def test_mesh_of_four_matches_one_device(name, wide):
    """The derivative planes ride the state through the exchanges: on a
    CPU mesh of four (4x1 and 2x2) a run with an S2 paced on the shards
    is bit-equal to one device with the per-substep exchange (the same
    arithmetic in the same order), and within the kernels' tolerance with
    the wide halo, whose block geometry masks the edges in another order
    (tests/test_ab2.py:207-227)."""
    if name == "br":
        c = br_cfg(width=64, height=64, duration=8, skip=False, ab2=True)
        make = tbr.BeelerReuter
    else:
        c = SimConfig(width=64, height=64, dt=0.05, dt_per_plot=10,
                      diff=1.5, duration=8, ab2=True)
        make = tfen.Fenton4v
    schedule = [(3.0, "s2")]

    def run(**kw):
        sim = Simulation(make(c), **kw).define()
        sim.add_pace_op("s2", "luq", make(c).max_v)
        return sim.simulate(schedule=schedule)

    one = run(device="cpu")
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(shape, devices=["cpu"] * 4)
        res = run(mesh=mesh, wide_halo=wide)
        assert set(res.state) == set(one.state)
        assert res.cycle_lengths == one.cycle_lengths
        if wide:
            variants.assert_kernel_close(res.state, one.state)
            continue
        for k in one.state:
            np.testing.assert_array_equal(res.state[k], one.state[k],
                                          err_msg=f"{shape} {k}")
        np.testing.assert_array_equal(res.probes["v"], one.probes["v"])


def test_sharded_volume_bit_equal_to_one_device():
    """run_volume(mesh=..., wide_halo=True) for BR ab2 under skip on two
    z shards, bit-equal to the unsharded run."""
    model = tbr.BeelerReuter(br_cfg(width=24, height=16, dt=0.05, ab2=True))
    whole = run_volume(model, 12, 3, device="cpu")
    sharded = run_volume(model, 12, 3, mesh=make_mesh(devices=["cpu"] * 2),
                         wide_halo=True, device="cpu")
    for k in whole[0]:
        np.testing.assert_array_equal(sharded[0][k], whole[0][k], err_msg=k)
    np.testing.assert_array_equal(sharded[1], whole[1])


def test_reconcile_state_helper():
    """The resume rule itself: stale derivative planes dropped, missing
    ones rebuilt, anything else rejected."""
    ab2 = tbr.BeelerReuter(br_cfg(ab2=True))
    euler = tbr.BeelerReuter(br_cfg())
    st = ab2.initial_state()
    assert set(simulation.reconcile_state(euler, st)) == set(
        euler.state_keys())
    st = euler.initial_state()
    assert set(simulation.reconcile_state(ab2, st)) == set(ab2.state_keys())
    with pytest.raises(ValueError, match="missing"):
        simulation.reconcile_state(
            euler, {k: v for k, v in st.items() if k != "V"})
