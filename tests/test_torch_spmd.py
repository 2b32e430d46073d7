"""The port's sharded 2D paths held against fib_tf_tpu on the CPU: the
plain block step against the JAX per-shard block kernel (in interpret
mode), `make_spmd_chunk` against the JAX one on the virtual CPU devices
(tests/test_sharding.py) and against the port's own unsharded step, and
`Simulation(mesh=...)` against the JAX engine and the unsharded engine.
The port runs on meshes of CPU entries, `make_mesh(devices=['cpu'] * 4)`.

Tolerance: rtol 1e-3 / atol 1e-5 on all 8 planes over two outer steps, the
JAX package's own kernel-vs-XLA bound (tests/test_pallas.py:90-97);
observed here: at most 3.1e-5 (V, in mV) against the JAX block kernel and
the JAX chunks."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.beeler_reuter as jbr
import fib_tf_tpu.parallel.sharding as jsharding
import fib_tf_tpu.parallel.spmd as jspmd
import fib_tf_tpu_torch.models.beeler_reuter as tbr
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.engine import Simulation as JaxSimulation
from fib_tf_tpu.ops.pallas_tiled import make_block_kernel
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation, simulation
from fib_tf_tpu_torch.ops import bodies, cuda_block, cuda_step
from fib_tf_tpu_torch.parallel import (gather_state, halo, make_mesh,
                                       shard_state, spmd)
from test_torch_fixtures import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=1e-5)
V_ATOL = 1e-3 * (tbr.BeelerReuter.max_v - tbr.BeelerReuter.min_v)
K = tbr.BeelerReuter.dt_per_step


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


def cfg(**kw):
    base = dict(width=64, height=64, dt=0.1, diff=0.809, duration=1,
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


def cpu_mesh(shape):
    return make_mesh(shape=shape, devices=["cpu"] * int(np.prod(shape)))


def jax_mesh(shape):
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU devices of tests/conftest.py")
    if len(shape) == 1:
        return jsharding.make_mesh(n_devices=shape[0])
    return jsharding.make_mesh(shape=shape,
                               devices=jax.devices()[:int(np.prod(shape))])


def unsharded_steps(model, st, n):
    ref = interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(n)
    for i in range(n):
        cuda_step.plain_step(model, ref, probe, i)
    return interop.state_to_numpy(ref), probe.numpy()


# -- the plain block step against the JAX block kernel ---------------------------------

H_TOTAL, W_TOTAL, H_LOCAL, W_LOCAL = 48, 48, 16, 16


@functools.lru_cache(maxsize=None)
def _jax_block_kernel(skip, two_d):
    jm = jbr.BeelerReuter(jax_cfg(cfg(height=H_TOTAL, width=W_TOTAL,
                                      skip=skip)))
    ext_w = W_LOCAL + 2 * K if two_d else W_TOTAL
    return make_block_kernel(jm, H_LOCAL + 2 * K, ext_w, H_TOTAL,
                             W_TOTAL if two_d else None, two_d,
                             interpret=True)


def _window(st, r0, n_rows, c0, n_cols):
    """Rows [r0, r0 + n_rows) x columns [c0, c0 + n_cols) of a host state,
    wrapped round the domain's edges as the ring exchange wraps them."""
    out = {}
    for k, v in st.items():
        rows = np.arange(r0, r0 + n_rows) % v.shape[0]
        cols = np.arange(c0, c0 + n_cols) % v.shape[1]
        out[k] = np.ascontiguousarray(v[np.ix_(rows, cols)])
    return out


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("origin", [
    (0, None), (16, None), (32, None),            # 1D: top, interior, bottom
    (0, 0), (16, 16), (32, 32), (0, 32)],         # 2D: corners, interior
    ids=lambda o: f"r{o[0]}c{o[1]}")
def test_plain_block_step_matches_jax_block_kernel(origin, skip):
    """One shard's extended block over two outer steps, its ghosts taken
    from the unsharded state each step: the plain block step against the
    JAX Pallas block kernel and against the unsharded step."""
    two_d = origin[1] is not None
    tm = tbr.BeelerReuter(cfg(height=H_TOTAL, width=W_TOTAL, skip=skip))
    kern = _jax_block_kernel(skip, two_d)
    rstart = origin[0] - K
    cstart = origin[1] - K if two_d else 0
    ext_h = H_LOCAL + 2 * K
    ext_w = W_LOCAL + 2 * K if two_d else W_TOTAL
    own = (slice(origin[0], origin[0] + H_LOCAL),
           slice(origin[1], origin[1] + W_LOCAL) if two_d else slice(None))
    full = seeded_state(tm, seed=4)
    worst = 0.0
    for _ in range(2):
        ext = _window(full, rstart, ext_h, cstart, ext_w)
        want = kern({k: jnp.asarray(v) for k, v in ext.items()}, rstart,
                    cstart if two_d else None)
        ext_in = interop.state_from_numpy(ext, "cpu")
        ext_out = {k: torch.zeros_like(v) for k, v in ext_in.items()}
        step = cuda_block.make_block_step(tm, two_d)
        assert step(ext_in, ext_out, rstart, cstart) is ext_out
        full, _ = unsharded_steps(tm, full, 1)
        for k in full:
            got = cuda_block.centre(ext_out[k], K, two_d).numpy()
            ref = np.asarray(cuda_block.centre(want[k], K, two_d))
            np.testing.assert_allclose(got, ref, err_msg=k, **TOL)
            np.testing.assert_allclose(got, full[k][own], err_msg=k, **TOL)
            worst = max(worst, np.abs(got - ref).max())
            # the ghosts of the output are the exchange's to fill
            assert float(ext_out[k][:K].abs().max()) == 0.0
    assert worst <= 1e-4
    assert cuda_block.KERNEL.launches == 0


def test_block_step_writes_the_probe_on_the_owning_shard():
    tm = tbr.BeelerReuter(cfg(height=H_TOTAL, width=W_TOTAL))
    full = seeded_state(tm, seed=5)
    ext = interop.state_from_numpy(
        _window(full, 16 - K, H_LOCAL + 2 * K, 0, W_TOTAL), "cpu")
    out = {k: torch.zeros_like(v) for k, v in ext.items()}
    probe = torch.zeros(2)
    step = cuda_block.make_block_step(tm, False)
    step(ext, out, 16 - K, 0, probe, 1)          # owns row 20
    after, want = unsharded_steps(tm, full, 1)
    assert abs(float(probe[1]) - float(want[0])) <= 1e-5 and probe[0] == 0
    ext0 = interop.state_from_numpy(
        _window(full, -K, H_LOCAL + 2 * K, 0, W_TOTAL), "cpu")
    with pytest.raises(ValueError, match="probe pixel"):
        step(ext0, out, -K, 0, probe, 0)         # rows 0-15 do not
    with pytest.raises(ValueError, match="window"):
        step(ext, out, 40, 0)                    # runs past the domain


def test_block_geometry_equals_the_grid_geometry_on_a_whole_grid():
    """A block that is the whole domain (no ghosts in use) computes the
    clamped stencil of ops/stencil.py."""
    from fib_tf_tpu_torch.ops import stencil
    x = torch.tensor(np.random.RandomState(6).normal(size=(12, 9))
                     .astype(np.float32))
    for two_d in (False, True):
        g = cuda_block.block_geometry(
            cuda_block.global_rows(0, 12, "cpu"), 12,
            cuda_block.global_cols(0, 9, "cpu") if two_d else None,
            9 if two_d else None)
        torch.testing.assert_close(g.enforce_boundary(x),
                                   stencil.enforce_boundary(x), rtol=0,
                                   atol=0)
        torch.testing.assert_close(g.laplace(x), stencil.laplace(x),
                                   rtol=1e-6, atol=1e-5)


# -- the one-ring exchange --------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4,), (2, 2), (3, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_halo_exchange_equals_the_unsharded_stencil(shape):
    from fib_tf_tpu_torch.ops import stencil
    mesh = cpu_mesh(shape)
    x = np.random.RandomState(7).normal(size=(24, 16)).astype(np.float32)
    pots = shard_state({"V": x}, mesh)["V"]
    n_cols = mesh.grid[1]
    ring = halo.HaloExchange(pots, two_d=n_cols > 1)
    v0 = stencil.enforce_boundary(torch.tensor(x))
    lap = stencil.laplace(v0)
    got_v0 = np.empty(mesh.size, dtype=object)
    got_lap = np.empty(mesh.size, dtype=object)
    for i in range(mesh.size):
        g = ring.geometry(*divmod(i, n_cols))
        got_v0[i] = g.enforce_boundary(pots.flat[i])
        got_lap[i] = g.laplace(got_v0[i])
        with pytest.raises(ValueError, match="another tensor"):
            g.laplace(pots.flat[i])
    from fib_tf_tpu_torch.parallel.sharding import gather_array
    np.testing.assert_array_equal(
        gather_array(got_v0.reshape(mesh.devices.shape)), v0.numpy())
    np.testing.assert_array_equal(
        gather_array(got_lap.reshape(mesh.devices.shape)), lap.numpy())


# -- make_spmd_chunk against the JAX chunk and the unsharded step ------------------------


@functools.lru_cache(maxsize=None)
def _jax_chunk_result(skip, shape, wide):
    c = cfg(skip=skip)
    jm = jbr.BeelerReuter(jax_cfg(c))
    mesh = jax_mesh(shape)
    chunk = jspmd.make_spmd_chunk(jm, mesh, length=2, wide_halo=wide,
                                  use_kernel=wide)
    st = seeded_state(tbr.BeelerReuter(c), seed=8)
    state, probes = chunk(jsharding.shard_state(st, mesh))
    return ({k: np.asarray(v) for k, v in state.items()},
            np.asarray(probes["v"]))


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4x1", "2x2"])
@pytest.mark.parametrize("mode", ["ring", "wide", "wide_kernel"])
def test_spmd_chunk_matches_jax_chunk_and_unsharded(mode, shape, skip):
    """Two outer steps of 64x64 on four shards: the per-substep exchange,
    the wide-halo plain step and the wide-halo block step (its plain
    version on the CPU), against the JAX chunk with the same flags (the
    Pallas block kernel, interpret mode, for both wide-halo cases) and
    against the port's unsharded step."""
    wide = mode != "ring"
    tm = tbr.BeelerReuter(cfg(skip=skip))
    st = seeded_state(tm, seed=8)
    mesh = cpu_mesh(shape)
    chunk = spmd.make_spmd_chunk(tm, mesh, 2, wide_halo=wide,
                                 use_kernel=mode == "wide_kernel")
    sharded = shard_state(st, mesh)
    out, probes = chunk(sharded)
    got = gather_state(out)
    want, want_probes = _jax_chunk_result(skip, shape, wide)
    ref, ref_probes = unsharded_steps(tm, st, 2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)
        assert np.abs(got[k] - want[k]).max() <= 1e-4
    np.testing.assert_allclose(probes["v"].numpy(), want_probes, atol=1e-5)
    np.testing.assert_allclose(probes["v"].numpy(), ref_probes, atol=1e-5)
    if not wide:    # the same arithmetic in the same order: bit-equal
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the chunk leaves its input alone
    np.testing.assert_array_equal(gather_state(sharded)["V"], st["V"])
    assert cuda_block.KERNEL.launches == 0


def test_shard_state_round_trip():
    st = seeded_state(tbr.BeelerReuter(cfg()), seed=9)
    for shape in ((4,), (2, 2), (1,), (2, 4)):
        mesh = cpu_mesh(shape)
        sharded = interop.shard_state(st, mesh)
        assert sharded["V"].shape == mesh.devices.shape
        n_rows, n_cols = mesh.grid
        assert tuple(sharded["V"].flat[0].shape) == (64 // n_rows,
                                                     64 // n_cols)
        assert all(t.is_contiguous() and t.dtype == torch.float32
                   for t in sharded["C"].flat)
        back = interop.gather_state(sharded)
        for k in st:
            np.testing.assert_array_equal(back[k], st[k])
    # the JAX package shards the same arrays the same way
    jm = jax_mesh((2, 2))
    js = jsharding.shard_state(st, jm)
    ours = interop.shard_state(st, cpu_mesh((2, 2)))
    for shard in js["V"].addressable_shards:
        r, c = shard.index[0].start // 32, shard.index[1].start // 32
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      ours["V"][r, c].numpy())


# -- the slice as a whole ------------------------------------------------------------------

ENGINE_CFG = SimConfig(width=64, height=64, dt=0.1, dt_per_plot=10,
                       diff=0.809, duration=30, cheby=True, skip=True)
SCHEDULE = [(15.0, "s2")]


def _run(sim):
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0)
    return sim.simulate(schedule=SCHEDULE)


@functools.lru_cache(maxsize=None)
def _unsharded_run():
    return _run(Simulation(tbr.BeelerReuter(ENGINE_CFG), device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_sharded_run():
    return _run(JaxSimulation(jbr.BeelerReuter(jax_cfg(ENGINE_CFG)),
                              mesh=jax_mesh((4,)), wide_halo=True))


def _check_run(got, want, exact=False):
    assert got.steps == want.steps == 60
    assert got.cycle_lengths == want.cycle_lengths == [(32, 16.0)]
    for k in want.state:
        tol = (dict(atol=0, rtol=0) if exact
               else dict(atol=V_ATOL, rtol=0) if k == "V"
               else dict(atol=0, rtol=1e-3) if k == "C"
               else dict(atol=1e-3, rtol=0))
        np.testing.assert_allclose(got.state[k], want.state[k], err_msg=k,
                                   **tol)
    np.testing.assert_allclose(got.probes["v"], want.probes["v"],
                               atol=0 if exact else V_ATOL / 120.0, rtol=0)


@pytest.mark.parametrize("how", ["mesh", "mesh_2x2", "config", "ring"])
def test_sharded_simulation_matches_jax_and_unsharded(how):
    """64x64 for 30 ms with an S2 at 15 ms whose quadrant spans two row
    shards: `Simulation(mesh=..., wide_halo=True)` on 4x1 and 2x2, the same
    through `SimConfig(mesh_shape=(4,), mesh_mode='spmd')` with
    `device='cpu'`, and the per-substep exchange, against the JAX
    `Simulation(mesh=make_mesh(n_devices=4), wide_halo=True)` and the
    port's unsharded CPU run."""
    if how == "config":
        sim = Simulation(tbr.BeelerReuter(ENGINE_CFG.replace(
            mesh_shape=(4,), mesh_mode="spmd")), device="cpu")
        assert sim._wide_halo and sim._mesh.grid == (4, 1)
    else:
        mesh = cpu_mesh((2, 2) if how == "mesh_2x2" else (4,))
        sim = Simulation(tbr.BeelerReuter(ENGINE_CFG), mesh=mesh,
                         wide_halo=how != "ring")
    assert sim.route == "plain" and sim.device.type == "cpu"
    got = _run(sim)
    assert got.state["V"].shape == (64, 64)
    _check_run(got, _unsharded_run(), exact=how == "ring")
    _check_run(got, _jax_sharded_run())
    np.testing.assert_array_equal(sim.state["V"], got.state["V"])


def test_sharded_pacing_spans_row_shards():
    sim = Simulation(tbr.BeelerReuter(ENGINE_CFG), mesh=cpu_mesh((4,)),
                     wide_halo=True).define()
    sim.add_pace_op("s1", "left", 10.0)
    state = interop.shard_state(sim.model.initial_state(s1=False),
                                sim._mesh)
    before = state["V"]
    fired = gather_state(sim.fire_on(state, "s1"))["V"]
    assert (fired[:, :5] == 10.0).all() and (fired[:, 5:] < -80).all()
    assert state["V"] is not before          # the caller's array is kept


def test_sharded_finiteness_flag():
    st = tbr.BeelerReuter(ENGINE_CFG).initial_state()
    st["V"][40, 10] = np.nan                  # third row shard
    sim = Simulation(tbr.BeelerReuter(ENGINE_CFG.replace(duration=1)),
                     mesh=cpu_mesh((4,)), wide_halo=True)
    with pytest.raises(FloatingPointError):
        sim.simulate(state=st)


# -- the refusals ----------------------------------------------------------------------------


def test_too_few_rows_or_columns_per_shard_raise():
    small = tbr.BeelerReuter(cfg(height=16, width=64))
    with pytest.raises(ValueError, match="rows per shard"):
        Simulation(small, mesh=cpu_mesh((4,)), wide_halo=True)
    narrow = tbr.BeelerReuter(cfg(height=64, width=8))
    with pytest.raises(ValueError, match="rows and columns per shard"):
        Simulation(narrow, mesh=cpu_mesh((2, 2)), wide_halo=True)
    low = tbr.BeelerReuter(cfg(height=32))
    with pytest.raises(ValueError, match="rows per shard"):
        spmd.make_spmd_chunk(low, cpu_mesh((8,)), 1, wide_halo=True)(
            shard_state(low.initial_state(), cpu_mesh((8,))))
    with pytest.raises(ValueError, match="rows per shard"):
        Simulation(tbr.BeelerReuter(cfg(height=16, mesh_shape=(4,),
                                        mesh_mode="spmd")), device="cpu")
    # the same texts as the reference's
    with pytest.raises(ValueError) as ref:
        jspmd.check_wide_halo_shards(4, 64, 5, False)
    with pytest.raises(ValueError) as ours:
        spmd.check_wide_halo_shards(4, 64, 5, False)
    assert str(ours.value) == str(ref.value)


def test_uneven_shards_raise():
    with pytest.raises(ValueError, match="divisible"):
        Simulation(tbr.BeelerReuter(cfg(height=66)), mesh=cpu_mesh((4,)))
    with pytest.raises(ValueError, match="divisible"):
        shard_state({"V": np.zeros((10, 8), np.float32)}, cpu_mesh((4,)))


def test_use_kernel_without_wide_halo_raises():
    tm = tbr.BeelerReuter(cfg())
    with pytest.raises(ValueError, match="wide_halo"):
        spmd.make_spmd_chunk(tm, cpu_mesh((4,)), 2, use_kernel=True)
    with pytest.raises(ValueError, match="wide_halo"):
        jspmd.make_spmd_chunk(jbr.BeelerReuter(jax_cfg(cfg())),
                              jax_mesh((4,)), 2, use_kernel=True)
    # kernel='pallas' needs CUDA devices, whatever the exchange
    with pytest.raises(ValueError, match="CUDA"):
        Simulation(tbr.BeelerReuter(cfg(kernel="pallas")),
                   mesh=cpu_mesh((4,)), wide_halo=True)
    with pytest.raises(ValueError, match="wide_halo=True"):
        simulation._check_mesh(tbr.BeelerReuter(cfg(kernel="pallas")),
                               cpu_mesh((4,)), wide_halo=False)


def test_spmd_route():
    tm = tbr.BeelerReuter(cfg())
    assert simulation.spmd_route(tm, "cuda", "auto", True) == "block"
    assert simulation.spmd_route(tm, "cuda", "pallas", True) == "block"
    assert simulation.spmd_route(tm, "cuda", "xla", True) == "plain"
    assert simulation.spmd_route(tm, "cuda", "auto", False) == "plain"
    assert simulation.spmd_route(tm, "cpu", "auto", True) == "plain"


@pytest.mark.parametrize("kw", [
    dict(mesh_shape=(4,), mesh_mode="gspmd"),
    dict(mesh_shape=(4,), height=66),              # 'auto' + a disqualifier
])
def test_gspmd_modes_raise(kw):
    with pytest.raises(NotImplementedError, match="GSPMD.*ROADMAP"):
        Simulation(tbr.BeelerReuter(cfg(**kw)), device="cpu")


def test_gspmd_sharding_argument_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation(tbr.BeelerReuter(cfg()), device="cpu", sharding=object())
    with pytest.raises(ValueError, match="mesh_mode='spmd' cannot"):
        Simulation(tbr.BeelerReuter(cfg(mesh_shape=(4,), height=66,
                                        mesh_mode="spmd")), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(phase=np.ones((64, 64), np.float32)),
    dict(dmap=np.ones((64, 64), np.float32)),
    dict(fiber=(1.0, 0.0, 1.0)), dict(egm_masks=[np.ones((64, 64))]),
    dict(ecg_weights=[np.ones((64, 64))]),
    dict(trend_points=(("V", 3, 3),)), dict(rotor=(10, 0.5)),
], ids=lambda kw: next(iter(kw)))
def test_unported_spmd_arguments_raise(kw):
    """The sharded observables not ported yet raise NotImplementedError.
    The geometry is ported: phase / dmap / fiber run one outer step within
    the kernel tolerance of the unsharded plain step under the same
    geometry (tests/test_torch_geometry_spmd.py holds them further), and
    the fiber tensor raises, as the reference does, without wide halos.
    The trend stream is ported: it is the unsharded step's pixel, bit for
    bit (tests/test_torch_large_spmd.py holds it further)."""
    tm = tbr.BeelerReuter(cfg())
    if "trend_points" in kw:
        st = seeded_state(tm, seed=2)
        _, probes = spmd.make_spmd_chunk(tm, cpu_mesh((4,)), 1,
                                         wide_halo=True, **kw)(
            shard_state(st, cpu_mesh((4,))))
        ref, _ = unsharded_steps(tm, st, 1)
        np.testing.assert_array_equal(probes["trend"].numpy(),
                                      ref["V"][3:4, 3:4])
        return
    if next(iter(kw)) not in ("phase", "dmap", "fiber"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            spmd.make_spmd_chunk(tm, cpu_mesh((4,)), 1, wide_halo=True, **kw)
        return
    if "fiber" in kw:
        with pytest.raises(ValueError, match="wide_halo"):
            spmd.make_spmd_chunk(tm, cpu_mesh((4,)), 1, **kw)
    st = seeded_state(tm, seed=2)
    chunk = spmd.make_spmd_chunk(tm, cpu_mesh((4,)), 1, wide_halo=True, **kw)
    got = gather_state(chunk(shard_state(st, cpu_mesh((4,))))[0])
    maps = bodies.GeometryMaps((64, 64), kw.get("phase"), kw.get("fiber"),
                                  kw.get("dmap"))
    ref = interop.state_from_numpy(st, "cpu")
    cuda_step.plain_step(tm, ref, geom=maps.plain("cpu"))
    for k, v in interop.state_to_numpy(ref).items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


def test_make_mesh_contract(monkeypatch):
    """The reference's contract (parallel/sharding.py:20-50) over
    torch.devices."""
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.devices.shape == (4,) and mesh.axis_names == ("x",)
    assert mesh.grid == (4, 1) and mesh.size == 4
    mesh = make_mesh(shape=(2, 2), devices=["cpu"] * 4)
    assert mesh.axis_names == ("x", "y") and mesh.grid == (2, 2)
    assert mesh.device(1, 1) == torch.device("cpu")
    with pytest.raises(ValueError, match="does not match"):
        make_mesh(shape=(3,), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="refusing to silently shrink"):
        make_mesh(devices=["cpu"] * 2, n_devices=4)
    assert make_mesh(devices=["cpu"] * 4, n_devices=2).size == 2
    # no card and no devices=: it never builds a CPU mesh by itself
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=["cuda:0"] * 4)
    with pytest.raises(RuntimeError):
        Simulation(tbr.BeelerReuter(cfg(mesh_shape=(4,))))
    # more devices than there are
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="refusing to silently shrink"):
        make_mesh(n_devices=4)
    with pytest.raises(ValueError, match="refusing to silently shrink"):
        simulation._config_mesh(tbr.BeelerReuter(cfg(mesh_shape=(4,))),
                                "cuda")
