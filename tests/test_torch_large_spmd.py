"""The four large models (Courtemanche, Courtemanche-ultra, Luo-Rudy 1991,
tp06) on the port's sharded paths, held on the CPU against the port's
unsharded runs and against fib_tf_tpu: `Simulation(mesh=...)` with and
without wide halos on 4x1 and 2x2 meshes of CPU entries (with the "trend"
and "ultra" streams), the JAX `make_spmd_chunk` on the virtual CPU devices
(tests/test_sharding.py's TestShardedObservables), the plain block step
against the JAX block kernel in interpret mode, `run_volume` on z shards,
and the routes of table mode.

Tolerances: a sharded run equals the unsharded one bit for bit (the same
elementwise arithmetic in the same order, shard by shard; the block
geometry sums the stencil as ops/stencil.py does), but for "ultra", whose
sums over the shards run in another order: rtol 1e-6.  Against the JAX
chunk the reference's sharded-vs-unsharded bounds: rtol 2e-5 / atol 2e-5
for "v" and "trend", rtol 1e-4 / atol 1e-5 for "ultra"
(tests/test_sharding.py:597-625), and rtol 1e-3 / atol 1e-5 on the planes,
the JAX package's kernel-vs-XLA bound (tests/test_pallas.py:90-97), which
also holds the plain block step to the JAX block kernel."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.engine.volume as jvol
import fib_tf_tpu.models.courtemanche as jc
import fib_tf_tpu.parallel.sharding as jsharding
import fib_tf_tpu.parallel.spmd as jspmd
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.ops.pallas_tiled import make_block_kernel
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation, run_volume, simulation, volume
from fib_tf_tpu_torch.models import (Courtemanche, CourtemancheUltra,
                                     LuoRudy91, TenTusscher06)
from fib_tf_tpu_torch.ops import (bodies, cuda_block, cuda_step,
                                  cuda_volume_block)
from fib_tf_tpu_torch.ops import stencil
from fib_tf_tpu_torch.parallel import (gather_state, make_mesh, shard_state,
                                       spmd)
from test_torch_fixtures import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=1e-5)
PROBE_TOL = dict(rtol=2e-5, atol=2e-5)
ULTRA_JAX_TOL = dict(rtol=1e-4, atol=1e-5)
# tests/test_sharding.py's grid and hole: width 64, height 128, a hole of
# radius 6 at column 20, row 64, on the boundary of two row shards
H, W = 128, 64
HOLE = (20, 64, 6)
# (class, configuration, outer steps): an S2 over the upper left quadrant
# after the first outer step
MODELS = {
    "court": (Courtemanche, dict(dt=0.1, duration=3.0), 3),
    "court_ultra": (CourtemancheUltra, dict(dt=0.1, duration=3.0), 3),
    "lr1": (LuoRudy91, dict(dt=0.02, duration=0.8), 4),
    "tp06": (TenTusscher06, dict(dt=0.02, duration=0.8,
                                 cell_type="transmural"), 4),
}


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


def cfg(name, height=H, width=W, **kw):
    c = dict(width=width, height=height, dt_per_plot=10, diff=0.809,
             **MODELS[name][1])
    c.update(kw)
    return SimConfig(**c)


def chronic_plane(height=H, width=W):
    """The left half remodeled."""
    p = np.zeros((height, width), np.float32)
    p[:, :width // 2] = 1.0
    return p


def model_of(name, **kw):
    """The model with what a user attaches after construction: Court's
    regional chronic plane, LR1's spiral g_si, tp06's g_kr dose plane
    beside its transmural planes."""
    c = cfg(name, **kw)
    model = MODELS[name][0](c)
    h, w = model.state_shape()
    if name == "court":
        model.set_het(chronic=chronic_plane(h, w))
    elif name == "lr1":
        model.g_si = 0.02
    elif name == "tp06":
        model.set_het(g_kr=np.linspace(0.2, 1.0, w, dtype=np.float32)[
            None].repeat(h, 0))
    return model


def cpu_mesh(shape):
    return make_mesh(shape=shape, devices=["cpu"] * int(np.prod(shape)))


def jax_mesh(shape):
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU devices of tests/conftest.py")
    if len(shape) == 1:
        return jsharding.make_mesh(n_devices=shape[0])
    return jsharding.make_mesh(shape=shape,
                               devices=jax.devices()[:int(np.prod(shape))])


def phase_field():
    return stencil.add_hole_to_phase_field(None, H, W, *HOLE)


def simulate(name, mesh=None, wide_halo=False):
    sim = Simulation(model_of(name), device="cpu", mesh=mesh,
                     wide_halo=wide_halo)
    sim.add_hole_to_phase_field(*HOLE)
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0 if name.startswith("court") else 20.0)
    dt = MODELS[name][1]["dt"]
    return sim, sim.simulate(schedule=[(10 * dt, "s2")])


@functools.lru_cache(maxsize=None)
def _unsharded(name):
    return simulate(name)[1]


# -- Simulation(mesh=...) against the unsharded run ----------------------------------


@pytest.mark.parametrize("wide", [True, False], ids=["wide", "per_substep"])
@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4x1", "2x2"])
@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_run_equals_the_unsharded_run(name, shape, wide):
    """128x64 with the hole, three outer steps and an S2 that spans the
    shards: the final state, "v" and "trend" bit-equal to the unsharded
    run, "ultra" within rtol 1e-6; the route is the plain step."""
    sim, got = simulate(name, cpu_mesh(shape), wide)
    want = _unsharded(name)
    assert sim.route == "plain" and sim._mesh.grid == (
        (4, 1) if shape == (4,) else (2, 2))
    assert got.steps == want.steps == MODELS[name][2]
    assert set(got.state) == set(want.state) == set(sim.model.state_keys())
    for k in want.state:
        np.testing.assert_array_equal(got.state[k], want.state[k],
                                      err_msg=k)
    assert sorted(got.probes) == sorted(want.probes)
    assert sorted(want.probes) == {
        "court": ["trend", "v"], "court_ultra": ["trend", "ultra", "v"]
    }.get(name, ["v"])
    for k in want.probes:
        if k == "ultra":
            np.testing.assert_allclose(got.probes[k], want.probes[k],
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got.probes[k], want.probes[k],
                                          err_msg=k)
    assert np.isfinite(got.state["V"]).all()


# -- against the JAX sharded chunk ---------------------------------------------------------

CHUNK_STEPS = 3


def _chunk_state(name):
    """The initial state with V drawn per cell over the upstroke, so that
    every cell fires within the chunk."""
    st = model_of(name).initial_state()
    rng = np.random.RandomState(3)
    st["V"] = rng.uniform(-85.0, 20.0, (H, W)).astype(np.float32)
    return st


@functools.lru_cache(maxsize=None)
def _jax_chunk(name, shape):
    c = cfg(name)
    jm = getattr(jc, {"court": "Courtemanche",
                      "court_ultra": "CourtemancheUltra"}[name])(jax_cfg(c))
    if name == "court":
        jm.set_het(chronic=chronic_plane())
    mesh = jax_mesh(shape)
    chunk = jspmd.make_spmd_chunk(jm, mesh, length=CHUNK_STEPS,
                                  phase=phase_field(), wide_halo=True,
                                  trend_points=jm.trend_points)
    state, probes = chunk(jsharding.shard_state(_chunk_state(name), mesh))
    return ({k: np.asarray(v) for k, v in state.items()},
            {k: np.asarray(v) for k, v in probes.items()})


@pytest.mark.parametrize("name,shape", [("court", (4,)),
                                        ("court_ultra", (2, 2))])
def test_sharded_chunk_matches_the_jax_chunk(name, shape):
    """Three outer steps of the wide-halo chunk with the hole: the final
    planes and the "v", "trend" and "ultra" streams against the JAX
    `make_spmd_chunk` on the same mesh shape, at the reference's
    sharded-vs-unsharded tolerances."""
    tm = model_of(name)
    phase = phase_field()
    chunk = spmd.make_spmd_chunk(tm, cpu_mesh(shape), CHUNK_STEPS,
                                 phase=phase, wide_halo=True,
                                 trend_points=tm.trend_points)
    out, probes = chunk(shard_state(_chunk_state(name), cpu_mesh(shape)))
    got = gather_state(out)
    want, want_probes = _jax_chunk(name, shape)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    r, c = tm.probe_pixel
    np.testing.assert_allclose(probes["v"].numpy() * phase[r, c],
                               want_probes["v"], **PROBE_TOL)
    np.testing.assert_allclose(probes["trend"].numpy(),
                               want_probes["trend"], **PROBE_TOL)
    assert ("ultra" in probes) == ("ultra" in want_probes) == (
        name == "court_ultra")
    if "ultra" in want_probes:
        np.testing.assert_allclose(probes["ultra"].numpy(),
                                   want_probes["ultra"], **ULTRA_JAX_TOL)


# -- the plain block step against the JAX block kernel -----------------------------------

BLOCK_H, BLOCK_W, BLOCK_OWN = 32, 32, 16
K = Courtemanche.dt_per_step


@functools.lru_cache(maxsize=None)
def _jax_block_kernel():
    jm = jc.Courtemanche(jax_cfg(cfg("court", BLOCK_H, BLOCK_W)))
    return make_block_kernel(jm, BLOCK_OWN + 2 * K, BLOCK_W, BLOCK_H, None,
                             False, interpret=True)


def _window(st, r0, n_rows):
    """Rows [r0, r0 + n_rows) of a host state, wrapped round the domain as
    the ring exchange wraps them."""
    return {k: np.ascontiguousarray(v[np.arange(r0, r0 + n_rows)
                                      % v.shape[0]])
            for k, v in st.items()}


@pytest.mark.parametrize("origin", [0, BLOCK_OWN], ids=["top", "bottom"])
def test_plain_block_step_matches_the_jax_block_kernel(origin):
    """One outer step of each of two 16x32 shards' extended blocks: the
    plain block step against the JAX Pallas block kernel (interpret mode)
    and, bit for bit, against the unsharded plain step."""
    tm = Courtemanche(cfg("court", BLOCK_H, BLOCK_W))
    full = tm.initial_state()
    rng = np.random.RandomState(5)
    full["V"] = rng.uniform(-90.0, 40.0, (BLOCK_H, BLOCK_W)).astype(
        np.float32)
    rstart = origin - K
    ext = _window(full, rstart, BLOCK_OWN + 2 * K)
    want = _jax_block_kernel()({k: jnp.asarray(v) for k, v in ext.items()},
                               rstart, None)
    ext_in = interop.state_from_numpy(ext, "cpu")
    ext_out = {k: torch.zeros_like(v) for k, v in ext_in.items()}
    probe = torch.zeros(1)
    step = cuda_block.make_block_step(tm, False)
    owns = origin <= tm.probe_pixel[0] < origin + BLOCK_OWN
    assert step(ext_in, ext_out, rstart, 0,
                probe if owns else None) is ext_out
    ref = interop.state_from_numpy(full, "cpu")
    ref_probe = torch.zeros(1)
    cuda_step.plain_step(tm, ref, ref_probe, 0)
    for k in want:
        got = cuda_block.centre(ext_out[k], K, False).numpy()
        np.testing.assert_allclose(
            got, np.asarray(cuda_block.centre(want[k], K, False)),
            err_msg=k, **TOL)
        np.testing.assert_array_equal(
            got, ref[k][origin:origin + BLOCK_OWN].numpy(), err_msg=k)
    # the input block is left alone, the output's ghosts to the exchange
    np.testing.assert_array_equal(ext_in["V"].numpy(), ext["V"])
    assert float(ext_out["V"][:K].abs().max()) == 0.0
    if owns:
        assert float(probe[0]) == float(ref_probe[0])


# -- run_volume on z shards ---------------------------------------------------------------

DEPTH, VH, VW, V_STEPS = 20, 16, 24, 3


def _volume_state(model):
    """The extruded state (S1 slab, het planes) with V raised per cell by
    N(0, 2) mV, so that no two slices are equal."""
    st = volume.volume_state(model, DEPTH)
    rng = np.random.RandomState(7)
    st["V"] = st["V"] + rng.normal(0.0, 2.0, st["V"].shape).astype(
        np.float32)
    return st


@functools.lru_cache(maxsize=None)
def _jax_court_volume():
    c = cfg("court", VH, VW, dt=0.05)
    jm = jc.Courtemanche(jax_cfg(c))
    jm.set_het(chronic=chronic_plane(VH, VW))
    final, probes, _ = jvol.run_volume(
        jm, DEPTH, V_STEPS, state=_volume_state(model_of("court", height=VH,
                                                         width=VW, dt=0.05)),
        mesh=jax_mesh((2,)), wide_halo=True, kernel="xla")
    return final, np.asarray(probes)


@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_run_volume_equals_the_unsharded_volume(name):
    """20x16x24 on two z shards of 10 slices (K = 10) for three outer
    steps: bit-equal to the unsharded run_volume (the plain step), and
    Courtemanche also against the JAX run_volume on two z shards;
    Courtemanche-ultra's uniform substeps split into groups of five
    (halo_k=5), Courtemanche's refuse to."""
    dt = 0.05 if name.startswith("court") else 0.02
    tm = model_of(name, height=VH, width=VW, dt=dt)
    st = _volume_state(tm)
    final, probes, _ = run_volume(tm, DEPTH, V_STEPS, state=st,
                                  mesh=cpu_mesh((2,)), wide_halo=True)
    whole, whole_probes, _ = run_volume(tm, DEPTH, V_STEPS, state=st,
                                        device="cpu")
    assert set(final) == set(whole) == set(tm.state_keys())
    for k in whole:
        np.testing.assert_array_equal(final[k], whole[k], err_msg=k)
    np.testing.assert_array_equal(probes, whole_probes)
    if name == "court_ultra":
        # uniform substeps: two exchanges of five slices per outer step
        split, split_probes, _ = run_volume(
            tm, DEPTH, V_STEPS, state=st, mesh=cpu_mesh((2,)),
            wide_halo=True, halo_k=5)
        for k in whole:
            np.testing.assert_array_equal(split[k], whole[k], err_msg=k)
        np.testing.assert_array_equal(split_probes, whole_probes)
    if name == "court":
        with pytest.raises(ValueError, match="uniform substeps"):
            run_volume(tm, DEPTH, V_STEPS, state=st, mesh=cpu_mesh((2,)),
                       wide_halo=True, halo_k=5)
        want, want_probes = _jax_court_volume()
        for k in want:
            np.testing.assert_allclose(final[k], np.asarray(want[k]),
                                       err_msg=k, **TOL)
        np.testing.assert_allclose(probes, want_probes, **PROBE_TOL)


# -- the routes, the planes and the bindings ----------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_routes_on_a_mesh(name):
    """The block kernels on a CUDA mesh under 'auto' and 'pallas', the
    plain step under 'xla', on a CPU mesh and per substep; kernel 6 under
    'auto' and 'pallas'."""
    tm = model_of(name, height=40, width=32)
    for kernel in ("auto", "pallas"):
        assert simulation.spmd_route(tm, "cuda", kernel, True) == "block"
        assert volume._use_shard_kernel(tm, "cuda", kernel)
    assert simulation.spmd_route(tm, "cuda", "xla", True) == "plain"
    assert simulation.spmd_route(tm, "cuda", "auto", False) == "plain"
    assert simulation.spmd_route(tm, "cpu", "auto", True) == "plain"
    assert not volume._use_shard_kernel(tm, "cuda", "xla")
    assert not volume._use_shard_kernel(tm, "cpu", "auto")
    with pytest.raises(ValueError, match="CUDA"):
        simulation.spmd_route(tm, "cpu", "pallas", True)
    body = bodies.body_on(tm, 3)
    assert bodies.body_on(tm, 6) is body and body.kernels == (1, 3, 4, 6)
    with pytest.raises(NotImplementedError, match="never routes"):
        bodies.body_on(tm, 2)


@pytest.mark.parametrize("name", list(MODELS))
def test_config_mesh_shape_runs_the_large_models(name):
    """`SimConfig(mesh_shape=(2, 2), mesh_mode='spmd')` with
    `device='cpu'` builds a CPU mesh and takes the wide-halo path; the run
    equals the unsharded one bit for bit."""
    tm = model_of(name, height=40, width=32, mesh_shape=(2, 2),
                  mesh_mode="spmd")
    sim = Simulation(tm, device="cpu")
    assert sim._wide_halo and sim._mesh.grid == (2, 2)
    got = sim.simulate()
    want = Simulation(model_of(name, height=40, width=32),
                      device="cpu").simulate()
    for k in want.state:
        np.testing.assert_array_equal(got.state[k], want.state[k],
                                      err_msg=k)
    np.testing.assert_array_equal(got.probes["v"], want.probes["v"])


def test_table_mode_runs_the_plain_step_on_a_mesh():
    """Court's table mode takes the plain step on a mesh under 'auto', on
    both sharded paths, and raises under 'pallas' (fib_tf_tpu/engine/
    simulation.py:784, volume.py:215-219); a sharded table run equals the
    unsharded one bit for bit."""
    tab = Courtemanche(cfg("court", 40, 32, table=True, duration=2.0))
    assert simulation.spmd_route(tab, "cuda", "auto", True) == "plain"
    assert not volume._use_shard_kernel(tab, "cuda", "auto")
    with pytest.raises(ValueError, match="table-mode gathers"):
        simulation.spmd_route(tab, "cuda", "pallas", True)
    with pytest.raises(ValueError, match="table-mode gathers"):
        volume._use_shard_kernel(tab, "cuda", "pallas")
    got = Simulation(tab, mesh=cpu_mesh((4,)), wide_halo=True).simulate()
    want = Simulation(Courtemanche(tab.cfg), device="cpu").simulate()
    for k in want.state:
        np.testing.assert_array_equal(got.state[k], want.state[k],
                                      err_msg=k)
    np.testing.assert_array_equal(got.probes["trend"], want.probes["trend"])


def test_nullable_planes_and_the_clamped_probe():
    """tp06 with a g_kr plane attached after construction and its three
    other het planes absent: every shard carries the g_kr plane and none
    of the absent ones, whose kernel pointers are null; LR1 on a 16-row
    grid probes its clamped row 15, which the last of four row shards
    owns; both sharded runs equal the unsharded ones."""
    tm = model_of("tp06", height=40, width=32, cell_type="epi")
    assert tm.het_keys() == ("_p_g_kr",)
    sharded = interop.shard_state(tm.initial_state(), cpu_mesh((4,)))
    shards = spmd.shards_of(sharded, cpu_mesh((4,)), tm.state_keys())
    for s in shards:
        assert "_p_g_kr" in s and not {"_p_endo", "_p_g_ks",
                                       "_p_g_to"} & set(s)
        ptrs = list(bodies.plane_pointers(s, bodies.TP06_PLANES))
        absent = [bodies.TP06_PLANES.index(k)
                  for k in ("_p_endo", "_p_g_ks", "_p_g_to")]
        assert all(ptrs[i] is None for i in absent)
    got = Simulation(tm, mesh=cpu_mesh((4,)), wide_halo=True).simulate()
    want = Simulation(model_of("tp06", height=40, width=32,
                               cell_type="epi"), device="cpu").simulate()
    for k in want.state:
        np.testing.assert_array_equal(got.state[k], want.state[k],
                                      err_msg=k)

    lr1 = model_of("lr1", height=16, width=32)
    assert lr1.probe_pixel == (15, 16)
    assert spmd.probe_owner(lr1, cpu_mesh((4,)), 4, 32) == (3, 3, 16)
    got = Simulation(lr1, mesh=cpu_mesh((4,)), wide_halo=False).simulate()
    want = Simulation(model_of("lr1", height=16, width=32),
                      device="cpu").simulate()
    np.testing.assert_array_equal(got.probes["v"], want.probes["v"])
    np.testing.assert_array_equal(got.state["V"], want.state["V"])


def test_large_block_bindings_and_schedules():
    """Kernel 3's large bodies bind csrc/large_block.cu in their own
    libraries, both forms in one; kernel 6's build with their kernel-1
    library's defines and flags; Courtemanche's group is eleven launches
    of ten substeps, and a block too shallow for them raises."""
    for name, lib in (("court", "court"), ("court_ultra", "court"),
                      ("lr1", "lrtp"), ("tp06", "lrtp")):
        for table in (cuda_block.KERNELS, cuda_block.GEOM_KERNELS):
            k = table[name]
            assert isinstance(k, cuda_block.LargeBlockKernel)
            assert k.library_name == f"{lib}_block"
            assert k.entry == f"{name}_block" + ("_geom" if k.geom else "")
        vk = cuda_volume_block.KERNELS[name]
        assert vk.library_name == f"{lib}_volume_block"
        assert vk.body.library.flags == ("-fmad=false",)
        assert not cuda_block.large_body("br")
    court = model_of("court", height=VH, width=VW, dt=0.05)
    assert cuda_volume_block.group_schedule(court, None) == (
        (False, True) + (False,) * 9)
    with pytest.raises(ValueError, match="uniform substeps"):
        cuda_volume_block.group_schedule(court, 5)
    ultra = model_of("court_ultra", height=VH, width=VW, dt=0.05)
    assert cuda_volume_block.group_schedule(ultra, 5) == (True,) * 5
    with pytest.raises(ValueError, match="no centre"):
        cuda_volume_block.make_volume_block_step(court, 20, 40)
    cuda_volume_block.make_volume_block_step(court, 21, 40)
