"""The port's sharded 2D geometry held against fib_tf_tpu on the CPU: the
extended block's operators (`cuda_block.block_geometry` with a phase field,
a fiber tensor and a diffusion map) against the JAX `block_geometry`, the
plain block step (kernel 3's plain version) against the JAX Pallas block
kernel `make_block_kernel(has_phase=, fiber=, has_dmap=)` in interpret
mode, the per-substep exchange's maps, and `make_spmd_chunk` /
`Simulation(mesh=...)` with geometry on meshes of four CPU entries (4x1,
2x2) against the JAX chunk and against the port's unsharded runs.

The geometries (a), (b), (c), the model pairs and the seeded states are
tests/test_torch_geometry.py's.

Tolerances: operators rtol 1e-5 / atol 1e-5 (the block's 9-point sum
adds the diagonals in the reference block_geometry's order, the whole
grid's stencil in its own); the plain block step against the JAX block
kernel, and sharded chunks against unsharded steps, rtol 1e-3 / atol 1e-5
over two outer steps (the JAX package's kernel-vs-XLA bound,
tests/test_pallas.py); whole runs 1e-3 of the model's range
(tests/test_golden.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.ops.pallas_tiled as jtiled
import fib_tf_tpu.parallel.sharding as jsharding
import fib_tf_tpu.parallel.spmd as jspmd
import test_torch_geometry as geo
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation
from fib_tf_tpu_torch.models import BeelerReuter
from fib_tf_tpu_torch.ops import bodies, cuda_block, cuda_step, stencil
from fib_tf_tpu_torch.parallel import (gather_state, halo, make_mesh,
                                       shard_state, spmd)
from fib_tf_tpu_torch.parallel.sharding import (gather_array,
                                                object_array, shard_array)
from test_torch_fixtures import one_torch_thread  # noqa: F401

OP_TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-3, atol=1e-5)
H, W = 48, 48


def geometry(kind):
    """(phase, fiber, dmap) of geometry `kind` on the 48x48 grid
    (tests/test_torch_geometry.py)."""
    return geo.geometry(kind, H, W)


def model_pair(name, **kw):
    return geo.model_pair(name, h=H, w=W, **kw)


seeded = geo.seeded


def window(a, r0, n_rows, c0, n_cols):
    """Rows [r0, r0 + n_rows) x columns [c0, c0 + n_cols) of a host array,
    wrapped round the domain's edges as the ring exchange wraps them."""
    rows = np.arange(r0, r0 + n_rows) % a.shape[0]
    cols = np.arange(c0, c0 + n_cols) % a.shape[1]
    return np.ascontiguousarray(a[np.ix_(rows, cols)])


def cpu_mesh(shape):
    return make_mesh(shape=shape, devices=["cpu"] * int(np.prod(shape)))


def jax_mesh(shape):
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU devices of tests/conftest.py")
    if len(shape) == 1:
        return jsharding.make_mesh(n_devices=shape[0])
    return jsharding.make_mesh(shape=shape,
                               devices=jax.devices()[:int(np.prod(shape))])


# origin of a 16-row (x 16-column) shard of 48x48, K ghost rings; None: 1D
ORIGINS = [(0, None), (16, None), (32, None), (0, 0), (16, 16), (32, 32),
           (0, 32)]


def block(origin, k):
    """(rstart, cstart, ext_h, ext_w, two_d) of a shard at `origin`."""
    two_d = origin[1] is not None
    return (origin[0] - k, origin[1] - k if two_d else 0, 16 + 2 * k,
            16 + 2 * k if two_d else W, two_d)


# -- the extended block's operators ---------------------------------------------------


@pytest.mark.parametrize("kind", ["a", "b", "c"])
@pytest.mark.parametrize("origin", ORIGINS, ids=lambda o: f"r{o[0]}c{o[1]}")
def test_block_geometry_matches_jax(origin, kind):
    """laplace(enforce_boundary(x)) on a K = 5 extended block: the port's
    block_geometry against the JAX one, on the cells the first substep
    keeps exact (the block less one ring)."""
    k = 5
    rstart, cstart, eh, ew, two_d = block(origin, k)
    phase, fiber, dmap = geometry(kind)
    x = np.random.RandomState(3).uniform(-80, 20, (H, W)).astype(np.float32)
    xe, pe = window(x, rstart, eh, cstart, ew), window(phase, rstart, eh,
                                                       cstart, ew)
    de = None if dmap is None else window(dmap, rstart, eh, cstart, ew)
    rg = rstart + np.arange(eh, dtype=np.int32)[:, None]
    cg = cstart + np.arange(ew, dtype=np.int32)[None, :] if two_d else None
    jg = jtiled.block_geometry(
        jnp.asarray(rg), H, None if cg is None else jnp.asarray(cg),
        W if two_d else None, jnp.asarray(pe), fiber,
        None if de is None else jnp.asarray(de))
    tg = cuda_block.block_geometry(
        torch.tensor(rg), H, None if cg is None else torch.tensor(cg),
        W if two_d else None, torch.tensor(pe), fiber,
        None if de is None else torch.tensor(de))
    want = np.asarray(jg.laplace(jg.enforce_boundary(jnp.asarray(xe))))
    got = tg.laplace(tg.enforce_boundary(torch.tensor(xe))).numpy()
    inner = (slice(1, -1), slice(1, -1) if two_d else slice(None))
    np.testing.assert_allclose(got[inner], want[inner], **OP_TOL)
    # and the whole grid's operator on the block's own cells
    whole = stencil.laplace(stencil.enforce_boundary(torch.tensor(x)),
                            phase_padded=torch.tensor(np.pad(phase, 1,
                                                             "reflect")),
                            dmap_padded=(None if dmap is None else
                                         torch.tensor(np.pad(dmap, 1,
                                                             "reflect"))))
    if fiber is not None:
        whole = stencil.anisotropic_laplace(
            stencil.enforce_boundary(torch.tensor(x)), *fiber,
            phase_padded=torch.tensor(np.pad(phase, 1, "reflect")),
            dmap_padded=(None if dmap is None else
                         torch.tensor(np.pad(dmap, 1, "reflect"))))
    own = (slice(k, -k), slice(k, -k) if two_d else slice(None))
    rows = slice(origin[0], origin[0] + 16)
    cols = slice(origin[1], origin[1] + 16) if two_d else slice(None)
    np.testing.assert_allclose(got[own], whole[rows, cols].numpy(),
                               **OP_TOL)


# -- kernel 3's plain version against the JAX block kernel ------------------------------


@functools.lru_cache(maxsize=None)
def _jax_block_kernel(name, kind, two_d):
    _, jm = model_pair(name)
    k = jm.dt_per_step
    _, fiber, dmap = geometry(kind)
    return jtiled.make_block_kernel(
        jm, 16 + 2 * k, 16 + 2 * k if two_d else W, H,
        W if two_d else None, two_d, has_phase=True, interpret=True,
        fiber=fiber, has_dmap=dmap is not None)


@pytest.mark.parametrize("name,kind,origin", [
    ("br", "c", (0, 32)), ("fenton", "b", (0, None))],
    ids=["br-c-2x2corner", "fenton-b-top"])
def test_plain_block_step_matches_jax_block_kernel(name, kind, origin):
    """One shard's extended block over two outer steps, its ghosts (and
    its maps') cut from the unsharded state each step: the plain block
    step against make_block_kernel with phase / fiber / dmap."""
    tm, jm = model_pair(name)
    k = tm.dt_per_step
    rstart, cstart, eh, ew, two_d = block(origin, k)
    phase, fiber, dmap = geometry(kind)
    pe = window(phase, rstart, eh, cstart, ew)
    de = None if dmap is None else window(dmap, rstart, eh, cstart, ew)
    kern = _jax_block_kernel(name, kind, two_d)
    full = seeded(tm, 4)
    own = (slice(k, -k), slice(k, -k) if two_d else slice(None))
    step = cuda_block.make_block_step(tm, two_d, fiber)
    for _ in range(2):
        ext = {kk: window(v, rstart, eh, cstart, ew) for kk, v in full.items()}
        want = kern({kk: jnp.asarray(v) for kk, v in ext.items()}, rstart,
                    cstart if two_d else None, jnp.asarray(pe),
                    None if de is None else jnp.asarray(de))
        ext_in = interop.state_from_numpy(ext, "cpu")
        ext_out = {kk: torch.zeros_like(v) for kk, v in ext_in.items()}
        step(ext_in, ext_out, rstart, cstart, phase_ext=torch.tensor(pe),
             dmap_ext=None if de is None else torch.tensor(de))
        for kk in want:
            np.testing.assert_allclose(ext_out[kk].numpy()[own],
                                       np.asarray(want[kk])[own],
                                       err_msg=kk, **KERNEL_TOL)
        # advance the whole grid under the unsharded geometry
        geom = bodies.GeometryMaps((H, W), phase, fiber, dmap).plain("cpu")
        st = interop.state_from_numpy(full, "cpu")
        cuda_step.plain_step(tm, st, geom=geom)
        full = interop.state_to_numpy(st)


@pytest.mark.parametrize("kind", ["a", "c"])
@pytest.mark.parametrize("name", ["br", "fenton", "ms"])
def test_plain_block_step_matches_the_unsharded_step(name, kind):
    """Every body's plain block step under a geometry, on the 2x2 corner
    and the 4x1 interior shard: its centre against the unsharded plain
    outer step's cells."""
    tm, _ = model_pair(name)
    k = tm.dt_per_step
    phase, fiber, dmap = geometry(kind)
    full = seeded(tm, 6)
    st = interop.state_from_numpy(full, "cpu")
    cuda_step.plain_step(tm, st, geom=bodies.GeometryMaps(
        (H, W), phase, fiber, dmap).plain("cpu"))
    for origin in ((0, 32), (16, None)):
        if fiber is not None and origin[1] is None and name != "br":
            continue
        rstart, cstart, eh, ew, two_d = block(origin, k)
        ext = interop.state_from_numpy(
            {kk: window(v, rstart, eh, cstart, ew) for kk, v in full.items()},
            "cpu")
        out = {kk: torch.zeros_like(v) for kk, v in ext.items()}
        cuda_block.make_block_step(tm, two_d, fiber)(
            ext, out, rstart, cstart,
            phase_ext=torch.tensor(window(phase, rstart, eh, cstart, ew)),
            dmap_ext=None if dmap is None else torch.tensor(
                window(dmap, rstart, eh, cstart, ew)))
        rows = slice(origin[0], origin[0] + 16)
        cols = slice(origin[1], origin[1] + 16) if two_d else slice(None)
        for kk in st:
            np.testing.assert_allclose(
                cuda_block.centre(out[kk], k, two_d).numpy(),
                st[kk][rows, cols].numpy(), err_msg=f"{kk} {origin}",
                **KERNEL_TOL)


def test_block_step_checks_the_maps():
    tm, _ = model_pair("br")
    step = cuda_block.make_block_step(tm, False)
    ext = interop.state_from_numpy(
        {kk: window(v, -5, 26, 0, W) for kk, v in seeded(tm, 1).items()},
        "cpu")
    out = {kk: torch.zeros_like(v) for kk, v in ext.items()}
    with pytest.raises(ValueError, match="phase"):
        step(ext, out, -5, 0, phase_ext=torch.ones(26, W - 1))
    with pytest.raises(ValueError, match="dmap"):
        step(ext, out, -5, 0, dmap_ext=torch.ones(26, W, dtype=torch.float64))


# -- the per-substep exchange's maps ------------------------------------------------------


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4x1", "2x2"])
def test_extend_phase_is_the_padded_map(shape):
    """extend_phase / extend_phase_2d: each shard's one-ring extension is
    its window of the REFLECT-padded map, as the reference's."""
    phase, _, _ = geometry("a")
    mesh = cpu_mesh(shape)
    blocks = shard_array(phase, mesh)
    ext = (halo.extend_phase_2d(blocks) if len(shape) == 2
           else halo.extend_phase(blocks))
    padded = np.pad(phase, 1, mode="reflect")
    n_rows, n_cols = mesh.grid
    h, w = H // n_rows, W // n_cols
    for i in range(mesh.size):
        r, c = divmod(i, n_cols)
        np.testing.assert_array_equal(
            ext.flat[i].numpy(),
            padded[r * h:(r + 1) * h + 2, c * w:(c + 1) * w + 2])


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4x1", "2x2"])
def test_halo_laplace_with_maps_equals_the_stencil(shape):
    phase, _, dmap = geometry("b")
    x = np.random.RandomState(5).uniform(-80, 20, (H, W)).astype(np.float32)
    mesh = cpu_mesh(shape)
    two_d = len(shape) == 2
    extend = halo.extend_phase_2d if two_d else halo.extend_phase
    pe, de = extend(shard_array(phase, mesh)), extend(shard_array(dmap, mesh))
    pots = shard_array(x, mesh)
    ring = halo.HaloExchange(pots, two_d, pe, de)
    n_cols = mesh.grid[1]
    laps = []
    for i in range(mesh.size):
        g = ring.geometry(*divmod(i, n_cols))
        laps.append(g.laplace(g.enforce_boundary(pots.flat[i])))
    got = gather_array(object_array(laps, mesh.devices.shape))
    want = stencil.laplace(
        stencil.enforce_boundary(torch.tensor(x)),
        phase_padded=torch.tensor(np.pad(phase, 1, "reflect")),
        dmap_padded=torch.tensor(np.pad(dmap, 1, "reflect")))
    np.testing.assert_array_equal(got, want.numpy())


# -- the sharded chunk and Simulation(mesh=...) ---------------------------------------------


def _unsharded(tm, st, n, phase, fiber, dmap):
    ref = interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(n)
    geom = bodies.GeometryMaps((H, W), phase, fiber, dmap).plain("cpu")
    for i in range(n):
        cuda_step.plain_step(tm, ref, probe, i, geom)
    return interop.state_to_numpy(ref), probe.numpy()


@pytest.mark.parametrize("kind", ["a", "b", "c"])
@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4x1", "2x2"])
@pytest.mark.parametrize("mode", ["ring", "wide", "wide_kernel"])
def test_spmd_chunk_with_geometry_matches_unsharded(mode, shape, kind):
    """Two outer steps of make_spmd_chunk with the geometry on a CPU mesh
    (the per-substep exchange, or the wide halo with the plain block step
    or the block kernel's plain version) against the unsharded plain steps
    under the same geometry; the fiber tensor needs the wide halo."""
    tm, _ = model_pair("br")
    phase, fiber, dmap = geometry(kind)
    mesh = cpu_mesh(shape)
    wide = mode != "ring"
    kw = dict(phase=phase, dmap=dmap, fiber=fiber, wide_halo=wide,
              use_kernel=mode == "wide_kernel")
    if fiber is not None and not wide:
        with pytest.raises(ValueError, match="wide_halo"):
            spmd.make_spmd_chunk(tm, mesh, 2, **kw)
        return
    st = seeded(tm, 8)
    chunk = spmd.make_spmd_chunk(tm, mesh, 2, **kw)
    state, probes = chunk(shard_state(st, mesh))
    got = gather_state(state)
    want, wprobe = _unsharded(tm, st, 2, phase, fiber, dmap)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **KERNEL_TOL)
    np.testing.assert_allclose(probes["v"].numpy(), wprobe, **KERNEL_TOL)


def test_spmd_chunk_maps_built_once():
    """The shards' maps are extended once (shard_maps) and reused by every
    chunk built from them; phase/dmap beside maps, or maps of the other
    schedule, raise."""
    tm, _ = model_pair("br")
    phase, fiber, dmap = geometry("c")
    mesh = cpu_mesh((2, 2))
    maps = spmd.shard_maps(tm, mesh, phase, dmap, wide_halo=True)
    assert maps.phase.shape == (2, 2) and maps.phase.flat[0].shape == (34, 34)
    np.testing.assert_array_equal(maps.phase.flat[3].numpy(),
                                  window(phase, 19, 34, 19, 34))
    st = seeded(tm, 9)
    a, _ = spmd.make_spmd_chunk(tm, mesh, 1, fiber=fiber, wide_halo=True,
                                maps=maps)(shard_state(st, mesh))
    b, _ = spmd.make_spmd_chunk(tm, mesh, 1, phase=phase, dmap=dmap,
                                fiber=fiber, wide_halo=True)(
        shard_state(st, mesh))
    for k in st:
        np.testing.assert_array_equal(gather_state(a)[k], gather_state(b)[k])
    with pytest.raises(ValueError, match="not both"):
        spmd.make_spmd_chunk(tm, mesh, 1, phase=phase, wide_halo=True,
                             maps=maps)
    with pytest.raises(ValueError, match="other comm"):
        spmd.make_spmd_chunk(tm, mesh, 1, wide_halo=False, maps=maps)
    with pytest.raises(ValueError, match="map of shape"):
        spmd.shard_maps(tm, mesh, np.ones((8, 8)))


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4x1", "2x2"])
def test_spmd_chunk_with_geometry_matches_jax_chunk(shape):
    """The wide-halo chunk with a hole, fibrosis and fibers against the
    JAX make_spmd_chunk (XLA block step) on its virtual CPU devices, two
    outer steps."""
    tm, jm = model_pair("br")
    phase, fiber, dmap = geometry("c")
    jmesh = jax_mesh(shape)
    st = seeded(tm, 10)
    jchunk = jspmd.make_spmd_chunk(jm, jmesh, length=2, phase=phase,
                                   dmap=dmap, wide_halo=True, fiber=fiber)
    jstate, jprobes = jchunk(jsharding.shard_state(st, jmesh))
    mesh = cpu_mesh(shape)
    state, probes = spmd.make_spmd_chunk(
        tm, mesh, 2, phase=phase, dmap=dmap, fiber=fiber, wide_halo=True,
        use_kernel=True)(shard_state(st, mesh))
    got = gather_state(state)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(jstate[k]), err_msg=k,
                                   **KERNEL_TOL)
    # the JAX chunk's probe is phase-scaled; the port's chunk leaves that
    # to Simulation
    scale = float(phase[tm.probe_pixel])
    np.testing.assert_allclose(probes["v"].numpy() * np.float32(scale),
                               np.asarray(jprobes["v"]), rtol=1e-5,
                               atol=1e-5)


def _sim(mesh_shape, wide, kind, duration=10):
    c = SimConfig(width=W, height=H, dt=0.1, dt_per_plot=10, diff=0.809,
                  duration=duration, cheby=True, skip=True,
                  **(dict(fiber_angle=np.deg2rad(30.0), fiber_ratio=0.25)
                     if kind == "c" else {}))
    mesh = cpu_mesh(mesh_shape) if mesh_shape else None
    sim = Simulation(BeelerReuter(c), device="cpu", mesh=mesh,
                     wide_halo=wide)
    phase, _, dmap = geometry(kind)
    sim.phase = phase
    if dmap is not None:
        sim.set_diffusion_map(dmap)
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0)
    return sim, sim.simulate(schedule=[(5.0, "s2")])


@pytest.mark.parametrize("mesh_shape,wide,kind", [
    ((4,), False, "b"), ((4,), True, "c"), ((2, 2), True, "c"),
    ((2, 2), False, "a")], ids=["4x1-ring-b", "4x1-wide-c", "2x2-wide-c",
                                "2x2-ring-a"])
def test_sharded_simulation_with_geometry_matches_unsharded(mesh_shape, wide,
                                                            kind):
    """Simulation(mesh=...) with a hole, a map and fibers (and an S2) ends
    within a whole run's bound of the unsharded run, with the same
    phase-scaled probe to 1e-3."""
    sim, got = _sim(mesh_shape, wide, kind)
    assert sim._shard_maps is not None and sim._shard_maps.wide_halo == wide
    _, want = _sim(None, False, kind)
    v_atol = 1e-3 * (BeelerReuter.max_v - BeelerReuter.min_v)
    for k in want.state:
        tol = (dict(atol=v_atol, rtol=0) if k == "V"
               else dict(atol=0, rtol=1e-3) if k == "C"
               else dict(atol=1e-3, rtol=0))
        np.testing.assert_allclose(got.state[k], want.state[k], err_msg=k,
                                   **tol)
    np.testing.assert_allclose(got.probes["v"], want.probes["v"], rtol=0,
                               atol=1e-3)


def test_fiber_on_a_mesh_needs_wide_halo():
    c = SimConfig(width=W, height=H, dt=0.1, diff=0.809, duration=1,
                  fiber_angle=0.5, fiber_ratio=0.5)
    with pytest.raises(ValueError, match="wide_halo"):
        Simulation(BeelerReuter(c), device="cpu", mesh=cpu_mesh((4,)))
    Simulation(BeelerReuter(c), device="cpu", mesh=cpu_mesh((4,)),
               wide_halo=True)
