"""The port's z-sharded wide-halo volume path held against fib_tf_tpu on
the CPU: the plain z-block step against the JAX per-shard volume block
kernel (in interpret mode), and `run_volume(mesh=, wide_halo=True)` against
the JAX one on the virtual CPU devices (tests/test_volume.py) and against
the port's own unsharded `run_volume`.  The port runs on meshes of CPU
entries, `make_mesh(devices=['cpu'] * 4)`.

Tolerance: rtol 1e-3 / atol 1e-5 on all 8 planes over two groups of
substeps (tests/test_pallas.py:90-97); observed here: at most 1.6e-5 (V, in
mV) against the JAX volume block kernel."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.engine.volume as jvol
import fib_tf_tpu.models.beeler_reuter as jbr
import fib_tf_tpu.parallel.volume_spmd as jvspmd
import fib_tf_tpu_torch.models.beeler_reuter as tbr
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.ops.pallas_volume import make_volume_block_kernel
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import VolumeEvent, run_volume, volume
from fib_tf_tpu_torch.ops import cuda_volume, cuda_volume_block
from fib_tf_tpu_torch.parallel import (gather_state, make_mesh, shard_state,
                                       volume_spmd)
from test_torch_fixtures import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=1e-5)
V_ATOL = 1e-3 * (tbr.BeelerReuter.max_v - tbr.BeelerReuter.min_v)
H, W = 16, 24


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


def cfg(**kw):
    base = dict(width=W, height=H, dt=0.05, diff=0.809, duration=1,
                cheby=True, skip=True)
    base.update(kw)
    return SimConfig(**base)


def seeded_volume(model, depth, seed=0):
    """The extruded initial state (with its S1 slab), perturbed per cell
    from a seed, so that no two slices are equal."""
    rng = np.random.RandomState(seed)
    st = volume.volume_state(model, depth)
    shape = st["V"].shape
    st["V"] = st["V"] + rng.normal(0, 2.0, shape).astype(np.float32)
    for g in tbr.GATES:
        st[g] = np.clip(st[g] * rng.uniform(0.9, 1.1, shape),
                        1e-5, 0.99999).astype(np.float32)
    st["C"] = (st["C"] * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
    return st


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def jax_mesh(n):
    from jax.sharding import Mesh

    if len(jax.devices()) < n:
        pytest.skip("needs the virtual CPU devices of tests/conftest.py")
    return Mesh(np.array(jax.devices()[:n]), ("z",))


# -- the plain z-block step against the JAX volume block kernel ------------------------

D_TOTAL, D_LOCAL = 18, 6


@functools.lru_cache(maxsize=None)
def _jax_volume_block_kernel(skip, dz_ratio, substeps):
    jm = jbr.BeelerReuter(jax_cfg(cfg(skip=skip)))
    k = 5 if substeps is None else substeps
    return make_volume_block_kernel(jm, D_LOCAL + 2 * k, D_TOTAL,
                                    dz_ratio=dz_ratio, interpret=True,
                                    substeps=substeps)


@pytest.mark.parametrize("skip,substeps", [(True, None), (False, 1)],
                         ids=["skip", "noskip-substeps1"])
@pytest.mark.parametrize("dz_ratio", [1.0, 0.5])
@pytest.mark.parametrize("z0", [0, 6, 12], ids=["top", "interior", "bottom"])
def test_plain_zblock_step_matches_jax_volume_block_kernel(z0, dz_ratio,
                                                           skip, substeps):
    """One shard's z-extended block over two groups (two outer steps under
    skip; two single substeps without), its ghosts taken from the unsharded
    volume each time: the plain z-block step against the JAX Pallas volume
    block kernel (flat layout, interpret mode) and the unsharded step."""
    tm = tbr.BeelerReuter(cfg(skip=skip))
    k = 5 if substeps is None else substeps
    ext_d = D_LOCAL + 2 * k
    zstart = z0 - k
    kern = _jax_volume_block_kernel(skip, dz_ratio, substeps)
    # the flat layout's index planes (volume_spmd.py:193-204)
    rrow = jnp.asarray(np.tile(np.arange(H, dtype=np.int32), ext_d)
                       .reshape(ext_d * H, 1))
    zidx = jnp.asarray(zstart + np.repeat(np.arange(ext_d, dtype=np.int32),
                                          H).reshape(ext_d * H, 1))
    full = seeded_volume(tm, D_TOTAL, seed=2)
    step = cuda_volume_block.make_volume_block_step(tm, ext_d, D_TOTAL,
                                                    dz_ratio, substeps)
    worst = 0.0
    for _ in range(2):
        zs = np.arange(zstart, zstart + ext_d) % D_TOTAL
        ext = {key: np.ascontiguousarray(v[zs]) for key, v in full.items()}
        want = kern({key: jnp.asarray(v) for key, v in ext.items()}, rrow,
                    zidx)
        block = interop.state_from_numpy(ext, "cpu")
        got, _ = step(block, torch.empty_like(block["V"]), zstart)
        ref = interop.state_from_numpy(full, "cpu")
        if substeps is None:
            cuda_volume.plain_volume_step(tm, ref, dz_ratio=dz_ratio)
        else:
            cuda_volume.plain_volume_substep(tm, ref, True,
                                             dz_ratio=dz_ratio)
        full = interop.state_to_numpy(ref)
        for key in full:
            centre = got[key][k:-k].numpy()
            np.testing.assert_allclose(
                centre, np.asarray(want[key])[k:-k], err_msg=key, **TOL)
            np.testing.assert_allclose(
                centre, full[key][z0:z0 + D_LOCAL], err_msg=key, **TOL)
            worst = max(worst, np.abs(centre - np.asarray(want[key])[k:-k])
                        .max())
    assert worst <= 1e-4
    assert cuda_volume_block.KERNEL.launches == {"slow": 0, "frozen": 0}


def test_zblock_geometry_equals_the_volume_geometry_on_a_whole_volume():
    from fib_tf_tpu_torch.ops import stencil3d
    x = torch.tensor(np.random.RandomState(3).normal(size=(5, 6, 7))
                     .astype(np.float32))
    g = cuda_volume_block.zblock_geometry(
        cuda_volume_block.global_slices(0, 5, "cpu"), 5, dz_ratio=0.5)
    torch.testing.assert_close(g.enforce_boundary(x),
                               stencil3d.enforce_boundary3d(x), rtol=0,
                               atol=0)
    torch.testing.assert_close(g.laplace(x),
                               stencil3d.laplace3d(x, dz_ratio=0.5),
                               rtol=1e-6, atol=1e-5)


def test_block_step_probe_and_window_checks():
    tm = tbr.BeelerReuter(cfg())
    full = seeded_volume(tm, D_TOTAL, seed=4)
    step = cuda_volume_block.make_volume_block_step(tm, 16, D_TOTAL)
    zs = np.arange(1, 17)
    block = interop.state_from_numpy(
        {k: np.ascontiguousarray(v[zs]) for k, v in full.items()}, "cpu")
    probe = torch.zeros(1)
    step(block, torch.empty(16, H, W), 1, probe, 0, 8)   # global slice 9
    ref = interop.state_from_numpy(full, "cpu")
    want = torch.zeros(1)
    cuda_volume.plain_volume_step(tm, ref, want, 0)
    assert abs(float(probe[0]) - float(want[0])) <= 1e-5
    with pytest.raises(ValueError, match="probe pixel"):
        step(block, torch.empty(16, H, W), 1, probe, 0, 2)    # a ghost
    with pytest.raises(ValueError, match="window"):
        step(block, torch.empty(16, H, W), 9)
    with pytest.raises(ValueError, match="no centre"):
        cuda_volume_block.make_volume_block_step(tm, 10, D_TOTAL)
    with pytest.raises(ValueError, match="uniform substeps"):
        cuda_volume_block.make_volume_block_step(tm, 8, D_TOTAL, substeps=1)


def test_model_substep_groups_match_reference():
    for skip in (True, False):
        c = cfg(skip=skip)
        jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
        assert tm.has_uniform_substeps == jm.has_uniform_substeps == (
            not skip)
    tm = tbr.BeelerReuter(cfg(skip=False))
    from fib_tf_tpu_torch.models.base import volume_geometry
    st = seeded_volume(tm, 4, seed=5)
    a = tm.substep_group(interop.state_from_numpy(st, "cpu"),
                         volume_geometry(), 5)
    b = tm.step(interop.state_from_numpy(st, "cpu"), volume_geometry())
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


# -- run_volume(mesh=, wide_halo=True) ------------------------------------------------------

DEPTH, N_OUTER = 20, 6
# an S2 over the lower slices of two shards, fired over the probe pixel
EVENTS = dict(step=2, loc="bottom", z1=12)


@functools.lru_cache(maxsize=None)
def _jax_sharded_volume(skip, halo_k):
    jm = jbr.BeelerReuter(jax_cfg(cfg(skip=skip)))
    final, probes, _ = jvol.run_volume(
        jm, DEPTH, N_OUTER, state=seeded_volume(tbr.BeelerReuter(cfg()),
                                                DEPTH, seed=6),
        dz_ratio=0.5, events=[jvol.VolumeEvent(**EVENTS)],
        mesh=jax_mesh(4), wide_halo=True, halo_k=halo_k, kernel="xla")
    return final, np.asarray(probes)


@pytest.mark.parametrize("kernel", ["auto", "xla"])
@pytest.mark.parametrize("skip,halo_k", [(True, None), (True, 5),
                                         (False, None), (False, 1)])
def test_sharded_run_volume_matches_jax_and_unsharded(skip, halo_k, kernel):
    """20x16x24 on four z shards for 6 outer steps with an S2 at step 2:
    against the JAX `run_volume(mesh=, wide_halo=True)` and the port's
    unsharded run; `halo_k=1` (no-skip) runs five exchanges and five
    one-substep groups per outer step and must equal `halo_k=5`."""
    tm = tbr.BeelerReuter(cfg(skip=skip))
    st = seeded_volume(tbr.BeelerReuter(cfg()), DEPTH, seed=6)
    kw = dict(state=st, dz_ratio=0.5, events=[VolumeEvent(**EVENTS)])
    final, probes, frames = run_volume(
        tm, DEPTH, N_OUTER, mesh=cpu_mesh(4), wide_halo=True, halo_k=halo_k,
        kernel=kernel, **kw)
    ref_final, ref_probes, _ = run_volume(tm, DEPTH, N_OUTER, device="cpu",
                                          **kw)
    want_final, want_probes = _jax_sharded_volume(skip, halo_k)
    assert frames is None and probes.shape == (N_OUTER,)
    assert final["V"].shape == (DEPTH, H, W)
    for key in ref_final:
        np.testing.assert_allclose(final[key], ref_final[key], err_msg=key,
                                   **TOL)
        tol = (dict(atol=V_ATOL, rtol=0) if key == "V"
               else dict(atol=0, rtol=1e-3) if key == "C"
               else dict(atol=1e-3, rtol=0))
        np.testing.assert_allclose(final[key], want_final[key],
                                   err_msg=key, **tol)
    np.testing.assert_allclose(probes, ref_probes, atol=1e-5)
    np.testing.assert_allclose(probes, want_probes, atol=V_ATOL / 120.0)
    assert probes[2] == 1.0           # the event fired over the probe
    if halo_k == 1:
        same, _, _ = run_volume(tm, DEPTH, N_OUTER, mesh=cpu_mesh(4),
                                wide_halo=True, halo_k=5, kernel=kernel,
                                **kw)
        for key in same:
            np.testing.assert_allclose(final[key], same[key], err_msg=key,
                                       **TOL)


def test_sharded_run_volume_frames():
    tm = tbr.BeelerReuter(cfg())
    ev = [VolumeEvent(step=3, loc="luq", z1=10)]
    a = run_volume(tm, DEPTH, 5, events=ev, frames_every=2, device="cpu")
    b = run_volume(tm, DEPTH, 5, events=ev, frames_every=2,
                   mesh=cpu_mesh(4), wide_halo=True)
    assert b[2].shape == (3, DEPTH, H, W)
    np.testing.assert_allclose(b[2], a[2], atol=1e-5)
    np.testing.assert_allclose(b[1], a[1], atol=1e-5)


def test_volume_chunk_keeps_its_input_and_takes_sharded_state():
    tm = tbr.BeelerReuter(cfg())
    st = seeded_volume(tm, DEPTH, seed=7)
    mesh = cpu_mesh(4)
    sharded = shard_state(st, mesh)
    assert tuple(sharded["V"][1].shape) == (5, H, W)
    chunk = volume_spmd.make_volume_spmd_chunk(tm, mesh, 2, DEPTH,
                                               use_kernel=True)
    out, probes = chunk(sharded)
    np.testing.assert_array_equal(gather_state(sharded)["V"], st["V"])
    assert probes["v"].shape == (2,)
    again, _ = chunk(out)                      # chunks chain
    ref = interop.state_from_numpy(st, "cpu")
    for _ in range(4):
        cuda_volume.plain_volume_step(tm, ref)
    np.testing.assert_allclose(gather_state(again)["V"], ref["V"].numpy(),
                               **TOL)


# -- the refusals -------------------------------------------------------------------------------


def test_volume_shard_checks_raise_as_reference():
    for args in ((16, 4, 5), (18, 4, 5)):
        with pytest.raises(ValueError) as ref:
            jvspmd.check_volume_shards(*args)
        with pytest.raises(ValueError) as ours:
            volume_spmd.check_volume_shards(*args)
        assert str(ours.value) == str(ref.value)
    tm = tbr.BeelerReuter(cfg())
    with pytest.raises(ValueError, match="z-slices per shard"):
        run_volume(tm, 16, 1, mesh=cpu_mesh(4), wide_halo=True)
    with pytest.raises(ValueError, match="not divisible"):
        run_volume(tm, 22, 1, mesh=cpu_mesh(4), wide_halo=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        run_volume(tm, 20, 1, wide_halo=True, device="cpu")
    with pytest.raises(ValueError, match="1D"):
        run_volume(tm, 20, 1, wide_halo=True,
                   mesh=make_mesh(shape=(2, 2), devices=["cpu"] * 4))


def test_halo_k_refusals():
    skip, noskip = (tbr.BeelerReuter(cfg(skip=s)) for s in (True, False))
    jskip = jbr.BeelerReuter(jax_cfg(cfg(skip=True)))
    with pytest.raises(ValueError, match="uniform substeps"):
        run_volume(skip, 20, 1, mesh=cpu_mesh(4), wide_halo=True, halo_k=1)
    with pytest.raises(ValueError, match="uniform substeps"):
        jvspmd.resolve_halo_k(jskip, 1)
    with pytest.raises(ValueError, match="must divide"):
        volume_spmd.resolve_halo_k(noskip, 2)
    with pytest.raises(ValueError, match=r"halo_k must be in \[1"):
        volume_spmd.resolve_halo_k(noskip, 6)
    assert volume_spmd.resolve_halo_k(skip, None) == 5
    assert volume_spmd.resolve_halo_k(skip, 5) == 5
    assert volume_spmd.resolve_halo_k(noskip, 1) == 1
    with pytest.raises(ValueError, match="wide_halo=True"):
        run_volume(noskip, 20, 1, halo_k=1, device="cpu")


def test_shard_kernel_choice():
    tm = tbr.BeelerReuter(cfg())
    assert volume._use_shard_kernel(tm, "cuda", "auto")
    assert volume._use_shard_kernel(tm, "cuda", "pallas")
    assert not volume._use_shard_kernel(tm, "cuda", "xla")
    assert not volume._use_shard_kernel(tm, "cpu", "auto")
    with pytest.raises(ValueError, match="CUDA"):
        run_volume(tm, 20, 1, mesh=cpu_mesh(4), wide_halo=True,
                   kernel="pallas")
    with pytest.raises(ValueError, match="auto|pallas|xla"):
        run_volume(tm, 20, 1, mesh=cpu_mesh(4), wide_halo=True,
                   kernel="mosaic")


def test_mesh_without_wide_halo_raises():
    with pytest.raises(NotImplementedError, match="GSPMD.*ROADMAP"):
        run_volume(tbr.BeelerReuter(cfg()), 20, 1, mesh=cpu_mesh(4))


@pytest.mark.parametrize("kw", [
    dict(phase=np.ones((H, W), np.float32)), dict(fiber=(1.0, 0.0, 1.0)),
    dict(rotor=True), dict(ecg_weights=np.ones((1, DEPTH, H, W))),
], ids=lambda kw: next(iter(kw)))
def test_unported_volume_spmd_arguments_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        volume_spmd.make_volume_spmd_chunk(tbr.BeelerReuter(cfg()),
                                           cpu_mesh(4), 1, DEPTH, **kw)


def test_sharded_run_volume_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        run_volume(tbr.BeelerReuter(cfg()), 20, 1, mesh=make_mesh(),
                   wide_halo=True)
