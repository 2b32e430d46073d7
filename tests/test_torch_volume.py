"""The port's 3D volume path held against fib_tf_tpu on the CPU: the 3D
operators, the plain versions of both volume kernels against the JAX
volume Pallas kernels (in interpret mode, as tests/test_volume.py runs
them), run_volume against the JAX run_volume(kernel='xla'), and the
routing against the JAX engine's `_use_volume_kernel`."""

import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.engine.volume as jvol
import fib_tf_tpu.models.beeler_reuter as jbr
import fib_tf_tpu.models.fenton as jfen
import fib_tf_tpu.models.mitchell_schaeffer as jms
import fib_tf_tpu_torch.models.beeler_reuter as tbr
import fib_tf_tpu_torch.models.fenton as tfen
import fib_tf_tpu_torch.models.mitchell_schaeffer as tms
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.ops import stencil3d as jst3
from fib_tf_tpu.ops.pallas_volume import (make_pallas_volume_step,
                                          make_tiled_volume_step)
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import VolumeEvent, run_volume, volume
from fib_tf_tpu_torch.ops import (cuda_step, cuda_volume, cuda_volume_block,
                                  cuda_volume_tiled, stencil3d)
from fib_tf_tpu_torch.parallel import make_mesh
from test_torch_fixtures import one_torch_thread  # noqa: F401


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


# the reference's own kernel-vs-XLA bound for volumes
# (tests/test_volume.py:319-344, 463-475)
VOLUME_TOL = dict(rtol=2e-5, atol=2e-5)
# whole-run bounds, as tests/test_torch_tiled.py:272-279: 1e-3 of the
# model's range for V, 1e-3 of [0, 1] for the gates, 1e-3 relative for Ca
V_ATOL = 1e-3 * (tbr.BeelerReuter.max_v - tbr.BeelerReuter.min_v)


def cfg(**kw):
    base = dict(width=24, height=16, dt=0.1, diff=0.809, duration=1,
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


def _volume(shape, seed):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


# -- the 3D operators ---------------------------------------------------------------


@pytest.mark.parametrize("dz_ratio", [1.0, 0.5])
@pytest.mark.parametrize("shape", [(3, 5, 7), (6, 12, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_laplace3d_matches_jax(shape, dz_ratio):
    x = _volume(shape, 1)
    want = np.asarray(jst3.laplace3d(jnp.asarray(x), dz_ratio=dz_ratio))
    got = stencil3d.laplace3d(torch.tensor(x), dz_ratio=dz_ratio).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 4, 5), (6, 12, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_enforce_boundary3d_matches_jax(shape):
    x = _volume(shape, 2)
    want = np.asarray(jst3.enforce_boundary3d(jnp.asarray(x)))
    got = stencil3d.enforce_boundary3d(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _clamp_laplace3d(v, dz_ratio):
    """The kernels' form: every stencil point reads V[clamp(z+dz),
    clamp(i+di), clamp(j+dj)], clamp(k) = min(max(k, 1), N-2)."""
    d, h, w = v.shape
    cz = np.clip(np.arange(-1, d + 1), 1, d - 2)
    ci = np.clip(np.arange(-1, h + 1), 1, h - 2)
    cj = np.clip(np.arange(-1, w + 1), 1, w - 2)
    p = v[np.ix_(cz, ci, cj)]
    c = p[1:-1, 1:-1, 1:-1]
    planar = (p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1] + p[1:-1, 1:-1, :-2]
              + p[1:-1, 1:-1, 2:]
              + 0.5 * (p[1:-1, :-2, :-2] + p[1:-1, 2:, :-2]
                       + p[1:-1, :-2, 2:] + p[1:-1, 2:, 2:])
              - 6.0 * c)
    return planar + (2.0 * dz_ratio) * ((p[:-2, 1:-1, 1:-1] - 2.0 * c)
                                        + p[2:, 1:-1, 1:-1])


@pytest.mark.parametrize("dz_ratio", [1.0, 0.5])
def test_clamp_index_identity_3d(dz_ratio):
    """The boundary rewrite composed with the Laplacian is the clamped
    stencil both volume kernels compute."""
    x = _volume((5, 9, 11), 3)
    t = torch.tensor(x)
    got = stencil3d.laplace3d(stencil3d.enforce_boundary3d(t),
                              dz_ratio=dz_ratio).numpy()
    np.testing.assert_allclose(got, _clamp_laplace3d(x, dz_ratio),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("loc,z0,z1", [("luq", 0, 3), ("ruq", 0, None),
                                       ("left", 2, 5), ("rlq", 1, 2)])
def test_pace_mask3d_matches_jax(loc, z0, z1):
    args = (6, 12, 16, loc, 30.0, -90.0, z0, z1)
    np.testing.assert_array_equal(stencil3d.pace_mask3d(*args),
                                  jst3.pace_mask3d(*args))


def test_unported_3d_geometry_raises():
    from fib_tf_tpu_torch.models import volume_geometry
    x = torch.zeros(3, 4, 5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stencil3d.laplace3d(x, phase_padded=np.ones((6, 7)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stencil3d.laplace3d(x, fiber=(1.0, 0.0, 1.0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        volume_geometry(phase=np.ones((4, 5)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        volume_geometry(fiber=(1.0, 0.0, 1.0))


def test_volume_state_matches_jax():
    c = cfg()
    got = volume.volume_state(tbr.BeelerReuter(c), 4)
    want = jvol.volume_state(jbr.BeelerReuter(jax_cfg(c)), 4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- the plain volume steps against the JAX volume kernels ---------------------------


def test_z_uniform_volume_step_equals_2d_step():
    """A z-uniform volume is the 2D simulation, exactly (the z term is
    identically zero): tests/test_volume.py:126-146 for the port."""
    tm = tbr.BeelerReuter(cfg(height=24, width=32))
    sheet = interop.state_from_numpy(tm.initial_state(), "cpu")
    vol = interop.state_from_numpy(volume.volume_state(tm, 4), "cpu")
    for _ in range(5):
        cuda_step.plain_step(tm, sheet)
        cuda_volume.plain_volume_step(tm, vol)
    for k in sheet:
        assert torch.equal(vol[k], sheet[k][None].expand_as(vol[k])), k


def test_plain_volume_step_matches_jax_volume_kernel():
    """BR cheby+skip, 4x16x24, dz_ratio=0.5, 2 outer steps: the plain
    version of the volume substep kernel against the JAX whole-volume
    kernel (flat layout, interpret mode)."""
    c = cfg()
    jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
    st = seeded_volume(tm, 4, seed=1)
    jstep = make_pallas_volume_step(jm, 4, dz_ratio=0.5, interpret=True)
    step = cuda_volume.make_volume_step(tm, 4, dz_ratio=0.5)
    want = {k: jnp.asarray(v) for k, v in st.items()}
    got = interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(2)
    pixel = cuda_volume.volume_probe_pixel(tm, 4)
    assert pixel == (2, 15, 12)
    for i in range(2):
        want = jstep(want)
        got = step(got, probe, i)
        ref = (float(want["V"][pixel]) - jm.min_v) / (jm.max_v - jm.min_v)
        assert abs(float(probe[i]) - ref) <= 2e-5
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **VOLUME_TOL)


@pytest.mark.parametrize("skip", [True, False])
def test_plain_tiled_volume_step_matches_jax_tiled_volume_kernel(skip):
    """4x64x128, tile_rows=32 (two row tiles), 2 outer steps: the plain
    version of the tiled volume kernel against the JAX row-tiled volume
    kernel (interpret mode)."""
    c = cfg(height=64, width=128, skip=skip)
    jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
    st = seeded_volume(tm, 4, seed=2)
    jstep = make_tiled_volume_step(jm, 4, 32, interpret=True)
    step = cuda_volume_tiled.make_tiled_volume_step(tm, 4)
    want = {k: jnp.asarray(v) for k, v in st.items()}
    got = interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(2)
    pixel = cuda_volume.volume_probe_pixel(tm, 4)
    for i in range(2):
        want = jstep(want)
        got = step(got, probe, i)
        ref = (float(want["V"][pixel]) - jm.min_v) / (jm.max_v - jm.min_v)
        assert abs(float(probe[i]) - ref) <= 2e-5
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **VOLUME_TOL)


def test_plain_tiled_volume_step_is_the_plain_volume_step():
    assert (cuda_volume_tiled.plain_tiled_volume_step
            is cuda_volume.plain_volume_step)


# -- run_volume against the JAX run_volume -------------------------------------------

RUN_CFG = cfg(height=48, width=64)
# a full-depth S2 over the probe pixel (2, 20, 32), which catches the
# event/probe order, and a half-depth one beside it
RUN_EVENTS = [dict(step=10, loc="ruq"), dict(step=25, loc="luq", z1=2)]


@pytest.fixture(scope="module")
def volume_runs():
    kw = dict(depth=5, n_outer=40, frames_every=15)
    want = jvol.run_volume(
        jbr.BeelerReuter(jax_cfg(RUN_CFG)), kernel="xla",
        events=[jvol.VolumeEvent(**e) for e in RUN_EVENTS], **kw)
    got = run_volume(tbr.BeelerReuter(RUN_CFG), device="cpu",
                     events=[VolumeEvent(**e) for e in RUN_EVENTS], **kw)
    return want, got


def test_run_volume_matches_jax_run_volume(volume_runs):
    (wf, wp, wfr), (gf, gp, gfr) = volume_runs
    assert set(gf) == set(wf)
    for k in wf:
        assert gf[k].shape == wf[k].shape == (5, 48, 64)
        tol = (dict(atol=V_ATOL, rtol=0) if k == "V"
               else dict(atol=0, rtol=1e-3) if k == "C"
               else dict(atol=1e-3, rtol=0))
        np.testing.assert_allclose(gf[k], wf[k], err_msg=k, **tol)
    assert gp.shape == wp.shape == (40,)
    np.testing.assert_allclose(gp, wp, atol=V_ATOL / 120.0, rtol=0)
    # the S2 over the probe pixel shows in the probe of its own step
    assert gp[10] == wp[10] == 1.0 and gp[9] < 0.5
    assert gfr.shape == wfr.shape == (3, 5, 48, 64)
    np.testing.assert_allclose(gfr, wfr, atol=V_ATOL / 120.0, rtol=0)


def test_run_volume_events_fire_after_their_step():
    """Without the events the same run differs at the S2 steps: the
    half-depth S2 holds max(V, 30 mV) on slices [0, 2) only."""
    tm = tbr.BeelerReuter(RUN_CFG)
    kw = dict(depth=5, device="cpu")
    plain, _, _ = run_volume(tm, n_outer=26, **kw)
    fired, _, _ = run_volume(tm, n_outer=26, events=[
        VolumeEvent(step=25, loc="luq", z1=2)], **kw)
    mask = volume.VolumeEvent(step=25, loc="luq", z1=2).resolve_mask(tm, 5)
    np.testing.assert_array_equal(fired["V"],
                                  np.maximum(plain["V"], mask))
    assert (fired["V"][:2, 1:24, 1:32] == 30.0).all()
    assert not (fired["V"][2:, 1:24, 1:32] == 30.0).any()


# -- routing against the JAX engine -----------------------------------------------------


def reference_volume_route(c, depth, kernel, monkeypatch):
    """The JAX volume kernel choice on a TPU, in the port's words."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    mode = jvol._use_volume_kernel(jbr.BeelerReuter(jax_cfg(c)), depth,
                                   None, kernel)
    return {None: "plain", "whole": "substep", "tiled": "tiled"}[mode]


MAIN = [(8, 128, 512), (8, 512, 512), (32, 128, 512)]


@pytest.mark.parametrize("kernel", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dhw", MAIN, ids=lambda s: "x".join(map(str, s)))
def test_volume_route_matches_reference(dhw, skip, kernel, monkeypatch):
    """At the reference's 32 MB cutover the port routes as the reference
    does: past it every depth takes the tiled kernel, 32x128x512 too,
    without a warning.  (The port's own cutover is the card's: see
    test_volume_route_main_configurations.)"""
    monkeypatch.setattr(volume, "VOLUME_KERNEL_STATE_MB_MAX",
                        jvol.VOLUME_KERNEL_STATE_MB_MAX)
    d, h, w = dhw
    c = cfg(height=h, width=w, skip=skip)
    want = reference_volume_route(c, d, kernel, monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = volume.volume_route(tbr.BeelerReuter(c), d, "cuda", kernel)
    assert got == want


def test_volume_route_main_configurations(monkeypatch):
    """8x128x512 (16 MB), 8x512x512 and 32x128x512 (64 MB) all route
    'substep' at the card's cutover, where the tiled kernel lost to the
    substep route; at the reference's 32 MB the 64 MB volumes route
    'tiled'.  The reference's own tiled reckoning at 8x512x512 is halo
    K=8, tile 64."""
    small = tbr.BeelerReuter(cfg(height=128, width=512))
    large = tbr.BeelerReuter(cfg(height=512, width=512))
    assert volume.volume_state_mb(small, 8) == 16.0
    assert volume.volume_state_mb(large, 8) == 64.0
    assert volume.volume_state_mb(small, 32) == 64.0
    for model, depth in ((small, 8), (large, 8), (small, 32)):
        assert volume.volume_route(model, depth, "cuda", "auto") == "substep"
    monkeypatch.setattr(volume, "VOLUME_KERNEL_STATE_MB_MAX", 32.0)
    assert volume.volume_route(small, 8, "cuda", "auto") == "substep"
    assert volume.volume_route(large, 8, "cuda", "auto") == "tiled"
    assert volume.volume_route(small, 32, "cuda", "auto") == "tiled"
    assert jvol.pick_volume_tile_rows(
        jbr.BeelerReuter(jax_cfg(cfg(height=512, width=512))), 8) == 64


@pytest.mark.parametrize("dhw,want,ours", [
    # exactly 32.0 MB: the reference's Mosaic cell cap (786,432 cells)
    # sends it to its tiled kernel; the port keeps it on the substep kernel
    ((8, 256, 512), "tiled", "substep"),
    # unaligned past the cutover: no Mosaic tile rows, so the reference
    # stays on XLA; the CUDA kernels take any shape
    ((8, 516, 500), "plain", "substep"),
    # past the reference's cutover: the card's keeps the substep kernel,
    # which beat the tiled kernel there (PERF.md section 6)
    ((8, 512, 512), "tiled", "substep"),
    ((32, 128, 512), "tiled", "substep"),
], ids=["8x256x512", "8x516x500", "8x512x512", "32x128x512"])
def test_volume_route_deliberate_differences(dhw, want, ours, monkeypatch):
    d, h, w = dhw
    c = cfg(height=h, width=w)
    assert reference_volume_route(c, d, "auto", monkeypatch) == want
    assert volume.volume_route(tbr.BeelerReuter(c), d, "cuda", "auto") == ours


def test_volume_route_on_the_cpu():
    big = tbr.BeelerReuter(cfg(height=512, width=512))
    assert volume.volume_route(big, 8, "cpu", "auto") == "plain"
    assert volume.volume_route(big, 8, "cpu", "xla") == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        volume.volume_route(big, 8, "cpu", "pallas")
    with pytest.raises(ValueError, match="kernel"):
        volume.volume_route(big, 8, "cuda", "triton")
    with pytest.raises(ValueError, match="CUDA"):
        run_volume(tbr.BeelerReuter(cfg()), 3, 1, kernel="pallas",
                   device="cpu")


def test_volume_cutover_equals_reference():
    """The reference's cutover is 32 MB; the port's is the card's: the
    tiled kernel won at no size measured, so none (see engine/volume.py
    VOLUME_KERNEL_STATE_MB_MAX)."""
    assert jvol.VOLUME_KERNEL_STATE_MB_MAX == 32.0
    assert volume.VOLUME_KERNEL_STATE_MB_MAX == math.inf


# -- run_volume's guards -----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(phase=np.ones((16, 24), np.float32)),
    dict(fiber_twist=2.1), dict(fiber_ratio=0.3), dict(fiber_elevation=0.2),
    dict(fiber_angle0=0.3),
    dict(mesh=object()),
    dict(wide_halo=True, mesh=make_mesh(devices=["cpu"]), rotor_probe=True),
    dict(halo_k=5, wide_halo=True, mesh=make_mesh(devices=["cpu"]),
         electrodes=[(-5.0, 8.0, 12.0)]),
    dict(electrodes=[(-5.0, 8.0, 12.0)]), dict(rotor_probe=True),
    dict(probe=lambda s: s["V"].mean()),
], ids=lambda kw: next(iter(kw)))
def test_unported_run_volume_arguments_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_volume(tbr.BeelerReuter(cfg()), 3, 1, device="cpu", **kw)


def test_guards_raise_as_reference():
    c = cfg()
    jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
    for args, kw in [((2, 1), {}),                        # depth < 3
                     ((3, 1), dict(fiber_ratio=0.0)),
                     ((3, 1), dict(dz_ratio=3.0))]:       # limit 0.0773
        with pytest.raises(ValueError) as ref:
            jvol.run_volume(jm, *args, kernel="xla", **kw)
        with pytest.raises(ValueError) as ours:
            run_volume(tm, *args, device="cpu", **kw)
        assert str(ours.value).split(";")[0] == str(ref.value).split(";")[0]
    # the guard is off for a z-uniform run that asks for it
    final, probes, frames = run_volume(tm, 3, 1, dz_ratio=3.0,
                                       allow_unstable_dt=True, device="cpu")
    assert probes.shape == (1,) and frames is None


def test_run_volume_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_volume(tbr.BeelerReuter(cfg()), 3, 1)


def test_non_finite_volume_raises():
    tm = tbr.BeelerReuter(cfg())
    st = volume.volume_state(tm, 3)
    st["V"][1, 5, 5] = np.nan
    with pytest.raises(FloatingPointError):
        run_volume(tm, 3, 1, state=st, device="cpu")


# -- the wrappers on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["substep", "tiled"])
def test_wrappers_route_cpu_tensors_to_plain_version(kind):
    tm = tbr.BeelerReuter(cfg(height=30, width=40, skip=kind == "tiled"))
    st = seeded_volume(tm, 3, seed=4)
    a = interop.state_from_numpy(st, "cpu")
    b = interop.state_from_numpy(st, "cpu")
    pa, pb = torch.zeros(2), torch.zeros(2)
    cuda_volume.KERNEL.reset_launches()
    cuda_volume_tiled.KERNEL.reset_launches()
    step = volume.make_route_step(tm, 3, kind, dz_ratio=0.5)
    for i in range(2):
        assert step(a, pa, i) is a
        cuda_volume.plain_volume_step(tm, b, pb, i, dz_ratio=0.5)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(pa, pb)
    assert cuda_volume.KERNEL.launches == {"slow": 0, "frozen": 0}
    assert cuda_volume_tiled.KERNEL.launches == 0


def test_volume_substep_routes_cpu_tensors_to_plain_version():
    tm = tbr.BeelerReuter(cfg())
    st = seeded_volume(tm, 4, seed=5)
    a = interop.state_from_numpy(st, "cpu")
    b = interop.state_from_numpy(st, "cpu")
    pa, pb = torch.zeros(1), torch.zeros(1)
    for slow in (True, False):
        cuda_volume.volume_substep(tm, a, slow, pa, 0, dz_ratio=0.5)
        cuda_volume.plain_volume_substep(tm, b, slow, pb, 0, dz_ratio=0.5)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(pa, pb)


@pytest.mark.parametrize("kind", ["substep", "tiled"])
@pytest.mark.parametrize("breakage", [
    "dtype", "shape", "depth", "contiguity", "missing", "device_mix"])
def test_wrappers_reject_bad_state(kind, breakage):
    tm = tbr.BeelerReuter(cfg())
    st = interop.state_from_numpy(volume.volume_state(tm, 4), "cpu")
    if breakage == "dtype":
        st["m"] = st["m"].double()
        err = TypeError
    elif breakage == "shape":
        st["h"] = st["h"][:, :-1]
        err = ValueError
    elif breakage == "depth":
        st["V"] = st["V"][:3]
        err = ValueError
    elif breakage == "contiguity":
        st["j"] = st["j"].transpose(1, 2).contiguous().transpose(1, 2)
        err = ValueError
    elif breakage == "missing":
        del st["C"]
        err = ValueError
    else:
        st["d"] = st["d"].to("meta")
        err = ValueError
    with pytest.raises(err):
        volume.make_route_step(tm, 4, kind)(st)


@pytest.mark.parametrize("kind", ["substep", "tiled"])
def test_wrappers_reject_bad_probe(kind):
    tm = tbr.BeelerReuter(cfg())
    step = volume.make_route_step(tm, 4, kind)
    st = interop.state_from_numpy(volume.volume_state(tm, 4), "cpu")
    with pytest.raises(IndexError):
        step(st, torch.zeros(2), 2)
    with pytest.raises(ValueError):
        step(st, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="depth"):
        cuda_volume.check_volume(tm, st, 2, None, 0)


# -- Fenton and Mitchell-Schaeffer volumes --------------------------------------------

# (JAX model, port model, the state's planes and their upper bounds); the
# kernel-vs-XLA bound of tests/test_pallas.py:90-97
SMALL_MODELS = {
    "fenton": (jfen.Fenton4v, tfen.Fenton4v,
               dict(u=1.0, v=1.0, w=1.0, s=0.6)),
    "ms": (jms.MitchellSchaeffer, tms.MitchellSchaeffer, dict(u=1.0, h=1.0)),
}
SMALL_TOL = dict(rtol=1e-3, atol=1e-5)


def small_models(name, **kw):
    jcls, tcls, _ = SMALL_MODELS[name]
    c = cfg(diff=1.5, **kw)
    return jcls(jax_cfg(c)), tcls(c)


def seeded_small_volume(name, model, depth, seed):
    """Every plane drawn per cell from a seed: no two slices are equal and
    every face differs from its neighbours."""
    rng = np.random.RandomState(seed)
    shape = (depth,) + tuple(model.state_shape())
    return {k: rng.uniform(0.0, hi, shape).astype(np.float32)
            for k, hi in SMALL_MODELS[name][2].items()}


@pytest.mark.parametrize("name", sorted(SMALL_MODELS))
def test_small_model_volume_step_matches_jax_volume_kernel(name):
    """4x16x128, dz_ratio=0.5, 2 outer steps of ten substeps: the plain
    version of the volume substep kernel against the JAX whole-volume
    kernel (flat layout, interpret mode)."""
    jm, tm = small_models(name, height=16, width=128)
    st = seeded_small_volume(name, tm, 4, seed=6)
    jstep = make_pallas_volume_step(jm, 4, dz_ratio=0.5, interpret=True)
    step = cuda_volume.make_volume_step(tm, 4, dz_ratio=0.5)
    want = {k: jnp.asarray(v) for k, v in st.items()}
    got = interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(2)
    pixel = cuda_volume.volume_probe_pixel(tm, 4)
    for i in range(2):
        want = jstep(want)
        got = step(got, probe, i)
        assert abs(float(probe[i]) - float(want["u"][pixel])) <= 1e-5
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **SMALL_TOL)


@pytest.mark.parametrize("name", sorted(SMALL_MODELS))
def test_small_model_run_volume_matches_jax_run_volume(name):
    """5x24x32 at examples/scroll_wave.py's dt 0.05 (the 3D limit at diff
    1.5 is 0.083), 25 outer steps with a half-depth S2 at step 12:
    run_volume on the CPU against the JAX run_volume(kernel='xla')."""
    jm, tm = small_models(name, height=24, width=32, dt=0.05)
    kw = dict(depth=5, n_outer=25)
    event = dict(step=12, loc="luq", z1=2)
    want = jvol.run_volume(jm, kernel="xla",
                           events=[jvol.VolumeEvent(**event)], **kw)
    got = run_volume(tm, device="cpu", events=[VolumeEvent(**event)], **kw)
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], err_msg=k,
                                   atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", sorted(SMALL_MODELS))
def test_small_model_volume_routes(name, monkeypatch):
    """run_volume takes the volume substep kernel for Fenton and
    Mitchell-Schaeffer at any size (the reference's whole-volume kernel,
    engine/volume.py:182); the tiled volume kernel hosts BR's main body
    alone, so where it would run these models they raise (ROADMAP Queue 2
    item D); the volume block kernel hosts every body, and the plain
    sharded step runs them."""
    _, tm = small_models(name, height=512, width=512)
    assert volume.volume_state_mb(tm, 32) >= 64.0
    assert volume.volume_route(tm, 32, "cuda", "auto") == "substep"
    assert volume.volume_route(tm, 32, "cuda", "pallas") == "substep"
    assert volume.volume_route(tm, 32, "cpu", "auto") == "plain"
    monkeypatch.setattr(volume, "VOLUME_KERNEL_STATE_MB_MAX", 32.0)
    with pytest.raises(NotImplementedError, match="Queue 2 item D"):
        volume.volume_route(tm, 32, "cuda", "auto")
    with pytest.raises(NotImplementedError, match="Queue 2 item D"):
        cuda_volume_tiled.make_tiled_volume_step(tm, 32)
    assert callable(cuda_volume_block.make_volume_block_step(tm, 28, 32))

    _, small = small_models(name, height=8, width=12, dt=0.05)
    st = seeded_small_volume(name, small, 20, seed=7)
    mesh = make_mesh(devices=["cpu"] * 2)
    sharded = run_volume(small, 20, 2, state=st, mesh=mesh, wide_halo=True,
                         device="cpu")
    whole = run_volume(small, 20, 2, state=st, device="cpu")
    for k in whole[0]:
        np.testing.assert_allclose(sharded[0][k], whole[0][k], err_msg=k,
                                   rtol=1e-6, atol=1e-6)
