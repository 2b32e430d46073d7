"""The port's 2D geometry held against fib_tf_tpu on the CPU: the phase
field, the relative diffusion map and the fiber tensor, from the stencil
operators and the host-side builders through `grid_geometry`'s model steps
and the kernels' plain versions (kernel 1's and kernel 2's against the JAX
Pallas kernels in interpret mode, as tests/test_pallas.py runs them) to
`Simulation` with a hole, a diffusion map and fibers.

The geometries: (a) examples/br_spiral.py's hole plus a `neg=True` rim, so
that phi is not 1 at the domain's border; (b) (a) plus
`fibrosis_map(density=0.25, strength=0.8, seed=0)`; (c) (b) plus fibers at
30 degrees, ratio 0.25.

Tolerances: single operators rtol 1e-5 (float32 sums in one order; atol
1e-5 where values cancel to zero); a model step under `grid_geometry`
against the JAX model's step rtol 1e-5 / atol 1e-5 (the same elementwise
arithmetic); kernel plain versions against the JAX Pallas kernels rtol
1e-3 / atol 1e-5, the JAX package's kernel-vs-XLA bound
(tests/test_pallas.py); whole runs 1e-3 of the model's range
(tests/test_golden.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.base as jbase
import fib_tf_tpu.ops.stencil as jstencil
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.engine import Simulation as JaxSimulation
from fib_tf_tpu.models import BeelerReuter as JaxBR
from fib_tf_tpu.models import Fenton4v as JaxFenton
from fib_tf_tpu.models import MitchellSchaeffer as JaxMS
from fib_tf_tpu.ops.pallas_step import make_pallas_step
from fib_tf_tpu.ops.pallas_tiled import make_tiled_pallas_step
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation
from fib_tf_tpu_torch.models import (BeelerReuter, Fenton4v,
                                     MitchellSchaeffer, grid_geometry)
from fib_tf_tpu_torch.models.base import tissue_geometry
from fib_tf_tpu_torch.ops import bodies, cuda_step, cuda_tiled, stencil
from test_torch_fixtures import one_torch_thread  # noqa: F401

OP_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-3, atol=1e-5)
H, W = 48, 64


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


def field(shape, seed, lo=-80.0, hi=20.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def geometry(kind, h=H, w=W):
    """(phase, fiber, dmap) of geometry `kind` ('a', 'b' or 'c') on an h x w
    grid, built with the reference's builders."""
    phase = jstencil.add_hole_to_phase_field(
        None, h, w, w * 150 // 512, h * 200 // 512, max(w * 40 // 512, 4))
    phase = jstencil.add_hole_to_phase_field(phase, h, w, w / 2, h / 2,
                                             min(h, w) / 2 + 10, neg=True)
    dmap = (jstencil.fibrosis_map(h, w, density=0.25, strength=0.8, seed=0)
            if kind in "bc" else None)
    fiber = (jstencil.fiber_tensor(np.deg2rad(30.0), 0.25) if kind == "c"
             else None)
    return phase, fiber, dmap


def pad(a):
    return np.pad(a, 1, mode="reflect")


def t(a):
    return None if a is None else torch.tensor(a)


def j(a):
    return None if a is None else jnp.asarray(a)


# -- the stencil operators ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["phase", "phase_padded", "dmap",
                                  "phase+dmap", "none"])
def test_laplace_forms_match_jax(kind):
    x = field((H, W), 1)
    phase, _, _ = geometry("a")
    dmap = jstencil.fibrosis_map(H, W, seed=3)
    kw_t, kw_j = {}, {}
    if kind == "phase":
        kw_t["phase"], kw_j["phase"] = t(phase), j(phase)
    if kind in ("phase_padded", "phase+dmap"):
        kw_t["phase_padded"] = t(pad(phase))
        kw_j["phase_padded"] = j(pad(phase))
    if kind in ("dmap", "phase+dmap"):
        kw_t["dmap_padded"], kw_j["dmap_padded"] = t(pad(dmap)), j(pad(dmap))
    got = stencil.laplace(torch.tensor(x), **kw_t).numpy()
    want = np.asarray(jstencil.laplace(jnp.asarray(x), **kw_j))
    np.testing.assert_allclose(got, want, **OP_TOL)


@pytest.mark.parametrize("with_phase", [False, True])
@pytest.mark.parametrize("with_dmap", [False, True])
@pytest.mark.parametrize("angle", [0.0, 0.5, 1.2])
def test_anisotropic_laplace_matches_jax(angle, with_dmap, with_phase):
    x = field((H, W), 2)
    phase, _, _ = geometry("a")
    dmap = jstencil.fibrosis_map(H, W, seed=4)
    dxx, dxy, dyy = jstencil.fiber_tensor(angle, 0.25)
    pp = pad(phase) if with_phase else None
    dp = pad(dmap) if with_dmap else None
    got = stencil.anisotropic_laplace(torch.tensor(x), dxx, dxy, dyy,
                                      phase_padded=t(pp),
                                      dmap_padded=t(dp)).numpy()
    want = np.asarray(jstencil.anisotropic_laplace(
        jnp.asarray(x), dxx, dxy, dyy, phase_padded=j(pp), dmap_padded=j(dp)))
    np.testing.assert_allclose(got, want, **OP_TOL)


def test_corrections_match_jax():
    xp = pad(field((H, W), 3))
    phase, _, _ = geometry("a")
    pp = pad(phase)
    q = pp * pad(jstencil.fibrosis_map(H, W, seed=5))
    dxx, dxy, dyy = jstencil.fiber_tensor(0.7, 0.3)
    pairs = [
        (stencil.phase_field_correction(t(xp), t(pp)),
         jstencil.phase_field_correction(j(xp), j(pp))),
        (stencil.anisotropic_phase_correction(t(xp), t(pp), dxx, dxy, dyy),
         jstencil.anisotropic_phase_correction(j(xp), j(pp), dxx, dxy, dyy)),
        (stencil.conduction_correction(t(xp), t(q), t(phase)),
         jstencil.conduction_correction(j(xp), j(q), j(phase))),
        (stencil.conduction_correction(t(xp), t(q), 1.0),
         jstencil.conduction_correction(j(xp), j(q), 1.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("angle", [0.0, 0.3, np.pi / 6, 1.2, np.pi / 2])
@pytest.mark.parametrize("ratio", [0.1, 0.25, 1.0])
def test_fiber_tensor_is_the_reference(angle, ratio):
    assert stencil.fiber_tensor(angle, ratio) == jstencil.fiber_tensor(
        angle, ratio)


# -- the host-side builders, bit for bit -----------------------------------------------


@pytest.mark.parametrize("args", [
    (None, 32, 48, 20.0, 10.0, 5.0, False),
    (None, 32, 48, 24.0, 16.0, 26.0, True),
    (None, 512, 512, 150, 200, 40, False),
    (None, 67, 131, 65.5, 33.5, 43.5, True),
], ids=["hole", "rim", "br_spiral", "ragged_rim"])
def test_add_hole_to_phase_field_is_bit_equal(args):
    got = stencil.add_hole_to_phase_field(*args)
    want = jstencil.add_hole_to_phase_field(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # chained: a rim on top of the hole
    h, w = args[1], args[2]
    got2 = stencil.add_hole_to_phase_field(got, h, w, w / 2, h / 2, h / 3,
                                           neg=True)
    want2 = jstencil.add_hole_to_phase_field(want, h, w, w / 2, h / 2,
                                             h / 3, neg=True)
    np.testing.assert_array_equal(got2, want2)


@pytest.mark.parametrize("kw", [
    dict(), dict(density=0.25, strength=0.8, seed=0),
    dict(density=0.5, strength=0.3, seed=7, patch=3),
    dict(density=0.0), dict(density=1.0, strength=0.6),
    dict(strength=0.0), dict(density=0.25, strength=1.0, seed=2),
])
@pytest.mark.parametrize("shape", [(64, 64), (67, 131), (2048, 2048)])
def test_fibrosis_map_is_bit_equal(shape, kw):
    got = stencil.fibrosis_map(*shape, **kw)
    want = jstencil.fibrosis_map(*shape, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(density=-0.1), dict(density=1.5),
                                dict(strength=-0.5), dict(strength=2.0)])
def test_fibrosis_map_refusals_match(kw):
    with pytest.raises(ValueError) as ref:
        jstencil.fibrosis_map(8, 8, **kw)
    with pytest.raises(ValueError) as ours:
        stencil.fibrosis_map(8, 8, **kw)
    assert str(ours.value) == str(ref.value)


# -- grid_geometry: the model steps -------------------------------------------------------

MODELS = {
    "br": (BeelerReuter, JaxBR, dict(diff=0.809, cheby=True, skip=True)),
    "fenton": (Fenton4v, JaxFenton, dict(diff=1.5)),
    "ms": (MitchellSchaeffer, JaxMS, dict(diff=1.5)),
}


def model_pair(name, h=H, w=W, **kw):
    tcls, jcls, base = MODELS[name]
    c = SimConfig(width=w, height=h, duration=1, **{"dt": 0.1, **base, **kw})
    return tcls(c), jcls(jax_cfg(c))


def seeded(model, seed):
    """The model's initial state, its potential perturbed per cell from a
    seed (BR by N(0, 2) mV, the others by U(0, 0.05))."""
    rng = np.random.RandomState(seed)
    st = model.initial_state()
    shape = model.state_shape()
    key = model.pot_key
    if key == "V":
        st[key] = st[key] + rng.normal(0, 2.0, shape).astype(np.float32)
    else:
        st[key] = st[key] + rng.uniform(0, 0.05, shape).astype(np.float32)
    return st


def jax_geometry(phase, fiber, dmap):
    """The JAX grid_geometry of a (phase, fiber, dmap) triple."""
    if fiber is None:
        return jbase.grid_geometry(phase, dmap=dmap)
    # fiber_tensor(angle, ratio) at 30 degrees, ratio 0.25
    return jbase.grid_geometry(phase, np.deg2rad(30.0), 0.25, dmap=dmap)


@pytest.mark.parametrize("kind", ["a", "b", "c"])
@pytest.mark.parametrize("name", ["br", "fenton", "ms"])
def test_grid_geometry_model_step_matches_jax(name, kind):
    tm, jm = model_pair(name)
    phase, fiber, dmap = geometry(kind)
    st = seeded(tm, 11)
    c = tm.cfg
    tgeom = grid_geometry(phase, np.deg2rad(30.0) if fiber else None,
                          0.25 if fiber else 1.0, dmap)
    got = interop.state_from_numpy(st, "cpu")
    want = {k: jnp.asarray(v) for k, v in st.items()}
    jgeom = jax_geometry(phase, fiber, dmap)
    for _ in range(3):
        got = tm.step(got, tgeom)
        want = jm.step(want, jgeom)
    assert c.height == H
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **STEP_TOL)


def test_grid_geometry_forms():
    """fiber_ratio == 1 keeps the isotropic stencil (as the reference);
    the maps are padded once, on the device asked for."""
    x = torch.tensor(field((H, W), 6))
    iso = grid_geometry(fiber_angle=0.4, fiber_ratio=1.0)
    assert iso.laplace is stencil.laplace
    assert grid_geometry().laplace is stencil.laplace
    phase, fiber, dmap = geometry("c")
    a = grid_geometry(phase, np.deg2rad(30.0), 0.25, dmap).laplace(x)
    b = tissue_geometry(phase, fiber, dmap).laplace(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_uniform_dmap_scales_like_diff():
    """In uniform-d tissue the operator is d x the base one (∇d = 0 kills
    the correction): a uniform map is a scaled diff
    (tests/test_hetero.py::test_uniform_dmap_scales_like_diff)."""
    x = torch.tensor(np.random.RandomState(2).rand(12, 20).astype(np.float32))
    d = np.full((12, 20), 0.37, np.float32)
    het = stencil.laplace(x, dmap_padded=torch.tensor(pad(d)))
    torch.testing.assert_close(het, 0.37 * stencil.laplace(x), rtol=1e-5,
                               atol=1e-6)
    ones = np.ones((12, 20), np.float32)
    assert torch.equal(stencil.laplace(x, dmap_padded=torch.tensor(
        pad(ones))), stencil.laplace(x))


# -- the phase field at the border: reflect for the maps, clamp for V -------------


def kernel_form(x, phase, dmap, fiber):
    """The kernels' per-cell arithmetic (csrc/geometry.cuh) written out in
    numpy float32 index by index: V's neighbour k at clamp(k), the maps'
    at reflect(k).  `x` is the raw V; the kernels read its clamped points,
    which is the boundary-enforced V."""
    h, w = x.shape
    rows, cols = np.arange(h), np.arange(w)
    clamp = lambda k, n: np.clip(k, 1, n - 2)
    refl = lambda k, n: np.where(k < 0, -k, np.where(k > n - 1,
                                                     2 * (n - 1) - k, k))
    cr = lambda d: clamp(rows + d, h)[:, None]
    cc = lambda d: clamp(cols + d, w)[None, :]
    v = lambda dr, dc: x[cr(dr), cc(dc)]
    n, s, wv, e = v(-1, 0), v(1, 0), v(0, -1), v(0, 1)
    c = v(0, 0)
    f32 = np.float32
    if fiber is None:
        lap = (n + s + wv + e + f32(0.5) * (v(-1, -1) + v(1, -1) + v(-1, 1)
                                            + v(1, 1)) - f32(6) * c)
    else:
        dxx, dxy, dyy = (f32(f) for f in fiber)
        vxx = wv - f32(2) * c + e
        vyy = n - f32(2) * c + s
        vxy = f32(0.25) * (v(1, 1) + v(-1, -1) - v(1, -1) - v(-1, 1))
        lap = f32(2) * (dxx * vxx + f32(2) * dxy * vxy + dyy * vyy)
    q = (dmap * phase if dmap is not None and phase is not None
         else (dmap if dmap is not None else phase))
    if q is None:
        return lap
    if dmap is not None:
        lap = dmap * lap
    phi = phase if phase is not None else f32(1)
    rr = lambda d: refl(rows + d, h)[:, None]
    rc = lambda d: refl(cols + d, w)[None, :]
    qx = q[rows[:, None], rc(1)] - q[rows[:, None], rc(-1)]
    qy = q[rr(1), cols[None, :]] - q[rr(-1), cols[None, :]]
    gx, gy = e - wv, s - n
    if fiber is None:
        flux = gy * qy + gx * qx
    else:
        flux = gx * (dxx * qx + dxy * qy) + gy * (dxy * qx + dyy * qy)
    return lap + flux / (f32(4) * phi)


@pytest.mark.parametrize("kind", ["a", "b", "c"])
def test_phase_at_the_border_reflects(kind):
    """With phi != 1 at the border (the rim), the kernels' form (V
    clamped, the maps reflected) is the reference's operator on the
    boundary-enforced V at every cell, the domain's outer two rings
    included; reading the maps at V's clamped indices instead is wrong one
    cell inside every edge (clamp(0) = 1, reflect(0) = 0)."""
    phase, fiber, dmap = geometry(kind)
    assert (phase[0] < 0.999).all() and (phase[:, -1] < 0.999).all()
    x = field((H, W), 7)
    want = np.asarray(jbase.grid_geometry(
        phase, np.deg2rad(30.0) if fiber else None,
        0.25 if fiber else 1.0, dmap=dmap).laplace(
            jstencil.enforce_boundary(jnp.asarray(x))))
    got = kernel_form(x, phase, dmap, fiber)
    np.testing.assert_allclose(got, want, **OP_TOL)
    # the trap: the maps read at V's clamped indices part from the
    # reference on the ring one cell inside the border
    ring1 = np.zeros((H, W), bool)
    ring1[1, 1:-1] = ring1[-2, 1:-1] = True
    ring1[1:-1, 1] = ring1[1:-1, -2] = True
    bad = _clamped_maps_form(x, phase, dmap, fiber)
    assert not np.allclose(bad[ring1], want[ring1], **OP_TOL)
    np.testing.assert_allclose(bad[2:-2, 2:-2], want[2:-2, 2:-2], **OP_TOL)


def _clamped_maps_form(x, phase, dmap, fiber):
    """The kernels' form with the maps' neighbours read at clamp(k), the
    trap the kernels avoid."""
    h, w = x.shape
    rows, cols = np.arange(h), np.arange(w)
    q = phase if dmap is None else dmap * phase
    cl = lambda k, n: np.clip(k, 1, n - 2)
    qx = q[rows[:, None], cl(cols + 1, w)[None, :]] - q[
        rows[:, None], cl(cols - 1, w)[None, :]]
    qy = q[cl(rows + 1, h)[:, None], cols[None, :]] - q[
        cl(rows - 1, h)[:, None], cols[None, :]]
    base = kernel_form(x, None, None, fiber)
    lap = base if dmap is None else dmap * base
    v = lambda dr, dc: x[cl(rows + dr, h)[:, None], cl(cols + dc, w)[None, :]]
    gx, gy = v(0, 1) - v(0, -1), v(1, 0) - v(-1, 0)
    if fiber is None:
        flux = gy * qy + gx * qx
    else:
        dxx, dxy, dyy = (np.float32(f) for f in fiber)
        flux = gx * (dxx * qx + dxy * qy) + gy * (dxy * qx + dyy * qy)
    return lap + flux / (np.float32(4) * phase)


# -- the kernels' plain versions against the JAX Pallas kernels ----------------------------


def _two_steps(jstep, step, tm, jm, st, n=2):
    """`n` outer steps of the JAX kernel `jstep` and the port's `step`
    (on CPU tensors: the plain version) from `st`; the probe at 1e-5."""
    want = {k: jnp.asarray(v) for k, v in st.items()}
    got = interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(n)
    for i in range(n):
        want = jstep(want)
        got = step(got, probe, i)
        assert abs(float(probe[i]) - float(jm.probe(want))) <= 1e-5
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **KERNEL_TOL)


@pytest.mark.parametrize("name,kind", [("br", "c"), ("fenton", "b")])
def test_kernel1_plain_matches_jax_pallas_step(name, kind):
    """Kernel 1 (make_cuda_step) under a geometry: its plain version
    against make_pallas_step with phase / fiber / dmap."""
    tm, jm = model_pair(name)
    phase, fiber, dmap = geometry(kind)
    jstep = make_pallas_step(jm, phase=phase, fiber=fiber, dmap=dmap,
                             interpret=True)
    _two_steps(jstep, cuda_step.make_cuda_step(tm, phase, fiber, dmap), tm,
               jm, seeded(tm, 12))


@pytest.mark.parametrize("name,kind", [("br", "b"), ("ms", "c")])
def test_kernel2_plain_matches_jax_tiled_kernel(name, kind):
    """Kernel 2 (make_tiled_cuda_step) under a geometry: its plain version
    against make_tiled_pallas_step with phase / fiber / dmap (16-row tiles:
    three, two of them at the domain's edges)."""
    tm, jm = model_pair(name)
    phase, fiber, dmap = geometry(kind)
    jstep = make_tiled_pallas_step(jm, 16, phase=phase, fiber=fiber,
                                   dmap=dmap, interpret=True)
    _two_steps(jstep, cuda_tiled.make_tiled_cuda_step(tm, phase, fiber, dmap),
               tm, jm, seeded(tm, 13))


@pytest.mark.parametrize("kind", ["a", "b", "c"])
@pytest.mark.parametrize("name", ["br", "fenton", "ms"])
def test_kernel_plain_steps_match_jax_model_step(name, kind):
    """The pairs not held to a Pallas kernel: kernels 1 and 2's plain
    outer steps under each geometry against the JAX model's step with its
    grid_geometry; the probe is the model's normalised potential."""
    tm, jm = model_pair(name)
    phase, fiber, dmap = geometry(kind)
    jgeom = jax_geometry(phase, fiber, dmap)
    for make in (cuda_step.make_cuda_step, cuda_tiled.make_tiled_cuda_step):
        _two_steps(lambda s: jm.step(s, jgeom), make(tm, phase, fiber, dmap),
                   tm, jm, seeded(tm, 14))


@pytest.mark.parametrize("ab2", [False, True])
def test_variant_bodies_under_geometry_match_jax(ab2):
    """BR's variant bodies (direct rates; ab2) and Fenton ab2 under (c),
    plain outer steps against the JAX model's step."""
    phase, fiber, dmap = geometry("c")
    jgeom = jax_geometry(phase, fiber, dmap)
    pairs = [model_pair("br", cheby=False, skip=False, ab2=ab2)]
    if ab2:
        pairs.append(model_pair("fenton", dt=0.025, ab2=True))
    for tm, jm in pairs:
        st = seeded(tm, 15)
        if ab2:
            st = tm.bootstrap_ab2(st)
        _two_steps(lambda s: jm.step(s, jgeom),
                   cuda_step.make_cuda_step(tm, phase, fiber, dmap), tm, jm,
                   {k: np.asarray(v, np.float32) for k, v in st.items()})


def test_geometry_maps_checks():
    maps = bodies.GeometryMaps((8, 9))
    assert maps.empty
    with pytest.raises(ValueError, match="shape"):
        bodies.GeometryMaps((8, 9), phase=np.ones((9, 8)))
    with pytest.raises(ValueError, match="dxx, dxy, dyy"):
        bodies.GeometryMaps((8, 9), fiber=(1.0, 0.0))
    full = bodies.GeometryMaps((8, 9), np.ones((8, 9)), (1.0, 0.0, 1.0),
                                  np.ones((8, 9)))
    assert not full.empty
    p, d = full.tensors("cpu")
    assert p.dtype == d.dtype == torch.float32 and p.shape == (8, 9)
    assert full.tensors("cpu")[0] is p and full.plain("cpu") is full.plain(
        "cpu")
    args = bodies.kernel_geometry_args(p, None, None)
    assert args == (p.data_ptr(), None, 0, 1.0, 0.0, 1.0)


# -- Simulation with a hole, a diffusion map and fibers --------------------------------

SIM_CFG = SimConfig(width=64, height=64, dt=0.1, dt_per_plot=10,
                    diff=0.809, duration=60, cheby=True, skip=True,
                    fiber_angle=np.deg2rad(30.0), fiber_ratio=0.25)


def _simulate(sim_cls, model):
    sim = sim_cls(model) if sim_cls is JaxSimulation else sim_cls(
        model, device="cpu")
    # a hole whose rim covers the probe pixel (20, 32): phi there < 1
    sim.add_hole_to_phase_field(32, 26, 4)
    sim.add_hole_to_phase_field(32, 32, 36, neg=True)
    sim.set_diffusion_map(jstencil.fibrosis_map(64, 64, 0.25, 0.8, 0))
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0)
    return sim, sim.simulate(schedule=[(30.0, "s2")])


@pytest.fixture(scope="module")
def sim_runs():
    jsim, want = _simulate(JaxSimulation, JaxBR(jax_cfg(SIM_CFG)))
    tsim, got = _simulate(Simulation, BeelerReuter(SIM_CFG))
    return jsim, want, tsim, got


def test_simulation_geometry_matches_jax_engine(sim_runs):
    jsim, want, tsim, got = sim_runs
    np.testing.assert_array_equal(tsim.phase, jsim.phase)
    np.testing.assert_array_equal(tsim.dmap, jsim.dmap)
    assert tsim.route == "plain" and got.steps == want.steps == 120
    assert got.cycle_lengths == want.cycle_lengths
    assert len(got.cycle_lengths) >= 1
    v_atol = 1e-3 * (BeelerReuter.max_v - BeelerReuter.min_v)
    for k in want.state:
        tol = (dict(atol=v_atol, rtol=0) if k == "V"
               else dict(atol=0, rtol=1e-3) if k == "C"
               else dict(atol=1e-3, rtol=0))
        np.testing.assert_allclose(got.state[k], want.state[k], err_msg=k,
                                   **tol)


def test_simulation_probe_is_phase_scaled(sim_runs):
    """The probe samples the phase-masked image: V's probe times
    phase[probe_pixel], which the cycle-length detector sees."""
    jsim, want, tsim, got = sim_runs
    r, c = tsim.model.probe_pixel
    scale = float(tsim.phase[r, c])
    assert 0.0 < scale < 0.99
    np.testing.assert_allclose(got.probes["v"], want.probes["v"], rtol=0,
                               atol=1e-3)
    assert got.probes["v"].max() <= scale * 1.0 + 1e-6


def test_geometry_precedes_define():
    sim = Simulation(BeelerReuter(SIM_CFG.replace(duration=1)),
                     device="cpu")
    with pytest.raises(ValueError, match="shape"):
        sim.set_diffusion_map(np.ones((8, 8)))
    with pytest.raises(ValueError, match="finite"):
        sim.set_diffusion_map(np.full((64, 64), -1.0))
    with pytest.raises(ValueError, match="finite"):
        sim.set_diffusion_map(np.full((64, 64), np.nan))
    sim.define()
    with pytest.raises(AssertionError, match="before define"):
        sim.add_hole_to_phase_field(3, 3, 2)
    with pytest.raises(AssertionError, match="before define"):
        sim.set_diffusion_map(np.ones((64, 64)))


def test_geometry_does_not_move_the_cutover(monkeypatch):
    """The cutover counts the model's planes only (the reference's
    _state_mb): a hole and a map leave `route` as it was."""
    from fib_tf_tpu_torch.engine import simulation
    m = BeelerReuter(SIM_CFG)
    assert simulation.route(m, "cuda", "auto") == "substep"
    monkeypatch.setattr(Simulation, "WHOLE_GRID_STATE_MB_MAX",
                        simulation.state_mb(m))
    assert simulation.route(m, "cuda", "auto") == "substep"


# -- the reference's geometry pins, through the port -------------------------------------


def test_golden_tissue_through_the_port():
    """tests/test_golden.py::test_golden_tissue on the port: 32x32 Fenton
    with a phase-field hole, S1 stripe, S2 quadrant at 4 ms, 8 ms, against
    tests/golden/fenton_tissue_u.npy at atol 1e-3."""
    import os
    cfg = SimConfig(width=32, height=32, dt=0.1, dt_per_plot=10, diff=1.5,
                    duration=8)
    sim = Simulation(Fenton4v(cfg), device="cpu")
    sim.add_hole_to_phase_field(16, 16, 5)
    sim.define()
    sim.add_pace_op("s2", "luq", 1.0)
    res = sim.simulate(schedule=[(4, "s2")])
    want = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                "fenton_tissue_u.npy"))
    np.testing.assert_allclose(res.state["u"], want, atol=1e-3, rtol=0)


def test_cv_anisotropy_physics():
    """tests/test_stencil.py::test_cv_anisotropy_physics on the port: a
    Fenton planar wave along x conducts faster with fibers along x (ratio
    0.25) than across them, by the reference's 2-3x."""
    cvs = {}
    for name, ang in (("along", 0.0), ("across", np.pi / 2)):
        cfg = SimConfig(width=128, height=16, dt=0.1, duration=1, diff=1.5,
                        fiber_angle=ang, fiber_ratio=0.25)
        model = Fenton4v(cfg)
        geom = grid_geometry(None, ang, 0.25)
        state = interop.state_from_numpy(model.initial_state(s1=True), "cpu")
        probes = []
        for _ in range(120):
            state = model.step(state, geom)
            probes.append([float(state["u"][8, 30]), float(state["u"][8, 90])])
        probes = np.asarray(probes)
        t0, t1 = (np.where(probes[:, j] > 0.5)[0][0] for j in (0, 1))
        cvs[name] = 60.0 / (t1 - t0)
    ratio = cvs["along"] / cvs["across"]
    assert 2.0 < ratio < 3.0, ratio
