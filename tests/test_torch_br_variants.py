"""Every Beeler-Reuter variant of the port against fib_tf_tpu's model, and
the plain versions of kernels 1-4 and 6 against the JAX Pallas kernels (in
interpret mode, as tests/test_pallas.py runs them) for the variants' and
the ab2 bodies, plus the goldens and the conduction-velocity pin that the
direct rates carry.

Tolerances:
  * the variant grid (`model.step` twice from states drawn per cell):
    |dV| <= 1e-4 mV, gates and C <= 1e-6, the derivative planes 1e-3
    (mV/ms) and 1e-5, the same bounds over dt; the main path's variant
    (fold + Chebyshev currents, Euler) bit-equal;
  * kernels' plain versions against the JAX kernels: rtol 1e-3 / atol
    1e-5 over two outer steps (tests/test_pallas.py:90-97);
  * in both, a cell outside them is arbitrated by the JAX model run in
    float64 from the same state (`assert_arbitrated`): it passes if the
    port is no further from that run than the JAX float32 result is, or
    if its float64 V passed within ILL_MARGIN_MV of a point where the
    reference's float32 evaluation is ill-conditioned (the model's
    `ill_conditioned` windows); at most ARBITRATED_CAP of a plane's cells;
  * goldens: 1e-3 of the model's 120 mV range (tests/test_golden.py);
  * conduction velocity: 5% of 1.714 cells/ms (tests/test_physics.py:142).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.beeler_reuter as jbr
import fib_tf_tpu.models.fenton as jfen
import fib_tf_tpu.models.mitchell_schaeffer as jms
import fib_tf_tpu_torch.models.beeler_reuter as tbr
import fib_tf_tpu_torch.models.fenton as tfen
import fib_tf_tpu_torch.models.mitchell_schaeffer as tms
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.models import grid_geometry as jax_grid_geometry
from fib_tf_tpu.models.base import volume_geometry as jax_volume_geometry
from fib_tf_tpu.ops.pallas_step import make_pallas_step
from fib_tf_tpu.ops.pallas_tiled import (make_block_kernel,
                                         make_tiled_pallas_step)
from fib_tf_tpu.ops.pallas_volume import (make_pallas_volume_step,
                                          make_volume_block_kernel)
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.models import cell_geometry, grid_geometry
from fib_tf_tpu_torch.ops import (bodies, cuda_block, cuda_step, cuda_tiled,
                                  cuda_volume, cuda_volume_block)
from fib_tf_tpu_torch.ops.chebyshev import (chebyshev_eval, chebyshev_terms,
                                            normalize_voltage)
from test_torch_fixtures import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KERNEL_TOL = dict(rtol=1e-3, atol=1e-5)
# the AB2 derivative planes (mV/ms for _dV_) enter the next step's V as
# 0.5 dt f_prev: the atol that moves V by at most V's own atol
DERIVATIVE_ATOL = 1e-5 / (0.5 * 0.1)
# the variant grid's bounds per plane (see the module note)
GRID_TOL = {"V": 1e-4, "_dV_": 1e-3, "_dC_": 1e-5}
GATE_TOL = 1e-6
# the margin round a model's `ill_conditioned` windows (its float32
# evaluation ill-conditioned: test_ill_conditioned_windows) and the share
# of a plane's cells that may pass by arbitration, as in chip_smoke.py
ILL_MARGIN_MV = 0.5
ARBITRATED_CAP = 0.02
# (gate mode, current mode) -> the SimConfig flags that select them
VARIANTS = {
    ("fold", "cheby"): dict(cheby=True, cheby_fold=True, cheby_currents=True),
    ("fold", "fast"): dict(cheby=True, cheby_fold=True, cheby_currents=False,
                           fast_currents=True),
    ("fold", "plain"): dict(cheby=True, cheby_fold=True,
                            cheby_currents=False, fast_currents=False),
    ("cheby", "cheby"): dict(cheby=True, cheby_fold=False,
                             cheby_currents=True),
    ("cheby", "fast"): dict(cheby=True, cheby_fold=False,
                            cheby_currents=False, fast_currents=True),
    ("cheby", "plain"): dict(cheby=True, cheby_fold=False,
                             cheby_currents=False, fast_currents=False),
    ("direct", "fast"): dict(cheby=False, fast_currents=True),
    ("direct", "plain"): dict(cheby=False, fast_currents=False),
}


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


def cfg(**kw):
    base = dict(width=24, height=16, dt=0.1, diff=0.809, duration=1)
    base.update(kw)
    return SimConfig(**base)


def br_models(**kw):
    c = cfg(**kw)
    return jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)


def drawn_state(model, shape, seed):
    """A Beeler-Reuter state drawn per cell from a seed: V over [-88, 28]
    mV, every gate over (0, 1), C over [1e-5, 3e-3); with ab2 the
    derivative planes bootstrapped from it."""
    rng = np.random.RandomState(seed)
    draw = lambda lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)
    st = {"V": draw(-88.0, 28.0), "C": draw(1e-5, 3e-3)}
    st.update({g: draw(1e-5, 0.99999) for g in tbr.GATES})
    if model.cfg.ab2:
        st = model.bootstrap_ab2(st)
    return st


def small_state(model, shape, seed):
    """A Fenton or Mitchell-Schaeffer state drawn per cell (the border
    differs from its neighbours); with ab2 the derivative planes
    bootstrapped from it."""
    rng = np.random.RandomState(seed)
    his = (dict(u=1.0, v=1.0, w=1.0, s=0.6) if model.name == "fenton"
           else dict(u=1.0, h=1.0))
    st = {k: rng.uniform(0.0, hi, shape).astype(np.float32)
          for k, hi in his.items()}
    if model.cfg.ab2:
        st = model.bootstrap_ab2(st)
    return st


def rest_state(model, shape, seed):
    """Beeler-Reuter's initial state (its S1 stripe; over a volume's depth
    too) perturbed per cell from a seed, as the port's kernel tests perturb
    it, with ab2 the derivative planes bootstrapped from it: V by N(0, 2)
    mV, the gates by x U(0.9, 1.1) and C by x U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    st = {k: np.ascontiguousarray(np.broadcast_to(v, shape), np.float32)
          for k, v in model.initial_state().items() if not k.startswith("_")}
    up = lambda lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)
    st["V"] = st["V"] + rng.normal(0, 2.0, shape).astype(np.float32)
    for g in tbr.GATES:
        st[g] = np.clip(st[g] * up(0.9, 1.1), 1e-5, 0.99999)
    st["C"] = st["C"] * up(0.5, 1.5)
    if model.cfg.ab2:
        st = model.bootstrap_ab2(st)
    return st


def to_jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def jax_float64(jm, st, geom, n_steps, substeps=None):
    """The JAX model's `n_steps` outer steps (or its first `substeps`
    substeps, once) from the host state `st`, in float64."""
    with jax.enable_x64():
        state = {k: jnp.asarray(v, jnp.float64) for k, v in st.items()}
        if substeps is not None:
            for fn in jm.substep_fns(geom)[0][:substeps]:
                state = fn(state)
        else:
            for _ in range(n_steps):
                state = jm.step(state, geom)
        return {k: np.asarray(v) for k, v in state.items()}


def assert_arbitrated(got, want, close, exact, windows):
    """Every plane of `got` (the port) `close(plane, got, want)` to `want`
    (the JAX package, float32) but at cells arbitrated by `exact()`, which
    returns (the JAX model's float64 run, its start state): a cell passes
    if the port is no further from float64 than `want`, or if its float64
    V passed within ILL_MARGIN_MV of one of `windows`; at most
    ARBITRATED_CAP of the plane's cells."""
    assert set(got) == set(want)
    arbiter = None
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k])
        off = ~close(k, g, w)
        if not off.any():
            continue
        if arbiter is None:
            arbiter = exact()
        ex, start = arbiter
        e = ex[k]
        nearer = np.abs(g - e) <= np.abs(w.astype(np.float64) - e)
        lo = np.minimum(start["V"], ex["V"])
        hi = np.maximum(start["V"], ex["V"])
        ill = np.zeros_like(off)
        for w_lo, w_hi in windows:
            ill |= (hi >= w_lo - ILL_MARGIN_MV) & (lo <= w_hi + ILL_MARGIN_MV)
        passed = off & (nearer | ill)
        assert not (off & ~passed).any(), (
            f"{k}: {int((off & ~passed).sum())} cells off by up to "
            f"{np.abs(g - w)[off & ~passed].max()}, the port further from "
            f"float64 than the JAX model and V away from {windows}")
        assert passed.sum() <= ARBITRATED_CAP * off.size, (
            f"{k}: {int(passed.sum())} arbitrated cells of {off.size}")


# -- constants and fits -----------------------------------------------------------------


def test_fast_current_constants_equal_the_reference_forms():
    """The shared-exponential currents' constants, pinned to the
    expressions of the reference's `currents` (beeler_reuter.py:296-311),
    and the rate table to the JAX model's."""
    assert tbr.FAST_CURRENTS == {
        "a85": float(np.exp(0.04 * 85.0)),
        "a53b": float(np.exp(0.08 * 53.0)),
        "a53": float(np.exp(0.04 * 53.0)),
        "a23": float(np.exp(-0.04 * 23.0)),
        "a77": float(np.exp(0.04 * 77.0)),
        "a35": float(np.exp(0.04 * 35.0)),
    }
    assert tbr.RATE_PARAMS == jbr.RATE_PARAMS
    v = np.linspace(-90.0, 30.0, 241).astype(np.float32)
    v = v[np.abs(v + 47.0) > 0.1]   # alpha_m's removable singularity
    for key, c in tbr.RATE_PARAMS.items():
        np.testing.assert_allclose(
            tbr.rate_torch(torch.tensor(v), c).numpy(),
            np.asarray(jbr.rate_jnp(jnp.asarray(v), c)), rtol=2e-6,
            err_msg=str(key))


def test_alpha_m_is_literal_at_its_removable_singularity():
    """alpha_m = -(V + 47) / (exp(-0.1 (V + 47)) - 1) is evaluated
    literally, as the reference's rate_jnp: at V = -47 mV exactly it is
    0/0 = NaN in both packages, so a direct-rates run whose V lands there
    turns m into NaN (as a volume with an S2 did on the card)."""
    v = np.float32([-47.0, -47.001, -46.999, -40.0])
    c = tbr.RATE_PARAMS[("m", "a")]
    got = tbr.rate_torch(torch.tensor(v), c).numpy()
    want = np.asarray(jbr.rate_jnp(jnp.asarray(v), c))
    assert np.isnan(got[0]) and np.isnan(want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)


FITTED = [k for k in VARIANTS if k[0] != "direct"]


@pytest.mark.parametrize("gate,current", FITTED,
                         ids=[f"{g}-{c}" for g, c in FITTED])
@pytest.mark.parametrize("skip", [True, False], ids=["skip", "noskip"])
def test_fit_sets_equal_jax_and_round_trip(gate, current, skip):
    """Each variant fits what the JAX model fits, bit for bit, and
    interop.cheby_coef_from_numpy takes the JAX set for that
    configuration and no other."""
    jm, tm = br_models(skip=skip, **VARIANTS[(gate, current)])
    assert set(tm.cheby_coef) == set(jm._cheby_coef)
    for k in jm._cheby_coef:
        assert np.array_equal(tm.cheby_coef[k], jm._cheby_coef[k]), k
    got = interop.cheby_coef_from_numpy(jm._cheby_coef, tm.cfg)
    assert all(np.array_equal(got[k], jm._cheby_coef[k]) for k in got)
    assert set(got) == set(jm._cheby_coef)
    bad = dict(jm._cheby_coef)
    del bad["x1_tau"]
    with pytest.raises(ValueError, match="missing"):
        interop.cheby_coef_from_numpy(bad, tm.cfg)
    extra = "i_k1" if current != "cheby" else "m_rl"
    if gate == "fold" and current == "cheby":
        extra = None
    if extra is not None:
        with pytest.raises(ValueError, match="unexpected"):
            interop.cheby_coef_from_numpy(
                {**jm._cheby_coef, extra: jm._cheby_coef["m_inf"]}, tm.cfg)


def test_unfolded_tau_h_fit_is_negative_at_rest():
    """The reference's degree-8 fit of tau_h (cheby without the fold) is
    negative on about [-88, -83.9] mV, around the resting potential
    (-84.6 mV): there the unfolded update g + (g - inf) expm1(-dt / tau)
    moves h away from inf, and near tau's zeros it clips h to 1e-5 or
    0.99999.  The port keeps the reference's fit; this pins where it is
    negative."""
    _, tm = br_models(**VARIANTS[("cheby", "plain")])
    v = np.linspace(-90.0, 30.0, 1201)
    terms = chebyshev_terms(normalize_voltage(torch.tensor(v), tm.min_v,
                                              tm.max_v), 8)
    tau = chebyshev_eval(tm.cheby_coef["h_tau"], terms).numpy()
    neg = v[tau < 0]
    assert -88.2 < neg.min() < -87.8 and -84.1 < neg.max() < -83.7
    assert -84.624 > neg.min() and -84.624 < neg.max()
    for g in ("x1", "m", "j", "d", "f"):
        t = chebyshev_eval(tm.cheby_coef[f"{g}_tau"], terms).numpy()
        assert (t > 0).all(), g


def test_ill_conditioned_windows():
    """Each flag set's windows: alpha_m's 0/0 with direct rates, iK1's
    with the literal and shared-exponential currents, and the unfolded
    tau_h fit's negative stretch (within 0.2 mV of where it is negative);
    none for the main path, Fenton or Mitchell-Schaeffer."""
    for (gate, current), flags in VARIANTS.items():
        tm = br_models(**flags)[1]
        want = (((-47.0, -47.0),) if gate == "direct" else ()) + (
            ((-23.0, -23.0),) if current != "cheby" else ())
        if gate == "cheby":
            v = np.linspace(-90.0, 30.0, 1201)
            tau = chebyshev_eval(tm.cheby_coef["h_tau"], chebyshev_terms(
                normalize_voltage(torch.tensor(v), tm.min_v, tm.max_v),
                8)).numpy()
            lo, hi = tm.ill_conditioned[-1]
            assert abs(v[tau < 0].min() - lo) < 0.2
            assert abs(v[tau < 0].max() - hi) < 0.2
            want += ((lo, hi),)
        assert tm.ill_conditioned == want, (gate, current)
    for name in ("fenton", "ms"):
        assert kernel_models(name)[1].ill_conditioned == ()


def test_direct_rates_take_no_fits():
    jm, tm = br_models(cheby=False)
    assert tm.cheby_coef == {} and not hasattr(jm, "_cheby_coef")
    with pytest.raises(ValueError, match="direct"):
        interop.cheby_coef_from_numpy({}, tm.cfg)


def test_variant_modes_and_bodies():
    """The modes each flag set selects, and the cell body that carries
    it: BeelerReuterCell for the main path only."""
    for (gate, current), flags in VARIANTS.items():
        for ab2 in (False, True):
            tm = br_models(**flags, ab2=ab2)[1]
            assert (tm.gate_mode, tm.current_mode) == (gate, current)
            body = bodies.cell_body(tm).name
            main = (gate, current) == ("fold", "cheby") and not ab2
            assert body == ("br" if main else
                            "br_variant_ab2" if ab2 else "br_variant")
            assert bodies.pack_params(tm).size == bodies.cell_body(
                tm).param_floats
    # Table 1's direct rows keep cheby_currents on: the fast form runs
    assert br_models(cheby=False)[1].current_mode == "fast"


def test_adaptive_dv_raises_and_the_fold_guard_stays():
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        tbr.BeelerReuter(cfg(adaptive_dv=1.0))
    tm = tbr.BeelerReuter(cfg(skip=True))
    st = interop.state_from_numpy(tm.initial_state(), "cpu")
    with pytest.raises(ValueError, match="baked"):
        tm.solve(st, grid_geometry(), n=1)
    # the unfolded and direct gates take any n
    for flags in (VARIANTS[("cheby", "plain")], VARIANTS[("direct", "fast")]):
        tm = tbr.BeelerReuter(cfg(skip=True, **flags))
        tm.solve(interop.state_from_numpy(tm.initial_state(), "cpu"),
                 grid_geometry(), n=1)


# -- the variant grid against the JAX model's solve ----------------------------------------


def _step_twice(model, st, dtype):
    state = {k: torch.tensor(v, dtype=dtype) for k, v in st.items()}
    for _ in range(2):
        state = model.step(state, grid_geometry())
    return {k: v.numpy() for k, v in state.items()}


@pytest.mark.parametrize("ab2", [False, True], ids=["euler", "ab2"])
@pytest.mark.parametrize("skip", [True, False], ids=["skip", "noskip"])
@pytest.mark.parametrize("gate,current", list(VARIANTS),
                         ids=[f"{g}-{c}" for g, c in VARIANTS])
def test_variant_matches_jax_solve(gate, current, skip, ab2):
    """Two outer steps of the port's plain model from a 16x24 state drawn
    per cell against the JAX model's `step` (its `solve` five times)."""
    jm, tm = br_models(skip=skip, ab2=ab2, **VARIANTS[(gate, current)])
    st = drawn_state(tm, tm.state_shape(), seed=11)
    want = {k: np.asarray(v) for k, v in
            jm.step(jm.step(to_jax(st), jax_grid_geometry()),
                    jax_grid_geometry()).items()}
    got = _step_twice(tm, st, torch.float32)
    assert set(got) == set(want) == set(tm.state_keys())
    if (gate, current) == ("fold", "cheby") and not ab2:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        return
    assert_arbitrated(
        got, want,
        lambda k, g, w: np.abs(g.astype(np.float64) - w)
        <= GRID_TOL.get(k, GATE_TOL),
        lambda: (jax_float64(jm, st, jax_grid_geometry(), 2), st),
        tm.ill_conditioned)


# -- the kernels' plain versions against the JAX Pallas kernels ----------------------------

# the configurations of the new bodies: Table 1's direct rows, the
# unfolded fit with plain currents (here), BR's ab2 and Fenton's ab2
# (tests/test_torch_ab2.py; Fenton at dt 0.05: AB2's stability interval
# is half Euler's, and at dt 0.1 the diffusion mode at diff 1.5 grows)
KERNEL_CONFIGS = {
    "direct": ("br", dict(cheby=False, skip=False)),
    "direct-skip": ("br", dict(cheby=False, skip=True)),
    "cheby-plain-skip": ("br", dict(VARIANTS[("cheby", "plain")],
                                    skip=True)),
    "br-ab2-skip": ("br", dict(skip=True, ab2=True)),
    "fenton-ab2": ("fenton", dict(ab2=True, dt=0.05)),
}
# A fused JAX Pallas kernel compiles for 4-18 s in interpret mode, so each
# configuration meets one on kernel 1 and on one or two of the fused
# kernels (PALLAS; the ab2 ones in tests/test_torch_ab2.py); the other
# (kernel, configuration) pairs hold the kernel's plain version to the JAX
# model's own step on the same geometry, run op by op, which the JAX
# package's tests hold its Pallas kernels to (the cell body is the model's
# `solve` in both; a kernel adds the schedule, the planes and the halo)
PALLAS = {"tiled": ("direct", "fenton-ab2"),
          "block": ("direct-skip", "br-ab2-skip"),
          "volume": ("cheby-plain-skip", "direct-skip"),
          "volume_block": ("cheby-plain-skip", "br-ab2-skip", "fenton", "ms")}
# kernel 6 runs Fenton and Mitchell-Schaeffer in groups of five of their
# ten substeps, as the sharded volume runs them with halo_k 5
GROUP_SUBSTEPS = {"fenton": 5, "ms": 5}
EULER_CONFIGS = ["direct", "direct-skip", "cheby-plain-skip"]
H, W = 32, 128          # 2D grids (four 16-row Pallas tiles, 16-row shards)
D, VH, VW = 4, 16, 24   # volumes
D_TOTAL, D_LOCAL = 18, 6


def kernel_models(name, **kw):
    family, flags = KERNEL_CONFIGS[name] if name in KERNEL_CONFIGS else (
        name, {})
    base = dict(dt=0.1, diff=0.809 if family == "br" else 1.5, duration=1)
    base.update(flags)
    base.update(kw)
    c = SimConfig(**base)
    j, t = {"br": (jbr.BeelerReuter, tbr.BeelerReuter),
            "fenton": (jfen.Fenton4v, tfen.Fenton4v),
            "ms": (jms.MitchellSchaeffer, tms.MitchellSchaeffer)}[family]
    return j(jax_cfg(c)), t(c)


def kernel_state(tm, shape, seed):
    """The kernels' inputs: Fenton and Mitchell-Schaeffer states drawn per
    cell, as their own tests draw them; for BR `rest_state`, as the port's
    BR kernel tests perturb the initial state (a state drawn over the
    whole range makes the Laplacian's rounding, summed in another order by
    the JAX kernels, alone as large as the 1e-5 mV atol at cells near 0
    mV).  Around rest the unfolded fits sit in their ill-conditioned
    window, and assert_kernel_close arbitrates the cells there."""
    if tm.name != "br":
        return small_state(tm, shape, seed)
    return rest_state(tm, shape, seed)


def kernel_close(k, got, want):
    """KERNEL_TOL, the derivative planes with DERIVATIVE_ATOL."""
    atol = DERIVATIVE_ATOL if k.startswith("_d") else KERNEL_TOL["atol"]
    return np.abs(got - want) <= atol + KERNEL_TOL["rtol"] * np.abs(want)


def assert_kernel_close(got, want, exact=None, windows=()):
    """Every plane within KERNEL_TOL (DERIVATIVE_ATOL for the derivative
    planes); with `exact`, cells outside them arbitrated
    (assert_arbitrated)."""
    if exact is None:
        exact = lambda: pytest.fail("cells outside the kernel tolerance")
    assert_arbitrated(got, want, kernel_close, exact, windows)


def _two_steps(jm, tm, jstep, step, st, geom):
    want, got = to_jax(st), interop.state_from_numpy(st, "cpu")
    for _ in range(2):
        want, got = jstep(want), step(got)
    assert_kernel_close(got, want, lambda: (jax_float64(jm, st, geom, 2), st),
                        tm.ill_conditioned)


def _window(st, axis_starts):
    """The window of a host state starting at `start` with `size` along
    each leading axis, wrapped round the domain as the exchange wraps it."""
    out = {}
    for k, v in st.items():
        for axis, (start, size) in enumerate(axis_starts):
            v = np.take(v, np.arange(start, start + size) % v.shape[axis],
                        axis=axis)
        out[k] = np.ascontiguousarray(v)
    return out


def substep_kernel_case(name):
    """Kernel 1's plain version (one launch per substep) against the JAX
    whole-grid kernel as the engine routes it, one substep per launch,
    two outer steps on 16x24."""
    jm, tm = kernel_models(name, height=16, width=24)
    _two_steps(jm, tm,
               make_pallas_step(jm, substeps_per_launch=1, interpret=True),
               cuda_step.make_cuda_step(tm),
               kernel_state(tm, tm.state_shape(), seed=1),
               jax_grid_geometry())


def model_step(jm, geom, substeps=None):
    """The JAX model's outer step (or its first `substeps` substeps) on
    `geom`, run op by op: the reference of the non-PALLAS pairs."""
    if substeps is None:
        return lambda st: jm.step(st, geom)
    fns = jm.substep_fns(geom)[0][:substeps]
    return lambda st: functools.reduce(lambda s, fn: fn(s), fns, st)


def tiled_kernel_case(name):
    """Kernel 2's plain version (one launch per outer step) against the
    JAX row-tiled kernel (or the JAX model's step): 16-row tiles on 32x128
    for BR, 32-row ones on 64x128 for Fenton's ten-ring halo."""
    rows = 64 if name.startswith("fenton") else H
    jm, tm = kernel_models(name, height=rows, width=W)
    _two_steps(jm, tm,
               make_tiled_pallas_step(jm, rows // 2, interpret=True)
               if name in PALLAS["tiled"]
               else model_step(jm, jax_grid_geometry()),
               cuda_tiled.make_tiled_cuda_step(tm),
               kernel_state(tm, tm.state_shape(), seed=2),
               jax_grid_geometry())


def block_kernel_case(name):
    """Kernel 3's plain version on the interior 16-row shard of a 1D mesh
    (its ghosts cut from the unsharded state each outer step) against the
    JAX per-shard block kernel (or the JAX model's step of the whole
    grid), two outer steps."""
    jm, tm = kernel_models(name, height=3 * 16, width=W)
    k = tm.dt_per_step
    h_own, h_total = 16, 3 * 16
    rstart = h_own - k
    if name in PALLAS["block"]:
        kern = make_block_kernel(jm, h_own + 2 * k, W, h_total, None, False,
                                 interpret=True)
        block = lambda ext, full: {kk: np.asarray(v)[k:-k] for kk, v in
                                   kern(to_jax(ext), rstart, None).items()}
    else:
        whole = model_step(jm, jax_grid_geometry())
        block = lambda ext, full: own(whole(to_jax(full)))
    step = cuda_block.make_block_step(tm, False)
    full = kernel_state(tm, tm.state_shape(), seed=3)
    own = lambda st: {kk: np.asarray(v)[h_own:2 * h_own]
                      for kk, v in st.items()}
    for _ in range(2):
        ext = _window(full, [(rstart, h_own + 2 * k)])
        ext_in = interop.state_from_numpy(ext, "cpu")
        ext_out = {kk: torch.zeros_like(v) for kk, v in ext_in.items()}
        step(ext_in, ext_out, rstart)
        assert_kernel_close(
            {kk: v[k:-k] for kk, v in ext_out.items()}, block(ext, full),
            lambda full=full: (own(jax_float64(jm, full, jax_grid_geometry(),
                                               1)), own(full)),
            tm.ill_conditioned)
        ref = interop.state_from_numpy(full, "cpu")
        cuda_step.plain_step(tm, ref)
        full = interop.state_to_numpy(ref)


def volume_dt(name):
    """A volume's dt: AB2 needs dt * diff * 20 < 1 in 3D (the Laplacian's
    largest eigenvalue at dz_ratio 1), so Fenton's ab2 (diff 1.5) runs at
    0.025; the others at 0.05, under Euler's 3D limit."""
    return 0.025 if name == "fenton-ab2" else 0.05


def volume_kernel_case(name):
    """Kernel 4's plain version (one launch per substep) against the JAX
    whole-volume kernel (flat layout), 4x16x24, dz_ratio 0.5."""
    jm, tm = kernel_models(name, height=VH, width=VW, dt=volume_dt(name))
    _two_steps(jm, tm,
               make_pallas_volume_step(jm, D, dz_ratio=0.5, interpret=True)
               if name in PALLAS["volume"]
               else model_step(jm, jax_volume_geometry(dz_ratio=0.5)),
               cuda_volume.make_volume_step(tm, D, dz_ratio=0.5),
               kernel_state(tm, (D,) + tm.state_shape(), seed=4),
               jax_volume_geometry(dz_ratio=0.5))


def volume_block_kernel_case(name):
    """Kernel 6's plain version on an interior z shard of an 18-slice
    volume (its ghosts cut from the unsharded volume each group) against
    the JAX volume block kernel (flat layout; or the JAX model's step of
    the whole volume), two groups of one outer step's substeps
    (GROUP_SUBSTEPS for Fenton and Mitchell-Schaeffer)."""
    jm, tm = kernel_models(name, height=VH, width=VW, dt=volume_dt(name))
    substeps = GROUP_SUBSTEPS.get(name)
    k = tm.dt_per_step if substeps is None else substeps
    ext_d, zstart = D_LOCAL + 2 * k, D_LOCAL - k
    geom = jax_volume_geometry(dz_ratio=0.5)
    own = lambda st: {kk: np.asarray(v)[D_LOCAL:2 * D_LOCAL]
                      for kk, v in st.items()}
    if name in PALLAS["volume_block"]:
        kern = make_volume_block_kernel(jm, ext_d, D_TOTAL, dz_ratio=0.5,
                                        interpret=True, substeps=substeps)
        rrow = jnp.asarray(np.tile(np.arange(VH, dtype=np.int32), ext_d)
                           .reshape(ext_d * VH, 1))
        zidx = jnp.asarray(zstart + np.repeat(
            np.arange(ext_d, dtype=np.int32), VH).reshape(ext_d * VH, 1))
        block = lambda ext, full: {kk: np.asarray(v)[k:-k] for kk, v in
                                   kern(to_jax(ext), rrow, zidx).items()}
    else:
        whole = model_step(jm, geom, substeps)
        block = lambda ext, full: own(whole(to_jax(full)))
    step = cuda_volume_block.make_volume_block_step(tm, ext_d, D_TOTAL, 0.5,
                                                    substeps)
    full = kernel_state(tm, (D_TOTAL,) + tm.state_shape(), seed=5)
    for _ in range(2):
        ext = _window(full, [(zstart, ext_d)])
        got, _ = step(interop.state_from_numpy(ext, "cpu"),
                      torch.empty((ext_d,) + tm.state_shape()), zstart)
        assert_kernel_close(
            {kk: v[k:-k] for kk, v in got.items()}, block(ext, full),
            lambda full=full: (own(jax_float64(jm, full, geom, 1, substeps)),
                               own(full)),
            tm.ill_conditioned)
        ref = interop.state_from_numpy(full, "cpu")
        cuda_volume_block.plain_volume_block_step(tm, ref, 0, D_TOTAL, 0.5,
                                                  substeps)
        full = interop.state_to_numpy(ref)


@pytest.mark.parametrize("name", EULER_CONFIGS)
def test_substep_kernel_plain_matches_jax_pallas_step(name):
    substep_kernel_case(name)


@pytest.mark.parametrize("name", EULER_CONFIGS)
def test_tiled_kernel_plain_matches_jax_tiled_kernel(name):
    tiled_kernel_case(name)


@pytest.mark.parametrize("name", EULER_CONFIGS)
def test_block_kernel_plain_matches_jax_block_kernel(name):
    block_kernel_case(name)


@pytest.mark.parametrize("name", EULER_CONFIGS)
def test_volume_kernel_plain_matches_jax_volume_kernel(name):
    volume_kernel_case(name)


@pytest.mark.parametrize("name", EULER_CONFIGS)
def test_volume_block_kernel_plain_matches_jax_volume_block_kernel(name):
    volume_block_kernel_case(name)


# -- goldens and physics ---------------------------------------------------------------------


@pytest.mark.parametrize("name,flags", [
    ("br_direct_ap", dict(cheby=False)), ("br_cheby_ap", dict(cheby=True))])
def test_golden_trace(name, flags):
    """0D action potentials vs tests/golden/, as tests/test_golden.py
    drives them (stim -30 mV, 700 outer steps)."""
    model = tbr.BeelerReuter(SimConfig(width=8, height=8, dt=0.1,
                                       duration=1, **flags))
    geom = cell_geometry()
    st = model.initial_state(s1=False)
    st["V"][:] = -30.0
    state = interop.state_from_numpy(st, "cpu")
    trace = []
    for _ in range(700):
        state = model.step(state, geom)
        trace.append(float(state["V"][0, 0]))
    want = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    np.testing.assert_allclose(
        np.asarray(trace, np.float32), want,
        atol=1e-3 * (model.max_v - model.min_v), rtol=0)


def test_conduction_velocity_at_diff_1():
    """A planar S1 wave on 128x16 at diff 1.0 with direct rates and no
    skip runs 1.714 cells/ms, the reference's absolute pin
    (tests/test_physics.py:138-142): the front's first V > -40 mV at
    columns 30 and 90 of the middle row."""
    model = tbr.BeelerReuter(cfg(width=128, height=16, diff=1.0,
                                 cheby=False, skip=False))
    state = interop.state_from_numpy(model.initial_state(), "cpu")
    arrival = {}
    for step in range(240):
        cuda_step.plain_step(model, state)
        for col in (30, 90):
            if col not in arrival and float(state["V"][8, col]) > -40.0:
                arrival[col] = step
        if len(arrival) == 2:
            break
    cv = 60.0 / ((arrival[90] - arrival[30]) * model.dt_per_step
                 * model.cfg.dt)
    assert cv == pytest.approx(1.714, rel=0.05)
