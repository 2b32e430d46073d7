"""The port's grid operators, Chebyshev fits and integrators held against
fib_tf_tpu's (same numpy inputs from a seed into both packages)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fib_tf_tpu.models.beeler_reuter import RATE_PARAMS, rate_np
from fib_tf_tpu.ops import chebyshev as jcheb
from fib_tf_tpu.ops import integrators as jint
from fib_tf_tpu.ops import stencil as jst
from fib_tf_tpu_torch.ops import chebyshev as tcheb
from fib_tf_tpu_torch.ops import integrators as tint
from fib_tf_tpu_torch.ops import stencil as tst
from test_torch_fixtures import one_torch_thread  # noqa: F401

SHAPES = [(4, 4), (5, 7), (32, 48)]
TOL = dict(rtol=1e-6, atol=1e-6)   # elementwise, as tests/test_pallas.py


def _plane(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_laplace_matches_jax(shape):
    x = _plane(shape, 0)
    np.testing.assert_allclose(
        tst.laplace(torch.from_numpy(x)).numpy(),
        np.asarray(jst.laplace(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_enforce_boundary_matches_jax(shape):
    x = _plane(shape, 1)
    np.testing.assert_array_equal(
        tst.enforce_boundary(torch.from_numpy(x)).numpy(),
        np.asarray(jst.enforce_boundary(jnp.asarray(x))))


def _clamp_laplace(v):
    """The kernel's indexing: v0 at stencil point (i+di, j+dj) is
    V[clamp(i+di), clamp(j+dj)] with clamp(k) = min(max(k, 1), N-2)."""
    h, w = v.shape
    r, c = np.arange(h), np.arange(w)

    def at(di, dj):
        return v[np.clip(r + di, 1, h - 2)][:, np.clip(c + dj, 1, w - 2)]

    return (at(-1, 0) + at(1, 0) + at(0, -1) + at(0, 1)
            + np.float32(0.5) * (at(-1, -1) + at(1, -1) + at(-1, 1)
                                 + at(1, 1))
            - np.float32(6.0) * at(0, 0))


@pytest.mark.parametrize("shape", SHAPES)
def test_clamp_index_identity(shape):
    """REFLECT laplace of the SYMMETRIC-enforced plane == the clamped
    9-point stencil the CUDA kernel reads, bit for bit."""
    v = _plane(shape, 2) * np.float32(100.0) - np.float32(85.0)
    want = np.asarray(jst.laplace(jst.enforce_boundary(jnp.asarray(v))))
    np.testing.assert_array_equal(_clamp_laplace(v), want)
    port = tst.laplace(tst.enforce_boundary(torch.from_numpy(v))).numpy()
    np.testing.assert_array_equal(port, want)


@pytest.mark.parametrize("loc", jst.PACE_LOCATIONS)
def test_pace_mask_matches_jax(loc):
    np.testing.assert_array_equal(
        tst.pace_mask(12, 10, loc, 10.0, -90.0),
        jst.pace_mask(12, 10, loc, 10.0, -90.0))


def test_pace_mask_rejects_unknown_location():
    with pytest.raises(ValueError):
        tst.pace_mask(8, 8, "center", 1.0, 0.0)


def test_apply_pace_matches_jax():
    pot = _plane((16, 16), 3) * np.float32(100.0) - np.float32(90.0)
    mask = tst.pace_mask(16, 16, "luq", 10.0, -90.0)
    np.testing.assert_array_equal(
        tst.apply_pace(torch.from_numpy(pot), torch.from_numpy(mask)).numpy(),
        np.asarray(jst.apply_pace(jnp.asarray(pot), jnp.asarray(mask))))


_V = np.linspace(-90.0, 30.0, 1001)


@pytest.mark.parametrize("y", [
    np.sin(_V / 17.0),
    np.exp(0.04 * (_V + 20.0)),
    rate_np(_V, RATE_PARAMS[("m", "a")]),
    1.0 / (rate_np(_V, RATE_PARAMS[("x1", "a")])
           + rate_np(_V, RATE_PARAMS[("x1", "b")])),
], ids=["sin", "exp", "m_alpha", "x1_tau"])
def test_chebyshev_fit_bit_equal(y):
    got = tcheb.chebyshev_fit(_V, y, 8)
    assert got.dtype == np.float64
    assert np.array_equal(got, jcheb.chebyshev_fit(_V, y, 8))


def test_chebyshev_terms_and_eval_match_jax():
    x = np.random.RandomState(4).uniform(-1, 1, (9, 13)).astype(np.float32)
    want = jcheb.chebyshev_terms(jnp.asarray(x), 8)
    got = tcheb.chebyshev_terms(torch.from_numpy(x), 8)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    d = tcheb.chebyshev_fit(_V, np.tanh(_V / 30.0), 8)
    np.testing.assert_allclose(
        tcheb.chebyshev_eval(d, got).numpy(),
        np.asarray(jcheb.chebyshev_eval(d, want)), **TOL)
    with pytest.raises(ValueError):
        tcheb.chebyshev_terms(torch.from_numpy(x), 1)


def test_normalize_voltage_matches_jax():
    v = _plane((6, 6), 5) * np.float32(120.0) - np.float32(90.0)
    np.testing.assert_array_equal(
        tcheb.normalize_voltage(torch.from_numpy(v), -90.0, 30.0).numpy(),
        np.asarray(jcheb.normalize_voltage(jnp.asarray(v), -90.0, 30.0)))


def test_rush_larsen_matches_jax():
    rng = np.random.RandomState(6)
    g = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    inf = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    tau = rng.uniform(0.2, 200.0, (16, 16)).astype(np.float32)
    got = tint.rush_larsen(torch.from_numpy(g), torch.from_numpy(inf),
                           torch.from_numpy(tau), 0.5).numpy()
    want = np.asarray(jint.rush_larsen(jnp.asarray(g), jnp.asarray(inf),
                                       jnp.asarray(tau), 0.5))
    np.testing.assert_allclose(got, want, **TOL)
    assert got.min() >= tint.GATE_MIN and got.max() <= tint.GATE_MAX
    assert (tint.GATE_MIN, tint.GATE_MAX) == (jint.GATE_MIN, jint.GATE_MAX)


def test_euler_matches_jax():
    g, r = _plane((5, 5), 7), _plane((5, 5), 8)
    np.testing.assert_allclose(
        tint.euler(torch.from_numpy(g), torch.from_numpy(r), 0.1).numpy(),
        np.asarray(jint.euler(jnp.asarray(g), jnp.asarray(r), 0.1)), **TOL)
