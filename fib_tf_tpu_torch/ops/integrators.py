"""Time integrators: explicit Euler, Adams-Bashforth-2 and Rush-Larsen
exponential gates, and the sign()-based step functions (port of
fib_tf_tpu/ops/integrators.py).

`rush_larsen` keeps the reference's implemented form
`clip(g + (g - g_inf) * expm1(-dt/tau), 1e-5, 0.99999)`, with the true
`torch.expm1` (the JAX package's Taylor substitute exists only because
Mosaic has no expm1).

`heaviside` / `heaviside_neg` keep the reference's sign() form, so
H(0) = G(0) = 0.5.  `torch.sign` returns 0 for NaN where `jnp.sign`
returns NaN, so the port's sign passes NaN through: a blow-up stays
visible to the engine's finiteness check.
"""

from __future__ import annotations

import torch

GATE_MIN = 0.00001
GATE_MAX = 0.99999


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """`num / t` as one IEEE division per element, as jnp computes it:
    torch evaluates a Python number over a tensor as `num * (1 / t)`,
    which rounds twice."""
    return torch.full_like(t, num) / t


def divide(num, den):
    """`num / den` as the reference's arithmetic: one IEEE division, also
    for a Python number over a tensor (rdiv); numpy and tensor operands
    divide as they are."""
    if isinstance(den, torch.Tensor) and not isinstance(num, torch.Tensor):
        return rdiv(num, den)
    return num / den


def euler(g: torch.Tensor, rate: torch.Tensor, dt: float) -> torch.Tensor:
    """Forward Euler step."""
    return g + rate * dt


def adams_bashforth2(g: torch.Tensor, rate: torch.Tensor,
                     rate_prev: torch.Tensor, dt: float) -> torch.Tensor:
    """Second-order Adams-Bashforth step g' = g + dt * (3/2 f_n - 1/2
    f_{n-1}), in the reference's order of operations (SimConfig.ab2)."""
    return g + dt * (1.5 * rate - 0.5 * rate_prev)


def rush_larsen(g: torch.Tensor, g_inf: torch.Tensor, g_tau: torch.Tensor,
                dt: float) -> torch.Tensor:
    """Rush-Larsen exponential integration of a gating variable."""
    return torch.clamp(
        g + (g - g_inf) * torch.expm1(rdiv(-dt, g_tau)), GATE_MIN, GATE_MAX
    )


def _sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) that returns NaN for NaN, as jnp.sign does."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """H(x) = (1 + sign(x)) / 2; H(0) = 0.5 (reference integrators.py:74-76)."""
    return (1.0 + _sign(x)) * 0.5


def heaviside_neg(x: torch.Tensor) -> torch.Tensor:
    """G(x) = (1 - sign(x)) / 2; G(0) = 0.5 (reference integrators.py:79-81)."""
    return (1.0 - _sign(x)) * 0.5
