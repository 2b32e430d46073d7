"""Time integrators: explicit Euler and Rush-Larsen exponential gates
(port of fib_tf_tpu/ops/integrators.py).

`rush_larsen` keeps the reference's implemented form
`clip(g + (g - g_inf) * expm1(-dt/tau), 1e-5, 0.99999)`, with the true
`torch.expm1` (the JAX package's Taylor substitute exists only because
Mosaic has no expm1).
"""

from __future__ import annotations

import torch

GATE_MIN = 0.00001
GATE_MAX = 0.99999


def euler(g: torch.Tensor, rate: torch.Tensor, dt: float) -> torch.Tensor:
    """Forward Euler step."""
    return g + rate * dt


def rush_larsen(g: torch.Tensor, g_inf: torch.Tensor, g_tau: torch.Tensor,
                dt: float) -> torch.Tensor:
    """Rush-Larsen exponential integration of a gating variable."""
    return torch.clamp(
        g + (g - g_inf) * torch.expm1(-dt / g_tau), GATE_MIN, GATE_MAX
    )
