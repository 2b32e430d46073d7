"""The Mitchell-Schaeffer 2-variable model (port of
fib_tf_tpu/models/mitchell_schaeffer.py).

Mitchell CC, Schaeffer DG. "A two-current model for the dynamics of
cardiac membrane." Bull Math Biol. 2003 Sep;65(5):767-93.

Two planes: the normalized potential u (diffusing) and the recovery gate
h.  The inward current h*u^2*(1-u)/tau_in regenerates the upstroke, the
outward current u/tau_out repolarizes; h closes above the gate threshold
(tau_close) and reopens below it (tau_open).  The gate ODE is linear in h
on each side of the threshold, so its substep relaxes h EXACTLY, by the
factors exp(-dt/tau_open) and exp(-dt/tau_close); the model's own
closed-form relation APD_max = tau_close * ln(1/h_min) is
`apd_max_analytic`.

As in Fenton's model, the rates (and the gate's threshold test) take the
RAW u and the diffusion the boundary-enforced u0.  S1 is a 5-column
stripe.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.models.base import (Geometry, IonicModel, State,
                                          check_unported)

# Mitchell & Schaeffer 2003, Table 1: a copy of the JAX model's constants
# (pinned equal by tests/test_torch_ms.py)
TAU_IN = 0.3      # ms
TAU_OUT = 6.0     # ms
TAU_OPEN = 120.0  # ms
TAU_CLOSE = 150.0  # ms
U_GATE = 0.13     # dimensionless threshold


def apd_max_analytic() -> float:
    """Closed-form maximum APD (Mitchell & Schaeffer 2003 eqs. 11-13):
    h falls from 1 to h_min = 4*tau_in/tau_out during one AP and
    repolarization is h-limited, so APD_max = tau_close * ln(1/h_min)."""
    h_min = 4.0 * TAU_IN / TAU_OUT
    return TAU_CLOSE * float(np.log(1.0 / h_min))


def decay(dt: float, tau: float) -> float:
    """exp(-dt/tau) in float32, as the reference's substep computes it."""
    return float(torch.exp(torch.tensor(-dt / tau, dtype=torch.float32)))


class MitchellSchaeffer(IonicModel):
    name = "ms"
    # the two phenomenological currents (g_in = 1/tau_in inward, g_out =
    # 1/tau_out outward)
    SCALE_PARAMS = ("g_in", "g_out")
    min_v = 0.0
    max_v = 1.0
    depol = 0.0
    dt_per_step = 10
    pot_key = "u"

    def __init__(self, cfg: SimConfig):
        # the reference's model has no ab2 variant and ignores the flag
        check_unported(cfg)
        super().__init__(cfg)
        # the gate's exact one-substep factors, open and closing
        self.decay_open = decay(cfg.dt, TAU_OPEN)
        self.decay_close = decay(cfg.dt, TAU_CLOSE)

    def state_keys(self):
        return ("h", "u")

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """(u, h) = (0, 1), with an S1 stripe u[:, :5] = 1."""
        u = self._full(0.0)
        if s1:
            u[:, :5] = 1.0
        return {"u": u, "h": self._full(1.0)}

    def solve(self, state: State, geom: Geometry) -> State:
        """One substep: explicit Euler on u, exact relaxation of h."""
        u, h = state["u"], state["h"]
        dt = self.cfg.dt
        u0 = geom.enforce_boundary(u)

        j_in = self.gscale("g_in", h * u * u * (1.0 - u) / TAU_IN)
        j_out = self.gscale("g_out", -u / TAU_OUT)
        u1 = u0 + dt * (j_in + j_out) + self.cfg.diff * dt * geom.laplace(u0)

        h_open = 1.0 - (1.0 - h) * self.decay_open
        h_close = h * self.decay_close
        return {"u": u1, "h": torch.where(u < U_GATE, h_open, h_close)}
