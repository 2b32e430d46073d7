"""The Cherry-Ehrlich-Nattel-Fenton 4-variable left-atrial model (port of
fib_tf_tpu/models/fenton.py).

Cherry EM, Ehrlich JR, Nattel S, Fenton FH. "Pulmonary vein reentry —
properties and size matter: insights from a computational analysis."
Heart Rhythm. 2007 Dec;4(12):1553-62.

Four planes: u (diffusing) and the local gates v, w, s.  Ten substeps make
one outer step, so at dt = 0.1 ms an outer step is 1 ms.

Quirks kept from the reference:
  * step functions via sign(): H(0) = G(0) = 0.5 (ops/integrators.py);
  * the rates are evaluated on the RAW u, the diffusion on the
    boundary-enforced u0: u' = u0 + dt*du(u) + diff*dt*lap(u0);
  * S1 is a one-pixel stripe at column 1.

With `cfg.ab2`, all four planes take Adams-Bashforth-2 steps and the
state carries their previous derivatives `_du_`, `_dv_`, `_dw_` and
`_ds_` (u's with its diffusion term).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.models.base import (Geometry, IonicModel, State,
                                          check_unported)
from fib_tf_tpu_torch.ops.integrators import (adams_bashforth2, heaviside,
                                               heaviside_neg)

# Cherry et al. 2007, left-atrial parameter set: a copy of the JAX model's
# constants (pinned equal by tests/test_torch_fenton.py)
TAU_V_PLUS = 3.33
TAU_V_MINUS = 19.2
TAU_W_PLUS = 160.0
TAU_W_MINUS_1 = 75.0
TAU_W_MINUS_2 = 75.0
TAU_D = 0.065
TAU_SI = 31.8364
TAU_SO = TAU_SI
TAU_A = 0.009
U_C = 0.23
U_W = 0.146
U_0 = 0.0
U_M = 1.0
U_CSI = 0.8
U_SO = 0.3
R_S_PLUS = 0.02
R_S_MINUS = 1.2
K_S = 3.0
A_SO = 0.115
B_SO = 0.84
C_SO = 0.02


class Fenton4v(IonicModel):
    name = "fenton"
    # the three phenomenological currents: g_fi the fast inward (Na
    # analog), g_si the slow inward (Ca analog), g_so the slow outward
    # (K analog)
    SCALE_PARAMS = ("g_fi", "g_si", "g_so")
    min_v = 0.0
    max_v = 1.0
    depol = 0.0
    dt_per_step = 10
    pot_key = "u"

    def __init__(self, cfg: SimConfig):
        check_unported(cfg)
        super().__init__(cfg)

    def state_keys(self):
        base = ("s", "u", "v", "w")
        if self.cfg.ab2:
            return tuple(sorted(base + ("_du_", "_dv_", "_dw_", "_ds_")))
        return base

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """(u, v, w, s) = (0, 1, 1, 0) with an S1 stripe u[:, 1] = 1; with
        ab2, the derivative planes bootstrapped from it."""
        u = self._full(0.0)
        if s1:
            u[:, 1] = 1.0
        st = {
            "u": u,
            "v": self._full(1.0),
            "w": self._full(1.0),
            "s": self._full(0.0),
        }
        if self.cfg.ab2:
            st = self.bootstrap_ab2(st)
        return st

    def _ab2_rates(self, state: State) -> State:
        """The AB2 derivative planes of `state` from the reaction alone:
        the pacing refresh and `bootstrap_ab2` use it."""
        du, dv, dw, ds = self.differentiate(
            state["u"], state["v"], state["w"], state["s"])
        return {"_du_": du, "_dv_": dv, "_dw_": dw, "_ds_": ds}

    def bootstrap_ab2(self, state: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """(Re)build the AB2 derivative planes of a numpy state: f_{-1} :=
        the reaction derivative of `state`.  Call after mutating a state
        by hand or when resuming an Euler state into an ab2 model."""
        st = dict(state)
        rates = self._ab2_rates({
            k: torch.tensor(np.asarray(st[k], np.float32))
            for k in ("u", "v", "w", "s")})
        st.update({k: v.numpy() for k, v in rates.items()})
        return st

    def differentiate(self, u, v, w, s):
        """Pointwise currents and gate right-hand sides."""
        i_fi = self.gscale(
            "g_fi", -v * heaviside(u - U_C) * (u - U_C) * (U_M - u) / TAU_D)
        i_si = self.gscale("g_si", -w * s / TAU_SI)
        i_so = self.gscale("g_so", (
            0.5 * (A_SO - TAU_A) * (1.0 + torch.tanh((u - B_SO) / C_SO))
            + (u - U_0) * heaviside_neg(u - U_SO) / TAU_SO
            + heaviside(u - U_SO) * TAU_A
        ))

        du = -(i_fi + i_si + i_so)
        dv = torch.where(u > U_C, -v / TAU_V_PLUS, (1.0 - v) / TAU_V_MINUS)
        dw = torch.where(
            u > U_C,
            -w / TAU_W_PLUS,
            torch.where(u > U_W, (1.0 - w) / TAU_W_MINUS_2,
                        (1.0 - w) / TAU_W_MINUS_1),
        )
        r_s = (R_S_PLUS - R_S_MINUS) * heaviside(u - U_C) + R_S_MINUS
        ds = r_s * (0.5 * (1.0 + torch.tanh((u - U_CSI) * K_S)) - s)
        return du, dv, dw, ds

    def solve(self, state: State, geom: Geometry) -> State:
        """One substep, explicit Euler or (`cfg.ab2`) Adams-Bashforth-2:
        rates from the raw u, diffusion from u0 = enforce_boundary(u)."""
        u, v, w, s = state["u"], state["v"], state["w"], state["s"]
        dt = self.cfg.dt
        u0 = geom.enforce_boundary(u)
        du, dv, dw, ds = self.differentiate(u, v, w, s)
        if not self.cfg.ab2:
            return {
                "u": u0 + dt * du + self.cfg.diff * dt * geom.laplace(u0),
                "v": v + dt * dv,
                "w": w + dt * dw,
                "s": s + dt * ds,
            }
        gu = du + self.cfg.diff * geom.laplace(u0)
        return {
            "u": adams_bashforth2(u0, gu, state["_du_"], dt),
            "v": adams_bashforth2(v, dv, state["_dv_"], dt),
            "w": adams_bashforth2(w, dw, state["_dw_"], dt),
            "s": adams_bashforth2(s, ds, state["_ds_"], dt),
            "_du_": gu,
            "_dv_": dv,
            "_dw_": dw,
            "_ds_": ds,
        }
