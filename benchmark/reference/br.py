"""Plain reference of the modified Beeler-Reuter model (Beeler and Reuter,
J Physiol 1977;268:177-210) as the configuration runs it: eight planes,
the d/f rate prefactors doubled, Chebyshev fits (degree 8 on [-90, 30] mV)
of each gate's steady state and of its Rush-Larsen multiplier
expm1(-dt_g / tau(V)) folded at the gate's step, Chebyshev fits of the
V-only currents (iK1 and ix1's voltage factor), the currents taken with
the gates before the update, V clipped to [-85, 25] mV.  With `skip` an
outer step is one substep that advances the slow gates (x1, j, d, f) by
5 dt and four that hold them; without, five substeps of dt each.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from reference.common import (GridModel, State, chain_sum, no_flux_border,
                              power_basis_fit, power_chain)

MIN_V, MAX_V = -90.0, 30.0
DEG = 8
SUBSTEPS = 5
DT_PER_STEP = SUBSTEPS   # substeps of dt in one outer step
FAST, SLOW = ("m", "h"), ("x1", "j", "d", "f")
GATE_LO, GATE_HI = 1e-5, 0.99999
# rate(V) = (c0 exp(c1 (V + c2)) + c3 (V + c4)) / (exp(c5 (V + c2)) + c6)
RATES = {
    "x1": ((0.0005, 0.083, 50.0, 0.0, 0.0, 0.057, 1.0),
           (0.0013, -0.06, 20.0, 0.0, 0.0, -0.04, 1.0)),
    "m": ((0.0, 0.0, 47.0, -1.0, 47.0, -0.1, -1.0),
          (40.0, -0.056, 72.0, 0.0, 0.0, 0.0, 0.0)),
    "h": ((0.126, -0.25, 77.0, 0.0, 0.0, 0.0, 0.0),
          (1.7, 0.0, 22.5, 0.0, 0.0, -0.082, 1.0)),
    "j": ((0.055, -0.25, 78.0, 0.0, 0.0, -0.2, 1.0),
          (0.3, 0.0, 32.0, 0.0, 0.0, -0.1, 1.0)),
    "d": ((0.19, -0.01, -5.0, 0.0, 0.0, -0.072, 1.0),
          (0.14, -0.017, 44.0, 0.0, 0.0, 0.05, 1.0)),
    "f": ((0.024, -0.008, 28.0, 0.0, 0.0, 0.15, 1.0),
          (0.013, -0.02, 30.0, 0.0, 0.0, -0.2, 1.0)),
}
REST = {"V": -84.624, "C": 1e-4, "m": 0.01, "h": 0.988, "j": 0.975,
        "d": 0.003, "f": 0.994, "x1": 0.0001}


def rate(v: np.ndarray, c) -> np.ndarray:
    return ((c[0] * np.exp(c[1] * (v + c[2])) + c[3] * (v + c[4]))
            / (np.exp(c[5] * (v + c[2])) + c[6]))


def fits(dt: float, slow_n: int) -> Dict[str, np.ndarray]:
    """The fitted curves, keyed <gate>_inf, <gate>_r (the folded
    multiplier), i_k1 and i_x1f."""
    v = np.linspace(MIN_V, MAX_V, 1001)
    out = {}
    for g, (ca, cb) in RATES.items():
        a, b = rate(v, ca), rate(v, cb)
        n = 1 if g in FAST else slow_n
        out[g + "_inf"] = power_basis_fit(v, a / (a + b), DEG)
        out[g + "_r"] = power_basis_fit(v, np.expm1(-dt * n * (a + b)), DEG)
    i_k1 = 0.35 * (4.0 * (np.exp(0.04 * (v + 85.0)) - 1.0)
                   / (np.exp(0.08 * (v + 53.0)) + np.exp(0.04 * (v + 53.0)))
                   + 0.2 * (v + 23.0) / (1.0 - np.exp(-0.04 * (v + 23.0))))
    i_x1f = 0.8 * (np.exp(0.04 * (v + 77.0)) - 1.0) / np.exp(0.04 * (v + 35.0))
    out["i_k1"] = power_basis_fit(v, i_k1, DEG)
    out["i_x1f"] = power_basis_fit(v, i_x1f, DEG)
    return out


def initial_state(height: int, width: int) -> Dict[str, np.ndarray]:
    """The resting planes with the S1 stripe: column 1 at +10 mV."""
    st = {k: np.full((height, width), v, np.float32) for k, v in REST.items()}
    st["V"][:, 1] = 10.0
    return st


class Model(GridModel):
    min_v, max_v = MIN_V, MAX_V

    def __init__(self, sim: Mapping, height: int, width: int, phase,
                 device, dtype=torch.float32):
        super().__init__(sim, height, width, phase, device, dtype)
        if not (sim.get("cheby") and sim.get("skip")):
            raise ValueError("the BR reference covers cheby + skip")
        self.dt, self.diff = float(sim["dt"]), float(sim["diff"])
        self.coef = fits(self.dt, SUBSTEPS)

    def substep(self, s: State, slow: bool) -> State:
        v = no_flux_border(s["V"])
        x = (v - 0.5 * (MAX_V + MIN_V)) / (0.5 * (MAX_V - MIN_V))
        chain = power_chain(x, DEG)
        out = dict(s)
        for g in FAST + (SLOW if slow else ()):
            inf = chain_sum(self.coef[g + "_inf"], chain)
            r = chain_sum(self.coef[g + "_r"], chain)
            out[g] = torch.clamp(s[g] + (s[g] - inf) * r, GATE_LO, GATE_HI)
        i_k1 = chain_sum(self.coef["i_k1"], chain)
        i_x1 = s["x1"] * chain_sum(self.coef["i_x1f"], chain)
        i_na = (4.0 * s["m"] ** 3 * s["h"] * s["j"] + 0.005) * (v - 50.0)
        e_ca = -82.3 - 13.0278 * torch.log(s["C"])
        i_ca = 0.09 * s["d"] * s["f"] * (v - e_ca)
        dt = self.dt
        out["V"] = torch.clamp(
            v + self.diff * dt * self.lap(v)
            - dt * (i_k1 + i_x1 + i_na + i_ca), -85.0, 25.0)
        out["C"] = s["C"] + dt * (-1e-7 * i_ca + 0.07 * (1e-7 - s["C"]))
        return out

    def outer_step(self, state: State) -> State:
        for k in range(SUBSTEPS):
            state = self.substep(state, slow=k == 0)
        return state
