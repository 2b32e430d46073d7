"""The Luo-Rudy 1991 (phase-1) guinea-pig ventricular model (port of
fib_tf_tpu/models/luo_rudy.py).

Luo CH, Rudy Y. "A model of the ventricular cardiac action potential.
Depolarization, repolarization, and their interaction." Circ Res.
1991;68:1501-1526.

Eight planes: V (diffusing), intracellular calcium Cai and six
Hodgkin-Huxley gates (m, h, j, d, f, x), the gates on Rush-Larsen, V and
Cai on explicit Euler.  The model is stiff (g_Na = 23 mS/cm^2): dt above
`DT_MAX` raises.  `g_si` is an instance attribute that a caller may set
after construction (examples/lr1_spiral.py does): the kernels' parameter
block reads it when a step is built.

Multi-rate (`cfg.skip`): the Na gates m/h/j advance every substep; x/d/f
advance once per outer step by 10 dt (one `solve(n=10)`, then nine
`solve(n=0)`).  Without skip an outer step is ten `solve(n=1)`.
`adaptive_dv` raises until ROADMAP Queue 1 item 15 ports it.

Rates are direct, as the reference's: every Python number over a tensor is
one IEEE division (`divide`), as jnp computes it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.models.base import (Geometry, IonicModel,
                                          SkipSchedule, State,
                                          check_unported)
from fib_tf_tpu_torch.ops.integrators import divide, rush_larsen

GATES = ("m", "h", "j", "d", "f", "x")
FAST_GATES = ("m", "h", "j")
SLOW_GATES = ("x", "d", "f")

# -- membrane constants: a copy of the JAX model's (pinned equal by
# tests/test_torch_lr1.py) ---------------------------------------------------
RTF = 26.71          # RT/F at 310 K, mV
K_O, K_I = 5.4, 145.0    # mM
NA_O, NA_I = 140.0, 18.0  # mM
PR_NAK = 0.01833     # Na/K permeability ratio in E_K

E_NA = RTF * float(np.log(NA_O / NA_I))                      # +54.8 mV
E_K = RTF * float(np.log((K_O + PR_NAK * NA_O) / (K_I + PR_NAK * NA_I)))
E_K1 = RTF * float(np.log(K_O / K_I))                        # -87.9 mV
E_KP = E_K1

G_NA = 23.0
G_SI = 0.09
G_K = 0.282 * float(np.sqrt(K_O / 5.4))
G_K1 = 0.6047 * float(np.sqrt(K_O / 5.4))
G_KP = 0.0183
G_B = 0.03921
E_B = -59.87
C_M = 1.0
# Xi's limit at its removable singularity V = -77 mV
XI_LIM = 2.837 * 0.04 * float(np.exp(1.68))

# explicit-Euler bound of the V update (the ~390 V/s upstroke)
DT_MAX = 0.05


def gate_rates(v, xp=torch, which=GATES):
    """Alpha/beta pairs of the requested gates (Luo & Rudy 1991, p. 1510),
    under torch (float32 planes) or numpy (float64, the initial state).
    alpha_m's removable singularity at V = -47.13 takes its limit 3.2;
    h and j branch at V = -40 mV with both branches evaluated."""
    out = {}
    if "m" in which:
        dm = v + 47.13
        a_m = xp.where(
            xp.abs(dm) < 1e-3, 3.2,
            0.32 * dm / (1.0 - xp.exp(-0.1 * dm)),
        )
        out["m"] = (a_m, 0.08 * xp.exp(-v / 11.0))

    if "h" in which or "j" in which:
        lo = v < -40.0
    if "h" in which:
        a_h = xp.where(lo, 0.135 * xp.exp(-(80.0 + v) / 6.8), 0.0)
        b_h = xp.where(
            lo,
            3.56 * xp.exp(0.079 * v) + 3.1e5 * xp.exp(0.35 * v),
            divide(1.0, 0.13 * (1.0 + xp.exp(-(v + 10.66) / 11.1))),
        )
        out["h"] = (a_h, b_h)
    if "j" in which:
        a_j = xp.where(
            lo,
            (-1.2714e5 * xp.exp(0.2444 * v)
             - 3.474e-5 * xp.exp(-0.04391 * v))
            * (v + 37.78) / (1.0 + xp.exp(0.311 * (v + 79.23))),
            0.0,
        )
        b_j = xp.where(
            lo,
            0.1212 * xp.exp(-0.01052 * v)
            / (1.0 + xp.exp(-0.1378 * (v + 40.14))),
            0.3 * xp.exp(-2.535e-7 * v) / (1.0 + xp.exp(-0.1 * (v + 32.0))),
        )
        out["j"] = (a_j, b_j)

    if "d" in which:
        a_d = 0.095 * xp.exp(-0.01 * (v - 5.0)) / (
            1.0 + xp.exp(-0.072 * (v - 5.0)))
        b_d = 0.07 * xp.exp(-0.017 * (v + 44.0)) / (
            1.0 + xp.exp(0.05 * (v + 44.0)))
        out["d"] = (a_d, b_d)
    if "f" in which:
        a_f = 0.012 * xp.exp(-0.008 * (v + 28.0)) / (
            1.0 + xp.exp(0.15 * (v + 28.0)))
        b_f = 0.0065 * xp.exp(-0.02 * (v + 30.0)) / (
            1.0 + xp.exp(-0.2 * (v + 30.0)))
        out["f"] = (a_f, b_f)
    if "x" in which:
        a_x = 0.0005 * xp.exp(0.083 * (v + 50.0)) / (
            1.0 + xp.exp(0.057 * (v + 50.0)))
        b_x = 0.0013 * xp.exp(-0.06 * (v + 20.0)) / (
            1.0 + xp.exp(-0.04 * (v + 20.0)))
        out["x"] = (a_x, b_x)
    return out


def xi_factor(v, xp=torch):
    """The time-independent inactivation factor Xi of I_K: for V > -100
    mV, 2.837 (e^{0.04(V+77)} - 1) / ((V+77) e^{0.04(V+35)}), else 1; at
    the removable V = -77 its limit 2.837 * 0.04 * e^{1.68}."""
    xi = xp.where(
        v > -100.0,
        2.837 * (xp.exp(0.04 * (v + 77.0)) - 1.0)
        / ((v + 77.0) * xp.exp(0.04 * (v + 35.0))),
        1.0,
    )
    return xp.where(xp.abs(v + 77.0) < 1e-3, XI_LIM, xi)


def k1_inf(v, xp=torch):
    """Steady-state activation of the inward rectifier I_K1 (an
    instantaneous gate)."""
    dv = v - E_K1
    a = divide(1.02, 1.0 + xp.exp(0.2385 * (dv - 59.215)))
    b = (
        0.49124 * xp.exp(0.08032 * (dv + 5.476))
        + xp.exp(0.06175 * (dv - 594.31))
    ) / (1.0 + xp.exp(-0.5143 * (dv + 4.753)))
    return a / (a + b)


class LuoRudy91(SkipSchedule, IonicModel):
    name = "lr1"
    min_v = -90.0
    max_v = 50.0
    depol = -84.5
    dt_per_step = 10
    pot_key = "V"
    default_dt = 0.02
    # the slow-inward conductance, per instance: the LR91 spiral literature
    # tunes it down from the paper's 0.09 (examples/lr1_spiral.py: 0.02)
    g_si = G_SI
    SCALE_PARAMS = ("g_Na", "g_si", "g_K", "g_K1", "g_Kp", "g_b")
    positive_states = ("Cai",)
    # where float32 is ill-conditioned, so that a kernel's and the plain
    # path's rounding may part past rtol/atol (tests and chip_smoke.py
    # arbitrate such cells in float64): alpha_m's removable singularity at
    # -47.13 mV and Xi's at -77 mV, each a difference over V minus its
    # pole
    ill_conditioned = ((-47.13, -47.13), (-77.0, -77.0))

    def __init__(self, cfg: SimConfig):
        check_unported(cfg)
        super().__init__(cfg)
        if cfg.dt > DT_MAX and cfg.adaptive_dv is None:
            raise ValueError(
                f"LuoRudy91 is explicit-Euler unstable at dt={cfg.dt} "
                f"(g_Na=23 gives ~390 V/s upstrokes); use dt <= {DT_MAX} "
                "(0.02 recommended) or enable adaptive_dv step-doubling"
            )

    @property
    def probe_pixel(self):
        """The reference's (20, width // 2), its row clamped to the grid as
        jnp indexing clamps it: tp06_transmural.py's 4-row strip reads its
        last row."""
        return (min(20, self.cfg.height - 1), self.cfg.width // 2)

    # -- state ----------------------------------------------------------------

    def state_keys(self):
        return ("Cai", "V", "d", "f", "h", "j", "m", "x")

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """Rest at V = -84.5 mV, [Ca]i = 2e-4 mM and the gates at their
        rest steady states (float64 rates); with `s1`, column 1 at +20
        mV."""
        v_rest = -84.5
        v = self._full(v_rest)
        if s1:
            v[:, 1] = 20.0
        st = {"V": v, "Cai": self._full(2e-4)}
        rates = gate_rates(np.float64(v_rest), xp=np)
        for g, (a, b) in rates.items():
            st[g] = self._full(float(a / (a + b)))
        return st

    # -- dynamics -------------------------------------------------------------

    def currents(self, v0, cai, gates):
        """The six membrane currents from the PRE-update gates: fast Na,
        slow inward (Ca), time-dependent K, K1, plateau K and
        background."""
        i_na = (self.gscale("g_Na", G_NA)
                * gates["m"] ** 3 * gates["h"] * gates["j"] * (v0 - E_NA))
        e_si = 7.7 - 13.0287 * torch.log(cai)
        i_si = (self.gscale("g_si", self.g_si)
                * gates["d"] * gates["f"] * (v0 - e_si))
        i_k = self.gscale("g_K", G_K) * gates["x"] * xi_factor(v0) * (v0 - E_K)
        i_k1 = self.gscale("g_K1", G_K1) * k1_inf(v0) * (v0 - E_K1)
        kp = 1.0 / (1.0 + torch.exp((7.488 - v0) / 5.98))
        i_kp = self.gscale("g_Kp", G_KP) * kp * (v0 - E_KP)
        i_b = self.gscale("g_b", G_B) * (v0 - E_B)
        return i_na, i_si, i_k, i_k1, i_kp, i_b

    def solve(self, state: State, geom: Geometry, n: int = 1) -> State:
        """One substep: Rush-Larsen on the gates, explicit Euler on V
        (reaction and diffusion) and on Cai.  `n` is how many dt the slow
        x/d/f gates advance (0: frozen); m/h/j always advance one dt."""
        dt = self.cfg.dt
        v0 = geom.enforce_boundary(state["V"])
        cai = state["Cai"]

        out = {}
        for g, (a, b) in gate_rates(v0, which=FAST_GATES).items():
            tau = 1.0 / (a + b)
            out[g] = rush_larsen(state[g], a * tau, tau, dt)
        if n > 0:
            for g, (a, b) in gate_rates(v0, which=SLOW_GATES).items():
                tau = 1.0 / (a + b)
                out[g] = rush_larsen(state[g], a * tau, tau, dt * n)
        else:
            for g in SLOW_GATES:
                out[g] = state[g]

        i_na, i_si, i_k, i_k1, i_kp, i_b = self.currents(v0, cai, state)
        i_sum = i_na + i_si + i_k + i_k1 + i_kp + i_b

        out["V"] = (
            v0 + self.cfg.diff * dt * geom.laplace(v0) - dt * i_sum / C_M
        )
        out["Cai"] = cai + dt * (-1e-4 * i_si + 0.07 * (1e-4 - cai))
        return out
