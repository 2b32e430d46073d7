"""The modified 8-variable Beeler-Reuter ventricular model (port of
fib_tf_tpu/models/beeler_reuter.py).

Beeler GW, Reuter H. "Reconstruction of the action potential of ventricular
myocardial fibres." J Physiol. 1977;268:177-210.

Eight planes: V (diffusing), Ca concentration C, and six gates (m, h, j,
d, f, x1).  Every variant of the reference runs:
  * gates: the folded Chebyshev multiplier (`cheby` + `cheby_fold`), the
    unfolded fits with Rush-Larsen (`cheby` alone), or the direct rates
    (`cheby=False`, Table 1's first two rows);
  * the V-only currents (iK1, ix1's voltage factor): Chebyshev fits
    (`cheby` + `cheby_currents`), one shared exp(0.04 V)
    (`fast_currents`), or the five literal exponentials;
  * `skip`: the slow gates advance 5 dt once per outer step;
  * `ab2`: Adams-Bashforth-2 on V and C, with the derivative planes
    `_dV_` and `_dC_` carried in the state.
Only `adaptive_dv` raises, until ROADMAP Queue 1 item 15 ports it.

Quirks kept from the reference: currents use the PRE-update gates; V is
clipped to [-85, 25] every substep; the d/f rate prefactors are doubled;
S1 sets column 1 to +10 mV; the fold bakes the slow gates' 5*dt under
`skip`, so `solve` raises when driven with another `n`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.models.base import (Geometry, IonicModel,
                                          SkipSchedule, State)
from fib_tf_tpu_torch.ops.chebyshev import (
    chebyshev_eval,
    chebyshev_fit,
    chebyshev_terms,
    normalize_voltage,
)
from fib_tf_tpu_torch.ops.integrators import (GATE_MAX, GATE_MIN,
                                               adams_bashforth2, rdiv,
                                               rush_larsen)
from fib_tf_tpu_torch.unported import not_ported

GATES = ("x1", "m", "h", "j", "d", "f")
FAST_GATES = ("m", "h")
SLOW_GATES = ("x1", "j", "d", "f")

# rate(V) = (c0*exp(c1*(V+c2)) + c3*(V+c4)) / (exp(c5*(V+c2)) + c6),
# keyed by (gate, alpha|beta); a copy of the JAX model's table (pinned
# equal by tests/test_torch_br.py).  The d/f prefactors carry the x2
# spiral modification.
RATE_PARAMS: Dict[Tuple[str, str], Tuple[float, ...]] = {
    ("x1", "a"): (0.0005, 0.083, 50.0, 0.0, 0.0, 0.057, 1.0),
    ("x1", "b"): (0.0013, -0.06, 20.0, 0.0, 0.0, -0.04, 1.0),
    ("m", "a"): (0.0, 0.0, 47.0, -1.0, 47.0, -0.1, -1.0),
    ("m", "b"): (40.0, -0.056, 72.0, 0.0, 0.0, 0.0, 0.0),
    ("h", "a"): (0.126, -0.25, 77.0, 0.0, 0.0, 0.0, 0.0),
    ("h", "b"): (1.7, 0.0, 22.5, 0.0, 0.0, -0.082, 1.0),
    ("j", "a"): (0.055, -0.25, 78.0, 0.0, 0.0, -0.2, 1.0),
    ("j", "b"): (0.3, 0.0, 32.0, 0.0, 0.0, -0.1, 1.0),
    ("d", "a"): (2 * 0.095, -0.01, -5.0, 0.0, 0.0, -0.072, 1.0),
    ("d", "b"): (2 * 0.07, -0.017, 44.0, 0.0, 0.0, 0.05, 1.0),
    ("f", "a"): (2 * 0.012, -0.008, 28.0, 0.0, 0.0, 0.15, 1.0),
    ("f", "b"): (2 * 0.0065, -0.02, 30.0, 0.0, 0.0, -0.2, 1.0),
}

CHEBY_DEG = 8
CHEBY_SAMPLES = 1001

# membrane constants
G_S = 0.09
G_NA = 4.0
G_NAC = 0.005
E_NA = 50.0
C_M = 1.0
V_CLIP_LO = -85.0
V_CLIP_HI = 25.0


def rate_np(v: np.ndarray, c: Tuple[float, ...]) -> np.ndarray:
    """Numpy evaluation of the rate parameterization (definition time)."""
    v = np.asarray(v, dtype=np.float64)
    return (c[0] * np.exp(c[1] * (v + c[2])) + c[3] * (v + c[4])) / (
        np.exp(c[5] * (v + c[2])) + c[6]
    )


def rate_torch(v: torch.Tensor, c: Tuple[float, ...]) -> torch.Tensor:
    """The rate on a float32 tensor, for the direct (non-Chebyshev) gates:
    rate_jnp's form, the linear term left out when c3 == 0.  Kept literal
    at alpha_m's removable singularity (V = -47 mV, c3 = c6 = -1)."""
    if c[3] == 0:
        return (c[0] * torch.exp(c[1] * (v + c[2]))) / (
            torch.exp(c[5] * (v + c[2])) + c[6]
        )
    return (c[0] * torch.exp(c[1] * (v + c[2])) + c[3] * (v + c[4])) / (
        torch.exp(c[5] * (v + c[2])) + c[6]
    )


# the shared-exponential currents' constants (k = exp(0.04 V)), computed in
# double as the reference does
FAST_CURRENTS: Dict[str, float] = {
    "a85": float(np.exp(0.04 * 85.0)),
    "a53b": float(np.exp(0.08 * 53.0)),
    "a53": float(np.exp(0.04 * 53.0)),
    "a23": float(np.exp(-0.04 * 23.0)),
    "a77": float(np.exp(0.04 * 77.0)),
    "a35": float(np.exp(0.04 * 35.0)),
}


def _check_variant(cfg: SimConfig):
    """Reject the one BR variant the port does not carry yet."""
    if cfg.adaptive_dv is not None:
        not_ported("adaptive_dv", "adaptive")


class BeelerReuter(SkipSchedule, IonicModel):
    name = "br"
    min_v = -90.0
    max_v = 30.0
    depol = -84.6
    dt_per_step = 5
    pot_key = "V"
    SCALE_PARAMS = ("g_Na", "g_NaC", "g_s", "g_K1", "g_x1")

    def __init__(self, cfg: SimConfig):
        _check_variant(cfg)
        super().__init__(cfg)
        # float64 coefficients in the S basis, keyed like the JAX model's
        # `_cheby_coef` (interop.cheby_coef_from_numpy replaces them);
        # empty with direct rates
        self.cheby_coef: Dict[str, np.ndarray] = (
            self._fit_chebyshev() if cfg.cheby else {})

    def _fit_chebyshev(self) -> Dict[str, np.ndarray]:
        """inf(V) and tau(V) of each gate, with `cheby_fold` the folded
        multiplier r(V) = expm1(-dt_g/tau(V)), and with `cheby_currents`
        the V-only currents, fitted on [min_v, max_v] with the JAX model's
        arithmetic."""
        v = np.linspace(self.min_v, self.max_v, CHEBY_SAMPLES)
        coef = {}
        for g in GATES:
            a = rate_np(v, RATE_PARAMS[(g, "a")])
            b = rate_np(v, RATE_PARAMS[(g, "b")])
            tau = 1.0 / (a + b)
            coef[f"{g}_inf"] = chebyshev_fit(v, a / (a + b), CHEBY_DEG)
            coef[f"{g}_tau"] = chebyshev_fit(v, tau, CHEBY_DEG)
            if self.cfg.cheby_fold:
                n = 1 if g in FAST_GATES else self.slow_n
                r = np.expm1(-(self.cfg.dt * n) / tau)
                coef[f"{g}_rl"] = chebyshev_fit(v, r, CHEBY_DEG)
        if self.cfg.cheby_currents:
            i_k1 = 0.35 * (
                4.0 * (np.exp(0.04 * (v + 85.0)) - 1.0)
                / (np.exp(0.08 * (v + 53.0)) + np.exp(0.04 * (v + 53.0)))
                + 0.2 * ((v + 23.0) / (1.0 - np.exp(-0.04 * (v + 23.0))))
            )
            i_x1f = (
                0.8 * (np.exp(0.04 * (v + 77.0)) - 1.0)
                / np.exp(0.04 * (v + 35.0))
            )
            coef["i_k1"] = chebyshev_fit(v, i_k1, CHEBY_DEG)
            coef["i_x1f"] = chebyshev_fit(v, i_x1f, CHEBY_DEG)
        return coef

    # -- the variant ----------------------------------------------------------

    @property
    def gate_mode(self) -> str:
        """'fold', 'cheby' (unfolded fits) or 'direct'."""
        if not self.cfg.cheby:
            return "direct"
        return "fold" if self.cfg.cheby_fold else "cheby"

    @property
    def current_mode(self) -> str:
        """'cheby', 'fast' or 'plain': the form of iK1 and ix1's voltage
        factor."""
        if self.cfg.cheby and self.cfg.cheby_currents:
            return "cheby"
        return "fast" if self.cfg.fast_currents else "plain"

    @property
    def ill_conditioned(self) -> tuple:
        """alpha_m's removable singularity at -47 mV (direct rates; 0/0 on
        V = -47.0 exactly), iK1's at -23 mV (the shared-exponential and
        literal currents), and where the unfolded fit of tau_h is negative,
        [-88.0, -83.9] mV around rest: there g + (g - inf) expm1(-dt / tau)
        multiplies a gate's rounding by up to exp(dt / |tau|) a substep."""
        windows = []
        if self.gate_mode == "direct":
            windows.append((-47.0, -47.0))
        if self.current_mode != "cheby":
            windows.append((-23.0, -23.0))
        if self.gate_mode == "cheby":
            windows.append((-88.0, -83.9))
        return tuple(windows)

    # -- state --------------------------------------------------------------

    def state_keys(self):
        base = ("C", "V", "d", "f", "h", "j", "m", "x1")
        if self.cfg.ab2:
            return tuple(sorted(base + ("_dV_", "_dC_")))
        return base

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """Resting state with the S1 stripe (column 1 at +10 mV); with
        ab2, the derivative planes bootstrapped from it."""
        v = self._full(-84.624)
        if s1:
            v[:, 1] = 10.0
        st = {
            "V": v,
            "C": self._full(1e-4),
            "m": self._full(0.01),
            "h": self._full(0.988),
            "j": self._full(0.975),
            "d": self._full(0.003),
            "f": self._full(0.994),
            "x1": self._full(0.0001),
        }
        if self.cfg.ab2:
            st = self.bootstrap_ab2(st)
        return st

    def _ab2_rates(self, state: State) -> State:
        """The AB2 derivative planes of `state` from the reaction alone:
        the pacing refresh and `bootstrap_ab2` use it."""
        v, c = state["V"], state["C"]
        i_k1, i_x1, i_na, i_ca = self.currents(v, c, state)
        return {
            "_dV_": -(i_k1 + i_x1 + i_na + i_ca) / C_M,
            "_dC_": -1.0e-7 * i_ca + 0.07 * (1.0e-7 - c),
        }

    def bootstrap_ab2(self, state: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """(Re)build the AB2 derivative planes of a numpy state: f_{-1} :=
        the reaction derivative of `state`.  Call after mutating a state
        by hand or when resuming an Euler state into an ab2 model."""
        st = dict(state)
        rates = self._ab2_rates({
            k: torch.tensor(np.asarray(st[k], np.float32))
            for k in ("V", "C") + GATES})
        st.update({k: v.numpy() for k, v in rates.items()})
        return st

    # -- dynamics -------------------------------------------------------------

    def _terms(self, v0):
        """The shared Chebyshev leading-term chain of a substep."""
        return chebyshev_terms(
            normalize_voltage(v0, self.min_v, self.max_v), CHEBY_DEG)

    def _advance(self, state: State, gate: str, n: int, v0,
                 terms) -> torch.Tensor:
        """Gate `gate` advanced by dt*n in the configured form."""
        g = state[gate]
        mode = self.gate_mode
        if mode == "fold":
            # g' = clip(g + (g - g_inf) * r(V)), r baked at definition
            baked = 1 if gate in FAST_GATES else self.slow_n
            if n != baked:
                raise ValueError(
                    f"cheby_fold baked dt*{baked} for gate {gate!r} but "
                    f"solve was driven with n={n}; drive the model through "
                    f"step()")
            inf = chebyshev_eval(self.cheby_coef[f"{gate}_inf"], terms)
            r = chebyshev_eval(self.cheby_coef[f"{gate}_rl"], terms)
            return torch.clamp(g + (g - inf) * r, GATE_MIN, GATE_MAX)
        if mode == "cheby":
            inf = chebyshev_eval(self.cheby_coef[f"{gate}_inf"], terms)
            tau = chebyshev_eval(self.cheby_coef[f"{gate}_tau"], terms)
        else:
            a = rate_torch(v0, RATE_PARAMS[(gate, "a")])
            b = rate_torch(v0, RATE_PARAMS[(gate, "b")])
            inf, tau = a / (a + b), 1.0 / (a + b)
        return rush_larsen(g, inf, tau, self.cfg.dt * n)

    def currents(self, v0, c, gates, terms=None):
        """The four membrane currents (iK1, ix1, iNa, iCa), the V-only
        parts in the configured form."""
        mode = self.current_mode
        x1 = gates["x1"]
        if mode == "cheby":
            if terms is None:
                terms = self._terms(v0)
            i_k1 = chebyshev_eval(self.cheby_coef["i_k1"], terms)
            i_x1 = x1 * chebyshev_eval(self.cheby_coef["i_x1f"], terms)
        elif mode == "fast":
            k = torch.exp(0.04 * v0)
            a = FAST_CURRENTS
            i_k1 = 0.35 * (
                4.0 * (a["a85"] * k - 1.0) / (a["a53b"] * k * k + a["a53"] * k)
                + 0.2 * ((v0 + 23.0) / (1.0 - rdiv(a["a23"], k)))
            )
            i_x1 = x1 * 0.8 * (a["a77"] * k - 1.0) / (a["a35"] * k)
        else:
            i_k1 = 0.35 * (
                4.0 * (torch.exp(0.04 * (v0 + 85.0)) - 1.0)
                / (torch.exp(0.08 * (v0 + 53.0))
                   + torch.exp(0.04 * (v0 + 53.0)))
                + 0.2 * ((v0 + 23.0)
                         / (1.0 - torch.exp(-0.04 * (v0 + 23.0))))
            )
            i_x1 = (x1 * 0.8 * (torch.exp(0.04 * (v0 + 77.0)) - 1.0)
                    / torch.exp(0.04 * (v0 + 35.0)))
        i_k1 = self.gscale("g_K1", i_k1)
        i_x1 = self.gscale("g_x1", i_x1)
        m = gates["m"]
        i_na = (
            self.gscale("g_Na", G_NA) * (m * m * m) * gates["h"] * gates["j"]
            + self.gscale("g_NaC", G_NAC)
        ) * (v0 - E_NA)
        e_ca = -82.3 - 13.0278 * torch.log(c)
        i_ca = self.gscale("g_s", G_S) * gates["d"] * gates["f"] * (v0 - e_ca)
        return i_k1, i_x1, i_na, i_ca

    def solve(self, state: State, geom: Geometry, n: int = 1) -> State:
        """One substep; `n` is how many dt the slow gates advance (0 =
        frozen, the multi-rate trick).  Returns a new state dict."""
        dt = self.cfg.dt
        v0 = geom.enforce_boundary(state["V"])
        terms = self._terms(v0) if self.cfg.cheby else None
        out = {g: self._advance(state, g, 1, v0, terms) for g in FAST_GATES}
        for g in SLOW_GATES:
            out[g] = (self._advance(state, g, n, v0, terms) if n > 0
                      else state[g])
        # currents use the PRE-update gates (load-bearing, ~0.4 mV/AP)
        i_k1, i_x1, i_na, i_ca = self.currents(v0, state["C"], state, terms)
        i_sum = i_k1 + i_x1 + i_na + i_ca
        c = state["C"]
        if not self.cfg.ab2:
            out["V"] = torch.clamp(
                v0 + self.cfg.diff * dt * geom.laplace(v0) - dt * i_sum / C_M,
                V_CLIP_LO, V_CLIP_HI,
            )
            out["C"] = c + dt * (-1.0e-7 * i_ca + 0.07 * (1.0e-7 - c))
            return out
        # Adams-Bashforth-2 on V and C; the gates keep Rush-Larsen
        g_v = self.cfg.diff * geom.laplace(v0) - i_sum / C_M
        g_c = -1.0e-7 * i_ca + 0.07 * (1.0e-7 - c)
        v1_raw = adams_bashforth2(v0, g_v, state["_dV_"], dt)
        v1 = torch.clamp(v1_raw, V_CLIP_LO, V_CLIP_HI)
        # where the clip fired, the history describes the clipped
        # trajectory: the effective derivative (v1 - v0) / dt
        out["V"] = v1
        out["C"] = adams_bashforth2(c, g_c, state["_dC_"], dt)
        out["_dV_"] = torch.where(v1 == v1_raw, g_v, (v1 - v0) / dt)
        out["_dC_"] = g_c
        return out
