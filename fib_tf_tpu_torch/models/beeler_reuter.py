"""The modified 8-variable Beeler-Reuter ventricular model (port of
fib_tf_tpu/models/beeler_reuter.py, main-path variants only).

Beeler GW, Reuter H. "Reconstruction of the action potential of ventricular
myocardial fibres." J Physiol. 1977;268:177-210.

Eight planes: V (diffusing), Ca concentration C, and six gates (m, h, j,
d, f, x1).  The slice supports the bench configuration: `cheby` with the
folded Rush-Larsen multiplier (`cheby_fold`) and Chebyshev-fitted V-only
currents (`cheby_currents`), with `skip` on or off.  Every other variant
raises until ROADMAP Queue 1 item 6 ports it.

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
from fib_tf_tpu_torch.models.base import Geometry, IonicModel, State
from fib_tf_tpu_torch.ops.chebyshev import (
    chebyshev_eval,
    chebyshev_fit,
    chebyshev_terms,
    normalize_voltage,
)
from fib_tf_tpu_torch.ops.integrators import GATE_MAX, GATE_MIN

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


def _check_variant(cfg: SimConfig):
    """Reject the BR variants the slice does not carry."""
    if cfg.adaptive_dv is not None:
        raise NotImplementedError(
            "adaptive_dv is not ported yet (ROADMAP Queue 1 item 15)")
    missing = [flag for flag in ("cheby", "cheby_fold", "cheby_currents")
               if not getattr(cfg, flag)]
    if missing or cfg.ab2:
        raise NotImplementedError(
            "the port runs Beeler-Reuter only with cheby + cheby_fold + "
            "cheby_currents and without ab2; direct rates, the unfolded "
            "fit, fast/plain currents and ab2 come with ROADMAP Queue 1 "
            "item 6")


class BeelerReuter(IonicModel):
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
        # dt multiple baked into the slow gates' folded fit
        self.slow_n = 5 if cfg.skip else 1
        # float64 coefficients in the S basis, keyed like the JAX model's
        # `_cheby_coef` (interop.cheby_coef_from_numpy replaces them)
        self.cheby_coef: Dict[str, np.ndarray] = self._fit_chebyshev()

    def _fit_chebyshev(self) -> Dict[str, np.ndarray]:
        """inf(V), tau(V) and the folded multiplier
        r(V) = expm1(-dt_g/tau(V)) of each gate, plus the V-only currents,
        fitted on [min_v, max_v] with the JAX model's arithmetic."""
        v = np.linspace(self.min_v, self.max_v, CHEBY_SAMPLES)
        coef = {}
        for g in GATES:
            a = rate_np(v, RATE_PARAMS[(g, "a")])
            b = rate_np(v, RATE_PARAMS[(g, "b")])
            tau = 1.0 / (a + b)
            coef[f"{g}_inf"] = chebyshev_fit(v, a / (a + b), CHEBY_DEG)
            coef[f"{g}_tau"] = chebyshev_fit(v, tau, CHEBY_DEG)
            n = 1 if g in FAST_GATES else self.slow_n
            r = np.expm1(-(self.cfg.dt * n) / tau)
            coef[f"{g}_rl"] = chebyshev_fit(v, r, CHEBY_DEG)
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

    # -- state --------------------------------------------------------------

    def state_keys(self):
        return ("C", "V", "d", "f", "h", "j", "m", "x1")

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """Resting state with the S1 stripe (column 1 at +10 mV)."""
        v = self._full(-84.624)
        if s1:
            v[:, 1] = 10.0
        return {
            "V": v,
            "C": self._full(1e-4),
            "m": self._full(0.01),
            "h": self._full(0.988),
            "j": self._full(0.975),
            "d": self._full(0.003),
            "f": self._full(0.994),
            "x1": self._full(0.0001),
        }

    # -- dynamics -------------------------------------------------------------

    def _advance(self, state: State, gate: str, n: int, terms) -> torch.Tensor:
        """Folded Rush-Larsen: g' = clip(g + (g - g_inf) * r(V))."""
        baked = 1 if gate in FAST_GATES else self.slow_n
        if n != baked:
            raise ValueError(
                f"cheby_fold baked dt*{baked} for gate {gate!r} but solve "
                f"was driven with n={n}; drive the model through step()"
            )
        g = state[gate]
        inf = chebyshev_eval(self.cheby_coef[f"{gate}_inf"], terms)
        r = chebyshev_eval(self.cheby_coef[f"{gate}_rl"], terms)
        return torch.clamp(g + (g - inf) * r, GATE_MIN, GATE_MAX)

    def currents(self, v0, c, gates, terms):
        """The four membrane currents (iK1, ix1, iNa, iCa)."""
        i_k1 = chebyshev_eval(self.cheby_coef["i_k1"], terms)
        i_x1 = gates["x1"] * chebyshev_eval(self.cheby_coef["i_x1f"], terms)
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
        terms = chebyshev_terms(
            normalize_voltage(v0, self.min_v, self.max_v), CHEBY_DEG)
        out = {g: self._advance(state, g, 1, terms) for g in FAST_GATES}
        for g in SLOW_GATES:
            out[g] = (self._advance(state, g, n, terms) if n > 0
                      else state[g])
        # currents use the PRE-update gates (load-bearing, ~0.4 mV/AP)
        i_k1, i_x1, i_na, i_ca = self.currents(v0, state["C"], state, terms)
        i_sum = i_k1 + i_x1 + i_na + i_ca
        out["V"] = torch.clamp(
            v0 + self.cfg.diff * dt * geom.laplace(v0) - dt * i_sum / C_M,
            V_CLIP_LO, V_CLIP_HI,
        )
        c = state["C"]
        out["C"] = c + dt * (-1.0e-7 * i_ca + 0.07 * (1.0e-7 - c))
        return out

    @property
    def has_uniform_substeps(self) -> bool:
        """Without `skip` the 5 substeps are identical solve(n=1) calls;
        the skip schedule (one n=5 + four n=0) is not splittable at
        arbitrary boundaries."""
        return not self.cfg.skip and self.cfg.adaptive_dv is None

    def substep_fns(self, geom: Geometry):
        """With `skip`, substep 0 advances the slow gates 5 dt (n=5) and
        substeps 1-4 freeze them (n=0); without, five n=1 substeps."""
        if not self.cfg.skip:
            fn = lambda s: self.solve(s, geom, n=1)
            return [fn] * 5, ("n1",) * 5
        first = lambda s: self.solve(s, geom, n=5)
        rest = lambda s: self.solve(s, geom, n=0)
        return [first] + [rest] * 4, ("n5",) + ("n0",) * 4
