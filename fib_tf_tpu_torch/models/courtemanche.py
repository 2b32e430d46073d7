"""The Courtemanche-Ramirez-Nattel human atrial model, 21 variables (port of
fib_tf_tpu/models/courtemanche.py), and Courtemanche-ultra, 22.

Courtemanche M, Ramirez RJ, Nattel S. "Ionic mechanisms underlying human
atrial action potential properties: insights from a mathematical model."
Am J Physiol. 1998;275:H301-21.

What the model carries, as the reference does:
  * chronic-AF remodeling: i_to and i_Kur x(1 - 0.5c), i_Ca,L x(1 - 0.7c),
    with c the global flag `cfg.chronic` or, where attached, the per-pixel
    plane `_p_chronic` (`set_het(chronic=...)`);
  * channel block: the 13 `SCALE_PARAMS` (`cfg.g_scale`, `set_scale`);
  * multi-rate: the fast states (V, Na_i, m, h) advance every dt, the other
    17 every 10th substep with 10 dt.  One outer step is the fast commit,
    then the slow commit from a second solve that sees the fast-updated
    state, then nine fast-only substeps;
  * three rate modes: direct (`calc_intermediates`), the hybrid Chebyshev
    fits (`cfg.court_cheby`, with the folded Rush-Larsen multipliers under
    `cfg.cheby_fold`; h and j stay direct) and the 150-row table
    (`cfg.table`);
  * `cfg.dv_max`, an opt-in cap on |dV| per substep.
`CourtemancheUltra` adds the ultra-slow Na gate `us` and drops the
fast/slow split: ten full-commit substeps.

`calc_intermediates` runs under numpy (table and fits, in float64) or torch
(the plain path, float32): every Python number over a tensor is one IEEE
division (`divide`), as the reference's jnp arithmetic is.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.models.base import (Geometry, IonicModel, State,
                                          check_unported)
from fib_tf_tpu_torch.ops import table as table_ops
from fib_tf_tpu_torch.ops.chebyshev import (chebyshev_eval, chebyshev_fit,
                                            chebyshev_terms,
                                            normalize_voltage)
from fib_tf_tpu_torch.ops.integrators import (GATE_MAX, GATE_MIN, divide,
                                               euler, rush_larsen)

# -- physical constants: a copy of the JAX model's (pinned equal by
# tests/test_torch_court.py) ------------------------------------------------
R_GAS = 8.3143        # J/(mol K)
TEMP = 310.0          # K
FARADAY = 96.4867     # C/mmol
CM = 100.0            # pF
G_NA = 7.8
NA_O = 140.0
K_O = 5.4
G_TO = 0.1652
G_KS = 0.12941176
G_CA_L = 0.12375
KM_NA_I = 10.0
KM_K_O = 1.5
I_NAK_MAX = 0.59933874
I_CAP_MAX = 0.275
G_B_NA = 0.0006744375
G_B_CA = 0.001131
G_B_K = 0.0
CA_O = 1.8
K_REL = 30.0
TAU_TR = 180.0
I_UP_MAX = 0.005
K_UP = 0.00092
CA_UP_MAX = 15.0
CMDN_MAX = 0.05
TRPN_MAX = 0.07
CSQN_MAX = 10.0
KM_CMDN = 0.00238
KM_TRPN = 0.0005
KM_CSQN = 0.8
V_CELL = 20100.0
V_I = V_CELL * 0.68
TAU_F_CA = 2.0
TAU_U = 8.0
V_REL = 0.0048 * V_CELL
V_UP = 0.0552 * V_CELL

# calc_intermediates constants
G_K1 = 0.09
K_Q10 = 3.0
G_KR = 0.029411765
I_NACA_MAX = 1600.0
K_M_NA = 87.5
K_M_CA = 1.38
K_SAT = 0.1
GAMMA = 0.35
SIGMA = 1.0

# the ultra-slow Na gate
V_US = -83.0
K_US = 23.0

# column order of the native lookup table
INTER_KEYS = (
    "d_infinity", "f_infinity", "tau_w", "tau_d", "tau_f", "w_infinity",
    "m_inf", "h_inf", "j_inf", "tau_oa", "tau_oi", "tau_ua", "tau_ui",
    "tau_xr", "tau_xs", "tau_m", "tau_h", "tau_j", "oa_infinity",
    "oi_infinity", "ua_infinity", "ui_infinity", "xr_infinity",
    "xs_infinity", "g_Kur", "f_NaK", "i_NaCaa", "i_NaCab", "i_K1a", "i_Kra",
)

FAST_STATES = ("V", "Na_i", "m", "h")
SLOW_RATIO = 10
# the terms of the currents that read only slow planes (`fast_invariants`),
# in the order of the kernels' cache (csrc/court_cell.cuh Invariant)
FAST_INVARIANTS = ("e_k", "e_ca", "i_cap", "p_to", "p_ks", "p_cal")


def calc_intermediates(v, xp=torch, ultra_slow: bool = False) -> Dict:
    """The 30 voltage-dependent intermediates (and with `ultra_slow` the us
    gate's two), under numpy or torch.  The `eps = V*1e-20` terms are the
    reference's guards at the removable singularities, and the tau_d branch
    keeps its V + 10.0001 shift."""
    rt = R_GAS * TEMP
    inter = {}
    eps = v * 1e-20

    inter["d_infinity"] = divide(1.0, 1.0 + xp.exp((v + 10.0) / -8.0))
    inter["tau_d"] = xp.where(
        xp.abs(v + 10.0001) < 1.0e-10,
        divide(4.579, 1.0 + xp.exp((v + 10.0) / -6.24)),
        (1.0 - xp.exp((v + 10.0001) / -6.24))
        / (0.035 * (v + 10.0001) * (1.0 + xp.exp((v + 10.0001) / -6.24))),
    )

    inter["f_infinity"] = xp.exp(-(v + 28.0) / 6.9) / (
        1.0 + xp.exp(-(v + 28.0) / 6.9)
    )
    inter["tau_f"] = divide(9.0, (
        0.0197 * xp.exp(-(0.0337**2) * (v + 10.0) ** 2) + 0.02
    ))

    inter["tau_w"] = xp.where(
        xp.abs(v - 7.9) < 1.0e-10,
        eps + (6.0 * 0.2) / 1.3,
        (6.0 * (1.0 - xp.exp(-(v - 7.9) / 5.0)))
        / ((1.0 + 0.3 * xp.exp(-(v - 7.9) / 5.0)) * (v - 7.9)),
    )
    inter["w_infinity"] = 1.0 - divide(1.0, 1.0 + xp.exp(-(v - 40.0) / 17.0))

    alpha_m = xp.where(
        xp.abs(v + 47.13) < 0.001,
        eps + 3.2,
        (0.32 * (v + 47.13)) / (1.0 - xp.exp(-0.1 * (v + 47.13))),
    )
    beta_m = 0.08 * xp.exp(-v / 11.0)
    inter["m_inf"] = alpha_m / (alpha_m + beta_m)
    inter["tau_m"] = divide(1.0, alpha_m + beta_m)

    inter.update(calc_hj_rates(v, xp))

    # the transient outward (oa/oi) and ultrarapid (ua/ui) K gates take the
    # shifted voltage V + 10
    vs = v + 10.0
    alpha_oa = divide(0.65, xp.exp(vs / -8.5) + xp.exp((vs - 40.0) / -59.0))
    beta_oa = divide(0.65, 2.5 + xp.exp((vs + 72.0) / 17.0))
    inter["tau_oa"] = divide(1.0, alpha_oa + beta_oa) / K_Q10
    inter["oa_infinity"] = divide(1.0, 1.0 + xp.exp((vs + 10.47) / -17.54))

    alpha_oi = divide(1.0, 18.53 + xp.exp((vs + 103.7) / 10.95))
    beta_oi = divide(1.0, 35.56 + xp.exp((vs - 8.74) / -7.44))
    inter["tau_oi"] = divide(1.0, alpha_oi + beta_oi) / K_Q10
    inter["oi_infinity"] = divide(1.0, 1.0 + xp.exp((vs + 33.1) / 5.3))

    alpha_ua = divide(0.65, xp.exp(vs / -8.5) + xp.exp((vs - 40.0) / -59.0))
    beta_ua = divide(0.65, 2.5 + xp.exp((vs + 72.0) / 17.0))
    inter["tau_ua"] = divide(1.0, alpha_ua + beta_ua) / K_Q10
    inter["ua_infinity"] = divide(1.0, 1.0 + xp.exp((vs + 20.3) / -9.6))

    alpha_ui = divide(1.0, 21.0 + xp.exp((vs - 195.0) / -28.0))
    beta_ui = divide(1.0, xp.exp((vs - 168.0) / -16.0))
    inter["tau_ui"] = divide(1.0, alpha_ui + beta_ui) / K_Q10
    inter["ui_infinity"] = divide(1.0, 1.0 + xp.exp((vs - 109.45) / 27.48))

    alpha_xr = xp.where(
        xp.abs(v + 14.1) < 1.0e-10,
        eps + 0.0015,
        (0.0003 * (v + 14.1)) / (1.0 - xp.exp((v + 14.1) / -5.0)),
    )
    beta_xr = xp.where(
        xp.abs(v - 3.3328) < 1.0e-10,
        eps + 0.000378361,
        (7.3898e-05 * (v - 3.3328)) / (xp.exp((v - 3.3328) / 5.1237) - 1.0),
    )
    inter["tau_xr"] = divide(1.0, alpha_xr + beta_xr)
    inter["xr_infinity"] = divide(1.0, 1.0 + xp.exp((v + 14.1) / -6.5))

    alpha_xs = xp.where(
        xp.abs(v - 19.9) < 1.0e-10,
        eps + 0.00068,
        (4.0e-05 * (v - 19.9)) / (1.0 - xp.exp((v - 19.9) / -17.0)),
    )
    beta_xs = xp.where(
        xp.abs(v - 19.9) < 1.0e-10,
        eps + 0.000315,
        (3.5e-05 * (v - 19.9)) / (xp.exp((v - 19.9) / 9.0) - 1.0),
    )
    inter["tau_xs"] = divide(0.5, alpha_xs + beta_xs)
    inter["xs_infinity"] = xp.sqrt(
        divide(1.0, 1.0 + xp.exp((v - 19.9) / -12.7)))

    inter["g_Kur"] = 0.005 + divide(0.05, 1.0 + xp.exp((v - 15.0) / -13.0))

    inter["f_NaK"] = divide(1.0, (
        1.0
        + 0.1245 * xp.exp((-0.1 * FARADAY * v) / rt)
        + 0.0365 * SIGMA * xp.exp((-FARADAY * v) / rt)
    ))

    i_na_ca_den = (
        (K_M_NA**3 + NA_O**3)
        * (K_M_CA + CA_O)
        * (1.0 + K_SAT * xp.exp(((GAMMA - 1.0) * v * FARADAY) / rt))
    )
    inter["i_NaCaa"] = (
        CM * I_NACA_MAX * (xp.exp((GAMMA * FARADAY * v) / rt) * CA_O)
    ) / i_na_ca_den
    inter["i_NaCab"] = (
        CM * I_NACA_MAX * (xp.exp(((GAMMA - 1.0) * FARADAY * v) / rt)
                           * NA_O**3)
    ) / i_na_ca_den

    inter["i_K1a"] = divide(CM * G_K1, 1.0 + xp.exp(0.07 * (v + 80.0)))
    inter["i_Kra"] = divide(CM * G_KR, 1.0 + xp.exp((v + 15.0) / 22.4))

    if ultra_slow:
        inter["us_infinity"], inter["tau_us"] = us_rates(v, xp)
    return inter


def us_rates(v, xp=torch):
    """The ultra-slow gate's inf and tau from its tanh-shaped rates."""
    alpha_us = 3e-5 * (0.5 * (1.0 - xp.tanh((v - V_US) / K_US)))
    beta_us = 1e-5 * (0.5 * (1.0 + xp.tanh((v - (V_US + 30.0)) / K_US)))
    return alpha_us / (alpha_us + beta_us), divide(1.0, alpha_us + beta_us)


def calc_intermediates_np(v: np.ndarray) -> Dict[str, np.ndarray]:
    """The intermediates in float64 numpy (the table and the fits)."""
    return calc_intermediates(np.asarray(v, dtype=np.float64), xp=np)


# The hybrid Chebyshev mode fits the intermediates that are smooth in V; the
# fast Na h/j rates switch branches at V = -40 mV and stay direct.
CHEBY_SMOOTH_KEYS = tuple(
    k for k in INTER_KEYS
    if k not in ("h_inf", "tau_h", "j_inf", "tau_j")
)
CHEBY_DEG_COURT = 12
CHEBY_SAMPLES_COURT = 5001


def calc_hj_rates(v, xp=torch) -> Dict:
    """The branchy fast-Na inactivation rates: h_inf, tau_h, j_inf,
    tau_j."""
    eps = v * 1e-20
    out = {}
    alpha_h = xp.where(v < -40.0, 0.135 * xp.exp((v + 80.0) / -6.8), eps)
    beta_h = xp.where(
        v < -40.0,
        3.56 * xp.exp(0.079 * v) + 310000.0 * xp.exp(0.35 * v),
        divide(1.0, 0.13 * (1.0 + xp.exp((v + 10.66) / -11.1))),
    )
    out["h_inf"] = alpha_h / (alpha_h + beta_h)
    out["tau_h"] = divide(1.0, alpha_h + beta_h)

    alpha_j = xp.where(
        v < -40.0,
        (
            (-127140.0 * xp.exp(0.2444 * v)
             - 3.474e-05 * xp.exp(-0.04391 * v))
            * (v + 37.78)
        )
        / (1.0 + xp.exp(0.311 * (v + 79.23))),
        eps,
    )
    beta_j = xp.where(
        v < -40.0,
        (0.1212 * xp.exp(-0.01052 * v))
        / (1.0 + xp.exp(-0.1378 * (v + 40.14))),
        (0.3 * xp.exp(-2.535e-07 * v)) / (1.0 + xp.exp(-0.1 * (v + 32.0))),
    )
    out["j_inf"] = alpha_j / (alpha_j + beta_j)
    out["tau_j"] = divide(1.0, alpha_j + beta_j)
    return out


class Courtemanche(IonicModel):
    name = "court"
    min_v = -100.0
    max_v = 50.0
    depol = -81.0
    # one outer step fuses a fast/slow group of 10 dt substeps
    dt_per_step = SLOW_RATIO
    pot_key = "V"
    fast_states: Tuple[str, ...] = FAST_STATES
    ultra_slow = False
    # a [0, 1] plane that spatializes the global chronic-AF flag: 1 = fully
    # remodeled, 0 = healthy; overrides cfg.chronic where attached
    HET_PARAMS = ("chronic",)
    SCALE_PARAMS = ("g_Na", "g_CaL", "g_Kr", "g_Ks", "g_to", "g_Kur",
                    "g_K1", "g_NaK", "g_NaCa", "g_pCa", "g_bNa", "g_bCa",
                    "g_bK")

    INITIAL_VALUES = {
        "V": -81.18,
        "Na_i": 1.117e01,
        "m": 2.98e-3,
        "h": 9.649e-1,
        "j": 9.775e-1,
        "K_i": 1.39e02,
        "oa": 3.043e-2,
        "oi": 9.992e-1,
        "ua": 4.966e-3,
        "ui": 9.986e-1,
        "xr": 3.296e-5,
        "xs": 1.869e-2,
        "Ca_i": 1.013e-4,
        "d": 1.367e-4,
        "f": 9.996e-1,
        "f_Ca": 7.755e-1,
        "Ca_rel": 1.488,
        "u_gate": 0.0,
        "v_gate": 1.0,
        "w_gate": 0.9992,
        "Ca_up": 1.488,
    }

    # gates updated from fitted (smooth) rate curves: gate -> (inf, tau,
    # dt key); w advances with d's dt, a quirk the reference keeps
    FITTED_GATES = {
        "d": ("d_infinity", "tau_d", "d"),
        "f": ("f_infinity", "tau_f", "f"),
        "w_gate": ("w_infinity", "tau_w", "d"),
        "m": ("m_inf", "tau_m", "m"),
        "oa": ("oa_infinity", "tau_oa", "oa"),
        "oi": ("oi_infinity", "tau_oi", "oi"),
        "ua": ("ua_infinity", "tau_ua", "ua"),
        "ui": ("ui_infinity", "tau_ui", "ui"),
        "xr": ("xr_infinity", "tau_xr", "xr"),
        "xs": ("xs_infinity", "tau_xs", "xs"),
    }

    # Where float32 is ill-conditioned, so that a kernel's and the plain
    # path's rounding may part past rtol/atol (tests and chip_smoke.py
    # arbitrate such cells in float64): the removable singularities of
    # tau_d (-10.0001), alpha_xr (-14.1), beta_xr (3.3328), tau_w (7.9) and
    # alpha_xs / beta_xs (19.9), each a difference over V minus its pole.
    ill_conditioned = ((-10.0001, -10.0001), (-14.1, -14.1),
                       (3.3328, 3.3328), (7.9, 7.9), (19.9, 19.9))

    def __init__(self, cfg: SimConfig):
        check_unported(cfg)
        if cfg.ab2:
            raise NotImplementedError(
                "ab2 is not implemented for Courtemanche: the multi-rate "
                "fast/slow split advances states on different effective "
                "dts, which has no well-defined shared AB2 history; use "
                "fenton or br"
            )
        super().__init__(cfg)
        # the 150 x 30 table (table mode) and the hybrid fits (court_cheby),
        # float32 and float64 numpy; interop.court_params_from_jax replaces
        # them with the JAX model's own
        self.table: Optional[np.ndarray] = None
        self.cheby_coef: Optional[Dict[str, np.ndarray]] = None
        if cfg.table:
            self.table = table_ops.build_table(calc_intermediates_np,
                                               INTER_KEYS)
        elif cfg.court_cheby:
            self.cheby_coef = self._fit_chebyshev()
        self._tables: Dict[torch.device, torch.Tensor] = {}

    def _fit_chebyshev(self) -> Dict[str, np.ndarray]:
        """Degree-12 fits of the smooth intermediates and, under
        `cheby_fold`, of each fitted gate's multiplier expm1(-dt_g/tau(V)),
        keyed `rl_<gate>`."""
        v = np.linspace(self.min_v, self.max_v, CHEBY_SAMPLES_COURT)
        inter = calc_intermediates_np(v)
        coef = {
            k: chebyshev_fit(v, np.broadcast_to(inter[k], v.shape),
                             CHEBY_DEG_COURT)
            for k in CHEBY_SMOOTH_KEYS
        }
        if self.cfg.cheby_fold:
            for gate, (_inf, tau_key, dt_key) in self.FITTED_GATES.items():
                r = np.expm1(-self.dt_for(dt_key) / inter[tau_key])
                coef[f"rl_{gate}"] = chebyshev_fit(v, r, CHEBY_DEG_COURT)
        return coef

    @property
    def kernel_free(self) -> bool:
        """Table mode has no cell body: the plain path, as the reference
        runs it on XLA."""
        return self.rate_mode == "table"

    @property
    def rate_mode(self) -> str:
        """'table', 'fold' (the fits with folded gates), 'cheby' (the fits
        with Rush-Larsen) or 'direct'."""
        if self.table is not None:
            return "table"
        if self.cheby_coef is not None:
            return "fold" if "rl_m" in self.cheby_coef else "cheby"
        return "direct"

    # -- state ---------------------------------------------------------------

    def state_keys(self):
        keys = tuple(self.INITIAL_VALUES.keys())
        if self.ultra_slow:
            keys = keys + ("us",)
        return tuple(sorted(keys + self.het_keys()))

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """The resting state; with `s1`, V = 20 mV on the 25 leftmost
        columns."""
        state = {k: self._full(val) for k, val in self.INITIAL_VALUES.items()}
        if self.ultra_slow:
            state["us"] = self._full(0.72)  # the steady state at 500 ms
        if s1:
            state["V"][:, :25] = 20.0
        return self.attach_het(state)

    def dt_for(self, name: str) -> float:
        """Per-state step: the fast states take dt, the rest dt * 10."""
        if name in self.fast_states:
            return self.cfg.dt
        return self.cfg.dt * SLOW_RATIO

    # -- dynamics ------------------------------------------------------------

    def _table_on(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = torch.tensor(self.table, device=device)
        return self._tables[device]

    def intermediates(self, v: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The intermediates of the rate mode (table, fits or direct), with
        the us gate's two under ultra_slow (always direct)."""
        if self.table is not None:
            inter = table_ops.lookup(self._table_on(v.device), v, INTER_KEYS)
        elif self.cheby_coef is not None:
            x = normalize_voltage(v, self.min_v, self.max_v)
            terms = chebyshev_terms(x, CHEBY_DEG_COURT)
            inter = {k: chebyshev_eval(c, terms)
                     for k, c in self.cheby_coef.items()}
            inter.update(calc_hj_rates(v))
        else:
            return calc_intermediates(v, ultra_slow=self.ultra_slow)
        if self.ultra_slow:
            inter["us_infinity"], inter["tau_us"] = us_rates(v)
        return inter

    def _gate(self, state: State, inter, gate: str) -> torch.Tensor:
        """One fitted gate: the folded multiplier when fitted, else
        Rush-Larsen."""
        inf_key, tau_key, dt_key = self.FITTED_GATES[gate]
        g = state[gate]
        rl = inter.get(f"rl_{gate}")
        if rl is not None:
            return torch.clamp(g + (g - inter[inf_key]) * rl, GATE_MIN,
                               GATE_MAX)
        return rush_larsen(g, inter[inf_key], inter[tau_key],
                           self.dt_for(dt_key))

    def fast_invariants(self, state: State) -> State:
        """The terms of the currents that read only planes the slow commit
        writes, {FAST_INVARIANTS key: tensor}: E_K, E_Ca, I_pCa and the
        gate prefixes of I_to, I_Ks and I_CaL (each current is its prefix
        times its driving force, in this order).  Between two slow
        commits they do not change."""
        rt_f = (R_GAS * TEMP) / FARADAY
        chronic = self.het_param(
            state, "chronic", 1.0 if self.cfg.chronic else 0.0)
        ca = state["Ca_i"]
        return {
            "e_k": rt_f * torch.log(divide(K_O, state["K_i"])),
            "e_ca": (rt_f / 2.0) * torch.log(divide(CA_O, ca)),
            "i_cap": ((CM * self.gscale("g_pCa", I_CAP_MAX) * ca)
                      / (0.0005 + ca)),
            "p_to": ((1.0 - 0.5 * chronic) * CM * self.gscale("g_to", G_TO)
                     * state["oa"] ** 3 * state["oi"]),
            "p_ks": CM * self.gscale("g_Ks", G_KS) * state["xs"] ** 2,
            "p_cal": ((1.0 - 0.7 * chronic) * CM
                      * self.gscale("g_CaL", G_CA_L)
                      * state["d"] * state["f"] * state["f_Ca"]),
        }

    def solve_full(self, state: State, geom: Geometry,
                   invariants: Optional[State] = None):
        """One substep of every state, with the `fast_invariants` of
        `state` or those given; returns (new_state, intermediates)."""
        dt_ = self.dt_for
        rt_f = (R_GAS * TEMP) / FARADAY
        chronic = self.het_param(
            state, "chronic", 1.0 if self.cfg.chronic else 0.0)
        inv = (self.fast_invariants(state) if invariants is None
               else invariants)

        v = geom.enforce_boundary(state["V"])
        inter = self.intermediates(v)

        s1: State = {}
        for gate in self.FITTED_GATES:
            s1[gate] = self._gate(state, inter, gate)
        s1["h"] = rush_larsen(state["h"], inter["h_inf"], inter["tau_h"],
                              dt_("h"))
        s1["j"] = rush_larsen(state["j"], inter["j_inf"], inter["tau_j"],
                              dt_("j"))
        if self.ultra_slow:
            s1["us"] = rush_larsen(state["us"], inter["us_infinity"],
                                   inter["tau_us"], dt_("us"))

        # the constant time constants as planes: rush_larsen's -dt / tau
        # is then one float32 division, as the kernels take it
        f_ca_inf = divide(1.0, 1.0 + state["Ca_i"] / 0.00035)
        s1["f_Ca"] = rush_larsen(state["f_Ca"], f_ca_inf,
                                 torch.full_like(f_ca_inf, TAU_F_CA),
                                 dt_("f_Ca"))

        e_k = inv["e_k"]
        i_k1 = self.gscale("g_K1", inter["i_K1a"]) * (v - e_k)
        i_to = inv["p_to"] * (v - e_k)
        i_kur = ((1.0 - 0.5 * chronic) * CM
                 * self.gscale("g_Kur", inter["g_Kur"])
                 * state["ua"] ** 3 * state["ui"] * (v - e_k))
        i_kr = self.gscale("g_Kr", inter["i_Kra"]) * state["xr"] * (v - e_k)
        i_ks = inv["p_ks"] * (v - e_k)
        i_nak = (
            (CM * self.gscale("g_NaK", I_NAK_MAX) * inter["f_NaK"])
            / (1.0 + torch.sqrt(divide(KM_NA_I, state["Na_i"]) ** 3))
        ) * (K_O / (K_O + KM_K_O))
        i_b_k = CM * self.gscale("g_bK", G_B_K) * (v - e_k)

        s1["K_i"] = euler(
            state["K_i"],
            (2.0 * i_nak - (i_k1 + i_to + i_kur + i_kr + i_ks + i_b_k))
            / (V_I * FARADAY),
            dt_("K_i"),
        )

        e_na = rt_f * torch.log(divide(NA_O, state["Na_i"]))
        i_na = (CM * self.gscale("g_Na", G_NA) * state["m"] ** 3
                * state["h"] * state["j"] * (v - e_na))
        if self.ultra_slow:
            i_na = i_na * state["us"]
        i_naca = self.gscale("g_NaCa", inter["i_NaCaa"] * state["Na_i"] ** 3
                             - inter["i_NaCab"] * state["Ca_i"])
        i_b_na = CM * self.gscale("g_bNa", G_B_NA) * (v - e_na)

        s1["Na_i"] = euler(
            state["Na_i"],
            (-3.0 * i_nak - (3.0 * i_naca + i_b_na + i_na)) / (V_I * FARADAY),
            dt_("Na_i"),
        )

        i_ca_l = inv["p_cal"] * (v - 65.0)
        i_cap = inv["i_cap"]
        e_ca = inv["e_ca"]
        i_b_ca = CM * self.gscale("g_bCa", G_B_CA) * (v - e_ca)

        dv = euler(
            v,
            -(i_na + i_k1 + i_to + i_kur + i_kr + i_ks + i_b_na + i_b_ca
              + i_nak + i_cap + i_naca + i_ca_l) / CM,
            dt_("V"),
        )
        v1 = dv + self.cfg.diff * dt_("V") * geom.laplace(v)
        if self.cfg.dv_max is not None:
            v1 = v + torch.clamp(v1 - v, -self.cfg.dv_max, self.cfg.dv_max)
        s1["V"] = v1

        i_rel = (K_REL * state["u_gate"] ** 2 * state["v_gate"]
                 * state["w_gate"] * (state["Ca_rel"] - state["Ca_i"]))
        i_tr = (state["Ca_up"] - state["Ca_rel"]) / TAU_TR

        s1["Ca_rel"] = euler(
            state["Ca_rel"],
            (i_tr - i_rel)
            / (1.0 + divide(CSQN_MAX * KM_CSQN,
                         (state["Ca_rel"] + KM_CSQN) ** 2)),
            dt_("Ca_rel"),
        )

        fn = 1000.0 * (
            1.0e-15 * V_REL * i_rel
            - (1.0e-15 / (2.0 * FARADAY)) * (0.5 * i_ca_l - 0.2 * i_naca)
        )
        u_inf = divide(1.0, 1.0 + torch.exp(-(fn - 3.4175e-13) / 1.367e-15))
        s1["u_gate"] = rush_larsen(state["u_gate"], u_inf,
                                   torch.full_like(u_inf, TAU_U),
                                   dt_("u_gate"))

        tau_v = 1.91 + 2.09 * u_inf
        v_inf = 1.0 - divide(1.0,
                          1.0 + torch.exp(-(fn - 6.835e-14) / 1.367e-15))
        s1["v_gate"] = rush_larsen(state["v_gate"], v_inf, tau_v,
                                   dt_("v_gate"))

        i_up = divide(I_UP_MAX, 1.0 + divide(K_UP, state["Ca_i"]))
        i_up_leak = (I_UP_MAX * state["Ca_up"]) / CA_UP_MAX

        s1["Ca_up"] = euler(
            state["Ca_up"],
            i_up - (i_up_leak + (i_tr * V_REL) / V_UP),
            dt_("Ca_up"),
        )

        b1 = (2.0 * i_naca - (i_cap + i_ca_l + i_b_ca)) / (
            2.0 * V_I * FARADAY) + (
            V_UP * (i_up_leak - i_up) + i_rel * V_REL) / V_I
        b2 = (
            1.0
            + divide(TRPN_MAX * KM_TRPN, (state["Ca_i"] + KM_TRPN) ** 2)
            + divide(CMDN_MAX * KM_CMDN, (state["Ca_i"] + KM_CMDN) ** 2)
        )
        s1["Ca_i"] = euler(state["Ca_i"], b1 / b2, dt_("Ca_i"))
        return s1, inter

    def solve(self, state: State, geom: Geometry,
              invariants: Optional[State] = None) -> State:
        return self.carry_het(state,
                              self.solve_full(state, geom, invariants)[0])

    def slow_keys(self, state) -> list:
        """The slow planes of `state`: neither fast nor a het plane."""
        return [k for k in state if k not in self.fast_states
                and not k.startswith(self.HET_PREFIX)]

    def fast_commit(self, state: State, geom: Geometry,
                    invariants: Optional[State] = None) -> State:
        """A substep that commits the fast states only, with the
        `fast_invariants` of `state` or those given."""
        s1 = self.solve(state, geom, invariants)
        return {**state, **{k: s1[k] for k in self.fast_states}}

    def slow_commit(self, state: State, geom: Geometry) -> State:
        """The second solve of substep 0: it sees the fast-updated state
        and commits the slow states only."""
        s1 = self.solve(state, geom)
        return {**state, **{k: s1[k] for k in self.slow_keys(state)}}

    def commit(self, state: State, geom: Geometry, slow: bool) -> State:
        """One kernel launch's work: the slow commit (`slow`) or the fast
        commit."""
        return (self.slow_commit if slow else self.fast_commit)(state, geom)

    # the kernels' launches of one outer step (SLOW = true: the slow
    # commit): the fast commit, the slow commit, nine fast commits
    launch_schedule = (False, True) + (False,) * (SLOW_RATIO - 1)

    def substep_fns(self, geom: Geometry):
        """Substep 0 is the fast-commit-then-slow-commit pair, substeps
        1-9 the shared fast-only body."""
        def first(s):
            return self.slow_commit(self.fast_commit(s, geom), geom)

        return ([first] + [lambda s: self.fast_commit(s, geom)]
                * (SLOW_RATIO - 1),
                ("fast+slow",) + ("fast",) * (SLOW_RATIO - 1))

    # -- probes --------------------------------------------------------------

    @property
    def trend_points(self):
        """((state key, row, col), ...) of the trend probe."""
        w2 = self.cfg.width // 2
        return (("V", w2, 20), ("Na_i", w2, 20))

    def trend_probe(self, state: State) -> torch.Tensor:
        """V and Na_i at pixel [width // 2, 20]."""
        return torch.stack([state[k][r, c] for k, r, c in self.trend_points])

    def extra_probes(self, state: State, phase=None) -> Dict:
        """The `trend` stream."""
        return {"trend": self.trend_probe(state)}


class CourtemancheUltra(Courtemanche):
    """Courtemanche with the ultra-slow Na gate `us` (it multiplies i_Na)
    and no fast/slow split: all 22 states advance every dt."""

    name = "court_ultra"
    ultra_slow = True
    launch_schedule = (True,) * SLOW_RATIO

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg.replace(ultra_slow=True))

    def dt_for(self, name: str) -> float:
        return self.cfg.dt

    # every launch commits every state (its one form), and an outer step
    # is ten identical full-commit solves
    commit = IonicModel.commit
    substep_fns = IonicModel.substep_fns

    @property
    def trend_points(self):
        """V and us at [width // 2, height // 8]."""
        r, c = self.cfg.width // 2, self.cfg.height // 8
        return (("V", r, c), ("us", r, c))

    def extra_probes(self, state: State, phase=None) -> Dict:
        """The `trend` stream and the phase-weighted `ultra` means."""
        return {"trend": self.trend_probe(state),
                "ultra": self.ultra_observables(state, phase)}

    # key order of the stacked `ultra` probe stream
    ULTRA_KEYS = ("mean_na", "mean_ca", "mean_us",
                  "mean_us_infinity", "mean_tau_us")

    def ultra_observables(self, state: State, phase=None) -> torch.Tensor:
        """Phase-weighted spatial means of Na_i, f_Ca, us and the us gate's
        two rates, a [5] tensor in ULTRA_KEYS order."""
        v = state["V"]
        w = (torch.as_tensor(phase, dtype=v.dtype, device=v.device)
             if phase is not None else torch.ones_like(v))
        wsum = torch.sum(w)
        return torch.stack([torch.sum(x * w) / wsum
                            for x in self.ultra_fields(state)])

    def ultra_fields(self, state: State):
        """The five planes whose phase-weighted means form the `ultra`
        probe."""
        us_inf, tau_us = us_rates(state["V"])
        return (state["Na_i"], state["f_Ca"], state["us"], us_inf, tau_us)
