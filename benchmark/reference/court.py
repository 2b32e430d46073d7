"""Plain reference of the Courtemanche-Ramirez-Nattel human atrial model
(Am J Physiol 1998;275:H301-21), 21 planes, with the direct rates, the
chronic-AF remodeling (i_to and i_Kur x 0.5, i_Ca,L x 0.3) and the
multi-rate schedule the configuration runs: the fast states (V, Na_i, m,
h) advance every dt, the other seventeen every tenth substep by 10 dt.
An outer step is a fast commit, a slow commit that sees the fast-updated
state, and nine more fast commits; a commit computes what its states
need.  The `trend` probe is V and Na_i at row width // 2, column 20.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from reference.common import GridModel, State, no_flux_border

MIN_V, MAX_V = -100.0, 50.0
RATIO = 10
DT_PER_STEP = RATIO   # substeps of dt in one outer step
FAST = ("V", "Na_i", "m", "h")
GATE_LO, GATE_HI = 1e-5, 0.99999

R, T, F = 8.3143, 310.0, 96.4867
RT = R * T
CM = 100.0
NA_O, K_O, CA_O = 140.0, 5.4, 1.8
G_NA, G_TO, G_KS, G_CAL = 7.8, 0.1652, 0.12941176, 0.12375
G_K1, G_KR = 0.09, 0.029411765
KM_NAI, KM_KO = 10.0, 1.5
I_NAK, I_CAP = 0.59933874, 0.275
G_BNA, G_BCA, G_BK = 0.0006744375, 0.001131, 0.0
K_REL, TAU_TR, TAU_FCA, TAU_U = 30.0, 180.0, 2.0, 8.0
I_UP, K_UP, CA_UP_MAX = 0.005, 0.00092, 15.0
CMDN, TRPN, CSQN = 0.05, 0.07, 10.0
KM_CMDN, KM_TRPN, KM_CSQN = 0.00238, 0.0005, 0.8
V_CELL = 20100.0
V_I, V_REL, V_UP = 0.68 * V_CELL, 0.0048 * V_CELL, 0.0552 * V_CELL
Q10 = 3.0
NACA_MAX, KM_NA, KM_CA, K_SAT, GAMMA = 1600.0, 87.5, 1.38, 0.1, 0.35

REST = {
    "V": -81.18, "Na_i": 11.17, "m": 2.98e-3, "h": 0.9649, "j": 0.9775,
    "K_i": 139.0, "oa": 3.043e-2, "oi": 0.9992, "ua": 4.966e-3,
    "ui": 0.9986, "xr": 3.296e-5, "xs": 1.869e-2, "Ca_i": 1.013e-4,
    "d": 1.367e-4, "f": 0.9996, "f_Ca": 0.7755, "Ca_rel": 1.488,
    "u_gate": 0.0, "v_gate": 1.0, "w_gate": 0.9992, "Ca_up": 1.488,
}


def initial_state(height: int, width: int) -> Dict[str, np.ndarray]:
    """The resting planes with the S1 stripe: the 25 leftmost columns at
    +20 mV."""
    st = {k: np.full((height, width), v, np.float32) for k, v in REST.items()}
    st["V"][:, :25] = 20.0
    return st


def rl(g, inf, tau, dt):
    """Rush-Larsen: g + (g - inf) (exp(-dt / tau) - 1), kept in (0, 1)."""
    return torch.clamp(g + (g - inf) * torch.expm1(-dt / tau),
                       GATE_LO, GATE_HI)


def where_near(v, pole, width, near, far):
    """`far` (a difference over V minus its pole), or `near` (the limit)
    within `width` of the pole."""
    return torch.where(torch.abs(v - pole) < width, near, far)


class Model(GridModel):
    min_v, max_v = MIN_V, MAX_V
    # the removable singularities of tau_d, alpha_xr, beta_xr, tau_w and
    # alpha_xs / beta_xs, and the h / j branch point
    POLES = (-10.0001, -14.1, 3.3328, 7.9, 19.9, -40.0)

    def __init__(self, sim: Mapping, height: int, width: int, phase,
                 device, dtype=torch.float32):
        super().__init__(sim, height, width, phase, device, dtype)
        if sim.get("court_cheby") or sim.get("table"):
            raise ValueError("the Courtemanche reference covers the direct "
                             "rates")
        self.dt, self.diff = float(sim["dt"]), float(sim["diff"])
        self.chronic = 1.0 if sim.get("chronic", True) else 0.0
        self.trend_pixel = (width // 2, 20)

    # -- rates -------------------------------------------------------------

    @staticmethod
    def fast_rates(v) -> Dict[str, torch.Tensor]:
        """The m and h gates' steady states and time constants (j's with
        h's: the same branches at -40 mV)."""
        eps = v * 1e-20
        a_m = where_near(v, -47.13, 0.001, eps + 3.2,
                         0.32 * (v + 47.13)
                         / (1.0 - torch.exp(-0.1 * (v + 47.13))))
        b_m = 0.08 * torch.exp(-v / 11.0)
        low = v < -40.0
        a_h = torch.where(low, 0.135 * torch.exp((v + 80.0) / -6.8), eps)
        b_h = torch.where(
            low, 3.56 * torch.exp(0.079 * v) + 310000.0 * torch.exp(0.35 * v),
            1.0 / (0.13 * (1.0 + torch.exp((v + 10.66) / -11.1))))
        a_j = torch.where(
            low, (-127140.0 * torch.exp(0.2444 * v)
                  - 3.474e-05 * torch.exp(-0.04391 * v)) * (v + 37.78)
            / (1.0 + torch.exp(0.311 * (v + 79.23))), eps)
        b_j = torch.where(
            low, 0.1212 * torch.exp(-0.01052 * v)
            / (1.0 + torch.exp(-0.1378 * (v + 40.14))),
            0.3 * torch.exp(-2.535e-07 * v)
            / (1.0 + torch.exp(-0.1 * (v + 32.0))))
        return {"m": (a_m / (a_m + b_m), 1.0 / (a_m + b_m)),
                "h": (a_h / (a_h + b_h), 1.0 / (a_h + b_h)),
                "j": (a_j / (a_j + b_j), 1.0 / (a_j + b_j))}

    @staticmethod
    def slow_rates(v) -> Dict[str, tuple]:
        """(steady state, time constant) of the gates that move every
        tenth substep."""
        eps = v * 1e-20
        out = {}
        out["d"] = (1.0 / (1.0 + torch.exp((v + 10.0) / -8.0)),
                    where_near(v, -10.0001, 1e-10,
                               4.579 / (1.0 + torch.exp((v + 10.0) / -6.24)),
                               (1.0 - torch.exp((v + 10.0001) / -6.24))
                               / (0.035 * (v + 10.0001)
                                  * (1.0 + torch.exp((v + 10.0001) / -6.24)))))
        ef = torch.exp(-(v + 28.0) / 6.9)
        out["f"] = (ef / (1.0 + ef),
                    9.0 / (0.0197 * torch.exp(-(0.0337 ** 2)
                                              * (v + 10.0) ** 2) + 0.02))
        ew = torch.exp(-(v - 7.9) / 5.0)
        out["w_gate"] = (1.0 - 1.0 / (1.0 + torch.exp(-(v - 40.0) / 17.0)),
                         where_near(v, 7.9, 1e-10, eps + 6.0 * 0.2 / 1.3,
                                    6.0 * (1.0 - ew)
                                    / ((1.0 + 0.3 * ew) * (v - 7.9))))
        vs = v + 10.0
        a_oa = 0.65 / (torch.exp(vs / -8.5) + torch.exp((vs - 40.0) / -59.0))
        b_oa = 0.65 / (2.5 + torch.exp((vs + 72.0) / 17.0))
        out["oa"] = (1.0 / (1.0 + torch.exp((vs + 10.47) / -17.54)),
                     1.0 / (a_oa + b_oa) / Q10)
        a_oi = 1.0 / (18.53 + torch.exp((vs + 103.7) / 10.95))
        b_oi = 1.0 / (35.56 + torch.exp((vs - 8.74) / -7.44))
        out["oi"] = (1.0 / (1.0 + torch.exp((vs + 33.1) / 5.3)),
                     1.0 / (a_oi + b_oi) / Q10)
        out["ua"] = (1.0 / (1.0 + torch.exp((vs + 20.3) / -9.6)),
                     out["oa"][1])
        a_ui = 1.0 / (21.0 + torch.exp((vs - 195.0) / -28.0))
        b_ui = 1.0 / torch.exp((vs - 168.0) / -16.0)
        out["ui"] = (1.0 / (1.0 + torch.exp((vs - 109.45) / 27.48)),
                     1.0 / (a_ui + b_ui) / Q10)
        a_xr = where_near(v, -14.1, 1e-10, eps + 0.0015,
                          0.0003 * (v + 14.1)
                          / (1.0 - torch.exp((v + 14.1) / -5.0)))
        b_xr = where_near(v, 3.3328, 1e-10, eps + 0.000378361,
                          7.3898e-05 * (v - 3.3328)
                          / (torch.exp((v - 3.3328) / 5.1237) - 1.0))
        out["xr"] = (1.0 / (1.0 + torch.exp((v + 14.1) / -6.5)),
                     1.0 / (a_xr + b_xr))
        a_xs = where_near(v, 19.9, 1e-10, eps + 0.00068,
                          4.0e-05 * (v - 19.9)
                          / (1.0 - torch.exp((v - 19.9) / -17.0)))
        b_xs = where_near(v, 19.9, 1e-10, eps + 0.000315,
                          3.5e-05 * (v - 19.9)
                          / (torch.exp((v - 19.9) / 9.0) - 1.0))
        out["xs"] = (torch.sqrt(1.0 / (1.0 + torch.exp((v - 19.9) / -12.7))),
                     0.5 / (a_xs + b_xs))
        return out

    # -- one commit ----------------------------------------------------------

    def commit(self, s: State, slow: bool) -> State:
        """The substep's new values of the fast states, or (`slow`) of the
        seventeen others, from the state `s`."""
        dt = self.dt
        dts = dt * RATIO
        c = self.chronic
        v = no_flux_border(s["V"])
        self.note_poles(v)
        rt_f = RT / F

        e_k = rt_f * torch.log(K_O / s["K_i"])
        e_na = rt_f * torch.log(NA_O / s["Na_i"])
        e_ca = 0.5 * rt_f * torch.log(CA_O / s["Ca_i"])
        i_k1 = CM * G_K1 / (1.0 + torch.exp(0.07 * (v + 80.0))) * (v - e_k)
        i_to = (1.0 - 0.5 * c) * CM * G_TO * s["oa"] ** 3 * s["oi"] * (v - e_k)
        g_kur = 0.005 + 0.05 / (1.0 + torch.exp((v - 15.0) / -13.0))
        i_kur = ((1.0 - 0.5 * c) * CM * g_kur * s["ua"] ** 3 * s["ui"]
                 * (v - e_k))
        i_kr = (CM * G_KR / (1.0 + torch.exp((v + 15.0) / 22.4)) * s["xr"]
                * (v - e_k))
        i_ks = CM * G_KS * s["xs"] ** 2 * (v - e_k)
        f_nak = 1.0 / (1.0 + 0.1245 * torch.exp(-0.1 * F * v / RT)
                       + 0.0365 * torch.exp(-F * v / RT))
        i_nak = (CM * I_NAK * f_nak
                 / (1.0 + torch.sqrt((KM_NAI / s["Na_i"]) ** 3))
                 * (K_O / (K_O + KM_KO)))
        i_bk = CM * G_BK * (v - e_k)
        den = ((KM_NA ** 3 + NA_O ** 3) * (KM_CA + CA_O)
               * (1.0 + K_SAT * torch.exp((GAMMA - 1.0) * v * F / RT)))
        i_naca = (CM * NACA_MAX * (torch.exp(GAMMA * F * v / RT) * CA_O)
                  / den * s["Na_i"] ** 3
                  - CM * NACA_MAX * (torch.exp((GAMMA - 1.0) * F * v / RT)
                                     * NA_O ** 3) / den * s["Ca_i"])
        i_na = CM * G_NA * s["m"] ** 3 * s["h"] * s["j"] * (v - e_na)
        i_bna = CM * G_BNA * (v - e_na)
        i_cal = ((1.0 - 0.7 * c) * CM * G_CAL * s["d"] * s["f"] * s["f_Ca"]
                 * (v - 65.0))
        i_cap = CM * I_CAP * s["Ca_i"] / (0.0005 + s["Ca_i"])
        i_bca = CM * G_BCA * (v - e_ca)

        if not slow:
            rates = self.fast_rates(v)
            total = (i_na + i_k1 + i_to + i_kur + i_kr + i_ks + i_bna + i_bca
                     + i_nak + i_cap + i_naca + i_cal)
            return {
                "V": v - dt * total / CM + self.diff * dt * self.lap(v),
                "Na_i": s["Na_i"] + dt * (-3.0 * i_nak
                                          - (3.0 * i_naca + i_bna + i_na)
                                          ) / (V_I * F),
                "m": rl(s["m"], *rates["m"], dt),
                "h": rl(s["h"], *rates["h"], dt),
            }

        out = {}
        out["j"] = rl(s["j"], *self.fast_rates(v)["j"], dts)
        for g, (inf, tau) in self.slow_rates(v).items():
            out[g] = rl(s[g], inf, tau, dts)
        out["f_Ca"] = rl(s["f_Ca"], 1.0 / (1.0 + s["Ca_i"] / 0.00035),
                         torch.full_like(v, TAU_FCA), dts)
        out["K_i"] = s["K_i"] + dts * (
            2.0 * i_nak - (i_k1 + i_to + i_kur + i_kr + i_ks + i_bk)
        ) / (V_I * F)
        i_rel = (K_REL * s["u_gate"] ** 2 * s["v_gate"] * s["w_gate"]
                 * (s["Ca_rel"] - s["Ca_i"]))
        i_tr = (s["Ca_up"] - s["Ca_rel"]) / TAU_TR
        out["Ca_rel"] = s["Ca_rel"] + dts * (i_tr - i_rel) / (
            1.0 + CSQN * KM_CSQN / (s["Ca_rel"] + KM_CSQN) ** 2)
        fn = 1000.0 * (1e-15 * V_REL * i_rel
                       - 1e-15 / (2.0 * F) * (0.5 * i_cal - 0.2 * i_naca))
        u_inf = 1.0 / (1.0 + torch.exp(-(fn - 3.4175e-13) / 1.367e-15))
        out["u_gate"] = rl(s["u_gate"], u_inf, torch.full_like(v, TAU_U),
                           dts)
        v_inf = 1.0 - 1.0 / (1.0 + torch.exp(-(fn - 6.835e-14) / 1.367e-15))
        out["v_gate"] = rl(s["v_gate"], v_inf, 1.91 + 2.09 * u_inf, dts)
        i_up = I_UP / (1.0 + K_UP / s["Ca_i"])
        i_leak = I_UP * s["Ca_up"] / CA_UP_MAX
        out["Ca_up"] = s["Ca_up"] + dts * (i_up - (i_leak
                                                   + i_tr * V_REL / V_UP))
        b1 = ((2.0 * i_naca - (i_cap + i_cal + i_bca)) / (2.0 * V_I * F)
              + (V_UP * (i_leak - i_up) + i_rel * V_REL) / V_I)
        b2 = (1.0 + TRPN * KM_TRPN / (s["Ca_i"] + KM_TRPN) ** 2
              + CMDN * KM_CMDN / (s["Ca_i"] + KM_CMDN) ** 2)
        out["Ca_i"] = s["Ca_i"] + dts * b1 / b2
        return out

    def outer_step(self, state: State) -> State:
        state = {**state, **self.commit(state, slow=False)}
        state = {**state, **self.commit(state, slow=True)}
        for _ in range(RATIO - 1):
            state = {**state, **self.commit(state, slow=False)}
        return state

    def probe_pixels(self) -> Dict[str, tuple]:
        return {"v": self.probe_pixel, "trend": self.trend_pixel}

    def probes(self, state: State) -> Dict[str, torch.Tensor]:
        r, c = self.trend_pixel
        return {"v": self.v_probe(state),
                "trend": torch.stack([state["V"][r, c].float(),
                                      state["Na_i"][r, c].float()])}
