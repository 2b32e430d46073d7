"""Plain reference of the ten Tusscher-Panfilov 2006 human ventricular model
(ten Tusscher and Panfilov, "Alternans and spiral breakup in a human
ventricular tissue model", Am J Physiol Heart Circ Physiol
2006;291:H1088-H1100), epicardial parameter set, as the configuration runs
it: nineteen planes (V; the pools Na_i, K_i, Ca_i, Ca_SR, Ca_SS; the
release variable R-bar; the gates m, h, j, d, f, f2, fCass, r, s, xr1,
xr2, xs), every one advanced every dt.

A substep takes the currents and rates from the state it starts from:
the gates and R-bar take Rush-Larsen steps (exact for their linear
equations at fixed V and Ca_SS), V and the pools explicit Euler.

Departures from the paper:

- Tissue: a grid of unit cells with the zoo's 9-point Laplacian and
  coupling `diff` (cells^2/ms), no-flux borders (the border cells take
  the potential of the cell inward), not the paper's D at its dx.
- No stimulus current: pacing raises V by a maximum with a mask, and the
  S1 is column 1 at +20 mV in the initial state.
- Initial state: the paper's initial potential and pools (V -86.2 mV,
  Ca_i = Ca_SS = 7e-5, Ca_SR 1.3, Na_i 7.67, K_i 138.3 mM, R-bar 1),
  the gates at their steady states at -86.2 mV (fCass at 7e-5 mM),
  computed in float64, not the paper's m = 0, h = j = 0.75, ...
- The buffered pools: the free concentrations take explicit Euler with
  the instantaneous-buffer factor 1 / (1 + Buf K / (Ca + K)^2) (the
  derivative of the paper's rapid-buffering equations), not the total
  concentrations with a quadratic solved for the free one.
- Every Rush-Larsen variable (the gates, fCass, R-bar) is clipped to
  [1e-5, 0.99999] after its step, as every model of the zoo clips its
  gates (fib_tf's Rush-Larsen); at rest r's steady state is 2e-8, and in
  the plateau h and j fall to 1e-11.
- I_CaL's GHK factor (V - 15) / (exp(x) - 1), x = 2 (V - 15) F/RT, is
  taken as (V - 15) / expm1(x), and as its limit RT/2F where |x| < 1e-4.

V enters the rates through its no-flux border, as the Laplacian does.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from reference.common import GridModel, State, no_flux_border

# TF32 matrix products would round below float32; the reference has none,
# but it runs on the card in the benchmark's process
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MIN_V, MAX_V = -90.0, 50.0
DT_PER_STEP = 10      # substeps of dt in one outer step
V_REST = -86.2

# -- the paper's Table 1 ---------------------------------------------------------
R, T, F = 8314.472, 310.0, 96485.3415    # J/(kmol K), K, C/mol
RT_F = R * T / F                          # mV
C_M = 0.185                               # the pools' capacitance
VOL_C, VOL_SR, VOL_SS = 0.016404, 0.001094, 0.00005468
K_O, NA_O, CA_O = 5.4, 140.0, 2.0
P_KNA = 0.03
G_NA, G_K1, G_KR = 14.838, 5.405, 0.153
G_TO, G_KS = 0.294, 0.392                 # epicardium
G_CAL = 3.980e-5
G_BNA, G_BCA = 2.9e-4, 5.92e-4
G_PCA, K_PCA, G_PK = 0.1238, 0.0005, 0.0146
P_NAK, K_MK, K_MNA = 2.724, 1.0, 40.0
K_NACA, K_SAT, ALPHA, GAMMA = 1000.0, 0.1, 2.5, 0.35
K_MCA, K_MNAI = 1.38, 87.5
V_MAXUP, K_UP = 0.006375, 0.00025
V_REL, V_LEAK, V_XFER = 0.102, 0.00036, 0.0038
K1P, K2P, K3, K4 = 0.15, 0.045, 0.060, 0.005
EC, MAX_SR, MIN_SR = 1.5, 2.5, 1.0
BUF_C, K_BUFC = 0.2, 0.001
BUF_SR, K_BUFSR = 10.0, 0.3
BUF_SS, K_BUFSS = 0.4, 0.00025
GHK_X = 1e-4
GATE_LO, GATE_HI = 1e-5, 0.99999
GATES = ("m", "h", "j", "d", "f", "f2", "r", "s", "xr1", "xr2", "xs")


def sigmoid(x):
    """1 / (1 + exp(x))."""
    return 1.0 / (1.0 + torch.exp(x))


def voltage_gates(v) -> Dict[str, tuple]:
    """(steady state, time constant in ms) of each voltage-gated gate,
    the paper's appendix (epicardial s gate)."""
    out = {}
    a_m = sigmoid((-60.0 - v) / 5.0)
    b_m = 0.1 * sigmoid((v + 35.0) / 5.0) + 0.1 * sigmoid((v - 50.0) / 200.0)
    out["m"] = (sigmoid((-56.86 - v) / 9.03) ** 2, a_m * b_m)

    below = v < -40.0
    hj_inf = sigmoid((v + 71.55) / 7.43) ** 2
    zero = torch.zeros_like(v)
    a_h = torch.where(below, 0.057 * torch.exp(-(v + 80.0) / 6.8), zero)
    b_h = torch.where(below,
                      2.7 * torch.exp(0.079 * v)
                      + 3.1e5 * torch.exp(0.3485 * v),
                      0.77 / (0.13 * (1.0 + torch.exp(-(v + 10.66) / 11.1))))
    out["h"] = (hj_inf, 1.0 / (a_h + b_h))
    a_j = torch.where(below,
                      (-25428.0 * torch.exp(0.2444 * v)
                       - 6.948e-6 * torch.exp(-0.04391 * v)) * (v + 37.78)
                      * sigmoid(0.311 * (v + 79.23)), zero)
    b_j = torch.where(below,
                      0.02424 * torch.exp(-0.01052 * v)
                      * sigmoid(-0.1378 * (v + 40.14)),
                      0.6 * torch.exp(0.057 * v) * sigmoid(-0.1 * (v + 32.0)))
    out["j"] = (hj_inf, 1.0 / (a_j + b_j))

    a_d = 1.4 * sigmoid((-35.0 - v) / 13.0) + 0.25
    b_d = 1.4 * sigmoid((v + 5.0) / 5.0)
    c_d = sigmoid((50.0 - v) / 20.0)
    out["d"] = (sigmoid((-8.0 - v) / 7.5), a_d * b_d + c_d)
    out["f"] = (sigmoid((v + 20.0) / 7.0),
                1102.5 * torch.exp(-(v + 27.0) ** 2 / 225.0)
                + 200.0 * sigmoid((13.0 - v) / 10.0)
                + 180.0 * sigmoid((v + 30.0) / 10.0) + 20.0)
    out["f2"] = (0.67 * sigmoid((v + 35.0) / 7.0) + 0.33,
                 562.0 * torch.exp(-(v + 27.0) ** 2 / 240.0)
                 + 31.0 * sigmoid((25.0 - v) / 10.0)
                 + 80.0 * sigmoid((v + 30.0) / 10.0))
    out["r"] = (sigmoid((20.0 - v) / 6.0),
                9.5 * torch.exp(-(v + 40.0) ** 2 / 1800.0) + 0.8)
    out["s"] = (sigmoid((v + 20.0) / 5.0),
                85.0 * torch.exp(-(v + 45.0) ** 2 / 320.0)
                + 5.0 * sigmoid((v - 20.0) / 5.0) + 3.0)
    a_xr1 = 450.0 * sigmoid((-45.0 - v) / 10.0)
    b_xr1 = 6.0 * sigmoid((v + 30.0) / 11.5)
    out["xr1"] = (sigmoid((-26.0 - v) / 7.0), a_xr1 * b_xr1)
    a_xr2 = 3.0 * sigmoid((-60.0 - v) / 20.0)
    b_xr2 = 1.12 * sigmoid((v - 60.0) / 20.0)
    out["xr2"] = (sigmoid((v + 88.0) / 24.0), a_xr2 * b_xr2)
    a_xs = 1400.0 / torch.sqrt(1.0 + torch.exp((5.0 - v) / 6.0))
    b_xs = sigmoid((v - 35.0) / 15.0)
    out["xs"] = (sigmoid((-5.0 - v) / 14.0), a_xs * b_xs + 80.0)
    return out


def fcass_gate(ca_ss) -> tuple:
    """(steady state, time constant) of the Ca_SS-gated inactivation."""
    q = (ca_ss / 0.05) ** 2
    return 0.6 / (1.0 + q) + 0.4, 80.0 / (1.0 + q) + 2.0


def rest_state() -> Dict[str, float]:
    """The paper's initial potential and pools, the gates at their
    steady states there (float64)."""
    v = torch.tensor(V_REST, dtype=torch.float64)
    st = {"V": V_REST, "Na_i": 7.67, "K_i": 138.3, "Ca_i": 7e-5,
          "Ca_SR": 1.3, "Ca_SS": 7e-5, "R_bar": 1.0}
    st.update({g: float(inf) for g, (inf, _) in voltage_gates(v).items()})
    st["fCass"] = float(fcass_gate(torch.tensor(7e-5,
                                                dtype=torch.float64))[0])
    return st


# the program's plane names for the paper's
PLANES = {"V": "V", "Na_i": "Nai", "K_i": "Ki", "Ca_i": "Cai",
          "Ca_SR": "CaSR", "Ca_SS": "CaSS", "R_bar": "Rq", "fCass": "fcass",
          **{g: g for g in GATES}}


def initial_state(height: int, width: int) -> Dict[str, np.ndarray]:
    """The resting planes with the S1: column 1 at +20 mV."""
    st = {PLANES[k]: np.full((height, width), x, np.float32)
          for k, x in rest_state().items()}
    st["V"][:, 1] = 20.0
    return st


def rush_larsen(g, inf, tau, dt):
    """The exact step of dg/dt = (inf - g) / tau, clipped."""
    return torch.clamp(inf + (g - inf) * torch.exp(-dt / tau),
                       GATE_LO, GATE_HI)


class Model(GridModel):
    min_v, max_v = MIN_V, MAX_V
    # the GHK factor's removable singularity.  Not the h / j branch point:
    # the paper's branches nearly meet at -40 mV (tau_h 2.58 / 2.54 ms,
    # tau_j 53.6 / 52.6 ms); on the card, with the cells near it kept in,
    # the end stage read at most 8.7e-5 over 36 runs
    POLES = (15.0,)

    def __init__(self, sim: Mapping, height: int, width: int, phase,
                 device, dtype=torch.float32):
        super().__init__(sim, height, width, phase, device, dtype)
        if sim.get("skip") or sim.get("cell_type", "epi") != "epi":
            raise ValueError("the tp06 reference covers the epicardial "
                             "cell with every gate advanced every dt")
        self.dt, self.diff = float(sim["dt"]), float(sim["diff"])

    def substep(self, s: State) -> State:
        dt = self.dt
        v = no_flux_border(s["V"])
        self.note_poles(v)
        na, k, ca = s["Nai"], s["Ki"], s["Cai"]
        ca_sr, ca_ss = s["CaSR"], s["CaSS"]

        e_na = RT_F * torch.log(NA_O / na)
        e_k = RT_F * torch.log(K_O / k)
        e_ks = RT_F * torch.log((K_O + P_KNA * NA_O) / (k + P_KNA * na))
        e_ca = 0.5 * RT_F * torch.log(CA_O / ca)
        vf = v / RT_F

        i_na = G_NA * s["m"] ** 3 * s["h"] * s["j"] * (v - e_na)
        x = 2.0 * (v - 15.0) / RT_F
        ghk = torch.where(
            x.abs() < GHK_X, 0.5 * RT_F * (0.25 * ca_ss - CA_O),
            (v - 15.0) * (0.25 * ca_ss * torch.exp(x) - CA_O)
            / torch.expm1(x))
        i_cal = (G_CAL * s["d"] * s["f"] * s["f2"] * s["fcass"]
                 * 4.0 * F / RT_F * ghk)
        i_to = G_TO * s["r"] * s["s"] * (v - e_k)
        i_kr = G_KR * (K_O / 5.4) ** 0.5 * s["xr1"] * s["xr2"] * (v - e_k)
        i_ks = G_KS * s["xs"] ** 2 * (v - e_ks)
        a_k1 = 0.1 / (1.0 + torch.exp(0.06 * (v - e_k - 200.0)))
        b_k1 = ((3.0 * torch.exp(0.0002 * (v - e_k + 100.0))
                 + torch.exp(0.1 * (v - e_k - 10.0)))
                / (1.0 + torch.exp(-0.5 * (v - e_k))))
        i_k1 = (G_K1 * (K_O / 5.4) ** 0.5 * a_k1 / (a_k1 + b_k1)
                * (v - e_k))
        up, down = torch.exp(GAMMA * vf), torch.exp((GAMMA - 1.0) * vf)
        i_naca = (K_NACA * (up * na ** 3 * CA_O
                            - down * NA_O ** 3 * ca * ALPHA)
                  / ((K_MNAI ** 3 + NA_O ** 3) * (K_MCA + CA_O)
                     * (1.0 + K_SAT * down)))
        i_nak = (P_NAK * K_O / (K_O + K_MK) * na / (na + K_MNA)
                 / (1.0 + 0.1245 * torch.exp(-0.1 * vf)
                    + 0.0353 * torch.exp(-vf)))
        i_pca = G_PCA * ca / (K_PCA + ca)
        i_pk = G_PK * (v - e_k) / (1.0 + torch.exp((25.0 - v) / 5.98))
        i_bna = G_BNA * (v - e_na)
        i_bca = G_BCA * (v - e_ca)
        i_ion = (i_na + i_k1 + i_to + i_kr + i_ks + i_cal + i_naca + i_nak
                 + i_pca + i_pk + i_bna + i_bca)

        kcasr = MAX_SR - (MAX_SR - MIN_SR) / (1.0 + (EC / ca_sr) ** 2)
        k1, k2 = K1P / kcasr, K2P * kcasr
        o = k1 * ca_ss ** 2 * s["Rq"] / (K3 + k1 * ca_ss ** 2)
        i_rel = V_REL * o * (ca_sr - ca_ss)
        i_up = V_MAXUP / (1.0 + K_UP ** 2 / ca ** 2)
        i_leak = V_LEAK * (ca_sr - ca)
        i_xfer = V_XFER * (ca_ss - ca)

        out = {}
        for g, (inf, tau) in voltage_gates(v).items():
            out[g] = rush_larsen(s[g], inf, tau, dt)
        out["fcass"] = rush_larsen(s["fcass"], *fcass_gate(ca_ss), dt)
        # dR/dt = K4 (1 - R) - k2 Ca_SS R
        rate = k2 * ca_ss + K4
        out["Rq"] = rush_larsen(s["Rq"], K4 / rate, 1.0 / rate, dt)

        def buffered(c, buf, kb):
            return 1.0 / (1.0 + buf * kb / (c + kb) ** 2)

        out["Cai"] = ca + dt * buffered(ca, BUF_C, K_BUFC) * (
            (i_leak - i_up) * VOL_SR / VOL_C + i_xfer
            - (i_bca + i_pca - 2.0 * i_naca) * C_M / (2.0 * VOL_C * F))
        out["CaSR"] = ca_sr + dt * buffered(ca_sr, BUF_SR, K_BUFSR) * (
            i_up - i_rel - i_leak)
        out["CaSS"] = ca_ss + dt * buffered(ca_ss, BUF_SS, K_BUFSS) * (
            -i_cal * C_M / (2.0 * VOL_SS * F) + i_rel * VOL_SR / VOL_SS
            - i_xfer * VOL_C / VOL_SS)
        out["Nai"] = na - dt * (i_na + i_bna + 3.0 * i_nak + 3.0 * i_naca
                                ) * C_M / (VOL_C * F)
        out["Ki"] = k - dt * (i_k1 + i_to + i_kr + i_ks + i_pk
                              - 2.0 * i_nak) * C_M / (VOL_C * F)
        out["V"] = v - dt * i_ion + self.diff * dt * self.lap(v)
        return out

    def outer_step(self, state: State) -> State:
        for _ in range(DT_PER_STEP):
            state = self.substep(state)
        return state
