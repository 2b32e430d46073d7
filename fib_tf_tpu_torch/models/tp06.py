"""The ten Tusscher-Panfilov 2006 human ventricular model, "TP06" (port of
fib_tf_tpu/models/tp06.py).

ten Tusscher KHWJ, Panfilov AV. "Alternans and spiral breakup in a human
ventricular tissue model." Am J Physiol Heart Circ Physiol.
2006;291:H1088-H1100.

Nineteen planes: V (diffusing), four ionic pools (Nai, Ki, Cai and the SR
and dyadic-subspace pools CaSR, CaSS), the release adaptation variable Rq
and twelve Hodgkin-Huxley gates; the gates and Rq on Rush-Larsen, V and
the pools on explicit Euler with the paper's instantaneous buffers.  The
L-type Ca current has the GHK form, whose removable singularity at V = 15
mV takes its exact limit where |x| < 1e-4 (x = 2 (V - 15) F/RT).

`cell_type` ('epi', 'endo', 'm') is an instance attribute that a caller may
set after construction (examples/tp06_spiral.py does): the kernels'
parameter block reads it when a step is built.  `cfg.cell_type =
'transmural'` attaches the per-pixel planes g_to, g_ks and endo (the
s-gate blend) of the banded wedge (`transmural_planes`); `set_het(g_kr=)`
adds a relative IKr dose plane.  The twelve `SCALE_PARAMS` compose with the
planes multiplicatively.

Multi-rate (`cfg.skip`): the slow gates f, f2, s, xr1, xs advance once per
outer step by 10 dt (one `solve(n=10)`, then nine `solve(n=0)`); without
skip an outer step is ten `solve(n=1)`.  `adaptive_dv` raises until
ROADMAP Queue 1 item 15 ports it.

Rates are direct; every Python number over a tensor is one IEEE division
(`divide`), as jnp computes it, and the GHK term uses `torch.expm1`, as the
JAX model's XLA path uses `jnp.expm1`.
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

# -- constants: a copy of the JAX model's (pinned equal by
# tests/test_torch_tp06.py) --------------------------------------------------
R_GAS = 8314.472      # J / (kmol K)
TEMP = 310.0          # K
FARADAY = 96485.3415  # C / mol
RTF = R_GAS * TEMP / FARADAY      # 26.7138 mV
F_RT = 1.0 / RTF

K_O = 5.4     # mM
NA_O = 140.0
CA_O = 2.0
PK_NA = 0.03  # Na permeability of I_Ks

CM = 0.185        # membrane capacitance factor of the pool updates
V_C = 0.016404    # cytoplasm
V_SR = 0.001094   # sarcoplasmic reticulum
V_SS = 0.00005468  # dyadic subspace

G_NA = 14.838
G_K1 = 5.405
G_KR = 0.153
G_CAL = 3.980e-5
G_B_NA = 0.00029
G_B_CA = 0.000592
G_P_CA = 0.1238
K_P_CA = 0.0005
G_P_K = 0.0146
P_NAK = 2.724
KM_K = 1.0
KM_NA = 40.0
K_NACA = 1000.0
GAMMA = 0.35
KM_NAI = 87.5
KM_CA = 1.38
K_SAT = 0.1
ALPHA_NACA = 2.5

# cell-type dependent (G_to, G_Ks); 'endo' also has its own s-gate shape
CELL_TYPES = {
    "epi": (0.294, 0.392),
    "endo": (0.073, 0.392),
    "m": (0.294, 0.098),
}

V_REL = 0.102     # mM/ms
K1_PRIME = 0.15
K2_PRIME = 0.045
K3_REL = 0.060
K4_REL = 0.005
MAX_SR = 2.5
MIN_SR = 1.0
EC_SR = 1.5
V_LEAK = 0.00036
V_XFER = 0.0038
VMAX_UP = 0.006375
K_UP = 0.00025
BUF_C, KBUF_C = 0.2, 0.001
BUF_SR, KBUF_SR = 10.0, 0.3
BUF_SS, KBUF_SS = 0.4, 0.00025

GATES_V = ("m", "h", "j", "d", "f", "f2", "r", "s", "xr1", "xr2", "xs")
FAST_GATES = ("m", "h", "j", "r", "d", "xr2")
SLOW_GATES = ("f", "f2", "s", "xr1", "xs")

# explicit-Euler bound (the paper integrates at dt = 0.02 ms)
DT_MAX = 0.05
# |x| below which the GHK drive takes its exact limit
GHK_EPS = 1e-4


def gate_rates(v, xp=torch, which=GATES_V, cell_type="epi", endo_w=None):
    """(inf, tau) pairs of the voltage gates (TP06 appendix forms), under
    torch (float32 planes) or numpy (float64, the initial state).  h and j
    branch at V = -40 mV with both branches evaluated.  `cell_type`
    selects the endocardial s-gate shape; `endo_w`, a blend plane in
    [0, 1], mixes the endo and epi/M s-gate forms per pixel and overrides
    `cell_type` for the s gate."""
    out = {}
    if "m" in which:
        m_inf = divide(1.0, (1.0 + xp.exp((-56.86 - v) / 9.03)) ** 2)
        a = divide(1.0, 1.0 + xp.exp((-60.0 - v) / 5.0))
        b = (divide(0.1, 1.0 + xp.exp((v + 35.0) / 5.0))
             + divide(0.1, 1.0 + xp.exp((v - 50.0) / 200.0)))
        out["m"] = (m_inf, a * b)

    if "h" in which or "j" in which:
        lo = v < -40.0
        hj_inf = divide(1.0, (1.0 + xp.exp((v + 71.55) / 7.43)) ** 2)
    if "h" in which:
        a_h = xp.where(lo, 0.057 * xp.exp(-(v + 80.0) / 6.8), 0.0)
        b_h = xp.where(
            lo,
            2.7 * xp.exp(0.079 * v) + 3.1e5 * xp.exp(0.3485 * v),
            divide(0.77, 0.13 * (1.0 + xp.exp(-(v + 10.66) / 11.1))),
        )
        out["h"] = (hj_inf, divide(1.0, a_h + b_h))
    if "j" in which:
        a_j = xp.where(
            lo,
            (-2.5428e4 * xp.exp(0.2444 * v)
             - 6.948e-6 * xp.exp(-0.04391 * v))
            * (v + 37.78) / (1.0 + xp.exp(0.311 * (v + 79.23))),
            0.0,
        )
        b_j = xp.where(
            lo,
            0.02424 * xp.exp(-0.01052 * v)
            / (1.0 + xp.exp(-0.1378 * (v + 40.14))),
            0.6 * xp.exp(0.057 * v) / (1.0 + xp.exp(-0.1 * (v + 32.0))),
        )
        out["j"] = (hj_inf, divide(1.0, a_j + b_j))

    if "xr1" in which:
        inf = divide(1.0, 1.0 + xp.exp((-26.0 - v) / 7.0))
        a = divide(450.0, 1.0 + xp.exp((-45.0 - v) / 10.0))
        b = divide(6.0, 1.0 + xp.exp((v + 30.0) / 11.5))
        out["xr1"] = (inf, a * b)
    if "xr2" in which:
        inf = divide(1.0, 1.0 + xp.exp((v + 88.0) / 24.0))
        a = divide(3.0, 1.0 + xp.exp((-60.0 - v) / 20.0))
        b = divide(1.12, 1.0 + xp.exp((v - 60.0) / 20.0))
        out["xr2"] = (inf, a * b)
    if "xs" in which:
        inf = divide(1.0, 1.0 + xp.exp((-5.0 - v) / 14.0))
        a = divide(1400.0, xp.sqrt(1.0 + xp.exp((5.0 - v) / 6.0)))
        b = divide(1.0, 1.0 + xp.exp((v - 35.0) / 15.0))
        out["xs"] = (inf, a * b + 80.0)

    if "r" in which:
        inf = divide(1.0, 1.0 + xp.exp((20.0 - v) / 6.0))
        tau = 9.5 * xp.exp(-((v + 40.0) ** 2) / 1800.0) + 0.8
        out["r"] = (inf, tau)
    if "s" in which:
        want_endo = endo_w is not None or cell_type == "endo"
        want_other = endo_w is not None or cell_type != "endo"
        if want_endo:
            inf_e = divide(1.0, 1.0 + xp.exp((v + 28.0) / 5.0))
            tau_e = 1000.0 * xp.exp(-((v + 67.0) ** 2) / 1000.0) + 8.0
        if want_other:
            inf_o = divide(1.0, 1.0 + xp.exp((v + 20.0) / 5.0))
            tau_o = (85.0 * xp.exp(-((v + 45.0) ** 2) / 320.0)
                     + divide(5.0, 1.0 + xp.exp((v - 20.0) / 5.0)) + 3.0)
        if endo_w is not None:
            out["s"] = (endo_w * inf_e + (1.0 - endo_w) * inf_o,
                        endo_w * tau_e + (1.0 - endo_w) * tau_o)
        elif cell_type == "endo":
            out["s"] = (inf_e, tau_e)
        else:
            out["s"] = (inf_o, tau_o)

    if "d" in which:
        inf = divide(1.0, 1.0 + xp.exp((-8.0 - v) / 7.5))
        a = divide(1.4, 1.0 + xp.exp((-35.0 - v) / 13.0)) + 0.25
        b = divide(1.4, 1.0 + xp.exp((v + 5.0) / 5.0))
        g = divide(1.0, 1.0 + xp.exp((50.0 - v) / 20.0))
        out["d"] = (inf, a * b + g)
    if "f" in which:
        inf = divide(1.0, 1.0 + xp.exp((v + 20.0) / 7.0))
        tau = (1102.5 * xp.exp(-((v + 27.0) ** 2) / 225.0)
               + divide(200.0, 1.0 + xp.exp((13.0 - v) / 10.0))
               + divide(180.0, 1.0 + xp.exp((v + 30.0) / 10.0)) + 20.0)
        out["f"] = (inf, tau)
    if "f2" in which:
        inf = divide(0.67, 1.0 + xp.exp((v + 35.0) / 7.0)) + 0.33
        tau = (562.0 * xp.exp(-((v + 27.0) ** 2) / 240.0)
               + divide(31.0, 1.0 + xp.exp((25.0 - v) / 10.0))
               + divide(80.0, 1.0 + xp.exp((v + 30.0) / 10.0)))
        out["f2"] = (inf, tau)
    return out


def fcass_rates(ca_ss, xp=torch):
    """The Ca-gated ICaL inactivation gate: inf and tau from the dyadic
    subspace calcium."""
    sq = (ca_ss / 0.05) ** 2
    return (divide(0.6, 1.0 + sq) + 0.4, divide(80.0, 1.0 + sq) + 2.0)


def k1_inf(v, e_k, xp=torch):
    """Steady-state rectification of I_K1 (an instantaneous gate)."""
    dv = v - e_k
    a = divide(0.1, 1.0 + xp.exp(0.06 * (dv - 200.0)))
    b = (3.0 * xp.exp(0.0002 * (dv + 100.0)) + xp.exp(0.1 * (dv - 10.0))
         ) / (1.0 + xp.exp(-0.5 * dv))
    return a / (a + b)


def ghk_drive(v0, ca_ss, xp=torch):
    """The L-type current's GHK driving term (V - 15) num / (e^x - 1),
    x = 2 (V - 15) F/RT, num = 0.25 CaSS e^x - Ca_o, and its exact limit
    (RT/2F) (0.25 CaSS - Ca_o) where |x| < GHK_EPS."""
    x = 2.0 * (v0 - 15.0) * F_RT
    num = 0.25 * ca_ss * xp.exp(x) - CA_O
    return xp.where(
        xp.abs(x) < GHK_EPS,
        0.5 * RTF * (0.25 * ca_ss - CA_O),
        (v0 - 15.0) * num / xp.expm1(x),
    )


def blended_s_rest(w, v_rest: float = -86.2):
    """Rest steady state of the transmurally blended s gate for an endo
    weight plane `w`: endo pixels take the endo s_inf, the others the
    epi/M one (float32)."""
    endo_inf = float(gate_rates(np.float64(v_rest), xp=np,
                                cell_type="endo")["s"][0])
    other_inf = float(gate_rates(np.float64(v_rest), xp=np,
                                 cell_type="epi")["s"][0])
    return (w * endo_inf + (1.0 - w) * other_inf).astype(np.float32)


def _bands(cfg: SimConfig, n: int):
    """(g_to, g_ks, endo) per position of an axis of `n` cells cut into the
    endo / M / epi bands at `cfg.cell_type_bands`."""
    b0, b1 = cfg.cell_type_bands
    x = np.arange(n, dtype=np.float32) / float(n)
    band = np.where(x < b0, 0, np.where(x < b1, 1, 2))
    g_to = np.choose(band, [CELL_TYPES["endo"][0], CELL_TYPES["m"][0],
                            CELL_TYPES["epi"][0]]).astype(np.float32)
    g_ks = np.choose(band, [CELL_TYPES["endo"][1], CELL_TYPES["m"][1],
                            CELL_TYPES["epi"][1]]).astype(np.float32)
    return g_to, g_ks, (band == 0).astype(np.float32)


def transmural_planes(cfg: SimConfig):
    """Per-pixel (g_to, g_ks, endo) planes of the canonical transmural
    wedge: endo / M / epi bands along x at the `cfg.cell_type_bands`
    column fractions (endo at the left edge).  float32 [H, W] arrays for
    IonicModel.set_het."""
    g_to, g_ks, endo = _bands(cfg, cfg.width)
    full = np.ones((cfg.height, 1), np.float32)
    return full * g_to[None, :], full * g_ks[None, :], full * endo[None, :]


def transmural_volume_state(model, depth: int, s1: bool = True):
    """A depth-banded 3D wedge: `engine.volume.volume_state` with the
    endo / M / epi bands along z (endo at slice 0) at the same
    `cfg.cell_type_bands` fractions, the het planes `[D, H, W]`, and the s
    gate's rest steady state re-blended per voxel.  The model must carry
    cell_type='transmural'."""
    from fib_tf_tpu_torch.engine.volume import volume_state

    if "endo" not in model.het:
        raise ValueError(
            "transmural_volume_state needs cell_type='transmural' "
            "(the 2D constructor attaches the het planes it re-bands)"
        )
    vs = volume_state(model, depth, s1=s1)
    cfg = model.cfg
    g_to, g_ks, endo = _bands(cfg, depth)
    full = np.ones((1, cfg.height, cfg.width), np.float32)
    pre = model.HET_PREFIX
    vs[pre + "g_to"] = g_to[:, None, None] * full
    vs[pre + "g_ks"] = g_ks[:, None, None] * full
    vs[pre + "endo"] = endo[:, None, None] * full
    vs["s"] = blended_s_rest(vs[pre + "endo"])
    return vs


class TenTusscher06(SkipSchedule, IonicModel):
    name = "tp06"
    min_v = -90.0
    max_v = 50.0
    depol = -86.2
    dt_per_step = 10
    pot_key = "V"
    default_dt = 0.02
    # 'epi' | 'endo' | 'm', per instance; 'transmural' attaches the planes
    cell_type = "epi"
    # per-pixel planes: g_to and g_ks absolute, endo the s-gate blend, g_kr
    # a relative IKr dose (1.0 = baseline)
    HET_PARAMS = ("g_to", "g_ks", "endo", "g_kr")
    SCALE_PARAMS = ("g_Na", "g_CaL", "g_Kr", "g_Ks", "g_to", "g_K1",
                    "g_NaK", "g_NaCa", "g_pCa", "g_pK", "g_bNa", "g_bCa")
    positive_states = ("Cai", "CaSR", "CaSS", "Nai", "Ki")
    # where float32 is ill-conditioned, so that a kernel's and the plain
    # path's rounding may part past rtol/atol (tests and chip_smoke.py
    # arbitrate such cells in float64): the GHK drive's removable
    # singularity at V = 15 mV, (V - 15) num / expm1(x) with both factors
    # tending to 0, out to where the exact limit takes over (|x| < 1e-4 is
    # |V - 15| < 1.3e-3 mV)
    ill_conditioned = ((15.0, 15.0),)

    def __init__(self, cfg: SimConfig):
        check_unported(cfg)
        super().__init__(cfg)
        if cfg.dt > DT_MAX and cfg.adaptive_dv is None:
            raise ValueError(
                f"TenTusscher06 is explicit-Euler unstable at dt={cfg.dt} "
                f"(the paper integrates at 0.02 ms); use dt <= {DT_MAX} "
                "(0.02 recommended) or enable adaptive_dv step-doubling"
            )
        if cfg.cell_type == "transmural":
            g_to, g_ks, endo = transmural_planes(cfg)
            self.set_het(g_to=g_to, g_ks=g_ks, endo=endo)
        else:
            self.cell_type = cfg.cell_type

    @property
    def probe_pixel(self):
        """The reference's (20, width // 2), its row clamped to the grid as
        jnp indexing clamps it: tp06_transmural.py's 4-row strip reads its
        last row."""
        return (min(20, self.cfg.height - 1), self.cfg.width // 2)

    # -- state ----------------------------------------------------------------

    def state_keys(self):
        return tuple(sorted(
            ("CaSR", "CaSS", "Cai", "Ki", "Nai", "Rq", "V", "d", "f",
             "f2", "fcass", "h", "j", "m", "r", "s", "xr1", "xr2",
             "xs") + self.het_keys()
        ))

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """Rest at the paper's initial conditions (V = -86.2 mV, Cai =
        CaSS = 7e-5, CaSR = 1.3, Nai = 7.67, Ki = 138.3 mM, Rq = 1), the
        gates at their rest steady states (float64 rates; s per pixel
        under an endo plane) and fcass at its CaSS-rest one; with `s1`,
        column 1 at +20 mV."""
        v_rest = -86.2
        v = self._full(v_rest)
        if s1:
            v[:, 1] = 20.0
        st = {
            "V": v,
            "Cai": self._full(7e-5),
            "CaSS": self._full(7e-5),
            "CaSR": self._full(1.3),
            "Nai": self._full(7.67),
            "Ki": self._full(138.3),
            "Rq": self._full(1.0),
        }
        rates = gate_rates(np.float64(v_rest), xp=np,
                           cell_type=self.cell_type)
        for g, (inf, _tau) in rates.items():
            st[g] = self._full(float(inf))
        if "endo" in self.het:
            st["s"] = blended_s_rest(self.het["endo"], v_rest)
        fc_inf, _ = fcass_rates(np.float64(7e-5), xp=np)
        st["fcass"] = self._full(float(fc_inf))
        return self.attach_het(st)

    # -- dynamics -------------------------------------------------------------

    def currents(self, v0, s):
        """The twelve membrane currents from the PRE-update gates and
        pools, in the JAX model's order (the sum of the V update adds them
        so).  g_to and g_Ks come from the per-pixel planes where attached,
        else the cell type's constants."""
        g_to, g_ks = CELL_TYPES[self.cell_type]
        g_to = self.gscale("g_to", self.het_param(s, "g_to", g_to))
        g_ks = self.gscale("g_Ks", self.het_param(s, "g_ks", g_ks))
        cai, ca_ss = s["Cai"], s["CaSS"]
        nai, ki = s["Nai"], s["Ki"]

        e_na = RTF * torch.log(divide(NA_O, nai))
        e_k = RTF * torch.log(divide(K_O, ki))
        e_ks = RTF * torch.log(divide(K_O + PK_NA * NA_O, ki + PK_NA * nai))
        e_ca = 0.5 * RTF * torch.log(divide(CA_O, cai))

        i_na = (self.gscale("g_Na", G_NA)
                * s["m"] ** 3 * s["h"] * s["j"] * (v0 - e_na))
        i_b_na = self.gscale("g_bNa", G_B_NA) * (v0 - e_na)

        i_cal = (self.gscale("g_CaL", G_CAL)
                 * s["d"] * s["f"] * s["f2"] * s["fcass"]
                 * 4.0 * FARADAY * F_RT * ghk_drive(v0, ca_ss))
        i_b_ca = self.gscale("g_bCa", G_B_CA) * (v0 - e_ca)

        i_to = g_to * s["r"] * s["s"] * (v0 - e_k)
        g_kr = self.gscale("g_Kr", G_KR * float(np.sqrt(K_O / 5.4)))
        kr_dose = self.het_param(s, "g_kr", None)
        if kr_dose is not None:
            g_kr = kr_dose * g_kr
        i_kr = g_kr * s["xr1"] * s["xr2"] * (v0 - e_k)
        i_ks = g_ks * s["xs"] ** 2 * (v0 - e_ks)
        i_k1 = (self.gscale("g_K1", G_K1 * float(np.sqrt(K_O / 5.4)))
                * k1_inf(v0, e_k) * (v0 - e_k))

        evf = torch.exp(GAMMA * v0 * F_RT)
        evf1 = torch.exp((GAMMA - 1.0) * v0 * F_RT)
        i_naca = (
            self.gscale("g_NaCa", K_NACA)
            * (evf * nai ** 3 * CA_O - evf1 * NA_O ** 3 * cai * ALPHA_NACA)
            / ((KM_NAI ** 3 + NA_O ** 3) * (KM_CA + CA_O)
               * (1.0 + K_SAT * evf1))
        )
        i_nak = (
            self.gscale("g_NaK", P_NAK) * K_O * nai
            / ((K_O + KM_K) * (nai + KM_NA)
               * (1.0 + 0.1245 * torch.exp(-0.1 * v0 * F_RT)
                  + 0.0353 * torch.exp(-v0 * F_RT)))
        )
        i_p_ca = self.gscale("g_pCa", G_P_CA) * cai / (K_P_CA + cai)
        i_p_k = (self.gscale("g_pK", G_P_K)
                 * (v0 - e_k) / (1.0 + torch.exp((25.0 - v0) / 5.98)))

        return {
            "i_na": i_na, "i_b_na": i_b_na, "i_cal": i_cal,
            "i_b_ca": i_b_ca, "i_to": i_to, "i_kr": i_kr, "i_ks": i_ks,
            "i_k1": i_k1, "i_naca": i_naca, "i_nak": i_nak,
            "i_p_ca": i_p_ca, "i_p_k": i_p_k,
        }

    def solve(self, state: State, geom: Geometry, n: int = 1) -> State:
        """One substep: Rush-Larsen on the 12 gates and Rq, explicit Euler
        on V (reaction and diffusion) and on the four pools.  `n` is how
        many dt the slow gates advance (0: frozen); everything else
        advances one dt."""
        dt = self.cfg.dt
        v0 = geom.enforce_boundary(state["V"])
        cai, ca_sr, ca_ss = state["Cai"], state["CaSR"], state["CaSS"]
        endo_w = state.get(self.HET_PREFIX + "endo")

        out = {}
        for g, (inf, tau) in gate_rates(
            v0, which=FAST_GATES, cell_type=self.cell_type
        ).items():
            out[g] = rush_larsen(state[g], inf, tau, dt)
        if n > 0:
            for g, (inf, tau) in gate_rates(
                v0, which=SLOW_GATES, cell_type=self.cell_type,
                endo_w=endo_w,
            ).items():
                out[g] = rush_larsen(state[g], inf, tau, dt * n)
        else:
            for g in SLOW_GATES:
                out[g] = state[g]
        fc_inf, fc_tau = fcass_rates(ca_ss)
        out["fcass"] = rush_larsen(state["fcass"], fc_inf, fc_tau, dt)

        cur = self.currents(v0, state)
        i_sum = sum(cur.values())

        # SR release with CaSR-gated rates; dRq/dt is linear in Rq, so its
        # exact update is Rush-Larsen's
        kcasr = MAX_SR - divide(MAX_SR - MIN_SR,
                                1.0 + divide(EC_SR, ca_sr) ** 2)
        k1 = divide(K1_PRIME, kcasr)
        k2 = K2_PRIME * kcasr
        rq_tau = divide(1.0, k2 * ca_ss + K4_REL)
        out["Rq"] = rush_larsen(state["Rq"], K4_REL * rq_tau, rq_tau, dt)
        o_gate = k1 * ca_ss ** 2 * state["Rq"] / (
            K3_REL + k1 * ca_ss ** 2
        )
        i_rel = V_REL * o_gate * (ca_sr - ca_ss)
        i_leak = V_LEAK * (ca_sr - cai)
        i_up = divide(VMAX_UP, 1.0 + divide(K_UP, cai) ** 2)
        i_xfer = V_XFER * (ca_ss - cai)

        buf_c = divide(1.0, 1.0 + divide(BUF_C * KBUF_C, (cai + KBUF_C) ** 2))
        buf_sr = divide(1.0, 1.0 + divide(BUF_SR * KBUF_SR,
                                          (ca_sr + KBUF_SR) ** 2))
        buf_ss = divide(1.0, 1.0 + divide(BUF_SS * KBUF_SS,
                                          (ca_ss + KBUF_SS) ** 2))

        cm_2vcf = CM / (2.0 * V_C * FARADAY)
        out["Cai"] = cai + dt * buf_c * (
            (i_leak - i_up) * V_SR / V_C + i_xfer
            - (cur["i_b_ca"] + cur["i_p_ca"] - 2.0 * cur["i_naca"])
            * cm_2vcf
        )
        out["CaSR"] = ca_sr + dt * buf_sr * (i_up - i_rel - i_leak)
        out["CaSS"] = ca_ss + dt * buf_ss * (
            -cur["i_cal"] * CM / (2.0 * V_SS * FARADAY)
            + i_rel * V_SR / V_SS - i_xfer * V_C / V_SS
        )
        out["Nai"] = state["Nai"] + dt * (
            -(cur["i_na"] + cur["i_b_na"]
              + 3.0 * cur["i_nak"] + 3.0 * cur["i_naca"])
            * CM / (V_C * FARADAY)
        )
        out["Ki"] = state["Ki"] + dt * (
            -(cur["i_k1"] + cur["i_to"] + cur["i_kr"] + cur["i_ks"]
              + cur["i_p_k"] - 2.0 * cur["i_nak"])
            * CM / (V_C * FARADAY)
        )

        out["V"] = v0 + self.cfg.diff * dt * geom.laplace(v0) - dt * i_sum
        return self.carry_het(state, out)
