"""The cell bodies' host side: what every kernel wrapper needs of a model.

A `CellBody` is a model's CUDA cell body (csrc/br_cell.cuh,
br_variant_cell.cuh, fenton_cell.cuh, ms_cell.cuh, court_cell.cuh,
lr1_cell.cuh, tp06_cell.cuh) as the wrappers see it: the prefix of its C
entry points, the configurations it carries, its per-cell planes in the
CUDA struct's order, its packed parameter block, the kernels that host it
and the `Library` its kernels' sources are built as.  `BODIES` is the
catalog: Beeler-Reuter's main path (cheby + cheby_fold + cheby_currents),
its other variants with and without ab2, Fenton with and without ab2 and
Mitchell-Schaeffer in the BR library; Courtemanche and Courtemanche-ultra
in the second (`COURT_LIBRARY`); Luo-Rudy 1991 and ten Tusscher-Panfilov
2006 in the third (`LRTP_LIBRARY`).  `cell_body` picks a model's body,
`body_on` the body a kernel must host; a model without one raises
NotImplementedError.  Table mode has no body: the engine runs it on the
plain path.

Besides the catalog, the checks every wrapper makes of what it launches
on (`check_state`, `check_probe`, `check_maps`), the plane pointers it
passes (`plane_pointers`), the geometry a 2D run takes (`GeometryMaps`:
a phase field, a diffusion map, a fiber tensor; make_pallas_step's
`phase`, `dmap` and `fiber`) and the state update contract of the plain
versions (`write_back`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fib_tf_tpu_torch.models.base import Geometry, IonicModel, tissue_geometry
from fib_tf_tpu_torch.models.beeler_reuter import (
    FAST_CURRENTS,
    G_NA,
    G_NAC,
    G_S,
    GATES,
    RATE_PARAMS,
    BeelerReuter,
)
from fib_tf_tpu_torch.models import courtemanche as court
from fib_tf_tpu_torch.models.courtemanche import (Courtemanche,
                                                  CourtemancheUltra)
from fib_tf_tpu_torch.models import luo_rudy as lr1
from fib_tf_tpu_torch.models import tp06
from fib_tf_tpu_torch.models.fenton import Fenton4v
from fib_tf_tpu_torch.models.luo_rudy import LuoRudy91
from fib_tf_tpu_torch.models.mitchell_schaeffer import MitchellSchaeffer
from fib_tf_tpu_torch.models.tp06 import TenTusscher06

State = Dict[str, torch.Tensor]

# the order of BrParams' fits in br_cell.cuh
FIT_ORDER = (
    "x1_inf", "x1_rl", "m_inf", "m_rl", "h_inf", "h_rl", "j_inf", "j_rl",
    "d_inf", "d_rl", "f_inf", "f_rl", "i_k1", "i_x1f",
)
# the per-cell planes, in the kernels' order (BeelerReuterCell::Plane)
CELL_PLANES = ("C", "m", "h", "j", "d", "f", "x1")
# BrParams (pack_params): the 14 fits' constant terms, their other eight
# coefficients fit by fit, 11 scalars, a pad, then the fits' nine
# coefficients again fit by fit
PARAM_FLOATS = len(FIT_ORDER) * 18 + 12
# BrVariantCell<AB2>::Plane: BR's planes, then with ab2 the derivatives
BR_VARIANT_AB2_PLANES = CELL_PLANES + ("_dC_", "_dV_")
# BrVariantParams: 14 fit slots of 9 coefficients, the 12 x 7 rate table,
# then 21 scalars (_pack_br_variant)
VARIANT_PARAM_FLOATS = 14 * 9 + 12 * 7 + 21
# BrGateMode and BrCurrentMode in br_variant_cell.cuh
GATE_MODES = {"fold": 0, "cheby": 1, "direct": 2}
CURRENT_MODES = {"cheby": 0, "fast": 1, "plain": 2}
# FentonCell::Plane, FentonAb2Cell::Plane and MsCell::Plane
FENTON_PLANES = ("v", "w", "s")
FENTON_AB2_PLANES = FENTON_PLANES + ("_du_", "_dv_", "_dw_", "_ds_")
MS_PLANES = ("h",)
# CourtCell<ULTRA>::Plane: the fast Na_i, m, h, the 17 slow planes, us
# (ultra), then the chronic plane, passed as a null pointer when it is not
# attached (csrc/cell_traits.cuh)
COURT_PLANES = ("Na_i", "m", "h", "j", "K_i", "oa", "oi", "ua", "ui", "xr",
                "xs", "Ca_i", "d", "f", "f_Ca", "Ca_rel", "u_gate", "v_gate",
                "w_gate", "Ca_up", "_p_chronic")
COURT_ULTRA_PLANES = COURT_PLANES[:-1] + ("us", "_p_chronic")
# CourtCell<false>'s cache on kernel 1 (court_cell.cuh Invariant): the fast
# commit's terms that read only slow planes, stored by every slow commit and
# read by the fast commits after it (`CommitCache`, `cache_schedule`)
COURT_CACHE = court.FAST_INVARIANTS
# CourtParams::coef order (court_cell.cuh court::Fit): the smooth fits,
# then the folded multipliers
COURT_FIT_ORDER = court.CHEBY_SMOOTH_KEYS + tuple(
    f"rl_{g}" for g in Courtemanche.FITTED_GATES)
# 36 fits of 13 coefficients, then 28 scalars (_pack_court)
COURT_PARAM_FLOATS = len(COURT_FIT_ORDER) * (court.CHEBY_DEG_COURT + 1) + 28
COURT_RATE_MODES = {"direct": 0, "cheby": 1, "fold": 2}
# Lr1Cell::Plane: Cai, the fast gates, the slow gates
LR1_PLANES = ("Cai", "m", "h", "j", "d", "f", "x")
# Tp06Cell::Plane: the state's sorted keys but V, then the four het planes,
# each passed as a null pointer when it is not attached
# (csrc/cell_traits.cuh)
TP06_HET_PLANES = ("_p_endo", "_p_g_kr", "_p_g_ks", "_p_g_to")
TP06_PLANES = ("CaSR", "CaSS", "Cai", "Ki", "Nai", "Rq", "d", "f", "f2",
               "fcass", "h", "j", "m", "r", "s", "xr1", "xr2",
               "xs") + TP06_HET_PLANES


def _pack_br(model: BeelerReuter) -> np.ndarray:
    """BrParams as a float32 array: the 14 fits' constant terms, their
    other eight coefficients fit by fit, the conductances with their
    g_scale factors folded in (in double, as the plain path's Python
    constants are), dt, diff*dt, the Chebyshev domain, the probe
    normalisation, a pad, then the 14 fits' nine coefficients again
    (br_cell.cuh says which kernels read which)."""
    cfg = model.cfg
    coef = np.stack([np.asarray(model.cheby_coef[k], np.float32)
                     for k in FIT_ORDER])
    scalars = np.array([
        model.gscale("g_Na", G_NA),
        model.gscale("g_NaC", G_NAC),
        model.gscale("g_s", G_S),
        model.scales.get("g_K1", 1.0),
        model.scales.get("g_x1", 1.0),
        cfg.dt,
        cfg.diff * cfg.dt,
        0.5 * (model.max_v + model.min_v),
        0.5 * (model.max_v - model.min_v),
        model.min_v,
        model.max_v - model.min_v,
    ], np.float32)
    return np.concatenate([coef[:, 0], coef[:, 1:].ravel(), scalars,
                           np.zeros(1, np.float32), coef.ravel()])


def _pack_br_variant(model: BeelerReuter) -> np.ndarray:
    """BrVariantParams as a float32 array: the fit slots (gate g's inf fit
    at 2g and its multiplier or tau fit at 2g + 1, then iK1's and ix1f's;
    zeros where the variant fits nothing), RATE_PARAMS, the fast currents'
    constants, the conductances as in `_pack_br`, dt and dt * slow_n,
    diff and diff * dt, the Chebyshev domain, the probe normalisation and
    the two modes."""
    cfg, coef = model.cfg, model.cheby_coef
    second = "rl" if model.gate_mode == "fold" else "tau"
    fits = np.zeros((14, 9), np.float32)
    if model.gate_mode != "direct":
        for i, g in enumerate(GATES):
            fits[2 * i] = coef[f"{g}_inf"]
            fits[2 * i + 1] = coef[f"{g}_{second}"]
    if model.current_mode == "cheby":
        fits[12], fits[13] = coef["i_k1"], coef["i_x1f"]
    rates = np.array([RATE_PARAMS[(g, ab)] for g in GATES for ab in "ab"],
                     np.float32)
    scalars = np.array([
        *(FAST_CURRENTS[k] for k in ("a85", "a53b", "a53", "a23", "a77",
                                     "a35")),
        model.gscale("g_Na", G_NA),
        model.gscale("g_NaC", G_NAC),
        model.gscale("g_s", G_S),
        model.scales.get("g_K1", 1.0),
        model.scales.get("g_x1", 1.0),
        cfg.dt,
        cfg.dt * model.slow_n,
        cfg.diff,
        cfg.diff * cfg.dt,
        0.5 * (model.max_v + model.min_v),
        0.5 * (model.max_v - model.min_v),
        model.min_v,
        model.max_v - model.min_v,
        GATE_MODES[model.gate_mode],
        CURRENT_MODES[model.current_mode],
    ], np.float32)
    return np.concatenate([fits.ravel(), rates.ravel(), scalars])


def _pack_fenton(model: Fenton4v) -> np.ndarray:
    """FentonParams: dt, diff*dt, the three currents' g_scale factors and
    the probe normalisation."""
    cfg, f = model.cfg, model.scales.get
    return np.array([cfg.dt, cfg.diff * cfg.dt, f("g_fi", 1.0),
                     f("g_si", 1.0), f("g_so", 1.0), model.min_v,
                     model.max_v - model.min_v], np.float32)


def _pack_fenton_ab2(model: Fenton4v) -> np.ndarray:
    """FentonAb2Params: as FentonParams, with diff in place of diff*dt."""
    cfg, f = model.cfg, model.scales.get
    return np.array([cfg.dt, cfg.diff, f("g_fi", 1.0), f("g_si", 1.0),
                     f("g_so", 1.0), model.min_v,
                     model.max_v - model.min_v], np.float32)


def _pack_ms(model: MitchellSchaeffer) -> np.ndarray:
    """MsParams: dt, diff*dt, the two currents' g_scale factors, the gate's
    float32 decay factors (the plain path's own) and the probe
    normalisation."""
    cfg, f = model.cfg, model.scales.get
    return np.array([cfg.dt, cfg.diff * cfg.dt, f("g_in", 1.0),
                     f("g_out", 1.0), model.decay_open, model.decay_close,
                     model.min_v, model.max_v - model.min_v], np.float32)


def _pack_court(model: Courtemanche) -> np.ndarray:
    """CourtParams as a float32 array: the fits (zeros where the mode fits
    nothing), the rate mode, whether the chronic plane is attached, the
    conductances with the g_scale factors (and the global chronic flag)
    folded in, each product formed in double in the reference's order, the
    g_scale factors of the currents it scales as tensors, dt of the fast
    and of the slow states, diff * dt, the dV cap, the Chebyshev domain and
    the probe normalisation (its span as a reciprocal, as torch divides a
    tensor by a Python number)."""
    cfg, f = model.cfg, model.scales.get
    fits = np.zeros((len(COURT_FIT_ORDER), court.CHEBY_DEG_COURT + 1),
                    np.float32)
    for i, k in enumerate(COURT_FIT_ORDER):
        if model.cheby_coef is not None and k in model.cheby_coef:
            fits[i] = model.cheby_coef[k]
    c = 1.0 if cfg.chronic else 0.0
    cm = court.CM
    g = model.gscale
    scalars = np.array([
        COURT_RATE_MODES[model.rate_mode],
        1.0 if "chronic" in model.het else 0.0,
        (1.0 - 0.5 * c) * cm * g("g_to", court.G_TO),
        (1.0 - 0.5 * c) * cm,
        (1.0 - 0.7 * c) * cm * g("g_CaL", court.G_CA_L),
        g("g_to", court.G_TO),
        g("g_CaL", court.G_CA_L),
        f("g_Kur", 1.0), f("g_K1", 1.0), f("g_Kr", 1.0), f("g_NaCa", 1.0),
        cm * g("g_Ks", court.G_KS),
        cm * g("g_NaK", court.I_NAK_MAX),
        court.K_O / (court.K_O + court.KM_K_O),
        cm * g("g_bK", court.G_B_K),
        cm * g("g_Na", court.G_NA),
        cm * g("g_bNa", court.G_B_NA),
        cm * g("g_pCa", court.I_CAP_MAX),
        cm * g("g_bCa", court.G_B_CA),
        model.dt_for("V"),
        model.dt_for("Ca_i"),
        cfg.diff * model.dt_for("V"),
        0.0 if cfg.dv_max is None else cfg.dv_max,
        0.0 if cfg.dv_max is None else 1.0,
        0.5 * (model.max_v + model.min_v),
        0.5 * (model.max_v - model.min_v),
        model.min_v,
        1.0 / (model.max_v - model.min_v),
    ], np.float32)
    return np.concatenate([fits.ravel(), scalars])


def _pack_lr1(model: LuoRudy91) -> np.ndarray:
    """Lr1Params as a float32 array: the six conductances with their
    g_scale factors (g_si the instance's, read now: a caller may set it
    after construction), the reversal potentials and Xi's limit, dt, the
    slow gates' dt * slow_n, diff * dt and the probe normalisation (its
    span as a reciprocal, as torch divides a tensor by a Python
    number)."""
    cfg, g = model.cfg, model.gscale
    return np.array([
        g("g_Na", lr1.G_NA), g("g_si", model.g_si), g("g_K", lr1.G_K),
        g("g_K1", lr1.G_K1), g("g_Kp", lr1.G_KP), g("g_b", lr1.G_B),
        lr1.E_NA, lr1.E_K, lr1.E_K1, lr1.E_KP, lr1.E_B, lr1.XI_LIM,
        cfg.dt, cfg.dt * model.slow_n, cfg.diff * cfg.dt,
        model.min_v, 1.0 / (model.max_v - model.min_v),
    ], np.float32)


def _pack_tp06(model: TenTusscher06) -> np.ndarray:
    """Tp06Params as a float32 array: the conductances with their
    g_scale factors folded in, each product formed in double in the plain
    path's order (g_to and g_Ks those of the instance's `cell_type`, read
    now: a caller may set it after construction), the g_to and g_Ks factors
    for the planes, which het planes are attached, whether the cell type is
    'endo', dt, the slow gates' dt * slow_n, diff * dt and the probe
    normalisation."""
    cfg, g, f = model.cfg, model.gscale, model.scales.get
    g_to, g_ks = tp06.CELL_TYPES[model.cell_type]
    root = float(np.sqrt(tp06.K_O / 5.4))
    return np.array([
        g("g_Na", tp06.G_NA), g("g_bNa", tp06.G_B_NA),
        g("g_CaL", tp06.G_CAL), g("g_bCa", tp06.G_B_CA),
        g("g_to", g_to), g("g_Ks", g_ks), g("g_Kr", tp06.G_KR * root),
        g("g_K1", tp06.G_K1 * root), g("g_NaCa", tp06.K_NACA),
        g("g_NaK", tp06.P_NAK) * tp06.K_O,
        g("g_pCa", tp06.G_P_CA), g("g_pK", tp06.G_P_K),
        f("g_to", 1.0), f("g_Ks", 1.0),
        *(1.0 if k in model.het else 0.0
          for k in ("g_to", "g_ks", "endo", "g_kr")),
        1.0 if model.cell_type == "endo" else 0.0,
        cfg.dt, cfg.dt * model.slow_n, cfg.diff * cfg.dt,
        model.min_v, 1.0 / (model.max_v - model.min_v),
    ], np.float32)


@dataclasses.dataclass(frozen=True)
class Library:
    """How a kernel source is built for a set of cell bodies: `prefix`
    names the library (`<prefix>_substep`, `<prefix>_volume`), `defines`
    are the macros that select its entries and `flags` its extra nvcc
    flags."""

    prefix: str
    defines: tuple = ()
    flags: tuple = ()

    def name(self, kernel: str) -> str:
        """The library of the kernel source `kernel` ('substep',
        'volume')."""
        return f"{self.prefix}_{kernel}"


BR_LIBRARY = Library("br")
# the Courtemanche bodies' entries of kernels 1 and 4, their sources'
# second library, compiled beside the first; without contraction into FMA,
# so that the direct rates round as the plain path does on the card
# (csrc/court_cell.cuh)
COURT_LIBRARY = Library("court", ("FIBTORCH_COURT_ENTRIES",),
                        ("-fmad=false",))
# Luo-Rudy's and tp06's entries of kernels 1 and 4, their sources' third
# library, with the same rounding rule (csrc/lr1_cell.cuh, tp06_cell.cuh)
LRTP_LIBRARY = Library("lrtp", ("FIBTORCH_LRTP_ENTRIES",), ("-fmad=false",))
# the kernels that host the bodies of their own libraries (Courtemanche's,
# Luo-Rudy's and tp06's): 1 and 4, and on the sharded paths 3
# (csrc/large_block.cu, not the tile skeleton, whose shared memory does
# not hold their planes) and 6
LARGE_KERNELS = (1, 3, 4, 6)


@dataclasses.dataclass(frozen=True)
class CellBody:
    """A model's CUDA cell body (csrc/br_cell.cuh, br_variant_cell.cuh,
    fenton_cell.cuh, ms_cell.cuh) as the wrappers see it: `name` prefixes
    its C entry points (`<name>_substep`, `<name>_tiled`, ...), `model`
    and `accepts` say which models' configurations it runs, `planes` are
    its per-cell planes in the struct's Plane order (the potential apart),
    `pack` returns its parameter block of `param_floats` float32s, and
    `kernels` are the numbers of the kernels that host it (1 the substep
    kernel, 2 the tiled, 3 the block, 4 the volume substep, 6 the volume
    block kernel; kernel 5 hosts BR's main body alone; the bodies of their
    own libraries take LARGE_KERNELS).  With
    `slow_keeps_potential`, a SLOW launch commits other planes only and
    writes no potential (csrc/cell_traits.cuh).  `library` says how its
    kernels' sources are built: BR_LIBRARY, COURT_LIBRARY for the
    Courtemanche bodies or LRTP_LIBRARY for Luo-Rudy's and tp06's.
    `cache` names the planes of its cache on kernel 1 (csrc/cell_traits.cuh
    kCachePlanes; Courtemanche's COURT_CACHE), empty for none."""

    name: str
    model: type
    accepts: Callable[[IonicModel], bool]
    planes: tuple
    param_floats: int
    pack: Callable[[IonicModel], np.ndarray]
    kernels: tuple = (1, 2, 3, 4, 6)
    slow_keeps_potential: bool = False
    library: Library = BR_LIBRARY
    cache: tuple = ()

    def writes_potential(self, slow: bool) -> bool:
        """Whether a launch of form `slow` writes the potential."""
        return not (slow and self.slow_keeps_potential)


def _br_main(model: BeelerReuter) -> bool:
    """The configuration BeelerReuterCell carries: the main path's."""
    return (model.gate_mode == "fold" and model.current_mode == "cheby"
            and not model.cfg.ab2)


BODIES = {b.name: b for b in (
    CellBody("br", BeelerReuter, _br_main, CELL_PLANES, PARAM_FLOATS,
             _pack_br),
    CellBody("br_variant", BeelerReuter,
             lambda m: not (_br_main(m) or m.cfg.ab2), CELL_PLANES,
             VARIANT_PARAM_FLOATS, _pack_br_variant),
    CellBody("br_variant_ab2", BeelerReuter, lambda m: m.cfg.ab2,
             BR_VARIANT_AB2_PLANES, VARIANT_PARAM_FLOATS, _pack_br_variant),
    CellBody("fenton", Fenton4v, lambda m: not m.cfg.ab2, FENTON_PLANES, 7,
             _pack_fenton),
    CellBody("fenton_ab2", Fenton4v, lambda m: m.cfg.ab2, FENTON_AB2_PLANES,
             7, _pack_fenton_ab2),
    CellBody("ms", MitchellSchaeffer, lambda m: True, MS_PLANES, 8,
             _pack_ms),
    # table mode has no body: the engine routes it to the plain path
    CellBody("court", Courtemanche, lambda m: not m.kernel_free,
             COURT_PLANES, COURT_PARAM_FLOATS, _pack_court, LARGE_KERNELS,
             True, COURT_LIBRARY, COURT_CACHE),
    CellBody("court_ultra", CourtemancheUltra,
             lambda m: not m.kernel_free, COURT_ULTRA_PLANES,
             COURT_PARAM_FLOATS, _pack_court, LARGE_KERNELS, False,
             COURT_LIBRARY),
    CellBody("lr1", LuoRudy91, lambda m: True, LR1_PLANES, 17, _pack_lr1,
             LARGE_KERNELS, False, LRTP_LIBRARY),
    CellBody("tp06", TenTusscher06, lambda m: True, TP06_PLANES, 24,
             _pack_tp06, LARGE_KERNELS, False, LRTP_LIBRARY),
)}

# what each kernel is, for the message of a body it does not host
KERNEL_NAMES = {1: "substep", 2: "tiled", 3: "block", 4: "volume substep",
                6: "volume block"}


def cell_body(model: IonicModel) -> CellBody:
    """The cell body that carries the model's configuration; raises
    NotImplementedError for a model that has none yet."""
    for body in BODIES.values():
        if type(model) is body.model and body.accepts(model):
            return body
    raise NotImplementedError(
        f"no CUDA kernel for model {model.name!r} yet (ROADMAP Queue 1)")


def body_on(model: IonicModel, kernel: int) -> CellBody:
    """The model's cell body, which kernel number `kernel` must host;
    raises NotImplementedError where it does not yet."""
    body = cell_body(model)
    if kernel not in body.kernels:
        raise NotImplementedError(
            f"the {body.name!r} body is not ported to the "
            f"{KERNEL_NAMES[kernel]} kernel (kernel {kernel}): the "
            f"reference never routes it there")
    return body


def hosted(kernel: int):
    """The names of the bodies kernel number `kernel` hosts."""
    return [name for name, b in BODIES.items() if kernel in b.kernels]


def pack_params(model: IonicModel) -> np.ndarray:
    """The model's kernel parameter block as a contiguous float32 array."""
    return np.ascontiguousarray(cell_body(model).pack(model))


def main_body_only(model: IonicModel, kernel: str):
    """Refuse any body but Beeler-Reuter's main one on a kernel that hosts
    it alone (kernel 5)."""
    name = cell_body(model).name
    if name != "br":
        raise NotImplementedError(
            f"the {kernel} kernel runs Beeler-Reuter's main body only "
            f"(cheby + cheby_fold + cheby_currents, no ab2); the {name!r} "
            f"body is not ported to it yet (ROADMAP Queue 2 item D)")


def plane_pointers(state: State, planes, extra: tuple = ()):
    """A ctypes array of the device pointers of `state`'s `planes`, then
    the pointers `extra`; a het plane that is not attached is a null
    pointer."""
    return (ctypes.c_void_p * (len(planes) + len(extra)))(
        *[None if k.startswith(IonicModel.HET_PREFIX) and k not in state
          else state[k].data_ptr() for k in planes], *extra)


class GeometryMaps:
    """A 2D run's static geometry as the kernels and their plain versions
    take it: the phase field ϕ and the relative diffusion map d (`[H, W]`
    numpy float32, or None: ϕ ≡ 1, d ≡ 1) and the fiber tensor (dxx, dxy,
    dyy) (None: the isotropic 9-point operator).  Their tensors are made
    once per device: `plain(device)` is the plain path's `Geometry`,
    `args(device)` the GEOM entries' trailing arguments (the maps'
    pointers, which the kernels read with the state's layout)."""

    def __init__(self, shape, phase: Optional[np.ndarray] = None,
                 fiber: Optional[tuple] = None,
                 dmap: Optional[np.ndarray] = None):
        self.shape = tuple(shape)
        self.phase = self._map(phase, "phase")
        self.dmap = self._map(dmap, "dmap")
        self.fiber = (None if fiber is None
                      else tuple(float(f) for f in fiber))
        if self.fiber is not None and len(self.fiber) != 3:
            raise ValueError(f"fiber must be (dxx, dxy, dyy), got {fiber}")
        self._tensors: Dict[torch.device, tuple] = {}
        self._plain: Dict[torch.device, Geometry] = {}

    def _map(self, a, name):
        if a is None:
            return None
        a = np.ascontiguousarray(a, np.float32)
        if a.shape != self.shape:
            raise ValueError(f"{name} has shape {a.shape}, the grid is "
                             f"{self.shape}")
        return a

    @property
    def empty(self) -> bool:
        """No geometry: the isotropic kernels and stencil."""
        return self.phase is None and self.dmap is None and self.fiber is None

    def tensors(self, device) -> tuple:
        """(phase, dmap) as float32 tensors on `device` (or None)."""
        device = torch.device(device)
        if device not in self._tensors:
            self._tensors[device] = tuple(
                None if a is None else torch.tensor(a, device=device)
                for a in (self.phase, self.dmap))
        return self._tensors[device]

    def plain(self, device) -> Geometry:
        """The plain operators (`tissue_geometry`) with the maps on
        `device`."""
        device = torch.device(device)
        if device not in self._plain:
            self._plain[device] = tissue_geometry(self.phase, self.fiber,
                                                  self.dmap, device)
        return self._plain[device]

    def args(self, device) -> tuple:
        """The GEOM entries' trailing arguments on `device`."""
        return kernel_geometry_args(*self.tensors(device), self.fiber)


def kernel_geometry_args(phase: Optional[torch.Tensor],
                         dmap: Optional[torch.Tensor],
                         fiber: Optional[tuple]) -> tuple:
    """The GEOM entries' trailing arguments (kernels/binding.py GEOMETRY)
    for the maps `phase` / `dmap` (tensors of the state's layout, or None)
    and the fiber tensor."""
    dxx, dxy, dyy = fiber if fiber is not None else (1.0, 0.0, 1.0)
    return (None if phase is None else phase.data_ptr(),
            None if dmap is None else dmap.data_ptr(),
            int(fiber is not None), dxx, dxy, dyy)


def check_maps(maps, shape, dev: torch.device):
    """The maps a GEOM launch reads: float32, contiguous, of the state's
    `shape` and on its device `dev`."""
    for name, t in zip(("phase", "dmap"), maps):
        if t is None:
            continue
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 {tuple(shape)} tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def check_state(model: IonicModel, state: State,
                shape=None) -> torch.device:
    """Validate the planes a substep reads and writes; return their
    device.  Raises on a missing plane or on any other device, dtype,
    shape (`shape`, default the model's [H, W]) or memory layout than the
    kernel takes."""
    shape = model.state_shape() if shape is None else tuple(shape)
    keys = model.state_keys()
    missing = [k for k in keys if k not in state]
    if missing:
        raise ValueError(f"state is missing planes {missing}")
    pot = model.pot_key
    dev = state[pot].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for k in keys:
        t = state[k]
        if t.device != dev:
            raise ValueError(f"plane {k!r} is on {t.device}, {pot} on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"plane {k!r} is {t.dtype}, not float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"plane {k!r} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"plane {k!r} is not contiguous")
    if dev.type == "cuda":
        ptrs = {state[k].data_ptr() for k in keys}
        if len(ptrs) != len(keys):
            raise ValueError("state planes must not share memory")
    return dev


def check_probe(probe: Optional[torch.Tensor], probe_index: int,
                dev: torch.device, pixel, shape):
    """Validate a probe buffer and index, and that `pixel` lies in
    `shape`."""
    if probe is None:
        return
    if (probe.device != dev or probe.dtype != torch.float32
            or probe.dim() != 1 or not probe.is_contiguous()):
        raise ValueError("probe must be a contiguous 1-D float32 tensor on "
                         f"{dev}")
    if not 0 <= probe_index < probe.numel():
        raise IndexError(f"probe_index {probe_index} outside "
                         f"[0, {probe.numel()})")
    if not all(0 <= p < n for p, n in zip(pixel, shape)):
        raise ValueError(f"probe pixel {tuple(pixel)} outside the "
                         f"{'x'.join(map(str, shape))} grid")


def write_back(state: State, new: State, pot_key: str) -> State:
    """Write a model's `solve` result into `state` under the kernels'
    contract: the potential is replaced, the other planes are
    overwritten in place."""
    for k, t in new.items():
        if k == pot_key:
            state[k] = t
        elif t is not state[k]:
            state[k].copy_(t)
    return state

