"""Model base class and geometry (main-path subset of
fib_tf_tpu/models/base.py).

Models are function factories over a state dict of `[H, W]` (or, in a
volume, `[D, H, W]`) float32 tensors: `initial_state()` returns numpy
planes, `solve(state, geom, n)` advances one substep and
`step(state, geom)` one outer step of `dt_per_step` substeps.  Spatial
operators are injected through a `Geometry` record, so the same model
runs in 2D tissue, in a 3D volume or as a 0D cell.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.ops import stencil, stencil3d
from fib_tf_tpu_torch.unported import QUEUE1, not_ported

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Injected spatial operators: `laplace` is the 9-point REFLECT
    stencil, `enforce_boundary` the SYMMETRIC no-flux border rewrite.
    0D (single-cell) geometry nulls both."""

    laplace: Callable[[torch.Tensor], torch.Tensor]
    enforce_boundary: Callable[[torch.Tensor], torch.Tensor]


def grid_geometry(
    phase: Optional[np.ndarray] = None,
    fiber_angle: Optional[float] = None,
    fiber_ratio: float = 1.0,
    dmap: Optional[np.ndarray] = None,
    device="cpu",
) -> Geometry:
    """Standard 2D tissue geometry (fib_tf_tpu/models/base.py:50-94),
    optionally with a phase field, anisotropic fiber conduction and a
    per-pixel relative diffusion map, its maps on `device`.

    The phase field and the diffusion map are REFLECT-padded once (they
    are static).  With `fiber_angle` set and `fiber_ratio != 1` the
    operator is the fiber tensor's (stencil.anisotropic_laplace);
    `fiber_ratio == 1` keeps the isotropic 9-point stencil, as the
    reference does."""
    fiber = None
    if fiber_angle is not None and fiber_ratio != 1.0:
        fiber = stencil.fiber_tensor(fiber_angle, fiber_ratio)
    return tissue_geometry(phase, fiber, dmap, device)


def _padded_map(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    """A static `[H, W]` map REFLECT-padded to `[H+2, W+2]` float32 on
    `device` (None stays None)."""
    if a is None:
        return None
    return torch.tensor(np.pad(np.asarray(a, np.float32), 1, mode="reflect"),
                        device=device)


def tissue_geometry(
    phase: Optional[np.ndarray] = None,
    fiber: Optional[tuple] = None,
    dmap: Optional[np.ndarray] = None,
    device="cpu",
) -> Geometry:
    """`grid_geometry` from the fiber tensor (dxx, dxy, dyy) itself (or
    None for the isotropic operator), as the kernels take it."""
    pp, dp = _padded_map(phase, device), _padded_map(dmap, device)
    if fiber is not None:
        dxx, dxy, dyy = fiber
        return Geometry(
            laplace=lambda x: stencil.anisotropic_laplace(
                x, dxx, dxy, dyy, phase_padded=pp, dmap_padded=dp),
            enforce_boundary=stencil.enforce_boundary)
    if pp is None and dp is None:
        return Geometry(laplace=stencil.laplace,
                        enforce_boundary=stencil.enforce_boundary)
    return Geometry(
        laplace=lambda x: stencil.laplace(x, phase_padded=pp,
                                          dmap_padded=dp),
        enforce_boundary=stencil.enforce_boundary)


def volume_geometry(
    phase: Optional[np.ndarray] = None,
    dz_ratio: float = 1.0,
    fiber: Optional[tuple] = None,
) -> Geometry:
    """3D `[D, H, W]` tissue geometry: the per-slice 9-point stencil plus
    a 2x-scaled z second difference (ops/stencil3d.laplace3d) and the
    SYMMETRIC rewrite on all faces.  Models run in 3D unchanged: their
    math is elementwise except these two operators.  Extruded phase
    fields and fiber tensors are not ported yet."""
    if phase is not None:
        raise NotImplementedError(
            f"phase fields in 3D are not ported yet ({QUEUE1['geometry']})")
    if fiber is not None:
        raise NotImplementedError(
            f"fiber tensors in 3D are not ported yet ({QUEUE1['geometry']})")
    return Geometry(
        laplace=lambda x: stencil3d.laplace3d(x, dz_ratio=dz_ratio),
        enforce_boundary=stencil3d.enforce_boundary3d,
    )


def cell_geometry() -> Geometry:
    """0D single-cell geometry: no diffusion, no boundary."""
    return Geometry(laplace=torch.zeros_like, enforce_boundary=lambda x: x)


def check_unported(cfg: SimConfig):
    """Reject the variant a small model's port does not carry yet:
    adaptive_dv."""
    if cfg.adaptive_dv is not None:
        not_ported("adaptive_dv", "adaptive")


class IonicModel:
    """Base class of the port's model zoo.

    Subclasses set `name`, `min_v`, `max_v`, `depol`, `dt_per_step`,
    `pot_key` and `SCALE_PARAMS`, and implement `initial_state` and
    `solve`; `step` defaults to `dt_per_step` x `solve`."""

    name: str = "base"
    min_v: float = 0.0
    max_v: float = 1.0
    depol: float = 0.0
    dt_per_step: int = 1
    pot_key: str = "V"
    # channel names set_scale accepts
    SCALE_PARAMS: tuple = ()
    # tick-indexed fast/slow dispatch is not ported; the engine rejects
    # models that set it (ROADMAP Queue 1 item 14)
    fast_slow_ratio: Optional[int] = None
    # [lo, hi] potential windows where the reference's float32 evaluation
    # is ill-conditioned; a kernel's and the plain path's rounding may part
    # there past rtol/atol (tests and chip_smoke.py arbitrate such cells)
    ill_conditioned: tuple = ()

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        # per-pixel parameter planes (set_het); {} = homogeneous tissue
        self.het: Dict[str, np.ndarray] = {}
        # per-channel conductance scale factors; {} = drug-free
        self.scales: Dict[str, float] = {}
        if cfg.g_scale:
            self.set_scale(**dict(cfg.g_scale))

    # -- per-pixel parameter heterogeneity ---------------------------------
    #
    # Each plane rides the state dict under a reserved "_p_<name>" key
    # (fib_tf_tpu/models/base.py:168-245): models read it in solve() and
    # pass it through unchanged, so every path carries it as an ordinary
    # state plane that no substep writes.

    HET_PREFIX = "_p_"
    # names set_het accepts; models with heterogeneity override
    HET_PARAMS: tuple = ()

    def set_het(self, **planes):
        """Attach per-pixel parameter planes, e.g.
        `model.set_het(chronic=mask)`: a finite `[H, W]` array per name
        (None removes a plane).  Must precede initial_state() / define().
        Returns self."""
        het = dict(self.het)
        for name, arr in planes.items():
            if name not in self.HET_PARAMS:
                raise ValueError(
                    f"{type(self).__name__} has no heterogeneous "
                    f"parameter {name!r}; available: {self.HET_PARAMS}"
                )
            if arr is None:
                het.pop(name, None)
                continue
            a = np.asarray(arr, np.float32)
            if a.shape != self.state_shape():
                raise ValueError(
                    f"het plane {name!r} shape {a.shape} != grid "
                    f"{self.state_shape()}"
                )
            if not np.isfinite(a).all():
                raise ValueError(f"het plane {name!r} must be finite")
            het[name] = a
        self.het = het
        return self

    def het_keys(self) -> tuple:
        """State keys of the attached planes."""
        return tuple(self.HET_PREFIX + k for k in sorted(self.het))

    def attach_het(self, state: Dict[str, np.ndarray]):
        """Add the _p_* planes to an initial-state dict."""
        for name, arr in self.het.items():
            state[self.HET_PREFIX + name] = np.asarray(arr, np.float32)
        return state

    def het_param(self, state: State, name: str, default):
        """The per-pixel plane when attached, else the scalar default."""
        return state.get(self.HET_PREFIX + name, default)

    def carry_het(self, state: State, out: State) -> State:
        """Pass the constant planes through a solve() output."""
        for k in state:
            if k.startswith(self.HET_PREFIX):
                out[k] = state[k]
        return out

    # -- channel block (drug) interface -----------------------------------

    def set_scale(self, **factors):
        """Attach per-channel conductance scale factors, e.g.
        `model.set_scale(g_K1=0.5)`.  None removes a factor.  Returns
        self."""
        scales = dict(self.scales)
        for name, f in factors.items():
            if name not in self.SCALE_PARAMS:
                raise ValueError(
                    f"{type(self).__name__} has no scalable channel "
                    f"{name!r}; available: {self.SCALE_PARAMS}"
                )
            if f is None:
                scales.pop(name, None)
                continue
            f = float(f)
            if not np.isfinite(f) or f < 0.0:
                raise ValueError(
                    f"g_scale[{name!r}] must be a finite factor >= 0 "
                    f"(got {f})"
                )
            scales[name] = f
        self.scales = scales
        return self

    def gscale(self, name: str, expr):
        """Scale a conductance (Python float) or a current (tensor) by the
        attached factor; with no factor (or exactly 1.0) the expression is
        returned untouched."""
        f = self.scales.get(name, 1.0)
        return expr if f == 1.0 else f * expr

    # -- state -------------------------------------------------------------

    def state_shape(self):
        return (self.cfg.height, self.cfg.width)

    def _full(self, value: float) -> np.ndarray:
        return np.full(self.state_shape(), value, dtype=np.float32)

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def state_keys(self):
        """Sorted state-plane names."""
        return tuple(sorted(self.initial_state(s1=False).keys()))

    # -- dynamics ----------------------------------------------------------

    def solve(self, state: State, geom: Geometry, n: int = 1) -> State:
        """One substep."""
        raise NotImplementedError

    def substep_fns(self, geom: Geometry):
        """The outer step as `(fns, labels)`: composing `fns` in order is
        `step(state, geom)`, and equal labels mean identical bodies."""
        fn = lambda s: self.solve(s, geom)
        return [fn] * self.dt_per_step, ("solve",) * self.dt_per_step

    # -- the kernels' view -------------------------------------------------

    @property
    def kernel_free(self) -> bool:
        """A configuration that no CUDA cell body carries, which the
        engine runs on the plain path: none by default."""
        return False

    @property
    def launch_schedule(self) -> tuple:
        """The `slow` flag of each kernel launch of an outer step: by
        default the one body, `dt_per_step` times."""
        return (True,) * self.dt_per_step

    def commit(self, state: State, geom: Geometry, slow: bool) -> State:
        """The substep that a kernel launch with `slow` computes, on the
        plain path: by default the one body, which only `slow` selects."""
        if not slow:
            raise ValueError(f"{self.name} has one substep body: slow=True")
        return self.solve(state, geom)

    def extra_probes(self, state: State, phase=None) -> Dict:
        """The probe streams beside "v" of one outer step (`phase`: the
        phase field as a tensor, or None): none by default."""
        return {}

    @property
    def has_uniform_substeps(self) -> bool:
        """True when `step` is exactly `dt_per_step` identical `solve`
        substeps, each applying the stencil once: the precondition for
        splitting an outer step into arbitrary contiguous groups (the
        wide-halo volume path's `halo_k` sub-cadence).  Models with custom
        substep schedules (BR's skip groups) override this."""
        return (type(self).step is IonicModel.step
                and type(self).substep_fns is IonicModel.substep_fns
                and self.cfg.adaptive_dv is None)

    def substep_group(self, state: State, geom: Geometry,
                      count: int) -> State:
        """`count` consecutive substeps; only meaningful when
        `has_uniform_substeps` (callers must check)."""
        for _ in range(count):
            state = self.solve(state, geom)
        return state

    def step(self, state: State, geom: Geometry) -> State:
        """One outer step = the `substep_fns` schedule."""
        fns, _ = self.substep_fns(geom)
        for fn in fns:
            state = fn(state)
        return state

    # -- views -------------------------------------------------------------

    def image(self, state: State) -> torch.Tensor:
        """Potential normalized to [0, 1]."""
        return (state[self.pot_key] - self.min_v) / (self.max_v - self.min_v)

    @property
    def probe_pixel(self):
        """(row, col) of the wavefront-observer pixel."""
        return (20, self.cfg.width // 2)

    def probe(self, state: State) -> torch.Tensor:
        """The normalized potential at `probe_pixel` (0-d tensor)."""
        r, c = self.probe_pixel
        return (state[self.pot_key][r, c] - self.min_v) / (
            self.max_v - self.min_v)


class SkipSchedule:
    """The multi-rate schedule of `cfg.skip` (the reference's Beeler-Reuter
    technique, br.py:96-107), for a model whose `solve(state, geom, n)`
    advances its slow gates by `n` dt: with skip, an outer step is one
    n = `dt_per_step` substep and `dt_per_step` - 1 frozen n = 0 ones;
    without, `dt_per_step` n = 1 substeps.  Beeler-Reuter, Luo-Rudy and
    tp06 mix it in before IonicModel."""

    @property
    def slow_n(self) -> int:
        """How many dt a slow launch advances the slow gates."""
        return self.dt_per_step if self.cfg.skip else 1

    @property
    def has_uniform_substeps(self) -> bool:
        """Without skip the substeps are identical solve(n=1) calls; the
        skip schedule is not splittable at arbitrary boundaries."""
        return not self.cfg.skip and self.cfg.adaptive_dv is None

    @property
    def launch_schedule(self) -> tuple:
        """One slow launch and the frozen ones under skip, all slow (n=1)
        without."""
        return (True,) + (not self.cfg.skip,) * (self.dt_per_step - 1)

    def commit(self, state: State, geom: Geometry, slow: bool) -> State:
        """The n = slow_n substep (`slow`) or the n = 0 one."""
        return self.solve(state, geom, n=self.slow_n if slow else 0)

    def substep_fns(self, geom: Geometry):
        """With skip, the n = dt_per_step substep then the shared n = 0
        body; without, the n = 1 body `dt_per_step` times."""
        k = self.dt_per_step
        if not self.cfg.skip:
            fn = lambda s: self.solve(s, geom, n=1)
            return [fn] * k, ("n1",) * k
        first = lambda s: self.solve(s, geom, n=k)
        rest = lambda s: self.solve(s, geom, n=0)
        return [first] + [rest] * (k - 1), (f"n{k}",) + ("n0",) * (k - 1)
