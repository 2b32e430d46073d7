"""Typed simulation configuration: the port's own copy of
fib_tf_tpu/config.py.

The port imports nothing of the JAX package, so it carries this copy of
`SimConfig` (numpy/stdlib only).  tests/test_torch_config.py pins it equal
to the reference: the same fields and defaults, the same derived
quantities and the same rejected configurations.  Fields whose features
the port has not carried yet (mesh_shape, rotor_probe, adaptive_dv, ...)
are accepted here and rejected by the model or the engine that would run
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static (trace-time) simulation parameters.

    Frozen + hashable so it can close over jitted step functions as a
    compile-time constant; changing any field recompiles, mirroring the
    reference where these were baked into the TF graph at define() time.
    """

    # -- grid ----------------------------------------------------------------
    width: int = 512            # grid width in cells
    height: int = 512           # grid height in cells

    # -- time stepping -------------------------------------------------------
    dt: float = 0.1             # integration time step (ms)
    dt_per_plot: float = 10     # plot/probe interval in dt units
    duration: float = 1000.0    # total simulated time (ms)

    # -- physics ---------------------------------------------------------
    diff: float = 1.5           # diffusion coefficient
    # Anisotropic conduction (the 2D realization of the fiber `normal`
    # the reference carried in its native Config, common.h:21-24, but
    # never used from Python): fibers at `fiber_angle` radians from the
    # x axis conduct with coefficient `diff`, cross-fiber with
    # `diff * fiber_ratio`.  None = isotropic (reference behavior).
    fiber_angle: Optional[float] = None
    fiber_ratio: float = 1.0

    # -- compile-time optimization variants (reference br.py:98-107, 132-135)
    skip: bool = False          # multi-rate slow-gate skipping
    cheby: bool = True          # Chebyshev polynomial rate approximation
    table: bool = False         # voltage-indexed lookup table (courtemanche.h:352-357)
    fast_currents: bool = True  # share exp(0.04V) across iK1/ix1 (br.py:153-158)
    # Fold the Rush-Larsen multiplier expm1(-dt/tau(V)) into the
    # definition-time Chebyshev fit (dt is a compile-time constant), so the
    # per-substep gate update needs no divide or exponential at all — a
    # TPU-native extension of the reference's tau-fit scheme with the same
    # order of fit error.  Set False for the reference-faithful tau fit.
    cheby_fold: bool = True
    # Also Chebyshev-fit the V-only membrane currents (whole iK1, and the
    # ix1 voltage prefactor), reusing the gate fits' term chain — the last
    # transcendentals leave the Beeler-Reuter substep.  Requires cheby.
    cheby_currents: bool = True
    # Hybrid Chebyshev for Courtemanche: fit the 24 smooth intermediates
    # (deg 12), keep the branchy h/j rates direct.  Accurate (0.56 mV max
    # over an AP) but measured ~10% SLOWER than direct evaluation on v5e —
    # TPU transcendentals are cheap — so opt-in, not default.  Note the
    # plain `cheby` flag is ignored by Courtemanche, as in the reference
    # (its court Chebyshev path was dead code, court.py:463-477).
    court_cheby: bool = False
    # Second-order Adams-Bashforth for the explicit-Euler state updates
    # (Fenton: all four planes; Beeler-Reuter: V and Ca).  The reference's
    # native traits reserve the 2x parameter storage for this behind
    # `#ifdef ADAMS_BASHFORTH` (ionic.h:15-19) without implementing it;
    # here it is a working opt-in.  Rush-Larsen gates are unaffected, and
    # Courtemanche (host-split multi-rate) does not support it.
    ab2: bool = False
    # Opt-in stability guard for Courtemanche: cap |ΔV| per substep at
    # this many mV.  The court analog of BR's reference V-clip
    # (br.py:167-168); prevents the explicit-Euler blowup the reference
    # silently integrated through in long fibrillatory runs.  None
    # (default) = exact reference behavior.  Physiological upstrokes
    # move ~2-4 mV per 0.1 ms substep, so 25.0 only engages in genuine
    # instability.
    dv_max: Optional[float] = None
    # Adaptive-dt step-doubling (ops/adaptive.py; beyond reference
    # parity — the *correct* alternative to the dv_max clip): when a
    # substep moves any cell's V by more than this many mV, re-take it
    # as two half-dt substeps, recursively down to dt/2**adaptive_depth.
    # The refinement is a lax.cond, so it only costs when triggered; an
    # untriggered run computes the same substeps as the plain integrator
    # (identical to within XLA fusion rounding, ≤1 ulp/step).  None
    # (default) = fixed-dt reference behavior.  Mutually exclusive with
    # dv_max (pick clip or refine) and ab2 (no consistent multi-dt
    # history); single-chip (see ops/adaptive.py on halo staleness).
    adaptive_dv: Optional[float] = None
    adaptive_depth: int = 2
    ultra_slow: bool = False    # court_ultra's ultra-slow Na gate (_us_)
    chronic: bool = True        # chronic-AF remodeling (court.py:167-170)
    # tp06 ventricular cell type: 'epi' | 'endo' | 'm' select one uniform
    # parameter set (models/tp06.CELL_TYPES); 'transmural' builds the
    # canonical heterogeneous wedge — endo / M / epi bands along x at the
    # `cell_type_bands` column fractions, realized as per-pixel g_to /
    # g_Ks / endo-s-gate planes (IonicModel.set_het) so the APD gradient
    # and its alternans/dispersion consequences are first-class.  Only
    # tp06 consumes it (like `ultra_slow` for court_ultra).
    cell_type: str = "epi"
    cell_type_bands: Tuple[float, float] = (0.25, 0.60)
    # Channel-block (drug) interface: per-channel maximal-conductance
    # scale factors, e.g. {"g_Kr": 0.5} = 50% IKr block (a dofetilide-
    # class hERG blocker), {"g_CaL": 0.5} = L-type Ca block (verapamil
    # class).  Pass a dict; it is normalized to a sorted tuple of
    # (name, factor) pairs so the config stays hashable.  Factors are
    # TRACE-TIME constants folded into the compiled step (zero runtime
    # cost on every path — XLA, the fused Mosaic kernels, meshes,
    # ensembles); a factor of exactly 1.0 is bitwise the unscaled model.
    # Valid names are per-model (IonicModel.SCALE_PARAMS — e.g. tp06's
    # CiPA panel g_Na/g_CaL/g_Kr/g_Ks/g_to/g_K1/...); the model raises
    # on unknown channels.  Composes multiplicatively with per-pixel
    # heterogeneity planes (substrate x dose) and court's chronic
    # remodeling.  Beyond reference parity: the reference hard-coded
    # one global remodeling flag (court.py:193-194); this generalizes
    # it to arbitrary per-channel pharmacology across the zoo.
    g_scale: Optional[Tuple[Tuple[str, float], ...]] = None

    # -- observability (reference ionic.py:190-191, 231-241) ------------------
    timeline: bool = False      # capture a profiler trace of one chunk
    timeline_name: str = "timeline.json"
    save_graph: bool = False    # dump compiled HLO instead of a TF graph

    # Live rotor census (new; no reference equivalent — the reference
    # judged rotor content by eye from Screen frames): emit per-outer-step
    # [count, net-charge] of phase singularities from INSIDE the compiled
    # scan (ops/stencil.rotor_metrics), via a time-delay-embedding ring
    # buffer of `rotor_tau_ms` of normalized-potential history carried
    # through the chunk.  Probe key: 'rotors'.  Single-chip feature.
    rotor_probe: bool = False
    rotor_tau_ms: float = 10.0  # embedding delay (ms of sim time)
    rotor_v_star: float = 0.5   # embedding origin in normalized [0,1] V

    # -- engine tuning (new; no reference equivalent) --------------------------
    chunk_ms: Optional[float] = None  # host-loop granularity; default = dt_per_plot*dt
    # step implementation: 'auto' picks the fused Pallas kernel where it is
    # profitable (small-state models, whole grid VMEM-resident) and the
    # XLA scan path elsewhere; 'xla' / 'pallas' force one.
    kernel: str = "auto"
    # Mosaic compile-cliff knob: split each fused-kernel outer step into
    # chained launches of at most this many substeps (one kernel compiled
    # per distinct body — models/base.substep_fns).  Mosaic compile time
    # grows superlinearly in body size (docs/OPTIMIZATIONS.md §8d), so
    # the large models trade a few extra HBM round trips per outer step
    # for a much smaller one-time compile.  None = whole outer step per
    # launch (the measured-fastest steady state for fenton/br/court).
    # Applies to the whole-grid and per-shard block kernels; the tiled
    # kernel's temporal halo is sized for the full group and cannot
    # split.
    substeps_per_launch: Optional[int] = None

    # -- parallelism (new; reference is single-device, SURVEY.md §2) ----------
    # When set, Simulation builds a device mesh of this shape and shards
    # the grid over it; e.g. (8,) rows or (4, 2) rows x cols.
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("x", "y")
    # Which sharded execution path mesh_shape selects:
    #   'auto'  — the explicit halo-exchange path with wide (K-row) halos
    #             and the per-shard fused block kernel when the model and
    #             grid qualify; where they do not, the reference falls back
    #             to GSPMD with a warning naming the disqualifier, and the
    #             port, which has no GSPMD mode yet, raises with it;
    #   'spmd'  — force the wide-halo exchange path (raise if it can't);
    #   'gspmd' — the reference's NamedSharding path (XLA infers the halo
    #             collectives); not ported, raises.
    mesh_mode: str = "auto"

    def __post_init__(self):
        if self.width <= 2 or self.height <= 2:
            raise ValueError("grid must be larger than 3x3")
        if self.dt <= 0:
            raise ValueError("dt must be positive")
        if self.duration < 0:
            raise ValueError("duration must be non-negative")
        if self.kernel not in ("auto", "xla", "pallas"):
            raise ValueError(f"unsupported kernel: {self.kernel}")
        if (self.substeps_per_launch is not None
                and self.substeps_per_launch < 1):
            raise ValueError("substeps_per_launch must be >= 1")
        if self.cell_type not in ("epi", "endo", "m", "transmural"):
            raise ValueError(
                f"unsupported cell_type: {self.cell_type!r} (epi / endo "
                "/ m / transmural)"
            )
        # JSON round trips (utils/checkpoint.load_state, from_dict) hand
        # tuple fields back as lists; normalize so equality and hashing
        # survive a save/load cycle
        object.__setattr__(
            self, "cell_type_bands",
            tuple(float(b) for b in self.cell_type_bands))
        b0, b1 = self.cell_type_bands
        if not 0.0 < b0 < b1 < 1.0:
            raise ValueError(
                "cell_type_bands must satisfy 0 < endo|M < M|epi < 1 "
                f"(got {self.cell_type_bands})"
            )
        if self.mesh_mode not in ("auto", "spmd", "gspmd"):
            raise ValueError(f"unsupported mesh_mode: {self.mesh_mode}")
        if self.g_scale is not None:
            # accept a dict (the natural call-site spelling) and
            # normalize to a sorted tuple of pairs to stay hashable
            pairs = (sorted(self.g_scale.items())
                     if isinstance(self.g_scale, Mapping)
                     else sorted(tuple(p) for p in self.g_scale))
            norm = []
            for name, f in pairs:
                f = float(f)
                if not math.isfinite(f) or f < 0.0:
                    raise ValueError(
                        f"g_scale[{name!r}] must be a finite factor >= 0 "
                        f"(got {f}); 1.0 = no block, 0.0 = full block"
                    )
                norm.append((str(name), f))
            object.__setattr__(self, "g_scale", tuple(norm))
        if not 0.0 < self.fiber_ratio <= 1.0:
            raise ValueError("fiber_ratio must be in (0, 1] "
                             "(cross-fiber fraction of diff)")
        # reject silent no-ops: asking for fibers without anisotropy (or
        # anisotropy without a direction) would run fully isotropic
        if self.fiber_angle is not None and self.fiber_ratio == 1.0:
            raise ValueError(
                "fiber_angle is set but fiber_ratio == 1.0 is isotropic; "
                "set fiber_ratio < 1 (or drop fiber_angle)"
            )
        if self.fiber_angle is None and self.fiber_ratio != 1.0:
            raise ValueError(
                "fiber_ratio != 1.0 requires fiber_angle (the fiber "
                "direction)"
            )
        if self.adaptive_dv is not None:
            if self.adaptive_dv <= 0:
                raise ValueError("adaptive_dv must be positive (mV)")
            if self.adaptive_depth < 1:
                raise ValueError("adaptive_depth must be >= 1")
            if self.dv_max is not None:
                raise ValueError(
                    "adaptive_dv and dv_max are mutually exclusive: pick "
                    "step-doubling refinement or the clip guard"
                )
            if self.ab2:
                raise ValueError(
                    "adaptive_dv is incompatible with ab2: the AB2 "
                    "derivative history has no consistent meaning across "
                    "substeps of varying dt"
                )
            if self.mesh_shape is not None and self.mesh_mode == "spmd":
                raise ValueError(
                    "adaptive_dv cannot run on the shard_map path: halos "
                    "are exchanged once per committed substep, so a shard "
                    "refining locally would read stale neighbor halos.  "
                    "GSPMD has no manual halos — the global acceptance "
                    "predicate partitions (tested) — so mesh_mode='auto' "
                    "routes adaptive runs there"
                )
        if self.rotor_probe:
            if self.rotor_tau_ms <= 0:
                raise ValueError("rotor_tau_ms must be positive")
            if self.mesh_shape is not None and self.mesh_mode == "gspmd":
                raise ValueError(
                    "rotor_probe is not supported on the GSPMD path (the "
                    "delay ring is not partitioned there); use "
                    "mesh_mode='auto'/'spmd' (the shard_map census, "
                    "parallel/spmd.py) or compute rotors post-hoc with "
                    "utils.tips on a saved cube"
                )

    # -- reference-dict interop ------------------------------------------------

    _ALIASES = {
        "samples": None,     # fenton_simple.py:224-232; derived from duration
        "s2_time": None,     # handled by the pacing protocol, not config
    }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SimConfig":
        """Build from a reference-style config dict, ignoring unknown keys
        that the reference treated as free-form attributes."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in fields}
        return cls(**kwargs)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    # -- derived quantities (reference ionic.py:198, 247-252) ------------------

    def samples(self, dt_per_step: int) -> int:
        """Number of outer steps for `duration` (reference ionic.py:198)."""
        return int(self.duration / (dt_per_step * self.dt))

    def millisecond_to_step(self, t_ms: float, dt_per_step: int) -> int:
        """Convert milliseconds to an outer-step index (ionic.py:247-252)."""
        return int(t_ms / (dt_per_step * self.dt))

    def plot_interval(self, dt_per_step: int) -> int:
        """Outer steps between plot frames (reference ionic.py:206)."""
        return max(1, int(self.dt_per_plot / dt_per_step))
