"""Hand state and parameters across between numpy (and so the JAX
package) and the port's torch tensors."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.models import courtemanche as court
from fib_tf_tpu_torch.models import luo_rudy, tp06
from fib_tf_tpu_torch.models.beeler_reuter import CHEBY_DEG, GATES
from fib_tf_tpu_torch.parallel import sharding


def state_from_numpy(state: Mapping[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """Copy numpy planes into contiguous float32 tensors on `device`."""
    return {
        k: torch.tensor(np.asarray(v, np.float32), device=device)
        for k, v in state.items()
    }


def state_to_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy a state's tensors back to numpy (a copy on the CPU too: the
    arrays never share memory with the tensors)."""
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in state.items()}


def shard_state(state: Mapping[str, np.ndarray],
                mesh: sharding.Mesh) -> Dict[str, np.ndarray]:
    """Numpy planes (`[H, W]`, or `[D, H, W]` volumes) to a state sharded
    over `mesh`: per key an object array of per-shard float32 tensors on
    the mesh's devices, laid out as the mesh."""
    return sharding.shard_state(
        {k: np.asarray(v, np.float32) for k, v in state.items()}, mesh)


def gather_state(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A sharded state back to whole numpy planes."""
    return sharding.gather_state(state)


def cheby_coef_from_numpy(coef: Mapping[str, np.ndarray],
                          cfg: Optional[SimConfig] = None
                          ) -> Dict[str, np.ndarray]:
    """Validate Beeler-Reuter Chebyshev coefficients (e.g. the JAX
    model's `_cheby_coef`) against the fits of the configuration `cfg`
    (default: the main path's, cheby + cheby_fold + cheby_currents), and
    return float64 copies, ready to assign to a port model's `cheby_coef`,
    so both packages compute with the same constants.  The set is
    `*_inf` and `*_tau` of every gate, `*_rl` with the fold and `i_k1`,
    `i_x1f` with `cheby_currents`, no more and no less; direct rates
    (`cheby=False`) take none."""
    if cfg is not None and not cfg.cheby:
        raise ValueError("direct rates (cheby=False) take no Chebyshev "
                         "coefficients")
    kinds = ("inf", "tau") + (("rl",) if cfg is None or cfg.cheby_fold
                              else ())
    need = [f"{g}_{kind}" for g in GATES for kind in kinds]
    if cfg is None or cfg.cheby_currents:
        need += ["i_k1", "i_x1f"]
    missing = [k for k in need if k not in coef]
    if missing:
        raise ValueError(f"coefficients missing {missing}")
    extra = sorted(set(coef) - set(need))
    if extra:
        raise ValueError(f"unexpected coefficients {extra} for this "
                         f"configuration")
    out = {}
    for k, v in coef.items():
        a = np.array(v, dtype=np.float64)
        if a.shape != (CHEBY_DEG + 1,) or not np.isfinite(a).all():
            raise ValueError(
                f"coefficient {k!r} must be {CHEBY_DEG + 1} finite values")
        out[k] = a
    return out


def court_params_from_numpy(model: court.Courtemanche,
                            cheby: Optional[Mapping[str, np.ndarray]] = None,
                            table: Optional[np.ndarray] = None,
                            het: Optional[Mapping[str, np.ndarray]] = None,
                            scales: Optional[Mapping[str, float]] = None
                            ) -> court.Courtemanche:
    """Carry a Courtemanche model's parameters, as numpy arrays, into the
    port's `model` (a `Courtemanche` or `CourtemancheUltra` of the same
    configuration), so that both compute with the same constants: the
    hybrid Chebyshev fits (the JAX model's `_cheby`: the smooth
    intermediates, with `rl_<gate>` under `cheby_fold`), the table (its
    `_table`, 150 x 30), the het planes (its `het`) and the `g_scale`
    factors (its `scales`).  Each must match the model's configuration:
    fits only with `court_cheby`, a table only with `table`.  Returns
    `model`."""
    if cheby is not None:
        if model.cheby_coef is None:
            raise ValueError("the model takes no Chebyshev fits (set "
                             "court_cheby and not table)")
        if set(cheby) != set(model.cheby_coef):
            raise ValueError(
                f"fits {sorted(cheby)} != the configuration's "
                f"{sorted(model.cheby_coef)}")
        fits = {}
        for k, v in cheby.items():
            a = np.array(v, dtype=np.float64)
            if (a.shape != (court.CHEBY_DEG_COURT + 1,)
                    or not np.isfinite(a).all()):
                raise ValueError(f"fit {k!r} must be "
                                 f"{court.CHEBY_DEG_COURT + 1} finite values")
            fits[k] = a
        model.cheby_coef = fits
    if table is not None:
        if model.table is None:
            raise ValueError("the model takes no table (set table=True)")
        t = np.array(table, dtype=np.float32)
        if t.shape != model.table.shape or not np.isfinite(t).all():
            raise ValueError(f"table must be a finite {model.table.shape} "
                             f"array, got {t.shape}")
        model.table = t
        model._tables.clear()
    return _carry_het_and_scales(model, het, scales)


def _carry_het_and_scales(model, het, scales):
    """Replace the model's het planes and g_scale factors with `het` and
    `scales` where given (set_het / set_scale validate them)."""
    if het is not None:
        model.set_het(**{k: None for k in model.het})
        model.set_het(**dict(het))
    if scales is not None:
        model.set_scale(**{k: None for k in model.scales})
        model.set_scale(**dict(scales))
    return model


def lr1_params_from_numpy(model: luo_rudy.LuoRudy91,
                          g_si: Optional[float] = None,
                          scales: Optional[Mapping[str, float]] = None
                          ) -> luo_rudy.LuoRudy91:
    """Carry a Luo-Rudy model's parameters into the port's `model`: its
    instance `g_si` (the JAX model's attribute, which a caller may have
    set after construction) and its `g_scale` factors (its `scales`).
    Returns `model`."""
    if g_si is not None:
        g = float(g_si)
        if not np.isfinite(g) or g < 0.0:
            raise ValueError(f"g_si must be a finite conductance >= 0, got "
                             f"{g_si}")
        model.g_si = g
    return _carry_het_and_scales(model, None, scales)


def tp06_params_from_numpy(model: tp06.TenTusscher06,
                           cell_type: Optional[str] = None,
                           het: Optional[Mapping[str, np.ndarray]] = None,
                           scales: Optional[Mapping[str, float]] = None
                           ) -> tp06.TenTusscher06:
    """Carry a ten Tusscher-Panfilov model's parameters into the port's
    `model`: its instance `cell_type` ('epi', 'endo' or 'm'), its het
    planes (its `het`: g_to, g_ks, endo, g_kr, each an [H, W] array of the
    model's grid) and its `g_scale` factors (its `scales`).  Returns
    `model`."""
    if cell_type is not None:
        if cell_type not in tp06.CELL_TYPES:
            raise ValueError(f"cell_type must be one of "
                             f"{sorted(tp06.CELL_TYPES)}, got {cell_type!r}")
        model.cell_type = cell_type
    return _carry_het_and_scales(model, het, scales)
