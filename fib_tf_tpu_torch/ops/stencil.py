"""Finite-difference grid operators on `[H, W]` float32 tensors (or
stacks of them, `[..., H, W]`, taken slice by slice).

The port of fib_tf_tpu/ops/stencil.py's 2D operators, held to it by
tests/test_torch_ops.py and tests/test_torch_geometry.py:
  * `laplace`          — 9-point stencil, diagonals x0.5, centre -6,
                         REFLECT padding, with the phase-field and
                         diffusion-map forms (stencil.py:36-84);
  * `anisotropic_laplace` — the fiber tensor operator, with the same
                         forms (stencil.py:106-159), and its pieces
                         `anisotropic_phase_correction`, `fiber_tensor`,
                         `phase_field_correction`, `conduction_correction`
                         (stencil.py:162-235);
  * `enforce_boundary` — SYMMETRIC pad of the interior (stencil.py:238-244);
  * `add_hole_to_phase_field` / `fibrosis_map` — the host-side geometry
                         builders (numpy; stencil.py:251-325), equal bit
                         for bit to the reference's;
  * `pace_mask` / `apply_pace` — stimulation masks and `max(pot, mask)`
                         firing (stencil.py:328-360).

The Laplacian is built from shifted slices, never from `conv2d`: on the
card cuDNN runs float32 convolutions in TF32 by default.  The geometry
forms take `[H, W]` fields and their REFLECT-padded `[H+2, W+2]` maps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _pad1(x: torch.Tensor, mode: str) -> torch.Tensor:
    # pads the last two axes; F.pad's reflect/replicate modes want a
    # batched (3D/4D) tensor, so [H, W] and [D, H, W] get one leading axis
    return F.pad(x[None], (1, 1, 1, 1), mode=mode)[0]


def _laplace9(xp: torch.Tensor) -> torch.Tensor:
    return (
        xp[..., :-2, 1:-1] + xp[..., 2:, 1:-1] + xp[..., 1:-1, :-2]
        + xp[..., 1:-1, 2:]
        + 0.5 * (xp[..., :-2, :-2] + xp[..., 2:, :-2] + xp[..., :-2, 2:]
                 + xp[..., 2:, 2:])
        - 6.0 * xp[..., 1:-1, 1:-1]
    )


def laplace(
    x: torch.Tensor,
    phase: Optional[torch.Tensor] = None,
    phase_padded: Optional[torch.Tensor] = None,
    dmap_padded: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """2D 9-point Laplacian with REFLECT boundary handling, per slice of
    `[..., H, W]`: l = N + S + W + E + 0.5*(NW + SW + NE + SE) - 6*C,
    summed in the order of fib_tf_tpu.ops.stencil.laplace.

    With a phase field ϕ (`phase`, or its REFLECT-padded `[H+2, W+2]`
    `phase_padded`) the no-flux correction (∇x·∇ϕ)/(4ϕ) is added; with a
    REFLECT-padded relative diffusion map `dmap_padded` the operator is
    d*lap9(x) + (∇x·∇(ϕd))/(4ϕ) (`conduction_correction`)."""
    xp = _pad1(x, "reflect")
    l = _laplace9(xp)
    if phase is not None and phase_padded is None:
        phase_padded = _pad1(phase, "reflect")
    if dmap_padded is not None:
        l = dmap_padded[1:-1, 1:-1] * l
        q = (dmap_padded * phase_padded if phase_padded is not None
             else dmap_padded)
        phi_c = (phase_padded[1:-1, 1:-1] if phase_padded is not None
                 else 1.0)
        return l + conduction_correction(xp, q, phi_c)
    if phase_padded is not None:
        l = l + phase_field_correction(xp, phase_padded)
    return l


def anisotropic_laplace(
    x: torch.Tensor,
    dxx: float,
    dxy: float,
    dyy: float,
    phase_padded: Optional[torch.Tensor] = None,
    dmap_padded: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The anisotropic operator 2*(dxx*Vxx + 2*dxy*Vxy + dyy*Vyy) with
    REFLECT boundary handling (a constant diffusion tensor; rows are y,
    columns x), scaled x2 like the isotropic stencil so that fiber_ratio 1
    conducts as it does.  With `phase_padded` the tensor form of the
    no-flux correction is added; with `dmap_padded`,
    d*(operator) + (∇x·D∇(ϕd))/(4ϕ)."""
    xp = _pad1(x, "reflect")
    c = xp[1:-1, 1:-1]
    vxx = xp[1:-1, :-2] - 2.0 * c + xp[1:-1, 2:]
    vyy = xp[:-2, 1:-1] - 2.0 * c + xp[2:, 1:-1]
    vxy = 0.25 * (xp[2:, 2:] + xp[:-2, :-2] - xp[2:, :-2] - xp[:-2, 2:])
    l = 2.0 * (dxx * vxx + 2.0 * dxy * vxy + dyy * vyy)
    if dmap_padded is not None:
        l = dmap_padded[1:-1, 1:-1] * l
        q = (dmap_padded * phase_padded if phase_padded is not None
             else dmap_padded)
        phi_c = (phase_padded[1:-1, 1:-1] if phase_padded is not None
                 else 1.0)
        gx = xp[1:-1, 2:] - xp[1:-1, :-2]
        gy = xp[2:, 1:-1] - xp[:-2, 1:-1]
        qx = q[1:-1, 2:] - q[1:-1, :-2]
        qy = q[2:, 1:-1] - q[:-2, 1:-1]
        return l + (
            gx * (dxx * qx + dxy * qy) + gy * (dxy * qx + dyy * qy)
        ) / (4.0 * phi_c)
    if phase_padded is not None:
        l = l + anisotropic_phase_correction(xp, phase_padded, dxx, dxy,
                                             dyy)
    return l


def anisotropic_phase_correction(
    x_padded: torch.Tensor,
    phase_padded: torch.Tensor,
    dxx: float,
    dxy: float,
    dyy: float,
) -> torch.Tensor:
    """Tensor form of the phase-field no-flux correction, (∇V·D∇ϕ)/ϕ by
    central differences: (Gx(dxx Px + dxy Py) + Gy(dxy Px + dyy Py))/(4ϕ).
    At D = I it is `phase_field_correction`."""
    X, p = x_padded, phase_padded
    gx = X[1:-1, 2:] - X[1:-1, :-2]
    gy = X[2:, 1:-1] - X[:-2, 1:-1]
    px = p[1:-1, 2:] - p[1:-1, :-2]
    py = p[2:, 1:-1] - p[:-2, 1:-1]
    return (
        gx * (dxx * px + dxy * py) + gy * (dxy * px + dyy * py)
    ) / (4.0 * p[1:-1, 1:-1])


def fiber_tensor(angle_rad: float, ratio: float):
    """Unit diffusion tensor (dxx, dxy, dyy) for fibers at `angle_rad` from
    the x axis: D = R diag(1, ratio) R^T (Python floats, computed as the
    reference does)."""
    c, s = float(np.cos(angle_rad)), float(np.sin(angle_rad))
    dxx = c * c + ratio * s * s
    dyy = s * s + ratio * c * c
    dxy = (1.0 - ratio) * c * s
    return dxx, dxy, dyy


def phase_field_correction(x_padded: torch.Tensor,
                           phase_padded: torch.Tensor) -> torch.Tensor:
    """Phase-field no-flux correction ((∂xX·∂xϕ + ∂yX·∂yϕ) / 4ϕ) of
    REFLECT-padded `[H+2, W+2]` inputs."""
    X, p = x_padded, phase_padded
    return (
        (X[2:, 1:-1] - X[:-2, 1:-1]) * (p[2:, 1:-1] - p[:-2, 1:-1])
        + (X[1:-1, 2:] - X[1:-1, :-2]) * (p[1:-1, 2:] - p[1:-1, :-2])
    ) / (4.0 * p[1:-1, 1:-1])


def conduction_correction(x_padded: torch.Tensor, q_padded: torch.Tensor,
                          phi_center) -> torch.Tensor:
    """Generalised no-flux / heterogeneity correction (∇x·∇q)/(4ϕ) on
    padded arrays, q = ϕ·d; `phi_center` is ϕ at the cell centres (`[H,
    W]`) or the scalar 1.0 without a phase field.  With d ≡ 1 it is
    `phase_field_correction`."""
    X, q = x_padded, q_padded
    return (
        (X[2:, 1:-1] - X[:-2, 1:-1]) * (q[2:, 1:-1] - q[:-2, 1:-1])
        + (X[1:-1, 2:] - X[1:-1, :-2]) * (q[1:-1, 2:] - q[1:-1, :-2])
    ) / (4.0 * phi_center)


def enforce_boundary(x: torch.Tensor) -> torch.Tensor:
    """No-flux (Neumann) boundary, per slice of `[..., H, W]`: border
    rows/columns take their inner neighbours' values.  torch has no
    'symmetric' pad; a 1-cell symmetric pad of the interior equals a
    'replicate' pad."""
    return _pad1(x[..., 1:-1, 1:-1], "replicate")


# -- geometry construction (host-side numpy; definition time) ----------------


def add_hole_to_phase_field(
    phase: Optional[np.ndarray],
    height: int,
    width: int,
    x: float,
    y: float,
    radius: float,
    neg: bool = False,
) -> np.ndarray:
    """Multiply a circular hole into a phase field, creating it if needed
    (a copy of fib_tf_tpu.ops.stencil.add_hole_to_phase_field).

    `neg=False`: a disk obstacle at (x, y), ϕ = 0.5*(tanh(dist - r) + 1);
    `neg=True`: everything OUTSIDE the radius is excluded,
    ϕ = 0.5*(tanh(0.1*(r - dist)) + 1).  Floored at 1e-5: the correction
    divides by ϕ."""
    if phase is None:
        phase = np.ones([height, width], dtype=np.float32)
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    dist = np.hypot(xx - x, yy - y)
    if neg:
        phase = phase * np.asarray(
            0.5 * (np.tanh(0.1 * (radius - dist)) + 1.0), dtype=np.float32
        )
    else:
        phase = phase * np.asarray(
            0.5 * (np.tanh(dist - radius) + 1.0), dtype=np.float32
        )
    return np.maximum(phase, 1e-5).astype(np.float32)


def fibrosis_map(
    height: int,
    width: int,
    density: float = 0.25,
    strength: float = 0.8,
    seed: int = 0,
    patch: int = 4,
) -> np.ndarray:
    """Patchy fibrotic relative-diffusion map (a copy of
    fib_tf_tpu.ops.stencil.fibrosis_map): 1.0 in healthy tissue,
    `1 - strength` in `patch`-cell patches covering about `density` of the
    area, thresholded coarse-grained uniform noise from `seed`."""
    if not 0.0 <= density <= 1.0:
        raise ValueError("density must be in [0, 1]")
    if not 0.0 <= strength <= 1.0:
        raise ValueError("strength must be in [0, 1] (1 = full block)")
    d = np.ones((height, width), np.float32)
    if density <= 0.0 or strength == 0.0:
        return d
    if density >= 1.0:
        return np.full_like(d, 1.0 - strength)
    rng = np.random.RandomState(seed)
    ch = -(-height // patch)
    cw = -(-width // patch)
    noise = rng.rand(ch, cw)
    thr = np.quantile(noise, 1.0 - density)
    fib = np.kron(noise >= thr, np.ones((patch, patch), dtype=bool))
    d[fib[:height, :width]] = 1.0 - strength
    return d


PACE_LOCATIONS = (
    "left", "right", "top", "bottom", "luq", "llq", "ruq", "rlq",
)


def pace_mask(
    height: int, width: int, loc: str, v: float, min_v: float
) -> np.ndarray:
    """Stimulus mask for one of the 8 named locations (numpy; a copy of
    fib_tf_tpu.ops.stencil.pace_mask).  Background is `min_v` so that
    `max(pot, mask)` leaves unstimulated cells untouched."""
    s = np.full([height, width], min_v, dtype=np.float32)
    if loc == "left":
        s[:, :5] = v
    elif loc == "right":
        s[:, -5:] = v
    elif loc == "top":
        s[:5, :] = v
    elif loc == "bottom":
        s[-5:, :] = v
    elif loc == "luq":
        s[1 : height // 2, 1 : width // 2] = v
    elif loc == "llq":
        s[height // 2 : -1, 1 : width // 2] = v
    elif loc == "ruq":
        s[1 : height // 2, width // 2 : -1] = v
    elif loc == "rlq":
        s[height // 2 : -1, width // 2 : -1] = v
    else:
        raise ValueError(f"undefined pace location: {loc!r}")
    return s


def apply_pace(pot: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fire a pacing op: pot <- max(pot, mask)."""
    return torch.maximum(pot, mask)
