"""Finite-difference grid operators on `[H, W]` float32 tensors (or
stacks of them, `[..., H, W]`, taken slice by slice).

The main-path subset of fib_tf_tpu/ops/stencil.py, held to it by
tests/test_torch_ops.py:
  * `laplace`          — 9-point stencil, diagonals x0.5, centre -6,
                         REFLECT padding (stencil.py:36-83, no phase/dmap);
  * `enforce_boundary` — SYMMETRIC pad of the interior (stencil.py:238-244);
  * `pace_mask` / `apply_pace` — stimulation masks and `max(pot, mask)`
                         firing (stencil.py:328-360).

The Laplacian is built from shifted slices, never from `conv2d`: on the
card cuDNN runs float32 convolutions in TF32 by default.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pad1(x: torch.Tensor, mode: str) -> torch.Tensor:
    # pads the last two axes; F.pad's reflect/replicate modes want a
    # batched (3D/4D) tensor, so [H, W] and [D, H, W] get one leading axis
    return F.pad(x[None], (1, 1, 1, 1), mode=mode)[0]


def laplace(x: torch.Tensor) -> torch.Tensor:
    """2D 9-point Laplacian with REFLECT boundary handling, per slice of
    `[..., H, W]`: l = N + S + W + E + 0.5*(NW + SW + NE + SE) - 6*C,
    summed in the order of fib_tf_tpu.ops.stencil.laplace."""
    xp = _pad1(x, "reflect")
    return (
        xp[..., :-2, 1:-1] + xp[..., 2:, 1:-1] + xp[..., 1:-1, :-2]
        + xp[..., 1:-1, 2:]
        + 0.5 * (xp[..., :-2, :-2] + xp[..., 2:, :-2] + xp[..., :-2, 2:]
                 + xp[..., 2:, 2:])
        - 6.0 * xp[..., 1:-1, 1:-1]
    )


def enforce_boundary(x: torch.Tensor) -> torch.Tensor:
    """No-flux (Neumann) boundary, per slice of `[..., H, W]`: border
    rows/columns take their inner neighbours' values.  torch has no
    'symmetric' pad; a 1-cell symmetric pad of the interior equals a
    'replicate' pad."""
    return _pad1(x[..., 1:-1, 1:-1], "replicate")


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
