"""3D (volume) finite-difference operators on `[D, H, W]` float32 tensors.

The main-path subset of fib_tf_tpu/ops/stencil3d.py, held to it by
tests/test_torch_volume.py:
  * `laplace3d`          — the 2D 9-point stencil per z-slice plus a
                           2x-scaled z second difference with REFLECT ends,
                           summed as `planar + (2*dz_ratio)*z`
                           (stencil3d.py:41-93);
  * `enforce_boundary3d` — the SYMMETRIC face rewrite on all three axes
                           (stencil3d.py:211-215);
  * `pace_mask3d`        — the 2D pace mask extruded over z-slices
                           [z0, z1) (stencil3d.py:246-262).

Composed, the rewrite and the Laplacian read V at
[clamp(z+dz), clamp(i+di), clamp(j+dj)] with clamp(k) = min(max(k, 1),
N-2) on each axis, which is what the volume kernels compute.

Phase fields and fiber tensors (`twist_angles`, `fiber_tensors`,
`fiber_tensors3d`) and the ECG lead fields (`ecg_weights`) are not ported
yet (ROADMAP Queue 1 items 9 and 18).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fib_tf_tpu_torch.ops import stencil
from fib_tf_tpu_torch.unported import QUEUE1


def laplace3d(
    x: torch.Tensor,
    phase_padded=None,
    dz_ratio: float = 1.0,
    fiber=None,
) -> torch.Tensor:
    """9-point in-plane + 2x-scaled z second difference, REFLECT ends.
    `dz_ratio` scales conduction along z relative to in-plane (1.0 =
    isotropic).  A phase field or fiber tensor raises: not ported yet."""
    if phase_padded is not None:
        raise NotImplementedError(
            f"phase fields in 3D are not ported yet ({QUEUE1['geometry']})")
    if fiber is not None:
        raise NotImplementedError(
            f"fiber tensors in 3D are not ported yet ({QUEUE1['geometry']})")
    planar = stencil.laplace(x)
    xp = torch.cat([x[1:2], x, x[-2:-1]])
    z = xp[:-2] - 2.0 * x + xp[2:]
    return planar + (2.0 * dz_ratio) * z


def enforce_boundary3d(x: torch.Tensor) -> torch.Tensor:
    """No-flux face rewrite on all three axes: every face voxel takes its
    interior neighbour's value (a 1-cell SYMMETRIC pad of the interior,
    which equals a 'replicate' pad)."""
    inner = x[1:-1, 1:-1, 1:-1]
    return F.pad(inner[None, None], (1, 1, 1, 1, 1, 1),
                 mode="replicate")[0, 0]


def pace_mask3d(
    depth: int,
    height: int,
    width: int,
    loc: str,
    v: float,
    min_v: float,
    z0: int = 0,
    z1: Optional[int] = None,
) -> np.ndarray:
    """Extruded stimulus mask (numpy): the 2D `stencil.pace_mask` on
    z-slices [z0, z1) (default: the full depth), `min_v` elsewhere, for
    `max(pot, mask)` firing."""
    m2 = stencil.pace_mask(height, width, loc, v, min_v)
    m = np.full([depth, height, width], min_v, dtype=np.float32)
    m[z0:z1 if z1 is not None else depth] = m2
    return m
