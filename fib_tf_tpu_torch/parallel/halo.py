"""The per-substep halo exchange: one ghost ring per substep (counterpart
of fib_tf_tpu/parallel/halo.py).

The `[H, W]` grid is sharded by rows over a 1D mesh, or by rows and columns
over a 2D mesh.  Every substep each shard rewrites its own part of the
domain's border (SYMMETRIC, only on the shards that own an edge), then
fetches one ghost row from each row neighbour and, on a 2D mesh, one ghost
column from each column neighbour, and takes the 9-point Laplacian of the
extended block; at the domain's edges the ghosts are REFLECT copies of the
shard's own cells.  The result equals `ops.stencil` on the gathered grid.

The reference runs inside `shard_map`, where every shard executes
`geom.laplace` at once and the fetch is a `ppermute`.  Here one process
runs the shards in turn, so the collective is hoisted out of the per-shard
call: `HaloExchange` takes all shards' potentials, enforces their borders
and exchanges the ring, and `HaloExchange.geometry(r, c)`, the counterpart
of the reference's `halo_geometry` / `halo_geometry_2d`, hands shard (r, c)
a `Geometry` bound to the result, good for that one substep.  A phase
field and a diffusion map are static: `extend_phase` / `extend_phase_2d`
extend each shard's block of them by one ring once, and the exchange's
Laplacian takes them (`halo_laplace`'s `phase_ext` / `dmap_ext`).  The
fiber tensor needs the wide-halo path, as in the reference.

This path has no kernel, here as in the reference (`use_kernel` requires
`wide_halo`): the fused block kernel needs the K-ring exchange of
parallel/spmd.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fib_tf_tpu_torch.models.base import Geometry
from fib_tf_tpu_torch.ops import stencil


def _as_grid(blocks: np.ndarray) -> np.ndarray:
    """The shards as a `[rows, cols]` object array (a 1D mesh has one
    column)."""
    return blocks.reshape(blocks.shape[0], -1)


def _fetch(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x if x.device == like.device else x.to(like.device)


def halo_enforce_boundary(x: torch.Tensor, ri: int, rn: int, ci: int = 0,
                          cn: int = 1, two_d: bool = False) -> torch.Tensor:
    """SYMMETRIC border rewrite on shard (ri, ci) of an rn x cn mesh: row
    replacement only on the shards that own the domain's top / bottom edge;
    column replacement everywhere on a 1D mesh (columns are unsharded) and
    only on the left / right shards of a 2D mesh.  Needs >= 2 rows (and
    columns) per shard."""
    x = x.clone()
    if ri == 0:
        x[0] = x[1]
    if ri == rn - 1:
        x[-1] = x[-2]
    if not two_d or ci == 0:
        x[:, 0] = x[:, 1]
    if not two_d or ci == cn - 1:
        x[:, -1] = x[:, -2]
    return x


def extend_rows(blocks: np.ndarray) -> np.ndarray:
    """`[h, w]` shards -> `[h+2, w]`: the upper neighbour's last row above,
    the lower neighbour's first row below; at the domain's edges the
    REFLECT rule (mirror excluding the edge row)."""
    grid = _as_grid(blocks)
    rn, cn = grid.shape
    out = np.empty_like(grid)
    for r in range(rn):
        for c in range(cn):
            x = grid[r, c]
            top = _fetch(grid[r - 1, c][-1:], x) if r > 0 else x[1:2]
            bottom = _fetch(grid[r + 1, c][:1], x) if r < rn - 1 else x[-2:-1]
            out[r, c] = torch.cat([top, x, bottom], dim=0)
    return out.reshape(blocks.shape)


def extend_cols(blocks: np.ndarray) -> np.ndarray:
    """`[h, w]` shards -> `[h, w+2]` with ghost columns from the column
    neighbours; the domain's edges REFLECT."""
    grid = _as_grid(blocks)
    rn, cn = grid.shape
    out = np.empty_like(grid)
    for r in range(rn):
        for c in range(cn):
            x = grid[r, c]
            left = _fetch(grid[r, c - 1][:, -1:], x) if c > 0 else x[:, 1:2]
            right = (_fetch(grid[r, c + 1][:, :1], x) if c < cn - 1
                     else x[:, -2:-1])
            out[r, c] = torch.cat([left, x, right], dim=1)
    return out.reshape(blocks.shape)


def extend_2d(blocks: np.ndarray) -> np.ndarray:
    """`[h, w]` shards -> `[h+2, w+2]`, the full one-ring extension over a
    2D mesh, in two phases: the column phase works on the row-EXTENDED
    blocks, so each ghost column carries its sender's own row ghosts, which
    are the four diagonal corner cells the 9-point stencil needs.  No
    separate corner messages."""
    return extend_cols(extend_rows(blocks))


def halo_laplace(xp: torch.Tensor,
                 phase_ext: Optional[torch.Tensor] = None,
                 dmap_ext: Optional[torch.Tensor] = None) -> torch.Tensor:
    """9-point Laplacian of a shard from its one-ring extension `[h+2,
    w+2]`, summed in the order of `ops.stencil.laplace`, equal to it on the
    gathered grid.  `phase_ext` / `dmap_ext`, if given, are the shard's
    phase field / relative diffusion map extended to `[h+2, w+2]` by
    `extend_phase` / `extend_phase_2d` (the reference's halo_laplace and
    halo_laplace_2d)."""
    l = (
        xp[:-2, 1:-1] + xp[2:, 1:-1] + xp[1:-1, :-2] + xp[1:-1, 2:]
        + 0.5 * (xp[:-2, :-2] + xp[2:, :-2] + xp[:-2, 2:] + xp[2:, 2:])
        - 6.0 * xp[1:-1, 1:-1]
    )
    if dmap_ext is not None:
        l = dmap_ext[1:-1, 1:-1] * l
        q = dmap_ext * phase_ext if phase_ext is not None else dmap_ext
        phi_c = phase_ext[1:-1, 1:-1] if phase_ext is not None else 1.0
        return l + stencil.conduction_correction(xp, q, phi_c)
    if phase_ext is not None:
        l = l + stencil.phase_field_correction(xp, phase_ext)
    return l


def extend_phase(blocks: np.ndarray) -> np.ndarray:
    """A row-sharded static map (`[h, w]` shards) extended to `[h+2, w+2]`
    once: ghost rows from the neighbours (REFLECT at the domain's edges)
    and a REFLECT column pad, the padded ϕ of the unsharded stencil."""
    grid = _as_grid(extend_rows(blocks))
    out = np.empty_like(grid)
    for r in range(grid.shape[0]):
        out[r, 0] = F.pad(grid[r, 0][None], (1, 1), mode="reflect")[0]
    return out.reshape(blocks.shape)


def extend_phase_2d(blocks: np.ndarray) -> np.ndarray:
    """A static map sharded over a 2D mesh, extended to `[h+2, w+2]`
    once (`extend_2d`)."""
    return extend_2d(blocks)


class HaloExchange:
    """One substep's collective over all shards: the border rewrite of
    every shard's potential, then the one-ring exchange."""

    def __init__(self, pots: np.ndarray, two_d: bool,
                 phase_ext: Optional[np.ndarray] = None,
                 dmap_ext: Optional[np.ndarray] = None):
        """`phase_ext` / `dmap_ext`: the shards' extended maps
        (`extend_phase` / `extend_phase_2d`), laid out as `pots`."""
        grid = _as_grid(pots)
        rn, cn = grid.shape
        self._pots = grid
        self._maps = [None if m is None else _as_grid(m)
                      for m in (phase_ext, dmap_ext)]
        v0 = np.empty_like(grid)
        for r in range(rn):
            for c in range(cn):
                v0[r, c] = halo_enforce_boundary(grid[r, c], r, rn, c, cn,
                                                 two_d)
        self._v0 = v0
        if two_d:
            self._xp = _as_grid(extend_2d(v0))
        else:
            # columns are unsharded: a local REFLECT pad
            self._xp = np.empty_like(grid)
            for r, x in enumerate(extend_rows(v0)[:, 0]):
                self._xp[r, 0] = F.pad(x[None], (1, 1), mode="reflect")[0]

    def geometry(self, r: int, c: int = 0) -> Geometry:
        """Shard (r, c)'s operators for this substep.  They answer only
        for the tensors the exchange was made from: `enforce_boundary` for
        the shard's potential, `laplace` for what `enforce_boundary`
        returned."""
        pot, v0, xp = self._pots[r, c], self._v0[r, c], self._xp[r, c]
        phase_ext, dmap_ext = (None if m is None else m[r, c]
                               for m in self._maps)

        def enforce_boundary(x):
            if x is not pot:
                raise ValueError("this halo geometry was exchanged for "
                                 "another tensor")
            return v0

        def laplace(x):
            if x is not v0:
                raise ValueError("this halo geometry was exchanged for "
                                 "another tensor")
            return halo_laplace(xp, phase_ext, dmap_ext)

        return Geometry(laplace=laplace, enforce_boundary=enforce_boundary)

