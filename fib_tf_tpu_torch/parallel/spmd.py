"""The sharded chunk: `length` outer steps of a grid sharded over a mesh,
with explicit halo exchange between neighbouring shards (counterpart of
fib_tf_tpu/parallel/spmd.py::make_spmd_chunk, with its "v", "trend" and
"ultra" streams; its electrode, ECG and rotor observables are not ported).

Layout: every `[H, W]` state plane is sharded by rows over a 1D mesh, or by
rows and columns over a 2D mesh.  Two comm schedules:

  * per substep (`wide_halo=False`): one ghost ring per kernel launch of
    the outer step (`model.launch_schedule`, each launch's plain work
    `model.commit`; Courtemanche's substep 0 is two), parallel/halo.py,
    plain PyTorch only;
  * wide halo (`wide_halo=True`): each shard's block is extended by
    K = dt_per_step ghost rows (and columns), exchanged once per OUTER step;
    the whole fused substep group then runs on the extension, whose ghosts
    turn to garbage one ring per substep, and the still-valid centre is
    kept.  Per shard the group is the block kernel (`use_kernel=True`,
    ops/cuda_block.py; csrc/br_block.cu, or csrc/large_block.cu for the
    four large models, on CUDA tensors) or the plain step under
    `block_geometry`.

Geometry: a phase field and a diffusion map are static, so each shard's
block of them is extended once (`shard_maps`: by K rings for the wide halo,
wrapped round the domain as the reference's ring exchange does, by one ring
for the per-substep exchange) and every step reads it; the fiber tensor
needs the wide halo (spmd.py:231-236).  A 2x2 mesh's K x K corners, which
the tensor's mixed derivative reads, ride the column exchange of the
row-extended block.

One process drives all shards.  On CUDA devices each shard works on its own
stream, also when shards share a card, and `torch.cuda.Event`s order a
shard's step against its neighbours' halo copies (see `_WideHalo`); on the
CPU the same calls run in turn.

Probes (the reference's masked psums, spmd.py:452-479), all in buffers on
the device of the shard that owns the "v" probe pixel, read back with one
copy per chunk:
  * "v": written by the shard that owns the probe pixel: the kernel gets
    the probe buffer on that shard only;
  * "trend" (`trend_points`, ((state key, row, column), ...); the engine
    passes the model's): `[length, n_points]`, each point copied after the
    step by the shard that owns its pixel;
  * "ultra" (a model with `ultra_fields`, Courtemanche-ultra):
    `[length, 5]` phase-weighted means; each shard sums x * w over its own
    cells (w its block of the phase field, or ones) after the step, and
    the partial sums are added and divided by the weight total, reduced
    once per chunk, when the chunk ends.  The order of the sum differs
    from the unsharded one, so the means may differ in the last bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fib_tf_tpu_torch.models.base import IonicModel
from fib_tf_tpu_torch.ops import cuda_block
from fib_tf_tpu_torch.parallel import halo
from fib_tf_tpu_torch.parallel.sharding import (Mesh, object_array,
                                                shard_array, shard_bounds)
from fib_tf_tpu_torch.unported import not_ported

State = Dict[str, torch.Tensor]


def check_wide_halo_shards(h_local: int, w_local: int, k: int,
                           is_2d: bool) -> None:
    """Shared wide-halo precondition: each shard must own at least K rows
    (and K columns on a 2D mesh), because ghost cells come from the
    immediate neighbour only.  Single source of truth for the engine's
    construction-time check and the chunk's."""
    if h_local < k or (is_2d and w_local < k):
        raise ValueError(
            f"wide_halo needs >= dt_per_step={k} rows"
            f"{' and columns' if is_2d else ''} per shard, got "
            f"{h_local}x{w_local}; use fewer devices or a larger grid"
        )


class ShardStreams:
    """One CUDA stream per shard of a mesh (also when shards share a
    card), so that a missing wait between neighbours shows on one card as
    it would on four.  On a CPU mesh every method is a no-op and work runs
    in call order."""

    def __init__(self, mesh: Mesh):
        self.devices: List[torch.device] = list(mesh.devices.flat)
        self.cuda = self.devices[0].type == "cuda"
        if any((d.type == "cuda") != self.cuda for d in self.devices):
            raise ValueError("a mesh mixes CPU and CUDA devices")
        self.streams = [torch.cuda.Stream(device=d) if self.cuda else None
                        for d in self.devices]

    def on(self, i: int):
        """Context: work started inside goes to shard i's stream."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[i])

    def event(self):
        return torch.cuda.Event() if self.cuda else None

    def begin(self):
        """The shards' streams wait for what their devices' current streams
        have queued (the buffers they are about to use)."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))

    def end(self):
        """The devices' current streams wait for the shards' streams."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                torch.cuda.current_stream(d).wait_stream(s)


def shards_of(state: Dict[str, np.ndarray], mesh: Mesh,
            keys) -> List[State]:
    """A sharded state as one dict per shard, in the mesh's row-major
    order; checks keys, layout and that every shard has one shape."""
    missing = [k for k in keys if k not in state]
    if missing:
        raise ValueError(f"state is missing planes {missing}")
    for k in keys:
        if getattr(state[k], "shape", None) != mesh.devices.shape:
            raise ValueError(
                f"plane {k!r} is not sharded over the {mesh.devices.shape} "
                f"mesh (use parallel.shard_state)")
    out = [{k: state[k].flat[i] for k in keys} for i in range(mesh.size)]
    shape = out[0][keys[0]].shape
    for i, (s, d) in enumerate(zip(out, mesh.devices.flat)):
        for k, t in s.items():
            if (t.shape != shape or t.device != d
                    or t.dtype != torch.float32):
                raise ValueError(
                    f"shard {i} of plane {k!r} is {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}; expected {tuple(shape)} "
                    f"float32 on {d}")
    return out


def reshard(shards: List[State], mesh: Mesh) -> Dict[str, np.ndarray]:
    """The inverse of `shards_of`: per-shard dicts back to a sharded
    state."""
    return {k: object_array([s[k] for s in shards], mesh.devices.shape)
            for k in shards[0]}


def probe_owner(model: IonicModel, mesh: Mesh, h_local: int,
                w_local: int) -> Tuple[int, int, int]:
    """(shard index, local row, local column) of the model's probe
    pixel."""
    return pixel_owner(model.probe_pixel, mesh, h_local, w_local)


def pixel_owner(pixel, mesh: Mesh, h_local: int,
                w_local: int) -> Tuple[int, int, int]:
    """(shard index, local row, local column) of the global `pixel`."""
    row, col = pixel
    n_rows, n_cols = mesh.grid
    if not (0 <= row < h_local * n_rows and 0 <= col < w_local * n_cols):
        raise ValueError(f"probe pixel {(row, col)} outside the "
                         f"{h_local * n_rows}x{w_local * n_cols} grid")
    r, c = row // h_local, col // w_local
    return r * n_cols + c, row - r * h_local, col - c * w_local


class _WideHalo:
    """The double-buffered extended blocks of all shards and their K-ring
    exchange.

    Step t on shard i reads extended buffer cur[i] and writes the centre of
    nxt[i]; the exchange then fills nxt[i]'s ghosts from the neighbours'
    nxt centres; step t+1 reads nxt[i].  Order between shards, with one
    stream per shard:

      * a row copy into shard i's ghosts runs on i's stream after waiting
        for the SENDER's step (event `stepped`), and before i's next step by
        stream order;
      * on a 2D mesh the column copies follow, of the row-EXTENDED block, so
        the K x K corners ride the column message; they wait for the
        sender's row copies (event `rowed`);
      * two steps later the sender rewrites the centre these copies read
        from.  That write is safe without a further event: the sender's
        step t+2 comes after its own exchange t+1 on its stream, which
        waited for this shard's `stepped` (or `rowed`) of step t+1, which
        this shard recorded after its copies of exchange t.  Every shard
        that reads a block is a neighbour the block's owner waits for at
        every exchange.

    Ghost rows beyond the domain (the reference's ring `ppermute` wraps
    them round; the global clamp never reads them) are filled once, at
    set-up, by the wrapped copy, and skipped afterwards."""

    def __init__(self, model: IonicModel, mesh: Mesh, streams: ShardStreams,
                 shards: List[State], is_2d: bool):
        self.k = k = model.dt_per_step
        self.is_2d = is_2d
        self.streams = streams
        self.n_rows, self.n_cols = mesh.grid
        keys = list(shards[0])
        h, w = shards[0][keys[0]].shape
        check_wide_halo_shards(h, w, k, is_2d)
        self.h, self.w = h, w
        eh, ew = cuda_block.block_shape(h, w, k, is_2d)
        n = len(shards)
        self.stepped = [streams.event() for _ in range(n)]
        self.rowed = [streams.event() for _ in range(n)]

        def alloc():
            stacks = [torch.empty((len(keys), eh, ew), dtype=torch.float32,
                                  device=d) for d in streams.devices]
            return stacks, [dict(zip(keys, b.unbind(0))) for b in stacks]

        # each shard's planes are views of one [planes, ext_h, ext_w] stack,
        # so that a halo message is one strided copy of all planes
        self.cur_stacks, self.cur = alloc()
        self.nxt_stacks, self.nxt = alloc()
        streams.begin()
        for i, s in enumerate(shards):
            with streams.on(i):
                for key, t in s.items():
                    cuda_block.centre(self.cur[i][key], k, is_2d).copy_(t)
                self.mark_stepped(i)
        self.exchange(self.cur_stacks, wrap=True)
        for i in range(n):
            with streams.on(i):
                self.nxt_stacks[i].copy_(self.cur_stacks[i])

    def origin(self, i: int) -> Tuple[int, int]:
        """Global (row, column) of element (0, 0) of shard i's extended
        block."""
        r, c = divmod(i, self.n_cols)
        return r * self.h - self.k, (c * self.w - self.k) if self.is_2d else 0

    def mark_stepped(self, i: int):
        """Record, on shard i's stream, that its centre is written."""
        if self.stepped[i] is not None:
            self.stepped[i].record(self.streams.streams[i])

    def _copy(self, stacks, i: int, dst, j: int, src, done):
        """On shard i's stream: wait for shard j's event `done[j]`, then
        copy the `src` window of all of j's planes into the `dst` window
        of i's."""
        if done[j] is not None:
            self.streams.streams[i].wait_event(done[j])
        stacks[i][(slice(None),) + dst].copy_(
            stacks[j][(slice(None),) + src], non_blocking=True)

    def exchange(self, stacks: List[torch.Tensor], wrap: bool = False):
        """Fill every shard's ghosts of `stacks` (`cur_stacks` or
        `nxt_stacks`) from its neighbours' centres."""
        k, nr, nc = self.k, self.n_rows, self.n_cols
        cols = slice(k, -k) if self.is_2d else slice(None)
        for i in range(nr * nc):
            r, c = divmod(i, nc)
            with self.streams.on(i):
                if r > 0 or (wrap and nr > 1):       # upper neighbour's
                    self._copy(stacks, i, (slice(0, k), cols),
                               ((r - 1) % nr) * nc + c,
                               (slice(-2 * k, -k), cols), self.stepped)
                if r < nr - 1 or (wrap and nr > 1):  # lower neighbour's
                    self._copy(stacks, i, (slice(-k, None), cols),
                               ((r + 1) % nr) * nc + c,
                               (slice(k, 2 * k), cols), self.stepped)
                if wrap and nr == 1:
                    # a single row of shards: its own rows, wrapped
                    self._copy(stacks, i, (slice(0, k), cols), i,
                               (slice(-2 * k, -k), cols), self.stepped)
                    self._copy(stacks, i, (slice(-k, None), cols), i,
                               (slice(k, 2 * k), cols), self.stepped)
                if self.rowed[i] is not None:
                    self.rowed[i].record(self.streams.streams[i])
        if not self.is_2d:
            return
        rows = slice(None)     # the row-extended block: corners included
        for i in range(nr * nc):
            r, c = divmod(i, nc)
            with self.streams.on(i):
                if c > 0 or wrap:
                    self._copy(stacks, i, (rows, slice(0, k)),
                               r * nc + (c - 1) % nc,
                               (rows, slice(-2 * k, -k)), self.rowed)
                if c < nc - 1 or wrap:
                    self._copy(stacks, i, (rows, slice(-k, None)),
                               r * nc + (c + 1) % nc,
                               (rows, slice(k, 2 * k)), self.rowed)

    def swap(self):
        self.cur, self.nxt = self.nxt, self.cur
        self.cur_stacks, self.nxt_stacks = self.nxt_stacks, self.cur_stacks

    def centres(self) -> List[State]:
        """Contiguous copies of the shards' own cells of `cur`."""
        return [{key: cuda_block.centre(t, self.k, self.is_2d).clone(
                     memory_format=torch.contiguous_format)
                 for key, t in s.items()} for s in self.cur]


@dataclasses.dataclass(frozen=True)
class ShardMaps:
    """The static maps of a sharded run, extended once per shard:
    `phase` / `dmap` are None or object arrays of the mesh's shape of
    per-shard tensors, `[h + 2K, w (+ 2K)]` (`wide_halo`, the blocks'
    layout) or `[h + 2, w + 2]` (the per-substep exchange); `own_phase`
    the shards' own `[h, w]` blocks of the phase field (the "ultra"
    probe's weights), or None."""

    phase: Optional[np.ndarray]
    dmap: Optional[np.ndarray]
    wide_halo: bool
    own_phase: Optional[np.ndarray] = None


def _wide_map(a: np.ndarray, mesh: Mesh, k: int) -> np.ndarray:
    """A static `[H, W]` map as every shard's block extended by K ghost
    rows (and columns on a 2D mesh), in the extended blocks' layout; the
    ghosts beyond the domain wrap round it, as the reference's ring
    exchange fills them (never read)."""
    n_rows, n_cols = mesh.grid
    height, width = a.shape
    h = shard_bounds(height, n_rows, "extent")
    w = shard_bounds(width, n_cols, "width") if n_cols > 1 else width
    out = np.empty(mesh.devices.shape, dtype=object)
    for i in range(mesh.size):
        r, c = divmod(i, n_cols)
        rows = np.arange(r * h - k, (r + 1) * h + k) % height
        cols = (np.arange(c * w - k, (c + 1) * w + k) % width
                if n_cols > 1 else np.arange(width))
        out.flat[i] = torch.tensor(np.ascontiguousarray(a[np.ix_(rows, cols)]),
                                   device=mesh.devices.flat[i])
    return out


def shard_maps(model: IonicModel, mesh: Mesh,
               phase: Optional[np.ndarray] = None,
               dmap: Optional[np.ndarray] = None,
               wide_halo: bool = False) -> ShardMaps:
    """Each shard's block of `phase` and `dmap` (`[H, W]`), extended once
    for the comm schedule: K = dt_per_step rings with `wide_halo`, else one
    ring (halo.extend_phase / extend_phase_2d)."""
    n_rows, n_cols = mesh.grid

    def extend(a):
        if a is None:
            return None
        a = np.asarray(a, np.float32)
        if a.shape != model.state_shape():
            raise ValueError(f"map of shape {a.shape} on the "
                             f"{model.state_shape()} grid")
        if wide_halo:
            return _wide_map(a, mesh, model.dt_per_step)
        blocks = shard_array(a, mesh)
        return (halo.extend_phase_2d(blocks) if n_cols > 1
                else halo.extend_phase(blocks))

    own = None if phase is None else shard_array(
        np.asarray(phase, np.float32), mesh)
    return ShardMaps(extend(phase), extend(dmap), wide_halo, own)


def make_spmd_chunk(
    model: IonicModel,
    mesh: Mesh,
    length: int,
    phase: Optional[np.ndarray] = None,
    dmap: Optional[np.ndarray] = None,
    egm_masks: Optional[list] = None,
    wide_halo: bool = False,
    use_kernel: bool = False,
    fiber: Optional[tuple] = None,
    trend_points: Optional[tuple] = None,
    ecg_weights: Optional[list] = None,
    rotor: Optional[tuple] = None,
    maps: Optional[ShardMaps] = None,
):
    """Build `chunk(state) -> (state, probes)` running `length` outer steps
    of a sharded state (`parallel.shard_state`) over `mesh`; `probes["v"]`
    is a `[length]` tensor on the device of the shard that owns the probe
    pixel, and beside it `probes["trend"]` (with `trend_points`,
    ((state key, row, column), ...)) a `[length, n_points]` one and
    `probes["ultra"]` (a model with `ultra_fields`) a `[length, 5]` one.
    The input's shards are not modified.

    `wide_halo=True` switches the comm schedule from one 1-row exchange per
    SUBSTEP to one K-row exchange per OUTER step (K = dt_per_step);
    `use_kernel=True` (requires `wide_halo`) runs the per-shard substep
    group in the block kernel: on a CUDA mesh csrc/br_block.cu, on a CPU
    mesh its plain version, which is also the `use_kernel=False` step.
    2D meshes (rows x cols) are supported on both schedules.

    `phase` / `dmap` (`[H, W]`) are the phase field and the relative
    diffusion map, extended per shard when the chunk is built, or `maps`
    (`shard_maps`) their extensions built beforehand; `fiber` = (dxx, dxy,
    dyy) selects the anisotropic operator and requires `wide_halo`.

    `egm_masks`, `ecg_weights` and `rotor` are the reference's and raise
    NotImplementedError: not ported yet."""
    if use_kernel and not wide_halo:
        raise ValueError(
            "use_kernel requires wide_halo=True (the per-substep "
            "exchange path has no fused block to hand the kernel)"
        )
    if fiber is not None and not wide_halo:
        raise ValueError(
            "fiber anisotropy on the halo-exchange path requires "
            "wide_halo=True (the per-substep halo geometries implement "
            "the isotropic stencil only)"
        )
    for name, value in (("egm_masks", egm_masks),
                        ("ecg_weights", ecg_weights), ("rotor", rotor)):
        if value is not None:
            not_ported(f"{name} on the sharded path", "parallel")
    if maps is None:
        maps = shard_maps(model, mesh, phase, dmap, wide_halo)
    elif phase is not None or dmap is not None:
        raise ValueError("pass phase / dmap or their shard maps, not both")
    elif maps.wide_halo != wide_halo:
        raise ValueError("the shard maps were extended for the other comm "
                         "schedule")
    n_rows, n_cols = mesh.grid
    is_2d = n_cols > 1
    keys = model.state_keys()
    streams = ShardStreams(mesh)
    block_step = (cuda_block.make_block_step(model, is_2d, fiber)
                  if use_kernel else None)

    has_ultra = hasattr(model, "ultra_fields")
    trend_points = tuple(trend_points or ())

    def shard_map(m, i):
        return None if m is None else m.flat[i]

    def probe_buffers(shards):
        """(owner, owner's local pixel, {stream: buffer}, trend pixels, the
        ultra weights and their total) of one chunk."""
        h, w = shards[0][keys[0]].shape
        owner, lr, lc = probe_owner(model, mesh, h, w)
        dev = streams.devices[owner]
        bufs = {"v": torch.empty(length, dtype=torch.float32, device=dev)}
        # (point, state key, shard, local row, local column)
        trend_at = [(j, key, *pixel_owner((r, c), mesh, h, w))
                    for j, (key, r, c) in enumerate(trend_points)]
        if trend_points:
            bufs["trend"] = torch.empty((length, len(trend_points)),
                                        dtype=torch.float32, device=dev)
        weights, wsum = None, None
        if has_ultra:
            bufs["ultra"] = torch.empty((length, mesh.size, 5),
                                        dtype=torch.float32, device=dev)
            weights = [shard_map(maps.own_phase, i) for i in range(mesh.size)]
            weights = [torch.ones((h, w), dtype=torch.float32, device=d)
                       if wt is None else wt
                       for wt, d in zip(weights, streams.devices)]
            wsum = torch.stack([torch.sum(wt).to(dev) for wt in weights]
                               ).sum()
        return owner, (lr, lc), bufs, trend_at, weights, wsum

    def take_probes(bufs, trend_at, weights, i, t, own):
        """Shard i's part of step t's trend and ultra streams, from `own`,
        its own cells."""
        for j, key, shard, lr, lc in trend_at:
            if shard == i:
                bufs["trend"][t, j].copy_(own[key][lr, lc])
        if weights is not None:
            bufs["ultra"][t, i].copy_(torch.stack([
                torch.sum(x * weights[i])
                for x in model.ultra_fields(own)]))

    def finish(bufs, wsum):
        """The chunk's probe streams: the ultra partial sums added."""
        if wsum is not None:
            bufs["ultra"] = bufs["ultra"].sum(dim=1) / wsum
        return bufs

    def wide_chunk(state):
        shards = shards_of(state, mesh, keys)
        owner, _, bufs, trend_at, weights, wsum = probe_buffers(shards)
        probe = bufs["v"]
        blocks = _WideHalo(model, mesh, streams, shards, is_2d)
        for t in range(length):
            for i in range(mesh.size):
                rstart, cstart = blocks.origin(i)
                own = probe if i == owner else None
                phase_ext = shard_map(maps.phase, i)
                dmap_ext = shard_map(maps.dmap, i)
                with streams.on(i):
                    if use_kernel:
                        block_step(blocks.cur[i], blocks.nxt[i], rstart,
                                   cstart, own, t, streams.streams[i],
                                   phase_ext, dmap_ext)
                    else:
                        cuda_block.plain_block_step(
                            model, blocks.cur[i], blocks.nxt[i], rstart,
                            cstart, is_2d, own, t, phase_ext, fiber,
                            dmap_ext)
                    blocks.mark_stepped(i)
                    if trend_at or weights is not None:
                        take_probes(bufs, trend_at, weights, i, t, {
                            key: cuda_block.centre(x, blocks.k, is_2d)
                            for key, x in blocks.nxt[i].items()})
            blocks.exchange(blocks.nxt_stacks)
            blocks.swap()
        streams.end()
        return reshard(blocks.centres(), mesh), finish(bufs, wsum)

    def ring_chunk(state):
        shards = [dict(s) for s in shards_of(state, mesh, keys)]
        owner, pixel, bufs, trend_at, weights, wsum = probe_buffers(shards)
        pot = model.pot_key
        for t in range(length):
            for slow in model.launch_schedule:
                ring = halo.HaloExchange(
                    object_array([s[pot] for s in shards],
                                 (n_rows, n_cols)), is_2d, maps.phase,
                    maps.dmap)
                for i in range(mesh.size):
                    shards[i] = model.commit(
                        shards[i], ring.geometry(*divmod(i, n_cols)), slow)
            v = shards[owner][pot][pixel]
            bufs["v"][t] = (v - model.min_v) / (model.max_v - model.min_v)
            for i in range(mesh.size):
                take_probes(bufs, trend_at, weights, i, t, shards[i])
        return reshard(shards, mesh), finish(bufs, wsum)

    return wide_chunk if wide_halo else ring_chunk
