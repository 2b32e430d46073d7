"""The wide-halo sharded chunk for 3D volumes, z-sharded (counterpart of
fib_tf_tpu/parallel/volume_spmd.py, without phase fields, fibers, the rotor
census and the ECG probe).

The `[D, H, W]` state is sharded along z over a 1D mesh.  Each outer step
is `dt_per_step // k` groups of k substeps (k = `halo_k`, default
`dt_per_step`: one group); before each group every shard receives k ghost
SLICES from each z neighbour, then the whole group runs on the extended
block: per shard either the volume block kernel (ops/cuda_volume_block.py;
csrc/br_volume_block.cu on CUDA tensors) or the plain step under
`zblock_geometry`.  Ghost slices decay one ring per substep.  In the plane
each shard owns the full sheet, so the in-plane operators need no
communication.

One process drives all shards, each on its own CUDA stream also when
shards share a card (parallel/spmd.ShardStreams).  The blocks stay extended
for the whole chunk and are updated in place, so the events run both ways:
a shard's ghost copies wait for the SENDER's group (`stepped`), and a
shard's next group, which overwrites the centre its neighbours copy from,
waits for the neighbours' copies (`copied`).

Probes mirror run_volume's: the scalar "v" probe is written by the shard
that owns the mid-depth slice.  Events fire after the step and before that
step's probe, which is then retaken on the owning shard; event masks are
z-sharded with the state.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fib_tf_tpu_torch.models.base import IonicModel
from fib_tf_tpu_torch.ops import cuda_volume_block
from fib_tf_tpu_torch.parallel.sharding import Mesh, shard_array
from fib_tf_tpu_torch.parallel.spmd import (
    ShardStreams,
    reshard,
    shards_of,
)
from fib_tf_tpu_torch.unported import not_ported


def check_volume_shards(depth: int, n_shards: int, k: int) -> None:
    """Wide-halo precondition: z divides evenly and every shard owns at
    least K slices (ghosts come from the immediate neighbour only)."""
    if depth % n_shards != 0:
        raise ValueError(
            f"depth {depth} not divisible by the mesh's {n_shards} shards"
        )
    if depth // n_shards < k:
        raise ValueError(
            f"wide_halo needs >= K={k} z-slices per shard (K = halo_k or "
            f"dt_per_step), got {depth // n_shards}; use fewer devices, a "
            f"deeper volume, or a smaller halo_k"
        )


def resolve_halo_k(model: IonicModel, halo_k: Optional[int]) -> int:
    """Validate and resolve the wide-halo exchange cadence: `None` means
    one exchange of dt_per_step ghost slices per outer step; an explicit
    `halo_k` splits the outer step into dt_per_step/halo_k groups of
    halo_k substeps, each preceded by a halo_k-slice exchange: smaller
    blocks for more messages.  Requires a model whose substeps are uniform
    (IonicModel.has_uniform_substeps; BR's skip groups are not splittable
    at arbitrary boundaries)."""
    if halo_k is None:
        return model.dt_per_step
    if not 1 <= halo_k <= model.dt_per_step:
        raise ValueError(
            f"halo_k must be in [1, dt_per_step={model.dt_per_step}], "
            f"got {halo_k}"
        )
    if model.dt_per_step % halo_k != 0:
        raise ValueError(
            f"halo_k={halo_k} must divide dt_per_step="
            f"{model.dt_per_step}"
        )
    if halo_k != model.dt_per_step and not model.has_uniform_substeps:
        raise ValueError(
            f"halo_k < dt_per_step needs uniform substeps, which "
            f"{model.name} does not have with this config (BR skip "
            f"groups are not splittable at arbitrary substep boundaries)"
        )
    return halo_k


def make_volume_spmd_chunk(
    model: IonicModel,
    mesh: Mesh,
    length: int,
    depth: int,
    fire: Sequence[Tuple[int, np.ndarray]] = (),
    phase: Optional[np.ndarray] = None,
    dz_ratio: float = 1.0,
    fiber: Optional[tuple] = None,
    use_kernel: bool = False,
    rotor: bool = False,
    halo_k: Optional[int] = None,
    ecg_weights=None,
):
    """Build `chunk(state) -> (state, probes)` advancing `length` outer
    steps of a z-sharded `[D, H, W]` volume (`parallel.shard_state`) over
    `mesh`; `probes["v"]` is a `[length]` tensor on the device of the shard
    that owns slice `depth // 2`.  The input's shards are not modified.

    `fire` is the chunk-relative event list [(step, [D, H, W] mask)].
    `use_kernel=True` runs the per-shard group in the volume block kernel:
    on a CUDA mesh csrc/br_volume_block.cu, on a CPU mesh its plain
    version, which is also the `use_kernel=False` step.

    `phase`, `fiber`, `rotor` and `ecg_weights` are the reference's and
    raise NotImplementedError: not ported yet."""
    for name, value, item in (("phase", phase, "geometry"),
                              ("fiber", fiber, "geometry"),
                              ("rotor", rotor or None, "parallel"),
                              ("ecg_weights", ecg_weights, "parallel")):
        if value is not None:
            not_ported(f"{name} on the sharded volume path", item)
    n_shards, n_cols = mesh.grid
    if n_cols > 1:
        raise ValueError("a volume shards over a 1D (z) mesh, got mesh "
                         f"shape {mesh.devices.shape}")
    k = resolve_halo_k(model, halo_k)
    n_groups = model.dt_per_step // k
    check_volume_shards(depth, n_shards, k)
    d_local = depth // n_shards
    ext_d = d_local + 2 * k
    h, w = model.state_shape()
    keys = model.state_keys()
    pot_key = model.pot_key
    zmid = depth // 2
    owner, probe_slice = zmid // d_local, zmid % d_local + k
    substeps = k if n_groups > 1 else None
    streams = ShardStreams(mesh)
    devices = streams.devices
    block_step = (cuda_volume_block.make_volume_block_step(
        model, ext_d, depth, dz_ratio, substeps) if use_kernel else None)
    fire_masks: Dict[int, List[np.ndarray]] = {}
    for t, mask in fire:
        mask = np.asarray(mask, np.float32)
        if mask.shape != (depth, h, w):
            raise ValueError(f"event mask of shape {mask.shape}, expected "
                             f"{(depth, h, w)}")
        fire_masks.setdefault(int(t), []).append(shard_array(mask, mesh))

    def chunk(state):
        shards = shards_of(state, mesh, keys)
        if tuple(shards[0][pot_key].shape) != (d_local, h, w):
            raise ValueError(
                f"shards of shape {tuple(shards[0][pot_key].shape)}, "
                f"expected {(d_local, h, w)}")
        probe = torch.empty(length, dtype=torch.float32,
                            device=devices[owner])
        stepped = [streams.event() for _ in range(n_shards)]
        copied = [streams.event() for _ in range(n_shards)]
        # each shard's planes are views of one stack, V's two buffers
        # first, so that a halo message is two strided copies: V from its
        # current buffer, and the other planes together
        others = [key for key in keys if key != pot_key]
        stacks = [torch.empty((len(keys) + 1, ext_d, h, w),
                              dtype=torch.float32, device=d) for d in devices]
        blocks: List[Dict[str, torch.Tensor]] = [
            dict(zip([pot_key] + others, (b[0],) + b[2:].unbind(0)))
            for b in stacks]
        spares: List[torch.Tensor] = [b[1] for b in stacks]
        streams.begin()
        for i, s in enumerate(shards):
            with streams.on(i):
                for key, t in s.items():
                    blocks[i][key][k:-k].copy_(t)
                # slices beyond the volume are never read back into it, but
                # the plain version computes on them: keep them finite
                if i == 0:
                    for key, t in s.items():
                        blocks[i][key][:k].copy_(t[:k])
                if i == n_shards - 1:
                    for key, t in s.items():
                        blocks[i][key][-k:].copy_(t[-k:])
                spares[i].copy_(blocks[i][pot_key])
                _record(stepped[i], streams, i)

        def exchange():
            for i in range(n_shards):
                with streams.on(i):
                    for j, dst, src in ((i - 1, slice(0, k),
                                         slice(-2 * k, -k)),
                                        (i + 1, slice(-k, None),
                                         slice(k, 2 * k))):
                        if not 0 <= j < n_shards:
                            continue
                        if stepped[j] is not None:
                            streams.streams[i].wait_event(stepped[j])
                        blocks[i][pot_key][dst].copy_(
                            blocks[j][pot_key][src], non_blocking=True)
                        stacks[i][2:, dst].copy_(stacks[j][2:, src],
                                                 non_blocking=True)
                    _record(copied[i], streams, i)

        def group(i: int, own_probe, t: int):
            zstart = i * d_local - k
            with streams.on(i):
                for j in (i - 1, i + 1):
                    if 0 <= j < n_shards and copied[j] is not None:
                        streams.streams[i].wait_event(copied[j])
                if use_kernel:
                    blocks[i], spares[i] = block_step(
                        blocks[i], spares[i], zstart, own_probe, t,
                        probe_slice, streams.streams[i])
                else:
                    cuda_volume_block.plain_volume_block_step(
                        model, blocks[i], zstart, depth, dz_ratio, substeps,
                        own_probe, t, probe_slice)

        for t in range(length):
            masks = fire_masks.get(t, ())
            for g in range(n_groups):
                exchange()
                last = g == n_groups - 1
                for i in range(n_shards):
                    group(i, probe if last and i == owner else None, t)
                    if not last or not masks:
                        _record(stepped[i], streams, i)
            if masks:
                # fired after the step and before its probe: retake it
                for i in range(n_shards):
                    with streams.on(i):
                        pot = blocks[i][pot_key][k:-k]
                        for m in masks:
                            torch.maximum(pot, m.flat[i], out=pot)
                        if i == owner:
                            probe[t] = cuda_volume_block.block_probe(
                                model, blocks[i], probe_slice)
                        _record(stepped[i], streams, i)
        streams.end()
        out = [{key: t[k:-k].clone() for key, t in b.items()}
               for b in blocks]
        return reshard(out, mesh), {"v": probe}

    return chunk


def _record(event, streams: ShardStreams, i: int):
    if event is not None:
        event.record(streams.streams[i])
