"""3D (volume) simulation: `run_volume` (main-path subset of
fib_tf_tpu/engine/volume.py).

`run_volume(model, depth, n_outer)` advances a `[depth, H, W]` volume
`n_outer` outer steps with the model unchanged: only the two spatial
operators come from the 3D geometry (models/base.volume_geometry).  The
run is a Python loop of outer steps, like the 2D engine's chunk loop:
the kernel's last launch of each outer step writes the probe into a device
buffer, and each chunk (`frames_every` outer steps, or the whole run) ends
in one read-back of that buffer (and of the frame, when asked for).

Kernel routing (`volume_route`, as the reference's `_use_volume_kernel`,
engine/volume.py:132-199, on the true shape): 'xla' runs the plain PyTorch
path anywhere; 'auto' on a CUDA device runs the volume substep kernel
(csrc/br_volume.cu, five launches per outer step) while the state fits
VOLUME_KERNEL_STATE_MB_MAX and the tiled volume kernel
(csrc/br_volume_tiled.cu, one launch per outer step, any depth) past it;
'pallas' forces the substep kernel at any size; on the CPU 'auto' runs the
plain path and 'pallas' raises.  The cutover is the card's, not the
reference's 32 MB: the tiled kernel lost to the substep route at every
size measured on the H100, so 'auto' stays on the substep kernel.  The reference's Mosaic caps (the cell cap, the
tiled block budget, its tile-row rules and the padded path) are not
carried: both CUDA kernels take any D >= 3, H, W >= 3.

`run_volume(..., mesh=, wide_halo=True, halo_k=)` shards the volume along
z over a `parallel.Mesh` and runs parallel/volume_spmd's wide-halo chunk:
per shard the volume block kernel (csrc/br_volume_block.cu) under
`_use_shard_kernel`, or the plain step.

The volume substep kernel hosts every model: Beeler-Reuter, Fenton,
Mitchell-Schaeffer, Courtemanche, Courtemanche-ultra, Luo-Rudy and tp06
(the reference's 'auto' keeps the last two on XLA, volume.py:182); the
tiled volume kernel hosts BR's main body alone, so the others raise
NotImplementedError where 'auto' or 'pallas' would take it (the cutover
lowered; ROADMAP Queue 2 item D); the block volume kernel hosts every
model.  Courtemanche's table mode runs the plain path, on a mesh too.

Not ported yet, and raising NotImplementedError when asked for: phase
fields, fiber twist / ratio / elevation (ROADMAP Queue 1 items 9 and 18),
a mesh without `wide_halo` (the reference's GSPMD volume path, item 19),
volume ECG electrodes, the rotor census and custom probe callables
(item 18), and adaptive_dv (item 15).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.engine.simulation import plain_only, resolve_device
from fib_tf_tpu_torch.models.base import IonicModel
from fib_tf_tpu_torch.ops import (bodies, cuda_volume, cuda_volume_tiled,
                                  stencil3d)
from fib_tf_tpu_torch.parallel import volume_spmd
from fib_tf_tpu_torch.unported import not_ported

# Whole-volume vs tiled cutover in MB of state (planes x D x H x W x 4).
# The reference's is 32 MB (fib_tf_tpu/engine/volume.py:78).  On the card
# the tiled volume kernel takes 2.0x, 1.3x, 1.7x and 1.15x the time of five
# substep launches at 8x128x512, 8x512x512, 32x128x512 and 8x1024x1024
# (NVIDIA H100 80GB HBM3, 700 W; tools/torch_tile_bench.py --volume,
# PERF.md section 6): no size past which it wins was found, so
# 'auto' takes the substep kernel at any size.  Lower the cutover to run
# the tiled kernel.
VOLUME_KERNEL_STATE_MB_MAX = math.inf


def volume_state(model: IonicModel, depth: int,
                 s1: bool = True) -> Dict[str, np.ndarray]:
    """Extrude the model's 2D initial state along z: `[D, H, W]` planes.
    The S1 stimulus becomes a full-depth slab, so the first wave is
    planar in 3D exactly as it is in 2D."""
    st = model.initial_state(s1=s1)
    return {
        k: np.repeat(np.asarray(v, np.float32)[None], depth, axis=0)
        for k, v in st.items()
    }


@dataclasses.dataclass
class VolumeEvent:
    """A stimulus fired at the END of outer step `step` (0-based), before
    that step's probe: one of the 8 named 2D pace locations extruded over
    z-slices `[z0:z1)` (the cross-field S2 that turns a planar wave into a
    scroll), or an explicit `[D, H, W]` mask with background
    model.min_v."""

    step: int
    loc: Optional[str] = None
    v: Optional[float] = None
    mask: Optional[np.ndarray] = None
    z0: int = 0
    z1: Optional[int] = None

    def resolve_mask(self, model: IonicModel, depth: int) -> np.ndarray:
        if (self.loc is None) == (self.mask is None):
            raise ValueError("VolumeEvent needs exactly one of loc/mask")
        if self.mask is not None:
            return np.asarray(self.mask, np.float32)
        v = model.max_v if self.v is None else self.v
        return stencil3d.pace_mask3d(
            depth, model.cfg.height, model.cfg.width, self.loc, v,
            model.min_v, self.z0, self.z1,
        )


def volume_state_mb(model: IonicModel, depth: int) -> float:
    """The volume's state in MB (2**20 bytes) on its true shape."""
    h, w = model.state_shape()
    return len(model.state_keys()) * depth * h * w * 4 / 2**20


def volume_route(model: IonicModel, depth: int, device_type: str,
                 kernel: str) -> str:
    """The outer step run_volume takes: 'substep' (csrc/br_volume.cu, one
    launch per substep; every cell body), 'tiled' (csrc/br_volume_tiled.cu,
    one launch per outer step, any depth; Beeler-Reuter's main body only:
    the other bodies raise NotImplementedError there) or 'plain'
    (PyTorch).  Under the card's cutover (no limit) 'auto' never takes
    'tiled'.  Courtemanche's table mode runs 'plain' ('pallas' raises)."""
    if plain_only(model, device_type, kernel):
        return "plain"
    if (kernel == "pallas"
            or volume_state_mb(model, depth) <= VOLUME_KERNEL_STATE_MB_MAX):
        return "substep"
    bodies.main_body_only(model, "tiled volume")
    return "tiled"


def _check_unported(model, phase, fiber_twist, fiber_angle0, fiber_ratio,
                    fiber_elevation, mesh, probe, rotor_probe, electrodes,
                    wide_halo):
    if phase is not None:
        not_ported("phase fields in run_volume", "geometry")
    if (fiber_twist != 0.0 or fiber_angle0 != 0.0 or fiber_ratio != 1.0
            or fiber_elevation != 0.0):
        not_ported("fiber twist / ratio / elevation in run_volume",
                   "geometry")
    if mesh is not None and not wide_halo:
        not_ported("the GSPMD z-sharded volume (mesh without wide_halo)",
                   "parallel")
    if electrodes:
        not_ported("volume ECG electrodes", "volume")
    if rotor_probe:
        not_ported("the volume rotor census (rotor_probe)", "volume")
    if probe is not None:
        not_ported("custom probe callables in run_volume", "volume")
    if model.cfg.adaptive_dv is not None:
        not_ported("adaptive_dv", "adaptive")


def _use_shard_kernel(model: IonicModel, device_type: str,
                      kernel: str) -> bool:
    """Kernel selection for the wide-halo z-sharded path: does the
    per-shard substep group run in the volume block kernel
    (csrc/br_volume_block.cu)?  As the reference's `_use_shard_kernel`
    (engine/volume.py:202-237) on a CUDA mesh: 'xla' never, 'pallas'
    always, 'auto' on the card, for every model (the reference's 'auto'
    keeps Luo-Rudy and tp06 on XLA, :228; the card's kernel hosts them);
    Courtemanche's table mode never ('pallas' raises, as the reference's
    does on the TPU).  The reference's (8, 128) alignment rule and its VMEM
    caps on the extended block are Mosaic's and are not carried: the CUDA
    kernel takes any H, W >= 3 and leaves the block to device memory.
    kernel='pallas' on a CPU mesh raises."""
    return not plain_only(model, device_type, kernel,
                          "a mesh of CUDA devices")


def make_route_step(model: IonicModel, depth: int, route: str,
                    dz_ratio: float = 1.0):
    """`step(state, probe, probe_index) -> state` for `route`."""
    if route == "tiled":
        return cuda_volume_tiled.make_tiled_volume_step(model, depth,
                                                        dz_ratio)
    if route == "substep":
        return cuda_volume.make_volume_step(model, depth, dz_ratio)

    def plain(state, probe=None, probe_index=0):
        return cuda_volume.plain_volume_step(model, state, probe,
                                             probe_index, dz_ratio)

    return plain


def run_volume(
    model: IonicModel,
    depth: int,
    n_outer: int,
    state: Optional[Dict[str, np.ndarray]] = None,
    phase: Optional[np.ndarray] = None,
    dz_ratio: float = 1.0,
    fiber_twist: float = 0.0,
    fiber_angle0: float = 0.0,
    fiber_ratio: float = 1.0,
    fiber_elevation: float = 0.0,
    mesh=None,
    events: Sequence[VolumeEvent] = (),
    probe: Optional[Callable] = None,
    frames_every: Optional[int] = None,
    allow_unstable_dt: bool = False,
    rotor_probe: bool = False,
    rotor_tau_ms: float = 10.0,
    rotor_v_star: float = 0.5,
    electrodes: Sequence[tuple] = (),
    kernel: str = "auto",
    wide_halo: bool = False,
    halo_k: Optional[int] = None,
    device="cuda",
):
    """Advance a `[depth, H, W]` volume `n_outer` outer steps.

    - `state`: stacked `[D, H, W]` numpy planes (default: `volume_state`).
    - `dz_ratio`: transmural conduction fraction (1.0 = isotropic).
    - `events`: VolumeEvents, each fired at the end of its outer step,
      before that step's probe.
    - `frames_every`: record the normalised `[D, H, W]` potential every
      this many outer steps (host-side chunking).
    - `kernel`: 'auto' | 'pallas' | 'xla' (see `volume_route`).
    - `device`: 'cuda' (the default; raises without a card) or 'cpu'.
    - `mesh` with `wide_halo=True`: shard the volume along z over the
      mesh's devices (parallel.make_mesh; the mesh wins over `device`) and
      exchange `halo_k` (default `dt_per_step`) ghost slices per group of
      `halo_k` substeps.
    - The other arguments are the reference's and raise
      NotImplementedError when set (not ported yet).

    Returns (final state, probes `[n_outer]`, frames `[n_frames, D, H, W]`
    or None); the probe is the normalised V at
    `(depth // 2, min(20, H-1), min(W // 2, W-1))`.

    Stability: explicit Euler in 3D needs dt <= 2 / ((8 + 8*dz_ratio) *
    diff); a larger dt raises unless `allow_unstable_dt` (e.g. a z-uniform
    volume never excites the z modes)."""
    if depth < 3:
        raise ValueError(
            "run_volume needs depth >= 3 (the SYMMETRIC face rewrite "
            "replaces both boundary slices with interior neighbors, so "
            "a 1- or 2-slice volume has no interior); use the 2D engine "
            "for sheets"
        )
    if not 0.0 < fiber_ratio <= 1.0:
        raise ValueError("fiber_ratio must be in (0, 1]")
    _check_unported(model, phase, fiber_twist, fiber_angle0, fiber_ratio,
                    fiber_elevation, mesh, probe, rotor_probe, electrodes,
                    wide_halo)
    dt_limit = 2.0 / ((8.0 + 8.0 * dz_ratio) * model.cfg.diff)
    if model.cfg.dt > dt_limit and not allow_unstable_dt:
        raise ValueError(
            f"dt={model.cfg.dt} exceeds the 3D explicit stability limit "
            f"2/((8 + 8*dz_ratio)*diff) = {dt_limit:.4f}; lower dt or "
            f"dz_ratio, or pass allow_unstable_dt=True (e.g. for z-uniform "
            f"fields)"
        )
    if state is None:
        state = volume_state(model, depth)
    if set(state) != set(model.state_keys()):
        raise ValueError(f"state planes {sorted(state)} != model planes "
                         f"{sorted(model.state_keys())}")
    if wide_halo:
        return _run_sharded(model, depth, n_outer, state, dz_ratio, mesh,
                            events, frames_every, kernel, halo_k)
    if halo_k is not None:
        raise ValueError("halo_k is the wide-halo exchange cadence: it "
                         "needs mesh= and wide_halo=True")
    device = resolve_device(device)
    route = volume_route(model, depth, device.type, kernel)
    step = make_route_step(model, depth, route, dz_ratio)
    dev_state = interop.state_from_numpy(state, device)

    pot_key = model.pot_key
    fire: Dict[int, List[torch.Tensor]] = {}
    for e in events:
        mask = torch.tensor(e.resolve_mask(model, depth), device=device)
        fire.setdefault(int(e.step), []).append(mask)

    probes: List[np.ndarray] = []
    frames: Optional[List[np.ndarray]] = None if frames_every is None else []
    chunk = n_outer if frames_every is None else frames_every
    done = 0
    while done < n_outer:
        length = min(chunk, n_outer - done)
        buf = torch.empty(length, dtype=torch.float32, device=device)
        for k in range(length):
            dev_state = step(dev_state, buf, k)
            masks = fire.get(done + k)
            if masks:
                # the reference fires after the step and before its probe
                # (engine/volume.py:557-564): retake the probe
                pot = dev_state[pot_key]
                for m in masks:
                    pot = torch.maximum(pot, m)
                dev_state[pot_key] = pot
                buf[k] = cuda_volume.volume_probe(model, dev_state)
        probes.append(buf.cpu().numpy())
        done += length
        if frames is not None:
            frames.append(model.image(dev_state).cpu().numpy())

    return _result(model, interop.state_to_numpy(dev_state), probes, frames)


def _result(model, final, probes, frames):
    if not np.isfinite(final[model.pot_key]).all():
        raise FloatingPointError(
            "non-finite potential in run_volume (the reference's disabled "
            "NaN check, ionic.py:208-212, would have integrated on)"
        )
    return (
        final,
        np.concatenate(probes) if probes else np.zeros(0, np.float32),
        np.stack(frames) if frames else None,
    )


def _run_sharded(model, depth, n_outer, state, dz_ratio, mesh, events,
                 frames_every, kernel, halo_k):
    """run_volume's wide-halo path: the z-sharded volume advanced chunk by
    chunk through parallel/volume_spmd (engine/volume.py:430-452, :542-552
    of the reference)."""
    if mesh is None:
        raise ValueError("wide_halo needs a mesh (z-sharded volume)")
    n_shards = mesh.grid[0]
    k = volume_spmd.resolve_halo_k(model, halo_k)
    volume_spmd.check_volume_shards(depth, n_shards, k)
    use_kernel = _use_shard_kernel(model, mesh.devices.flat[0].type, kernel)
    masks = [(int(e.step), e.resolve_mask(model, depth)) for e in events]
    dev_state = interop.shard_state(state, mesh)

    probes: List[np.ndarray] = []
    frames: Optional[List[np.ndarray]] = None if frames_every is None else []
    chunk_len = n_outer if frames_every is None else frames_every
    done = 0
    while done < n_outer:
        length = min(chunk_len, n_outer - done)
        fire = [(t - done, m) for t, m in masks if done <= t < done + length]
        chunk = volume_spmd.make_volume_spmd_chunk(
            model, mesh, length, depth, fire=fire, dz_ratio=dz_ratio,
            use_kernel=use_kernel, halo_k=halo_k)
        dev_state, p = chunk(dev_state)
        probes.append(p["v"].cpu().numpy())
        done += length
        if frames is not None:
            pot = interop.gather_state(
                {model.pot_key: dev_state[model.pot_key]})
            frames.append(
                model.image({k: torch.from_numpy(v)
                             for k, v in pot.items()}).numpy())
    return _result(model, interop.gather_state(dev_state), probes, frames)
