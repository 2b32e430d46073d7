"""The per-shard volume block kernel's wrapper, its geometry and its plain
version.

Counterpart of fib_tf_tpu/ops/pallas_volume.py::make_volume_block_kernel,
the per-shard compute of the wide-halo z-sharded volume path
(parallel/volume_spmd.py): a fused group of substeps (all `dt_per_step` of
an outer step, or `halo_k` of them) on ONE shard's `[d + 2k, H, W]` block,
extended by k ghost slices on each side.  The ghosts came from the
neighbouring shards; the block's global start slice `zstart` and the
volume's depth decide where the z faces reflect, so only a shard that owns
a z face reflects there; in the plane each shard owns the whole sheet.  The
kernel is csrc/br_volume_block.cu (CUDA C++, built with nvcc and bound with
ctypes; a template over the cell body, one entry per body of
ops/bodies.BODIES, the Courtemanche bodies and Luo-Rudy's and tp06's in
libraries of their own, `CellBody.library`): one launch per substep of the
group, as the volume substep kernel, each on the slices that are still
exact; Courtemanche's substep 0 is two launches on the same slices (the
fast commit, then the slow commit, which keeps the potential).

`zblock_geometry` is the plain geometry of an extended block (the
reference's `zblock_geometry`, pallas_volume.py:310-394, without phase
fields and fibers): the wide-halo volume path's `kernel='xla'` step and the
kernel's plain version.

Routing is by the device of the block's tensors, as in ops/cuda_step.py:
CPU tensors take the plain version, CUDA tensors launch the kernel, and a
launch that fails raises.  Nothing falls back from the card to the plain
version.

Update contract: the block's state dict is updated IN PLACE and returned.
After a group of n substeps the centre `[n, ext_d - n)` of every plane is
exact and the slices outside it are garbage, for the halo exchange to
refill.  The planes keep their memory (a caller may hold them as views of
one allocation): on the card the potential alternates between the block's
two buffers (the dict's `model.pot_key` and `spare`, which the step
returns swapped) and the other planes are overwritten; the plain version
overwrites all of them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fib_tf_tpu_torch import tracing
from fib_tf_tpu_torch.kernels import binding, build
from fib_tf_tpu_torch.models.base import Geometry, IonicModel
from fib_tf_tpu_torch.ops import bodies, stencil
from fib_tf_tpu_torch.ops.bodies import BODIES, State, plane_pointers

SOURCE = build.CSRC_DIR / "br_volume_block.cu"


# -- the plain geometry of a z-extended block -----------------------------------------


def _zup(x):     # y[z] = x[z-1]; slice 0 keeps itself (halo garbage)
    return torch.cat([x[:1], x[:-1]], dim=0)


def _zdown(x):   # y[z] = x[z+1]; the last slice keeps itself
    return torch.cat([x[1:], x[-1:]], dim=0)


def global_slices(zstart: int, n: int, device) -> torch.Tensor:
    """`[n, 1, 1]` global slice indices of a block whose slice 0 is slice
    `zstart`."""
    return zstart + torch.arange(n, dtype=torch.int32,
                                 device=device)[:, None, None]


def zblock_geometry(zg: torch.Tensor, d_total: int,
                    dz_ratio: float = 1.0) -> Geometry:
    """Geometry over a volume block extended with k ghost z-slices.

    `zg` is the `[ext_d, 1, 1]` int tensor of global z indices of the
    block's slices; slices outside [0, d_total) are halo garbage that
    shrinks away one ring per substep.  In the plane each shard owns the
    full `[H, W]` sheet, so the in-plane operators are the plain ones
    (REFLECT / SYMMETRIC at the true edges); only the z direction needs
    global-edge masking (REFLECT at global z = 0 / d_total - 1, ghost
    slices elsewhere).  Phase fields and fiber tensors are not ported yet
    (ROADMAP Queue 1 items 9 and 18)."""
    top = zg == 0
    bottom = zg == d_total - 1

    def laplace(x):
        zu = _zup(x)
        zd = _zdown(x)
        # reflect at the global faces: slice 0's z neighbour is slice 1
        z_term = (torch.where(top, zd, zu) - 2.0 * x
                  + torch.where(bottom, zu, zd))
        return stencil.laplace(x) + (2.0 * dz_ratio) * z_term

    def enforce_boundary(x):
        # SYMMETRIC z faces only at the global edges, in-plane faces
        # everywhere; raw shifts from the pre-rewrite array
        zd = _zdown(x)
        zu = _zup(x)
        x = torch.where(top, zd, x)
        x = torch.where(bottom, zu, x)
        return stencil.enforce_boundary(x)

    return Geometry(laplace=laplace, enforce_boundary=enforce_boundary)


# -- the binding --------------------------------------------------------------------------


class VolumeBlockKernel(binding.Binding):
    """ctypes binding of one cell body's entry `<body>_volume_block` of
    csrc/br_volume_block.cu, in the library of the body's
    `CellBody.library` (`library_name`: br_volume_block, court_volume_block
    for the Courtemanche bodies or lrtp_volume_block for Luo-Rudy's and
    tp06's); `launches` counts successful launches per template flag
    ("slow" = SLOW=true, "frozen" = SLOW=false; Fenton, Mitchell-Schaeffer
    and Courtemanche-ultra launch SLOW=true alone, Courtemanche's slow
    commit is SLOW=true)."""

    ARGS = ("slow:i params:p n_params:i dz_ratio:f v_in:p v_out:p planes:p "
            "n_planes:i ext_d:i height:i width:i zstart:i d_total:i z_lo:i "
            "z_hi:i")
    PROBE = binding.PROBE_3D
    PER_FORM = True

    def __init__(self, body: str):
        b = BODIES[body]
        super().__init__(f"{body}_volume_block", SOURCE,
                         b.library.name("volume_block"), b, False,
                         b.library.defines, b.library.flags)

    def launch(self, params: np.ndarray, state: State,
               v_out: Optional[torch.Tensor], slow: bool, dz_ratio: float,
               zstart: int, d_total: int, z_lo: int, z_hi: int,
               probe: Optional[torch.Tensor], pixel, probe_index: int,
               stream: int):
        """One substep on the slices [z_lo, z_hi) of CUDA tensors already
        validated by the caller: the potential goes from the state's to
        `v_out` (None for a form that keeps it), the other planes are
        updated in place."""
        with tracing.span(self.span_name):
            v_in = state[self.body.model.pot_key]
            ext_d, h, w = v_in.shape
            planes = self.body.planes
            self.call(
                int(slow), params.ctypes.data, params.size, dz_ratio,
                v_in.data_ptr(), None if v_out is None else v_out.data_ptr(),
                plane_pointers(state, planes), len(planes),
                ext_d, h, w, zstart, d_total, z_lo, z_hi,
                probe.data_ptr() if probe is not None else None,
                *pixel, probe_index, v_in.device.index, stream, slow=slow)


# the process-wide bindings, one per cell body: the built library is
# process-wide too.  KERNEL is Beeler-Reuter's.
KERNELS = {name: VolumeBlockKernel(name) for name in bodies.hosted(6)}
KERNEL = KERNELS["br"]


# -- the step -------------------------------------------------------------------------------


def group_schedule(model: IonicModel, substeps: Optional[int]):
    """`slow` flag of each launch of one group: the whole outer step's
    schedule (`substeps=None`; Courtemanche's eleven launches for ten
    substeps), or `substeps` uniform substeps, which only a model with
    uniform substeps has (no-skip BR, LR1 and tp06, Courtemanche-ultra: all
    SLOW)."""
    schedule = model.launch_schedule
    if substeps is None:
        return schedule
    if not model.has_uniform_substeps:
        raise ValueError(
            f"a group of {substeps} substeps needs uniform substeps, which "
            f"{model.name} does not have with this config")
    return schedule[:substeps]


def plain_volume_block_step(model: IonicModel, state: State, zstart: int,
                            d_total: int, dz_ratio: float = 1.0,
                            substeps: Optional[int] = None,
                            probe: Optional[torch.Tensor] = None,
                            probe_index: int = 0,
                            probe_slice: int = 0) -> State:
    """Plain PyTorch version of one group: `model.step` (or
    `substep_group`) on the extended block under `zblock_geometry`
    (volume_spmd.py:254-262).  With `probe` (the owning shard only), the
    normalised new V at the model's probe pixel of LOCAL slice
    `probe_slice` goes to `probe[probe_index]`."""
    v = state[model.pot_key]
    geom = zblock_geometry(global_slices(zstart, v.shape[0], v.device),
                           d_total, dz_ratio)
    new = (model.step(dict(state), geom) if substeps is None
           else model.substep_group(dict(state), geom, substeps))
    for key, t in new.items():
        state[key].copy_(t)
    if probe is not None:
        probe[probe_index] = block_probe(model, state, probe_slice)
    return state


def block_probe(model: IonicModel, state: State,
                local_slice: int) -> torch.Tensor:
    """The normalised potential at the volume's probe pixel on the block's
    slice `local_slice` (0-d)."""
    h, w = model.state_shape()
    r, c = model.probe_pixel
    v = state[model.pot_key][local_slice, min(r, h - 1), min(c, w - 1)]
    return (v - model.min_v) / (model.max_v - model.min_v)


def make_volume_block_step(model: IonicModel, ext_d: int, d_total: int,
                           dz_ratio: float = 1.0,
                           substeps: Optional[int] = None):
    """Build `step(state, spare, zstart, probe=None, probe_index=0,
    probe_slice=0, stream=None) -> (state, spare)`: one group of substeps
    on one shard's `[ext_d, H, W]` extended block whose slice 0 is global
    slice `zstart` (ghosts included), one launch per substep (and
    Courtemanche's slow commit).  `spare` is the block's second V buffer;
    the pair comes back swapped when the group has an odd number of
    substeps.  Pass `probe` only on the shard that
    owns the probe pixel, with its LOCAL slice; the group's last launch
    writes it.  `stream` is the CUDA stream to launch on (default: the
    device's current one).  CPU blocks take `plain_volume_block_step`."""
    body = bodies.body_on(model, 6)
    kernel = KERNELS[body.name]
    schedule = group_schedule(model, substeps)
    # the substeps: a launch that keeps the potential shrinks nothing
    n = sum(map(body.writes_potential, schedule))
    if ext_d <= 2 * n:
        raise ValueError(f"a {ext_d}-slice block has no centre left after "
                         f"{n} substeps")
    params = bodies.pack_params(model)
    pot = model.pot_key
    h, w = model.state_shape()
    shape = (ext_d, h, w)
    pixel = (min(model.probe_pixel[0], h - 1), min(model.probe_pixel[1], w - 1))

    def step(state: State, spare: torch.Tensor, zstart: int,
             probe: Optional[torch.Tensor] = None, probe_index: int = 0,
             probe_slice: int = 0,
             stream: Optional[torch.cuda.Stream] = None
             ) -> Tuple[State, torch.Tensor]:
        dev = bodies.check_state(model, state, shape)
        if not (zstart + n >= 0 and zstart + ext_d - n <= d_total):
            raise ValueError(
                f"a {ext_d}-slice block at slice {zstart} with a {n}-slice "
                f"halo is not a window of the {d_total}-slice volume")
        bodies.check_probe(probe, probe_index, dev,
                           (probe_slice - n,) + pixel, (ext_d - 2 * n, h, w))
        if dev.type == "cpu":
            plain_volume_block_step(model, state, zstart, d_total, dz_ratio,
                                    substeps, probe, probe_index,
                                    probe_slice)
            return state, spare
        if (spare.shape != shape or spare.device != dev
                or spare.dtype != torch.float32 or not spare.is_contiguous()
                or spare.data_ptr() in {t.data_ptr()
                                        for t in state.values()}):
            raise ValueError(
                f"spare must be another contiguous float32 {shape} tensor "
                f"on {dev}")
        s = stream if stream is not None else torch.cuda.current_stream(dev)
        done = 0    # substeps of the group launched so far
        for i, slow in enumerate(schedule):
            writes = body.writes_potential(slow)
            # substep `done` is exact on [done + 1, ext_d - 1 - done)
            kernel.launch(params, state, spare if writes else None, slow,
                          dz_ratio, zstart, d_total, done + 1,
                          ext_d - 1 - done,
                          probe if i == len(schedule) - 1 else None,
                          (probe_slice,) + pixel, probe_index, s.cuda_stream)
            if writes:
                state[pot], spare = spare, state[pot]
                done += 1
        return state, spare

    return step
