"""The tiled Beeler-Reuter volume outer-step kernel's wrapper and its plain
version.

Counterpart of fib_tf_tpu/ops/pallas_volume.py::make_tiled_volume_step,
the kernel run_volume runs past the 32 MB whole-volume envelope: one launch
per outer step, all five substeps fused over in-plane tiles that hold the
full depth, with a halo of one ring per substep in the tiled directions.
The kernel is csrc/br_volume_tiled.cu (CUDA C++, built with nvcc and bound
with ctypes); its source note says what bounds it and why the whole
extended tile, all eight planes, lives in shared memory.

The tile is TILE_W = 32 columns wide and `tile_rows(depth, n_sub)` rows
tall per slice: the most that fits a block's shared memory at that depth.
A depth too deep to leave an interior after the halo has no tile
(`tile_rows` is None); engine/volume.py::volume_route sends such a volume
to the substep kernel.

Routing is by the device of the state's tensors, as in ops/cuda_step.py:
CPU tensors take the plain version, CUDA tensors launch the kernel, and a
launch that fails raises.  Nothing falls back from the card to the plain
version.

State update contract: the state dict is updated IN PLACE and returned.
On the card every plane is replaced by a new tensor (the kernel reads all
eight planes of its neighbours' halos, so none can be rewritten in place);
the new planes are views of one [8, D, H, W] allocation.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from fib_tf_tpu_torch.kernels import build
from fib_tf_tpu_torch.models.beeler_reuter import BeelerReuter
from fib_tf_tpu_torch.ops import cuda_step, cuda_volume
from fib_tf_tpu_torch.ops.cuda_step import CELL_PLANES, PARAM_FLOATS, State
from fib_tf_tpu_torch.ops.cuda_tiled import slow_mask

SOURCE = build.CSRC_DIR / "br_volume_tiled.cu"
HEADERS = (build.CSRC_DIR / "br_cell.cuh",)
# The tile layout br_volume_tiled.cu is built for (checked against the
# library): columns per tile (one thread each), threads per block in y,
# the most rows per slice, and the dynamic shared memory one block may use
# on sm_90 (227 KB).
TILE_W = 32
THREADS_Y = 32
TILE_H_MAX = 64
SMEM_BYTES_MAX = 232448
# floats of shared memory per tile cell: V double-buffered + 7 planes
FLOATS_PER_CELL = 2 + len(CELL_PLANES)

# The plain version of one outer step is the volume substep kernel's: the
# tiled kernel computes the same function in one launch.
plain_tiled_volume_step = cuda_volume.plain_volume_step


def tile_rows(depth: int, n_sub: int) -> Optional[int]:
    """Rows per slice of the extended tile at `depth` (the most that fit
    the shared memory, capped at TILE_H_MAX), or None when no interior row
    is left after an `n_sub`-ring halo."""
    rows = min(TILE_H_MAX,
               SMEM_BYTES_MAX // (4 * FLOATS_PER_CELL * depth * TILE_W))
    if rows - 2 * n_sub < 1 or TILE_W - 2 * n_sub < 1:
        return None
    return rows


def max_depth(n_sub: int) -> int:
    """The deepest volume the kernel takes for `n_sub` substeps."""
    depth = 3
    while tile_rows(depth + 1, n_sub) is not None:
        depth += 1
    return depth


class VolumeTiledKernel:
    """ctypes binding of csrc/br_volume_tiled.cu.  The library is built and
    loaded on the first launch; `launches` counts successful launches."""

    def __init__(self):
        self._lib = None
        self.reset_launches()

    def reset_launches(self):
        self.launches = 0

    def build(self):
        """Build the library (if needed) and return its path."""
        return build.build("br_volume_tiled", [SOURCE], HEADERS)

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load("br_volume_tiled", [SOURCE], HEADERS)
            for fn in ("br_volume_tiled_param_floats",
                       "br_volume_tiled_planes"):
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = ctypes.c_int
            lib.br_volume_tiled_layout.argtypes = [
                ctypes.POINTER(ctypes.c_int)] * 4
            lib.br_volume_tiled_layout.restype = None
            lib.br_volume_tiled.argtypes = (
                [ctypes.c_void_p, ctypes.c_int,      # params, n_params
                 ctypes.c_float,                     # dz_ratio
                 ctypes.c_void_p, ctypes.c_void_p,   # v_in, v_out
                 ctypes.c_void_p, ctypes.c_void_p,   # planes in / out
                 ctypes.c_int]                       # n_planes
                + [ctypes.c_int] * 4                 # depth, height, width,
                                                     # tile_h
                + [ctypes.c_int, ctypes.c_uint,      # n_sub, slow_mask
                   ctypes.c_void_p,                  # probe (may be null)
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,  # probe z, r, c
                   ctypes.c_longlong,                # probe index
                   ctypes.c_int,                     # device ordinal
                   ctypes.c_void_p]                  # cudaStream_t
            )
            lib.br_volume_tiled.restype = ctypes.c_int
            _check_layout(lib)
            self._lib = lib
        return self._lib

    def launch(self, params: np.ndarray, state: State, schedule,
               dz_ratio: float, rows: int, probe: Optional[torch.Tensor],
               pixel, probe_index: int, stream: int):
        """One outer step on CUDA tensors already validated by the caller;
        the state's planes are replaced by the new ones."""
        lib = self.library()
        v_in = state["V"]
        d, h, w = v_in.shape
        out = dict(zip(("V",) + CELL_PLANES, torch.empty(
            (1 + len(CELL_PLANES), d, h, w), dtype=v_in.dtype,
            device=v_in.device).unbind(0)))
        ptrs = ctypes.c_void_p * len(CELL_PLANES)
        err = lib.br_volume_tiled(
            params.ctypes.data, params.size, dz_ratio,
            v_in.data_ptr(), out["V"].data_ptr(),
            ptrs(*[state[k].data_ptr() for k in CELL_PLANES]),
            ptrs(*[out[k].data_ptr() for k in CELL_PLANES]),
            len(CELL_PLANES), d, h, w, rows, len(schedule),
            slow_mask(schedule),
            probe.data_ptr() if probe is not None else None,
            *pixel, probe_index, v_in.device.index, stream,
        )
        if err != 0:
            raise RuntimeError(
                f"br_volume_tiled launch failed with CUDA error {err} "
                f"({d}x{h}x{w}, tile rows {rows}, {len(schedule)} substeps)")
        self.launches += 1
        state.update(out)


def _check_layout(lib):
    """The library's parameter block, planes and tile layout must be the
    ones this module packs and sizes."""
    layout = [ctypes.c_int() for _ in range(4)]
    lib.br_volume_tiled_layout(*map(ctypes.byref, layout))
    got = (lib.br_volume_tiled_param_floats(), lib.br_volume_tiled_planes(),
           tuple(v.value for v in layout))
    want = (PARAM_FLOATS, len(CELL_PLANES),
            (TILE_W, THREADS_Y, TILE_H_MAX, SMEM_BYTES_MAX))
    if got != want:
        raise RuntimeError(
            f"br_volume_tiled.cu takes (param floats, planes, layout) = "
            f"{got}, this module packs {want}")


# the process-wide binding: the built library is process-wide too
KERNEL = VolumeTiledKernel()


def make_tiled_volume_step(model: BeelerReuter, depth: int,
                           dz_ratio: float = 1.0):
    """Build `step(state, probe=None, probe_index=0) -> state`, one outer
    step of a `[depth, H, W]` volume in one launch of the tiled volume
    kernel.  The kernel writes the probe after the last substep.  CPU
    states take `plain_tiled_volume_step`."""
    if not isinstance(model, BeelerReuter):
        raise NotImplementedError(
            f"no CUDA kernel for model {model.name!r} yet (ROADMAP Queue 1)")
    schedule = cuda_step.slow_schedule(model)
    rows = tile_rows(depth, len(schedule))
    if rows is None:
        raise ValueError(
            f"depth {depth} leaves the tiled volume kernel no interior "
            f"after a {len(schedule)}-ring halo (deepest: "
            f"{max_depth(len(schedule))}); use the substep kernel")
    params = cuda_step.pack_params(model)
    pixel = cuda_volume.volume_probe_pixel(model, depth)

    def step(state: State, probe: Optional[torch.Tensor] = None,
             probe_index: int = 0) -> State:
        dev = cuda_volume.check_volume(model, state, depth, probe,
                                       probe_index)
        if dev.type == "cpu":
            return plain_tiled_volume_step(model, state, probe, probe_index,
                                           dz_ratio)
        KERNEL.launch(params, state, schedule, dz_ratio, rows, probe, pixel,
                      probe_index, torch.cuda.current_stream(dev).cuda_stream)
        return state

    return step
