"""The tiled outer-step kernel's wrappers and its plain version.

Counterpart of fib_tf_tpu/ops/pallas_tiled.py::make_tiled_pallas_step, the
kernel the JAX engine runs past its 32 MB whole-grid cutover: one launch
per outer step, all its substeps fused over 2D tiles with a halo of one
ring per substep (Beeler-Reuter five, Fenton and Mitchell-Schaeffer ten).
The kernel is csrc/br_tiled.cu (CUDA C++, built with nvcc and bound with
ctypes; one entry per cell body of ops/bodies.BODIES) over the tile
skeleton of csrc/br_tile.cuh, which the per-shard block kernel shares; its
source note says what bounds it and why the tiles are 2D.

Routing is by the device of the state's tensors, as in ops/cuda_step.py:
CPU tensors take the plain version, CUDA tensors launch the kernel, and a
launch that fails raises.  Nothing falls back from the card to the plain
version.  With a phase field, a fiber tensor or a diffusion map
(make_tiled_pallas_step's `phase`, `fiber`, `dmap`) the launch is the
body's GEOM entry, `<body>_tiled_geom` (`GEOM_KERNELS`), on its own tile
shape (`tile_of(body, geom=True)`).

State update contract: the state dict is updated IN PLACE and returned.
On the card every plane is replaced by a new tensor (the kernel reads all
planes of its neighbours' halos, so none can be rewritten in place); the
new planes are views of one [planes, H, W] allocation.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from fib_tf_tpu_torch import tracing
from fib_tf_tpu_torch.kernels import binding, build
from fib_tf_tpu_torch.models.base import IonicModel
from fib_tf_tpu_torch.ops import bodies, cuda_step
from fib_tf_tpu_torch.ops.bodies import BODIES, State, plane_pointers

SOURCE = build.CSRC_DIR / "br_tiled.cu"
# The tile shape of a body's entry in br_tiled.cu and br_block.cu: (threads
# in x, threads in y, cells per thread along y).  The extended tile is
# x-threads wide and y-threads x cells tall; its interior loses one ring
# per substep on each side (54 x 54 of 64 x 64 for five, 44 x 44 for
# ten).  TILE, 1024 threads at 64 registers, was the fastest of five
# shapes timed at 2048x2048 on the card for BR's main body (PERF.md,
# Findings); BR's variant body spills at 64 registers, so its entries
# take 512 threads, which may hold 128 registers each, on the same 64 x 64
# tile.  Checked against the library on load.
TILE = (64, 16, 4)
TILES = {"br_variant": (64, 8, 8), "br_variant_ab2": (64, 8, 8)}
# the GEOM entries' tile shapes where they differ from TILES: BR's main
# body with the geometry spills at 64 registers (4 bytes, -Xptxas -v on the
# card), so its GEOM entries run 512 threads on the same 64 x 64 tile
GEOM_TILES = {"br": (64, 8, 8)}


def tile_of(body: str, geom: bool = False):
    """The tile shape of cell body `body`'s entry (`geom`: its GEOM
    entry's)."""
    if geom and body in GEOM_TILES:
        return GEOM_TILES[body]
    return TILES.get(body, TILE)

# The plain version of one outer step is the substep kernel's: the tiled
# kernel computes the same function in one launch.
plain_tiled_step = cuda_step.plain_step


def tile_interior(n_sub: int, body: str = "br", geom: bool = False):
    """(rows, cols) of the largest interior a tile of body `body` (`geom`:
    its GEOM entry) writes when it runs `n_sub` substeps (its halo is n_sub
    rings)."""
    bx, by, ry = tile_of(body, geom)
    return by * ry - 2 * n_sub, bx - 2 * n_sub


def tile_spans(length: int, max_tile: int):
    """[(start, size), ...] of the interior tiles that cut one axis of a
    launch's window, `length` cells, relative to its start: as few tiles as
    `max_tile` allows, of equal size to within one cell, the larger first
    (csrc/br_tile.cuh split_axis)."""
    n = -(-length // max_tile)
    base, rem = divmod(length, n)
    return [(i * base + min(i, rem), base + (i < rem)) for i in range(n)]


def tile_walk(n_tiles: int, n_blocks: int):
    """The tiles each persistent block computes, in order: block b takes
    b, b + grid, b + 2 grid, ... with grid = min(n_tiles, n_blocks)
    (csrc/br_tile.cuh tile_kernel)."""
    grid = min(n_tiles, n_blocks)
    return [list(range(b, n_tiles, grid)) for b in range(grid)]


def slow_mask(schedule) -> int:
    """The kernel's schedule: bit s set when substep s is SLOW."""
    return sum(1 << s for s, slow in enumerate(schedule) if slow)


class TiledKernel(binding.Binding):
    """ctypes binding of one cell body's entry `<body>_tiled` of
    csrc/br_tiled.cu, or with `geom` its GEOM form `<body>_tiled_geom`,
    which a second library of the same source holds (`br_tiled_geom`,
    built with FIBTORCH_GEOM_ENTRIES); `launches` counts successful
    launches."""

    ARGS = ("params:p n_params:i v_in:p v_out:p planes_in:p planes_out:p "
            "n_planes:i height:i width:i n_sub:i slow_mask:u")

    def __init__(self, body: str, geom: bool = False):
        suffix = "_geom" if geom else ""
        super().__init__(f"{body}_tiled{suffix}", SOURCE, f"br_tiled{suffix}",
                         BODIES[body], geom,
                         ("FIBTORCH_GEOM_ENTRIES",) if geom else ())

    def check(self, lib: ctypes.CDLL):
        check_tile_shape(lib, self.entry, self.body.name, self.geom)
        _check_split(lib)

    def launch(self, params: np.ndarray, state: State, schedule,
               probe: Optional[torch.Tensor], probe_pixel, probe_index: int,
               stream: int, geometry: tuple = ()):
        """One outer step on CUDA tensors already validated by the caller;
        the state's planes are replaced by the new ones.  `geometry` is a
        GEOM entry's trailing arguments
        (`bodies.kernel_geometry_args`)."""
        with tracing.span(self.span_name):
            pot, planes = self.body.model.pot_key, self.body.planes
            v_in = state[pot]
            h, w = v_in.shape
            out = dict(zip((pot,) + planes, torch.empty(
                (1 + len(planes), h, w), dtype=v_in.dtype,
                device=v_in.device).unbind(0)))
            self.call(
                params.ctypes.data, params.size,
                v_in.data_ptr(), out[pot].data_ptr(),
                plane_pointers(state, planes), plane_pointers(out, planes),
                len(planes), h, w, len(schedule), slow_mask(schedule),
                probe.data_ptr() if probe is not None else None,
                probe_pixel[0], probe_pixel[1], probe_index,
                v_in.device.index, stream, *geometry)
            state.update(out)


def check_tile_shape(lib, entry: str, body: str, geom: bool = False):
    """The tile shape of the library's `entry` must be the one this module
    sizes for `body` (`tile_of`)."""
    fn = getattr(lib, f"{entry}_tile_shape")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = None
    shape = [ctypes.c_int() for _ in range(3)]
    fn(*map(ctypes.byref, shape))
    got = tuple(s.value for s in shape)
    if got != tile_of(body, geom):
        raise RuntimeError(f"{entry}'s tile is {got}, this module sizes "
                           f"{tile_of(body, geom)}")


def _check_split(lib):
    """The library's split must be the one `tile_spans` mirrors."""
    lib.br_tiled_split.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.br_tiled_split.restype = None
    for length, max_tile in ((2048, 54), (512, 54), (1024, 54), (131, 62),
                             (9, 54), (2047, 60), (2048, 44), (532, 44)):
        n, base, rem = (ctypes.c_int() for _ in range(3))
        lib.br_tiled_split(length, max_tile, *map(ctypes.byref,
                                                  (n, base, rem)))
        spans = [(i * base.value + min(i, rem.value),
                  base.value + (i < rem.value)) for i in range(n.value)]
        if spans != tile_spans(length, max_tile):
            raise RuntimeError(
                f"br_tiled.cu cuts {length} cells into tiles {spans}, "
                f"tile_spans into {tile_spans(length, max_tile)}")


# the process-wide bindings, one per cell body and form: the built library
# is process-wide too.  KERNEL is Beeler-Reuter's.
KERNELS = {name: TiledKernel(name) for name in bodies.hosted(2)}
GEOM_KERNELS = {name: TiledKernel(name, geom=True)
                for name in bodies.hosted(2)}
KERNEL = KERNELS["br"]


def make_tiled_cuda_step(model: IonicModel,
                         phase: Optional[np.ndarray] = None,
                         fiber: Optional[tuple] = None,
                         dmap: Optional[np.ndarray] = None):
    """Build `step(state, probe=None, probe_index=0) -> state`, one outer
    step in one launch of the tiled kernel, under the geometry `phase`,
    `fiber` (dxx, dxy, dyy), `dmap` if given (the GEOM entry).  The kernel
    writes the probe after the last substep.  CPU states take
    `plain_tiled_step`."""
    maps = bodies.GeometryMaps(model.state_shape(), phase, fiber, dmap)
    body = bodies.body_on(model, 2).name
    geom = not maps.empty
    kernel = (GEOM_KERNELS if geom else KERNELS)[body]
    if model.cfg.substeps_per_launch is not None:
        # fib_tf_tpu/engine/simulation.py:590-597
        raise ValueError(
            "substeps_per_launch applies to the whole-grid and per-shard "
            "block kernels; the tiled kernel's temporal halo is sized for "
            "the full substep group and cannot split — drop the knob or "
            "stay under the whole-grid state budget")
    schedule = model.launch_schedule
    if min(tile_interior(len(schedule), body, geom)) < 1:
        raise ValueError(f"tile {tile_of(body, geom)} has no interior left "
                         f"after a {len(schedule)}-ring halo")
    params = bodies.pack_params(model)

    def step(state: State, probe: Optional[torch.Tensor] = None,
             probe_index: int = 0) -> State:
        dev = bodies.check_state(model, state)
        bodies.check_probe(probe, probe_index, dev, model.probe_pixel,
                           model.state_shape())
        if dev.type == "cpu":
            return plain_tiled_step(model, state, probe, probe_index,
                                    maps.plain(dev))
        kernel.launch(params, state, schedule, probe, model.probe_pixel,
                      probe_index, torch.cuda.current_stream(dev).cuda_stream,
                      maps.args(dev) if geom else ())
        return state

    return step
