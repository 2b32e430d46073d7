"""The tiled Beeler-Reuter volume outer-step kernel's wrapper and its plain
version.

Counterpart of fib_tf_tpu/ops/pallas_volume.py::make_tiled_volume_step,
the kernel run_volume runs past the 32 MB whole-volume envelope: one launch
per outer step, all five substeps fused over in-plane tiles with a halo of
one ring per substep.  The kernel is csrc/br_volume_tiled.cu (CUDA C++,
built with nvcc and bound with ctypes).  It never holds a tile's full
depth: each block streams the slices of its in-plane tiles through a
wavefront of the substep levels (level s updates stream position t - s at
pipeline step t, across tile boundaries), so it takes any depth >= 3.
`tile_plan` mirrors the kernel's tiles, walk, levels, ring slots and
copies; its source note says what lives where and what bounds it.  It
hosts Beeler-Reuter's main cell body alone (cheby + cheby_fold +
cheby_currents, no ab2): for Fenton, Mitchell-Schaeffer and BR's other
variants `make_tiled_volume_step` raises NotImplementedError (ROADMAP
Queue 2 item D).

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
import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fib_tf_tpu_torch import tracing
from fib_tf_tpu_torch.kernels import binding, build
from fib_tf_tpu_torch.models.beeler_reuter import BeelerReuter
from fib_tf_tpu_torch.ops import bodies, cuda_volume
from fib_tf_tpu_torch.ops.bodies import BODIES, CELL_PLANES, State
from fib_tf_tpu_torch.ops.cuda_tiled import slow_mask, tile_spans, tile_walk

SOURCE = build.CSRC_DIR / "br_volume_tiled.cu"
# The layout br_volume_tiled.cu is built for (checked against the library):
# the extended in-plane tile (rows, columns), its threads (one per cell),
# the most substeps per launch, the ring slots of the loaded V, of each
# later level's input V and of the per-cell planes, and the dynamic shared
# memory one block may use on sm_90 (227 KB).
TILE = (30, 32)
THREADS = 960
MAX_SUB = 5
V_IN_SLOTS, V_SLOTS, PLANE_SLOTS = 4, 3, MAX_SUB + 1
SMEM_BYTES_MAX = 232448
# the persistent grid tile_plan assumes unless told: one block on each of
# an H100 SXM's 132 SMs (the kernel asks the card)
GRID = 132

# The plain version of one outer step is the volume substep kernel's: the
# tiled kernel computes the same function in one launch.
plain_tiled_volume_step = cuda_volume.plain_volume_step


def smem_bytes(tile: Tuple[int, int] = TILE) -> int:
    """Shared memory of one block: the loaded V's ring, levels 1..4's V
    rings and the ring of the seven per-cell planes."""
    cells = tile[0] * tile[1]
    slots = (V_IN_SLOTS + (MAX_SUB - 1) * V_SLOTS
             + PLANE_SLOTS * len(CELL_PLANES))
    return 4 * cells * slots


def balanced_rows(height: int, n_sub: int, n_cols: int, blocks: int,
                  tile_rows: int = TILE[0]):
    """The kernel's row split (csrc/br_volume_tiled.cu balanced_rows), as
    tile_spans: among n = ceil(height / (tile_rows - 2 n_sub)) .. 4 n row
    tiles, the one with the least waves x (rows + n_sub - 1) on a grid of
    `blocks`, the fewest tiles on a tie.  A warp is a row of the tile, so
    a tile costs its rows, not its columns."""
    least = -(-height // (tile_rows - 2 * n_sub))
    best, best_cost = least, None
    for n in range(least, min(height, 4 * least) + 1):
        cost = -(-n * n_cols // blocks) * (-(-height // n) + n_sub - 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = n, cost
    base, rem = divmod(height, best)
    return [(i * base + min(i, rem), base + (i < rem)) for i in range(best)]


def clamp(k: int, n: int) -> int:
    """The boundary index map of every axis: min(max(k, 1), n - 2)."""
    return min(max(k, 1), n - 2)


class Level(NamedTuple):
    """One level's work at a pipeline step: level `s` on slice `z` of tile
    `tile`, the block's stream position `p`; a barrier precedes it when it
    reads what another thread wrote in the same step."""

    s: int
    tile: int
    z: int
    p: int
    barrier: bool


class Copy(NamedTuple):
    """A copy a step starts: `what` ("planes" or "V") of slice `z` of
    tile `tile`, stream position `p`."""

    what: str
    tile: int
    z: int
    p: int


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """What br_volume_tiled.cu does for one launch, in its own terms.

    `tiles[i] = (r0, c0, eh, ew)`: tile i's local cell (0, 0) in global
    indices and its used extent (interior + 2 n_sub per axis), row-major.
    Block b of the grid of `n_blocks` walks `walk[b]`; its tiles' slices
    form one stream, position p = D i + z for slice z of its i-th tile.
    At pipeline step t level s updates position t - s (`steps(b)`), so the
    levels run on consecutive positions, across tile boundaries.  Level s
    reads its input V at slices `z_reads(z)` (clamp(z-1), clamp(z),
    clamp(z+1)) of the same tile and updates the ring [s+1, U-2-s] of the
    used extent.  Position p keeps its loaded V in slot `v_in_slot(p)`,
    its per-cell planes in `plane_slot(p)`, and level s's output in level
    s+1's slot `v_slot(p)`."""

    depth: int
    height: int
    width: int
    n_sub: int
    tile: Tuple[int, int]
    n_blocks: int
    row_spans: Tuple[Tuple[int, int], ...]
    col_spans: Tuple[Tuple[int, int], ...]

    @functools.cached_property
    def tiles(self) -> List[Tuple[int, int, int, int]]:
        k = self.n_sub
        return [(r - k, c - k, h + 2 * k, w + 2 * k)
                for r, h in self.row_spans for c, w in self.col_spans]

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.tile)

    @functools.cached_property
    def walk(self) -> List[List[int]]:
        """The tiles of each block, in the order it runs them."""
        return tile_walk(len(self.tiles), self.n_blocks)

    def z_reads(self, z: int) -> Tuple[int, int, int]:
        d = self.depth
        return clamp(z - 1, d), clamp(z, d), clamp(z + 1, d)

    @staticmethod
    def v_in_slot(p: int) -> int:
        return p % V_IN_SLOTS

    @staticmethod
    def v_slot(p: int) -> int:
        return p % V_SLOTS

    @staticmethod
    def plane_slot(p: int) -> int:
        return p % PLANE_SLOTS

    def clamp_free(self, tile: Tuple[int, int, int, int]) -> bool:
        """Whether a tile takes the clamp-free body: every cell a level
        updates lies one cell inside every in-plane domain edge."""
        r0, c0, eh, ew = tile
        return (r0 >= 1 and r0 + eh <= self.height - 1 and c0 >= 1
                and c0 + ew <= self.width - 1)

    def first_copies(self, block: int) -> List[Copy]:
        """What block b copies before its first step."""
        first = self.walk[block][0]
        return [Copy("planes", first, 0, 0), Copy("V", first, 1, 1)]

    def steps(self, block: int):
        """Block b's pipeline steps: (t, levels, copies) with the levels in
        the order they run and the copies the step starts (at its start:
        the planes of position t + 1 and the V of position t + 2, where
        that is a slice 1..D-2 that level 0 reads)."""
        stream = self.walk[block]
        d, k = self.depth, self.n_sub
        n_pos = len(stream) * d
        for t in range(n_pos + k - 1):
            levels, copies = [], []
            for s in range(k):
                p = t - s
                if 0 <= p < n_pos:
                    tile, z = stream[p // d], p % d
                    edge = not self.clamp_free(self.tiles[tile])
                    levels.append(Level(s, tile, z, p,
                                        s > 0 and (z == 0 or edge)))
            if t + 1 < n_pos:
                p = t + 1
                copies.append(Copy("planes", stream[p // d], p % d, p))
            if t + 2 < n_pos and 1 <= (t + 2) % d <= d - 2:
                p = t + 2
                copies.append(Copy("V", stream[p // d], p % d, p))
            yield t, levels, copies


def tile_plan(depth: int, height: int, width: int, n_sub: int,
              tile: Tuple[int, int] = TILE,
              n_blocks: int = GRID) -> TilePlan:
    """The kernel's plan for a `[depth, height, width]` volume and `n_sub`
    substeps on a grid of `n_blocks` (`tile`: the extended tile, TILE
    unless a test forces a smaller one)."""
    if depth < 3 or height < 3 or width < 3:
        raise ValueError(f"a volume needs D, H, W >= 3, got "
                         f"{depth}x{height}x{width}")
    if not 1 <= n_sub <= MAX_SUB:
        raise ValueError(f"the tiled volume kernel runs 1..{MAX_SUB} "
                         f"substeps per launch, not {n_sub}")
    th, tw = tile[0] - 2 * n_sub, tile[1] - 2 * n_sub
    if min(th, tw) < 1:
        raise ValueError(f"tile {tile} has no interior left after a "
                         f"{n_sub}-ring halo")
    cols = tile_spans(width, tw)
    rows = balanced_rows(height, n_sub, len(cols), n_blocks, tile[0])
    return TilePlan(depth, height, width, n_sub, tuple(tile), n_blocks,
                    tuple(rows), tuple(cols))


class VolumeTiledKernel(binding.Binding):
    """ctypes binding of csrc/br_volume_tiled.cu's one entry,
    `br_volume_tiled` (Beeler-Reuter's main body), in the library of the
    same name; `launches` counts successful launches."""

    ARGS = ("params:p n_params:i dz_ratio:f v_in:p v_out:p planes_in:p "
            "planes_out:p n_planes:i depth:i height:i width:i n_sub:i "
            "slow_mask:u")
    PROBE = binding.PROBE_3D

    def __init__(self):
        super().__init__("br_volume_tiled", SOURCE, "br_volume_tiled",
                         BODIES["br"])

    def check(self, lib: ctypes.CDLL):
        """The library's layout and row split must be the ones this
        module mirrors (tile_plan)."""
        lib.br_volume_tiled_layout.argtypes = [
            ctypes.POINTER(ctypes.c_int)] * 8
        lib.br_volume_tiled_layout.restype = None
        lib.br_volume_tiled_rows.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.br_volume_tiled_rows.restype = None
        layout = [ctypes.c_int() for _ in range(8)]
        lib.br_volume_tiled_layout(*map(ctypes.byref, layout))
        got = tuple(v.value for v in layout)
        want = (TILE[1], TILE[0], THREADS, MAX_SUB, V_IN_SLOTS, V_SLOTS,
                PLANE_SLOTS, smem_bytes())
        if got != want:
            raise RuntimeError(f"br_volume_tiled.cu is laid out as {got}, "
                               f"this module mirrors {want}")
        for height, n_cols, blocks in ((512, 24, 132), (128, 24, 132),
                                       (67, 6, 7), (9, 1, 132)):
            n, base, rem = (ctypes.c_int() for _ in range(3))
            lib.br_volume_tiled_rows(height, 5, n_cols, blocks,
                                     *map(ctypes.byref, (n, base, rem)))
            spans = [(i * base.value + min(i, rem.value),
                      base.value + (i < rem.value)) for i in range(n.value)]
            if spans != balanced_rows(height, 5, n_cols, blocks):
                raise RuntimeError(
                    f"br_volume_tiled.cu cuts {height} rows into tiles "
                    f"{spans}, tile_plan into "
                    f"{balanced_rows(height, 5, n_cols, blocks)}")

    def launch(self, params: np.ndarray, state: State, schedule,
               dz_ratio: float, probe: Optional[torch.Tensor], pixel,
               probe_index: int, stream: int):
        """One outer step on CUDA tensors already validated by the caller;
        the state's planes are replaced by the new ones."""
        with tracing.span(self.span_name):
            v_in = state["V"]
            d, h, w = v_in.shape
            out = dict(zip(("V",) + CELL_PLANES, torch.empty(
                (1 + len(CELL_PLANES), d, h, w), dtype=v_in.dtype,
                device=v_in.device).unbind(0)))
            self.call(
                params.ctypes.data, params.size, dz_ratio,
                v_in.data_ptr(), out["V"].data_ptr(),
                bodies.plane_pointers(state, CELL_PLANES),
                bodies.plane_pointers(out, CELL_PLANES),
                len(CELL_PLANES), d, h, w, len(schedule), slow_mask(schedule),
                probe.data_ptr() if probe is not None else None,
                *pixel, probe_index, v_in.device.index, stream)
            state.update(out)


# the process-wide binding: the built library is process-wide too
KERNEL = VolumeTiledKernel()


def make_tiled_volume_step(model: BeelerReuter, depth: int,
                           dz_ratio: float = 1.0):
    """Build `step(state, probe=None, probe_index=0) -> state`, one outer
    step of a `[depth, H, W]` volume (any depth >= 3) in one launch of the
    tiled volume kernel.  The kernel writes the probe after the last
    substep.  CPU states take `plain_tiled_volume_step`."""
    bodies.main_body_only(model, "tiled volume")
    schedule = model.launch_schedule
    h, w = model.state_shape()
    tile_plan(depth, h, w, len(schedule))   # raises on what it cannot run
    params = bodies.pack_params(model)
    pixel = cuda_volume.volume_probe_pixel(model, depth)

    def step(state: State, probe: Optional[torch.Tensor] = None,
             probe_index: int = 0) -> State:
        dev = cuda_volume.check_volume(model, state, depth, probe,
                                       probe_index)
        if dev.type == "cpu":
            return plain_tiled_volume_step(model, state, probe, probe_index,
                                           dz_ratio)
        KERNEL.launch(params, state, schedule, dz_ratio, probe, pixel,
                      probe_index, torch.cuda.current_stream(dev).cuda_stream)
        return state

    return step
