"""The per-shard block kernel's wrapper, its geometry and its plain version.

Counterpart of fib_tf_tpu/ops/pallas_tiled.py::make_block_kernel, the
per-shard compute of the wide-halo sharded path (parallel/spmd.py): one
outer step (all `dt_per_step` substeps) on ONE shard's block extended by
K = dt_per_step ghost rows on each side and, on a 2D mesh, K ghost columns.
The ghosts came from the neighbouring shards; the block's global origin
(`rstart`, `cstart`) and the domain's size decide where the REFLECT /
SYMMETRIC edge rules apply, so only a shard that owns a domain edge reflects
there.  The kernel is csrc/br_block.cu (CUDA C++, built with nvcc and bound
with ctypes; one entry per cell body of ops/bodies.BODIES: K = 5 for
Beeler-Reuter, 10 for Fenton and Mitchell-Schaeffer), the tile skeleton of
the tiled outer-step kernel (csrc/br_tile.cuh, on each body's tile shape,
cuda_tiled.tile_of) reading from the extended block; and for the bodies of
8-23 planes, whose tiles the skeleton's shared memory does not hold
(Courtemanche, Courtemanche-ultra, Luo-Rudy 1991, tp06; K = 10),
csrc/large_block.cu (`LargeBlockKernel`): one thread per cell and one
launch per commit of the outer step (eleven for Courtemanche, ten for the
others), each on the rows (and columns) that are still exact, V
double-buffered through a scratch plane.

`block_geometry` is the plain geometry of an extended block (the
reference's `block_geometry`, pallas_tiled.py:60-175, with its phase field,
fiber tensor and diffusion map): the wide-halo path's `kernel='xla'` step
and the kernel's plain version.  Under a geometry the launch is the body's
GEOM entry, `<body>_block_geom` (`GEOM_KERNELS`), which reads the shard's
phase field and diffusion map extended like its block (parallel/spmd.py
builds them once).

Routing is by the device of the block's tensors, as in ops/cuda_step.py:
CPU tensors take the plain version, CUDA tensors launch the kernel, and a
launch that fails raises.  Nothing falls back from the card to the plain
version.

Update contract: a step reads the extended planes of `ext_in` and writes
the CENTRE (the shard's own cells) of the extended planes of `ext_out`,
which must be other memory; `ext_out`'s ghosts are left for the halo
exchange to fill (the large bodies' launches leave garbage there, which
the exchange overwrites).  Writing into the other buffer of a double-buffered pair
fuses the reference's crop (spmd.py:400-404).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from fib_tf_tpu_torch import tracing
from fib_tf_tpu_torch.kernels import binding, build
from fib_tf_tpu_torch.models.base import Geometry, IonicModel
from fib_tf_tpu_torch.ops import bodies, cuda_tiled
from fib_tf_tpu_torch.ops.bodies import BODIES, State, plane_pointers

SOURCE = build.CSRC_DIR / "br_block.cu"
# the large bodies' block kernel, built as a library per body library
# (court_block, lrtp_block) holding the isotropic and the GEOM entries
LARGE_SOURCE = build.CSRC_DIR / "large_block.cu"
# the arguments both block kernels take after their first ones
_BLOCK_ARGS = ("v_in:p v_out:p planes_in:p planes_out:p n_planes:i ext_h:i "
               "ext_w:i rstart:i cstart:i halo:i two_d:i h_total:i "
               "w_total:i")


# -- the plain geometry of an extended block -----------------------------------------


def _row_up(x):     # y[i] = x[i-1]; row 0 keeps itself
    return torch.cat([x[:1], x[:-1]], dim=0)


def _row_down(x):   # y[i] = x[i+1]; the last row keeps itself
    return torch.cat([x[1:], x[-1:]], dim=0)


def _col_left(x):   # y[:, j] = x[:, j-1]; column 0 keeps itself
    return torch.cat([x[:, :1], x[:, :-1]], dim=1)


def _col_right(x):  # y[:, j] = x[:, j+1]; the last column keeps itself
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def global_rows(start: int, n: int, device) -> torch.Tensor:
    """`[n, 1]` global row indices of a block whose row 0 is row `start`."""
    return start + torch.arange(n, dtype=torch.int32, device=device)[:, None]


def global_cols(start: int, n: int, device) -> torch.Tensor:
    """`[1, n]` global column indices."""
    return start + torch.arange(n, dtype=torch.int32, device=device)[None, :]


def block_geometry(
    rg: torch.Tensor,
    h_total: int,
    cg: Optional[torch.Tensor] = None,
    w_total: Optional[int] = None,
    phase_ext: Optional[torch.Tensor] = None,
    fiber: Optional[tuple] = None,
    dmap_ext: Optional[torch.Tensor] = None,
) -> Geometry:
    """Geometry over a block extended with halo rows (and, when `cg` is
    given, halo columns).

    `rg` is the `[ext_h, 1]` int tensor of global row indices of the
    block's rows; rows outside [0, h_total) are halo garbage that shrinks
    away one ring per substep.  Without `cg`, columns span the full width
    and use plain REFLECT semantics; with `cg` (`[1, ext_w]` global column
    indices) the same global-edge masking applies along columns: the 2D
    wide-halo case.  `phase_ext` / `dmap_ext` are the phase field and the
    relative diffusion map on the same extended block, `fiber` the tensor
    (dxx, dxy, dyy) of the anisotropic operator (the reference's forms,
    value-identical to ops/stencil.py's on the gathered grid)."""
    top = rg == 0
    bottom = rg == h_total - 1

    def north(x):
        # reflect at the global top edge: row 0's north neighbour is row 1
        return torch.where(top, _row_down(x), _row_up(x))

    def south(x):
        return torch.where(bottom, _row_up(x), _row_down(x))

    if cg is None:
        def west(x):
            return torch.cat([x[:, 1:2], x[:, :-1]], dim=1)

        def east(x):
            return torch.cat([x[:, 1:], x[:, -2:-1]], dim=1)

        def col_fix(x):
            return torch.cat([x[:, 1:2], x[:, 1:-1], x[:, -2:-1]], dim=1)
    else:
        left_edge = cg == 0
        right_edge = cg == w_total - 1

        def west(x):
            return torch.where(left_edge, _col_right(x), _col_left(x))

        def east(x):
            return torch.where(right_edge, _col_left(x), _col_right(x))

        def col_fix(x):
            x = torch.where(left_edge, _col_right(x), x)
            return torch.where(right_edge, _col_left(x), x)

    def laplace(x):
        n = north(x)
        s = south(x)
        w = west(x)
        e = east(x)
        if fiber is not None:
            dxx, dxy, dyy = fiber
            vxx = w - 2.0 * x + e
            vyy = n - 2.0 * x + s
            vxy = 0.25 * (east(s) + west(n) - west(s) - east(n))
            l = 2.0 * (dxx * vxx + 2.0 * dxy * vxy + dyy * vyy)
        else:
            # ops/stencil.laplace's order, NW + SW + NE + SE: the block
            # equals the whole grid bit for bit
            l = (n + s + w + e
                 + 0.5 * (west(n) + west(s) + east(n) + east(s)) - 6.0 * x)
        if phase_ext is None and dmap_ext is None:
            return l
        if dmap_ext is not None:
            l = dmap_ext * l
            q = dmap_ext * phase_ext if phase_ext is not None else dmap_ext
        else:
            q = phase_ext
        phi = phase_ext if phase_ext is not None else 1.0
        gx = e - w
        gy = s - n
        qx = east(q) - west(q)
        qy = south(q) - north(q)
        if fiber is not None:
            flux = gx * (dxx * qx + dxy * qy) + gy * (dxy * qx + dyy * qy)
        else:
            flux = gy * qy + gx * qx
        return l + flux / (4.0 * phi)

    def enforce_boundary(x):
        x = torch.where(top, _row_down(x), x)       # row 0 <- row 1
        x = torch.where(bottom, _row_up(x), x)      # row H-1 <- row H-2
        return col_fix(x)

    return Geometry(laplace=laplace, enforce_boundary=enforce_boundary)


# -- the binding --------------------------------------------------------------------------


class BlockKernel(binding.Binding):
    """ctypes binding of one cell body's entry `<body>_block` of
    csrc/br_block.cu, or with `geom` its GEOM form `<body>_block_geom`,
    which a second library of the same source holds (`br_block_geom`,
    built with FIBTORCH_GEOM_ENTRIES); `launches` counts successful
    launches."""

    ARGS = f"params:p n_params:i {_BLOCK_ARGS} n_sub:i slow_mask:u"

    def __init__(self, body: str, geom: bool = False):
        suffix = "_geom" if geom else ""
        super().__init__(f"{body}_block{suffix}", SOURCE, f"br_block{suffix}",
                         BODIES[body], geom,
                         ("FIBTORCH_GEOM_ENTRIES",) if geom else ())

    def check(self, lib: ctypes.CDLL):
        cuda_tiled.check_tile_shape(lib, self.entry, self.body.name,
                                    self.geom)

    def launch(self, params: np.ndarray, ext_in: State, ext_out: State,
               rstart: int, cstart: int, halo: int, two_d: bool,
               h_total: int, w_total: int, schedule,
               probe: Optional[torch.Tensor], probe_pixel, probe_index: int,
               stream: int, geometry: tuple = ()):
        """One outer step on CUDA tensors already validated by the
        caller: reads `ext_in`, writes the centre of `ext_out`.
        `geometry` is a GEOM entry's trailing arguments, the maps of the
        extended layout (`bodies.kernel_geometry_args`)."""
        with tracing.span(self.span_name):
            pot, planes = self.body.model.pot_key, self.body.planes
            v_in = ext_in[pot]
            ext_h, ext_w = v_in.shape
            self.call(
                params.ctypes.data, params.size,
                v_in.data_ptr(), ext_out[pot].data_ptr(),
                plane_pointers(ext_in, planes),
                plane_pointers(ext_out, planes),
                len(planes), ext_h, ext_w, rstart, cstart, halo, int(two_d),
                h_total, w_total, len(schedule),
                cuda_tiled.slow_mask(schedule),
                probe.data_ptr() if probe is not None else None,
                probe_pixel[0], probe_pixel[1], probe_index,
                v_in.device.index, stream, *geometry)


class LargeBlockKernel(binding.Binding):
    """ctypes binding of one large cell body's entry `<body>_block` of
    csrc/large_block.cu, or with `geom` its GEOM form `<body>_block_geom`:
    one commit of the outer step per launch.  The library (`library_name`:
    court_block or lrtp_block, the body's `CellBody.library` with its
    defines and flags, both forms in one) is built and loaded on the first
    launch; `launches` counts successful launches per template flag
    ("slow" = SLOW=true, "frozen" = SLOW=false), as the substep kernel's
    binding does."""

    ARGS = f"slow:i params:p n_params:i {_BLOCK_ARGS} shrink:i copy_all:i"
    PER_FORM = True

    def __init__(self, body: str, geom: bool = False):
        b = BODIES[body]
        super().__init__(f"{body}_block" + ("_geom" if geom else ""),
                         LARGE_SOURCE, b.library.name("block"), b, geom,
                         b.library.defines, b.library.flags,
                         layout=f"{body}_block")

    def launch(self, params: np.ndarray, slow: bool, v_in: torch.Tensor,
               v_out: Optional[torch.Tensor], planes_in: State,
               planes_out: State, rstart: int, cstart: int, halo: int,
               two_d: bool, h_total: int, w_total: int, shrink: int,
               copy_all: bool, probe: Optional[torch.Tensor], probe_pixel,
               probe_index: int, stream: int, geometry: tuple = ()):
        """One commit on CUDA tensors already validated by the caller,
        after `shrink` substeps of the outer step: V from `v_in` to `v_out`
        (None for a form that keeps it), the other planes from `planes_in`
        to `planes_out` (the same dict updates in place; `copy_all` copies
        the planes the form does not commit).  `geometry` is a GEOM entry's
        trailing arguments, the maps of the extended layout."""
        with tracing.span(self.span_name):
            planes = self.body.planes
            ext_h, ext_w = v_in.shape
            self.call(
                int(slow), params.ctypes.data, params.size,
                v_in.data_ptr(), None if v_out is None else v_out.data_ptr(),
                plane_pointers(planes_in, planes),
                plane_pointers(planes_out, planes),
                len(planes), ext_h, ext_w, rstart, cstart, halo, int(two_d),
                h_total, w_total, shrink, int(copy_all),
                probe.data_ptr() if probe is not None else None,
                probe_pixel[0], probe_pixel[1], probe_index,
                v_in.device.index, stream, *geometry, slow=slow)

    def step(self, params: np.ndarray, schedule, ext_in: State,
             ext_out: State, rstart: int, cstart: int, halo: int,
             two_d: bool, h_total: int, w_total: int,
             probe: Optional[torch.Tensor], probe_pixel, probe_index: int,
             stream: torch.cuda.Stream, geometry: tuple = ()) -> State:
        """One outer step, one launch per entry of `schedule`: the first
        reads `ext_in` and writes every plane of `ext_out`, the others
        update `ext_out` in place; V alternates between a scratch plane and
        `ext_out`'s so that the last write lands in `ext_out`.  `ext_in` is
        not written."""
        pot = self.body.model.pot_key
        writes = [self.body.writes_potential(s) for s in schedule]
        with torch.cuda.stream(stream):
            scratch = torch.empty_like(ext_out[pot])
        # an even number of writes starts in the scratch plane
        targets = ((scratch, ext_out[pot]) if sum(writes) % 2 == 0
                   else (ext_out[pot], scratch))
        v, planes, done = ext_in[pot], ext_in, 0
        for i, (slow, w) in enumerate(zip(schedule, writes)):
            v_out = targets[done % 2] if w else None
            self.launch(params, slow, v, v_out, planes, ext_out, rstart,
                        cstart, halo, two_d, h_total, w_total, done, i == 0,
                        probe if i == len(schedule) - 1 else None,
                        probe_pixel, probe_index, stream.cuda_stream,
                        geometry)
            planes = ext_out
            if w:
                v, done = v_out, done + 1
        return ext_out


def large_body(body: str) -> bool:
    """Whether cell body `body` takes csrc/large_block.cu: a body of its
    own library (bodies.LARGE_KERNELS), whose planes the tile
    skeleton's shared memory does not hold."""
    return BODIES[body].library is not bodies.BR_LIBRARY


def _binding(body: str, geom: bool = False):
    return (LargeBlockKernel if large_body(body) else BlockKernel)(body, geom)


# the process-wide bindings, one per cell body and form: the built library
# is process-wide too.  KERNEL is Beeler-Reuter's.
KERNELS = {name: _binding(name) for name in bodies.hosted(3)}
GEOM_KERNELS = {name: _binding(name, geom=True)
                for name in bodies.hosted(3)}
KERNEL = KERNELS["br"]


# -- the step -------------------------------------------------------------------------------


def block_shape(h_local: int, w_local: int, halo: int, two_d: bool):
    """(ext_h, ext_w) of a shard's `h_local x w_local` block extended by
    `halo` ghost rows (and, when `two_d`, ghost columns) on each side."""
    return h_local + 2 * halo, w_local + (2 * halo if two_d else 0)


def centre(x: torch.Tensor, halo: int, two_d: bool) -> torch.Tensor:
    """The shard's own cells of an extended plane (a view)."""
    return x[halo:-halo, halo:-halo] if two_d else x[halo:-halo]


def plain_block_step(model: IonicModel, ext_in: State, ext_out: State,
                     rstart: int, cstart: int, two_d: bool,
                     probe: Optional[torch.Tensor] = None,
                     probe_index: int = 0,
                     phase_ext: Optional[torch.Tensor] = None,
                     fiber: Optional[tuple] = None,
                     dmap_ext: Optional[torch.Tensor] = None) -> State:
    """Plain PyTorch version of one launch: `model.step` on the extended
    block under `block_geometry` (with the block's `phase_ext`, `fiber`,
    `dmap_ext`), its centre copied into `ext_out` (spmd.py:406-414).  With
    `probe` (the owning shard only), the normalised new potential at the
    model's probe pixel goes to `probe[probe_index]`."""
    cfg = model.cfg
    halo = model.dt_per_step
    ext_h, ext_w = ext_in[model.pot_key].shape
    dev = ext_in[model.pot_key].device
    geom = block_geometry(
        global_rows(rstart, ext_h, dev), cfg.height,
        global_cols(cstart, ext_w, dev) if two_d else None,
        cfg.width if two_d else None, phase_ext, fiber, dmap_ext)
    new = model.step(dict(ext_in), geom)
    for k, t in new.items():
        centre(ext_out[k], halo, two_d).copy_(centre(t, halo, two_d))
    if probe is not None:
        r, c = model.probe_pixel
        v = new[model.pot_key][r - rstart, c - cstart]
        probe[probe_index] = (v - model.min_v) / (model.max_v - model.min_v)
    return ext_out


def make_block_step(model: IonicModel, two_d: bool,
                    fiber: Optional[tuple] = None):
    """Build `step(ext_in, ext_out, rstart, cstart, probe=None,
    probe_index=0, stream=None, phase_ext=None, dmap_ext=None) -> ext_out`:
    one outer step of one shard's extended block in one launch of the
    block kernel (for the large bodies, one launch of csrc/large_block.cu
    per commit; `ext_in` is not written).  `rstart` / `cstart` are the
    global indices of the
    block's element (0, 0), ghosts included (`cstart` is 0 on a 1D mesh).
    Pass `probe` only on the shard that owns the model's probe pixel.
    `stream` is the CUDA stream to launch on (default: the device's
    current one).  `phase_ext` / `dmap_ext` are the shard's phase field and
    diffusion map extended like its block; with them or with `fiber` (dxx,
    dxy, dyy) the launch is the GEOM entry.  CPU blocks take
    `plain_block_step`.

    `SimConfig.substeps_per_launch`, which the reference's block kernel
    takes to bound its compile time, has no effect here: the launch always
    fuses the whole outer step."""
    body = bodies.body_on(model, 3).name
    schedule = model.launch_schedule
    halo = model.dt_per_step
    for geom in () if large_body(body) else (False, True):
        if min(cuda_tiled.tile_interior(len(schedule), body, geom)) < 1:
            raise ValueError(
                f"tile {cuda_tiled.tile_of(body, geom)} has no interior "
                f"left after a {len(schedule)}-ring halo")
    if fiber is not None:
        fiber = tuple(float(f) for f in fiber)
    params = bodies.pack_params(model)
    h_total, w_total = model.state_shape()

    def step(ext_in: State, ext_out: State, rstart: int, cstart: int = 0,
             probe: Optional[torch.Tensor] = None, probe_index: int = 0,
             stream: Optional[torch.cuda.Stream] = None,
             phase_ext: Optional[torch.Tensor] = None,
             dmap_ext: Optional[torch.Tensor] = None) -> State:
        shape = tuple(ext_in[model.pot_key].shape)
        dev = bodies.check_state(model, ext_in, shape)
        if bodies.check_state(model, ext_out, shape) != dev:
            raise ValueError("ext_in and ext_out are on different devices")
        _check_block(shape, rstart, cstart, halo, two_d, h_total, w_total)
        bodies.check_maps((phase_ext, dmap_ext), shape, dev)
        geom = (fiber is not None or phase_ext is not None
                or dmap_ext is not None)
        if probe is not None:
            r, c = model.probe_pixel
            lr, lc = r - rstart - halo, c - cstart - (halo if two_d else 0)
            own_h = shape[0] - 2 * halo
            own_w = shape[1] - (2 * halo if two_d else 0)
            bodies.check_probe(probe, probe_index, dev, (lr, lc),
                               (own_h, own_w))
        if dev.type == "cpu":
            return plain_block_step(model, ext_in, ext_out, rstart, cstart,
                                    two_d, probe, probe_index, phase_ext,
                                    fiber, dmap_ext)
        s = stream if stream is not None else torch.cuda.current_stream(dev)
        kernel = (GEOM_KERNELS if geom else KERNELS)[body]
        args = (bodies.kernel_geometry_args(phase_ext, dmap_ext, fiber)
                if geom else ())
        if large_body(body):
            return kernel.step(params, schedule, ext_in, ext_out, rstart,
                               cstart, halo, two_d, h_total, w_total, probe,
                               model.probe_pixel, probe_index, s, args)
        kernel.launch(params, ext_in, ext_out, rstart, cstart, halo, two_d,
                      h_total, w_total, schedule, probe, model.probe_pixel,
                      probe_index, s.cuda_stream, args)
        return ext_out

    return step


def _check_block(shape, rstart, cstart, halo, two_d, h_total, w_total):
    """The extended block's centre must be a non-empty window of the
    domain."""
    ext_h, ext_w = shape
    ok = (ext_h > 2 * halo and rstart + halo >= 0
          and rstart + ext_h - halo <= h_total)
    if two_d:
        ok = ok and (ext_w > 2 * halo and cstart + halo >= 0
                     and cstart + ext_w - halo <= w_total)
    else:
        ok = ok and cstart == 0 and ext_w == w_total
    if not ok:
        raise ValueError(
            f"a {ext_h}x{ext_w} block at ({rstart}, {cstart}) with a "
            f"{halo}-cell halo is not a window of the {h_total}x{w_total} "
            f"domain")
