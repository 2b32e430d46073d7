"""The substep kernel's wrappers and the plain version.

Counterpart of fib_tf_tpu/ops/pallas_step.py::make_pallas_step as the JAX
engine runs it: one launch per substep.  The kernel is csrc/br_substep.cu
(CUDA C++, built with nvcc and bound with ctypes), which hosts every cell
body of the port (ops/bodies.BODIES), one entry each, in three libraries
of the same source: the BR library's (Beeler-Reuter's bodies, Fenton's
and Mitchell-Schaeffer's), the Courtemanche bodies' (`COURT_LIBRARY`) and
Luo-Rudy 1991's and tp06's (`LRTP_LIBRARY`).  A BR body has two forms (the
substep that advances the slow gates, n=5 under skip, and the n=0 substep
that freezes them), and so do LR1's and tp06's (n=10 under skip);
Fenton's and Mitchell-Schaeffer's one form runs ten launches per outer
step.  Courtemanche's two forms are the fast commit (SLOW=false) and the
slow commit (SLOW=true), which reads the new V and writes no potential:
eleven launches per outer step; Courtemanche-ultra's one form ten.  Its
source note says what bounds it and what the simple design leaves for
later.

Routing is by the device of the state's tensors: CPU tensors take the plain
PyTorch version (the model's own `commit` on the ported stencil); CUDA
tensors launch the kernel, and a launch that fails raises.  Nothing falls
back from the card to the plain version.

Geometry (ops/bodies.GeometryMaps) takes each entry's GEOM form,
`<body>_substep_geom` (`GEOM_KERNELS`), and the plain version takes the
model's `commit` under `grid_geometry`'s operators.  A run without
geometry launches the isotropic entries, as before.

State update contract (both versions): the state dict is updated IN PLACE
and returned.  The potential (`model.pot_key`: "V" for BR, "u" for Fenton
and Mitchell-Schaeffer) is replaced by a new tensor (the kernel
double-buffers it); the other planes keep their tensors and are
overwritten.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from fib_tf_tpu_torch import tracing
from fib_tf_tpu_torch.kernels import binding, build
from fib_tf_tpu_torch.models.base import Geometry, IonicModel, grid_geometry
from fib_tf_tpu_torch.ops.bodies import (BODIES, GeometryMaps, State,
                                         body_on, check_probe, check_state,
                                         hosted, pack_params, plane_pointers,
                                         write_back)

SOURCE = build.CSRC_DIR / "br_substep.cu"


class CommitCache:
    """A body's cache on kernel 1 (`CellBody.cache`): one float32 plane per
    name on each device, made at the shape of the state that first uses
    it there and made anew when that shape changes.  It is never part of
    the state: every slow commit stores it and the fast commits after it
    in the outer step read it (`cache_schedule`), so no value outlives the
    outer step."""

    def __init__(self, names: tuple):
        self.names = names
        self._planes: Dict[torch.device, tuple] = {}

    def planes(self, like: torch.Tensor) -> torch.Tensor:
        """The cache for the state plane `like`, `[len(names), H, W]` on its
        device."""
        return self._made(like)[0]

    def pointers(self, like: torch.Tensor) -> tuple:
        """The device pointers of `planes(like)`, in `names` order."""
        return self._made(like)[1]

    def _made(self, like: torch.Tensor) -> tuple:
        made = self._planes.get(like.device)
        if made is None or made[0].shape[1:] != like.shape:
            t = torch.empty((len(self.names), *like.shape),
                            dtype=torch.float32, device=like.device)
            made = self._planes[like.device] = (
                t, tuple(p.data_ptr() for p in t))
        return made


def cache_schedule(schedule) -> tuple:
    """Whether each launch of an outer step (`launch_schedule`) reads its
    body's cache: every fast commit after the slow commit, which stores
    it; the fast commit before it computes its terms from the planes."""
    reads, stored = [], False
    for slow in schedule:
        reads.append(stored and not slow)
        stored = stored or slow
    return tuple(reads)


class SubstepKernel(binding.Binding):
    """ctypes binding of one cell body's entry `<body>_substep` of
    csrc/br_substep.cu, or with `geom` its GEOM form `<body>_substep_geom`,
    in the library of the body's `CellBody.library` (`library_name`:
    br_substep, court_substep for the Courtemanche bodies or lrtp_substep
    for Luo-Rudy's and tp06's).  `launches` counts successful launches per
    template flag ("slow" = SLOW=true, "frozen" = SLOW=false; Fenton,
    Mitchell-Schaeffer and Courtemanche-ultra launch SLOW=true alone,
    Courtemanche's slow commit is SLOW=true and its fast commit
    SLOW=false), and `cached_launches` the fast commits among them that
    read the body's cache.  A body with a cache (`CellBody.cache`) keeps it
    here, in `cache`, a `CommitCache` that every slow launch stores; the
    launches of one device go to one stream, in order, so that a fast
    launch reads the last slow launch's cache."""

    ARGS = ("form:i params:p n_params:i v_in:p v_out:p planes:p n_planes:i "
            "height:i width:i")
    PER_FORM = True

    def __init__(self, body: str, geom: bool = False):
        b = BODIES[body]
        super().__init__(f"{body}_substep" + ("_geom" if geom else ""),
                         SOURCE, b.library.name("substep"), b, geom,
                         b.library.defines, b.library.flags,
                         layout=f"{body}_substep")
        self.cache = CommitCache(b.cache) if b.cache else None

    def reset_launches(self):
        super().reset_launches()
        self.cached_launches = 0

    def check(self, lib: ctypes.CDLL):
        """The library's cache must have the planes the body names."""
        n_cache = getattr(lib, f"{self.body.name}_substep_cache_planes")
        n_cache.argtypes, n_cache.restype = [], ctypes.c_int
        if n_cache() != len(self.body.cache):
            raise RuntimeError(
                f"{self.entry} has a cache of {n_cache()} planes, this "
                f"module names {len(self.body.cache)}")

    def launch(self, params: np.ndarray, state: State, slow: bool,
               probe: Optional[torch.Tensor], probe_pixel, probe_index: int,
               stream: int, geometry: tuple = (), cached: bool = False):
        """One substep on CUDA tensors already validated by the caller;
        `geometry` is a GEOM entry's trailing arguments
        (`bodies.kernel_geometry_args`).  A slow launch of a body with a
        cache stores it; with `cached`, a fast launch reads it in place of
        the planes its terms come from (`cache_schedule`)."""
        if cached and (slow or self.cache is None):
            raise ValueError(f"{self.entry}: only a fast commit of a body "
                             f"with a cache reads one")
        with tracing.span(self.span_name):
            pot = self.body.model.pot_key
            v_in = state[pot]
            writes = self.body.writes_potential(slow)
            v_out = torch.empty_like(v_in) if writes else None
            h, w = v_in.shape
            cache = (self.cache.pointers(v_in)
                     if self.cache is not None and (slow or cached) else ())
            self.call(
                int(slow) + 2 * bool(cache), params.ctypes.data, params.size,
                v_in.data_ptr(), v_out.data_ptr() if writes else None,
                plane_pointers(state, self.body.planes, cache),
                len(self.body.planes) + len(cache), h, w,
                probe.data_ptr() if probe is not None else None,
                probe_pixel[0], probe_pixel[1], probe_index,
                v_in.device.index, stream, *geometry, slow=slow)
            self.cached_launches += int(cached)
            if writes:
                state[pot] = v_out


# the process-wide bindings, one per cell body and form: the built library
# is process-wide too.  KERNEL is Beeler-Reuter's.
KERNELS = {name: SubstepKernel(name) for name in hosted(1)}
GEOM_KERNELS = {name: SubstepKernel(name, geom=True) for name in hosted(1)}
KERNEL = KERNELS["br"]


def plain_substep(model: IonicModel, state: State, slow: bool,
                  probe: Optional[torch.Tensor] = None,
                  probe_index: int = 0,
                  geom: Optional[Geometry] = None) -> State:
    """Plain PyTorch version of one kernel launch: the model's `commit`
    under `geom` (default the isotropic `grid_geometry()`), written back
    into `state` under the kernel's contract."""
    geom = grid_geometry() if geom is None else geom
    write_back(state, model.commit(state, geom, slow), model.pot_key)
    if probe is not None:
        probe[probe_index] = model.probe(state)
    return state


def plain_cached_substep(model: IonicModel, state: State, cache: State,
                         probe: Optional[torch.Tensor] = None,
                         probe_index: int = 0,
                         geom: Optional[Geometry] = None) -> State:
    """Plain version of a fast commit that reads the cache in place of
    the planes its terms come from, written back into `state` as
    `plain_substep` writes.  The plain version of the cache a slow commit
    stores is the model's `fast_invariants` of the state it has just
    written."""
    geom = grid_geometry() if geom is None else geom
    write_back(state, model.fast_commit(state, geom, cache), model.pot_key)
    if probe is not None:
        probe[probe_index] = model.probe(state)
    return state


def substep(model: IonicModel, state: State, slow: bool,
            probe: Optional[torch.Tensor] = None,
            probe_index: int = 0,
            maps: Optional[GeometryMaps] = None) -> State:
    """One substep: the kernel on CUDA tensors, the plain version on CPU
    tensors, under the geometry `maps` if given.  For BR, `slow` advances
    the slow gates (the n=5 substep under skip).  With `probe`, writes the
    normalized new potential at `model.probe_pixel` to
    `probe[probe_index]`.  On the card a slow substep of a body with a
    cache also stores it (`SubstepKernel.cache`)."""
    body = body_on(model, 1)
    dev = check_state(model, state)
    check_probe(probe, probe_index, dev, model.probe_pixel,
                model.state_shape())
    geometric = maps is not None and not maps.empty
    if dev.type == "cpu":
        return plain_substep(model, state, slow, probe, probe_index,
                             maps.plain(dev) if geometric else None)
    kernel = (GEOM_KERNELS if geometric else KERNELS)[body.name]
    kernel.launch(pack_params(model), state, slow, probe, model.probe_pixel,
                  probe_index, torch.cuda.current_stream(dev).cuda_stream,
                  maps.args(dev) if geometric else ())
    return state


def plain_step(model: IonicModel, state: State,
               probe: Optional[torch.Tensor] = None,
               probe_index: int = 0,
               geom: Optional[Geometry] = None) -> State:
    """Plain version of one outer step (a `plain_substep` per launch of
    the model's `launch_schedule`, under `geom`, default the isotropic
    stencil; the probe is taken after the last)."""
    geom = grid_geometry() if geom is None else geom
    for slow in model.launch_schedule:
        plain_substep(model, state, slow, geom=geom)
    if probe is not None:
        probe[probe_index] = model.probe(state)
    return state


def make_cuda_step(model: IonicModel, phase: Optional[np.ndarray] = None,
                   fiber: Optional[tuple] = None,
                   dmap: Optional[np.ndarray] = None):
    """Build `step(state, probe=None, probe_index=0) -> state`, one outer
    step: one launch per substep (BR: one slow launch and four frozen ones
    under skip, five slow launches without; Fenton, Mitchell-Schaeffer and
    Courtemanche-ultra: ten; Courtemanche: eleven, its substep 0 being the
    fast commit and the slow commit).  The last launch writes the probe.
    With a phase field, a fiber tensor (dxx, dxy, dyy) or a diffusion map
    (make_pallas_step's), each launch is the body's GEOM entry.  The fast
    commits of a body with a cache (Courtemanche) read it as
    `cache_schedule` says.  CPU states take `plain_step`."""
    maps = GeometryMaps(model.state_shape(), phase, fiber, dmap)
    body = body_on(model, 1).name
    kernel = (KERNELS if maps.empty else GEOM_KERNELS)[body]
    params = pack_params(model)
    schedule = model.launch_schedule
    reads = (cache_schedule(schedule) if kernel.cache is not None
             else (False,) * len(schedule))
    last = len(schedule) - 1

    def step(state: State, probe: Optional[torch.Tensor] = None,
             probe_index: int = 0) -> State:
        dev = check_state(model, state)
        check_probe(probe, probe_index, dev, model.probe_pixel,
                    model.state_shape())
        if dev.type == "cpu":
            return plain_step(model, state, probe, probe_index,
                              maps.plain(dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        geometry = () if maps.empty else maps.args(dev)
        for i, (slow, cached) in enumerate(zip(schedule, reads)):
            kernel.launch(params, state, slow,
                          probe if i == last else None, model.probe_pixel,
                          probe_index, stream, geometry, cached)
        return state

    return step
