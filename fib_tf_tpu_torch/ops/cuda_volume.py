"""The volume substep kernel's wrappers and its plain version.

Counterpart of fib_tf_tpu/ops/pallas_volume.py::make_pallas_volume_step,
the kernel run_volume runs for a volume whose state fits the 32 MB
whole-volume envelope: one outer step of a `[D, H, W]` volume, here as one
launch per substep, with the two forms of each Beeler-Reuter body (the n=5
substep that advances the slow gates, the n=0 substep that freezes them)
and the one form of the Fenton and Mitchell-Schaeffer bodies (ten launches
per outer step).
The kernel is csrc/br_volume.cu (CUDA C++, built with nvcc and bound with
ctypes; one entry per cell body of ops/cuda_step.BODIES); its source note
says what bounds it.

Routing is by the device of the state's tensors, as in ops/cuda_step.py:
CPU tensors take the plain version (`model.solve` on `volume_geometry`),
CUDA tensors launch the kernel, and a launch that fails raises.  Nothing
falls back from the card to the plain version.

State update contract (both versions, as ops/cuda_step.py): the state dict
is updated IN PLACE and returned.  The potential is replaced by a new
tensor; the other planes keep their tensors and are overwritten.

The probe of a volume is the normalised potential at `volume_probe_pixel`: the
model's probe pixel on the mid-depth slice, clamped to the grid
(fib_tf_tpu/engine/volume.py:488-498).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from fib_tf_tpu_torch.kernels import build
from fib_tf_tpu_torch.models.base import IonicModel, volume_geometry
from fib_tf_tpu_torch.ops import cuda_step
from fib_tf_tpu_torch.ops.cuda_step import BODIES, State

SOURCE = build.CSRC_DIR / "br_volume.cu"
HEADERS = (build.CSRC_DIR / "br_cell.cuh",
           build.CSRC_DIR / "br_variant_cell.cuh",
           build.CSRC_DIR / "br_volume_cell.cuh",
           build.CSRC_DIR / "cell_traits.cuh",
           build.CSRC_DIR / "court_cell.cuh",
           build.CSRC_DIR / "fenton_cell.cuh",
           build.CSRC_DIR / "lr1_cell.cuh",
           build.CSRC_DIR / "ms_cell.cuh",
           build.CSRC_DIR / "torch_rounding.cuh",
           build.CSRC_DIR / "tp06_cell.cuh")


def volume_shape(model: IonicModel, depth: int):
    return (depth,) + tuple(model.state_shape())


def volume_probe_pixel(model: IonicModel, depth: int):
    """(z, row, col) of the volume's probe: the model's probe pixel on
    slice depth // 2, clamped to the true grid."""
    r, c = model.probe_pixel
    h, w = model.state_shape()
    return depth // 2, min(r, h - 1), min(c, w - 1)


def volume_probe(model: IonicModel, state: State) -> torch.Tensor:
    """The normalised potential at the volume's probe pixel (0-d)."""
    pixel = volume_probe_pixel(model, state[model.pot_key].shape[0])
    return (state[model.pot_key][pixel] - model.min_v) / (
        model.max_v - model.min_v)


def check_volume(model: IonicModel, state: State, depth: int,
                 probe: Optional[torch.Tensor],
                 probe_index: int) -> torch.device:
    """Validate the `[depth, H, W]` planes and the probe; return the
    device.  Raises on what the kernels do not take."""
    if depth < 3:
        raise ValueError(f"a volume needs depth >= 3, got {depth}")
    shape = volume_shape(model, depth)
    dev = cuda_step.check_state(model, state, shape)
    cuda_step.check_probe(probe, probe_index, dev,
                          volume_probe_pixel(model, depth), shape)
    return dev


class VolumeKernel:
    """ctypes binding of one cell body's entry `<body>_volume` of
    csrc/br_volume.cu.  The library (`library_name`: br_volume,
    court_volume for the Courtemanche bodies or lrtp_volume for Luo-Rudy's
    and tp06's) is built and loaded on the
    first launch; `launches` counts successful launches per template flag
    ("slow" = SLOW=true, "frozen" = SLOW=false, as ops/cuda_step.py's)."""

    def __init__(self, body: str):
        self.body = BODIES[body]
        self.entry = f"{body}_volume"
        self.library_name = self.body.library.name("volume")
        self._lib = None
        self.reset_launches()

    def reset_launches(self):
        self.launches = {"slow": 0, "frozen": 0}

    def build(self):
        """Build the library (if needed) and return its path."""
        lib = self.body.library
        return build.build(self.library_name, [SOURCE], HEADERS,
                           lib.defines, lib.flags)

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load(self.library_name, [SOURCE], HEADERS,
                             self.body.library.defines,
                             self.body.library.flags)
            fn = getattr(lib, self.entry)
            fn.argtypes = (
                [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # slow, params
                 ctypes.c_float]                               # dz_ratio
                + [ctypes.c_void_p] * 3              # v_in, v_out, planes
                + [ctypes.c_int] * 4                 # n_planes, depth, h, w
                + [ctypes.c_void_p,                  # probe (may be null)
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,  # probe z, r, c
                   ctypes.c_longlong,                # probe index
                   ctypes.c_int,                     # device ordinal
                   ctypes.c_void_p]                  # cudaStream_t
            )
            fn.restype = ctypes.c_int
            cuda_step.check_layout(lib, self.entry, self.body)
            self._lib = lib
        return self._lib

    def launch(self, params: np.ndarray, state: State, slow: bool,
               dz_ratio: float, probe: Optional[torch.Tensor], pixel,
               probe_index: int, stream: int):
        """One substep on CUDA tensors already validated by the caller."""
        fn = getattr(self.library(), self.entry)
        pot = self.body.model.pot_key
        v_in = state[pot]
        writes = self.body.writes_potential(slow)
        v_out = torch.empty_like(v_in) if writes else None
        d, h, w = v_in.shape
        err = fn(
            int(slow), params.ctypes.data, params.size, dz_ratio,
            v_in.data_ptr(), v_out.data_ptr() if writes else None,
            cuda_step.plane_pointers(state, self.body.planes),
            len(self.body.planes), d, h, w,
            probe.data_ptr() if probe is not None else None,
            *pixel, probe_index, v_in.device.index, stream,
        )
        if err != 0:
            raise RuntimeError(
                f"{self.entry} launch failed with CUDA error {err} "
                f"({d}x{h}x{w}, slow={slow})")
        self.launches["slow" if slow else "frozen"] += 1
        if writes:
            state[pot] = v_out


# the process-wide bindings, one per cell body: the built library is
# process-wide too.  KERNEL is Beeler-Reuter's.
KERNELS = {name: VolumeKernel(name) for name in cuda_step.hosted(4)}
KERNEL = KERNELS["br"]


def plain_volume_substep(model: IonicModel, state: State, slow: bool,
                         probe: Optional[torch.Tensor] = None,
                         probe_index: int = 0,
                         dz_ratio: float = 1.0) -> State:
    """Plain PyTorch version of one kernel launch: `solve_substep` on
    `volume_geometry(dz_ratio=dz_ratio)`, written back into `state` under
    the kernel's contract."""
    cuda_step.write_back(state, cuda_step.solve_substep(
        model, state, volume_geometry(dz_ratio=dz_ratio), slow),
        model.pot_key)
    if probe is not None:
        probe[probe_index] = volume_probe(model, state)
    return state


def plain_volume_step(model: IonicModel, state: State,
                      probe: Optional[torch.Tensor] = None,
                      probe_index: int = 0,
                      dz_ratio: float = 1.0) -> State:
    """Plain version of one outer step of a volume (`dt_per_step`
    `plain_volume_substep`s; the probe is taken after the last)."""
    for slow in cuda_step.slow_schedule(model):
        plain_volume_substep(model, state, slow, dz_ratio=dz_ratio)
    if probe is not None:
        probe[probe_index] = volume_probe(model, state)
    return state


def volume_substep(model: IonicModel, state: State, slow: bool,
                   probe: Optional[torch.Tensor] = None,
                   probe_index: int = 0, dz_ratio: float = 1.0) -> State:
    """One substep of a volume: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    body = cuda_step.body_on(model, 4)
    pot = state[model.pot_key]
    if pot.dim() != 3:
        raise ValueError(f"{model.pot_key} has shape {tuple(pot.shape)}, "
                         f"not [D, H, W]")
    depth = pot.shape[0]
    dev = check_volume(model, state, depth, probe, probe_index)
    if dev.type == "cpu":
        return plain_volume_substep(model, state, slow, probe, probe_index,
                                    dz_ratio)
    KERNELS[body.name].launch(
        cuda_step.pack_params(model), state, slow, dz_ratio, probe,
        volume_probe_pixel(model, depth), probe_index,
        torch.cuda.current_stream(dev).cuda_stream)
    return state


def make_volume_step(model: IonicModel, depth: int,
                     dz_ratio: float = 1.0):
    """Build `step(state, probe=None, probe_index=0) -> state`, one outer
    step of a `[depth, H, W]` volume, one launch per substep (BR: one
    slow launch and four frozen ones under skip, five slow launches
    without; Fenton, Mitchell-Schaeffer and Courtemanche-ultra: ten;
    Courtemanche: eleven, as ops/cuda_step.make_cuda_step).  The last
    launch writes the probe.  CPU states take `plain_volume_step`."""
    kernel = KERNELS[cuda_step.body_on(model, 4).name]
    params = cuda_step.pack_params(model)
    schedule = cuda_step.slow_schedule(model)
    last = len(schedule) - 1
    pixel = volume_probe_pixel(model, depth)

    def step(state: State, probe: Optional[torch.Tensor] = None,
             probe_index: int = 0) -> State:
        dev = check_volume(model, state, depth, probe, probe_index)
        if dev.type == "cpu":
            return plain_volume_step(model, state, probe, probe_index,
                                     dz_ratio)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, slow in enumerate(schedule):
            kernel.launch(params, state, slow, dz_ratio,
                          probe if i == last else None, pixel, probe_index,
                          stream)
        return state

    return step
