"""The Beeler-Reuter volume substep kernel's wrapper and its plain version.

Counterpart of fib_tf_tpu/ops/pallas_volume.py::make_pallas_volume_step,
the kernel run_volume runs for a volume whose state fits the 32 MB
whole-volume envelope: one outer step of a `[D, H, W]` volume, here as one
launch per substep with the two Beeler-Reuter bodies (the n=5 substep that
advances the slow gates, the n=0 substep that freezes them).  The kernel is
csrc/br_volume.cu (CUDA C++, built with nvcc and bound with ctypes); its
source note says what bounds it.

Routing is by the device of the state's tensors, as in ops/cuda_step.py:
CPU tensors take the plain version (`model.solve` on `volume_geometry`),
CUDA tensors launch the kernel, and a launch that fails raises.  Nothing
falls back from the card to the plain version.

State update contract (both versions, as ops/cuda_step.py): the state dict
is updated IN PLACE and returned.  "V" is replaced by a new tensor; the
other seven planes keep their tensors and are overwritten.

The probe of a volume is the normalised V at `volume_probe_pixel`: the
model's probe pixel on the mid-depth slice, clamped to the grid
(fib_tf_tpu/engine/volume.py:488-498).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from fib_tf_tpu_torch.kernels import build
from fib_tf_tpu_torch.models.base import volume_geometry
from fib_tf_tpu_torch.models.beeler_reuter import BeelerReuter
from fib_tf_tpu_torch.ops import cuda_step
from fib_tf_tpu_torch.ops.cuda_step import CELL_PLANES, PARAM_FLOATS, State

SOURCE = build.CSRC_DIR / "br_volume.cu"
HEADERS = (build.CSRC_DIR / "br_cell.cuh",
           build.CSRC_DIR / "br_volume_cell.cuh")


def volume_shape(model: BeelerReuter, depth: int):
    return (depth,) + tuple(model.state_shape())


def volume_probe_pixel(model: BeelerReuter, depth: int):
    """(z, row, col) of the volume's probe: the model's probe pixel on
    slice depth // 2, clamped to the true grid."""
    r, c = model.probe_pixel
    h, w = model.state_shape()
    return depth // 2, min(r, h - 1), min(c, w - 1)


def volume_probe(model: BeelerReuter, state: State) -> torch.Tensor:
    """The normalised potential at the volume's probe pixel (0-d)."""
    pixel = volume_probe_pixel(model, state[model.pot_key].shape[0])
    return (state[model.pot_key][pixel] - model.min_v) / (
        model.max_v - model.min_v)


def check_volume(model: BeelerReuter, state: State, depth: int,
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
    """ctypes binding of csrc/br_volume.cu.  The library is built and
    loaded on the first launch; `launches` counts successful launches per
    body ("slow" = SLOW=true, "frozen" = SLOW=false)."""

    def __init__(self):
        self._lib = None
        self.reset_launches()

    def reset_launches(self):
        self.launches = {"slow": 0, "frozen": 0}

    def build(self):
        """Build the library (if needed) and return its path."""
        return build.build("br_volume", [SOURCE], HEADERS)

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load("br_volume", [SOURCE], HEADERS)
            lib.br_volume_param_floats.argtypes = []
            lib.br_volume_param_floats.restype = ctypes.c_int
            lib.br_volume.argtypes = (
                [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # slow, params
                 ctypes.c_float]                               # dz_ratio
                + [ctypes.c_void_p] * 9              # v_in, v_out, 7 planes
                + [ctypes.c_int] * 3                 # depth, height, width
                + [ctypes.c_void_p,                  # probe (may be null)
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,  # probe z, r, c
                   ctypes.c_longlong,                # probe index
                   ctypes.c_int,                     # device ordinal
                   ctypes.c_void_p]                  # cudaStream_t
            )
            lib.br_volume.restype = ctypes.c_int
            if lib.br_volume_param_floats() != PARAM_FLOATS:
                raise RuntimeError(
                    f"br_volume.cu takes {lib.br_volume_param_floats()} "
                    f"parameter floats, pack_params packs {PARAM_FLOATS}")
            self._lib = lib
        return self._lib

    def launch(self, params: np.ndarray, state: State, slow: bool,
               dz_ratio: float, probe: Optional[torch.Tensor], pixel,
               probe_index: int, stream: int):
        """One substep on CUDA tensors already validated by the caller."""
        lib = self.library()
        v_in = state["V"]
        v_out = torch.empty_like(v_in)
        d, h, w = v_in.shape
        err = lib.br_volume(
            int(slow), params.ctypes.data, params.size, dz_ratio,
            v_in.data_ptr(), v_out.data_ptr(),
            *[state[k].data_ptr() for k in CELL_PLANES],
            d, h, w,
            probe.data_ptr() if probe is not None else None,
            *pixel, probe_index, v_in.device.index, stream,
        )
        if err != 0:
            raise RuntimeError(
                f"br_volume launch failed with CUDA error {err} "
                f"({d}x{h}x{w}, slow={slow})")
        self.launches["slow" if slow else "frozen"] += 1
        state["V"] = v_out


# the process-wide binding: the built library is process-wide too
KERNEL = VolumeKernel()


def plain_volume_substep(model: BeelerReuter, state: State, slow: bool,
                         probe: Optional[torch.Tensor] = None,
                         probe_index: int = 0,
                         dz_ratio: float = 1.0) -> State:
    """Plain PyTorch version of one kernel launch: `model.solve` on
    `volume_geometry(dz_ratio=dz_ratio)` with n = model.slow_n when
    `slow`, else n = 0, written back into `state` under the kernel's
    contract."""
    cuda_step.write_back(state, model.solve(
        state, volume_geometry(dz_ratio=dz_ratio),
        n=model.slow_n if slow else 0))
    if probe is not None:
        probe[probe_index] = volume_probe(model, state)
    return state


def plain_volume_step(model: BeelerReuter, state: State,
                      probe: Optional[torch.Tensor] = None,
                      probe_index: int = 0,
                      dz_ratio: float = 1.0) -> State:
    """Plain version of one outer step of a volume (five
    `plain_volume_substep`s; the probe is taken after the last)."""
    for slow in cuda_step.slow_schedule(model):
        plain_volume_substep(model, state, slow, dz_ratio=dz_ratio)
    if probe is not None:
        probe[probe_index] = volume_probe(model, state)
    return state


def volume_substep(model: BeelerReuter, state: State, slow: bool,
                   probe: Optional[torch.Tensor] = None,
                   probe_index: int = 0, dz_ratio: float = 1.0) -> State:
    """One substep of a volume: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if state["V"].dim() != 3:
        raise ValueError(f"V has shape {tuple(state['V'].shape)}, not "
                         f"[D, H, W]")
    depth = state["V"].shape[0]
    dev = check_volume(model, state, depth, probe, probe_index)
    if dev.type == "cpu":
        return plain_volume_substep(model, state, slow, probe, probe_index,
                                    dz_ratio)
    KERNEL.launch(cuda_step.pack_params(model), state, slow, dz_ratio, probe,
                  volume_probe_pixel(model, depth), probe_index,
                  torch.cuda.current_stream(dev).cuda_stream)
    return state


def make_volume_step(model: BeelerReuter, depth: int,
                     dz_ratio: float = 1.0):
    """Build `step(state, probe=None, probe_index=0) -> state`, one outer
    step of a `[depth, H, W]` volume: one slow launch and four frozen
    ones under skip, five slow launches without.  The last launch writes
    the probe.  CPU states take `plain_volume_step`."""
    if not isinstance(model, BeelerReuter):
        raise NotImplementedError(
            f"no CUDA kernel for model {model.name!r} yet (ROADMAP Queue 1)")
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
            KERNEL.launch(params, state, slow, dz_ratio,
                          probe if i == last else None, pixel, probe_index,
                          stream)
        return state

    return step
