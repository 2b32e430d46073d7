"""The volume substep kernel's wrappers and its plain version.

Counterpart of fib_tf_tpu/ops/pallas_volume.py::make_pallas_volume_step,
the kernel run_volume runs for a volume whose state fits the 32 MB
whole-volume envelope: one outer step of a `[D, H, W]` volume, here as one
launch per substep, with the two forms of each Beeler-Reuter body (the n=5
substep that advances the slow gates, the n=0 substep that freezes them)
and the one form of the Fenton and Mitchell-Schaeffer bodies (ten launches
per outer step).
The kernel is csrc/br_volume.cu (CUDA C++, built with nvcc and bound with
ctypes; one entry per cell body of ops/bodies.BODIES); its source note
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

from typing import Optional

import numpy as np
import torch

from fib_tf_tpu_torch import tracing
from fib_tf_tpu_torch.kernels import binding, build
from fib_tf_tpu_torch.models.base import IonicModel, volume_geometry
from fib_tf_tpu_torch.ops import bodies
from fib_tf_tpu_torch.ops.bodies import BODIES, State, plane_pointers

SOURCE = build.CSRC_DIR / "br_volume.cu"


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
    dev = bodies.check_state(model, state, shape)
    bodies.check_probe(probe, probe_index, dev,
                       volume_probe_pixel(model, depth), shape)
    return dev


class VolumeKernel(binding.Binding):
    """ctypes binding of one cell body's entry `<body>_volume` of
    csrc/br_volume.cu, in the library of the body's `CellBody.library`
    (`library_name`: br_volume, court_volume for the Courtemanche bodies or
    lrtp_volume for Luo-Rudy's and tp06's); `launches` counts successful
    launches per template flag ("slow" = SLOW=true, "frozen" = SLOW=false,
    as ops/cuda_step.py's)."""

    ARGS = ("slow:i params:p n_params:i dz_ratio:f v_in:p v_out:p planes:p "
            "n_planes:i depth:i height:i width:i")
    PROBE = binding.PROBE_3D
    PER_FORM = True

    def __init__(self, body: str):
        b = BODIES[body]
        super().__init__(f"{body}_volume", SOURCE, b.library.name("volume"),
                         b, False, b.library.defines, b.library.flags)

    def launch(self, params: np.ndarray, state: State, slow: bool,
               dz_ratio: float, probe: Optional[torch.Tensor], pixel,
               probe_index: int, stream: int):
        """One substep on CUDA tensors already validated by the caller."""
        with tracing.span(self.span_name):
            pot = self.body.model.pot_key
            v_in = state[pot]
            writes = self.body.writes_potential(slow)
            v_out = torch.empty_like(v_in) if writes else None
            d, h, w = v_in.shape
            self.call(
                int(slow), params.ctypes.data, params.size, dz_ratio,
                v_in.data_ptr(), v_out.data_ptr() if writes else None,
                plane_pointers(state, self.body.planes),
                len(self.body.planes), d, h, w,
                probe.data_ptr() if probe is not None else None,
                *pixel, probe_index, v_in.device.index, stream, slow=slow)
            if writes:
                state[pot] = v_out


# the process-wide bindings, one per cell body: the built library is
# process-wide too.  KERNEL is Beeler-Reuter's.
KERNELS = {name: VolumeKernel(name) for name in bodies.hosted(4)}
KERNEL = KERNELS["br"]


def plain_volume_substep(model: IonicModel, state: State, slow: bool,
                         probe: Optional[torch.Tensor] = None,
                         probe_index: int = 0,
                         dz_ratio: float = 1.0) -> State:
    """Plain PyTorch version of one kernel launch: the model's `commit` on
    `volume_geometry(dz_ratio=dz_ratio)`, written back into `state` under
    the kernel's contract."""
    bodies.write_back(state, model.commit(
        state, volume_geometry(dz_ratio=dz_ratio), slow), model.pot_key)
    if probe is not None:
        probe[probe_index] = volume_probe(model, state)
    return state


def plain_volume_step(model: IonicModel, state: State,
                      probe: Optional[torch.Tensor] = None,
                      probe_index: int = 0,
                      dz_ratio: float = 1.0) -> State:
    """Plain version of one outer step of a volume (a
    `plain_volume_substep` per launch of the model's `launch_schedule`;
    the probe is taken after the last)."""
    for slow in model.launch_schedule:
        plain_volume_substep(model, state, slow, dz_ratio=dz_ratio)
    if probe is not None:
        probe[probe_index] = volume_probe(model, state)
    return state


def volume_substep(model: IonicModel, state: State, slow: bool,
                   probe: Optional[torch.Tensor] = None,
                   probe_index: int = 0, dz_ratio: float = 1.0) -> State:
    """One substep of a volume: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    body = bodies.body_on(model, 4)
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
        bodies.pack_params(model), state, slow, dz_ratio, probe,
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
    kernel = KERNELS[bodies.body_on(model, 4).name]
    params = bodies.pack_params(model)
    schedule = model.launch_schedule
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
