"""The Beeler-Reuter substep kernel's wrapper and its plain version.

Counterpart of fib_tf_tpu/ops/pallas_step.py::make_pallas_step as the JAX
engine runs it for Beeler-Reuter cheby+skip: one launch per substep, two
bodies (the n=5 substep that advances the slow gates, and the n=0 substep
that freezes them).  The kernel is csrc/br_substep.cu (CUDA C++, built with
nvcc and bound with ctypes); its source note says what bounds it and what
the simple design leaves for later.

Routing is by the device of the state's tensors: CPU tensors take the plain
PyTorch version (built from the ported stencil, Chebyshev fits and
`BeelerReuter.solve`); CUDA tensors launch the kernel, and a launch that
fails raises.  Nothing falls back from the card to the plain version.

State update contract (both versions): the state dict is updated IN PLACE
and returned.  "V" is replaced by a new tensor (the kernel double-buffers
V); the other seven planes keep their tensors and are overwritten.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from fib_tf_tpu_torch.kernels import build
from fib_tf_tpu_torch.models.base import grid_geometry
from fib_tf_tpu_torch.models.beeler_reuter import (
    G_NA,
    G_NAC,
    G_S,
    BeelerReuter,
)

State = Dict[str, torch.Tensor]

SOURCE = build.CSRC_DIR / "br_substep.cu"
HEADERS = (build.CSRC_DIR / "br_cell.cuh",)
# BrParams::coef order in br_cell.cuh
FIT_ORDER = (
    "x1_inf", "x1_rl", "m_inf", "m_rl", "h_inf", "h_rl", "j_inf", "j_rl",
    "d_inf", "d_rl", "f_inf", "f_rl", "i_k1", "i_x1f",
)
# the per-cell planes, in the kernels' order (BeelerReuterCell::Plane)
CELL_PLANES = ("C", "m", "h", "j", "d", "f", "x1")
# 14 fits of 9 coefficients, then 11 scalars (pack_params)
PARAM_FLOATS = len(FIT_ORDER) * 9 + 11


def pack_params(model: BeelerReuter) -> np.ndarray:
    """The kernel's BrParams as a float32 array: the 14 fits, then the
    conductances with their g_scale factors folded in (in double, as the
    plain path's Python constants are), dt, diff*dt, the Chebyshev domain
    and the probe normalisation."""
    cfg = model.cfg
    coef = np.stack([np.asarray(model.cheby_coef[k], np.float32)
                     for k in FIT_ORDER])
    scalars = np.array([
        model.gscale("g_Na", G_NA),
        model.gscale("g_NaC", G_NAC),
        model.gscale("g_s", G_S),
        model.scales.get("g_K1", 1.0),
        model.scales.get("g_x1", 1.0),
        cfg.dt,
        cfg.diff * cfg.dt,
        0.5 * (model.max_v + model.min_v),
        0.5 * (model.max_v - model.min_v),
        model.min_v,
        model.max_v - model.min_v,
    ], np.float32)
    return np.ascontiguousarray(np.concatenate([coef.ravel(), scalars]))


class BrSubstepKernel:
    """ctypes binding of csrc/br_substep.cu.  The library is built and
    loaded on the first launch; `launches` counts successful launches per
    body ("slow" = SLOW=true, "frozen" = SLOW=false)."""

    def __init__(self):
        self._lib = None
        self.reset_launches()

    def reset_launches(self):
        self.launches = {"slow": 0, "frozen": 0}

    def build(self):
        """Build the library (if needed) and return its path."""
        return build.build("br_substep", [SOURCE], HEADERS)

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load("br_substep", [SOURCE], HEADERS)
            lib.br_param_floats.argtypes = []
            lib.br_param_floats.restype = ctypes.c_int
            lib.br_substep.argtypes = (
                [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                + [ctypes.c_void_p] * 9              # v_in, v_out, 7 planes
                + [ctypes.c_int, ctypes.c_int,       # height, width
                   ctypes.c_void_p,                  # probe (may be null)
                   ctypes.c_int, ctypes.c_int,       # probe row, col
                   ctypes.c_longlong,                # probe index
                   ctypes.c_int,                     # device ordinal
                   ctypes.c_void_p]                  # cudaStream_t
            )
            lib.br_substep.restype = ctypes.c_int
            if lib.br_param_floats() != PARAM_FLOATS:
                raise RuntimeError(
                    f"br_substep.cu takes {lib.br_param_floats()} parameter "
                    f"floats, pack_params packs {PARAM_FLOATS}")
            self._lib = lib
        return self._lib

    def launch(self, params: np.ndarray, state: State, slow: bool,
               probe: Optional[torch.Tensor], probe_pixel, probe_index: int,
               stream: int):
        """One substep on CUDA tensors already validated by the caller."""
        lib = self.library()
        v_in = state["V"]
        v_out = torch.empty_like(v_in)
        h, w = v_in.shape
        err = lib.br_substep(
            int(slow), params.ctypes.data, params.size,
            v_in.data_ptr(), v_out.data_ptr(),
            *[state[k].data_ptr() for k in CELL_PLANES],
            h, w,
            probe.data_ptr() if probe is not None else None,
            probe_pixel[0], probe_pixel[1], probe_index,
            v_in.device.index, stream,
        )
        if err != 0:
            raise RuntimeError(
                f"br_substep launch failed with CUDA error {err} "
                f"({h}x{w}, slow={slow})"
            )
        self.launches["slow" if slow else "frozen"] += 1
        state["V"] = v_out


# the process-wide binding: the built library is process-wide too
KERNEL = BrSubstepKernel()


def check_state(model: BeelerReuter, state: State,
                shape=None) -> torch.device:
    """Validate the planes a substep reads and writes; return their
    device.  Raises on a missing plane or on any other device, dtype,
    shape (`shape`, default the model's [H, W]) or memory layout than the
    kernel takes."""
    shape = model.state_shape() if shape is None else tuple(shape)
    keys = model.state_keys()
    missing = [k for k in keys if k not in state]
    if missing:
        raise ValueError(f"state is missing planes {missing}")
    dev = state["V"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for k in keys:
        t = state[k]
        if t.device != dev:
            raise ValueError(f"plane {k!r} is on {t.device}, V on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"plane {k!r} is {t.dtype}, not float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"plane {k!r} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"plane {k!r} is not contiguous")
    if dev.type == "cuda":
        ptrs = {state[k].data_ptr() for k in keys}
        if len(ptrs) != len(keys):
            raise ValueError("state planes must not share memory")
    return dev


def check_probe(probe: Optional[torch.Tensor], probe_index: int,
                dev: torch.device, pixel, shape):
    """Validate a probe buffer and index, and that `pixel` lies in
    `shape`."""
    if probe is None:
        return
    if (probe.device != dev or probe.dtype != torch.float32
            or probe.dim() != 1 or not probe.is_contiguous()):
        raise ValueError("probe must be a contiguous 1-D float32 tensor on "
                         f"{dev}")
    if not 0 <= probe_index < probe.numel():
        raise IndexError(f"probe_index {probe_index} outside "
                         f"[0, {probe.numel()})")
    if not all(0 <= p < n for p, n in zip(pixel, shape)):
        raise ValueError(f"probe pixel {tuple(pixel)} outside the "
                         f"{'x'.join(map(str, shape))} grid")


def _check_probe(model: BeelerReuter, probe: Optional[torch.Tensor],
                 probe_index: int, dev: torch.device):
    check_probe(probe, probe_index, dev, model.probe_pixel,
                model.state_shape())


def write_back(state: State, new: State) -> State:
    """Write `model.solve`'s result into `state` under the kernels'
    contract: V is replaced, the other planes are overwritten in place."""
    for k, t in new.items():
        if k == "V":
            state["V"] = t
        elif t is not state[k]:
            state[k].copy_(t)
    return state


def plain_substep(model: BeelerReuter, state: State, slow: bool,
                  probe: Optional[torch.Tensor] = None,
                  probe_index: int = 0) -> State:
    """Plain PyTorch version of one kernel launch: `model.solve` with
    n = model.slow_n when `slow`, else n = 0, written back into `state`
    under the kernel's contract."""
    write_back(state, model.solve(state, grid_geometry(),
                                  n=model.slow_n if slow else 0))
    if probe is not None:
        probe[probe_index] = model.probe(state)
    return state


def substep(model: BeelerReuter, state: State, slow: bool,
            probe: Optional[torch.Tensor] = None,
            probe_index: int = 0) -> State:
    """One Beeler-Reuter substep: the kernel on CUDA tensors, the plain
    version on CPU tensors.  `slow` advances the slow gates (the n=5
    substep under skip).  With `probe`, writes the normalized new V at
    `model.probe_pixel` to `probe[probe_index]`."""
    dev = check_state(model, state)
    _check_probe(model, probe, probe_index, dev)
    if dev.type == "cpu":
        return plain_substep(model, state, slow, probe, probe_index)
    KERNEL.launch(pack_params(model), state, slow, probe, model.probe_pixel,
                  probe_index, torch.cuda.current_stream(dev).cuda_stream)
    return state


def slow_schedule(model: BeelerReuter):
    """`slow` flag of each substep of an outer step: one slow substep and
    four frozen ones under skip, five slow ones without."""
    _, labels = model.substep_fns(grid_geometry())
    return tuple(label != "n0" for label in labels)


def plain_step(model: BeelerReuter, state: State,
               probe: Optional[torch.Tensor] = None,
               probe_index: int = 0) -> State:
    """Plain version of one outer step (five `plain_substep`s; the probe
    is taken after the last)."""
    for slow in slow_schedule(model):
        plain_substep(model, state, slow)
    if probe is not None:
        probe[probe_index] = model.probe(state)
    return state


def make_cuda_step(model: BeelerReuter):
    """Build `step(state, probe=None, probe_index=0) -> state`, one outer
    step: one slow launch and four frozen ones under skip, five slow
    launches without.  The last launch writes the probe.  CPU states take
    `plain_step`."""
    if not isinstance(model, BeelerReuter):
        raise NotImplementedError(
            f"no CUDA kernel for model {model.name!r} yet (ROADMAP Queue 1)")
    params = pack_params(model)
    schedule = slow_schedule(model)
    last = len(schedule) - 1

    def step(state: State, probe: Optional[torch.Tensor] = None,
             probe_index: int = 0) -> State:
        dev = check_state(model, state)
        _check_probe(model, probe, probe_index, dev)
        if dev.type == "cpu":
            return plain_step(model, state, probe, probe_index)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, slow in enumerate(schedule):
            KERNEL.launch(params, state, slow,
                          probe if i == last else None, model.probe_pixel,
                          probe_index, stream)
        return state

    return step
