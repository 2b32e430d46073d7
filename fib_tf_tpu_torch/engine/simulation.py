"""The simulation driver (main-path subset of
fib_tf_tpu/engine/simulation.py).

`simulate()` cuts the run into chunks at pacing events (and at
`max_chunk_steps`), exactly where the JAX engine does.  A chunk is a Python
loop over outer steps that only enqueues work on the device; the last
kernel launch of each outer step writes the step's "v" probe into a device
buffer.  At the end of a chunk one device-to-host copy brings back the
probe buffer and the finiteness flag of V; the cycle-length detector
consumes the probes.

Kernel routing (`route`, as the JAX engine's `_use_pallas` / `_step_fn`
route): 'xla' runs the plain PyTorch path anywhere; 'auto' and 'pallas' run
a CUDA kernel on a CUDA device, the substep kernel (five launches per outer
step) while the state fits WHOLE_GRID_STATE_MB_MAX and the tiled kernel
(one launch per outer step) past it; on the CPU 'auto' runs the plain path
and 'pallas' raises.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.engine.observers import CycleLengthDetector
from fib_tf_tpu_torch.models.base import IonicModel
from fib_tf_tpu_torch.ops import cuda_step, cuda_tiled, stencil

_GEOMETRY = "ROADMAP Queue 1 item 9"
_ENGINE = "ROADMAP Queue 1 item 14"
_PARALLEL = "ROADMAP Queue 1 item 19"


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


@dataclasses.dataclass
class SimResult:
    """Output of `Simulation.simulate` (the JAX engine's fields)."""

    state: Dict[str, np.ndarray]         # final state (host numpy)
    probes: Dict[str, np.ndarray]        # per-outer-step probe streams
    frames: Optional[np.ndarray]         # always None: frames not ported
    elapsed: float                       # wall seconds (excl. set-up)
    steps: int                           # outer steps executed
    cell_updates_per_sec: float
    sim_seconds_per_wall_second: float
    cycle_lengths: List[tuple]


class Simulation:
    """Owns a model, its pacing ops and the device, and drives the run."""

    def __init__(self, model: IonicModel, device="cuda"):
        """`device`: 'cuda' (the default), 'cpu' or a torch.device.  The
        run takes the card unless the caller asks for the CPU; 'cuda'
        without a card raises."""
        device = resolve_device(device)
        cfg: SimConfig = model.cfg
        if cfg.mesh_shape is not None:
            _not_ported("mesh sharding (SimConfig.mesh_shape)", _PARALLEL)
        if cfg.fiber_angle is not None:
            _not_ported("fiber anisotropy (SimConfig.fiber_angle)",
                        _GEOMETRY)
        if cfg.rotor_probe:
            _not_ported("the rotor probe (SimConfig.rotor_probe)", _ENGINE)
        if cfg.timeline or cfg.save_graph:
            _not_ported("timeline / save_graph export", _ENGINE)
        if model.fast_slow_ratio:
            _not_ported("fast_slow_ratio dispatch", _ENGINE)
        self.model = model
        self.cfg = cfg
        self.device = device
        # 'substep', 'tiled' or 'plain': the outer step define() builds
        self.route = route(model, device.type, cfg.kernel)
        self.cl_observer: Optional[Callable[[int, float], None]] = None
        self.state: Optional[Dict[str, np.ndarray]] = None
        self._pace_masks: Dict[str, torch.Tensor] = {}
        self._defined = False
        self._step = None

    # Whole-grid vs tiled cutover in MB of state (planes x H x W x 4): the
    # JAX engine's value (fib_tf_tpu/engine/simulation.py:507), where its
    # whole-grid kernel gives way to the tiled one.  Not retuned for the
    # card yet (PERF.md open questions).
    WHOLE_GRID_STATE_MB_MAX = 32

    def _state_mb(self) -> float:
        return state_mb(self.model)

    # -- not ported yet --------------------------------------------------------

    def add_hole_to_phase_field(self, x, y, radius, neg: bool = False):
        _not_ported("phase fields", _GEOMETRY)

    def set_diffusion_map(self, dmap):
        _not_ported("diffusion maps", _GEOMETRY)

    def add_electrode(self, x, y, radius: float = 5.0):
        _not_ported("electrogram electrodes", _ENGINE)

    def add_ecg_electrode(self, x, y, z: float = 5.0):
        _not_ported("ECG electrodes", _ENGINE)

    def run(self, im=None, keep_state: bool = False, block: bool = True):
        _not_ported("the run() generator", _ENGINE)

    def fire_op(self, name: str):
        _not_ported("fire_op (the run() generator's pacing)", _ENGINE)

    # -- definition --------------------------------------------------------------

    def define(self, s1: bool = True,
               state: Optional[Dict[str, np.ndarray]] = None):
        """Materialize the initial state (or `state`, to resume) and the
        outer-step function.  On a CUDA device this builds the kernel and
        runs one outer step and one chunk read-back on a scratch copy, so
        that `simulate()` times the steady state."""
        init = state if state is not None else self.model.initial_state(s1=s1)
        init = {k: np.asarray(v, dtype=np.float32) for k, v in init.items()}
        if set(init) != set(self.model.state_keys()):
            raise ValueError(
                f"state planes {sorted(init)} != model planes "
                f"{sorted(self.model.state_keys())}")
        self._initial = init
        if self.route == "tiled":
            self._step = cuda_tiled.make_tiled_cuda_step(self.model)
        elif self.route == "substep":
            self._step = cuda_step.make_cuda_step(self.model)
        else:
            self._step = functools.partial(cuda_step.plain_step, self.model)
        if self.device.type == "cuda":
            scratch = interop.state_from_numpy(init, self.device)
            probe = torch.empty(1, device=self.device)
            scratch = self._step(scratch, probe, 0)
            self._read_chunk(probe, scratch)
        self._defined = True
        return self

    def add_pace_op(self, name: str, loc: str, v: float):
        """Register a stimulation op (call after define)."""
        if not self._defined:
            raise AssertionError("add_pace_op must be called after define()")
        self._pace_masks[name] = torch.tensor(
            stencil.pace_mask(self.cfg.height, self.cfg.width, loc, v,
                              self.model.min_v),
            device=self.device,
        )

    def fire_on(self, state: Dict[str, torch.Tensor], name: str):
        """Apply a registered pacing op to a device state in place:
        pot <- max(pot, mask).  Returns the state."""
        key = self.model.pot_key
        state[key] = stencil.apply_pace(state[key], self._pace_masks[name])
        return state

    def millisecond_to_step(self, t_ms: float) -> int:
        return self.cfg.millisecond_to_step(t_ms, self.model.dt_per_step)

    def _read_chunk(self, probe: torch.Tensor, state) -> np.ndarray:
        """The chunk's one device-to-host copy: the probe buffer followed
        by the finiteness flag of the potential."""
        finite = torch.isfinite(state[self.model.pot_key]).all()
        return torch.cat([probe, finite.to(probe.dtype).reshape(1)]).cpu().numpy()

    # -- the scheduled run ---------------------------------------------------------

    def simulate(
        self,
        schedule: Sequence[Tuple[float, str]] = (),
        state: Optional[Dict[str, np.ndarray]] = None,
        record_frames_every_ms: Optional[float] = None,
        check_finite: bool = True,
        max_chunk_steps: Optional[int] = None,
    ) -> SimResult:
        """Run `cfg.duration` ms with pacing events at scheduled times.

        `schedule` is a list of (ms, op_name); ops fire between outer
        steps, after the step that contains `ms` (the reference's run()
        loop fires at i == step, after step + 1 outer steps)."""
        if record_frames_every_ms is not None:
            _not_ported("frame recording", _ENGINE)
        if not self._defined:
            self.define()
        model, cfg = self.model, self.cfg
        samples = cfg.samples(model.dt_per_step)
        plot_interval = cfg.plot_interval(model.dt_per_step)

        events = sorted(
            (min(self.millisecond_to_step(ms) + 1, samples), name)
            for ms, name in schedule
        )
        unknown = {name for _, name in events} - set(self._pace_masks)
        if unknown:
            raise KeyError(f"unregistered pacing ops {sorted(unknown)}")
        bounds = [0] + [e[0] for e in events] + [samples]
        if max_chunk_steps is None:
            max_chunk_steps = max(1, int((cfg.chunk_ms or cfg.duration)
                                         / (model.dt_per_step * cfg.dt)))

        if state is not None and set(state) != set(model.state_keys()):
            raise ValueError(f"state planes {sorted(state)} != model planes "
                             f"{sorted(model.state_keys())}")
        dev_state = interop.state_from_numpy(
            state if state is not None else self._initial, self.device)
        detector = CycleLengthDetector(
            cfg.dt, model.dt_per_step, plot_interval, self.cl_observer)
        cuda = self.device.type == "cuda"
        if cuda:
            if events:  # load the pacing op's kernels outside the timing
                stencil.apply_pace(dev_state[model.pot_key],
                                   self._pace_masks[events[0][1]])
            torch.cuda.synchronize(self.device)

        probes_acc: List[np.ndarray] = []
        ev_idx = 0
        step = 0
        then = time.perf_counter()
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = b - a
            while seg > 0:
                n = min(seg, max_chunk_steps)
                probe = torch.empty(n, dtype=torch.float32,
                                    device=self.device)
                for k in range(n):
                    dev_state = self._step(dev_state, probe, k)
                host = self._read_chunk(probe, dev_state)
                if check_finite and not host[-1]:
                    raise FloatingPointError(
                        f"non-finite {model.pot_key} detected at outer "
                        f"step {step + n}")
                probes_acc.append(host[:-1])
                detector.feed(step, host[:-1])
                step += n
                seg -= n
            if ev_idx < len(events) and events[ev_idx][0] == b:
                dev_state = self.fire_on(dev_state, events[ev_idx][1])
                ev_idx += 1
        if cuda:
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - then

        total_substeps = step * model.dt_per_step
        cups = cfg.height * cfg.width * total_substeps / max(elapsed, 1e-9)
        sim_s = total_substeps * cfg.dt / 1000.0
        self.state = interop.state_to_numpy(dev_state)
        probes = {"v": np.concatenate(probes_acc)} if probes_acc else {}
        return SimResult(
            state=self.state,
            probes=probes,
            frames=None,
            elapsed=elapsed,
            steps=step,
            cell_updates_per_sec=cups,
            sim_seconds_per_wall_second=sim_s / max(elapsed, 1e-9),
            cycle_lengths=detector.cycle_lengths,
        )


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: 'cuda', 'cpu' or a
    torch.device.  A CUDA device without a card raises; nothing falls
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def state_mb(model: IonicModel) -> float:
    """The model's state in MB (2**20 bytes) on its true grid."""
    h, w = model.state_shape()
    return len(model.state_keys()) * h * w * 4 / 2**20


def route(model: IonicModel, device_type: str, kernel: str) -> str:
    """The outer step a run takes: 'substep' (the CUDA substep kernel,
    five launches per outer step), 'tiled' (the CUDA tiled kernel, one
    launch) or 'plain' (PyTorch).  As the JAX engine routes
    (simulation.py:405-492, :568-617) on a CUDA device, with the state's
    MB taken on the true grid; the reference's (8, 128) alignment and tile
    divisibility conditions are Mosaic's and are not carried, since the
    CUDA kernels take any shape.  kernel='pallas' without a CUDA device
    raises."""
    if kernel == "pallas" and device_type != "cuda":
        raise ValueError(
            "kernel='pallas' runs the hand-written CUDA kernels and needs "
            "a CUDA device; use kernel='auto' or 'xla' on the CPU")
    if kernel == "xla" or device_type != "cuda":
        return "plain"
    if state_mb(model) <= Simulation.WHOLE_GRID_STATE_MB_MAX:
        return "substep"
    return "tiled"
