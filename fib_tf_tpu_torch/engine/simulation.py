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
a CUDA kernel on a CUDA device, the substep kernel (one launch per substep:
five per outer step for Beeler-Reuter, ten for Fenton, Mitchell-Schaeffer,
Courtemanche-ultra, Luo-Rudy and tp06, eleven for Courtemanche) while the
state fits
WHOLE_GRID_STATE_MB_MAX and the tiled kernel (one launch per outer step)
past it; on the CPU 'auto' runs the plain path and 'pallas' raises.
Beeler-Reuter, Fenton and Mitchell-Schaeffer have their cell bodies on both
kernels and on the block kernel, as the reference routes them
(fib_tf_tpu/engine/simulation.py:463-492, `SPMD_KERNEL_MODELS` :797-799).
Courtemanche, Courtemanche-ultra, Luo-Rudy and tp06 take the substep
kernel at every size (the reference never gives them its tiled kernel, and
past its 32 MB VMEM cap runs XLA, a cap the card's substep kernel does not
have), and on a mesh the block kernel (csrc/large_block.cu, one launch per
commit); Courtemanche with `table=True` runs the plain path ('pallas'
raises), on a mesh too.

Probes: the kernel's last launch of an outer step writes the "v" probe;
a model's `extra_probes` add their streams: Courtemanche's "trend" (V and
Na_i at one pixel) and court_ultra's "ultra" (phase-weighted means), taken
after each outer step on the device.  `probe_at_step(i,
key)` reads the chunk being consumed from inside a `cl_observer`.

Sharded runs (`Simulation(model, mesh=..., wide_halo=...)`, or
`SimConfig.mesh_shape` with `mesh_mode` 'auto' / 'spmd'): the grid is
sharded over a `parallel.Mesh` and every chunk runs through
parallel/spmd.make_spmd_chunk, with the state, the pacing masks and the
finiteness flag sharded alike, and the chunk's `trend` / `ultra` streams
read back with "v".  With `wide_halo`, 'auto' on a CUDA mesh and
'pallas' run the per-shard block kernel (csrc/br_block.cu, one launch per
shard per outer step; csrc/large_block.cu for the four large models, one
launch per commit), 'xla' the plain wide-halo step; without `wide_halo`
the per-substep exchange runs, which has no kernel.  The GSPMD modes
(`sharding=`, `mesh_mode='gspmd'`, and 'auto' when the configuration
cannot take the halo-exchange path) are not ported and raise.

Geometry (before `define()`): `add_hole_to_phase_field` builds the phase
field, `set_diffusion_map` attaches a relative diffusion map, and
`SimConfig.fiber_angle` / `fiber_ratio` the fiber tensor.  They go to every
route: the kernels' GEOM entries, the plain step's operators, and on a mesh
the shards' maps, extended once at `define()`.  They do not move the
routing: the cutover counts the model's planes only, as the reference's
`_state_mb` does.  The "v" probe samples the phase-masked image, as the
reference's does: V's probe is scaled by phase[probe_pixel].
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch import interop, tracing
from fib_tf_tpu_torch.engine.observers import CycleLengthDetector
from fib_tf_tpu_torch.models.base import IonicModel, grid_geometry
from fib_tf_tpu_torch.ops import bodies, cuda_step, cuda_tiled, stencil
from fib_tf_tpu_torch.parallel import sharding as mesh_sharding
from fib_tf_tpu_torch.parallel import spmd
from fib_tf_tpu_torch.unported import not_ported

# kernel='pallas' with Courtemanche's table mode (the reference raises the
# same on its TPU kernels, fib_tf_tpu/engine/simulation.py:435-440)
TABLE_KERNEL_MESSAGE = ("table-mode gathers don't run in the CUDA kernels; "
                        "use kernel='xla' or drop table=True")


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

    def __init__(self, model: IonicModel, device="cuda",
                 mesh: Optional[mesh_sharding.Mesh] = None,
                 wide_halo: bool = False, sharding=None):
        """`device`: 'cuda' (the default), 'cpu' or a torch.device.  The
        run takes the card unless the caller asks for the CPU; 'cuda'
        without a card raises.

        `mesh` (parallel.make_mesh) runs the explicit halo-exchange path
        on the mesh's devices and wins over `device`; `wide_halo` selects
        one K-row exchange per outer step instead of one row per substep.
        With `SimConfig.mesh_shape` and no `mesh`, the mesh is built of
        the visible cards (`device='cuda'`; fewer cards than the shape
        needs raise) or of that many CPU entries (`device='cpu'`).
        `sharding` (the reference's GSPMD mode) is not ported."""
        cfg: SimConfig = model.cfg
        if sharding is not None:
            not_ported("the GSPMD path (sharding=...)", "parallel")
        if mesh is None and cfg.mesh_shape:
            mesh, wide_halo = _config_mesh(model, device), True
        if mesh is not None:
            device = mesh.devices.flat[0]
        device = resolve_device(device)
        if cfg.rotor_probe:
            not_ported("the rotor probe (SimConfig.rotor_probe)", "engine")
        if cfg.save_graph:
            not_ported("save_graph export", "engine")
        if model.fast_slow_ratio:
            not_ported("fast_slow_ratio dispatch", "engine")
        if mesh is not None:
            _check_mesh(model, mesh, wide_halo)
        self.model = model
        # the geometry (numpy, static), set before define()
        self.phase: Optional[np.ndarray] = None
        self.dmap: Optional[np.ndarray] = None
        self.cfg = cfg
        self.device = device
        self._mesh = mesh
        self._wide_halo = wide_halo
        # 'substep', 'tiled' or 'plain': the outer step define() builds; on
        # a mesh 'block' (the per-shard block kernel) or 'plain'
        self.route = (route(model, device.type, cfg.kernel) if mesh is None
                      else spmd_route(model, device.type, cfg.kernel,
                                      wide_halo))
        self._spmd_chunks: Dict[int, Callable] = {}
        self.cl_observer: Optional[Callable[[int, float], None]] = None
        self.state: Optional[Dict[str, np.ndarray]] = None
        self._pace_masks: Dict[str, torch.Tensor] = {}
        self._defined = False
        self._step = None
        self._shard_maps: Optional[spmd.ShardMaps] = None
        # the phase field on the device (the `ultra` probe's weights)
        self._phase_t: Optional[torch.Tensor] = None
        # (first step, host probes) of the chunk simulate() is consuming
        self._probe_window: Optional[Tuple[int, Dict[str, np.ndarray]]] = None
        self._timeline_done = False

    # Whole-grid vs tiled cutover in MB of state (planes x H x W x 4): the
    # JAX engine's value (fib_tf_tpu/engine/simulation.py:507), where its
    # whole-grid kernel gives way to the tiled one.  Not retuned for the
    # card yet (PERF.md open questions).
    WHOLE_GRID_STATE_MB_MAX = 32

    def _state_mb(self) -> float:
        return state_mb(self.model)

    # -- geometry construction (before define) ----------------------------------

    def add_hole_to_phase_field(self, x, y, radius, neg: bool = False):
        """Multiply a circular hole (or, with `neg`, everything outside a
        disk) into the phase field (must precede `define`)."""
        if self._defined:
            raise AssertionError(
                "add_hole_to_phase_field must be called before define()")
        self.phase = stencil.add_hole_to_phase_field(
            self.phase, self.cfg.height, self.cfg.width, x, y, radius, neg)

    def set_diffusion_map(self, dmap):
        """Attach a per-pixel RELATIVE diffusion map (1 = the nominal
        `cfg.diff`; stencil.fibrosis_map builds patchy fibrosis).  Must
        precede `define`."""
        if self._defined:
            raise AssertionError(
                "set_diffusion_map must be called before define()")
        dmap = np.asarray(dmap, np.float32)
        if dmap.shape != (self.cfg.height, self.cfg.width):
            raise ValueError(
                f"diffusion map shape {dmap.shape} != grid "
                f"{(self.cfg.height, self.cfg.width)}")
        if not np.isfinite(dmap).all() or (dmap < 0).any():
            raise ValueError("diffusion map must be finite and >= 0")
        self.dmap = dmap

    def _fiber(self):
        """(dxx, dxy, dyy) when anisotropic, else None."""
        if self.cfg.fiber_angle is not None and self.cfg.fiber_ratio != 1.0:
            return stencil.fiber_tensor(self.cfg.fiber_angle,
                                        self.cfg.fiber_ratio)
        return None

    def _probe_scale(self) -> float:
        """The phase field at the probe pixel (1 without one): the
        reference samples the phase-masked image."""
        if self.phase is None:
            return 1.0
        r, c = self.model.probe_pixel
        return float(self.phase[r, c])

    # -- not ported yet --------------------------------------------------------

    def add_electrode(self, x, y, radius: float = 5.0):
        not_ported("electrogram electrodes", "engine")

    def add_ecg_electrode(self, x, y, z: float = 5.0):
        not_ported("ECG electrodes", "engine")

    def run(self, im=None, keep_state: bool = False, block: bool = True):
        not_ported("the run() generator", "engine")

    def fire_op(self, name: str):
        not_ported("fire_op (the run() generator's pacing)", "engine")

    # -- definition --------------------------------------------------------------

    def define(self, s1: bool = True,
               state: Optional[Dict[str, np.ndarray]] = None):
        """Materialize the initial state (or `state`, to resume) and the
        outer-step function.  A resumed state is reconciled across the
        ab2 flag (`reconcile_state`).  On a CUDA device this builds the
        kernel and runs one outer step and one chunk read-back on a
        scratch copy, so that `simulate()` times the steady state."""
        init = state if state is not None else self.model.initial_state(s1=s1)
        init = {k: np.asarray(v, dtype=np.float32) for k, v in init.items()}
        if state is not None:
            init = reconcile_state(self.model, init)
        if set(init) != set(self.model.state_keys()):
            raise ValueError(
                f"state planes {sorted(init)} != model planes "
                f"{sorted(self.model.state_keys())}")
        self._initial = init
        fiber = self._fiber()
        if self._mesh is not None:
            self._shard_maps = spmd.shard_maps(
                self.model, self._mesh, self.phase, self.dmap,
                self._wide_halo)
            if self.device.type == "cuda":
                self._run_chunk(self._to_device(init), 1)
            self._defined = True
            return self
        # the steps' geometry arguments, given only when set
        geometry = {k: v for k, v in dict(phase=self.phase, fiber=fiber,
                                          dmap=self.dmap).items()
                    if v is not None}
        if self.phase is not None:
            self._phase_t = torch.tensor(self.phase, device=self.device)
        if self.route == "tiled":
            self._step = cuda_tiled.make_tiled_cuda_step(self.model,
                                                         **geometry)
        elif self.route == "substep":
            self._step = cuda_step.make_cuda_step(self.model, **geometry)
        else:
            self._step = functools.partial(
                cuda_step.plain_step, self.model,
                geom=grid_geometry(self.phase, self.cfg.fiber_angle,
                                   self.cfg.fiber_ratio, self.dmap,
                                   self.device))
        if self.device.type == "cuda":
            self._run_chunk(interop.state_from_numpy(init, self.device), 1)
        self._defined = True
        return self

    def add_pace_op(self, name: str, loc: str, v: float):
        """Register a stimulation op (call after define)."""
        if not self._defined:
            raise AssertionError("add_pace_op must be called after define()")
        mask = stencil.pace_mask(self.cfg.height, self.cfg.width, loc, v,
                                 self.model.min_v)
        self._pace_masks[name] = (
            torch.tensor(mask, device=self.device) if self._mesh is None
            else mesh_sharding.shard_array(mask, self._mesh))

    def fire_on(self, state, name: str):
        """Apply a registered pacing op to a device state in place:
        pot <- max(pot, mask), shard by shard on a mesh (the mask is
        sharded with the state).  With ab2 the derivative planes are
        refreshed at the paced pixels (`pace`).  Returns the state."""
        with tracing.span("fibtorch.event"):
            mask = self._pace_masks[name]
            if self._mesh is None:
                state.update(pace(self.model, state, mask))
                return state
            keys = list(state)
            planes = {k: state[k].copy() for k in keys}
            for i in range(mask.size):
                new = pace(self.model, {k: planes[k].flat[i] for k in keys},
                           mask.flat[i])
                for k, t in new.items():
                    planes[k].flat[i] = t
            state.update(planes)
            return state

    def millisecond_to_step(self, t_ms: float) -> int:
        return self.cfg.millisecond_to_step(t_ms, self.model.dt_per_step)

    def _extra_probes(self, state) -> Dict[str, torch.Tensor]:
        """The probe streams beside "v" of one outer step, as the
        reference's `_probes`: the model's `extra_probes` (Courtemanche's
        `trend`, court_ultra's phase-weighted `ultra` means)."""
        return self.model.extra_probes(state, self._phase_t)

    def _read_chunk(self, probe: torch.Tensor, state,
                    extra: Optional[Dict[str, torch.Tensor]] = None):
        """The chunk's one device-to-host copy: the probe buffer, the
        `extra` probe streams (`[n, ...]` buffers) and the finiteness flag
        of the potential (on a mesh, the AND of the shards' own cells,
        gathered on the probe's device).  Returns ({stream: host array},
        finite)."""
        with tracing.span("fibtorch.readback"):
            pot = state[self.model.pot_key]
            if self._mesh is None:
                finite = torch.isfinite(pot).all()
            else:
                finite = torch.stack([torch.isfinite(t).all().to(probe.device)
                                      for t in pot.flat]).all()
            extra = extra or {}
            flat = torch.cat([probe] + [t.reshape(-1) for t in extra.values()]
                             + [finite.to(probe.dtype).reshape(1)]
                             ).cpu().numpy()
        out, at = {"v": flat[:probe.numel()]}, probe.numel()
        for key, t in extra.items():
            out[key] = flat[at:at + t.numel()].reshape(tuple(t.shape))
            at += t.numel()
        return out, bool(flat[-1])

    def _to_device(self, state: Dict[str, np.ndarray]):
        """Host planes to the device state: tensors, or shards on a mesh."""
        if self._mesh is None:
            return interop.state_from_numpy(state, self.device)
        return interop.shard_state(state, self._mesh)

    def _run_chunk(self, state, n: int):
        """`n` outer steps and the chunk's read-back: (state, host array of
        the n probes and the finiteness flag)."""
        if self._mesh is None:
            probe = torch.empty(n, dtype=torch.float32, device=self.device)
            extra: Dict[str, torch.Tensor] = {}
            with tracing.span("fibtorch.enqueue"):
                for k in range(n):
                    state = self._step(state, probe, k)
                    for key, value in self._extra_probes(state).items():
                        if key not in extra:
                            extra[key] = value.new_empty((n,) + value.shape)
                        extra[key][k] = value
            return (state, *self._read_chunk(probe, state, extra))
        if n not in self._spmd_chunks:
            self._spmd_chunks[n] = spmd.make_spmd_chunk(
                self.model, self._mesh, n, wide_halo=self._wide_halo,
                use_kernel=self.route == "block", fiber=self._fiber(),
                trend_points=getattr(self.model, "trend_points", None),
                maps=self._shard_maps)
        with tracing.span("fibtorch.enqueue"):
            state, probes = self._spmd_chunks[n](state)
        extra = {k: t for k, t in probes.items() if k != "v"}
        return (state, *self._read_chunk(probes["v"], state, extra))

    def _synchronize(self):
        devices = ([self.device] if self._mesh is None
                   else set(self._mesh.devices.flat))
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

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
        loop fires at i == step, after step + 1 outer steps).

        With `SimConfig.timeline`, the first call profiles one 1-step
        chunk from the final state after the timed run and writes its
        Chrome trace under `timeline_name` with `.json` -> `_trace`."""
        with tracing.span("fibtorch.simulate"):
            return self._simulate(schedule, state, record_frames_every_ms,
                                  check_finite, max_chunk_steps)

    def _simulate(self, schedule, state, record_frames_every_ms,
                  check_finite, max_chunk_steps) -> SimResult:
        if record_frames_every_ms is not None:
            not_ported("frame recording", "engine")
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
        with tracing.span("fibtorch.state_in"):
            dev_state = self._to_device(
                state if state is not None else self._initial)
        detector = CycleLengthDetector(
            cfg.dt, model.dt_per_step, plot_interval, self.cl_observer)
        if self.device.type == "cuda":
            if events:  # load the pacing op's kernels outside the timing
                self.fire_on(dict(dev_state), events[0][1])
            self._synchronize()

        probes_acc: Dict[str, List[np.ndarray]] = {}
        scale = np.float32(self._probe_scale())
        ev_idx = 0
        step = 0
        then = time.perf_counter()
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = b - a
            while seg > 0:
                n = min(seg, max_chunk_steps)
                dev_state, host, finite = self._run_chunk(dev_state, n)
                if check_finite and not finite:
                    raise FloatingPointError(
                        f"non-finite {model.pot_key} detected at outer "
                        f"step {step + n}")
                if scale != 1:
                    host["v"] = host["v"] * scale
                for key, value in host.items():
                    probes_acc.setdefault(key, []).append(value)
                # cl_observer callbacks read this chunk's live probes
                # (probe_at_step)
                self._probe_window = (step, host)
                detector.feed(step, host["v"])
                step += n
                seg -= n
            if ev_idx < len(events) and events[ev_idx][0] == b:
                dev_state = self.fire_on(dev_state, events[ev_idx][1])
                ev_idx += 1
        self._synchronize()
        elapsed = time.perf_counter() - then

        total_substeps = step * model.dt_per_step
        cups = cfg.height * cfg.width * total_substeps / max(elapsed, 1e-9)
        sim_s = total_substeps * cfg.dt / 1000.0
        with tracing.span("fibtorch.state_out"):
            self.state = (interop.state_to_numpy(dev_state)
                          if self._mesh is None
                          else interop.gather_state(dev_state))
        if cfg.timeline and not self._timeline_done:
            self._capture_timeline(dev_state)
        probes = {k: np.concatenate(v) for k, v in probes_acc.items()}
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

    def _capture_timeline(self, dev_state):
        """Profile one 1-step chunk from the final device state, after its
        copy to `self.state` (CPU activity, and CUDA on a card), and write
        its Chrome trace, as the JAX engine's `_capture_timeline` profiles
        one chunk (the reference wrote a Chrome trace of one extra
        sess.run, ionic.py:231-241)."""
        from torch.profiler import ProfilerActivity, profile

        self._timeline_done = True
        logdir = self.cfg.timeline_name.replace(".json", "_trace")
        os.makedirs(logdir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            self._run_chunk(dev_state, 1)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

    def probe_at_step(self, i: int, key: str) -> np.ndarray:
        """Probe stream `key` at outer step `i` of the chunk simulate() is
        consuming: valid inside cl_observer callbacks."""
        if self._probe_window is None:
            raise RuntimeError(
                "probe_at_step is only valid while a run is consuming "
                "probe chunks (e.g. inside a cl_observer callback)")
        start, out = self._probe_window
        n = len(out[key])
        if not 0 <= i - start < n:
            raise IndexError(f"step {i} outside the live probe window "
                             f"[{start}, {start + n})")
        return np.asarray(out[key][i - start])


def pace(model: IonicModel, state, mask: torch.Tensor):
    """The planes a pacing op replaces: pot <- max(pot, mask) and, with
    ab2, the derivative planes re-bootstrapped from the paced state at the
    paced pixels (mask > min_v) and kept elsewhere, where they carry the
    diffusion term (the reference's `_pace_fn`)."""
    key = model.pot_key
    out = {key: stencil.apply_pace(state[key], mask)}
    if model.cfg.ab2:
        paced = mask > model.min_v
        fresh = model._ab2_rates({**state, **out})
        out.update({k: torch.where(paced, v, state[k])
                    for k, v in fresh.items()})
    return out


def reconcile_state(model: IonicModel,
                    state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A resumed state fitted to the model's planes across the ab2 flag
    (fib_tf_tpu/engine/simulation.py:242-279): stale derivative planes
    (`_d*`, an ab2 run resumed into a non-ab2 model) are dropped, missing
    ones (an Euler state resumed into an ab2 model) rebuilt with
    `bootstrap_ab2`; any other unknown or missing plane raises."""
    expected = set(model.state_keys())
    stale = {k for k in state if k not in expected}
    if stale:
        if not all(k.startswith("_d") for k in stale):
            raise ValueError(f"resume state has unknown planes "
                             f"{sorted(stale)} for model {model.name!r}")
        state = {k: v for k, v in state.items() if k in expected}
    missing = expected - set(state)
    if missing:
        if not (model.cfg.ab2 and hasattr(model, "bootstrap_ab2")
                and all(k.startswith("_d") for k in missing)):
            raise ValueError(
                f"resume state is missing planes {sorted(missing)}")
        state = {k: np.asarray(v, np.float32)
                 for k, v in model.bootstrap_ab2(state).items()}
    return state


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


def _config_mesh(model: IonicModel, device) -> mesh_sharding.Mesh:
    """The mesh `SimConfig.mesh_shape` asks for, when `mesh_mode` lands on
    the halo-exchange path ('spmd', or 'auto' without a disqualifier); the
    engine then runs it with wide halos, the reference's best sharded
    configuration (fib_tf_tpu/engine/simulation.py:75-106).  The reference
    sends 'gspmd', and 'auto' with a disqualifier, to GSPMD; that mode is
    not ported, so both raise here instead of taking another path."""
    cfg = model.cfg
    if cfg.mesh_mode == "gspmd":
        not_ported("the GSPMD path (mesh_mode='gspmd')", "parallel")
    n = int(np.prod(cfg.mesh_shape))
    if torch.device(device).type == "cpu":
        mesh = mesh_sharding.make_mesh(cfg.mesh_shape, cfg.mesh_axes,
                                       devices=["cpu"] * n)
    else:
        mesh = mesh_sharding.make_mesh(cfg.mesh_shape, cfg.mesh_axes,
                                       n_devices=n)
    reason = spmd_disqualifier(model, mesh)
    if reason and cfg.mesh_mode == "spmd":
        raise ValueError(
            f"mesh_mode='spmd' cannot run this configuration: {reason}")
    if reason:
        not_ported(f"mesh_mode='auto' would fall back to the GSPMD path "
                   f"({reason}), which", "parallel")
    return mesh


def spmd_disqualifier(model: IonicModel,
                      mesh: mesh_sharding.Mesh) -> Optional[str]:
    """Why this configuration can't take the wide-halo exchange path
    (None = it can).  Single source of truth for the mesh_mode routing."""
    cfg = model.cfg
    if cfg.adaptive_dv is not None:
        return ("adaptive_dv refines substeps locally, which would read "
                "stale halos")
    if model.fast_slow_ratio:
        return ("fast_slow_ratio models scan ratio-groups outside the "
                "sharded chunk")
    n_rows, n_cols = mesh.grid
    if cfg.height % n_rows or cfg.width % n_cols:
        return (f"grid {cfg.height}x{cfg.width} is not divisible by the "
                f"{n_rows}x{n_cols} mesh (the halo exchange needs even "
                f"shards)")
    try:
        spmd.check_wide_halo_shards(cfg.height // n_rows,
                                    cfg.width // n_cols, model.dt_per_step,
                                    n_cols > 1)
    except ValueError as e:
        return str(e)
    return None


def _check_mesh(model: IonicModel, mesh: mesh_sharding.Mesh,
                wide_halo: bool):
    """The construction checks of a sharded run
    (fib_tf_tpu/engine/simulation.py:109-137)."""
    cfg = model.cfg
    if cfg.fiber_angle is not None and not wide_halo:
        raise ValueError(
            "fiber anisotropy on the halo-exchange (mesh=...) path requires "
            "wide_halo=True (the per-substep halo geometries are "
            "isotropic)")
    if cfg.kernel == "pallas" and not wide_halo:
        raise ValueError(
            "kernel='pallas' on the halo-exchange (mesh=...) path requires "
            "wide_halo=True: the per-substep exchange path has no fused "
            "block to hand the kernel")
    n_rows, n_cols = mesh.grid
    if cfg.height % n_rows or cfg.width % n_cols:
        raise ValueError(
            f"grid {cfg.height}x{cfg.width} is not divisible by the "
            f"{n_rows}x{n_cols} mesh (the halo exchange needs even shards)")
    if wide_halo:
        spmd.check_wide_halo_shards(cfg.height // n_rows,
                                    cfg.width // n_cols, model.dt_per_step,
                                    n_cols > 1)


def spmd_route(model: IonicModel, device_type: str, kernel: str,
               wide_halo: bool) -> str:
    """The per-shard step of a sharded run: 'block' (the block kernel:
    csrc/br_block.cu, one launch per shard per outer step, or for the four
    large models csrc/large_block.cu, one launch per commit) or 'plain'.
    As the JAX engine's `_spmd_use_kernel` (simulation.py:750-785) on a
    CUDA mesh: 'pallas' forces the block kernel, 'auto' takes it with wide
    halos, 'xla' runs the plain step; Courtemanche's table mode runs the
    plain step ('pallas' raises), as `route` routes it.  kernel='pallas' on
    a CPU mesh raises."""
    if plain_only(model, device_type, kernel, "a mesh of CUDA devices"):
        return "plain"
    return "block" if wide_halo else "plain"


def state_mb(model: IonicModel) -> float:
    """The model's state in MB (2**20 bytes) on its true grid."""
    h, w = model.state_shape()
    return len(model.state_keys()) * h * w * 4 / 2**20


def plain_only(model: IonicModel, device_type: str, kernel: str,
               devices: str = "a CUDA device") -> bool:
    """The checks every kernel choice starts with (`route`, `spmd_route`,
    engine/volume.py's `volume_route` and `_use_shard_kernel`): whether
    the run takes the plain path at any size, under kernel='xla', off the
    card, or for a model without a kernel (Courtemanche's table mode).
    Raises on a kernel name but auto|pallas|xla, on kernel='pallas' off
    the card (which needs `devices`) and on kernel='pallas' in table
    mode."""
    if kernel not in ("auto", "pallas", "xla"):
        raise ValueError(f"kernel must be auto|pallas|xla, got {kernel!r}")
    if kernel == "pallas" and device_type != "cuda":
        raise ValueError(
            f"kernel='pallas' runs the hand-written CUDA kernels and needs "
            f"{devices}; use kernel='auto' or 'xla' on the CPU")
    if model.kernel_free and kernel == "pallas":
        raise ValueError(TABLE_KERNEL_MESSAGE)
    return model.kernel_free or kernel == "xla" or device_type != "cuda"


def route(model: IonicModel, device_type: str, kernel: str) -> str:
    """The outer step a run takes: 'substep' (the CUDA substep kernel, one
    launch per substep), 'tiled' (the CUDA tiled kernel, one launch) or
    'plain' (PyTorch).  As the JAX engine routes
    (simulation.py:405-492, :568-617) on a CUDA device, with the state's
    MB taken on the true grid; the reference's (8, 128) alignment and tile
    divisibility conditions are Mosaic's and are not carried, since the
    CUDA kernels take any shape.  kernel='pallas' without a CUDA device
    raises."""
    if plain_only(model, device_type, kernel):
        return "plain"
    if (state_mb(model) <= Simulation.WHOLE_GRID_STATE_MB_MAX
            or 2 not in bodies.cell_body(model).kernels):
        # Courtemanche, LR1 and tp06 take the substep kernel at every
        # size: the reference keeps them off its tiled kernel and runs XLA
        # past its VMEM cap, which the card's substep kernel does not have
        return "substep"
    return "tiled"

