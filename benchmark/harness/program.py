"""The system under test, driven through its public entry alone:
`Simulation(model).define(state=...)`, `add_hole_to_phase_field`,
`add_pace_op` and `simulate(schedule=...)`, with the configuration's
defaults (the route that 'auto' picks, the default chunk, `check_finite`
on).  A stage of the run is one `simulate()` call of its own length on a
Simulation built for it; the state passes from one stage to the next as
the host planes that `simulate()` returns."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np


class Program:
    def __init__(self, cell, device):
        from fib_tf_tpu_torch.config import SimConfig
        from fib_tf_tpu_torch.engine import Simulation
        from fib_tf_tpu_torch.models import MODEL_REGISTRY

        self._SimConfig, self._Simulation = SimConfig, Simulation
        self.model_cls = MODEL_REGISTRY[cell.config["model"]]
        self.sim_kw = dict(cell.config["sim"])
        self.traffic = cell.traffic
        self.device = device
        probe = self.model_cls(self._cfg(1.0))
        self.step_ms = probe.dt_per_step * probe.cfg.dt
        self.cycle_lengths: List[Tuple[int, float]] = []
        self.route = None

    def _cfg(self, duration_ms: float):
        h, w = self.traffic["grid"]
        return self._SimConfig(height=h, width=w, duration=duration_ms,
                               **self.sim_kw)

    def simulation(self, n_steps: int, state: Dict[str, np.ndarray]):
        """A defined Simulation of `n_steps` outer steps from `state`."""
        model = self.model_cls(self._cfg((n_steps + 0.5) * self.step_ms))
        sim = self._Simulation(model, device=self.device)
        for x, y, r, outside in self.traffic["holes"]:
            sim.add_hole_to_phase_field(x, y, r, neg=bool(outside))
        sim.define(state=state)
        for name, op in self.traffic["pace_ops"].items():
            sim.add_pace_op(name, op["loc"], float(op["v"]))
        sim.cl_observer = lambda i, cl: self.cycle_lengths.append((i, cl))
        self.route = sim.route
        return sim

    def schedule(self, events: List[Tuple[int, str]]):
        """Events as (outer steps from the call's start, op) in the
        entry's ms: each at the middle of the step it fires after."""
        return [((k - 0.5) * self.step_ms, op) for k, op in events]

    def run(self, sim, events: List[Tuple[int, str]], sync) -> Tuple:
        """One `simulate()` call: (SimResult, seconds on the host clock
        from the call to its return, with the device synchronised)."""
        t0 = time.perf_counter()
        res = sim.simulate(schedule=self.schedule(events))
        sync()
        return res, time.perf_counter() - t0

    def stage(self, state, n_steps, events, sync):
        """A stage of the run: the SimResult of `n_steps` from `state`."""
        return self.run(self.simulation(n_steps, state), events, sync)[0]
