#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card at
the cell's own size:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--seconds 2]

For each seed it makes one run of the cell (a window of `--seconds`) and
prints one JSON line: each checked stage's widest gap between the program
and the plain reference (the lower readings), and the same gap of the
control, the reference computed in bfloat16 (the nearest precision below
the configuration's float32) in the program's place, against the float32
reference (the upper readings); beside them both gaps with the
ill-conditioned cells kept in, and how many cells the reference marked.
The benchmark's own runs never run the control.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12 \
        --faults frozen,half_steps,final_altered [--seconds 2]

reads the window's checks with a fault planted in the timed window alone
(where the reference does not follow): a window that returns the state it
was given with its probe streams held, one that runs half its outer
steps, and one whose final potential is altered at the probe's cell.  One
line per fault and seed, with `correct` and the window's readings.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402

CONTROL_DTYPE = "bfloat16"


def control_gaps(cell, device):
    """An `on_check` that records the control's gap of each stage."""
    import torch

    from harness import compare, spec
    from harness import traffic as gen

    ref = spec.family_module("reference", cell.family)
    phase = gen.geometry(cell.traffic)
    gaps = {}

    def on_check(st, st_in, evs, out, ref_run):
        c = compare.reference_run(ref, cell, phase, st_in, st.steps, evs,
                                  device, dtype=getattr(torch, CONTROL_DTYPE))
        as_np = {k: v.float().cpu().numpy() for k, v in c.state.items()}
        probes = {k: v.float().cpu().numpy() for k, v in c.probes.items()}
        gaps[st.name] = {
            "control": compare.stage_gap(as_np, probes, ref_run),
            "program_all_cells": compare.stage_gap(
                out.state, out.probes, ref_run, leave_out=False),
            "control_all_cells": compare.stage_gap(
                as_np, probes, ref_run, leave_out=False),
            "ill_conditioned": int(ref_run.ill_conditioned.sum()),
        }

    return gaps, on_check


def frozen(real_run, prog, sim, events, sync):
    """The window returns the state it was given, each probe stream held
    at its first sample."""
    res, wall = real_run(prog, sim, events, sync)
    res.state = {k: v.copy() for k, v in prog.window_input.items()}
    res.probes = {k: np.repeat(v[:1], len(v), axis=0)
                  for k, v in res.probes.items()}
    return res, wall


def half_steps(real_run, prog, sim, events, sync):
    """The window runs half the outer steps it was asked for."""
    n = prog.window_steps // 2
    return real_run(prog, prog.simulation(n, prog.window_input),
                    [e for e in events if e[0] <= n], sync)


def final_altered(real_run, prog, sim, events, sync):
    """The window's final potential, at the "v" probe's cell (row 20, the
    middle column), set 10 mV above what it computed."""
    res, wall = real_run(prog, sim, events, sync)
    v = res.state["V"]
    v[20, v.shape[1] // 2] += 10.0
    return res, wall


WINDOW_FAULTS = {f.__name__: f for f in (frozen, half_steps, final_altered)}


@contextlib.contextmanager
def window_fault(fault):
    """Plant `fault(real_run, program, sim, events, sync)` in the timed
    window's `simulate()` call alone; the stages before and after it, and
    the fault's own calls, run as they are."""
    from harness import program
    P = program.Program
    real_run, real_stage, real_simulation = P.run, P.stage, P.simulation

    def stage(self, *args, **kw):
        self.in_stage = True
        try:
            return real_stage(self, *args, **kw)
        finally:
            self.in_stage = False

    def simulation(self, n_steps, state):
        if not getattr(self, "in_stage", False):
            self.window_input, self.window_steps = state, n_steps
        return real_simulation(self, n_steps, state)

    def run(self, sim, events, sync):
        if getattr(self, "in_stage", False):
            return real_run(self, sim, events, sync)
        self.in_stage = True
        try:
            return fault(real_run, self, sim, events, sync)
        finally:
            self.in_stage = False

    P.stage, P.simulation, P.run = stage, simulation, run
    try:
        yield
    finally:
        P.stage, P.simulation, P.run = real_stage, real_simulation, real_run


def window_faults(cell, seeds, seconds, device, faults):
    for name in faults:
        for seed in seeds:
            with window_fault(WINDOW_FAULTS[name]):
                result, checks = run.run_cell(cell, seed, seconds, False,
                                              device, time.perf_counter())
            yield {"cell": cell.name, "seed": seed, "fault": name,
                   "correct": result["correct"],
                   "window": {c[0]: c[1] for c in checks
                              if c[0].startswith("window.")}}


def calibrate(cell, seeds, seconds, device):
    for seed in seeds:
        gaps, on_check = control_gaps(cell, device)
        t0 = time.perf_counter()
        result, checks = run.run_cell(cell, seed, seconds, False, device, t0,
                                      on_check=on_check)
        yield {
            "cell": cell.name, "seed": seed,
            "program": {name: [gap, where] for name, gap, _, where in checks},
            "correct": result["correct"],
            "control": {k: list(v["control"]) for k, v in gaps.items()},
            "beside": gaps,
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "seconds": time.perf_counter() - t0,
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", default="",
                    help="comma-separated: " + ",".join(WINDOW_FAULTS))
    args = ap.parse_args(argv)
    import torch

    from harness import spec
    if not torch.cuda.is_available():
        print("calibrate.py reads the card; none is visible", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda:0")
    lines = (window_faults(cell, seeds, args.seconds, device,
                           args.faults.split(",")) if args.faults
             else calibrate(cell, seeds, args.seconds, device))
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
