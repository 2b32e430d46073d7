#!/usr/bin/env python3
"""The benchmark of fib_tf_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  A cell names a model configuration and a
traffic mix (workloads/<cell>.json).  A run

1. makes the initial state from the seed (the family's resting planes
   and S1 stripe, V raised per cell by N(0, 1) mV, drawn on the card);
2. runs the stretch before the window through the entry,
   `Simulation.simulate`, in stages: the checked start, each checked
   event with the steps around it, the rest, and a warm-up whose rate
   sizes the window (the first run of a checkout also builds the kernels
   into build/fib_tf_tpu_torch/, which this counts as set-up);
3. times one `simulate()` call of about `--seconds` on its own host
   clock (`--trace 1`: the traffic's `trace_ms` under torch.profiler);
4. runs the checked continuation after the window, frees the program's
   state, holds every checked stage to the plain reference
   (reference/<family>.py), and holds the window's own outputs to what
   the traffic makes of them (harness/window.py).

The last line of standard output is one JSON object: `correct`,
`attempted` and `failed` (the checked stages and the window's checks),
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` a `breakdown`, and last
`checks`, each compared number with its limit.  Earlier lines on
standard error give the card's name, power limit and clocks beside the
window, the window's outer steps and cycle lengths, and the peak device
memory; the last lines there are the compared numbers beside their
limits.  Without a card, or with fewer than the cell needs, it exits 2
and prints no result; so it does when the process holds JAX or the JAX
package as it is about to print.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fib_tf_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def device_record(device) -> dict:
    """The result's `device`: the card's name and the peak device memory
    so far (a CPU run, which only the tests make, says so)."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, on_check=None, steps=None):
    """One run of `cell` on `device`: (result dict, [(check, value,
    limit, where)]).  `on_check(stage, stage input, events, program
    output, reference run)` sees each checked stage after its comparison
    (the control's calibration uses it).  `steps` fixes the window's
    outer steps (the tests do); a run sizes the window from `seconds`."""
    import torch

    from harness import compare, program, spec
    from harness import device as card
    from harness import trace as tr
    from harness import traffic as gen
    from harness import window as win

    ref = spec.family_module("reference", cell.family)
    counts = spec.family_module("counts", cell.family)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    prog = program.Program(cell, device)
    t = cell.traffic
    step_ms = ref.DT_PER_STEP * float(cell.config["sim"]["dt"])
    if abs(prog.step_ms - step_ms) > 1e-9:
        raise RuntimeError(f"outer step {prog.step_ms} ms, the reference's "
                           f"{step_ms} ms")
    phase = gen.geometry(t)
    state = gen.initial_state(ref, t, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    checked = []
    running = "start"
    try:
        stages = gen.pre_window(t, step_ms)
        for st in stages:
            running = st.name
            evs = gen.in_stage(gen.events_until(t, step_ms, st.end), st)
            res = prog.stage(state, st.steps, evs, sync)
            if st.checked:
                checked.append((st, state, evs, res))
            state = res.state
        # the window's length only: the entry's own loop time per outer
        # step in the warm-up, without the state's copies in and out
        rate = res.elapsed / stages[-1].steps
        target = (steps if steps is not None
                  else int(round(t["trace_ms"] / step_ms)) if trace
                  else int(round(seconds / rate)))
        window, end = gen.window_and_end(t, step_ms, stages[-1].end, target)
        w_events = gen.in_stage(gen.events_until(t, step_ms, window.end),
                                window)
        running = "window"
        w_in = state
        sim = prog.simulation(window.steps, state)
        prog.cycle_lengths.clear()
        before = card.sample() if cuda else None
        holder = {}
        setup_s = time.perf_counter() - t_start
        if trace:
            with tr.capture(holder):
                res, w_wall = prog.run(sim, w_events, sync)
        else:
            res, w_wall = prog.run(sim, w_events, sync)
        after = card.sample() if cuda else None
        dev = device_record(device)
        cycles = list(prog.cycle_lengths)
        del sim
        sim_s = window.steps * step_ms / 1000.0

        log(f"card: {before}")
        log(f"card after the window: {after}")
        log(f"route: {prog.route}; stages: "
            + ", ".join(f"{s.name} [{s.start}, {s.end})" for s in stages)
            + f", window [{window.start}, {window.end}), end "
              f"[{end.start}, {end.end}); outer step {step_ms} ms")
        log(f"window: {window.steps} outer steps, {sim_s * 1000.0:.1f} ms "
            f"simulated in {w_wall:.6f} s; {len(w_events)} events; "
            f"{len(cycles)} probe crossings, cycle lengths (ms) "
            f"{[cl for _, cl in cycles][:12]}")
        log(f"set-up {setup_s:.3f} s (warm-up {rate * 1e3:.4f} ms per outer "
            f"step); peak device memory {dev['memory_peak_bytes']} bytes")

        running = "end"
        e_events = gen.in_stage(gen.events_until(t, step_ms, end.end), end)
        res_end = prog.stage(res.state, end.steps, e_events, sync)
        checked.append((end, res.state, e_events, res_end))
    except FloatingPointError as e:
        # the program's own guard found a non-finite potential: an output
        # that says the wrong thing, so the run is not correct
        log(f"the program raised in stage {running}: {e}")
        limit = cell.limits.get(running)
        return ({"correct": False, "attempted": len(cell.limits),
                 "failed": 1, "metrics": {}, "device": device_record(device),
                 "checks": {running: {"value": None, "limit": limit}}},
                [(running, None, limit, str(e))])

    h, w = t["grid"]
    flops = counts.flops_per_cell_step(cell.config["sim"],
                                       phase is not None) * h * w
    result = {"correct": False, "attempted": len(checked), "failed": 0}
    if trace:
        peak = spec.peaks(dev["kind"])
        ctx = tr.reduce(holder.pop("prof"), window.steps, flops,
                        peak and peak["fp32_flop_per_s"])
        metrics = {}
        for mname, reader in spec.metric_readers().items():
            value = reader.read(ctx)
            if value is not None:
                metrics[mname] = {"value": value, "unit": reader.UNIT}
        dev.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        result["breakdown"] = tr.breakdown(ctx)
    else:
        metrics = {
            "wall_s_per_sim_s": {"value": w_wall / sim_s, "unit": "s/sim-s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result["metrics"] = metrics
    result["device"] = dev

    del prog, res_end, state
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = []
    for st, st_in, evs, out in checked:
        ref_run = compare.reference_run(ref, cell, phase, st_in, st.steps,
                                        evs, device)
        gap, where = compare.stage_gap(out.state, out.probes, ref_run)
        log(f"stage {st.name}: {int(ref_run.ill_conditioned.sum())} "
            f"ill-conditioned cells left out")
        if on_check is not None:
            on_check(st, st_in, evs, out, ref_run)
        del ref_run
        checks.append((st.name, gap, cell.limits[st.name],
                       f"widest at {where}"))
    for name, value, where in win.checks(cell, ref, phase, step_ms,
                                         window.steps, w_events, w_in,
                                         res, device):
        checks.append((name, value, cell.limits[name], where))
    sync()
    log(f"reference: {time.perf_counter() - t_ref:.3f} s for "
        f"{sum(st.steps for st, *_ in checked)} outer steps")
    failed = [c for c in checks if not win.passes(c[1], c[2])]
    result.update(correct=not failed, attempted=len(checks),
                  failed=len(failed))
    result["checks"] = {c[0]: {"value": c[1], "limit": c[2]} for c in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CHECKOUT / "build" / "bench_cache" / sub)
    sys.path[:0] = [str(HERE), str(CHECKOUT)]
    from harness import spec
    cell = spec.load_cell(args.workload)

    import torch
    chips = int(cell.chips)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda:0"),
                              T_START)
    return report(result, checks)


def report(result: dict, checks) -> int:
    """Print the result's line, with the compared numbers beside their
    limits as the last lines on standard error; or, where the process
    holds JAX or the JAX package, exit 2 with no result."""
    from harness.window import passes
    found = forbidden_modules()
    if found:
        log(f"no result: the process holds {found}")
        return 2
    for name, value, limit, where in checks:
        log(f"check {name}: {value!r} ({where}) against limit {limit!r}: "
            f"{'ok' if passes(value, limit) else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
