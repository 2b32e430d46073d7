"""`correct` comes out false for the control and for a broken timed path,
at 64x64 on the CPU.

The control is the plain reference computed in bfloat16, the precision
below the configuration's float32, in the program's place; each cell's
limits have to fail it.  The faults break the timed path underneath a
whole run of the harness (the plain outer step the port takes on the
CPU): a step that returns its state unchanged, a step that leaves half
the grid out, and a step whose answer is altered where it is produced.
Three more break the timed window alone, where the reference does not
follow: a window that returns the state it was given, one that runs half
its outer steps, and one whose final potential is altered at the probe.
One card holds each cell, so there is no exchange between chips to
leave out.

    python -m pytest benchmark/tests -q
"""

import contextlib
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import calibrate  # noqa: E402
from harness import spec  # noqa: E402
from harness.window import passes  # noqa: E402
from test_bench_harness import cpu_run, small_root  # noqa: E402

CELLS = ["br.512.paced", "court.2048.annulus", "br.2048.paced",
         "court.512.annulus"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_the_cell_limits(tmp_path, cell_name):
    root = small_root(tmp_path, cell_name)
    cell = spec.load_cell(cell_name, root)
    for line in calibrate.calibrate(cell, [3, 4, 5], 0.1,
                                    torch.device("cpu")):
        program = {k: v[0] for k, v in line["program"].items()}
        control = {k: v[0] for k, v in line["control"].items()}
        assert all(passes(program[k], cell.limits[k]) for k in program), line
        assert any(control[k] > cell.limits[k] for k in control), line


def unchanged(step):
    def broken(model, state, *args, **kw):
        before = {k: v.clone() for k, v in state.items()}
        step(model, state, *args, **kw)
        state.update(before)
        return state
    return broken


def half_grid(step):
    def broken(model, state, *args, **kw):
        before = {k: v.clone() for k, v in state.items()}
        step(model, state, *args, **kw)
        h = next(iter(state.values())).shape[0] // 2
        for k, v in state.items():
            v[h:] = before[k][h:]
        return state
    return broken


def altered(step):
    """One cell's potential written as the model's peak after every
    outer step."""
    def broken(model, state, *args, **kw):
        step(model, state, *args, **kw)
        v = state[model.pot_key]
        v[v.shape[0] // 3, v.shape[1] // 3] = model.max_v
        return state
    return broken


@pytest.mark.parametrize("fault", [None, unchanged, half_grid, altered])
@pytest.mark.parametrize("cell_name", ["br.512.paced", "court.512.annulus"])
def test_a_broken_timed_path_reads_not_correct(tmp_path, monkeypatch,
                                               cell_name, fault):
    from fib_tf_tpu_torch.ops import cuda_step
    root = small_root(tmp_path, cell_name)
    if fault is not None:
        monkeypatch.setattr(cuda_step, "plain_step",
                            fault(cuda_step.plain_step))
    result, _ = cpu_run(root, cell_name, seed=9)
    assert result["correct"] is (fault is None), result["checks"]


PERIOD_MS = 300.0


def paced_root(tmp_path):
    """`br.512.paced` at 64x64 paced every 300 ms, the window from 290 ms
    over two beats, with bands around what a sound run reads there: every
    cycle 300 ms, each beat at the probe 18.5 ms after its pace."""
    root = small_root(tmp_path, "br.512.paced")
    path = root / "traffic" / "paced.512.json"
    t = json.loads(path.read_text())
    t["trains"] = [dict(tr, first_ms=PERIOD_MS, period_ms=PERIOD_MS)
                   for tr in t["trains"]]
    t.update(pre_window_ms=PERIOD_MS - 10.0)
    path.write_text(json.dumps(t))
    path = root / "workloads" / "br.512.paced.json"
    w = json.loads(path.read_text())
    w["limits"].update({"window.cycle_ms": [290.0, 310.0],
                        "window.pace_delay_ms": [15.0, 22.0]})
    path.write_text(json.dumps(w))
    return root


@pytest.mark.parametrize("fault", [None, *calibrate.WINDOW_FAULTS])
def test_a_broken_window_reads_not_correct(tmp_path, fault):
    root = paced_root(tmp_path)
    with (calibrate.window_fault(calibrate.WINDOW_FAULTS[fault]) if fault
          else contextlib.nullcontext()):
        result, checks = cpu_run(root, "br.512.paced", seed=9, steps=1200)
    window = {c[0]: c[1] for c in checks if c[0].startswith("window.")}
    assert result["correct"] is (fault is None), window
    assert all(passes(c[1], c[2]) for c in checks
               if not c[0].startswith("window.")), checks
    if fault is None:
        assert window["window.cycle_ms"] == [PERIOD_MS, PERIOD_MS], window
