"""The benchmark's harness on the CPU: the loader, the result line, the
refusal without a card, and the rule that nothing the benchmark runs
imports JAX or the JAX package.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
sys.path[:0] = [str(BENCH), str(CHECKOUT)]

import run  # noqa: E402
from harness import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "fib_tf_tpu"}
SMALL = 64


def small_traffic(name: str) -> dict:
    """A cell's traffic at 64x64 and a few tens of ms: the holes scaled
    with the grid, the events brought forward."""
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    scale = SMALL / t["grid"][0]
    t["grid"] = [SMALL, SMALL]
    t["holes"] = [[x * scale, y * scale, max(r * scale, 4.0), o]
                  for x, y, r, o in t["holes"]]
    t["trains"] = [dict(tr, first_ms=50.0, period_ms=50.0)
                   for tr in t["trains"]]
    t["events"] = [dict(e, at_ms=30.0) for e in t["events"]]
    t.update(pre_window_ms=60.0, warmup_ms=20.0, trace_ms=10.0,
             start_steps=min(t["start_steps"], 10),
             end_steps=min(t["end_steps"], 8))
    return t


def small_root(tmp_path: Path, cell: str) -> Path:
    """A copy of the benchmark's files for `cell` at 64x64, with the
    cell's own limits."""
    root = tmp_path / "bench"
    if not root.exists():
        shutil.copytree(BENCH / "configs", root / "configs")
        shutil.copytree(BENCH / "metrics", root / "metrics")
        (root / "traffic").mkdir()
        (root / "workloads").mkdir()
    w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    (root / "traffic" / f"{w['traffic']}.json").write_text(
        json.dumps(small_traffic(w["traffic"])))
    # the window's bands are the full-size traffic's: at 64x64 the tests
    # that hold them set their own
    w["limits"].update({k: [0.0, 1e9] for k, v in w["limits"].items()
                        if isinstance(v, list)})
    (root / "workloads" / f"{cell}.json").write_text(json.dumps(w))
    return root


def cpu_run(root, cell, seed=7, trace=False, seconds=0.2, steps=None):
    import time
    c = spec.load_cell(cell, root)
    return run.run_cell(c, seed, seconds, trace, torch.device("cpu"),
                        time.perf_counter(), steps=steps)


def test_loader_finds_a_new_cell_by_its_files(tmp_path):
    root = small_root(tmp_path, "br.512.paced")
    (root / "workloads" / "extra.cell.json").write_text(json.dumps(
        {"config": "court", "traffic": "paced.512", "chips": 1,
         "limits": {"start": 0.5, "end": 0.5}}))
    cell = spec.load_cell("extra.cell", root)
    assert (cell.family, cell.chips, cell.traffic["grid"]) == (
        "court", 1, [SMALL, SMALL])
    assert cell.limits == {"start": 0.5, "end": 0.5}
    with pytest.raises(spec.SpecError):
        spec.load_cell("no.such.cell", root)
    with pytest.raises(spec.SpecError):
        spec.load_cell("bad name", root)
    bad = dict(small_traffic("paced.512"), surprise=1)
    (root / "traffic" / "bad.json").write_text(json.dumps(bad))
    (root / "workloads" / "bad.json").write_text(json.dumps(
        {"config": "br_cheby_skip", "traffic": "bad", "chips": 1,
         "limits": {}}))
    with pytest.raises(spec.SpecError, match="surprise"):
        spec.load_cell("bad", root)
    (root / "workloads" / "four.json").write_text(json.dumps(
        {"config": "court", "traffic": "paced.512", "chips": 4,
         "limits": {"start": 0.5, "end": 0.5}}))
    with pytest.raises(spec.SpecError, match="one card"):
        spec.load_cell("four", root)
    (root / "workloads" / "band.json").write_text(json.dumps(
        {"config": "court", "traffic": "paced.512", "chips": 1,
         "limits": {"window.cycle_ms": [300, 200]}}))
    with pytest.raises(spec.SpecError, match="band"):
        spec.load_cell("band", root)


def test_every_listed_cell_loads_with_a_limit_per_checked_stage():
    from harness import traffic as gen
    from harness import window
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    readers = spec.metric_readers()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert (cell.config_name, cell.traffic_name, cell.chips) == (
            w["config"], w["traffic"], w["chips"])
        ref = spec.family_module("reference", cell.family)
        step = ref.DT_PER_STEP * cell.config["sim"]["dt"]
        names = {s.name for s in gen.pre_window(cell.traffic, step)
                 if s.checked} | {"end"} | set(window.names(cell.traffic))
        assert set(cell.limits) == names
    assert {m["name"] for m in bench["per_layer"]} == set(readers)
    for m in bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(tmp_path, trace):
    root = small_root(tmp_path, "br.512.paced")
    result, checks = cpu_run(root, "br.512.paced", trace=trace)
    line = json.loads(json.dumps(result))
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"} | ({"breakdown"} if trace
                                                else set())
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == len(checks)
    assert {"start", "end", "window.steps", "window.last_probe",
            "window.cycle_ms"} <= {c[0] for c in checks}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    else:
        assert set(line["metrics"]) == {"wall_s_per_sim_s", "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for name, value, limit, _ in checks:
        assert line["checks"][name] == {"value": value, "limit": limit}


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "br.512.paced",
         "--seed", "2147483713", "--seconds", "1", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("planted", [None, "jax", "fib_tf_tpu.engine"])
def test_a_process_holding_jax_prints_no_result(monkeypatch, capsys,
                                                planted):
    """Every path to the result's line passes the look at sys.modules,
    as it is about to print: a JAX module loaded at any point, the
    reference's comparison included, leaves no result."""
    import types
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.setenv(var, "unset")
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def fake_run(*args, **kw):
        if planted:
            monkeypatch.setitem(sys.modules, planted,
                                types.ModuleType(planted))
        return {"correct": True, "attempted": 1, "failed": 0,
                "metrics": {}, "device": {}, "checks": {}}, []

    monkeypatch.setattr(run, "run_cell", fake_run)
    rc = run.main(["--workload", "br.512.paced", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    if planted:
        assert rc == 2 and out.strip() == ""
        assert planted.split(".")[0] in err
    else:
        assert rc == 0 and json.loads(out.strip().splitlines()[-1])


def test_window_readings():
    from harness import window
    step = 0.5
    v = np.zeros(2000)
    for beat in (100, 1100):               # two beats 500 ms apart
        v[beat:beat + 400] = 1.0
    times = window.crossings(0.0, v, step)
    assert times == [50.5, 550.5]
    assert window.cycle_band(times, 1000.0) == [500.0, 500.0]
    assert window.cycle_band([], 1000.0) == [1000.0, 1000.0]
    assert window.cycle_band([50.5], 1000.0) == [949.5, 949.5]
    # a crossing at the first step counts, from the input state's probe
    assert window.crossings(0.0, np.ones(4), step) == [0.5]
    assert window.crossings(1.0, np.ones(4), step) == []
    delays = window.pace_delays(times, [(2, "pace"), (1002, "pace"),
                                        (1900, "pace"), (5, "s2")],
                                {"pace"}, step, 1000.0)
    assert delays == [49.5, 50.0]
    assert window.pace_delays(times, [(1990, "pace")], {"pace"}, step,
                              1000.0) == [5.0, 5.0]
    assert window.pace_delays(times, [], {"pace"}, step, 1000.0) is None
    assert window.passes([500.0, 500.0], [450.0, 550.0])
    assert not window.passes([500.0, 949.5], [450.0, 550.0])
    assert not window.passes([400.0, 500.0], [450.0, 550.0])
    assert window.passes(0, 0.0) and not window.passes(1, 0.0)
    assert not window.passes(None, 1.0)


def test_a_run_outside_a_checkout_of_the_program_exits_nonzero(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "br.512.paced",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def imported_top_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    sources = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(sources) > 10
    for path in sources:
        names = set(imported_top_names(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if "reference" in path.parts:
            assert "fib_tf_tpu_torch" not in names, path


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run, calibrate; "
            "from harness import compare, program, spec, trace, traffic, "
            "device; import reference.br, reference.court, counts.br, "
            "counts.court; spec.metric_readers(); "
            "import fib_tf_tpu_torch.engine; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH), str(CHECKOUT), FORBIDDEN))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=CHECKOUT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "br.512.paced",
         "--seed", "2147483713", "--seconds", "1", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
