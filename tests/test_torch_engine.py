"""The port's Simulation driver held against the JAX engine on the CPU,
plus its routing rules and the features it does not carry yet."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.engine import Simulation as JaxSimulation
from fib_tf_tpu.engine.observers import CycleLengthDetector as JaxDetector
from fib_tf_tpu.models import BeelerReuter as JaxBR
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import CycleLengthDetector, Simulation
from fib_tf_tpu.models import grid_geometry as jax_grid_geometry
from fib_tf_tpu_torch.models import BeelerReuter, grid_geometry, volume_geometry
from fib_tf_tpu_torch.ops import stencil
from fib_tf_tpu_torch.parallel import make_mesh
from test_torch_fixtures import one_torch_thread  # noqa: F401


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


# 64x64 BR cheby+skip for 60 ms, with an S2 quadrant stimulus at 30 ms
CFG = SimConfig(width=64, height=64, dt=0.1, dt_per_plot=10, diff=0.809,
                duration=60, cheby=True, skip=True)
SCHEDULE = [(30.0, "s2")]
# whole-run bound: 1e-3 of the model's range (tests/test_golden.py); the
# gates get 1e-3 of theirs ([0, 1]) and Ca 1e-3 relative
V_ATOL = 1e-3 * (BeelerReuter.max_v - BeelerReuter.min_v)


def _port_run(**kw):
    sim = Simulation(BeelerReuter(CFG), device="cpu").define()
    sim.add_pace_op("s2", "luq", 10.0)
    return sim.simulate(schedule=SCHEDULE, **kw)


@pytest.fixture(scope="module")
def runs():
    jsim = JaxSimulation(JaxBR(jax_cfg(CFG))).define()
    jsim.add_pace_op("s2", "luq", 10.0)
    return jsim.simulate(schedule=SCHEDULE), _port_run()


def test_simulate_matches_jax_engine(runs):
    want, got = runs
    assert got.steps == want.steps == 120
    assert got.cycle_lengths == want.cycle_lengths == [(42, 21.0)]
    assert set(got.state) == set(want.state)
    for k in want.state:
        if k == "V":
            tol = dict(atol=V_ATOL, rtol=0)
        elif k == "C":
            tol = dict(atol=0, rtol=1e-3)
        else:
            tol = dict(atol=1e-3, rtol=0)
        np.testing.assert_allclose(got.state[k], want.state[k], err_msg=k,
                                   **tol)
    assert got.probes["v"].shape == want.probes["v"].shape == (120,)
    np.testing.assert_allclose(got.probes["v"], want.probes["v"],
                               atol=V_ATOL / 120.0, rtol=0)
    assert got.frames is None and got.elapsed > 0
    assert got.sim_seconds_per_wall_second > 0
    assert got.cell_updates_per_sec > 0


def test_chunking_does_not_change_the_run(runs):
    _, whole = runs
    chunked = _port_run(max_chunk_steps=7)
    assert chunked.cycle_lengths == whole.cycle_lengths
    np.testing.assert_array_equal(chunked.probes["v"], whole.probes["v"])
    for k in whole.state:
        np.testing.assert_array_equal(chunked.state[k], whole.state[k])


def test_event_fires_after_its_step():
    """An event at 30.5 ms lands after outer step 61 + 1 = 62, the last
    of a 31 ms run: the final S2 quadrant holds max(V, 10 mV)."""
    sim = Simulation(BeelerReuter(CFG.replace(duration=31)),
                     device="cpu").define()
    sim.add_pace_op("s2", "luq", 10.0)
    fired = sim.simulate(schedule=[(30.5, "s2")])
    plain = sim.simulate()
    assert fired.steps == plain.steps == 62
    assert (fired.state["V"][1:32, 1:32] >= 10.0).all()
    assert not (plain.state["V"][1:32, 1:32] >= 10.0).all()
    np.testing.assert_array_equal(
        fired.state["V"],
        np.maximum(plain.state["V"], sim._pace_masks["s2"].numpy()))


def test_cycle_length_detector_matches_jax():
    rng = np.random.RandomState(0)
    series = np.clip(
        0.5 + 0.6 * np.sin(np.arange(400) / 9.0)
        + rng.normal(0, 0.05, 400), 0, 1).astype(np.float32)
    seen, jseen = [], []
    ours = CycleLengthDetector(0.1, 5, 2, lambda i, cl: seen.append((i, cl)))
    ref = JaxDetector(0.1, 5, 2, lambda i, cl: jseen.append((i, cl)))
    for start in range(0, 400, 37):
        ours.feed(start, series[start:start + 37])
        ref.feed(start, series[start:start + 37])
    assert ours.cycle_lengths == ref.cycle_lengths == seen == jseen
    assert len(seen) > 3


def test_kernel_pallas_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        Simulation(BeelerReuter(CFG.replace(kernel="pallas")), device="cpu")


def test_cuda_device_without_cuda_raises(monkeypatch):
    """The entry point runs on the card unless asked for the CPU: without
    a card, the default device and 'cuda' both raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Simulation(BeelerReuter(CFG), device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(BeelerReuter(CFG))
    assert Simulation(BeelerReuter(CFG), device="cpu").device.type == "cpu"


def test_xla_and_auto_agree_on_cpu():
    a = Simulation(BeelerReuter(CFG.replace(duration=5)), device="cpu")
    b = Simulation(BeelerReuter(CFG.replace(duration=5, kernel="xla")),
                   device="cpu")
    ra, rb = a.simulate(), b.simulate()
    for k in ra.state:
        np.testing.assert_array_equal(ra.state[k], rb.state[k])


GEOMETRY_CALLS = ("phase", "dmap")


@pytest.mark.parametrize("call", [
    lambda s: s.add_hole_to_phase_field(16, 16, 4),
    lambda s: s.set_diffusion_map(np.ones((64, 64), np.float32)),
    lambda s: s.add_electrode(10, 10),
    lambda s: s.add_ecg_electrode(10, 10),
    lambda s: s.run(),
    lambda s: s.fire_op("s2"),
    lambda s: s.simulate(record_frames_every_ms=1.0),
], ids=["phase", "dmap", "electrode", "ecg", "run", "fire_op", "frames"])
def test_unported_engine_features_raise(call, request):
    """The engine features not ported yet raise NotImplementedError.  The
    phase field and the diffusion map are ported: they raise as the
    reference does, after define() (tests/test_torch_geometry.py holds
    them to the JAX engine)."""
    sim = Simulation(BeelerReuter(CFG), device="cpu")
    if request.node.callspec.id in GEOMETRY_CALLS:
        call(sim)
        sim.define()
        with pytest.raises(AssertionError, match="before define"):
            call(sim)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(sim)


@pytest.mark.parametrize("kw", [
    dict(mesh_shape=(2,), mesh_mode="gspmd"),
    dict(fiber_angle=0.5, fiber_ratio=0.5),
    dict(rotor_probe=True),
    dict(save_graph=True),
])
def test_unported_config_features_raise(kw):
    """The configuration features not ported yet raise NotImplementedError.
    Fiber anisotropy is ported: it raises as the reference does on a mesh
    without wide halos, and runs otherwise."""
    if "fiber_angle" in kw:
        c = CFG.replace(**kw)
        mesh = make_mesh(devices=["cpu"] * 4)
        with pytest.raises(ValueError, match="wide_halo"):
            Simulation(BeelerReuter(c), device="cpu", mesh=mesh)
        sim = Simulation(BeelerReuter(c.replace(duration=1)), device="cpu")
        assert sim._fiber() == stencil.fiber_tensor(0.5, 0.5)
        assert np.isfinite(sim.simulate().state["V"]).all()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation(BeelerReuter(CFG.replace(**kw)), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(phase=np.ones((8, 8))), dict(dmap=np.ones((8, 8))),
    dict(fiber_angle=0.3, fiber_ratio=0.5),
])
def test_unported_geometry_raises(kw):
    """The 2D geometry is ported: grid_geometry(**kw) is the JAX
    operator (tests/test_torch_geometry.py holds every form); the 3D forms
    of the phase field and the fiber tensor still raise (ROADMAP Queue 1
    item 18)."""
    x = np.random.RandomState(0).uniform(-80, 20, (8, 8)).astype(np.float32)
    got = grid_geometry(**kw).laplace(torch.tensor(x)).numpy()
    want = np.asarray(jax_grid_geometry(**kw).laplace(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    volume_kw = ({"phase": kw["phase"]} if "phase" in kw
                 else {"fiber": stencil.fiber_tensor(0.3, 0.5)}
                 if "fiber_angle" in kw else None)
    if volume_kw is not None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            volume_geometry(**volume_kw)


def test_pacing_and_resume_errors():
    sim = Simulation(BeelerReuter(CFG), device="cpu")
    with pytest.raises(AssertionError):
        sim.add_pace_op("s2", "luq", 10.0)
    sim.define()
    with pytest.raises(KeyError):
        sim.simulate(schedule=[(1.0, "nope")])
    bad = BeelerReuter(CFG).initial_state()
    del bad["x1"]
    with pytest.raises(ValueError):
        sim.simulate(state=bad)
    with pytest.raises(ValueError):
        Simulation(BeelerReuter(CFG), device="cpu").define(state=bad)


def test_non_finite_state_raises():
    st = BeelerReuter(CFG).initial_state()
    st["V"][10, 10] = np.nan
    sim = Simulation(BeelerReuter(CFG.replace(duration=1)), device="cpu")
    with pytest.raises(FloatingPointError):
        sim.simulate(state=st)
    res = sim.simulate(state=st, check_finite=False)
    assert np.isnan(res.state["V"]).any()


def test_timeline_trace_written(tmp_path, monkeypatch):
    """cfg.timeline -> a Chrome trace of one 1-step chunk from the final
    state, in the directory the JAX engine names (its
    test_timeline_trace_written), holding the chunk's spans; the run's
    own result is the run without it."""
    monkeypatch.chdir(tmp_path)
    cfg = CFG.replace(duration=3, timeline=True, timeline_name="tl.json")
    sim = Simulation(BeelerReuter(cfg), device="cpu")
    res = sim.simulate()
    plain = Simulation(BeelerReuter(cfg.replace(timeline=False)),
                       device="cpu").simulate()
    assert (tmp_path / "tl_trace").is_dir()
    names = {e["name"] for e in json.loads(
        (tmp_path / "tl_trace" / "trace.json").read_text())["traceEvents"]
        if "name" in e}
    assert {"fibtorch.enqueue", "fibtorch.readback"} <= names
    assert "fibtorch.simulate" not in names
    for k in plain.state:
        np.testing.assert_array_equal(res.state[k], plain.state[k])
    np.testing.assert_array_equal(res.probes["v"], plain.probes["v"])
