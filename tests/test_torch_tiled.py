"""The port's tiled outer step and its routing, held against fib_tf_tpu:
the plain version of the tiled kernel against the JAX tiled Pallas kernel
(run in interpret mode on the CPU, as tests/test_pallas.py runs it), and
the engine's kernel choice against the JAX engine's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.beeler_reuter as jbr
import fib_tf_tpu_torch.models.beeler_reuter as tbr
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.engine import Simulation as JaxSimulation
from fib_tf_tpu.ops.pallas_tiled import make_tiled_pallas_step
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import Simulation, simulation
from fib_tf_tpu_torch.ops import cuda_step, cuda_tiled
from test_torch_fixtures import one_torch_thread  # noqa: F401


def jax_cfg(c):
    """The JAX package's SimConfig with the same fields as the port's `c`."""
    return JaxSimConfig(**dataclasses.asdict(c))


TILED_TOL = dict(rtol=2e-3, atol=1e-5)   # tests/test_pallas.py:151-174


def cfg(**kw):
    base = dict(width=128, height=64, dt=0.1, diff=0.809, duration=1,
                cheby=True, skip=True)
    base.update(kw)
    return SimConfig(**base)


def seeded_state(model, seed=0):
    """The initial state (with S1 stripe), perturbed from a seed."""
    rng = np.random.RandomState(seed)
    st = model.initial_state()
    shape = model.state_shape()
    st["V"] = st["V"] + rng.normal(0, 2.0, shape).astype(np.float32)
    for g in tbr.GATES:
        st[g] = np.clip(st[g] * rng.uniform(0.9, 1.1, shape),
                        1e-5, 0.99999).astype(np.float32)
    st["C"] = (st["C"] * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
    return st


# -- the plain tiled step against the JAX tiled kernel ---------------------------


@pytest.mark.parametrize("skip", [True, False])
def test_plain_tiled_step_matches_jax_tiled_kernel(skip):
    """64x128, tile_rows=16 (four row tiles, two of them at the domain's
    edges), 2 outer steps from a seeded state."""
    c = cfg(skip=skip)
    jm, tm = jbr.BeelerReuter(jax_cfg(c)), tbr.BeelerReuter(c)
    st = seeded_state(tm, seed=1)
    jstep = make_tiled_pallas_step(jm, tile_rows=16, interpret=True)
    want = {k: jnp.asarray(v) for k, v in st.items()}
    got = interop.state_from_numpy(st, "cpu")
    probe = torch.zeros(2)
    step = cuda_tiled.make_tiled_cuda_step(tm)
    for i in range(2):
        want = jstep(want)
        got = step(got, probe, i)
        assert abs(float(probe[i]) - float(jm.probe(want))) <= 1e-5
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TILED_TOL)


def test_plain_tiled_step_is_the_plain_outer_step():
    assert cuda_tiled.plain_tiled_step is cuda_step.plain_step


# -- routing against the JAX engine -------------------------------------------------


def reference_route(c, monkeypatch):
    """The JAX engine's kernel choice for BR on a TPU, in the port's words:
    no fused kernel -> 'plain'; the whole-grid kernel -> 'substep'; the
    tiled kernel -> 'tiled'.  __init__ allocates no state."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    sim = JaxSimulation(jbr.BeelerReuter(jax_cfg(c)))
    if not sim._use_pallas():
        return "plain"
    fits = sim._state_mb(padded=True) <= sim.WHOLE_GRID_STATE_MB_MAX
    return "substep" if fits else "tiled"


ALIGNED = [(512, 512), (1024, 1024), (1032, 1024), (1152, 1024),
           (2048, 2048)]


@pytest.mark.parametrize("kernel", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("hw", ALIGNED, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_route_matches_reference_on_aligned_grids(hw, skip, kernel,
                                                  monkeypatch):
    c = cfg(height=hw[0], width=hw[1], skip=skip, kernel=kernel)
    want = reference_route(c, monkeypatch)
    assert simulation.route(tbr.BeelerReuter(c), "cuda", kernel) == want


def test_route_across_the_cutover():
    """1024x1024 is exactly 32 MB and stays on the substep kernel."""
    routes = {hw: simulation.route(
        tbr.BeelerReuter(cfg(height=hw[0], width=hw[1])), "cuda", "auto")
        for hw in ALIGNED}
    assert routes == {(512, 512): "substep", (1024, 1024): "substep",
                      (1032, 1024): "tiled", (1152, 1024): "tiled",
                      (2048, 2048): "tiled"}
    assert simulation.state_mb(
        tbr.BeelerReuter(cfg(height=1024, width=1024))) == 32.0


@pytest.mark.parametrize("hw", [(1024, 1032), (1030, 1024)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_unaligned_grid_past_the_cutover_routes_tiled(hw, monkeypatch):
    """Where the port deliberately differs: the reference keeps an
    unaligned grid past the cutover on XLA (simulation.py:469-471), since
    Mosaic tiling needs the (8, 128) alignment; the CUDA tiled kernel takes
    any shape."""
    c = cfg(height=hw[0], width=hw[1])
    assert reference_route(c, monkeypatch) == "plain"
    assert simulation.route(tbr.BeelerReuter(c), "cuda", "auto") == "tiled"


def test_route_on_the_cpu():
    big = tbr.BeelerReuter(cfg(height=2048, width=2048))
    assert simulation.route(big, "cpu", "auto") == "plain"
    assert simulation.route(big, "cpu", "xla") == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        simulation.route(big, "cpu", "pallas")
    assert Simulation(big, device="cpu").route == "plain"


def test_cutover_constant_equals_reference():
    assert (Simulation.WHOLE_GRID_STATE_MB_MAX
            == JaxSimulation.WHOLE_GRID_STATE_MB_MAX == 32)
    for hw in [(64, 64), (1032, 1024), (1031, 517)]:
        c = cfg(height=hw[0], width=hw[1])
        sim = Simulation(tbr.BeelerReuter(c), device="cpu")
        assert sim._state_mb() == JaxSimulation(
            jbr.BeelerReuter(jax_cfg(c)))._state_mb()


# -- the wrapper on the CPU -------------------------------------------------------------


def test_tile_table():
    assert cuda_tiled.tile_interior(5) == (54, 54)
    assert cuda_tiled.slow_mask((True, False, False, False, False)) == 1
    assert cuda_tiled.slow_mask((True,) * 5) == 31
    # a 512-row shard: 10 row tiles of 52 and 51 rows, not 9 x 54 + 26
    assert cuda_tiled.tile_spans(512, 54) == [(0, 52), (52, 52)] + [
        (104 + 51 * i, 51) for i in range(8)]
    # 2048: 38 tiles, 34 of 54 and 4 of 53
    sizes = [n for _, n in cuda_tiled.tile_spans(2048, 54)]
    assert sizes == [54] * 34 + [53] * 4
    assert cuda_tiled.tile_walk(5, 3) == [[0, 3], [1, 4], [2]]
    assert cuda_tiled.tile_walk(2, 132) == [[0], [1]]


@pytest.mark.parametrize("n_sub", [1, 3, 5])
def test_tile_spans_cover_an_axis_once(n_sub):
    """Brute force over every window length up to 300: the tiles cover
    each cell exactly once, as few as the largest interior allows, of
    sizes within one cell of each other."""
    for max_tile in cuda_tiled.tile_interior(n_sub):
        for length in range(1, 301):
            spans = cuda_tiled.tile_spans(length, max_tile)
            hits = np.zeros(length, dtype=int)
            for start, size in spans:
                hits[start:start + size] += 1
            sizes = [size for _, size in spans]
            assert (hits == 1).all(), (length, max_tile)
            assert len(spans) == -(-length // max_tile)
            assert max(sizes) <= max_tile and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("rows,cols,n_blocks", [
    (2048, 2048, 132), (2047, 2047, 132), (512, 2048, 132),
    (1024, 1024, 132), (67, 131, 132), (9, 12, 132), (300, 200, 7)],
    ids=lambda v: str(v))
def test_persistent_walk_writes_every_cell_once(rows, cols, n_blocks):
    """The persistent blocks' static walk over the tiles of a rows x cols
    window writes every cell exactly once, and no block takes more than
    one tile beyond any other."""
    th, tw = cuda_tiled.tile_interior(5)
    rs, cs = cuda_tiled.tile_spans(rows, th), cuda_tiled.tile_spans(cols, tw)
    walk = cuda_tiled.tile_walk(len(rs) * len(cs), n_blocks)
    hits = np.zeros((rows, cols), dtype=int)
    for tiles in walk:
        for t in tiles:
            (r, h), (c, w) = rs[t // len(cs)], cs[t % len(cs)]
            hits[r:r + h, c:c + w] += 1
    assert (hits == 1).all()
    assert len(walk) == min(n_blocks, len(rs) * len(cs))
    counts = [len(tiles) for tiles in walk]
    assert max(counts) - min(counts) <= 1


def test_empty_interior_raises(monkeypatch):
    monkeypatch.setattr(cuda_tiled, "TILE", (8, 8, 1))
    with pytest.raises(ValueError, match="interior"):
        cuda_tiled.make_tiled_cuda_step(tbr.BeelerReuter(cfg()))


@pytest.mark.parametrize("skip", [True, False])
def test_wrapper_routes_cpu_tensors_to_plain_version(skip):
    tm = tbr.BeelerReuter(cfg(height=48, width=40, skip=skip))
    st = seeded_state(tm, seed=3)
    a = interop.state_from_numpy(st, "cpu")
    b = interop.state_from_numpy(st, "cpu")
    probe_a, probe_b = torch.zeros(3), torch.zeros(3)
    step = cuda_tiled.make_tiled_cuda_step(tm)
    for i in range(3):
        assert step(a, probe_a, i) is a
        cuda_step.plain_step(tm, b, probe_b, i)
    for k in b:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    torch.testing.assert_close(probe_a, probe_b, rtol=0, atol=0)
    assert cuda_tiled.KERNEL.launches == 0


@pytest.mark.parametrize("breakage", [
    "dtype", "shape", "contiguity", "missing", "device_mix"])
def test_wrapper_rejects_bad_state(breakage):
    tm = tbr.BeelerReuter(cfg(height=32, width=32))
    st = interop.state_from_numpy(tm.initial_state(), "cpu")
    if breakage == "dtype":
        st["m"] = st["m"].double()
        err = TypeError
    elif breakage == "shape":
        st["h"] = st["h"][:-1]
        err = ValueError
    elif breakage == "contiguity":
        st["j"] = st["j"].t().contiguous().t()
        err = ValueError
    elif breakage == "missing":
        del st["C"]
        err = ValueError
    else:
        st["d"] = st["d"].to("meta")
        err = ValueError
    with pytest.raises(err):
        cuda_tiled.make_tiled_cuda_step(tm)(st)


def test_wrapper_rejects_bad_probe():
    tm = tbr.BeelerReuter(cfg(height=32, width=32))
    step = cuda_tiled.make_tiled_cuda_step(tm)
    st = interop.state_from_numpy(tm.initial_state(), "cpu")
    with pytest.raises(IndexError):
        step(st, torch.zeros(2), 2)
    with pytest.raises(ValueError):
        step(st, torch.zeros(2, dtype=torch.float64))
    small = tbr.BeelerReuter(cfg(height=16, width=32))  # probe row 20
    st = interop.state_from_numpy(small.initial_state(), "cpu")
    with pytest.raises(ValueError, match="probe pixel"):
        cuda_tiled.make_tiled_cuda_step(small)(st, torch.zeros(1))


def test_substeps_per_launch_on_the_tiled_route_raises(monkeypatch):
    c = cfg(height=32, width=32, substeps_per_launch=1)
    with pytest.raises(ValueError, match="substeps_per_launch"):
        cuda_tiled.make_tiled_cuda_step(tbr.BeelerReuter(c))
    _route_as_on_the_card(monkeypatch, cutover_mb=0.01)
    sim = Simulation(tbr.BeelerReuter(c), device="cpu")
    assert sim.route == "tiled"
    with pytest.raises(ValueError, match="substeps_per_launch"):
        sim.define()


# -- the engine on the CPU ----------------------------------------------------------------

# 64x64 BR cheby+skip for 60 ms with an S2 quadrant stimulus at 30 ms, as
# tests/test_torch_engine.py runs it
ENGINE_CFG = SimConfig(width=64, height=64, dt=0.1, dt_per_plot=10,
                       diff=0.809, duration=60, cheby=True, skip=True)
SCHEDULE = [(30.0, "s2")]
V_ATOL = 1e-3 * (tbr.BeelerReuter.max_v - tbr.BeelerReuter.min_v)


def _route_as_on_the_card(monkeypatch, cutover_mb):
    """Lower the cutover to `cutover_mb` and make the CPU engine take the
    routing decision it would take on a CUDA device."""
    monkeypatch.setattr(Simulation, "WHOLE_GRID_STATE_MB_MAX", cutover_mb)
    real = simulation.route
    monkeypatch.setattr(simulation, "route",
                        lambda model, device_type, kernel:
                        real(model, "cuda", kernel))


def test_engine_on_the_tiled_route_matches_jax_engine(monkeypatch):
    """With the cutover lowered so that 64x64 (0.125 MB) routes 'tiled'
    on a card, the CPU engine builds the tiled step, whose wrapper runs
    the plain version on CPU tensors, and matches the JAX engine."""
    monkeypatch.setattr(Simulation, "WHOLE_GRID_STATE_MB_MAX", 0.1)
    model = tbr.BeelerReuter(ENGINE_CFG)
    assert simulation.route(model, "cuda", "auto") == "tiled"
    assert Simulation(model, device="cpu").route == "plain"

    _route_as_on_the_card(monkeypatch, cutover_mb=0.1)
    built = []
    make = cuda_tiled.make_tiled_cuda_step
    monkeypatch.setattr(cuda_tiled, "make_tiled_cuda_step",
                        lambda m: built.append(m) or make(m))
    sim = Simulation(model, device="cpu")
    assert sim.route == "tiled"
    sim.define()
    assert built == [model]
    sim.add_pace_op("s2", "luq", 10.0)
    got = sim.simulate(schedule=SCHEDULE)

    jsim = JaxSimulation(jbr.BeelerReuter(jax_cfg(ENGINE_CFG))).define()
    jsim.add_pace_op("s2", "luq", 10.0)
    want = jsim.simulate(schedule=SCHEDULE)
    assert got.steps == want.steps == 120
    assert got.cycle_lengths == want.cycle_lengths == [(42, 21.0)]
    for k in want.state:
        tol = (dict(atol=V_ATOL, rtol=0) if k == "V"
               else dict(atol=0, rtol=1e-3) if k == "C"
               else dict(atol=1e-3, rtol=0))
        np.testing.assert_allclose(got.state[k], want.state[k], err_msg=k,
                                   **tol)
    np.testing.assert_allclose(got.probes["v"], want.probes["v"],
                               atol=V_ATOL / 120.0, rtol=0)
