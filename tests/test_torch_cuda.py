"""The CUDA kernels (2D substep and tiled, volume substep and tiled, and the
per-shard block kernels of the sharded paths) against their plain PyTorch
version, on the card: Beeler-Reuter on all six, Fenton and
Mitchell-Schaeffer on the four that host their cell bodies, the 2D
geometry's GEOM entries of kernels 1-3 for every cell body, and
Courtemanche, Courtemanche-ultra, Luo-Rudy 1991 and ten
Tusscher-Panfilov 2006 on kernels 1 (with GEOM) and 4.

Marked `cuda`: without a CUDA device (and nvcc) every test here skips.  On
the card:  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from fib_tf_tpu_torch import SimConfig, interop
from fib_tf_tpu_torch.engine import (Simulation, VolumeEvent, run_volume,
                                     volume, volume_state)
from fib_tf_tpu_torch.models import (BeelerReuter, Courtemanche,
                                     CourtemancheUltra, Fenton4v, LuoRudy91,
                                     MitchellSchaeffer, TenTusscher06)
from fib_tf_tpu_torch.ops import (bodies, cuda_block, cuda_step, cuda_tiled,
                                  cuda_volume, cuda_volume_block,
                                  cuda_volume_tiled)
from fib_tf_tpu_torch.parallel import make_mesh
from test_torch_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda

CFG = SimConfig(width=96, height=64, dt=0.1, dt_per_plot=10, diff=0.809,
                duration=20, cheby=True, skip=True)


def tile_bench():
    """tools/torch_tile_bench.py, whose SASS parser the tests share."""
    tools = Path(__file__).resolve().parents[1] / "tools"
    path = tools / "torch_tile_bench.py"
    spec = importlib.util.spec_from_file_location("torch_tile_bench", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(model, device):
    rng = np.random.RandomState(0)
    st = model.initial_state()
    st["V"] = st["V"] + rng.normal(0, 1.0, st["V"].shape).astype(np.float32)
    return interop.state_from_numpy(st, device)


@pytest.mark.parametrize("skip", [True, False])
def test_kernel_matches_plain_version(device, skip):
    model = BeelerReuter(CFG.replace(skip=skip))
    base = _state(model, device)
    before = dict(cuda_step.KERNEL.launches)
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    pk, pp = torch.zeros(3, device=device), torch.zeros(3, device=device)
    step = cuda_step.make_cuda_step(model)
    for i in range(3):
        got = step(got, pk, i)
        want = cuda_step.plain_step(model, want, pp, i)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)
    launched = {k: cuda_step.KERNEL.launches[k] - before[k] for k in before}
    assert launched == ({"slow": 3, "frozen": 12} if skip
                        else {"slow": 15, "frozen": 0})


def test_kernel_rejects_bad_planes(device):
    model = BeelerReuter(CFG)
    st = _state(model, device)
    st["m"] = st["m"].double()
    with pytest.raises(TypeError):
        cuda_step.substep(model, st, True)
    st = _state(model, device)
    st["h"] = st["m"]
    with pytest.raises(ValueError, match="share memory"):
        cuda_step.substep(model, st, True)


def test_simulate_routes_by_kernel_setting(device):
    before = dict(cuda_step.KERNEL.launches)
    ref = Simulation(BeelerReuter(CFG.replace(kernel="xla")),
                     device=device).define().simulate()
    assert cuda_step.KERNEL.launches == before
    sim = Simulation(BeelerReuter(CFG.replace(kernel="pallas")),
                     device=device).define()
    cuda_step.KERNEL.reset_launches()
    res = sim.simulate()
    assert cuda_step.KERNEL.launches == {"slow": res.steps,
                                         "frozen": 4 * res.steps}
    np.testing.assert_allclose(res.state["V"], ref.state["V"], atol=0.12,
                               rtol=0)


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("hw", [(64, 96), (67, 131)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_tiled_kernel_matches_plain_version(device, hw, skip):
    model = BeelerReuter(CFG.replace(height=hw[0], width=hw[1], skip=skip))
    base = _state(model, device)
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    pk, pp = torch.zeros(3, device=device), torch.zeros(3, device=device)
    step = cuda_tiled.make_tiled_cuda_step(model)
    before = cuda_tiled.KERNEL.launches
    for i in range(3):
        got = step(got, pk, i)
        want = cuda_tiled.plain_tiled_step(model, want, pp, i)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)
    assert cuda_tiled.KERNEL.launches - before == 3


def _seeded(model, device, seed):
    rng = np.random.RandomState(seed)
    st = model.initial_state()
    st["V"] = st["V"] + rng.normal(0, 3.0, st["V"].shape).astype(np.float32)
    return interop.state_from_numpy(st, device)


@pytest.mark.parametrize("hw", [(2047, 2047), (160, 160), (9, 12)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_tiled_kernel_on_ragged_and_small_grids(device, hw):
    """2047^2: 38 x 38 tiles of 54 and 53 cells, 10 or 11 for each
    persistent block; 160^2: 3 x 3 tiles, the clamp-free centre among edge
    tiles in one launch; 9x12: smaller than one tile (no probe pixel)."""
    h, w = hw
    model = BeelerReuter(CFG.replace(height=h, width=w))
    base = _seeded(model, device, 4)
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    has_probe = model.probe_pixel[0] < h
    pk = torch.zeros(2, device=device) if has_probe else None
    pp = torch.zeros(2, device=device) if has_probe else None
    step = cuda_tiled.make_tiled_cuda_step(model)
    before = cuda_tiled.KERNEL.launches
    for i in range(2):
        got = step(got, pk, i)
        want = cuda_tiled.plain_tiled_step(model, want, pp, i)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-5)
    if has_probe:
        torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)
    assert cuda_tiled.KERNEL.launches - before == 2


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("n_sub", [1, 2, 3, 4, 5])
def test_tiled_kernel_for_every_substep_count(device, n_sub, skip):
    """One launch of n_sub substeps (the first n_sub of the model's
    schedule) against n_sub plain substeps, on 131 x 200 cells: tiles of
    every interior size the halo leaves."""
    model = BeelerReuter(CFG.replace(height=131, width=200, skip=skip))
    schedule = model.launch_schedule[:n_sub]
    base = _seeded(model, device, 5)
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    pk, pp = torch.zeros(1, device=device), torch.zeros(1, device=device)
    cuda_tiled.KERNEL.launch(bodies.pack_params(model), got, schedule, pk,
                             model.probe_pixel, 0,
                             torch.cuda.current_stream(device).cuda_stream)
    for s, slow in enumerate(schedule):
        last = s == len(schedule) - 1
        want = cuda_step.plain_substep(model, want, slow,
                                       pp if last else None, 0)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)


def test_simulate_past_the_cutover_routes_tiled(device, monkeypatch):
    monkeypatch.setattr(Simulation, "WHOLE_GRID_STATE_MB_MAX", 0.01)
    ref = Simulation(BeelerReuter(CFG.replace(kernel="xla")),
                     device=device).define().simulate()
    sim = Simulation(BeelerReuter(CFG), device=device).define()
    assert sim.route == "tiled"
    cuda_step.KERNEL.reset_launches()
    cuda_tiled.KERNEL.reset_launches()
    res = sim.simulate()
    assert cuda_tiled.KERNEL.launches == res.steps
    assert cuda_step.KERNEL.launches == {"slow": 0, "frozen": 0}
    np.testing.assert_allclose(res.state["V"], ref.state["V"], atol=0.12,
                               rtol=0)


# -- the volume kernels ---------------------------------------------------------------


def _volume_state(model, depth, device):
    rng = np.random.RandomState(1)
    st = volume_state(model, depth)
    st["V"] = st["V"] + rng.normal(0, 1.0, st["V"].shape).astype(np.float32)
    return interop.state_from_numpy(st, device)


@pytest.mark.parametrize("kind", ["substep", "tiled"])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dhw", [(4, 64, 96), (5, 67, 131), (3, 9, 12)],
                         ids=lambda s: "x".join(map(str, s)))
def test_volume_kernels_match_plain_version(device, dhw, skip, kind):
    d, h, w = dhw
    model = BeelerReuter(CFG.replace(height=h, width=w, skip=skip))
    base = _volume_state(model, d, device)
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    pk, pp = torch.zeros(3, device=device), torch.zeros(3, device=device)
    step = volume.make_route_step(model, d, kind, dz_ratio=0.5)
    cuda_volume.KERNEL.reset_launches()
    cuda_volume_tiled.KERNEL.reset_launches()
    for i in range(3):
        got = step(got, pk, i)
        want = cuda_volume.plain_volume_step(model, want, pp, i,
                                             dz_ratio=0.5)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)
    if kind == "tiled":
        assert cuda_volume_tiled.KERNEL.launches == 3
    else:
        assert cuda_volume.KERNEL.launches == (
            {"slow": 3, "frozen": 12} if skip else {"slow": 15, "frozen": 0})


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dhw", [(3, 40, 48), (8, 64, 96), (19, 40, 70),
                                 (32, 40, 48), (37, 67, 131)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tiled_volume_kernel_at_any_depth(device, dhw, skip):
    """The z-streaming kernel takes any depth: the shallowest, the main
    one, past the old kernel's 18 slices, and ragged in every axis; two
    outer steps against the plain version, all planes and the probe."""
    d, h, w = dhw
    model = BeelerReuter(CFG.replace(height=h, width=w, skip=skip))
    base = _volume_state(model, d, device)
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    pk, pp = torch.zeros(2, device=device), torch.zeros(2, device=device)
    step = cuda_volume_tiled.make_tiled_volume_step(model, d)
    cuda_volume_tiled.KERNEL.reset_launches()
    for i in range(2):
        got = step(got, pk, i)
        want = cuda_volume.plain_volume_step(model, want, pp, i)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)
    assert cuda_volume_tiled.KERNEL.launches == 2


def test_volume_kernel_rejects_bad_planes(device):
    model = BeelerReuter(CFG)
    st = _volume_state(model, 4, device)
    st["h"] = st["m"]
    with pytest.raises(ValueError, match="share memory"):
        cuda_volume.volume_substep(model, st, True)


@pytest.mark.parametrize("cutover_mb", [32.0, 0.01])
def test_run_volume_routes_and_matches_plain_run(device, cutover_mb,
                                                 monkeypatch):
    monkeypatch.setattr(volume, "VOLUME_KERNEL_STATE_MB_MAX", cutover_mb)
    model = BeelerReuter(CFG)
    events = [VolumeEvent(step=6, loc="ruq")]
    ref = run_volume(model, 4, 10, events=events, kernel="xla",
                     device=device)
    cuda_volume.KERNEL.reset_launches()
    cuda_volume_tiled.KERNEL.reset_launches()
    got = run_volume(model, 4, 10, events=events, device=device)
    if cutover_mb > 1:
        assert cuda_volume.KERNEL.launches == {"slow": 10, "frozen": 40}
        assert cuda_volume_tiled.KERNEL.launches == 0
    else:
        assert cuda_volume.KERNEL.launches == {"slow": 0, "frozen": 0}
        assert cuda_volume_tiled.KERNEL.launches == 10
    np.testing.assert_allclose(got[0]["V"], ref[0]["V"], atol=0.12, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-3, rtol=0)
    assert got[1][6] == ref[1][6] == 1.0


# -- the per-shard block kernels and the sharded paths ---------------------------------


def _extended(st, r0, r1, c0, c1, device):
    """The window [r0, r1) x [c0, c1) of a host state, wrapped round the
    domain's edges like the first exchange, as device planes."""
    out = {}
    for k, v in st.items():
        rows = np.arange(r0, r1) % v.shape[0]
        cols = np.arange(c0, c1) % v.shape[1]
        out[k] = torch.tensor(v[np.ix_(rows, cols)], device=device)
    return out


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("origin", [(0, 0), (40, 0), (96, 0), (0, None),
                                    (67, None), (96, None), (64, 80),
                                    (5, 3), (0, 40)],
                         ids=lambda o: f"r{o[0]}c{o[1]}")
def test_block_kernel_matches_plain_version(device, origin, skip):
    """A 32-row (x 50-column) shard block of a 128x130 domain, at the
    domain's edges, corners and interior; column origin None = 1D mesh."""
    model = BeelerReuter(CFG.replace(height=128, width=130, skip=skip))
    k = model.dt_per_step
    rng = np.random.RandomState(2)
    st = model.initial_state()
    st["V"] = st["V"] + rng.normal(0, 3.0, st["V"].shape).astype(np.float32)
    two_d = origin[1] is not None
    r0, c0 = origin[0] - k, (origin[1] - k if two_d else 0)
    r1, c1 = origin[0] + 32 + k, (origin[1] + 50 + k if two_d else 130)
    cur = _extended(st, r0, r1, c0, c1, device)
    got_out = {kk: torch.zeros_like(v) for kk, v in cur.items()}
    want_out = {kk: torch.zeros_like(v) for kk, v in cur.items()}
    owns = origin[0] <= 20 < origin[0] + 32 and (
        not two_d or origin[1] <= 65 < origin[1] + 50)
    pk = torch.zeros(1, device=device) if owns else None
    pp = torch.zeros(1, device=device) if owns else None
    before = cuda_block.KERNEL.launches
    cuda_block.make_block_step(model, two_d)(cur, got_out, r0, c0, pk, 0)
    cuda_block.plain_block_step(model, cur, want_out, r0, c0, two_d, pp, 0)
    assert cuda_block.KERNEL.launches - before == 1
    for kk in want_out:
        torch.testing.assert_close(got_out[kk], want_out[kk], rtol=1e-3,
                                   atol=1e-5)
        # only the centre is written
        assert float(got_out[kk][:k].abs().max()) == 0.0
    if owns:
        torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("h_own,w_own,origin", [
    (512, None, (512, 0)), (1024, 1024, (1024, 1024)), (67, 131, (700, 900))],
    ids=["4x1-interior", "2x2-corner", "67x131"])
def test_block_kernel_on_blocks_of_2048(device, h_own, w_own, origin):
    """Shards of the 2048^2 domain: a 512-row shard of a 4x1 mesh (10 row
    tiles of 52 and 51 rows), the corner shard of a 2x2 mesh (ext_w 1034,
    edge and clamp-free tiles in one launch), and a 67 x 131 block whose
    rows and columns split unevenly."""
    model = BeelerReuter(CFG.replace(height=2048, width=2048))
    k = model.dt_per_step
    rng = np.random.RandomState(6)
    st = model.initial_state()
    st["V"] = st["V"] + rng.normal(0, 3.0, st["V"].shape).astype(np.float32)
    two_d = w_own is not None
    r0, c0 = origin[0] - k, (origin[1] - k if two_d else 0)
    r1, c1 = origin[0] + h_own + k, (origin[1] + w_own + k if two_d
                                     else 2048)
    cur = _extended(st, r0, r1, c0, c1, device)
    got_out = {kk: torch.zeros_like(v) for kk, v in cur.items()}
    want_out = {kk: torch.zeros_like(v) for kk, v in cur.items()}
    before = cuda_block.KERNEL.launches
    cuda_block.make_block_step(model, two_d)(cur, got_out, r0, c0)
    cuda_block.plain_block_step(model, cur, want_out, r0, c0, two_d)
    assert cuda_block.KERNEL.launches - before == 1
    for kk in want_out:
        torch.testing.assert_close(got_out[kk], want_out[kk], rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("skip,substeps", [(True, None), (False, None),
                                           (False, 1)])
@pytest.mark.parametrize("zstart", [-5, 3, 11], ids=lambda z: f"z{z}")
@pytest.mark.parametrize("dz_ratio", [1.0, 0.5])
def test_volume_block_kernel_matches_plain_version(device, zstart, skip,
                                                   substeps, dz_ratio):
    """A 6-slice shard (16 slices with its ghosts; 8 with `substeps=1`) of
    a 22-slice volume: the top shard, an interior one and the bottom
    one."""
    n = 5 if substeps is None else substeps
    zstart = zstart + 5 - n
    model = BeelerReuter(CFG.replace(height=40, width=67, skip=skip))
    full = volume_state(model, 22)
    rng = np.random.RandomState(3)
    full["V"] = full["V"] + rng.normal(0, 3.0, full["V"].shape).astype(
        np.float32)
    ext_d = 6 + 2 * n
    zs = np.arange(zstart, zstart + ext_d) % 22
    base = {k: torch.tensor(v[zs], device=device) for k, v in full.items()}
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    probe_slice = n + 2
    pk, pp = torch.zeros(1, device=device), torch.zeros(1, device=device)
    cuda_volume_block.KERNEL.reset_launches()
    step = cuda_volume_block.make_volume_block_step(model, ext_d, 22,
                                                    dz_ratio, substeps)
    got, _ = step(got, torch.empty_like(got["V"]), zstart, pk, 0, probe_slice)
    cuda_volume_block.plain_volume_block_step(
        model, want, zstart, 22, dz_ratio, substeps, pp, 0, probe_slice)
    for k in want:
        torch.testing.assert_close(got[k][n:-n], want[k][n:-n], rtol=1e-3,
                                   atol=1e-5)
    torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)
    assert cuda_volume_block.KERNEL.launches == (
        {"slow": 1, "frozen": 4} if skip else {"slow": n, "frozen": 0})


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4x1", "2x2"])
def test_sharded_simulate_launches_block_kernel(device, shape):
    """Four shards on one card: the block kernel once per shard per outer
    step and no other kernel, equal to the unsharded tiled run."""
    cfg = CFG.replace(height=64, width=96, duration=20)
    mesh = make_mesh(shape=shape, devices=[device] * 4)
    ref = Simulation(BeelerReuter(cfg.replace(kernel="xla")),
                     device=device).define().simulate()
    sim = Simulation(BeelerReuter(cfg), mesh=mesh, wide_halo=True).define()
    assert sim.route == "block"
    for kern in (cuda_block.KERNEL, cuda_step.KERNEL, cuda_tiled.KERNEL):
        kern.reset_launches()
    res = sim.simulate()
    assert cuda_block.KERNEL.launches == 4 * res.steps
    assert cuda_tiled.KERNEL.launches == 0
    assert cuda_step.KERNEL.launches == {"slow": 0, "frozen": 0}
    np.testing.assert_allclose(res.state["V"], ref.state["V"], atol=0.12,
                               rtol=0)
    np.testing.assert_allclose(res.probes["v"], ref.probes["v"], atol=1e-3,
                               rtol=0)
    tiled = cuda_tiled.make_tiled_cuda_step(BeelerReuter(cfg))
    st = interop.state_from_numpy(BeelerReuter(cfg).initial_state(), device)
    for _ in range(res.steps):
        st = tiled(st)
    # the per-cell code is the tiled kernel's; only the tiling differs
    for k, v in interop.state_to_numpy(st).items():
        np.testing.assert_allclose(res.state[k], v, rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("skip,halo_k", [(True, None), (False, None),
                                         (False, 1)])
def test_sharded_run_volume_launches_block_kernel(device, skip, halo_k):
    model = BeelerReuter(CFG.replace(height=40, width=67, skip=skip))
    mesh = make_mesh(devices=[device] * 4)
    events = [VolumeEvent(step=6, loc="ruq", z1=12)]
    ref = run_volume(model, 24, 10, events=events, dz_ratio=0.5,
                     kernel="xla", device=device)
    cuda_volume_block.KERNEL.reset_launches()
    cuda_volume.KERNEL.reset_launches()
    got = run_volume(model, 24, 10, events=events, dz_ratio=0.5, mesh=mesh,
                     wide_halo=True, halo_k=halo_k)
    assert cuda_volume_block.KERNEL.launches == (
        {"slow": 40, "frozen": 160} if skip else {"slow": 200, "frozen": 0})
    assert cuda_volume.KERNEL.launches == {"slow": 0, "frozen": 0}
    np.testing.assert_allclose(got[0]["V"], ref[0]["V"], atol=0.12, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-3, rtol=0)


# -- Fenton and Mitchell-Schaeffer on kernels 1-4 -------------------------------------

SMALL = {"fenton": (Fenton4v, dict(u=1.0, v=1.0, w=1.0, s=0.6)),
         "ms": (MitchellSchaeffer, dict(u=1.0, h=1.0))}


def _small(name, **kw):
    return SMALL[name][0](CFG.replace(diff=1.5, **kw))


def _small_state(name, shape, seed):
    """Every plane drawn per cell (host numpy): the border differs from
    its neighbours, so a body that took v0 for the raw centre fails."""
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(0.0, hi, shape).astype(np.float32)
            for k, hi in SMALL[name][1].items()}


def _two_steps(step, plain, base):
    """Two outer steps of `step` and of `plain` from `base`: every plane
    and the probe within rtol 1e-3 / atol 1e-5."""
    dev = next(iter(base.values())).device
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    pk, pp = torch.zeros(2, device=dev), torch.zeros(2, device=dev)
    for i in range(2):
        got = step(got, pk, i)
        want = plain(want, pp, i)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("hw", [(67, 131), (160, 160)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_small_model_substep_and_tiled_kernels(device, name, hw):
    """Kernel 1 (ten launches per outer step) and kernel 2 (one launch,
    ten substeps: 44 x 44 tile interiors) against the plain step."""
    model = _small(name, height=hw[0], width=hw[1])
    base = interop.state_from_numpy(_small_state(name, hw, 3), device)
    plain = lambda st, p, i: cuda_step.plain_step(model, st, p, i)
    sub, til = cuda_step.KERNELS[name], cuda_tiled.KERNELS[name]
    sub.reset_launches()
    til.reset_launches()
    _two_steps(cuda_step.make_cuda_step(model), plain, base)
    _two_steps(cuda_tiled.make_tiled_cuda_step(model), plain, base)
    assert sub.launches == {"slow": 20, "frozen": 0}
    assert til.launches == 2


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("origin", [(0, None), (60, None), (120, None),
                                    (0, 0), (60, 70)],
                         ids=lambda o: f"r{o[0]}c{o[1]}")
def test_small_model_block_kernel(device, name, origin):
    """A 40-row (x 50-column) shard of a 160x160 domain extended by K = 10
    ghost rows (and columns): kernel 3 against the plain block step."""
    model = _small(name, height=160, width=160)
    k = model.dt_per_step
    st = _small_state(name, (160, 160), 4)
    two_d = origin[1] is not None
    r0, c0 = origin[0] - k, (origin[1] - k if two_d else 0)
    r1, c1 = origin[0] + 40 + k, (origin[1] + 50 + k if two_d else 160)
    cur = _extended(st, r0, r1, c0, c1, device)
    got_out = {kk: torch.zeros_like(v) for kk, v in cur.items()}
    want_out = {kk: torch.zeros_like(v) for kk, v in cur.items()}
    owns = origin[0] <= 20 < origin[0] + 40 and (
        not two_d or origin[1] <= 80 < origin[1] + 50)
    pk = torch.zeros(1, device=device) if owns else None
    pp = torch.zeros(1, device=device) if owns else None
    kernel = cuda_block.KERNELS[name]
    before = kernel.launches
    cuda_block.make_block_step(model, two_d)(cur, got_out, r0, c0, pk, 0)
    cuda_block.plain_block_step(model, cur, want_out, r0, c0, two_d, pp, 0)
    assert kernel.launches - before == 1
    for kk in want_out:
        torch.testing.assert_close(got_out[kk], want_out[kk], rtol=1e-3,
                                   atol=1e-5)
        assert float(got_out[kk][:k].abs().max()) == 0.0
    if owns:
        torch.testing.assert_close(pk, pp, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("dhw", [(5, 67, 131), (3, 24, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_small_model_volume_kernel(device, name, dhw):
    """Kernel 4, ten launches per outer step, against the plain volume
    step (dt 0.05: the 3D limit at diff 1.5 is 0.083)."""
    model = _small(name, height=dhw[1], width=dhw[2], dt=0.05)
    base = interop.state_from_numpy(_small_state(name, dhw, 5), device)
    kernel = cuda_volume.KERNELS[name]
    kernel.reset_launches()
    _two_steps(cuda_volume.make_volume_step(model, dhw[0], 0.5),
               lambda st, p, i: cuda_volume.plain_volume_step(
                   model, st, p, i, dz_ratio=0.5), base)
    assert kernel.launches == {"slow": 20, "frozen": 0}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_model_simulate_routes(device, name, monkeypatch):
    """simulate() on the card: the substep kernel ten launches per outer
    step, the tiled kernel (cutover lowered) once, the block kernel once
    per shard, each within 1e-3 of kernel='xla'; kernel 5 raises, kernel
    6 runs the sharded volume bit-equal to kernel 4's unsharded run."""
    cfg = CFG.replace(diff=1.5, height=64, width=96, duration=20)
    ref = Simulation(_small(name, height=64, width=96, duration=20,
                            kernel="xla"), device=device).define().simulate()
    sub, til, blk = (cuda_step.KERNELS[name], cuda_tiled.KERNELS[name],
                     cuda_block.KERNELS[name])
    runs = {}
    for how in ("substep", "tiled", "block"):
        for kern in (sub, til, blk):
            kern.reset_launches()
        if how == "block":
            sim = Simulation(SMALL[name][0](cfg), mesh=make_mesh(
                devices=[device] * 4), wide_halo=True).define()
        else:
            if how == "tiled":
                monkeypatch.setattr(Simulation, "WHOLE_GRID_STATE_MB_MAX", 0)
            sim = Simulation(SMALL[name][0](cfg), device=device).define()
        assert sim.route == how
        for kern in (sub, til, blk):
            kern.reset_launches()
        res = runs[how] = sim.simulate()
        assert sub.launches == {"slow": 10 * res.steps if how == "substep"
                                else 0, "frozen": 0}
        assert til.launches == (res.steps if how == "tiled" else 0)
        assert blk.launches == (4 * res.steps if how == "block" else 0)
        np.testing.assert_allclose(res.state["u"], ref.state["u"],
                                   atol=1e-3, rtol=0)
        assert res.cycle_lengths == ref.cycle_lengths
    # kernels 2 and 3 share the tile skeleton and the cell body
    for k in runs["tiled"].state:
        np.testing.assert_array_equal(runs["block"].state[k],
                                      runs["tiled"].state[k])
    model = SMALL[name][0](cfg.replace(dt=0.05))
    sharded = run_volume(model, 24, 2, mesh=make_mesh(devices=[device] * 2),
                         wide_halo=True)
    whole = run_volume(model, 24, 2, device=device)
    for k in whole[0]:
        np.testing.assert_array_equal(sharded[0][k], whole[0][k])
    monkeypatch.setattr(volume, "VOLUME_KERNEL_STATE_MB_MAX", 0.0)
    with pytest.raises(NotImplementedError, match="Queue 2 item D"):
        run_volume(model, 24, 2, device=device)


# -- 2D geometry: the GEOM entries of kernels 1-3 ---------------------------------------

GEOM_BODIES = {
    "br": (BeelerReuter, dict(diff=0.809, cheby=True, skip=True)),
    "br_variant": (BeelerReuter, dict(diff=0.809, cheby=False, skip=False)),
    "br_variant_ab2": (BeelerReuter, dict(diff=0.809, skip=True, ab2=True)),
    "fenton": (Fenton4v, dict(diff=1.5)),
    "fenton_ab2": (Fenton4v, dict(diff=1.5, dt=0.025, ab2=True)),
    "ms": (MitchellSchaeffer, dict(diff=1.5)),
}


def _geom_model(name, hw):
    cls, kw = GEOM_BODIES[name]
    return cls(CFG.replace(height=hw[0], width=hw[1], **kw))


def _geom_state(model, device, seed):
    """The initial state, its potential raised per cell from a seed, the
    ab2 derivatives bootstrapped."""
    rng = np.random.RandomState(seed)
    st = model.initial_state()
    key = model.pot_key
    shape = st[key].shape
    st[key] = st[key] + (rng.normal(0, 1.0, shape) if key == "V"
                         else rng.uniform(0, 0.02, shape)).astype(np.float32)
    if model.cfg.ab2:
        st = model.bootstrap_ab2({k: v for k, v in st.items()
                                  if not k.startswith("_")})
    return interop.state_from_numpy(st, device)


def _geometry(kind, hw):
    """(phase, fiber, dmap): (a) br_spiral's hole scaled and a neg=True rim
    (phi != 1 at the border), (b) with fibrosis, (c) with fibers at 30
    degrees, ratio 0.25."""
    from fib_tf_tpu_torch.ops import stencil
    h, w = hw
    phase = stencil.add_hole_to_phase_field(
        None, h, w, w * 150 // 512, h * 200 // 512, max(w * 40 // 512, 4))
    phase = stencil.add_hole_to_phase_field(phase, h, w, w / 2, h / 2,
                                            min(h, w) / 2 + 10, neg=True)
    dmap = stencil.fibrosis_map(h, w, 0.25, 0.8, 0) if kind in "bc" else None
    fiber = (stencil.fiber_tensor(np.deg2rad(30.0), 0.25) if kind == "c"
             else None)
    return phase, fiber, dmap


def _geom_two_steps(step, plain, base, exact=False):
    """`_two_steps`, with the AB2 derivative planes at atol 1e-5 / (0.5 dt)
    = 2e-4 at dt 0.1: they enter the next substep as 0.5 dt f_prev
    (chip_smoke.py DERIVATIVE_ATOL); with `exact`, every plane and the
    probe bit for bit."""
    dev = next(iter(base.values())).device
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    pk, pp = torch.zeros(2, device=dev), torch.zeros(2, device=dev)
    for i in range(2):
        got = step(got, pk, i)
        want = plain(want, pp, i)
    rtol = 0.0 if exact else 1e-3
    for k in want:
        atol = 0.0 if exact else 2e-4 if k.startswith("_d") else 1e-5
        torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=atol)
    torch.testing.assert_close(pk, pp, rtol=rtol, atol=0.0 if exact else 1e-5)


@pytest.mark.parametrize("kind", ["a", "b", "c"])
@pytest.mark.parametrize("name", sorted(GEOM_BODIES))
def test_geometry_kernels_match_plain_version(device, name, kind):
    """Kernels 1 and 2's GEOM entries at 67x131 against the plain step
    under the same geometry, two outer steps; only the GEOM entries
    launch."""
    hw = (67, 131)
    model = _geom_model(name, hw)
    phase, fiber, dmap = _geometry(kind, hw)
    base = _geom_state(model, device, 7)
    geom = bodies.GeometryMaps(hw, phase, fiber, dmap).plain(device)
    plain = lambda st, p, i: cuda_step.plain_step(model, st, p, i, geom)
    kernels = [cuda_step.KERNELS[name], cuda_step.GEOM_KERNELS[name],
               cuda_tiled.KERNELS[name], cuda_tiled.GEOM_KERNELS[name]]
    for kern in kernels:
        kern.reset_launches()
    _geom_two_steps(cuda_step.make_cuda_step(model, phase, fiber, dmap),
                    plain, base)
    _geom_two_steps(cuda_tiled.make_tiled_cuda_step(model, phase, fiber,
                                                    dmap), plain, base)
    n = 2 * len(model.launch_schedule)
    assert sum(kernels[1].launches.values()) == n
    assert sum(kernels[0].launches.values()) == 0
    assert kernels[3].launches == 2 and kernels[2].launches == 0


@pytest.mark.parametrize("kind", ["a", "c"])
@pytest.mark.parametrize("origin", [(0, None), (60, None), (120, None),
                                    (0, 0), (60, 70)],
                         ids=lambda o: f"r{o[0]}c{o[1]}")
@pytest.mark.parametrize("name", ["br", "fenton", "ms"])
def test_geometry_block_kernel_matches_plain_version(device, name, origin,
                                                     kind):
    """Kernel 3's GEOM entry on a 40-row (x 50-column) shard of 160x160,
    its maps extended like the block, against the plain block step."""
    hw = (160, 160)
    model = _geom_model(name, hw)
    k = model.dt_per_step
    phase, fiber, dmap = _geometry(kind, hw)
    st = {kk: v.cpu().numpy() for kk, v in
          _geom_state(model, "cpu", 8).items()}
    two_d = origin[1] is not None
    r0, c0 = origin[0] - k, (origin[1] - k if two_d else 0)
    r1, c1 = origin[0] + 40 + k, (origin[1] + 50 + k if two_d else 160)
    cur = _extended(st, r0, r1, c0, c1, device)
    maps = _extended({"p": phase, **({"d": dmap} if dmap is not None
                                     else {})}, r0, r1, c0, c1, device)
    got_out = {kk: torch.zeros_like(v) for kk, v in cur.items()}
    want_out = {kk: torch.zeros_like(v) for kk, v in cur.items()}
    kernel = cuda_block.GEOM_KERNELS[name]
    before = kernel.launches
    cuda_block.make_block_step(model, two_d, fiber)(
        cur, got_out, r0, c0, phase_ext=maps["p"], dmap_ext=maps.get("d"))
    cuda_block.plain_block_step(model, cur, want_out, r0, c0, two_d, None, 0,
                                maps["p"], fiber, maps.get("d"))
    assert kernel.launches - before == 1
    for kk in want_out:
        torch.testing.assert_close(got_out[kk], want_out[kk], rtol=1e-3,
                                   atol=1e-5)


def test_geometry_simulate_routes(device, monkeypatch):
    """simulate() with a hole, fibrosis and fibers: the substep route
    launches kernel 1's GEOM entry 5 times per outer step, the tiled route
    kernel 2's once, a 2x2 mesh of four shards on the card kernel 3's four
    times, bit-equal to the tiled run; each within 0.12 mV of
    kernel='xla' and crossing with it."""
    cfg = CFG.replace(height=64, width=96, duration=30,
                      fiber_angle=np.deg2rad(30.0), fiber_ratio=0.25)
    phase, _, dmap = _geometry("b", (64, 96))

    def run(c, **kw):
        sim = Simulation(BeelerReuter(c), **kw)
        sim.phase = phase
        sim.set_diffusion_map(dmap)
        sim.define()
        return sim, sim.simulate()

    _, ref = run(cfg.replace(kernel="xla"), device=device)
    kernels = [cuda_step.GEOM_KERNELS["br"], cuda_tiled.GEOM_KERNELS["br"],
               cuda_block.GEOM_KERNELS["br"], cuda_step.KERNELS["br"],
               cuda_tiled.KERNELS["br"], cuda_block.KERNELS["br"]]
    runs = {}
    for how in ("substep", "tiled", "block"):
        if how == "tiled":
            monkeypatch.setattr(Simulation, "WHOLE_GRID_STATE_MB_MAX", 0)
        kw = (dict(mesh=make_mesh(shape=(2, 2), devices=[device] * 4),
                   wide_halo=True) if how == "block" else dict(device=device))
        for kern in kernels:
            kern.reset_launches()
        sim, res = run(cfg, **kw)
        assert sim.route == how
        counts = [sum(k.launches.values()) if isinstance(k.launches, dict)
                  else k.launches for k in kernels]
        want = {"substep": 5, "tiled": 1, "block": 4}[how] * (res.steps + 1)
        assert counts == [want if i == ("substep", "tiled", "block").index(
            how) else 0 for i in range(6)], counts
        np.testing.assert_allclose(res.state["V"], ref.state["V"],
                                   atol=0.12, rtol=0)
        assert res.cycle_lengths == ref.cycle_lengths
        runs[how] = res
    for k in runs["tiled"].state:
        np.testing.assert_array_equal(runs["block"].state[k],
                                      runs["tiled"].state[k])


# -- Courtemanche and Courtemanche-ultra: kernels 1 and 4 -------------------------------

COURT_FLAGS = {"direct": {}, "cheby": dict(court_cheby=True),
               "unfolded": dict(court_cheby=True, cheby_fold=False),
               # healthy tissue, a dV cap the upstroke meets and a factor
               # on each of the 13 channels (every scale slot of the
               # parameter block, and the kernel's clip)
               "blocked": dict(chronic=False, dv_max=2.0, g_scale=(
                   ("g_Na", 0.9), ("g_CaL", 0.7), ("g_Kr", 1.3),
                   ("g_Ks", 1.1), ("g_to", 0.6), ("g_Kur", 0.5),
                   ("g_K1", 1.2), ("g_NaK", 0.95), ("g_NaCa", 1.15),
                   ("g_pCa", 0.85), ("g_bNa", 1.05), ("g_bCa", 0.9),
                   ("g_bK", 2.0)))}


def _court_state(model, device, depth=None):
    """The initial state with V raised per cell from a seed and 12 plain
    outer steps, so that the S1 front has left its stripe."""
    rng = np.random.RandomState(1)
    st = model.initial_state()
    st["V"] = st["V"] + rng.normal(0, 1.0, st["V"].shape).astype(np.float32)
    if depth is not None:
        st = {k: np.repeat(v[None], depth, axis=0) for k, v in st.items()}
    s = interop.state_from_numpy(st, device)
    plain = (cuda_step.plain_step if depth is None
             else cuda_volume.plain_volume_step)
    for _ in range(12):
        plain(model, s)
    return s


@pytest.mark.parametrize("ultra", [False, True], ids=["court", "ultra"])
@pytest.mark.parametrize("flags", sorted(COURT_FLAGS))
def test_court_kernels_match_plain_version(device, flags, ultra):
    """Kernel 1 (isotropic, and GEOM with the annulus of
    examples/court_run.py and a regional chronic plane) and kernel 4 at
    67x131 (4x67x131), two outer steps; the direct rates bit for bit
    (csrc/court_cell.cuh rounds as the plain path does, -fmad=false);
    exact launches: eleven per outer step for Courtemanche (one SLOW=true
    slow commit, nine fast commits that read the cache on kernel 1), ten
    for ultra (none cached); no other binding of kernel 1 reads a cache."""
    from fib_tf_tpu_torch.ops import stencil
    cls = CourtemancheUltra if ultra else Courtemanche
    model = cls(CFG.replace(height=67, width=131, **COURT_FLAGS[flags]))
    plane = np.zeros((67, 131), np.float32)
    plane[:, :65] = 1.0
    het = cls(model.cfg).set_het(chronic=plane)
    phase = stencil.add_hole_to_phase_field(None, 67, 131, 65, 33, 4)
    phase = stencil.add_hole_to_phase_field(phase, 67, 131, 65, 33, 27,
                                            neg=True)
    name = bodies.cell_body(model).name
    exact = model.rate_mode == "direct"
    per_step = ({"slow": 10, "frozen": 0} if ultra
                else {"slow": 1, "frozen": 10})
    cached_per_step = 0 if ultra else 9
    bindings = [*cuda_step.KERNELS.values(),
                *cuda_step.GEOM_KERNELS.values()]
    for m, geo, kernels in ((model, {}, cuda_step.KERNELS),
                            (het, {}, cuda_step.KERNELS),
                            (model, dict(phase=phase),
                             cuda_step.GEOM_KERNELS)):
        maps = bodies.GeometryMaps(m.state_shape(), **geo)
        geom = maps.plain(device)
        for kern in bindings:
            kern.reset_launches()
        _geom_two_steps(cuda_step.make_cuda_step(m, **geo),
                        lambda s, p, i: cuda_step.plain_step(m, s, p, i,
                                                             geom),
                        _court_state(m, device), exact)
        assert kernels[name].launches == {k: 2 * v
                                          for k, v in per_step.items()}
        assert kernels[name].cached_launches == 2 * cached_per_step
        assert sum(k.cached_launches for k in bindings) == (
            2 * cached_per_step)
    kernel = cuda_volume.KERNELS[name]
    kernel.reset_launches()
    _geom_two_steps(cuda_volume.make_volume_step(model, 4),
                    lambda s, p, i: cuda_volume.plain_volume_step(
                        model, s, p, i),
                    _court_state(model, device, depth=4), exact)
    assert kernel.launches == {k: 2 * v for k, v in per_step.items()}


@pytest.mark.parametrize("geometry", [False, True], ids=["iso", "geom"])
def test_court_cache_crosses_no_outer_step(device, geometry):
    """Kernel 1's cache holds values for one outer step only: with the
    cache filled with NaN between two outer steps and an S2 fired there,
    the second step still equals the plain one bit for bit, and the state
    holds the model's planes alone."""
    from fib_tf_tpu_torch.ops import stencil
    model = Courtemanche(CFG.replace(height=67, width=131))
    geo = {}
    if geometry:
        geo["phase"] = stencil.add_hole_to_phase_field(None, 67, 131, 65,
                                                       33, 4)
    maps = bodies.GeometryMaps(model.state_shape(), **geo)
    geom = maps.plain(device)
    step = cuda_step.make_cuda_step(model, **geo)
    mask = torch.tensor(stencil.pace_mask(67, 131, "luq", 10.0,
                                          model.min_v), device=device)
    got = _court_state(model, device)
    want = {k: v.clone() for k, v in got.items()}
    for i in range(2):
        if i:
            kernels = cuda_step.GEOM_KERNELS if geometry else cuda_step.KERNELS
            kernels["court"].cache.planes(got["V"]).fill_(float("nan"))
            for st in (got, want):
                st["V"] = torch.maximum(st["V"], mask)
        got = step(got)
        want = cuda_step.plain_step(model, want, geom=geom)
        assert set(got) == set(model.state_keys())
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("geometry", [False, True], ids=["iso", "geom"])
def test_court_slow_commit_stores_the_cache(device, geometry):
    """Every slow commit of court on kernel 1 stores the cache (the model's
    `fast_invariants` of the planes it has just written, bit for bit), and
    a fast commit that reads it equals `plain_cached_substep`; the entry
    refuses a slow commit that would not store it (form 1)."""
    from fib_tf_tpu_torch.ops import stencil
    model = Courtemanche(CFG.replace(height=67, width=131))
    maps = bodies.GeometryMaps(model.state_shape(), phase=(
        stencil.add_hole_to_phase_field(None, 67, 131, 65, 33, 4)
        if geometry else None))
    geom = maps.plain(device)
    kernel = (cuda_step.GEOM_KERNELS if geometry
              else cuda_step.KERNELS)["court"]
    got = _court_state(model, device)
    want = {k: v.clone() for k, v in got.items()}
    got = cuda_step.substep(model, got, True, maps=maps)
    want = cuda_step.plain_substep(model, want, True, geom=geom)
    cache = kernel.cache.planes(got["V"])
    plain_cache = model.fast_invariants(want)
    for i, k in enumerate(bodies.COURT_CACHE):
        torch.testing.assert_close(cache[i], plain_cache[k], rtol=0, atol=0)
    kernel.launch(bodies.pack_params(model), got, False, None,
                  model.probe_pixel, 0,
                  torch.cuda.current_stream(device).cuda_stream,
                  maps.args(device) if geometry else (), True)
    cuda_step.plain_cached_substep(model, want, plain_cache, geom=geom)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    fn = getattr(kernel.library(), kernel.entry)
    params = bodies.pack_params(model)
    v_in = got["V"]
    err = fn(1, params.ctypes.data, params.size, v_in.data_ptr(), None,
             bodies.plane_pointers(got, kernel.body.planes),
             len(kernel.body.planes), 67, 131, None, 0, 0, 0,
             v_in.device.index, torch.cuda.current_stream(device).cuda_stream,
             *(maps.args(device) if geometry else ()))
    assert err == 1  # cudaErrorInvalidValue


def test_court_auto_launches_kernels_1_and_4(device):
    """kernel='auto' without a table: Simulation launches kernel 1 (no
    other kernel) and run_volume kernel 4; table mode launches none."""
    cfg = CFG.replace(duration=5)
    for kernels in (cuda_step.KERNELS, cuda_volume.KERNELS):
        kernels["court"].reset_launches()
    sim = Simulation(Courtemanche(cfg), device=device).define()
    assert sim.route == "substep"
    cuda_step.KERNELS["court"].reset_launches()
    res = sim.simulate()
    assert cuda_step.KERNELS["court"].launches == {"slow": res.steps,
                                                   "frozen": 10 * res.steps}
    assert cuda_step.KERNELS["court"].cached_launches == 9 * res.steps
    assert res.probes["trend"].shape == (res.steps, 2)
    run_volume(Courtemanche(cfg.replace(dt=0.05)), 4, 3, device=device)
    assert cuda_volume.KERNELS["court"].launches == {"slow": 3,
                                                     "frozen": 30}
    before = dict(cuda_step.KERNELS["court"].launches)
    tab = Simulation(Courtemanche(cfg.replace(table=True)), device=device)
    assert tab.route == "plain"
    tab.define().simulate()
    assert cuda_step.KERNELS["court"].launches == before


# -- Luo-Rudy 1991 and ten Tusscher-Panfilov 2006: kernels 1 and 4 ------------------

LRTP_CFG = CFG.replace(height=67, width=131, dt=0.02, skip=False)
LRTP_SCALE = {"lr1": (("g_Na", 0.9), ("g_si", 0.5), ("g_K", 1.2),
                      ("g_K1", 1.1), ("g_Kp", 0.8), ("g_b", 1.3)),
              "tp06": tuple((k, 0.8 + 0.05 * i) for i, k in enumerate(
                  TenTusscher06.SCALE_PARAMS))}
# (model class, flags, g_si or cell_type set after construction, a g_kr
# plane): every form and het-plane subset the chip phases run
LRTP_CASES = {
    "lr1-skip": (LuoRudy91, dict(skip=True), None, False),
    "lr1": (LuoRudy91, {}, None, False),
    "lr1-gsi-scaled": (LuoRudy91, dict(skip=True, g_scale=LRTP_SCALE["lr1"]),
                       0.02, False),
    "tp06-epi-skip": (TenTusscher06, dict(skip=True), None, False),
    "tp06-endo": (TenTusscher06, dict(cell_type="endo"), None, False),
    "tp06-m-after-skip": (TenTusscher06, dict(skip=True), "m", False),
    "tp06-transmural-skip": (TenTusscher06, dict(
        cell_type="transmural", skip=True), None, False),
    "tp06-g_kr": (TenTusscher06, {}, None, True),
    "tp06-transmural-g_kr-scaled": (TenTusscher06, dict(
        cell_type="transmural", g_scale=LRTP_SCALE["tp06"]), None, True),
}


def _lrtp_model(case):
    cls, flags, after, kr = LRTP_CASES[case]
    model = cls(LRTP_CFG.replace(**flags))
    if after is not None:
        setattr(model, "g_si" if cls is LuoRudy91 else "cell_type", after)
    if kr:
        model.set_het(g_kr=np.random.RandomState(3).uniform(
            0.2, 1.0, model.state_shape()).astype(np.float32))
    return model


def _lrtp_state(model, device, depth=None):
    """The initial state with V raised per cell from a seed and 20 plain
    outer steps (4 ms), so that the S1 front has left its stripe."""
    rng = np.random.RandomState(1)
    st = model.initial_state()
    st["V"] = st["V"] + rng.normal(0, 1.0, st["V"].shape).astype(np.float32)
    if depth is not None:
        st = {k: np.repeat(v[None], depth, axis=0) for k, v in st.items()}
    s = interop.state_from_numpy(st, device)
    plain = (cuda_step.plain_step if depth is None
             else cuda_volume.plain_volume_step)
    for _ in range(20):
        plain(model, s)
    return s


@pytest.mark.parametrize("case", sorted(LRTP_CASES))
def test_lrtp_kernels_match_plain_version(device, case):
    """Kernel 1 (isotropic, and GEOM under an annulus with fibers) and
    kernel 4 at 67x131 (4x67x131): one launch of each form and two outer
    steps equal to the plain version bit for bit (csrc/lr1_cell.cuh and
    tp06_cell.cuh round as the plain path does, -fmad=false), and so
    within rtol 1e-3 / atol 1e-5; exact launches (one SLOW and nine frozen
    per outer step under skip, ten SLOW without)."""
    from fib_tf_tpu_torch.ops import stencil
    model = _lrtp_model(case)
    name = bodies.cell_body(model).name
    phase = stencil.add_hole_to_phase_field(None, 67, 131, 65, 33, 4)
    phase = stencil.add_hole_to_phase_field(phase, 67, 131, 65, 33, 27,
                                            neg=True)
    fiber = stencil.fiber_tensor(np.deg2rad(30.0), 0.25)
    schedule = model.launch_schedule
    per_step = {"slow": sum(schedule),
                "frozen": len(schedule) - sum(schedule)}
    base = _lrtp_state(model, device)
    for geo, kernels in (({}, cuda_step.KERNELS),
                         (dict(phase=phase, fiber=fiber),
                          cuda_step.GEOM_KERNELS)):
        maps = bodies.GeometryMaps(model.state_shape(), **geo)
        geom = maps.plain(device)
        for slow in sorted(set(schedule)):
            got = cuda_step.substep(model, {k: v.clone()
                                            for k, v in base.items()},
                                    slow, maps=maps)
            want = cuda_step.plain_substep(model, {k: v.clone() for k, v
                                                   in base.items()}, slow,
                                           geom=geom)
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        kernels[name].reset_launches()
        _geom_two_steps(cuda_step.make_cuda_step(model, **geo),
                        lambda s, p, i: cuda_step.plain_step(model, s, p, i,
                                                             geom), base,
                        exact=True)
        assert kernels[name].launches == {k: 2 * v
                                          for k, v in per_step.items()}
    kernel = cuda_volume.KERNELS[name]
    vbase = _lrtp_state(model, device, depth=4)
    for slow in sorted(set(schedule)):
        got = cuda_volume.volume_substep(model, {k: v.clone() for k, v
                                                 in vbase.items()}, slow)
        want = cuda_volume.plain_volume_substep(model, {k: v.clone() for k, v
                                                        in vbase.items()},
                                                slow)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    kernel.reset_launches()
    _geom_two_steps(cuda_volume.make_volume_step(model, 4),
                    lambda s, p, i: cuda_volume.plain_volume_step(
                        model, s, p, i), vbase, exact=True)
    assert kernel.launches == {k: 2 * v for k, v in per_step.items()}


def test_lrtp_auto_launches_kernels_1_and_4(device):
    """kernel='auto': Simulation launches kernel 1 (no other kernel) and
    run_volume kernel 4, for both models."""
    for cls in (LuoRudy91, TenTusscher06):
        cfg = LRTP_CFG.replace(duration=2, skip=True)
        name = cls.name
        sim = Simulation(cls(cfg), device=device).define()
        assert sim.route == "substep"
        for kernels in (cuda_step.KERNELS, cuda_volume.KERNELS):
            kernels[name].reset_launches()
        res = sim.simulate()
        assert cuda_step.KERNELS[name].launches == {
            "slow": res.steps, "frozen": 9 * res.steps}
        run_volume(cls(cfg), 4, 3, device=device)
        assert cuda_volume.KERNELS[name].launches == {"slow": 3,
                                                      "frozen": 27}


# -- the large bodies on the sharded paths: kernels 3 and 6 --------------------------

# (model class, flags, a g_kr plane): every large body, both of LR1's and
# tp06's forms (skip), tp06 with all four het planes and Courtemanche with
# its chronic plane
LARGE_CASES = {
    "court": (Courtemanche, dict(dt=0.1), False),
    "court_ultra": (CourtemancheUltra, dict(dt=0.1), False),
    "lr1-skip": (LuoRudy91, dict(skip=True), False),
    "tp06-transmural-g_kr-skip": (TenTusscher06, dict(
        cell_type="transmural", skip=True), True),
}
LARGE_H, LARGE_W = 40, 48


def _large_model(case, **kw):
    cls, flags, kr = LARGE_CASES[case]
    model = cls(LRTP_CFG.replace(height=LARGE_H, width=LARGE_W,
                                 **dict(flags, **kw)))
    h, w = model.state_shape()
    if cls is Courtemanche:
        plane = np.zeros((h, w), np.float32)
        plane[:, :w // 2] = 1.0
        model.set_het(chronic=plane)
    if kr:
        model.set_het(g_kr=np.random.RandomState(3).uniform(
            0.2, 1.0, (h, w)).astype(np.float32))
    return model


@pytest.mark.parametrize("geometry", [False, True], ids=["iso", "geom"])
@pytest.mark.parametrize("origin", [(0, None), (10, None), (30, None),
                                    (0, 0), (20, 24)],
                         ids=lambda o: f"r{o[0]}c{o[1]}")
@pytest.mark.parametrize("case", sorted(LARGE_CASES))
def test_large_block_kernel_matches_plain_version(device, case, origin,
                                                  geometry):
    """csrc/large_block.cu: one outer step of one shard's extended block
    of a 40x48 domain (4x1: the top, an interior and the bottom shard of
    10 rows; 2x2: two 20x24 shards), isotropic and under an annulus with
    fibers, equal to plain_block_step bit for bit; one launch per commit;
    the input block is left as it was."""
    from fib_tf_tpu_torch.ops import stencil
    model = _large_model(case)
    k = model.dt_per_step
    two_d = origin[1] is not None
    h_own, w_own = (20, 24) if two_d else (10, LARGE_W)
    rstart = origin[0] - k
    cstart = origin[1] - k if two_d else 0
    ext_h, ext_w = cuda_block.block_shape(h_own, w_own, k, two_d)
    full = _lrtp_state(model, device)
    rows = torch.arange(rstart, rstart + ext_h, device=device) % LARGE_H
    cols = torch.arange(cstart, cstart + ext_w, device=device) % LARGE_W
    ext = {key: v[rows][:, cols].contiguous() for key, v in full.items()}
    fiber, maps = None, {}
    if geometry:
        phase = stencil.add_hole_to_phase_field(None, LARGE_H, LARGE_W, 24,
                                                20, 4)
        phase = stencil.add_hole_to_phase_field(phase, LARGE_H, LARGE_W, 24,
                                                20, 18, neg=True)
        fiber = stencil.fiber_tensor(np.deg2rad(30.0), 0.25)
        p = torch.tensor(phase, device=device)
        maps = dict(phase_ext=p[rows][:, cols].contiguous())
    r, c = model.probe_pixel
    owns = (rstart + k <= r < rstart + ext_h - k
            and (not two_d or cstart + k <= c < cstart + ext_w - k))
    before = {key: v.clone() for key, v in ext.items()}
    outs, probes = [], []
    name = bodies.cell_body(model).name
    kernel = (cuda_block.GEOM_KERNELS if geometry else cuda_block.KERNELS)[
        name]
    kernel.reset_launches()
    for step in (cuda_block.make_block_step(model, two_d, fiber),
                 lambda *a, **kw: cuda_block.plain_block_step(
                     model, a[0], a[1], a[2], a[3], two_d, kw["probe"], 0,
                     kw.get("phase_ext"), fiber)):
        out = {key: torch.zeros_like(v) for key, v in ext.items()}
        probe = torch.zeros(1, device=device)
        step(ext, out, rstart, cstart, probe=probe if owns else None,
             **maps)
        outs.append(out)
        probes.append(probe)
    torch.cuda.synchronize()
    schedule = model.launch_schedule
    assert kernel.launches == {"slow": sum(schedule),
                               "frozen": len(schedule) - sum(schedule)}
    for key in ext:
        got = cuda_block.centre(outs[0][key], k, two_d)
        want = cuda_block.centre(outs[1][key], k, two_d)
        assert bool(got.isfinite().all()), key
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(ext[key], before[key], rtol=0, atol=0)
    torch.testing.assert_close(probes[0], probes[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("zstart", [-10, 10, 20])
@pytest.mark.parametrize("case", sorted(LARGE_CASES))
def test_large_volume_block_kernel_matches_plain_version(device, case,
                                                         zstart):
    """csrc/br_volume_block.cu's large bodies: one group on a shard's
    30-slice block (10 slices and 10 ghost slices each way) of a 40x40x48
    volume, the top, the interior one that owns the probe and the bottom
    shard, equal to
    plain_volume_block_step bit for bit on the centre; Courtemanche's
    group is eleven launches."""
    model = _large_model(case, dt=0.05 if case.startswith("court")
                         else 0.02)
    k, depth = model.dt_per_step, 40
    base = _lrtp_state(model, device, depth=depth)
    idx = torch.arange(zstart, zstart + 30, device=device).clamp(0, depth - 1)
    block = {key: v[idx].contiguous() for key, v in base.items()}
    name = bodies.cell_body(model).name
    kernel = cuda_volume_block.KERNELS[name]
    kernel.reset_launches()
    got = {key: v.clone() for key, v in block.items()}
    spare = torch.empty_like(got[model.pot_key])
    probe = torch.zeros(1, device=device)
    owns = zstart + k <= depth // 2 < zstart + 30 - k
    got, _ = cuda_volume_block.make_volume_block_step(model, 30, depth)(
        got, spare, zstart, probe if owns else None, 0,
        depth // 2 - zstart)
    want = cuda_volume_block.plain_volume_block_step(
        model, {key: v.clone() for key, v in block.items()}, zstart, depth,
        probe=torch.zeros(1, device=device) if owns else None,
        probe_slice=depth // 2 - zstart)
    torch.cuda.synchronize()
    schedule = model.launch_schedule
    assert kernel.launches == {"slow": sum(schedule),
                               "frozen": len(schedule) - sum(schedule)}
    for key in want:
        torch.testing.assert_close(got[key][k:-k], want[key][k:-k], rtol=0,
                                   atol=0)


def test_large_models_auto_launch_kernels_3_and_6(device):
    """kernel='auto' on four shards of one card: Simulation launches the
    large block kernel (one launch per commit per shard, no other kernel)
    and equals the unsharded kernel-1 run bit for bit, probes included;
    run_volume on four z shards launches kernel 6 and equals kernel 4,
    Courtemanche-ultra's also in groups of five substeps (halo_k=5)."""
    for case in sorted(LARGE_CASES):
        model = _large_model(case, duration=1.0)
        name = bodies.cell_body(model).name
        sim = Simulation(model, mesh=make_mesh(devices=[device] * 4),
                         wide_halo=True).define()
        assert sim.route == "block"
        cuda_block.KERNELS[name].reset_launches()
        cuda_step.KERNELS[name].reset_launches()
        res = sim.simulate()
        schedule = model.launch_schedule
        assert cuda_block.KERNELS[name].launches == {
            "slow": 4 * res.steps * sum(schedule),
            "frozen": 4 * res.steps * (len(schedule) - sum(schedule))}
        assert cuda_step.KERNELS[name].launches == {"slow": 0, "frozen": 0}
        want = Simulation(_large_model(case, duration=1.0),
                          device=device).simulate()
        for key in want.state:
            np.testing.assert_array_equal(res.state[key], want.state[key])
        for key in want.probes:
            if key == "ultra":
                np.testing.assert_allclose(res.probes[key], want.probes[key],
                                           rtol=1e-5)
            else:
                np.testing.assert_array_equal(res.probes[key],
                                              want.probes[key])
        vmodel = _large_model(case, dt=0.05 if case.startswith("court")
                              else 0.02)
        cuda_volume_block.KERNELS[name].reset_launches()
        sharded = run_volume(vmodel, 40, 2, mesh=make_mesh(
            devices=[device] * 4), wide_halo=True)
        assert cuda_volume_block.KERNELS[name].launches == {
            "slow": 8 * sum(schedule),
            "frozen": 8 * (len(schedule) - sum(schedule))}
        whole = run_volume(vmodel, 40, 2, device=device)
        for key in whole[0]:
            np.testing.assert_array_equal(sharded[0][key], whole[0][key])
        np.testing.assert_array_equal(sharded[1], whole[1])
        if case == "court_ultra":
            # uniform substeps: groups of five, the pair of V buffers
            # swapped after each
            split = run_volume(vmodel, 40, 2, mesh=make_mesh(
                devices=[device] * 4), wide_halo=True, halo_k=5)
            for key in whole[0]:
                np.testing.assert_array_equal(split[0][key], whole[0][key])


def _launches_by_entry():
    """The launches every 2D binding has counted so far, by C entry."""
    out = {}
    for module in (cuda_step, cuda_tiled, cuda_block):
        for kernels in (module.KERNELS, module.GEOM_KERNELS):
            for k in kernels.values():
                n = k.launches
                out[k.entry] = sum(n.values()) if isinstance(n, dict) else n
    return out


@pytest.mark.parametrize("case", ["substep", "tiled", "court_geom", "block",
                                  "large_block", "tp06"])
def test_launch_spans_equal_the_launch_counters(device, monkeypatch, case):
    """Over a short simulate() with one pacing event, the trace holds one
    `fibtorch.launch.<entry>` span per launch each binding counts (kernels
    1-3 and the large block kernel, through all four wrappers; tp06's
    `tp06_substep`, ten a step), and no device-side record carries a
    `fibtorch.` name."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = CFG.replace(duration=2)
    if case == "tiled":
        monkeypatch.setattr(Simulation, "WHOLE_GRID_STATE_MB_MAX", 0.01)
    if case == "tp06":
        model = TenTusscher06(cfg.replace(dt=0.02, cheby=False, skip=False))
    else:
        model = (Courtemanche(cfg) if case in ("court_geom", "large_block")
                 else BeelerReuter(cfg))
    kw = (dict(mesh=make_mesh(devices=[device] * 4), wide_halo=True)
          if case.endswith("block") else dict(device=device))
    sim = Simulation(model, **kw)
    if case == "court_geom":
        sim.add_hole_to_phase_field(48, 32, 8)
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0)
    before = _launches_by_entry()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = sim.simulate(schedule=[(1.0, "s2")])
    after = _launches_by_entry()
    assert res.steps == {"court_geom": 2, "large_block": 2,
                         "tp06": 10}.get(case, 4)
    launched = {f"fibtorch.launch.{e}": after[e] - before[e] for e in after
                if after[e] != before[e]}
    if case == "tp06":
        assert launched == {"fibtorch.launch.tp06_substep": 100}
    events = prof.profiler.kineto_results.events()
    spans = Counter(e.name() for e in events
                    if e.name().startswith("fibtorch.launch."))
    assert launched and spans == launched
    assert not [e.name() for e in events
                if e.device_type() == DeviceType.CUDA
                and "fibtorch." in e.name()]


def test_br_tiled_body_loads_few_constants_per_thread(device):
    """Kernel 2's clamp-free BR body, in the SASS that cuobjdump prints and
    tools/torch_tile_bench.py counts: at most 4 LDC (a load into every
    thread's registers) per frozen cell-substep and 8 per SLOW one, the
    division's divisor and one LDC.64 for each gate's pair of constant
    terms (br_cell.cuh BrParams); 64 registers and no spill."""
    from fib_tf_tpu_torch.kernels import build

    try:
        cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    except RuntimeError:
        pytest.skip("needs nvcc")
    if not cuobjdump.exists():
        pytest.skip("needs cuobjdump")
    bench = tile_bench()
    lib = cuda_tiled.KERNEL.build()
    sass = bench.sass_functions(bench.cuobjdump_sass(lib), lines=True)
    (name, lines), = [(fn, ls) for fn, ls in sass.items()
                      if "tile_kernel" in fn and "BeelerReuterCell" in fn]
    kinds = bench.per_kind(bench.cell_substeps(bench.sass_instructions(lines)))
    assert kinds["frozen_clamp_free"]["ldc"] <= 4
    assert kinds["slow_clamp_free"]["ldc"] <= 8
    log = lib.with_name(lib.name + ".log").read_text()
    report = log[log.index(name):].split("Compiling entry function")[0]
    assert "Used 64 registers" in report
    assert "0 bytes spill stores, 0 bytes spill loads" in report
