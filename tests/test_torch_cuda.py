"""The CUDA kernels (2D substep and tiled, volume substep and tiled) against
their plain PyTorch version, on the card.

Marked `cuda`: without a CUDA device (and nvcc) every test here skips.  On
the card:  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q"""

import numpy as np
import pytest
import torch

from fib_tf_tpu_torch import SimConfig, interop
from fib_tf_tpu_torch.engine import (Simulation, VolumeEvent, run_volume,
                                     volume, volume_state)
from fib_tf_tpu_torch.models import BeelerReuter
from fib_tf_tpu_torch.ops import (cuda_step, cuda_tiled, cuda_volume,
                                  cuda_volume_tiled)

pytestmark = pytest.mark.cuda

CFG = SimConfig(width=96, height=64, dt=0.1, dt_per_plot=10, diff=0.809,
                duration=20, cheby=True, skip=True)


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
