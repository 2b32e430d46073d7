#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (fib_tf_tpu_torch) on one NVIDIA GPU.

Run from the root of the checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on after a failure):
  1. the card's name and power limit, the torch/CUDA versions, and the
     build of the Beeler-Reuter substep kernel from csrc/ with nvcc;
  2. kernel vs plain PyTorch on the card at 512x512, on a seeded state that
     holds a wavefront: one slow (n=5) launch, one frozen (n=0) launch and
     two outer steps, all 8 planes at rtol 1e-3 / atol 1e-5;
  3. the main path, Simulation(BeelerReuter(cfg), device='cuda')
     .define().simulate() at the bench configuration for 400 ms: it must
     launch the kernel exactly 5 times per outer step, stay finite, cross
     the probe at outer step 332 +- 2 (the JAX engine's crossing), and end
     within WHOLE_RUN_ATOL_MV of the same run forced to kernel='xla';
  4. timings: each body's device time per launch against the plain
     version's, the host launch overhead per outer step, and simulate()'s
     wall seconds per simulated second over 1000 ms.

Prints the nvidia-smi line and one JSON line describing the kernels before
its last line, which is {"ok": true, "device": {...}}.  Needs a CUDA GPU and
nvcc; exits 1 without them.  Imports no JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 1234
# bench.py's configuration, cut to 400 ms of simulated time
CFG = dict(width=512, height=512, dt=0.1, dt_per_plot=10, diff=0.809,
           duration=400, cheby=True, skip=True)
# kernel vs plain over single launches and 2 outer steps: the JAX
# package's own kernel-vs-XLA tolerance (tests/test_pallas.py)
RTOL, ATOL = 1e-3, 1e-5
# final V of the 400 ms kernel run vs the kernel-free run: 1e-3 of the
# model's 120 mV range, the goldens' bound (tests/test_golden.py)
WHOLE_RUN_ATOL_MV = 0.12
# first probe crossing of the JAX engine for this configuration (CPU run
# at 32x512; the S1 wave is planar, so the height does not move it)
CROSSING_STEP, CROSSING_SLACK = 332, 2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def compare(name, got, want):
    """Max abs error over the planes; fails outside rtol/atol."""
    worst = 0.0
    for k in want:
        a = got[k].double().cpu().numpy()
        b = want[k].double().cpu().numpy()
        err = np.abs(a - b)
        bad = err > ATOL + RTOL * np.abs(b)
        check(np.isfinite(a).all(), f"{name}: plane {k} not finite")
        check(not bad.any(),
              f"{name}: plane {k} differs at {int(bad.sum())} cells, "
              f"max abs err {err.max():.3g}")
        worst = max(worst, float(err.max()))
    print(f"  {name}: all {len(want)} planes within rtol {RTOL} / atol "
          f"{ATOL}; max abs err {worst:.3g}", flush=True)
    return worst


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA GPU")
    try:
        from fib_tf_tpu_torch import SimConfig, interop
        from fib_tf_tpu_torch.engine import Simulation
        from fib_tf_tpu_torch.kernels import build
        from fib_tf_tpu_torch.models import BeelerReuter
        from fib_tf_tpu_torch.ops import cuda_step
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")

    dev = torch.device("cuda")
    # no TF32 anywhere in the plain reference (it uses no conv/matmul, but
    # state both settings)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1 ----------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    lib_path = build.build("br_substep", [cuda_step.SOURCE])
    cuda_step.KERNEL.library()
    build_s = time.perf_counter() - t0
    log = lib_path.with_name(lib_path.name + ".log").read_text()
    print(f"phase 1: built {lib_path.name} from "
          f"{cuda_step.SOURCE.name} in {build_s:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # -- phase 2 ----------------------------------------------------------------
    cfg = SimConfig(**CFG)
    model = BeelerReuter(cfg)
    rng = np.random.default_rng(SEED)
    init = model.initial_state()
    shape = model.state_shape()
    init["V"] = init["V"] + rng.normal(0.0, 1.0, shape).astype(np.float32)
    for g in ("m", "h", "j", "d", "f", "x1"):
        init[g] = np.clip(init[g] * rng.uniform(0.98, 1.02, shape),
                          1e-5, 0.99999).astype(np.float32)
    init["C"] = (init["C"] * rng.uniform(0.9, 1.1, shape)).astype(np.float32)
    base = interop.state_from_numpy(init, dev)
    for _ in range(20):   # 10 ms: a wavefront leaves the S1 stripe
        cuda_step.plain_step(model, base)
    torch.cuda.synchronize()
    vb = base["V"].cpu().numpy()
    check(np.isfinite(vb).all() and vb.max() > 0.0,
          "phase 2 state holds no wavefront")

    def clone(s):
        return {k: v.clone() for k, v in s.items()}

    print("phase 2: kernel vs plain PyTorch at 512x512", flush=True)
    errs = {}
    for body, slow in (("slow", True), ("frozen", False)):
        pk = torch.zeros(1, device=dev)
        pp = torch.zeros(1, device=dev)
        got = cuda_step.substep(model, clone(base), slow, pk, 0)
        want = cuda_step.plain_substep(model, clone(base), slow, pp, 0)
        torch.cuda.synchronize()
        errs[body] = compare(f"one {body} launch", got, want)
        check(abs(float(pk[0]) - float(pp[0])) <= ATOL + RTOL * abs(float(pp[0])),
              f"{body} probe {float(pk[0])} vs plain {float(pp[0])}")
    step = cuda_step.make_cuda_step(model)
    got, want = clone(base), clone(base)
    pk = torch.zeros(2, device=dev)
    pp = torch.zeros(2, device=dev)
    for i in range(2):
        got = step(got, pk, i)
        want = cuda_step.plain_step(model, want, pp, i)
    torch.cuda.synchronize()
    compare("2 outer steps", got, want)
    check(np.allclose(pk.cpu().numpy(), pp.cpu().numpy(), rtol=RTOL,
                      atol=ATOL), "2-step probes differ")

    # -- phase 3 ----------------------------------------------------------------
    print("phase 3: main path, Simulation(...).define().simulate() at "
          f"{cfg.width}x{cfg.height}, {cfg.duration} ms", flush=True)
    sim = Simulation(BeelerReuter(cfg), device="cuda").define()
    cuda_step.KERNEL.reset_launches()
    res = sim.simulate()
    launches = dict(cuda_step.KERNEL.launches)
    print(f"  steps {res.steps}, launches {launches}, "
          f"cycle_lengths {res.cycle_lengths}", flush=True)
    check(res.steps == cfg.samples(model.dt_per_step),
          f"ran {res.steps} outer steps")
    check(launches["slow"] + launches["frozen"] == 5 * res.steps,
          f"launches {launches} != 5 x {res.steps} outer steps")
    check(launches["slow"] == res.steps and launches["frozen"] == 4 * res.steps,
          f"launch split {launches} is not 1 slow + 4 frozen per step")
    for k, v in res.state.items():
        check(v.shape == shape and np.isfinite(v).all(),
              f"final plane {k} not finite or of shape {v.shape}")
    check(len(res.cycle_lengths) >= 1, "the probe saw no wavefront")
    first = res.cycle_lengths[0][0]
    check(abs(first - CROSSING_STEP) <= CROSSING_SLACK,
          f"first crossing at outer step {first}, expected "
          f"{CROSSING_STEP} +- {CROSSING_SLACK}")

    before = dict(cuda_step.KERNEL.launches)
    ref = Simulation(BeelerReuter(cfg.replace(kernel="xla")),
                     device="cuda").define().simulate()
    check(cuda_step.KERNEL.launches == before,
          "the kernel='xla' run launched the kernel")
    dv = np.abs(res.state["V"] - ref.state["V"])
    print(f"  final V vs kernel='xla' run: max abs {dv.max():.4g} mV "
          f"(bound {WHOLE_RUN_ATOL_MV} mV); crossings "
          f"{ref.cycle_lengths}; probe max abs "
          f"{np.abs(res.probes['v'] - ref.probes['v']).max():.3g}",
          flush=True)
    check(float(dv.max()) <= WHOLE_RUN_ATOL_MV,
          f"final V differs from the kernel-free run by {dv.max()} mV")
    check(ref.cycle_lengths[:1] == res.cycle_lengths[:1],
          "kernel and kernel-free runs cross at different steps")

    # -- phase 4 ----------------------------------------------------------------
    print(f"phase 4: timings on {card}", flush=True)
    timing = time_kernels(torch, model, base, cuda_step)
    long = Simulation(BeelerReuter(cfg.replace(duration=1000)),
                      device="cuda").define().simulate()
    wall_per_sim = 1.0 / long.sim_seconds_per_wall_second
    ref_wall_per_sim = 1.0 / ref.sim_seconds_per_wall_second
    for body in ("slow", "frozen"):
        print(f"  {body} body: kernel {timing[body]['kernel_us']:.3f} "
              f"us/launch (device), plain {timing[body]['plain_us']:.1f} "
              f"us/substep (device) [{card}]", flush=True)
    print(f"  outer step (1 slow + 4 frozen launches): device "
          f"{timing['step_device_us']:.2f} us, host-paced "
          f"{timing['step_wall_us']:.2f} us, host enqueue "
          f"{timing['step_host_us']:.2f} us -> launch overhead "
          f"{timing['step_wall_us'] - timing['step_device_us']:.2f} "
          f"us/outer step [{card}]", flush=True)
    print(f"  simulate(): {wall_per_sim:.6f} wall-s/sim-s over "
          f"{long.steps} outer steps (1000 ms), kernel path; "
          f"{ref_wall_per_sim:.6f} on the kernel='xla' path over 400 ms "
          f"[{card}]", flush=True)

    kernels = [
        {
            "name": f"br_substep<SLOW={str(slow).lower()}>",
            "route": "cuda",
            "source": "fib_tf_tpu_torch/csrc/br_substep.cu",
            "replaces": "fib_tf_tpu/ops/pallas_step.py:205",
            "launches": launches[body],
            "max_abs_err": errs[body],
            "ms": timing[body]["kernel_us"] / 1e3,
            "plain_ms": timing[body]["plain_us"] / 1e3,
        }
        for body, slow in (("slow", True), ("frozen", False))
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def device_us(torch, fn, reps: int) -> float:
    """Device time per call of `fn` in microseconds.  The stream is first
    held by a spin kernel long enough for the host to queue all `reps`
    calls, so the events bracket device work only, not launch gaps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    for attempt in range(4):
        # SM clocks are 1.98 GHz at most: this spins >= 5x the host time
        cycles = int(max(host_s, 1e-3) * 10e9 * 4 ** attempt)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        queued_s = time.perf_counter() - t
        # the device has not reached `start` yet: every call was queued
        # before the first one ran
        held = not start.query()
        end.record()
        end.synchronize()
        if held:
            return start.elapsed_time(end) * 1e3 / reps
    fail(f"the spin kernel did not hold the stream while {reps} calls were "
         f"queued (host {host_s * 1e3:.2f} ms unheld, {queued_s * 1e3:.2f} "
         f"ms held, {cycles} cycles)")


def time_kernels(torch, model, base, cuda_step):
    """Per-launch device times of both bodies and of the plain substeps,
    and the host-paced time of an outer step."""
    state = {k: v.clone() for k, v in base.items()}
    params = cuda_step.pack_params(model)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for body, slow in (("slow", True), ("frozen", False)):
        out[body] = {
            "kernel_us": device_us(torch, lambda: cuda_step.KERNEL.launch(
                params, state, slow, None, model.probe_pixel, 0, stream),
                reps=200),
            "plain_us": device_us(torch, lambda: cuda_step.plain_substep(
                model, state, slow), reps=2),
        }
    step = cuda_step.make_cuda_step(model)
    out["step_device_us"] = device_us(torch, lambda: step(state), reps=100)
    n = 2000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t = time.perf_counter()
    for _ in range(n):
        step(state)
    out["step_host_us"] = (time.perf_counter() - t) * 1e6 / n
    end.record()
    end.synchronize()
    out["step_wall_us"] = start.elapsed_time(end) * 1e3 / n
    return out


if __name__ == "__main__":
    main()
