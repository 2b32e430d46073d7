#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (fib_tf_tpu_torch) on one NVIDIA GPU.

Run from the root of the checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on after a failure):
  1. the card's name and power limit, the torch/CUDA versions, and the
     build of both kernels from csrc/ with nvcc (in parallel): the substep
     kernel br_substep.cu and the tiled outer-step kernel br_tiled.cu;
  2. substep kernel vs plain PyTorch on the card at 512x512, on a seeded
     state that holds a wavefront: one slow (n=5) launch, one frozen (n=0)
     launch and two outer steps, all 8 planes at rtol 1e-3 / atol 1e-5;
  3. the 512x512 main path, Simulation(BeelerReuter(cfg), device='cuda')
     .define().simulate() at the bench configuration for 400 ms: it must
     route 'substep', launch the substep kernel exactly 5 times per outer
     step and the tiled kernel never, stay finite, cross the probe at outer
     step 332 +- 2 (the JAX engine's crossing), and end within
     WHOLE_RUN_ATOL_MV of the same run forced to kernel='xla';
  4. timings at 512x512: each substep body's device time per launch
     against the plain version's, the host launch overhead per outer step,
     and simulate()'s wall seconds per simulated second over 1000 ms;
  5. tiled kernel vs plain PyTorch on the card, all 8 planes and the probe
     at the same tolerance, skip on and off: 1 and 2 outer steps at
     2048x2048 on a seeded state that holds a wavefront, 2 outer steps at
     the ragged 67x131 and 1031x517 and at 9x12 (smaller than one tile),
     and 2 outer steps against the substep kernel at 512x512;
  6. the 2048x2048 main path (past the 32 MB cutover) for 700 ms: it must
     route 'tiled', launch the tiled kernel exactly once per outer step and
     the substep kernel never, stay finite, cross the probe at outer step
     1332 +- 2 (the JAX engine's crossing), and end within
     WHOLE_RUN_ATOL_MV of, and cross with, the same run forced to
     kernel='xla';
  7. timings of the tiled kernel: device time per outer step of the tiled
     kernel, the substep route (5 launches) and the plain outer step at
     2048x2048 and at 512x512; simulate()'s wall seconds per simulated
     second on the tiled route (phase 6's run), and at 512x512 for 1000 ms
     with the cutover lowered so that it takes the tiled route (held
     within WHOLE_RUN_ATOL_MV of phase 4's run).

Prints the nvidia-smi line and one JSON line describing the kernels before
its last line, which is {"ok": true, "device": {...}}.  Needs a CUDA GPU and
nvcc; exits 1 without them.  Imports no JAX.
"""

import concurrent.futures
import functools
import json
import subprocess
import sys
import time

import numpy as np

SEED = 1234
# bench.py's configuration, cut to 400 ms of simulated time
CFG = dict(width=512, height=512, dt=0.1, dt_per_plot=10, diff=0.809,
           duration=400, cheby=True, skip=True)
# the same past the whole-grid cutover (128 MB of state), cut to 700 ms:
# long enough for the S1 wave to cross the probe at column 1024
CFG_LARGE = dict(CFG, width=2048, height=2048, duration=700)
# kernel vs plain over single launches and 2 outer steps: the JAX
# package's own kernel-vs-XLA tolerance (tests/test_pallas.py)
RTOL, ATOL = 1e-3, 1e-5
# final V of a whole kernel run vs the kernel-free run: 1e-3 of the
# model's 120 mV range, the goldens' bound (tests/test_golden.py)
WHOLE_RUN_ATOL_MV = 0.12
# first probe crossing of the JAX engine for each configuration; the S1
# wave is planar, so the height does not move it and the JAX engine pins
# it on the CPU at height 32:
#   SimConfig(width=W, height=32, dt=0.1, dt_per_plot=10, diff=0.809,
#             duration=D, cheby=True, skip=True, kernel='xla')
#   -> Simulation(BeelerReuter(cfg)).define().simulate().cycle_lengths[0]
# gives (332, 166.0) at W=512, D=400 and (1332, 666.0) at W=2048, D=700
CROSSING_STEP, CROSSING_SLACK = 332, 2
CROSSING_STEP_LARGE = 1332
# ragged grids, and one smaller than a tile, for the tiled kernel
RAGGED = ((67, 131), (1031, 517), (9, 12))


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def compare(name, got, want):
    """Max abs error over the planes (in float64 on the device); fails
    outside rtol/atol."""
    worst = 0.0
    for k in want:
        a = got[k].double()
        b = want[k].double()
        err = (a - b).abs()
        bad = err > ATOL + RTOL * b.abs()
        check(bool(a.isfinite().all()), f"{name}: plane {k} not finite")
        check(not bool(bad.any()),
              f"{name}: plane {k} differs at {int(bad.sum())} cells, "
              f"max abs err {float(err.max()):.3g}")
        worst = max(worst, float(err.max()))
    print(f"  {name}: all {len(want)} planes within rtol {RTOL} / atol "
          f"{ATOL}; max abs err {worst:.3g}", flush=True)
    return worst


def compare_probes(name, got, want):
    a, b = got.double().cpu().numpy(), want.double().cpu().numpy()
    check(np.allclose(a, b, rtol=RTOL, atol=ATOL),
          f"{name}: probes {a} vs plain {b}")


def clone(s):
    return {k: v.clone() for k, v in s.items()}


def seeded_state(torch, interop, model, dev, plain_step, rng):
    """The initial state perturbed from `rng`, then 20 plain outer steps
    (10 ms) on the card, so that a wavefront has left the S1 stripe."""
    init = model.initial_state()
    shape = model.state_shape()
    init["V"] = init["V"] + rng.normal(0.0, 1.0, shape).astype(np.float32)
    for g in ("m", "h", "j", "d", "f", "x1"):
        init[g] = np.clip(init[g] * rng.uniform(0.98, 1.02, shape),
                          1e-5, 0.99999).astype(np.float32)
    init["C"] = (init["C"] * rng.uniform(0.9, 1.1, shape)).astype(np.float32)
    base = interop.state_from_numpy(init, dev)
    for _ in range(20):
        plain_step(model, base)
    torch.cuda.synchronize()
    check(bool(base["V"].isfinite().all()) and float(base["V"].max()) > 0.0,
          f"{shape} seeded state holds no wavefront")
    return base


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA GPU")
    try:
        from fib_tf_tpu_torch import SimConfig, interop
        from fib_tf_tpu_torch.engine import Simulation
        from fib_tf_tpu_torch.models import BeelerReuter
        from fib_tf_tpu_torch.ops import cuda_step, cuda_tiled
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
    bindings = {"br_substep": (cuda_step.KERNEL, cuda_step.SOURCE),
                "br_tiled": (cuda_tiled.KERNEL, cuda_tiled.SOURCE)}
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(bindings)) as pool:
        futures = {name: pool.submit(kernel.build)
                   for name, (kernel, _) in bindings.items()}
        lib_paths = {name: f.result() for name, f in futures.items()}
    for kernel, _ in bindings.values():
        kernel.library()
    build_s = time.perf_counter() - t0
    for name, (_, source) in bindings.items():
        path = lib_paths[name]
        print(f"phase 1: built {path.name} from {source.name} ({build_s:.2f} "
              f"s for both)", flush=True)
        for line in path.with_name(path.name + ".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    def reset_counts():
        cuda_step.KERNEL.reset_launches()
        cuda_tiled.KERNEL.reset_launches()

    def read_counts():
        return dict(cuda_step.KERNEL.launches), cuda_tiled.KERNEL.launches

    # -- phase 2 ----------------------------------------------------------------
    cfg = SimConfig(**CFG)
    model = BeelerReuter(cfg)
    shape = model.state_shape()
    rng = np.random.default_rng(SEED)
    base = seeded_state(torch, interop, model, dev, cuda_step.plain_step, rng)

    print("phase 2: substep kernel vs plain PyTorch at 512x512", flush=True)
    errs = {}
    for body, slow in (("slow", True), ("frozen", False)):
        pk = torch.zeros(1, device=dev)
        pp = torch.zeros(1, device=dev)
        got = cuda_step.substep(model, clone(base), slow, pk, 0)
        want = cuda_step.plain_substep(model, clone(base), slow, pp, 0)
        torch.cuda.synchronize()
        errs[body] = compare(f"one {body} launch", got, want)
        compare_probes(f"{body} launch", pk, pp)
    step = cuda_step.make_cuda_step(model)
    got, want = clone(base), clone(base)
    pk = torch.zeros(2, device=dev)
    pp = torch.zeros(2, device=dev)
    for i in range(2):
        got = step(got, pk, i)
        want = cuda_step.plain_step(model, want, pp, i)
    torch.cuda.synchronize()
    compare("2 outer steps", got, want)
    compare_probes("2-step", pk, pp)

    # -- phase 3 ----------------------------------------------------------------
    print("phase 3: main path, Simulation(...).define().simulate() at "
          f"{cfg.width}x{cfg.height}, {cfg.duration} ms", flush=True)
    sim = Simulation(BeelerReuter(cfg), device="cuda").define()
    check(sim.route == "substep", f"512x512 routes {sim.route!r}")
    reset_counts()
    res = sim.simulate()
    launches, tiled_launches = read_counts()
    print(f"  route {sim.route}, steps {res.steps}, launches {launches}, "
          f"tiled launches {tiled_launches}, cycle_lengths "
          f"{res.cycle_lengths}", flush=True)
    check(res.steps == cfg.samples(model.dt_per_step),
          f"ran {res.steps} outer steps")
    check(launches["slow"] + launches["frozen"] == 5 * res.steps,
          f"launches {launches} != 5 x {res.steps} outer steps")
    check(launches["slow"] == res.steps and launches["frozen"] == 4 * res.steps,
          f"launch split {launches} is not 1 slow + 4 frozen per step")
    check(tiled_launches == 0, "the 512x512 run launched the tiled kernel")
    check_run(res, shape, CROSSING_STEP)

    before = read_counts()
    ref = Simulation(BeelerReuter(cfg.replace(kernel="xla")),
                     device="cuda").define().simulate()
    check(read_counts() == before, "the kernel='xla' run launched a kernel")
    check_against_plain_run(res, ref)

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

    # -- phase 5 ----------------------------------------------------------------
    print("phase 5: tiled kernel vs plain PyTorch", flush=True)
    cfg_large = SimConfig(**CFG_LARGE)
    large = BeelerReuter(cfg_large)
    base_large = seeded_state(torch, interop, large, dev,
                              cuda_step.plain_step, rng)
    tiled_err = 0.0
    for skip in (True, False):
        m = BeelerReuter(cfg_large.replace(skip=skip))
        for n in (1, 2):
            tiled_err = max(tiled_err, check_tiled(
                torch, cuda_tiled, m, base_large, n,
                functools.partial(cuda_step.plain_step, m),
                f"2048x2048 skip={skip}"))
    for h, w in RAGGED:
        for skip in (True, False):
            m = BeelerReuter(cfg.replace(height=h, width=w, skip=skip))
            st = seeded_state(torch, interop, m, dev, cuda_step.plain_step,
                              rng) if min(h, w) > 20 else None
            if st is None:   # 9x12: the S1 stripe alone, no probe pixel
                st = interop.state_from_numpy(m.initial_state(), dev)
            tiled_err = max(tiled_err, check_tiled(
                torch, cuda_tiled, m, st, 2,
                functools.partial(cuda_step.plain_step, m),
                f"{h}x{w} skip={skip}"))
    for skip in (True, False):
        m = BeelerReuter(cfg.replace(skip=skip))
        tiled_err = max(tiled_err, check_tiled(
            torch, cuda_tiled, m, base, 2, cuda_step.make_cuda_step(m),
            f"512x512 skip={skip}", against="substep kernel"))

    # -- phase 6 ----------------------------------------------------------------
    print("phase 6: main path past the 32 MB cutover, Simulation(...)"
          f".define().simulate() at {cfg_large.width}x{cfg_large.height}, "
          f"{cfg_large.duration} ms", flush=True)
    sim = Simulation(large, device="cuda").define()
    check(sim.route == "tiled", f"2048x2048 routes {sim.route!r}")
    reset_counts()
    res_large = sim.simulate()
    launches_large, tiled_launches = read_counts()
    print(f"  route {sim.route}, steps {res_large.steps}, tiled launches "
          f"{tiled_launches}, substep launches {launches_large}, "
          f"cycle_lengths {res_large.cycle_lengths}", flush=True)
    check(res_large.steps == cfg_large.samples(large.dt_per_step),
          f"ran {res_large.steps} outer steps")
    check(tiled_launches == res_large.steps,
          f"{tiled_launches} tiled launches for {res_large.steps} outer steps")
    check(launches_large == {"slow": 0, "frozen": 0},
          f"the 2048x2048 run launched the substep kernel {launches_large}")
    check_run(res_large, large.state_shape(), CROSSING_STEP_LARGE)
    before = read_counts()
    t0 = time.perf_counter()
    ref_large = Simulation(BeelerReuter(cfg_large.replace(kernel="xla")),
                           device="cuda").define().simulate()
    print(f"  kernel='xla' run: {time.perf_counter() - t0:.1f} s", flush=True)
    check(read_counts() == before, "the kernel='xla' run launched a kernel")
    check_against_plain_run(res_large, ref_large)

    # -- phase 7 ----------------------------------------------------------------
    print(f"phase 7: tiled kernel timings on {card}", flush=True)
    tiled_timing = time_tiled(torch, cuda_step, cuda_tiled, large,
                              base_large, model, base)
    for size, t in tiled_timing.items():
        print(f"  {size}: tiled kernel {t['tiled_us']:.2f} us/outer step, "
              f"substep route (5 launches) {t['substep_us']:.2f}, plain "
              f"{t['plain_us']:.1f} (device) [{card}]", flush=True)
    print(f"  simulate() on the tiled route at 2048x2048: "
          f"{1.0 / res_large.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
          f"over {res_large.steps} outer steps (700 ms); "
          f"{1.0 / ref_large.sim_seconds_per_wall_second:.6f} on the "
          f"kernel='xla' path [{card}]", flush=True)
    # the cutover question: phase 4's 1000 ms run at 512x512, with the
    # cutover lowered so that it takes the tiled route
    cutover = Simulation.WHOLE_GRID_STATE_MB_MAX
    Simulation.WHOLE_GRID_STATE_MB_MAX = 0
    try:
        sim = Simulation(BeelerReuter(cfg.replace(duration=1000)),
                         device="cuda").define()
    finally:
        Simulation.WHOLE_GRID_STATE_MB_MAX = cutover
    check(sim.route == "tiled", f"lowered cutover routes {sim.route!r}")
    long_tiled = sim.simulate()
    dv = float(np.abs(long_tiled.state["V"] - long.state["V"]).max())
    check(dv <= WHOLE_RUN_ATOL_MV,
          f"512x512 tiled and substep routes end {dv} mV apart")
    print(f"  simulate() at 512x512, 1000 ms, cutover lowered to the tiled "
          f"route: {1.0 / long_tiled.sim_seconds_per_wall_second:.6f} "
          f"wall-s/sim-s, against {wall_per_sim:.6f} on the substep route "
          f"(phase 4); final V {dv:.3g} mV apart [{card}]", flush=True)

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
    big = tiled_timing["2048x2048"]
    kernels.append({
        "name": "br_tiled",
        "route": "cuda",
        "source": "fib_tf_tpu_torch/csrc/br_tiled.cu",
        "replaces": "fib_tf_tpu/ops/pallas_tiled.py:342",
        "launches": tiled_launches,
        "max_abs_err": tiled_err,
        "ms": big["tiled_us"] / 1e3,
        "plain_ms": big["plain_us"] / 1e3,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def check_run(res, shape, crossing):
    """A kernel run's final state is finite and of `shape`, and its first
    probe crossing is the JAX engine's."""
    for k, v in res.state.items():
        check(v.shape == shape and np.isfinite(v).all(),
              f"final plane {k} not finite or of shape {v.shape}")
    check(len(res.cycle_lengths) >= 1, "the probe saw no wavefront")
    first = res.cycle_lengths[0][0]
    check(abs(first - crossing) <= CROSSING_SLACK,
          f"first crossing at outer step {first}, expected "
          f"{crossing} +- {CROSSING_SLACK}")


def check_against_plain_run(res, ref):
    """A kernel run ends within WHOLE_RUN_ATOL_MV of the kernel='xla' run
    and crosses at the same step."""
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


def check_tiled(torch, cuda_tiled, model, base, n_steps, reference, name,
                against="plain"):
    """`n_steps` outer steps of the tiled kernel vs the outer step
    `reference(state, probe, i)` from `base`: all planes and the probe
    (where the grid holds the probe pixel).  Returns the max abs error."""
    h, w = model.state_shape()
    has_probe = model.probe_pixel[0] < h
    dev = base["V"].device
    pk = torch.zeros(n_steps, device=dev) if has_probe else None
    pp = torch.zeros(n_steps, device=dev) if has_probe else None
    step = cuda_tiled.make_tiled_cuda_step(model)
    got, want = clone(base), clone(base)
    for i in range(n_steps):
        got = step(got, pk, i)
        want = reference(want, pp, i)
    torch.cuda.synchronize()
    err = compare(f"{name}, {n_steps} outer step(s) vs {against}", got, want)
    if has_probe:
        compare_probes(name, pk, pp)
    return err


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
    state = clone(base)
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


def time_tiled(torch, cuda_step, cuda_tiled, large, base_large, model, base):
    """Device time per outer step at 2048x2048 and 512x512: the tiled
    kernel, the substep route and the plain step.
    The plain outer step is timed substep by substep and summed over the
    schedule: its five substeps queue more launches than the stream holds
    behind the spin kernel."""
    out = {}
    for size, m, b in (("2048x2048", large, base_large),
                       ("512x512", model, base)):
        state = clone(b)

        def run(step):
            return lambda: step(state)

        reps = 50 if size == "2048x2048" else 200
        plain = {slow: device_us(torch, lambda: cuda_step.plain_substep(
            m, state, slow), reps=1) for slow in (True, False)}
        out[size] = {
            "tiled_us": device_us(torch, run(
                cuda_tiled.make_tiled_cuda_step(m)), reps=reps),
            "substep_us": device_us(torch, run(cuda_step.make_cuda_step(m)),
                                    reps=reps),
            "plain_us": sum(plain[slow]
                            for slow in cuda_step.slow_schedule(m)),
        }
    return out


if __name__ == "__main__":
    main()
