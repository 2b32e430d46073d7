#!/usr/bin/env python
"""Time kernel 1's Courtemanche commits (csrc/br_substep.cu, the
`court_substep` library, body csrc/court_cell.cuh) at 2048x2048 on one CUDA
card, and count what the compiler made of them.

  python tools/torch_court_bench.py                    # this checkout
  python tools/torch_court_bench.py --root DIR --tag parent
                                                       # DIR's package

It builds the court library of the package under `--root` (default: the
checkout it lives in), so that two versions can be timed in one call, in
turns, on one card, and prints, after the card's name and power limit:

  * the `-Xptxas -v` lines of the court library's kernel-1 functions;
  * a census of each of their SASS (cuobjdump -sass): instructions by class
    (tools/torch_tile_bench.py's classes), the MUFU instructions by
    function (LG2 for each logf, RCP for each IEEE division, EX2, RSQ,
    SQRT) and the calls (a division's slow path); a static count, so both
    rate modes' code is in it;
  * device times (CUDA events around a queue held by a spin kernel, as in
    chip_smoke.py) of each form of a GEOM launch: the fast commit that
    computes its terms from the planes, the slow commit (which stores the
    cache where the package has one, ops/cuda_step.py
    SubstepKernel.cache), and there the fast commit that reads it; then
    of outer steps of eleven launches with no fast commit reading the
    cache and, where there is one, with the nine reading it, and through
    the package's own make_cuda_step.

The grid, geometry and state are court.2048.annulus's (benchmark/): the
benchmark configuration's model (direct rates, chronic AF, dt 0.1 ms, diff
0.809) in examples/court_run.py's annulus (hole 120, ring 1018), V raised
by a seeded N(0, 1) mV, an S2 'luq' at 650 ms and 1500 ms of outer steps
before the timing, so that a reentry runs.

The last line is one JSON object with every number, also written to
`<out>/<tag>_court_bench.json` (`--out`, default `build/court_bench/`).
Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
N = 2048
S2_STEP, WARM_STEPS = 650, 1500
MUFU = ("LG2", "RCP", "EX2", "RSQ", "SQRT")


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def demangle(names):
    """{mangled: readable} through the toolkit's cu++filt, where it runs."""
    try:
        tool = Path(tile_bench.find_nvcc()).with_name("cu++filt")
        out = subprocess.run([str(tool)], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        return dict(zip(names, out.stdout.splitlines()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return {n: n for n in names}


def resources(lib: Path):
    """{function: its -Xptxas -v lines} of the court library's kernel-1
    functions: registers, spills, stack."""
    out, name = {}, None
    for ln in tile_bench.ptxas_lines(lib):
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            name = m.group(1) if "substep_kernel" in m.group(1) else None
        elif name:
            out.setdefault(name, []).append(ln)
    names = demangle(list(out))
    return {names.get(fn, fn): " ".join(lines) for fn, lines in out.items()}


def census(lib: Path, out: Path):
    """{function: counts} of the court library's kernel-1 functions."""
    text = tile_bench.cuobjdump_sass(lib)
    out.write_text(text)
    funcs = {fn: ops for fn, ops in tile_bench.sass_functions(text).items()
             if "substep_kernel" in fn}
    names = demangle(list(funcs))
    result = {}
    for fn, ops in funcs.items():
        counts = tile_bench.classify(ops)
        for sub in MUFU:
            counts[f"mufu_{sub.lower()}"] = sum(op.startswith(f"MUFU.{sub}")
                                                for op in ops)
        counts["call"] = sum(op.split(".")[0] == "CALL" for op in ops)
        result[names.get(fn, fn)] = counts
    return result


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(HERE),
                   help="checkout whose fib_tf_tpu_torch is timed")
    p.add_argument("--tag", default="this", help="name of the run")
    p.add_argument("--out", default=str(HERE / "build" / "court_bench"),
                   help="directory for the SASS and the JSON")
    p.add_argument("--reps", type=int, default=50,
                   help="launches or outer steps per timing")
    p.add_argument("--sass-dir", default=None,
                   help="directory for the SASS listing (default: --out)")
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    smoke = load("chip_smoke", HERE / "chip_smoke.py")
    if not torch.cuda.is_available():
        smoke.fail("torch_court_bench needs a CUDA card")
    from fib_tf_tpu_torch import SimConfig, interop
    from fib_tf_tpu_torch.models import Courtemanche
    from fib_tf_tpu_torch.ops import cuda_step, stencil

    smoke.check(Path(cuda_step.__file__).resolve().is_relative_to(root),
                f"imported {cuda_step.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"[{args.tag}] package {root / 'fib_tf_tpu_torch'}", flush=True)
    out_dir = Path(args.out)
    sass_dir = Path(args.sass_dir or out_dir)
    for d in (out_dir, sass_dir):
        d.mkdir(parents=True, exist_ok=True)
    result = {"tag": args.tag, "card": card}

    kernel = cuda_step.GEOM_KERNELS["court"]
    lib = kernel.build()
    result["ptxas"] = resources(lib)
    result["sass"] = census(lib, sass_dir / f"{args.tag}_court_substep.sass")
    for fn, c in result["sass"].items():
        if "CourtCell<false>" in fn or "CourtCellILb0E" in fn:
            print(f"  {fn}: {result['ptxas'].get(fn, '')}", flush=True)
            print("    SASS " + ", ".join(f"{k} {v}" for k, v in c.items()),
                  flush=True)

    dev = torch.device("cuda")
    model = Courtemanche(SimConfig(width=N, height=N, dt=0.1, dt_per_plot=10,
                                   diff=0.809, chronic=True))
    phase = smoke.court_annulus(stencil, N, 120)
    maps = cuda_step.GeometryMaps((N, N), phase)
    geometry = maps.args(dev)
    rng = np.random.default_rng(smoke.SEED)
    init = model.initial_state()
    init["V"] = init["V"] + rng.normal(0.0, 1.0, (N, N)).astype(np.float32)
    base = interop.state_from_numpy(init, dev)
    step = cuda_step.make_cuda_step(model, phase)
    mask = torch.tensor(stencil.pace_mask(N, N, "luq", 10.0, model.min_v),
                        device=dev)
    for i in range(WARM_STEPS):
        if i == S2_STEP:
            base["V"] = torch.maximum(base["V"], mask)
        base = step(base)
    torch.cuda.synchronize()
    smoke.check(bool(torch.isfinite(base["V"]).all()),
                "the warm-up state is not finite")

    params = cuda_step.pack_params(model)
    stream = torch.cuda.current_stream().cuda_stream
    pixel = model.probe_pixel
    cached = getattr(kernel, "cache", None) is not None

    def launch(st, slow, reads=False):
        kernel.launch(params, st, slow, None, pixel, 0, stream, geometry,
                      *((True,) if reads else ()))

    def us(fn, reps=args.reps):
        st = smoke.clone(base)
        return smoke.device_us(torch, lambda: fn(st), reps=reps)

    t = {"fast_us": us(lambda st: launch(st, False)),
         "slow_us": us(lambda st: launch(st, True))}
    if cached:
        # the slow commits above left a slow commit's values in the cache
        t["fast_load_us"] = us(lambda st: launch(st, False, True))

    def outer(reads):
        sched = model.launch_schedule
        flags = (cuda_step.cache_schedule(sched) if reads
                 else (False,) * len(sched))
        return lambda st: [launch(st, s, r) for s, r in zip(sched, flags)]

    reps = max(args.reps // 5, 4)
    t["step_none_us"] = us(outer(False), reps=reps)
    if cached:
        t["step_cached_us"] = us(outer(True), reps=reps)
    t["step_package_us"] = us(step, reps=reps)
    result.update(t)
    for k, v in t.items():
        print(f"[{args.tag}] {k} {v:.3f} [{card}]", flush=True)
    (out_dir / f"{args.tag}_court_bench.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "sass"}),
          flush=True)


tile_bench = load("torch_tile_bench", HERE / "tools" / "torch_tile_bench.py")

if __name__ == "__main__":
    main()
