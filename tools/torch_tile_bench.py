#!/usr/bin/env python
"""Time the 2D tile skeleton of fib_tf_tpu_torch (csrc/br_tile.cuh) or, with
--volume, the tiled volume kernel (csrc/br_volume_tiled.cu) on one CUDA
card, and show what the compiler made of it.

  python tools/torch_tile_bench.py                     # this checkout
  python tools/torch_tile_bench.py --root DIR --tag parent
                                                       # DIR's package
  python tools/torch_tile_bench.py --volume [--root DIR --tag T]

With --volume it prints the `-Xptxas -v` lines and SASS instruction
counts of kernels 5 and 4, and device times per outer step at 8x512x512,
32x128x512, 8x128x512 and 8x1024x1024: kernel 5 (through
make_tiled_volume_step, so a parent package of another design times too)
and the substep route (five launches of csrc/br_volume.cu, before and
after kernel 5), with their ratio.

The skeleton runs two kernels: kernel 2 (csrc/br_tiled.cu, one outer step
of a whole grid) and kernel 3 (csrc/br_block.cu, one outer step of a
shard's halo-extended block).  This script builds both from the package
found under `--root` (default: the checkout it lives in), so that two
versions of the skeleton can be timed in one call, in turns, on one card.
It prints, after the card's name and power limit:

  * the `-Xptxas -v` lines of both libraries (registers, spills, stack);
  * from `cuobjdump -sass`, the instructions of each `tile_kernel` and
    the instruction counts between its shared-memory stores of V (one
    per cell-substep), written in full to `<out>/<tag>_*.sass`;
  * device times (CUDA events around a queue held by a spin kernel, as in
    chip_smoke.py): kernel 2 at 2048^2 and 2047^2, the substep route (five
    launches of csrc/br_substep.cu) at 2048^2 and the ratio of the two,
    and the SM clock and power that nvidia-smi reads while kernel 2 runs,
    kernel 3 on a 522x2048 block (a 512-row shard of 2048^2 on a 4x1 mesh)
    and on a 1034x1034 block (a corner shard of 2x2);
  * the memory-vs-compute split of kernel 2 at 2048^2 and of kernel 3 on
    the 522x2048 block from their existing arguments alone
    (chip_smoke.time_split): n_sub = 1..5 substeps, all frozen and all
    SLOW, each time divided by the number of tiles, fitted by a straight
    line in the substeps' ring rows (intercept: what a tile costs
    besides its substeps; slopes: one frozen and one SLOW substep of a
    whole ring).

The last line is one JSON object with every number, also written to
`<out>/<tag>_tile_bench.json` (`--out`, default `build/tile_bench/`).
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


def load_smoke():
    """chip_smoke.py of this checkout, for its timers and seeded states."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(lib: Path):
    """The resource lines nvcc's -Xptxas -v wrote into the build log."""
    log = lib.with_name(lib.name + ".log").read_text().splitlines()
    return [ln.strip() for ln in log
            if re.search(r"Compiling|registers|spill|stack", ln)]


INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_functions(text: str):
    """{mangled name: [opcode, ...]} of every function in cuobjdump's
    -sass output."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = INSN.search(line)
        if name and m:
            funcs[name].append(m.group(2))
    return funcs


def sass_report(lib: Path, out: Path, match: str = "tile_kernel"):
    """Instruction counts of each kernel of `lib` whose name holds `match`:
    the total, and the gaps between consecutive shared stores (STS), one
    per cell-substep of a 2D substep body."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr}")
    out.write_text(proc.stdout)
    report = {}
    for name, ops in sass_functions(proc.stdout).items():
        if match not in name:
            continue
        sts = [i for i, op in enumerate(ops) if op.startswith("STS")]
        gaps = [b - a for a, b in zip(sts, sts[1:])]
        hist = {}
        for op in ops:
            key = op.split(".")[0]
            hist[key] = hist.get(key, 0) + 1
        report[name] = {"instructions": len(ops), "sts_gaps": gaps,
                        "opcodes": dict(sorted(hist.items(),
                                               key=lambda kv: -kv[1]))}
    return report


def find_nvcc():
    from fib_tf_tpu_torch.kernels import build
    return build.find_nvcc()


def sample_clocks(torch, launch, seconds: float = 2.0):
    """nvidia-smi's SM clock (MHz) and power draw (W), sampled every 0.2 s
    while `launch` runs back to back for about `seconds`: the clock at
    which the kernel's instructions issue."""
    import threading
    import time

    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30).stdout
            mhz, watts = out.strip().splitlines()[0].split(",")
            samples.append((float(mhz), float(watts)))
            time.sleep(0.2)

    launch()
    torch.cuda.synchronize()
    poller = threading.Thread(target=poll)
    poller.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(100):
            launch()
        torch.cuda.synchronize()
    stop.set()
    poller.join()
    return {"sm_mhz": [m for m, _ in samples],
            "power_w": [w for _, w in samples]}


# (depth, height, width) timed with --volume: the main volume past the
# reference's cutover, the sharded path's whole volume, the main substep
# volume, and one four times the first (does the tiled kernel win past
# 64 MB?)
VOLUME_SHAPES = ((8, 512, 512), (32, 128, 512), (8, 128, 512),
                 (8, 1024, 1024))


def volume_bench(args, smoke, card, out_dir):
    """--volume: kernel 5 and the substep route."""
    import numpy as np
    import torch
    from fib_tf_tpu_torch import SimConfig, interop
    from fib_tf_tpu_torch.engine import volume
    from fib_tf_tpu_torch.models import BeelerReuter
    from fib_tf_tpu_torch.ops import cuda_volume
    from fib_tf_tpu_torch.ops import cuda_volume_tiled as cvt

    result = {"tag": args.tag, "card": card}
    libs = {"br_volume_tiled": cvt.KERNEL.build(),
            "br_volume": cuda_volume.KERNEL.build()}
    for name, lib in libs.items():
        lines = ptxas_lines(lib)
        result[f"{name} ptxas"] = lines
        for ln in lines:
            print(f"  {name} ptxas: {ln}", flush=True)
        rep = sass_report(lib, out_dir / f"{args.tag}_{name}.sass", "volume")
        for fn, r in rep.items():
            top = dict(list(r["opcodes"].items())[:24])
            print(f"  {name} SASS {fn[:60]}: {r['instructions']} "
                  f"instructions; opcodes {top}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(smoke.SEED)
    us = smoke.device_us
    for d, h, w in VOLUME_SHAPES:
        model = BeelerReuter(SimConfig(**dict(smoke.VOL_CFG, height=h,
                                              width=w)))
        base = smoke.seeded_volume(torch, interop, volume, cuda_volume,
                                   model, d, dev, rng)
        st = smoke.clone(base)
        size = f"{d}x{h}x{w}"
        t = {}
        substep = cuda_volume.make_volume_step(model, d)
        t["substep_route_us"] = us(torch, lambda: substep(st), reps=100)
        try:
            tiled = cvt.make_tiled_volume_step(model, d)
        except ValueError as e:   # a package whose kernel 5 refuses d
            print(f"[{args.tag}] {size}: kernel 5 refuses it ({e})",
                  flush=True)
        else:
            t["kernel5_us"] = us(torch, lambda: tiled(st), reps=100)
        t["substep_route_again_us"] = us(torch, lambda: substep(st),
                                         reps=100)
        route = (t["substep_route_us"] + t["substep_route_again_us"]) / 2
        result[size] = t
        parts = ", ".join(
            f"{k[:-3]} {v:.3f} us (ratio {v / route:.4f})"
            for k, v in t.items() if not k.startswith("substep"))
        print(f"[{args.tag}] {size}: substep route "
              f"{t['substep_route_us']:.3f} / {t['substep_route_again_us']:.3f}"
              f" us; {parts} [{card}]", flush=True)
    (out_dir / f"{args.tag}_volume_bench.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(HERE),
                   help="checkout whose fib_tf_tpu_torch is timed")
    p.add_argument("--tag", default="this", help="name of the run")
    p.add_argument("--out", default=str(HERE / "build" / "tile_bench"),
                   help="directory for the SASS and the JSON")
    p.add_argument("--volume", action="store_true",
                   help="time the tiled volume kernel (kernel 5)")
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    smoke = load_smoke()
    if not torch.cuda.is_available():
        smoke.fail("torch_tile_bench needs a CUDA card")
    from fib_tf_tpu_torch import SimConfig, interop
    from fib_tf_tpu_torch.models import BeelerReuter
    from fib_tf_tpu_torch.ops import cuda_block, cuda_step, cuda_tiled

    smoke.check(Path(cuda_tiled.__file__).resolve().is_relative_to(root),
                f"imported {cuda_tiled.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"[{args.tag}] package {root / 'fib_tf_tpu_torch'}", flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.volume:
        volume_bench(args, smoke, card, out_dir)
        return
    result = {"tag": args.tag, "card": card}

    libs = {"br_tiled": cuda_tiled.KERNEL.build(),
            "br_block": cuda_block.KERNEL.build()}
    cuda_step.KERNEL.build()
    for name, lib in libs.items():
        lines = ptxas_lines(lib)
        result[f"{name}_ptxas"] = lines
        for ln in lines:
            print(f"  {name} ptxas: {ln}", flush=True)
        rep = sass_report(lib, out_dir / f"{args.tag}_{name}.sass")
        result[f"{name}_sass"] = rep
        for fn, r in rep.items():
            print(f"  {name} SASS {fn}: {r['instructions']} instructions; "
                  f"gaps between STS {r['sts_gaps']}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(smoke.SEED)
    cfg = SimConfig(**smoke.CFG_LARGE)
    large = BeelerReuter(cfg)
    base = smoke.seeded_state(torch, interop, large, dev,
                              cuda_step.plain_step, rng)
    params = cuda_step.pack_params(large)
    stream = torch.cuda.current_stream().cuda_stream
    sched = cuda_step.slow_schedule(large)
    clone = smoke.clone
    us = smoke.device_us

    def tiled_us(model, state, schedule, reps=50):
        st = clone(state)
        return us(torch, lambda: cuda_tiled.KERNEL.launch(
            params, st, schedule, None, model.probe_pixel, 0, stream),
            reps=reps)

    t = {"tiled_2048_us": tiled_us(large, base, sched)}
    st = clone(base)
    substep = cuda_step.make_cuda_step(large)
    t["substep_route_2048_us"] = us(torch, lambda: substep(st), reps=50)
    t["tiled_over_substep"] = t["tiled_2048_us"] / t["substep_route_2048_us"]
    odd = BeelerReuter(cfg.replace(height=2047, width=2047))
    odd_state = {k: v[:2047, :2047].contiguous() for k, v in base.items()}
    t["tiled_2047_us"] = tiled_us(odd, odd_state, sched)

    t["clocks"] = sample_clocks(torch, lambda: cuda_tiled.KERNEL.launch(
        params, st, sched, None, large.probe_pixel, 0, stream))

    k = large.dt_per_step
    for name, (rstart, cstart, ext_h, ext_w, two_d) in {
            "block_522x2048": (512 - k, 0, 512 + 2 * k, 2048, False),
            "block_1034x1034": (1024 - k, 1024 - k, 1024 + 2 * k,
                                1024 + 2 * k, True)}.items():
        ext = smoke.wrapped_window(base, (rstart, cstart), (ext_h, ext_w))
        dst = {kk: torch.zeros_like(v) for kk, v in ext.items()}
        t[f"{name}_us"] = us(torch, lambda: cuda_block.KERNEL.launch(
            params, ext, dst, rstart, cstart, k, two_d, 2048, 2048, sched,
            None, large.probe_pixel, 0, stream), reps=100)

    # the memory-vs-compute splits (chip_smoke.time_split)
    t["split"] = smoke.split_tiled(torch, cuda_step, cuda_tiled, large, base)
    ext = smoke.wrapped_window(base, (512 - k, 0), (512 + 2 * k, 2048))
    dst = {kk: torch.zeros_like(v) for kk, v in ext.items()}
    t["block_split"] = smoke.time_split(
        torch, lambda schedule: cuda_block.KERNEL.launch(
            params, ext, dst, 512 - k, 0, k, False, 2048, 2048, schedule,
            None, large.probe_pixel, 0, stream),
        lambda n: smoke.tile_count(cuda_tiled, n, 512, 2048),
        ext_rows=smoke.tile_rows(cuda_tiled))
    result.update(t)

    print(f"[{args.tag}] kernel 2 at 2048^2: {t['tiled_2048_us']:.3f} us; "
          f"substep route {t['substep_route_2048_us']:.3f} us; ratio "
          f"{t['tiled_over_substep']:.4f}; at 2047^2 {t['tiled_2047_us']:.3f}"
          f" us [{card}]", flush=True)
    print(f"[{args.tag}] while kernel 2 runs: SM clock "
          f"{t['clocks']['sm_mhz']} MHz, power {t['clocks']['power_w']} W",
          flush=True)
    print(f"[{args.tag}] kernel 3: 522x2048 block "
          f"{t['block_522x2048_us']:.3f} us, 1034x1034 block "
          f"{t['block_1034x1034_us']:.3f} us [{card}]", flush=True)
    smoke.print_split(f"[{args.tag}] br_tiled at 2048^2", t["split"], card)
    smoke.print_split(f"[{args.tag}] br_block on 522x2048",
                      t["block_split"], card)
    (out_dir / f"{args.tag}_tile_bench.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items()
                      if not k.endswith("_sass")}), flush=True)


if __name__ == "__main__":
    main()
