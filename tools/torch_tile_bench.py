#!/usr/bin/env python
"""Time the 2D tile skeleton of fib_tf_tpu_torch (csrc/br_tile.cuh) or, with
--volume, the tiled volume kernel (csrc/br_volume_tiled.cu) on one CUDA
card, and show what the compiler made of it.

  python tools/torch_tile_bench.py                     # this checkout
  python tools/torch_tile_bench.py --root DIR --tag parent
                                                       # DIR's package
  python tools/torch_tile_bench.py --volume [--root DIR --tag T]
  python tools/torch_tile_bench.py --sass [--root DIR --tag T]
  python tools/torch_tile_bench.py --compare-sass A_sass.json B_sass.json

With --sass it builds every library of the package and times nothing: it
writes each library's SASS, a hash of each function's SASS and the class
counts per cell-substep of BR's tile kernels to `<out>/<tag>_sass.json`;
--compare-sass lists the functions of two such censuses whose SASS
differs, and exits 1 when one differs that does not hold BR's main body
(kernel 5 hosts it alone), or with --match REGEX one whose
`library:function` name REGEX does not find: every other function must
be identical.

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
    per cell-substep), written in full to `<out>/<tag>_*.sass`, and per
    cell-substep (frozen and SLOW, clamp-free and edge body) the
    instructions by class: constant loads (ULDC, LDC), FFMA / FMUL /
    FADD, MUFU, LDS / STS, branches and barriers, and the rest;
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


def sass_functions(text: str, lines: bool = False):
    """{mangled name: [opcode, ...]} of every function in cuobjdump's
    -sass output (`lines`: the whole instruction lines instead)."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = INSN.search(line)
        if name and m:
            # cuobjdump pads its columns to the file's longest line
            funcs[name].append(" ".join(line.split()) if lines
                               else m.group(2))
    return funcs


# The classes of SASS instructions counted per cell-substep, by opcode
# (without its modifiers); every other opcode is "other".
OP_CLASSES = {
    "const_load": ("ULDC", "LDC"),
    "float": ("FFMA", "FMUL", "FADD"),
    "mufu": ("MUFU",),
    "shared": ("LDS", "STS"),
    "control": ("BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY",
                "BSYNC", "BREAK", "BAR", "WARPSYNC"),
}


def op_class(op: str) -> str:
    base = op.split(".")[0]
    for cls, names in OP_CLASSES.items():
        if base in names:
            return cls
    return "other"


def classify(ops):
    """{class: count} of a run of opcodes, with their total and, among the
    constant loads, the LDC ones: a load into every thread's registers,
    where ULDC loads a uniform register once for the warp."""
    counts = dict.fromkeys((*OP_CLASSES, "other"), 0)
    for op in ops:
        counts[op_class(op)] += 1
    counts["total"] = len(ops)
    counts["ldc"] = sum(op.split(".")[0] == "LDC" for op in ops)
    return counts


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_instructions(lines):
    """(address, predicate, opcode, operands) of cuobjdump's instruction
    lines."""
    out = []
    for line in lines:
        m = SASS_LINE.search(line)
        if m:
            out.append((int(m.group(1), 16), (m.group(2) or "").strip(),
                        m.group(3), m.group(4).strip()))
    return out


def cell_substeps(insns):
    """Class counts per cell-substep of a 2D tile kernel, from its
    instructions (`sass_instructions`).  The function is cut into runs at
    every unconditional jump, barrier and exit and at its target, at loop
    heads and before each run of cp.async copies (LDGSTS), so that a run
    holds one form of the substep: its rows, each ending in the shared
    store of the new V (STS to a register address; the walk's stores use a
    uniform one), and what the form does once for all of them.  Code that
    only the last substep runs (a forward conditional jump over global
    stores, STG) is left out.  Each run with rows is labelled SLOW (100 or
    more FFMA a row: fourteen fits of eight terms; a frozen one computes
    six) or frozen, and edge (integer min / max: the clamps of the edge
    body) or clamp-free, with its class counts over its rows."""
    index = {a: i for i, (a, *_) in enumerate(insns)}
    n = len(insns)

    def v_store(i):
        return insns[i][2].startswith("STS") and "[R" in insns[i][3]

    cuts, skipped = {0, n}, [False] * n
    for i, (_, pred, op, args) in enumerate(insns):
        base = op.split(".")[0]
        if base in ("BRA", "EXIT", "RET", "BAR") and not pred:
            cuts.add(i + 1)
        if base == "LDGSTS" and not insns[i - 1][2].startswith("LDGSTS"):
            cuts.add(i)
        if base != "BRA":
            continue
        t = index.get(int(args.split()[-1], 16))
        if t is None:
            continue
        if t <= i or not pred:
            cuts.add(t)   # a loop head, or where two forms join
            continue
        if not any(insns[k][2].startswith("STG") for k in range(i + 1, t)):
            continue
        # skip the last substep's stores: past them, up to the next row
        stores = [k for k in range(i + 1, t) if v_store(k)]
        stop = t if not stores else max(
            [k + 1 for k in range(i + 1, stores[0])
             if insns[k][2].startswith("STG")], default=i + 1)
        for k in range(i + 1, stop):
            skipped[k] = True
    cuts = sorted(cuts)
    runs = []
    for a, b in zip(cuts, cuts[1:]):
        kept = [insns[k][2] for k in range(a, b) if not skipped[k]]
        rows = sum(v_store(k) for k in range(a, b) if not skipped[k])
        if not rows:
            continue
        bases = [op.split(".")[0] for op in kept]
        slow = bases.count("FFMA") >= 100 * rows
        edge = any(op in ("IMNMX", "VIMNMX") for op in bases)
        counts = classify(kept)
        runs.append({"kind": ("slow" if slow else "frozen") +
                     ("_edge" if edge else "_clamp_free"), "rows": rows,
                     **{k: v / rows for k, v in counts.items()}})
    return runs


def per_kind(runs):
    """{kind: {class: count per cell-substep}} over the runs of each kind
    (their rows' mean), with the runs and rows counted."""
    out = {}
    for kind in sorted({r["kind"] for r in runs}):
        these = [r for r in runs if r["kind"] == kind]
        rows = sum(r["rows"] for r in these)
        out[kind] = {k: round(sum(r[k] * r["rows"] for r in these) / rows, 2)
                     for k in these[0] if k not in ("kind", "rows")}
        out[kind].update(runs=len(these), rows=rows)
    return out


def cuobjdump_sass(lib: Path) -> str:
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr}")
    return proc.stdout


def sass_report(lib: Path, out: Path, match: str = "tile_kernel"):
    """Instruction counts of each kernel of `lib` whose name holds `match`:
    the total, the gaps between consecutive shared stores (STS), one per
    cell-substep of a 2D substep body, and the class counts of the
    cell-substeps among them (`cell_substeps`, `per_kind`)."""
    text = cuobjdump_sass(lib)
    out.write_text(text)
    report = {}
    for name, lines in sass_functions(text, lines=True).items():
        if match not in name:
            continue
        insns = sass_instructions(lines)
        ops = [op for _, _, op, _ in insns]
        sts = [i for i, op in enumerate(ops) if op.startswith("STS")]
        gaps = [b - a for a, b in zip(sts, sts[1:])]
        hist = {}
        for op in ops:
            key = op.split(".")[0]
            hist[key] = hist.get(key, 0) + 1
        runs = cell_substeps(insns)
        report[name] = {"instructions": len(ops), "sts_gaps": gaps,
                        "cell_substeps": runs,
                        "per_cell_substep": per_kind(runs),
                        "opcodes": dict(sorted(hist.items(),
                                               key=lambda kv: -kv[1]))}
    return report


def print_per_kind(label: str, fn: str, kinds):
    for kind, c in kinds.items():
        parts = ", ".join(f"{k} {v:g}" for k, v in c.items())
        print(f"  {label} SASS {fn[:72]} per {kind} cell-substep: {parts}",
              flush=True)


def all_libraries():
    """{library name: kernel binding} of every library of the port's six
    kernel modules (as chip_smoke.py's phase 1 builds them)."""
    from fib_tf_tpu_torch.ops import (cuda_block, cuda_step, cuda_tiled,
                                      cuda_volume, cuda_volume_block,
                                      cuda_volume_tiled)
    libraries = {}
    for mod in (cuda_step, cuda_tiled, cuda_volume, cuda_volume_tiled,
                cuda_block, cuda_volume_block):
        for kernel in (*getattr(mod, "KERNELS", {"br": mod.KERNEL}).values(),
                       *getattr(mod, "GEOM_KERNELS", {}).values()):
            libraries.setdefault(kernel.library_name, kernel)
    return libraries


def sass_census(args, out_dir: Path):
    """--sass: build every library, hash each function's SASS and count
    the cell-substeps of BR's tile kernels by class; no timing."""
    import concurrent.futures
    import hashlib

    libraries = all_libraries()
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        paths = dict(zip(libraries, pool.map(lambda k: k.build(),
                                             libraries.values())))
    result = {"tag": args.tag, "functions": {}, "tile_kernels": {},
              "ptxas": {}}
    for name, lib in sorted(paths.items()):
        text = cuobjdump_sass(lib)
        (out_dir / f"{args.tag}_{name}.sass").write_text(text)
        result["ptxas"][name] = ptxas_lines(lib)
        for fn, lines in sass_functions(text, lines=True).items():
            result["functions"][f"{name}:{fn}"] = hashlib.sha256(
                "\n".join(lines).encode()).hexdigest()
        for fn, lines in sass_functions(text, lines=True).items():
            if "tile_kernel" in fn and "BeelerReuterCell" in fn:
                kinds = per_kind(cell_substeps(sass_instructions(lines)))
                result["tile_kernels"][f"{name}:{fn}"] = kinds
                print_per_kind(name, fn, kinds)
    for name, lines in result["ptxas"].items():
        for ln in lines:
            print(f"  {name} ptxas: {ln}", flush=True)
    print(f"[{args.tag}] {len(result['functions'])} functions in "
          f"{len(paths)} libraries", flush=True)
    (out_dir / f"{args.tag}_sass.json").write_text(
        json.dumps(result, indent=1))


# The functions that hold BR's main body (its kernel 5 hosts no other):
# the only ones whose SASS a change of that body may alter.
BR_MAIN_BODY = r"BeelerReuterCell|^br_volume_tiled:"


def compare_sass(paths, match: str = BR_MAIN_BODY):
    """--compare-sass A B: the functions whose SASS differs between two
    --sass censuses; false when one whose `library:name` the regular
    expression `match` does not find differs or is missing from either."""
    # an anonymous namespace's mangled name carries a hash of the source's
    # path: two checkouts name the same function apart
    anon = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}(?=\d)")
    a, b = ({anon.sub("<anon>", fn): h
             for fn, h in json.loads(Path(p).read_text())["functions"].items()}
            for p in paths)
    ok = True
    for fn in sorted(set(a) | set(b)):
        if a.get(fn) == b.get(fn):
            continue
        expected = re.search(match, fn) is not None
        ok = ok and expected
        print(f"{'changed' if expected else 'DIFFERS'}: {fn}", flush=True)
    same = sum(a.get(fn) == b.get(fn) for fn in a)
    print(f"{same} of {len(a)} functions identical; none but those naming "
          f"{match!r} differ: {ok}", flush=True)
    return ok


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
    p.add_argument("--sass", action="store_true",
                   help="build every library, hash its SASS and count BR's "
                   "tile kernels per cell-substep; no timing")
    p.add_argument("--compare-sass", nargs=2, metavar="JSON",
                   help="the functions whose SASS differs between two "
                   "--sass censuses")
    p.add_argument("--match", default=BR_MAIN_BODY, metavar="REGEX",
                   help="with --compare-sass, the `library:function` "
                   "names that may differ (default: BR's main body)")
    args = p.parse_args()
    if args.compare_sass:
        sys.exit(0 if compare_sass(args.compare_sass, args.match) else 1)
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
    if args.sass:
        sass_census(args, out_dir)
        return
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
            print_per_kind(name, fn, r["per_cell_substep"])

    dev = torch.device("cuda")
    rng = np.random.default_rng(smoke.SEED)
    cfg = SimConfig(**smoke.CFG_LARGE)
    large = BeelerReuter(cfg)
    base = smoke.seeded_state(torch, interop, large, dev,
                              cuda_step.plain_step, rng)
    params = cuda_step.pack_params(large)
    stream = torch.cuda.current_stream().cuda_stream
    sched = large.launch_schedule
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
