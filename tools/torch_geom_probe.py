#!/usr/bin/env python
"""Two measurements behind the 2D geometry's design, on one CUDA card.

  python tools/torch_geom_probe.py [--tiles] [--float64]

--tiles: BR's GEOM entry of kernel 2 (`br_tiled_geom`) as the package
builds it (512 threads, 128 registers a thread) and at 1024 threads (64
registers), the shape of the isotropic entry: a copy of csrc/ under
build/ with that one line changed.  Prints each build's registers and
spills (-Xptxas -v) for BR's GEOM tile kernel, holds both against the
plain step at 2048x2048 under chip_smoke's geometry (c), and times both
and the isotropic entry (chip_smoke.device_us).

--float64: examples/fenton_spiral.py's run (Fenton 512x512, S2 at 210 ms,
400 outer steps), with and without its hole: kernel 1 against the plain
path in float32 and in float64, the max |u| distances every 50 outer
steps.  It shows whether the kernel's distance from the float32 plain run
past the S2's reentry is the kernel's rounding or float32's.

Without flags both run.  Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ptxas_lines(path: Path):
    """(kernel, line) of BR's GEOM tile kernel in the build log."""
    fn = None
    for line in path.with_name(path.name + ".log").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        if fn and "BeelerReuterCell" in fn and "tile_kernel" in fn and (
                "Lb1E" in fn) and re.search(r"registers|spill", line):
            yield fn, line.strip()


def tiles(torch, cs, card):
    from fib_tf_tpu_torch import SimConfig, interop
    from fib_tf_tpu_torch.kernels import build
    from fib_tf_tpu_torch.models import BeelerReuter
    from fib_tf_tpu_torch.ops import bodies, cuda_step, cuda_tiled, stencil

    dev = torch.device("cuda")
    repo = cuda_tiled.GEOM_KERNELS["br"]
    copy_dir = ROOT / "build" / "geom_probe_csrc"
    shutil.copytree(build.CSRC_DIR, copy_dir, dirs_exist_ok=True)
    src = copy_dir / "br_tiled.cu"
    old = "GEOM_ENTRIES(br, fibtorch::BeelerReuterCell, 64, 8, 8)"
    text = src.read_text()
    if old not in text:
        sys.exit(f"{src} has no line {old!r}")
    src.write_text(text.replace(
        old, "GEOM_ENTRIES(br, fibtorch::BeelerReuterCell, 64, 16, 4)"))
    saved = dict(cuda_tiled.GEOM_TILES)
    try:
        cuda_tiled.GEOM_TILES.pop("br", None)
        wide = cuda_tiled.TiledKernel("br", geom=True)
        wide.source = src      # its headers are the copies beside it
        wide.library()
        wide_path = wide.build()
    finally:
        cuda_tiled.GEOM_TILES.update(saved)
    repo.library()
    kernels = (("512 threads (the package's)", repo, repo.build()),
               ("1024 threads (copy)", wide, wide_path))
    for label, _, path in kernels:
        for _, line in ptxas_lines(path):
            print(f"  {label}: {line}", flush=True)

    rng = np.random.default_rng(cs.SEED)
    model = BeelerReuter(SimConfig(**dict(cs.CFG, width=2048, height=2048)))
    base = cs.seeded_state(torch, interop, model, dev, cuda_step.plain_step,
                           rng)
    maps = cs.geometry_maps(bodies, stencil, "c", (2048, 2048))
    params = bodies.pack_params(model)
    schedule = model.launch_schedule
    stream = torch.cuda.current_stream().cuda_stream
    want = cs.clone(base)
    cuda_step.plain_step(model, want, geom=maps.plain(dev))
    for label, kern, _ in kernels:
        got = cs.clone(base)
        kern.launch(params, got, schedule, None, model.probe_pixel, 0,
                    stream, maps.args(dev))
        torch.cuda.synchronize()
        cs.compare(f"br_tiled_geom, {label}", got, want)
        state = cs.clone(base)
        us = cs.device_us(torch, lambda: kern.launch(
            params, state, schedule, None, model.probe_pixel, 0, stream,
            maps.args(dev)), reps=30)
        print(f"  br_tiled_geom {label}: {us:.2f} us per outer step at "
              f"2048x2048, geometry (c) [{card}]", flush=True)
    state = cs.clone(base)
    iso = cuda_tiled.make_tiled_cuda_step(model)
    print(f"  br_tiled (isotropic): "
          f"{cs.device_us(torch, lambda: iso(state), reps=30):.2f} us per "
          f"outer step [{card}]", flush=True)


def float64(torch, card):
    from fib_tf_tpu_torch import SimConfig, interop
    from fib_tf_tpu_torch.models import Fenton4v
    from fib_tf_tpu_torch.ops import bodies, cuda_step, stencil

    dev = torch.device("cuda")
    cfg = SimConfig(width=512, height=512, dt=0.1, dt_per_plot=10, diff=1.5,
                    duration=400)
    model = Fenton4v(cfg)
    mask = torch.tensor(stencil.pace_mask(512, 512, "luq", 1.0, model.min_v),
                        device=dev)
    fire = cfg.millisecond_to_step(210.0, model.dt_per_step) + 1
    for label, hole in (("hole (256, 256), r 30", (256, 256, 30)),
                        ("no hole", None)):
        phase = (stencil.add_hole_to_phase_field(None, 512, 512, *hole)
                 if hole else None)
        geom = bodies.GeometryMaps((512, 512), phase).plain(dev)
        init = model.initial_state()
        kernel = interop.state_from_numpy(init, dev)
        plain = interop.state_from_numpy(init, dev)
        exact = {k: v.double() for k, v in plain.items()}
        step = cuda_step.make_cuda_step(model, phase)
        for i in range(cfg.samples(model.dt_per_step)):
            kernel = step(kernel)
            cuda_step.plain_step(model, plain, geom=geom)
            cuda_step.plain_step(model, exact, geom=geom)
            if i + 1 == fire:
                for s in (kernel, plain, exact):
                    s["u"] = torch.maximum(s["u"], mask.to(s["u"].dtype))
            if (i + 1) % 50 == 0:
                k, p, e = kernel["u"].double(), plain["u"].double(), exact["u"]
                print(f"  {label}, outer step {i + 1}: max |u| kernel - "
                      f"plain {float((k - p).abs().max()):.3g}, kernel - "
                      f"float64 {float((k - e).abs().max()):.3g}, plain - "
                      f"float64 {float((p - e).abs().max()):.3g} [{card}]",
                      flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--float64", action="store_true")
    args = ap.parse_args()
    if not (args.tiles or args.float64):
        args.tiles = args.float64 = True
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    if args.tiles:
        tiles(torch, cs, card)
    if args.float64:
        float64(torch, card)


if __name__ == "__main__":
    main()
