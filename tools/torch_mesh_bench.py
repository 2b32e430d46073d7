#!/usr/bin/env python
"""Run the port's sharded wide-halo paths on a mesh of CUDA devices and
hold them against the unsharded runs on one card (fib_tf_tpu_torch).

  python tools/torch_mesh_bench.py                 # all visible cards
  python tools/torch_mesh_bench.py --repeat 4      # four shards on cuda:0
  python tools/torch_mesh_bench.py --cpu --size 64 --steps 20   # rehearsal

It runs `Simulation(BeelerReuter(cfg), mesh=..., wide_halo=True)` at
`--size`^2 on a rows x 1 mesh and, with four shards, on a 2 x 2 mesh, and
`run_volume(mesh=..., wide_halo=True)` at (8 x shards) x 128 x 512, each
against the same run without a mesh on the first device.  For every run it
prints the launches of the block kernels, whether the final state equals
the unsharded one bit for bit (the per-cell code is the same), and wall
seconds per simulated second, after the card's name and power limit.  Any
mismatch exits 1.  Imports no JAX.
"""

import argparse
import os
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

from fib_tf_tpu_torch import SimConfig
from fib_tf_tpu_torch.engine import Simulation, VolumeEvent, run_volume
from fib_tf_tpu_torch.models import BeelerReuter
from fib_tf_tpu_torch.ops import cuda_block, cuda_volume_block
from fib_tf_tpu_torch.parallel import make_mesh

ATOL_MV = 0.12   # 1e-3 of the model's range, the goldens' bound


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=2048, help="2D grid side")
    p.add_argument("--steps", type=int, default=400, help="outer steps")
    p.add_argument("--repeat", type=int, default=0,
                   help="build the mesh of this many entries of device 0 "
                        "instead of one shard per visible card")
    p.add_argument("--cpu", action="store_true",
                   help="rehearse on the CPU (plain PyTorch path)")
    args = p.parse_args()

    kind = "cpu" if args.cpu else "cuda"
    if kind == "cuda":
        if not torch.cuda.is_available():
            sys.exit("torch_mesh_bench: needs a CUDA device (or --cpu)")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = "; ".join(smi.stdout.strip().splitlines())
    else:
        card = "CPU rehearsal (no device time)"
    n_visible = 1 if args.cpu else torch.cuda.device_count()
    if args.repeat:
        devices = [f"{kind}:0" if kind == "cuda" else "cpu"] * args.repeat
    else:
        devices = [f"cuda:{i}" for i in range(n_visible)] if kind == "cuda" \
            else ["cpu"] * 4
    n = len(devices)
    first = torch.device(devices[0])
    print(f"{card}\nmesh of {n} shards on {devices}", flush=True)
    ok = True

    # -- 2D ---------------------------------------------------------------------
    dt_outer = 0.5   # ms per outer step: 5 substeps of 0.1 ms
    cfg = SimConfig(width=args.size, height=args.size, dt=0.1,
                    dt_per_plot=10, diff=0.809,
                    duration=args.steps * dt_outer, cheby=True, skip=True)
    ref = Simulation(BeelerReuter(cfg), device=first).define().simulate()
    print(f"2D {args.size}^2, {ref.steps} outer steps, unsharded on {first}: "
          f"{1.0 / ref.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
          f"[{card}]", flush=True)
    shapes = [(n,)] + ([(2, 2)] if n == 4 else [])
    for shape in shapes:
        sim = Simulation(BeelerReuter(cfg),
                         mesh=make_mesh(shape=shape, devices=devices),
                         wide_halo=True).define()
        cuda_block.KERNEL.reset_launches()
        res = sim.simulate()
        ok &= report(f"2D mesh {'x'.join(map(str, shape))}", res.state,
                     ref.state, cuda_block.KERNEL.launches,
                     n * res.steps if kind == "cuda" else 0,
                     1.0 / res.sim_seconds_per_wall_second,
                     res.elapsed / res.steps, card)

    # -- 3D ---------------------------------------------------------------------
    depth = 8 * n
    vcfg = cfg.replace(height=128, width=512) if not args.cpu else \
        cfg.replace(height=16, width=32)
    model = BeelerReuter(vcfg)
    events = [VolumeEvent(step=args.steps // 2, loc="luq", z1=depth // 2)]
    sim_s = args.steps * dt_outer / 1000.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # too deep for the tiled kernel
        run_volume(model, depth, 2, device=first)
        t0 = time.perf_counter()
        vref = run_volume(model, depth, args.steps, events=events,
                          device=first)
        ref_s = time.perf_counter() - t0
    print(f"3D {depth}x{vcfg.height}x{vcfg.width}, {args.steps} outer steps, "
          f"unsharded on {first}: {ref_s / sim_s:.6f} wall-s/sim-s [{card}]",
          flush=True)
    mesh = make_mesh(devices=devices)
    run_volume(model, depth, 2, mesh=mesh, wide_halo=True)
    cuda_volume_block.KERNEL.reset_launches()
    t0 = time.perf_counter()
    vres = run_volume(model, depth, args.steps, events=events, mesh=mesh,
                      wide_halo=True)
    wall = time.perf_counter() - t0
    ok &= report(f"3D mesh {n} (z)", vres[0], vref[0],
                 sum(cuda_volume_block.KERNEL.launches.values()),
                 5 * n * args.steps if kind == "cuda" else 0,
                 wall / sim_s, wall / args.steps, card)
    ok &= bool(np.array_equal(vres[1], vref[1]))
    sys.exit(0 if ok else 1)


def report(name, state, ref, launches, want_launches, wall_per_sim,
           s_per_step, card) -> bool:
    dv = float(np.abs(state["V"] - ref["V"]).max())
    same = all(np.array_equal(state[k], ref[k]) for k in ref)
    good = (dv <= ATOL_MV and launches == want_launches
            and bool(np.isfinite(state["V"]).all()))
    print(f"{name}: block-kernel launches {launches} (expected "
          f"{want_launches}); final V vs unsharded: max abs {dv:.4g} mV, "
          f"all planes bit-equal: {same}; {wall_per_sim:.6f} wall-s/sim-s, "
          f"host-paced {s_per_step * 1e6:.2f} us/outer step [{card}]"
          f"{'' if good else '  <-- MISMATCH'}", flush=True)
    return good


if __name__ == "__main__":
    main()
