#!/usr/bin/env python
"""Run the six Beeler-Reuter kernels of fib_tf_tpu_torch on one CUDA card
and record a digest of every output plane and each kernel's device time,
so that two versions of the kernels (e.g. a commit and its parent) can be
held bit for bit against each other and timed in one call.

  python tools/torch_br_parity.py --root DIR --tag parent --out A.json
  python tools/torch_br_parity.py --tag this --out B.json
  python tools/torch_br_parity.py --compare A.json B.json [C.json ...]

Each run imports the package under `--root` (default: this checkout),
builds its kernels, and advances seeded BR cheby+skip states made here with
numpy (the same in every run): kernel 1 (`make_cuda_step`) and kernel 2
(`make_tiled_cuda_step`) two outer steps at 512x512 and 2048x2048, kernel
3 (`make_block_step`) one outer step of the interior 522x2048 block of a
4x1 mesh, kernel 4 (`make_volume_step`) and kernel 5
(`make_tiled_volume_step`) two outer steps at 8x128x512 and 8x512x512,
kernel 6 (`make_volume_block_step`) one group on the interior 18x128x512
block of a 32x128x512 volume; and the GEOM entries of kernels 1-3 under
chip_smoke.py's geometry (c) (a hole, a diffusion map and fibers at 30
degrees): kernel 1 two outer steps at 512x512, kernel 2 one at 2048x2048,
kernel 3 one on the 522x2048 block.  It writes the SHA-256 of every output
plane and the device time per call of each step (chip_smoke.device_us) with the
card's name and power limit to `--out`.  `--compare` prints, for each
kernel, whether all runs' planes are bit-equal and each run's time, and
exits 1 when a plane differs.  Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
SEED = 1234


def load_smoke():
    """chip_smoke.py of this checkout, for its timer and seeded states."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(state):
    """SHA-256 of each plane's bytes, by plane name."""
    return {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
            for k, v in sorted(state.items())}


def run(args):
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from fib_tf_tpu_torch import SimConfig, interop
    from fib_tf_tpu_torch.engine import volume
    from fib_tf_tpu_torch.models import BeelerReuter
    from fib_tf_tpu_torch.ops import (cuda_block, cuda_step, cuda_tiled,
                                      cuda_volume, cuda_volume_block,
                                      cuda_volume_tiled, stencil)

    smoke = load_smoke()
    if not torch.cuda.is_available():
        smoke.fail("needs a CUDA card")
    smoke.check(Path(cuda_step.__file__).resolve().is_relative_to(root),
                f"imported {cuda_step.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    cfg = SimConfig(**smoke.CFG)
    out = {"tag": args.tag, "root": str(root), "card": card, "kernels": {}}

    def record(name, step, base, n, call=None):
        """`n` calls of `step` on a copy of `base`: the planes' digest
        and the device time of one call."""
        state = smoke.clone(base)
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        timed = smoke.clone(base)
        us = smoke.device_us(torch, call or (lambda: step(timed)), reps=20)
        out["kernels"][name] = {"planes": digest(state), "us": us}
        print(f"  {name}: {us:.3f} us per call [{card}]", flush=True)

    def seeded(model):
        return smoke.seeded_state(torch, interop, model, dev,
                                  cuda_step.plain_step, rng)

    def seeded_volume(model, depth):
        return smoke.seeded_volume(torch, interop, volume, cuda_volume,
                                   model, depth, dev, rng)

    small, large = BeelerReuter(cfg), BeelerReuter(
        SimConfig(**smoke.CFG_LARGE))
    base, base_large = seeded(small), seeded(large)
    record("kernel 1 (512x512)", cuda_step.make_cuda_step(small), base, 2)
    record("kernel 2 (2048x2048)", cuda_tiled.make_tiled_cuda_step(large),
           base_large, 2)
    k = large.dt_per_step
    ext = smoke.wrapped_window(base_large, (512 - k, 0), (512 + 2 * k, 2048))
    block = cuda_block.make_block_step(large, False)

    def block_step(state):
        nxt = {kk: torch.zeros_like(v) for kk, v in state.items()}
        return block(state, nxt, 512 - k)

    ext_timed = smoke.clone(ext)
    ext_out = {kk: torch.zeros_like(v) for kk, v in ext.items()}
    record("kernel 3 (522x2048 block)", block_step, ext, 1,
           lambda: block(ext_timed, ext_out, 512 - k))
    vcfg = SimConfig(**smoke.VOL_CFG)
    vmodel, vlarge = BeelerReuter(vcfg), BeelerReuter(
        SimConfig(**smoke.VOL_CFG_LARGE))
    vbase = seeded_volume(vmodel, 8)
    record("kernel 4 (8x128x512)", cuda_volume.make_volume_step(vmodel, 8),
           vbase, 2)
    record("kernel 5 (8x512x512)",
           cuda_volume_tiled.make_tiled_volume_step(vlarge, 8),
           seeded_volume(vlarge, 8), 2)
    deep = seeded_volume(vmodel, 32)
    zext = smoke.wrapped_window(deep, (8 - k,), (8 + 2 * k,))
    group = cuda_volume_block.make_volume_block_step(vmodel, 8 + 2 * k, 32)
    spare = torch.empty_like(zext["V"])

    def group_step(state):
        return group(state, torch.empty_like(state["V"]), 8 - k)[0]

    def timed_group():
        nonlocal spare
        _, spare = group(zext_timed, spare, 8 - k)

    zext_timed = smoke.clone(zext)
    record("kernel 6 (18x128x512 block)", group_step, zext, 1, timed_group)

    def geometry(h, w):
        """chip_smoke.geometry_maps' geometry (c) as the steps take it."""
        phase = stencil.add_hole_to_phase_field(
            None, h, w, w * 150 // 512, h * 200 // 512, max(w * 40 // 512, 4))
        phase = stencil.add_hole_to_phase_field(
            phase, h, w, w / 2, h / 2, min(h, w) / 2 + 10, neg=True)
        return dict(phase=phase, dmap=stencil.fibrosis_map(
            h, w, density=0.25, strength=0.8, seed=0),
            fiber=stencil.fiber_tensor(np.deg2rad(smoke.FIBER_DEG),
                                       smoke.FIBER_RATIO))

    record("kernel 1 GEOM (512x512)",
           cuda_step.make_cuda_step(small, **geometry(512, 512)), base, 2)
    geo = geometry(2048, 2048)
    record("kernel 2 GEOM (2048x2048)",
           cuda_tiled.make_tiled_cuda_step(large, **geo), base_large, 1)
    gblock = cuda_block.make_block_step(large, False, fiber=geo["fiber"])
    rows = slice(512 - k, 1024 + k)
    maps = {name: torch.as_tensor(np.ascontiguousarray(geo[name][rows]),
                                  dtype=torch.float32, device=dev)
            for name in ("phase", "dmap")}

    def gblock_step(state):
        nxt = {kk: torch.zeros_like(v) for kk, v in state.items()}
        return gblock(state, nxt, 512 - k, 0, phase_ext=maps["phase"],
                      dmap_ext=maps["dmap"])

    record("kernel 3 GEOM (522x2048 block)", gblock_step, ext, 1,
           lambda: gblock(ext_timed, ext_out, 512 - k, 0,
                          phase_ext=maps["phase"], dmap_ext=maps["dmap"]))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"tag": args.tag, "kernels": len(out["kernels"])}))


def compare(paths):
    runs = [json.loads(Path(p).read_text()) for p in paths]
    ok = True
    for name in runs[0]["kernels"]:
        planes = [r["kernels"][name]["planes"] for r in runs]
        same = all(p == planes[0] for p in planes)
        ok = ok and same
        times = ", ".join(f"{r['tag']} {r['kernels'][name]['us']:.3f}"
                          for r in runs)
        print(f"{name}: all {len(planes[0])} planes bit-equal across "
              f"{len(runs)} runs: {same}; us per call: {times} "
              f"[{runs[0]['card']}]", flush=True)
    return ok


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(HERE),
                   help="checkout whose fib_tf_tpu_torch to run")
    p.add_argument("--tag", default="this", help="name of the run")
    p.add_argument("--out", default=str(HERE / "build" / "br_parity.json"))
    p.add_argument("--compare", nargs="+", metavar="JSON",
                   help="compare the records of earlier runs instead")
    args = p.parse_args()
    if args.compare:
        sys.exit(0 if compare(args.compare) else 1)
    run(args)


if __name__ == "__main__":
    main()
