#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (fib_tf_tpu_torch) on one NVIDIA GPU.

Run from the root of the checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on after a failure):
  1. the card's name and power limit, the torch/CUDA versions, and the
     build of all six kernels from csrc/ with nvcc (in parallel, sixteen
     libraries: kernels 2 and 3 build their GEOM entries, and kernels 1,
     4 and 6 their Courtemanche bodies and their Luo-Rudy and tp06 bodies,
     as second and third libraries of the same source, and kernel 3 those
     four bodies from csrc/large_block.cu, court_block and lrtp_block): the
     substep kernel br_substep.cu, the tiled outer-step kernel br_tiled.cu,
     the volume substep kernel br_volume.cu, the tiled volume kernel
     br_volume_tiled.cu, and the per-shard block kernels br_block.cu and
     br_volume_block.cu of the sharded paths (all but br_volume_tiled.cu
     host six cell bodies, one entry each: Beeler-Reuter's main path, its
     other variants without and with ab2, Fenton without and with ab2,
     Mitchell-Schaeffer); the -Xptxas -v lines of every kernel, and
     neither the tile skeleton's libraries (br_tiled, br_block and their
     GEOM libraries) nor the tiled volume kernel may spill (nor the
     Courtemanche bodies' libraries, court_substep and court_volume: the
     same sources built with -DFIBTORCH_COURT_ENTRIES and -fmad=false; nor
     Luo-Rudy's and tp06's, lrtp_substep and lrtp_volume, built with
     -DFIBTORCH_LRTP_ENTRIES and -fmad=false; nor kernels 3 and 6's
     libraries of the four, court_block, lrtp_block, court_volume_block and
     lrtp_volume_block);
  2. substep kernel vs plain PyTorch on the card at 512x512, on a seeded
     state that holds a wavefront: one slow (n=5) launch, one frozen (n=0)
     launch and two outer steps, all 8 planes at rtol 1e-3 / atol 1e-5;
  3. the 512x512 main path, Simulation(BeelerReuter(cfg), device='cuda')
     .define().simulate() at the bench configuration for 400 ms: it must
     route 'substep', launch the substep kernel exactly 5 times per outer
     step and no other kernel, stay finite, cross the probe at outer
     step 332 +- 2 (the JAX engine's crossing), and end within
     WHOLE_RUN_ATOL_MV of the same run forced to kernel='xla';
  4. timings at 512x512: each substep body's device time per launch
     against the plain version's, the host launch overhead per outer step,
     and simulate()'s wall seconds per simulated second over 1000 ms;
  5. tiled kernel vs plain PyTorch on the card, all 8 planes and the probe
     at the same tolerance, skip on and off: 1 and 2 outer steps at
     2048x2048 on a seeded state that holds a wavefront, 2 outer steps at
     the ragged 67x131, 1031x517 and 2047x2047 (tiles of two sizes, many
     per persistent block), at 160x160 (a clamp-free tile among edge tiles
     in one launch) and at 9x12 (smaller than one tile), and 2 outer steps
     against the substep kernel at 512x512;
  6. the 2048x2048 main path (past the 32 MB cutover) for 700 ms: it must
     route 'tiled', launch the tiled kernel exactly once per outer step and
     no other kernel, stay finite, cross the probe at outer step
     1332 +- 2 (the JAX engine's crossing), and end within
     WHOLE_RUN_ATOL_MV of, and cross with, the same run forced to
     kernel='xla';
  7. timings of the tiled kernel: device time per outer step of the tiled
     kernel, the substep route (5 launches) and the plain outer step at
     2048x2048 and at 512x512; simulate()'s wall seconds per simulated
     second on the tiled route (phase 6's run), and at 512x512 for 1000 ms
     with the cutover lowered so that it takes the tiled route (held
     within WHOLE_RUN_ATOL_MV of phase 4's run); the ratio of the tiled
     kernel to the substep route at 2048x2048; and the tiled kernel's
     memory-vs-compute split (time_split: n_sub = 1..5, all frozen and all
     SLOW, per tile);
  8. volume substep kernel vs plain PyTorch at the same tolerance: at
     8x128x512 on a seeded state that holds a wavefront, one slow launch,
     one frozen launch and 2 outer steps, and 2 outer steps with
     dz_ratio=0.5; 2 outer steps at the ragged 5x67x131 and at depth 3,
     skip on and off;
  9. the volume path, run_volume(BeelerReuter(cfg), 8, 1000,
     device='cuda') at 8x128x512 with the cross-field S2 of
     examples/scroll_wave.py at outer step 700 over the lower half of the
     depth: it must route 'substep', launch the volume substep kernel
     exactly 1 slow + 4 frozen times per outer step and no other kernel,
     stay finite, cross the mid-depth probe at (332, 166.0) +- 2 steps
     (the 2D crossing: the S1 wave is planar), and end within
     WHOLE_RUN_ATOL_MV of, and cross with, the same run with kernel='xla';
 10. tiled volume kernel (z-streaming, any depth) vs plain PyTorch at the
     same tolerance, skip on and off: 1 and 2 outer steps at 8x512x512 on
     a seeded state, 2 outer steps at 32x128x512, the ragged 37x67x131 and
     5x67x131, at 4x9x12 (smaller than one tile) and at depth 3, and 2
     outer steps against the volume substep kernel at 8x128x512 (the max
     |diff| and whether the two routes are bit-equal);
 11. the tiled volume path: run_volume at 8x512x512 with phase 9's terms
     and the reference's 32 MB cutover: it must route 'tiled', launch the
     tiled volume kernel exactly once per outer step and no other kernel,
     and pass phase 9's checks; then the same run on the card's cutover,
     which routes 'substep' (the tiled kernel lost to it on the card) and
     must launch the volume substep kernel 1 slow + 4 frozen times per
     outer step and pass the same checks;
 12. volume timings: device time per launch of both volume substep bodies
     (and of their plain versions), and per outer step of the tiled
     volume kernel, the substep route and the plain outer step, at
     8x128x512, 8x512x512 and 32x128x512, with the tiled kernel's ratio to
     the substep route and its bound; run_volume's wall seconds per
     simulated second at 8x128x512 and at 8x512x512 on both routes, and
     with kernel='xla';
 13. block kernel vs plain PyTorch at the same tolerance: one shard's
     halo-extended block of the 2048x2048 domain, its ghosts cut from the
     seeded state (522x2048 on a 4x1 mesh: the top, an interior and the
     bottom shard; 1034x1034 on a 2x2 mesh: a corner shard), 1 and 2 outer
     steps, skip on and off, a 67x131 block of 2048x2048 (rows and columns
     split unevenly), and ragged 23x41 blocks of a 67x131 domain;
 14. volume block kernel vs plain PyTorch: one shard's 18x128x512 block
     (8 slices and 5 ghost slices each way) of a 32x128x512 volume, the
     top, an interior and the bottom shard, dz_ratio 1 and 0.5, 1 and 2
     outer steps, and groups of one substep without skip (halo_k=1);
 15. the sharded 2D main path, Simulation(BeelerReuter(cfg),
     mesh=make_mesh(devices=['cuda:0'] * 4), wide_halo=True).define()
     .simulate() at 2048x2048 for phase 6's 700 ms, four row shards on the
     one card, each on its own stream: it must launch the block kernel
     exactly 4 times per outer step and no other kernel, cross where phase
     6 did, and end within WHOLE_RUN_ATOL_MV of phase 6's unsharded run
     and of its kernel='xla' run, and bit-equal to phase 6's run; the same
     on a 2x2 mesh for 100 ms against an unsharded run of that length;
 16. the sharded volume path, run_volume(BeelerReuter(cfg), 32, 1000,
     mesh=<four z shards on cuda:0>, wide_halo=True) at 32x128x512 with the
     S2 of phase 9 over the lower half of the depth: it must launch the
     volume block kernel exactly 4 x (1 slow + 4 frozen) times per outer
     step and no other kernel, cross at (332, 166.0) +- 2 steps, and end
     within WHOLE_RUN_ATOL_MV of the unsharded run_volume of the same
     volume on the kernels, which must route 'substep' (the card's
     cutover) with no warning and launch the volume substep kernel 1 slow
     + 4 frozen times per outer step, and of the same run at the
     reference's cutover, which must route 'tiled' with no warning and
     launch the tiled volume kernel once per outer step; a 100-step run is
     held against kernel='xla';
 17. timings of the sharded paths: device time per outer step per shard
     of both block kernels and of their plain versions, the halo copies of
     one shard, the block kernel's memory-vs-compute split on the 522x2048
     block, the host-paced time per outer step, and wall seconds per
     simulated second of both sharded runs beside the unsharded ones;
 18. Fenton and Mitchell-Schaeffer on kernels 1-4 vs plain PyTorch, from
     states drawn per cell (the border differs from its neighbours, so a
     body that took the boundary-enforced centre for its rates fails),
     2 outer steps, every plane and the probe at rtol 1e-3 / atol 1e-5,
     with exact launches (ten per outer step on kernels 1 and 4, one on
     kernels 2 and 3): kernel 1 at 512x512 and 67x131, kernel 2 at
     2048x2048 and 67x131, kernel 3 on the 4x1 top, interior and bottom
     and the 2x2 corner blocks of 2048x2048 (K = 10 ghost rows), kernel 4
     at 16x512x512 and 5x67x131 with dz_ratio 1 and 0.5;
 19. Fenton, Table 1's row (512x512, dt 0.1, diff 1.5) for 400 ms:
     route 'substep', ten launches per outer step and no other kernel,
     the JAX engine's crossing (76) +- 2, final u within 1e-3 of
     kernel='xla'; timings of the launch, the outer step (device and
     host-paced), the tiled kernel at 512x512 and a 1000 ms run on either
     route;
 20. Fenton at 2048x2048 for 400 ms: route 'tiled', one launch per outer
     step, crossing (306) +- 2, within 1e-3 of kernel='xla'; the tiled
     kernel beside ten launches of kernel 1;
 21. Fenton at 2048x2048 on four row shards of cuda:0 (wide_halo, K =
     10): four block launches per outer step, bit-equal to phase 20's run;
 22. the Fenton scroll wave of examples/scroll_wave.py at --size 512
     --depth 16 (dt 0.05, S2 at 250 ms over z < 8, 600 ms): ten volume
     launches per outer step, crossing (144) +- 2, within 1e-3 of
     kernel='xla' and crossing with it;
 23. Mitchell-Schaeffer: 512x512 for 400 ms on kernel 1 (crossing 139
     +- 2, within 1e-3 of kernel='xla'), and 100 outer steps each on
     kernel 2 (2048x4096, 64 MB, against kernel='xla'), kernel 3 (4x1
     shards, bit-equal to kernel 2's run) and kernel 4 (16x512x512,
     against kernel='xla'), with exact launches; timings of all four
     (kernels 2 and 3 at 2048x2048, as Fenton's).
 24. the new (kernel, body) pairs vs plain PyTorch, 2 outer steps (2
     groups on kernel 6), every plane and the probe at rtol 1e-3 / atol
     1e-5 (the AB2 derivative planes at DERIVATIVE_ATOL; a cell outside
     them is arbitrated by a float64 plain run, see compare, and counted
     in the entry's "arbitrated_cells"), with exact launches: BrVariantCell<false/true> for VARIANT_CHECKS and
     FentonAb2Cell from seeded wavefront states (per-cell noise; the
     unfolded fits' too, whose cells at rest sit where the reference's
     tau_h fit is negative), on
     kernel 1 (512x512, 67x131), kernel 2 (2048x2048, 67x131), kernel 3
     (4x1 top and interior, 2x2 corner blocks of 2048x2048), kernel 4
     (8x128x512 or 16x512x512, and 5x67x131, dz_ratio 1 and 0.5) and
     kernel 6 (the top, interior and bottom shards of 32x128x512), and
     kernel 6 for BR's main body, Fenton and Mitchell-Schaeffer;
 25. Table 1 on the card: `python -m fib_tf_tpu bench`'s five rows at
     512x512 for 1000 ms, 3 runs each, printed in its JSON shape with the
     card's name; exact launches per run (2000 SLOW + 8000 frozen under
     skip, 10000 SLOW without, 10000 for Fenton), each run's first
     crossing within +- 2 steps of the JAX engine's, and each row within
     WHOLE_RUN_ATOL_MV (Fenton 1e-3) of kernel='xla' over 400 ms;
 26. Table 1's direct rows at 2048x2048 for 700 ms (kernel 2, once per
     outer step) and on four row shards of cuda:0 (kernel 3, bit-equal);
 27. BR cheby+skip+ab2 and Fenton ab2 (dt 0.025), with an S2 (pacing
     refreshes the derivative planes; Fenton's 512x512 run without):
     512x512 for 400 ms on kernel 1 against kernel='xla' and the JAX
     crossing; 2048x2048 on kernel 2 and four row shards on kernel 3,
     bit-equal;
 28. run_volume on kernel 4 with phase 9's S2 at 8x128x512, against
     kernel='xla': BR cheby+skip+ab2 (dt 0.05) for 1000 outer steps; BR
     direct (skip) to the S2's step, then kernel and plain substep by
     substep to 1000, where alpha_m's 0/0 at V = -47.0 mV exactly may turn
     a cell non-finite (direct_volume_after_s2);
     Fenton ab2 (dt 0.025) at 16x512x512 for 100 outer steps;
 29. 32x128x512 on four z shards of cuda:0 (kernel 6) for BR direct, BR
     ab2, Fenton, Fenton ab2 and Mitchell-Schaeffer (halo_k 5: groups of
     five of their ten substeps), 100 outer steps with an S2, bit-equal
     to the unsharded runs (kernel 4), or, where both end non-finite,
     bit-equal up to the outer step in which both turn
     (replay_to_non_finite);
 30. the device time, plain time and bound of every new pair;
 31. the 2D geometry's GEOM entries of kernels 1-3 (a phase field, a
     diffusion map, a fiber tensor; csrc/geometry.cuh) for all six bodies
     vs plain PyTorch under three geometries, (a) examples/br_spiral.py's
     hole plus a neg=True rim (phi < 1 on the border), (b) (a) plus
     fibrosis_map(0.25, 0.8, seed 0), (c) (b) plus fibers at 30 degrees,
     ratio 0.25: kernel 1 one launch and 2 outer steps at 512x512 and
     67x131; kernel 2 1 and 2 outer steps at 2048x2048, 2 at 67x131 and
     (c) at 2047x2047; kernel 3 on the 4x1 top and interior and the 2x2
     corner blocks of 2048x2048, 2 outer steps; exact launches;
 32. examples/br_spiral.py at 512x512 for 400 ms (hole (150, 200) r 40,
     S2 at 300 ms): route 'substep', 1 slow + 4 frozen GEOM launches per
     outer step and no other kernel, the JAX engine's crossing 332 +- 2,
     within WHOLE_RUN_ATOL_MV of kernel='xla';
 33. examples/fenton_spiral.py at 512x512 (hole (256, 256) r 30, S2 at
     210 ms), 400 ms: ten GEOM launches per outer step, crossing 76 +- 2,
     within 1e-3 of kernel='xla' or, past it, no further from a float64
     plain run than the float32 plain run is (the S2 breaks into reentry,
     where float32 rounding of any order grows);
 34. examples/fiber_anisotropy.py at 512 (Fenton, 30 degrees, ratio 0.25,
     20 ms): the wavefront's extents within a cell of the JAX engine's;
 35. BR at 2048x2048 for 700 ms with the hole (600, 800) r 160 and (b)'s
     fibrosis on kernel 2 (once per outer step), on 4x1 shards of cuda:0
     (kernel 3), and with (c)'s fibers unsharded and on 2x2 shards:
     sharded runs bit-equal to the unsharded ones;
 36. every body on every GEOM route through Simulation (10 outer steps,
     geometry (c)), exact launches, the 4x1 and 2x2 runs bit-equal to
     kernel 2's;
 37. the device time of every GEOM entry beside its isotropic entry, the
     plain version and the bound, and each full-width run's wall-s/sim-s;
 38. Courtemanche and Courtemanche-ultra's entries (court_substep,
     court_substep_geom, court_ultra_substep, court_ultra_substep_geom on
     kernel 1, court_volume and court_ultra_volume on kernel 4) vs plain
     PyTorch in every rate mode (direct, the hybrid fits with and without
     the folded gates; and direct with chronic=False, a dV cap and every
     g_scale factor): one launch of each form (the fast commit
     SLOW=false, the slow commit SLOW=true; ultra's full commit) and 2
     outer steps, every plane and the probe at rtol 1e-3 / atol 1e-5 (a
     cell outside them arbitrated by a float64 plain run and counted), at
     512x512 isotropic, under the annulus of examples/court_run.py and
     under geometry (c), and at 8x128x512; a direct-rate launch equal to
     plain bit for bit (court_cell.cuh rounds as the plain path does),
     the fitted modes' count of cells that differ printed; exact launches
     (11 per outer step for Courtemanche, 10 for ultra);
 39. examples/court_run.py's first model at 512x512 (dt 0.1, diff 0.809,
     the annulus, S2 at 350 ms, 1000 ms) on kernel 1's GEOM entry: exact
     launches and no other kernel, the JAX engine's first crossing (148)
     +- 2, the final V within 1e-3 of the model's range of kernel='xla' on
     the card or, past it, no further from a float64 plain run than the
     float32 plain run is (PR 9's rule), and the trend stream with it (to
     the S2 where arbitrated); probe_at_step read in the cl_observer;
 40. examples/court_ultra_run.py's run_small at 512x512 (diff 1.5, hole r
     10, S2 at 300 ms, 1000 ms) on court_ultra_substep_geom, with
     probe_at_step(i, 'ultra') read inside the cl_observer and held to the
     recorded stream; exact launches, the JAX engine's first crossing (119)
     +- 2, the final V, the trend and the ultra streams against
     kernel='xla' as in phase 39;
 41. a regional _p_chronic plane (the left half remodeled) at 512x512 for
     400 ms, both models on kernel 1, against kernel='xla' (past 1e-3 of
     the range, arbitrated by a float64 plain run, as in phase 39);
 42. run_volume of both models at 8x128x512 on kernel 4 (300 outer steps;
     ultra 100 at dt 0.05), against kernel='xla' (past 1e-3 of the range,
     arbitrated by a float64 plain run);
 43. the device time of every Courtemanche entry beside its plain version
     (timed between CUDA events as the stream runs it: its launches cannot
     queue behind the spin kernel) and its bound, and each run's
     wall-s/sim-s;
 44. Luo-Rudy 1991's and ten Tusscher-Panfilov 2006's entries on kernel 1
     (lr1_substep, tp06_substep) vs plain PyTorch at 512x512, one launch of
     each form and 2 outer steps, skip on and off: LR1 with g_si 0.02 set
     after construction and with every g_scale factor; tp06 in each cell
     type (m set after construction), transmural, with a g_kr plane alone,
     and with both and every g_scale factor; every launch bit-equal to
     plain (lr1_cell.cuh and tp06_cell.cuh round as the plain path does),
     exact launches;
 45. their GEOM entries under the annulus of examples/court_run.py and
     fibers (one launch of each form and 2 outer steps, bit-equal), and a
     20 ms Simulation of each with that geometry, bit-equal to
     kernel='xla' or no further from a float64 plain run than the
     float32 plain run is;
 46. their kernel-4 entries at 8x128x512 (bit-equal, as in 44) and
     run_volume for 50 outer steps against kernel='xla' (tp06's wedge
     banded along z, transmural_volume_state);
 47. the main path at full width under 'auto': examples/lr1_spiral.py
     (512x512, dt 0.02, diff 0.809, g_si 0.02) and
     examples/tp06_spiral.py (epi, diff 0.15), skip off and on (the
     examples' --skip): the S1 wave to the example's
     cut on the kernel, the cut, 40 ms of stage 2, each held against
     kernel='xla' (LR1's whole stage 1, tp06's first 40 ms, and stage 2
     from the same cut state); examples/tp06_transmural.py's 4x256 strip
     for one 800 ms beat, its first 60 ms against kernel='xla'; exact
     launches;
 48. the device time of every LR1 and tp06 entry (kernel 1 at 512x512,
     isotropic and GEOM; kernel 4 at 8x128x512), its plain version's, its
     bound (bytes and operations per form, lrtp_bytes / lrtp_flops) and its
     ptxas registers and spills (neither library may spill);
 49. kernel 3's large bodies (csrc/large_block.cu: court_block,
     court_ultra_block, lr1_block, tp06_block and their GEOM entries; one
     launch per commit) vs plain_block_step at 2048x2048 (Courtemanche
     with its chronic plane, LR1 and tp06 with skip, tp06 with its
     transmural and g_kr planes): one outer step of a 4x1 shard's
     532x2048 block (the top, an interior and the bottom shard) and of a
     2x2 shard's 1044x1044 block, and under the annulus with fibers; every
     plane and the probe at rtol 1e-3 / atol 1e-5, 0 cells not bit-equal,
     exact launches;
 50. examples/court_run.py's first model on a 4x1 mesh and
     court_ultra_run.py's run_small on a 2x2 mesh (four shards on the
     card, 512x512, the annulus, 1000 ms) under 'auto', bit-equal to the
     unsharded kernel-1 runs (the final state, "v" and "trend"; "ultra"
     within rtol 1e-5), crossing at (148, 148.0) / (119, 119.0) +- 2; the
     court run's first 50 ms against the sharded kernel='xla' run; 50 ms
     of each without geometry on the other mesh shape;
 51. examples/lr1_spiral.py and tp06_spiral.py (skip on) at 512x512 on a
     4x1 mesh: the S1 wave to the cut, the cut, 40 ms of stage 2, bit-equal
     to the unsharded kernel-1 runs; tp06 with its transmural and g_kr
     planes for 40 ms; both under the annulus with fibers on a 2x2 mesh for
     20 ms;
 52. kernel 6's large bodies (court_volume_block, court_ultra_volume_block,
     lr1_volume_block, tp06_volume_block): one group on a shard's
     30x128x512 block vs plain_volume_block_step, bit-equal on the centre;
     run_volume at 40x128x512 on four z shards (10 slices, K = 10)
     bit-equal to the unsharded kernel-4 run (court and court_ultra 100
     outer steps, LR1 and tp06 50);
 53. the device time of every kernel-3 and kernel-6 entry of the large
     bodies per launch and per outer step (CUDA events behind the spin
     kernel), its plain version's, its bound and its ptxas registers and
     spills (none may spill).

Prints the nvidia-smi line and one JSON line describing the kernels before
its last line, which is {"ok": true, "device": {...}}.  Needs a CUDA GPU and
nvcc; exits 1 without them.  Imports no JAX.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
import types
import warnings

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
# the AB2 derivative planes (mV/ms for _dV_) enter the next substep's
# potential as 0.5 dt f_prev: the atol that moves it by at most ATOL at dt
# 0.1 (tests/test_torch_br_variants.py)
DERIVATIVE_ATOL = ATOL / (0.5 * 0.1)
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
RAGGED = ((67, 131), (1031, 517), (2047, 2047), (160, 160), (9, 12))
# the volume path: the reference's own BR volume, 8x128x512 (16 MB of
# state), and the same with the rows doubled past the 32 MB cutover,
# 8x512x512 (64 MB); 1000 outer steps (500 ms) with the cross-field S2 of
# examples/scroll_wave.py at outer step 700 (350 ms) over the lower half of
# the depth.  The S1 wave is planar, so the mid-depth probe crosses where
# the 2D engine's does at W=512: (332, 166.0)
DEPTH = 8
VOL_CFG = dict(CFG, height=128, duration=500)
VOL_CFG_LARGE = dict(VOL_CFG, height=512)
VOL_STEPS, S2_STEP = 1000, 700
# the reference's whole-volume cutover (fib_tf_tpu/engine/volume.py:78): the
# tiled volume path runs under it; the port's own cutover is the card's
REFERENCE_VOLUME_MB = 32.0
# phase 8: ragged, and the shallowest depth
VOL_RAGGED = ((5, 67, 131), (3, 64, 96))
# phase 10: deeper than the substep route's cutover takes (the sharded
# volume's 32x128x512), ragged, smaller than one tile, and the shallowest
VOL_TILED_SHAPES = ((32, 128, 512), (37, 67, 131), (5, 67, 131), (4, 9, 12),
                    (3, 64, 96))
# the sharded paths: four shards, all on the one card.  2D: 2048x2048 in four
# 512-row shards (4x1) or four 1024x1024 shards (2x2), K = 5 ghost rows.
# 3D: the reference's per-shard shape of its z-sharded volume, 8x128x512
# per shard (docs/OPTIMIZATIONS.md section 14b, sizes only): 32x128x512
N_SHARDS = 4
SHARDED_DEPTH = 32
SHORT_MS = 100          # the 2x2 run
SHORT_VOL_STEPS = 100   # the sharded volume run held against kernel='xla'
# the least time of a kernel (bound_ms): the larger of its bytes over the
# H100 SXM's HBM rate and its float32 operations over its peak float32
# rate outside the tensor cores (NVIDIA's data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Fenton and Mitchell-Schaeffer (phases 18-23).  Fenton's 2D configuration
# is Table 1's fifth row (fib_tf_tpu/cli.py:682-691): 512x512, dt 0.1 ms,
# diff 1.5, cut to 400 ms (4 MB of state); 2048x2048 (64 MB) takes the
# tiled kernel past the 32 MB cutover, and four row shards of it the block
# kernel; the volume is examples/scroll_wave.py's run at --size 512 --depth
# 16: dt 0.05, diff 1.5, the S2 over z < 8 at 250 ms, 600 ms (64 MB).
SMALL_CFG = dict(width=512, height=512, dt=0.1, dt_per_plot=10, diff=1.5,
                 duration=400)
SMALL_CFG_LARGE = dict(SMALL_CFG, width=2048, height=2048)
SCROLL_CFG = dict(SMALL_CFG, dt=0.05, duration=600)
SCROLL_DEPTH, SCROLL_STEPS, SCROLL_S2 = 16, 1200, 500
# the JAX engine's first crossings, pinned on the CPU at height 32 (the S1
# wave is planar; in the volume too):
#   SimConfig(width=W, height=32, dt=DT, dt_per_plot=10, diff=1.5,
#             duration=D, kernel='xla')
#   -> Simulation(Model(cfg)).define().simulate().cycle_lengths[0]
# gives Fenton (76, 76.0) at W=512, D=400, (306, 306.0) at W=2048, D=400,
# (144, 72.0) at W=512, DT=0.05, D=600; Mitchell-Schaeffer (139, 139.0) at
# W=512, D=400 (DT 0.1 where not given)
SMALL_CROSSINGS = {"fenton": 76, "fenton_2048": 306, "fenton_scroll": 144,
                   "ms": 139}
# Mitchell-Schaeffer's runs on kernels 2-4 are cut to 100 outer steps; its
# two planes pass the 32 MB cutover at 2048x4096 (64 MB, as Fenton's
# 2048x2048), not at 2048x2048 (32 MB)
MS_SHORT_STEPS = 100
MS_LARGE_WIDTH = 4096
# the planes of a seeded small-model state, each drawn per cell in
# [0, hi): the border differs from its neighbours, so a cell body fed the
# boundary-enforced centre for its raw one fails there
SMALL_PLANES = {"fenton": dict(u=1.0, v=1.0, w=1.0, s=0.6),
                "ms": dict(u=1.0, h=1.0)}
# whole runs: 1e-3 of the models' [0, 1] range (tests/test_golden.py)
SMALL_ATOL = 1e-3
# float32 operations per cell-substep in the plane (fenton_cell.cuh,
# ms_cell.cuh, counted by hand, a tanhf as one: Fenton has two), with the
# 9-point stencil's 10; a volume adds the z term's 4.  Fenton's ab2 body
# spends 3 more on each of its four planes
SMALL_FLOPS = {"fenton": 67, "fenton_ab2": 79, "ms": 27}

# The rest of Beeler-Reuter and the ab2 bodies (phases 24-30).  Table 1 is
# `python -m fib_tf_tpu bench` (fib_tf_tpu/cli.py:665-691) at its
# defaults: 512x512, 1000 ms, 3 runs, rows BR cheby x skip (the other flags
# at their defaults: the direct rows run the shared-exponential currents)
# and Fenton at diff 1.5
TABLE1_SIZE, TABLE1_MS, TABLE1_RUNS = 512, 1000, 3
TABLE1_ROWS = (("br", dict(cheby=False, skip=False)),
               ("br", dict(cheby=False, skip=True)),
               ("br", dict(cheby=True, skip=False)),
               ("br", dict(cheby=True, skip=True)),
               ("fenton", {}))
# the JAX engine's first crossings, pinned on the CPU at height 32 (the S1
# wave is planar):
#   SimConfig(width=W, height=32, dt=DT, diff=D, duration=T, kernel='xla',
#             **flags) -> Simulation(Model(cfg)).define().simulate()
#   .cycle_lengths[0]
# gives, at W=512, T=400, DT 0.1: BR cheby=False (338, 169.0) with and
# without skip, cheby=True (332, 166.0) with and without, Fenton (76, 76.0);
# BR cheby=False at W=2048, T=700: (1354, 677.0) with and without skip; BR
# cheby + skip + ab2: (318, 159.0) at W=512, (1272, 636.0) at W=2048, T=700;
# Fenton ab2 at DT 0.025: (269, 67.25) at W=512, (1076, 269.0) at W=2048; BR
# cheby + skip + ab2 at DT 0.05, W=512: (594, 148.5) (the planar S1 wave
# of a volume crosses there too)
TABLE1_CROSSINGS = {("br", ("cheby", False), ("skip", False)): 338,
                    ("br", ("cheby", False), ("skip", True)): 338,
                    ("br", ("cheby", True), ("skip", False)): 332,
                    ("br", ("cheby", True), ("skip", True)): 332,
                    ("fenton",): 76}
DIRECT_CROSSING_2048 = 1354
AB2_CROSSINGS = {"br": 318, "br_2048": 1272, "fenton": 269,
                 "fenton_2048": 1076, "br_volume": 594}
# the ab2 runs: BR's bench configuration with ab2, and Fenton's Table 1
# row with ab2 at dt 0.025.  AB2's stability interval is (-1, 0), half of
# Euler's: Fenton's highest diffusion mode (dt * diff * 12) and its
# upstroke at u = 1, v = 1 (dt * 11.8) sum to 1.49 at dt 0.05, so an S2's
# sharp front amplifies the kernel's and the plain path's rounding (0.0038
# apart in u 50 ms after an S2 at dt 0.05, on an H100 80GB HBM3 at 700 W);
# 0.75 at dt 0.025.
# An S2 on the upper left quadrant after the first crossing, whose pacing
# refreshes the derivative planes; 2048x2048 for 700 ms (BR) or 400 ms.
# Fenton's 512x512 run against kernel='xla' goes without: its S2 at 200 ms
# breaks into reentry, and there the kernel's and the plain path's
# rounding part by 2.0e-3 in u within 200 ms (the same card)
AB2_S2_MS = {"br": (200.0, 680.0), "fenton": (None, 350.0)}
AB2_LARGE_MS = {"br": 700, "fenton": 400}
BR_AB2 = dict(CFG, ab2=True)
FENTON_AB2 = dict(SMALL_CFG, dt=0.025, ab2=True)
# the ab2 volumes: the 3D Laplacian's largest eigenvalue is 20 (dz_ratio
# 1), and AB2 needs dt * diff * 20 < 1 (BR at dt 0.1: 1.6; Fenton at dt
# 0.05: 1.5), so BR's run at dt 0.05 and Fenton's at dt 0.025
BR_AB2_VOL = dict(VOL_CFG, skip=True, ab2=True, dt=0.05)
FENTON_AB2_VOL = dict(SCROLL_CFG, ab2=True, dt=0.025)
# the BR variants held to their plain version on every kernel (phase 24):
# Table 1's direct rows, the unfolded fits with the literal currents, the
# fold with the shared-exponential currents, and ab2 with folded and with
# direct gates
VARIANT_CHECKS = {
    "direct": dict(cheby=False, skip=False),
    "direct-skip": dict(cheby=False, skip=True),
    "cheby-plain-skip": dict(cheby_fold=False, cheby_currents=False,
                             fast_currents=False, skip=True),
    "fold-fast-skip": dict(cheby_currents=False, skip=True),
    "ab2-skip": dict(skip=True, ab2=True),
    "direct-ab2": dict(cheby=False, skip=False, ab2=True),
}
# compare() lets a kernel's cell past rtol/atol pass when the kernel is no
# further than the plain path from a float64 plain run at that cell, or
# when the cell's float64 V passed within ILL_MARGIN_MV of a window where
# the body is ill-conditioned in float32 (the model's `ill_conditioned`:
# Beeler-Reuter's removable singularities and its unfolded tau_h fit,
# negative around rest); at most ARBITRATED_CAP of a plane's cells, and
# each pair's count goes into the kernels line ("arbitrated_cells")
ILL_MARGIN_MV = 0.5
ARBITRATED_CAP = 0.02
ARBITRATED = {}
# a seeded BR state holds a wavefront when some cell is above -40 mV, the
# arrival threshold of the conduction-velocity pins: the unfolded fits'
# plateau sits lower than the main path's, and 10 ms after the S1 a
# 67x131 state of theirs peaked under 0 mV on the card
WAVEFRONT_MV = -40.0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def compare(name, got, want, exact=None, windows=()):
    """Max abs error over the planes (in float64 on the device); fails
    outside rtol/atol (the AB2 derivative planes: DERIVATIVE_ATOL).  With
    `exact`, a callable that returns the plain path's run in float64 from
    the same state and that state, a cell outside rtol/atol is arbitrated:
    it passes when the kernel is no further from float64 than the float32
    plain path is at that cell, or when its float64 V passed within
    ILL_MARGIN_MV of one of `windows` (`model.ill_conditioned`); at most
    ARBITRATED_CAP
    of the plane's cells, counted in ARBITRATED under the entry's name (the
    first word of `name`)."""
    worst = 0.0
    arbiter = None
    for k in want:
        a = got[k].double()
        b = want[k].double()
        err = (a - b).abs()
        atol = DERIVATIVE_ATOL if k.startswith("_d") else ATOL
        bad = err > atol + RTOL * b.abs()
        check(bool(a.isfinite().all()), f"{name}: plane {k} not finite")
        if exact is not None and bool(bad.any()):
            if arbiter is None:
                arbiter = exact()
            ex, start = arbiter
            e = ex[k]
            ke, pe = (a - e).abs(), (b - e).abs()
            nearer = bad & (ke <= pe)
            ill = bad.new_zeros(bad.shape)
            if windows:
                v0, v1 = start["V"].double(), ex["V"]
                lo, hi = v0.minimum(v1), v0.maximum(v1)
                for w_lo, w_hi in windows:
                    ill |= ((hi >= w_lo - ILL_MARGIN_MV)
                            & (lo <= w_hi + ILL_MARGIN_MV))
            ill = bad & ill & ~nearer
            n_bad, n_near, n_ill = (int(bad.sum()), int(nearer.sum()),
                                    int(ill.sum()))
            print(f"  {name}: plane {k}: {n_bad} cells outside rtol/atol, "
                  f"by up to {float(err[bad].max()):.3g}; the kernel nearer "
                  f"float64 at {n_near} (up to {float(ke[bad].max()):.3g} "
                  f"from it, the plain path up to {float(pe[bad].max()):.3g})"
                  f", {n_ill} more within {ILL_MARGIN_MV} mV of "
                  f"{list(windows)}", flush=True)
            entry = name.split()[0].rstrip(",")
            ARBITRATED[entry] = ARBITRATED.get(entry, 0) + n_near + n_ill
            check(n_near + n_ill <= ARBITRATED_CAP * bad.numel(),
                  f"{name}: plane {k}: {n_near + n_ill} arbitrated cells, "
                  f"past {ARBITRATED_CAP:.0%} of {bad.numel()}")
            bad = bad & ~nearer & ~ill
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
    if model.cfg.ab2:
        init = model.bootstrap_ab2(init)
    base = interop.state_from_numpy(init, dev)
    for _ in range(20):
        plain_step(model, base)
    torch.cuda.synchronize()
    check(bool(base["V"].isfinite().all())
          and float(base["V"].max()) > WAVEFRONT_MV,
          f"{shape} seeded state holds no wavefront")
    return base


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA GPU")
    try:
        from fib_tf_tpu_torch import SimConfig, interop
        from fib_tf_tpu_torch.engine import (CycleLengthDetector,
                                             Simulation, VolumeEvent,
                                             run_volume, volume)
        from fib_tf_tpu_torch.models import (BeelerReuter, Courtemanche,
                                             CourtemancheUltra, Fenton4v,
                                             LuoRudy91, MitchellSchaeffer,
                                             TenTusscher06)
        from fib_tf_tpu_torch.models.tp06 import transmural_volume_state
        from fib_tf_tpu_torch.ops import (bodies, cuda_block, cuda_step,
                                          cuda_tiled, cuda_volume,
                                          cuda_volume_block,
                                          cuda_volume_tiled, stencil)
        from fib_tf_tpu_torch.ops.stencil3d import enforce_boundary3d
        from fib_tf_tpu_torch.parallel import make_mesh
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
    modules = (cuda_step, cuda_tiled, cuda_volume, cuda_volume_tiled,
               cuda_block, cuda_volume_block)
    # one library per source and cell-body library (`library_name`), and
    # for kernels 2 and 3 a second one of the same source with their GEOM
    # entries; one binding per entry point (a cell body's: br_substep,
    # fenton_substep, br_tiled_geom, ...; the tiled volume kernel's one
    # entry is named after its library)
    libraries, bindings = {}, {}
    for mod in modules:
        for kernel in (*getattr(mod, "KERNELS", {"br": mod.KERNEL}).values(),
                       *getattr(mod, "GEOM_KERNELS", {}).values()):
            libraries.setdefault(kernel.library_name, kernel)
            bindings[kernel.entry] = kernel
    t0 = time.perf_counter()
    # one nvcc per library, all started together
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        futures = {name: pool.submit(kernel.build)
                   for name, kernel in libraries.items()}
        lib_paths = {name: f.result() for name, f in futures.items()}
    for kernel in bindings.values():
        kernel.library()
    build_s = time.perf_counter() - t0
    for name, kernel in libraries.items():
        path = lib_paths[name]
        print(f"phase 1: built {path.name} from {kernel.source.name} "
              f"({build_s:.2f} s for all {len(libraries)}; entries "
              f"{[e for e, k in bindings.items() if k.library_name == name]})",
              flush=True)
        for line in path.with_name(path.name + ".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    for name in ("br_tiled", "br_block", "br_volume_tiled", "br_tiled_geom",
                 "br_block_geom", "court_substep", "court_volume",
                 "lrtp_substep", "lrtp_volume", "court_block", "lrtp_block",
                 "court_volume_block", "lrtp_volume_block"):
        log = lib_paths[name].with_name(lib_paths[name].name + ".log")
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", log.read_text())
        check(bool(spills) and all(a == b == "0" for a, b in spills),
              f"{name}: the kernel spills ({spills})")

    def reset_counts():
        for kernel in bindings.values():
            kernel.reset_launches()

    def read_counts():
        """Launches of every kernel since reset_counts(), by library."""
        return {name: (dict(kernel.launches)
                       if isinstance(kernel.launches, dict)
                       else kernel.launches)
                for name, kernel in bindings.items()}

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
    counts = read_counts()
    launches = counts["br_substep"]
    print(f"  route {sim.route}, steps {res.steps}, launches {counts}, "
          f"cycle_lengths {res.cycle_lengths}", flush=True)
    check(res.steps == cfg.samples(model.dt_per_step),
          f"ran {res.steps} outer steps")
    check(launches["slow"] + launches["frozen"] == 5 * res.steps,
          f"launches {launches} != 5 x {res.steps} outer steps")
    check(launches["slow"] == res.steps and launches["frozen"] == 4 * res.steps,
          f"launch split {launches} is not 1 slow + 4 frozen per step")
    check_only(counts, "br_substep", "the 512x512 run")
    check_run(res, shape, CROSSING_STEP)

    before = read_counts()
    ref = Simulation(BeelerReuter(cfg.replace(kernel="xla")),
                     device="cuda").define().simulate()
    check(read_counts() == before, "the kernel='xla' run launched a kernel")
    check_against_plain_run(res, ref)

    # -- phase 4 ----------------------------------------------------------------
    print(f"phase 4: timings on {card}", flush=True)
    timing = time_kernels(torch, model, base, cuda_step, bodies)
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
    counts = read_counts()
    tiled_launches = counts["br_tiled"]
    print(f"  route {sim.route}, steps {res_large.steps}, launches "
          f"{counts}, cycle_lengths {res_large.cycle_lengths}", flush=True)
    check(res_large.steps == cfg_large.samples(large.dt_per_step),
          f"ran {res_large.steps} outer steps")
    check(tiled_launches == res_large.steps,
          f"{tiled_launches} tiled launches for {res_large.steps} outer steps")
    check_only(counts, "br_tiled", "the 2048x2048 run")
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
              f"substep route (5 launches) {t['substep_us']:.2f}, ratio "
              f"{t['tiled_us'] / t['substep_us']:.4f}, plain "
              f"{t['plain_us']:.1f} (device) [{card}]", flush=True)
    tiled_split = split_tiled(torch, bodies, cuda_tiled, large,
                              base_large)
    print_split("br_tiled at 2048x2048", tiled_split, card)
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

    # -- phase 8 ----------------------------------------------------------------
    vcfg = SimConfig(**VOL_CFG)
    vmodel = BeelerReuter(vcfg)
    vshape = cuda_volume.volume_shape(vmodel, DEPTH)
    vname = "x".join(map(str, vshape))
    print(f"phase 8: volume substep kernel vs plain PyTorch at {vname}",
          flush=True)
    vbase = seeded_volume(torch, interop, volume, cuda_volume, vmodel, DEPTH,
                          dev, rng)
    verrs = {}
    for body, slow in (("slow", True), ("frozen", False)):
        pk = torch.zeros(1, device=dev)
        pp = torch.zeros(1, device=dev)
        got = cuda_volume.volume_substep(vmodel, clone(vbase), slow, pk, 0)
        want = cuda_volume.plain_volume_substep(vmodel, clone(vbase), slow,
                                                pp, 0)
        torch.cuda.synchronize()
        verrs[body] = compare(f"one {body} launch", got, want)
        compare_probes(f"{body} launch", pk, pp)
    for dz in (1.0, 0.5):
        step_err = check_outer_steps(
            torch, cuda_volume.make_volume_step(vmodel, DEPTH, dz),
            plain_volume(cuda_volume, vmodel, dz), vbase, 2,
            f"{vname} dz_ratio={dz}")
        for body in verrs:
            verrs[body] = max(verrs[body], step_err)
    for d, h, w in VOL_RAGGED:
        for skip in (True, False):
            m = BeelerReuter(vcfg.replace(height=h, width=w, skip=skip))
            st = seeded_volume(torch, interop, volume, cuda_volume, m, d,
                               dev, rng)
            check_outer_steps(torch, cuda_volume.make_volume_step(m, d),
                              plain_volume(cuda_volume, m), st, 2,
                              f"{d}x{h}x{w} skip={skip}")

    # -- phase 9 ----------------------------------------------------------------
    events = [VolumeEvent(step=S2_STEP, loc="luq", z1=DEPTH // 2)]
    print(f"phase 9: the volume path, run_volume(...) at {vname}, "
          f"{VOL_STEPS} outer steps, S2 at step {S2_STEP} over z < "
          f"{DEPTH // 2}", flush=True)
    route = volume.volume_route(vmodel, DEPTH, "cuda", "auto")
    check(route == "substep", f"{vname} routes {route!r}")
    # warm-up: the timed runs start with the kernel loaded
    run_volume(vmodel, DEPTH, 2, device="cuda")
    reset_counts()
    vrun = run_volume_timed(run_volume, vmodel, DEPTH, events)
    counts = read_counts()
    vlaunches = counts["br_volume"]
    print(f"  route {route}, launches {counts}", flush=True)
    check(vlaunches == {"slow": VOL_STEPS, "frozen": 4 * VOL_STEPS},
          f"launches {vlaunches} are not 1 slow + 4 frozen per outer step")
    check_only(counts, "br_volume", f"the {vname} run")
    vcross = check_volume_run(CycleLengthDetector, vmodel, vrun, vshape)
    before = read_counts()
    vref = run_volume_timed(run_volume, vmodel, DEPTH, events, kernel="xla")
    check(read_counts() == before, "the kernel='xla' run launched a kernel")
    check_against_plain_volume(CycleLengthDetector, vmodel, vrun, vref,
                               vcross)

    # -- phase 10 ---------------------------------------------------------------
    vcfg_large = SimConfig(**VOL_CFG_LARGE)
    vlarge = BeelerReuter(vcfg_large)
    vshape_large = cuda_volume.volume_shape(vlarge, DEPTH)
    vname_large = "x".join(map(str, vshape_large))
    print("phase 10: tiled volume kernel vs plain PyTorch", flush=True)
    vbase_large = seeded_volume(torch, interop, volume, cuda_volume, vlarge,
                                DEPTH, dev, rng)
    vt_err = 0.0
    for skip in (True, False):
        m = BeelerReuter(vcfg_large.replace(skip=skip))
        for n in (1, 2):
            vt_err = max(vt_err, check_outer_steps(
                torch, cuda_volume_tiled.make_tiled_volume_step(m, DEPTH),
                plain_volume(cuda_volume, m), vbase_large, n,
                f"{vname_large} skip={skip}"))
    sbase = None
    for d, h, w in VOL_TILED_SHAPES:
        for skip in (True, False):
            m = BeelerReuter(vcfg.replace(height=h, width=w, skip=skip))
            st = (seeded_volume(torch, interop, volume, cuda_volume, m, d,
                                dev, rng) if min(h, w) > 20
                  else interop.state_from_numpy(
                      volume.volume_state(m, d), dev))
            if (d, h, w) == (SHARDED_DEPTH, vcfg.height, vcfg.width) and skip:
                sbase = st   # phases 12 and 14 time and cut it
            plan = cuda_volume_tiled.tile_plan(d, h, w, m.dt_per_step)
            vt_err = max(vt_err, check_outer_steps(
                torch, cuda_volume_tiled.make_tiled_volume_step(m, d),
                plain_volume(cuda_volume, m), st, 2,
                f"{d}x{h}x{w} skip={skip} ({len(plan.tiles)} tiles)"))
    for skip in (True, False):
        m = BeelerReuter(vcfg.replace(skip=skip))
        tiled = run_outer_steps(
            torch, cuda_volume_tiled.make_tiled_volume_step(m, DEPTH),
            vbase, 2)
        substep = run_outer_steps(
            torch, cuda_volume.make_volume_step(m, DEPTH), vbase, 2)
        diff = compare(
            f"{vname} skip={skip}, 2 outer steps vs volume substep kernel",
            tiled, substep)
        vt_err = max(vt_err, diff)
        same = all(torch.equal(tiled[k], substep[k]) for k in substep)
        print(f"  {vname} skip={skip}: tiled volume kernel vs the substep "
              f"route, max |diff| {diff:.3g} over the 8 planes, "
              f"bit-equal: {same}", flush=True)

    # -- phase 11 ---------------------------------------------------------------
    print(f"phase 11: the tiled volume path, run_volume(...) at "
          f"{vname_large} with the reference's {REFERENCE_VOLUME_MB} MB "
          f"cutover, {VOL_STEPS} outer steps, and the same run on the "
          f"card's cutover", flush=True)
    card_route = volume.volume_route(vlarge, DEPTH, "cuda", "auto")
    check(card_route == "substep",
          f"{vname_large} routes {card_route!r} on the card's cutover")
    with reference_cutover(volume):
        route = volume.volume_route(vlarge, DEPTH, "cuda", "auto")
        check(route == "tiled", f"{vname_large} routes {route!r}")
        reset_counts()
        vrun_large = run_volume_timed(run_volume, vlarge, DEPTH, events)
        counts = read_counts()
    vt_launches = counts["br_volume_tiled"]
    print(f"  route {route}, launches {counts}", flush=True)
    check(vt_launches == VOL_STEPS,
          f"{vt_launches} tiled volume launches for {VOL_STEPS} outer steps")
    check_only(counts, "br_volume_tiled", f"the {vname_large} run")
    vcross_large = check_volume_run(CycleLengthDetector, vlarge, vrun_large,
                                    vshape_large)
    before = read_counts()
    vref_large = run_volume_timed(run_volume, vlarge, DEPTH, events,
                                  kernel="xla")
    check(read_counts() == before, "the kernel='xla' run launched a kernel")
    check_against_plain_volume(CycleLengthDetector, vlarge, vrun_large,
                               vref_large, vcross_large)
    reset_counts()
    vsub_large = run_volume_timed(run_volume, vlarge, DEPTH, events)
    counts = read_counts()
    print(f"  the card's route {card_route}, launches {counts}", flush=True)
    check(counts["br_volume"] == {"slow": VOL_STEPS,
                                  "frozen": 4 * VOL_STEPS},
          f"launches {counts['br_volume']} are not 1 slow + 4 frozen per "
          f"outer step")
    check_only(counts, "br_volume", f"the {vname_large} run on the card's "
               f"cutover")
    check_against_plain_volume(
        CycleLengthDetector, vlarge, vsub_large, vref_large,
        check_volume_run(CycleLengthDetector, vlarge, vsub_large,
                         vshape_large))

    # -- phase 12 ---------------------------------------------------------------
    print(f"phase 12: volume timings on {card}", flush=True)
    sname = f"{SHARDED_DEPTH}x{vcfg.height}x{vcfg.width}"
    vtiming = time_volume(torch, bodies, cuda_volume, cuda_volume_tiled,
                          ((vname, vmodel, vbase),
                           (vname_large, vlarge, vbase_large),
                           (sname, vmodel, sbase)))
    for size, t in vtiming.items():
        cells = int(np.prod(t["shape"]))
        tb_ms, tb_by = outer_step_bound(
            cells, vmodel.launch_schedule, volume=True)
        print(f"  {size}: volume substep kernel SLOW {t['slow_us']:.3f} / "
              f"frozen {t['frozen_us']:.3f} us/launch, plain "
              f"{t['plain_slow_us']:.1f} / {t['plain_frozen_us']:.1f} "
              f"us/substep; per outer step: substep route (5 launches) "
              f"{t['substep_us']:.2f}, tiled volume kernel "
              f"{t['tiled_us']:.2f} (bound {tb_ms * 1e3:.3f}, {tb_by}), "
              f"ratio tiled / substep route "
              f"{t['tiled_us'] / t['substep_us']:.4f}, plain "
              f"{t['plain_us']:.1f} us (device) [{card}]", flush=True)
    sim_s = VOL_STEPS * vmodel.dt_per_step * vcfg.dt / 1000.0
    for size, run, ref_run, rt in ((vname, vrun, vref, "substep"),
                                   (vname_large, vrun_large, vref_large,
                                    "tiled"),
                                   (vname_large, vsub_large, vref_large,
                                    "substep")):
        print(f"  run_volume at {size}, {VOL_STEPS} outer steps, route {rt}: "
              f"{run['wall_s'] / sim_s:.6f} wall-s/sim-s; kernel='xla': "
              f"{ref_run['wall_s'] / sim_s:.6f} [{card}]", flush=True)


    # -- phase 13 ---------------------------------------------------------------
    print("phase 13: block kernel vs plain PyTorch (one shard's extended "
          "block)", flush=True)
    k_halo = large.dt_per_step
    block_err = 0.0
    # (own rows, own columns or None on a 1D mesh, origin of the shard)
    shards_2d = [("4x1 top", 512, None, (0, 0)),
                 ("4x1 interior", 512, None, (512, 0)),
                 ("4x1 bottom", 512, None, (1536, 0)),
                 ("2x2 corner", 1024, 1024, (1024, 1024))]
    for skip in (True, False):
        m = BeelerReuter(cfg_large.replace(skip=skip))
        for name, h_own, w_own, origin in shards_2d:
            for n in (1, 2):
                block_err = max(block_err, check_block(
                    torch, cuda_block, cuda_tiled, m, base_large, h_own,
                    w_own, origin, n, f"2048x2048 {name} skip={skip}"))
        block_err = max(block_err, check_block(
            torch, cuda_block, cuda_tiled, m, base_large, 67, 131,
            (700, 900), 2, f"2048x2048 67x131 block skip={skip}"))
        m = BeelerReuter(cfg.replace(height=67, width=131, skip=skip))
        st = seeded_state(torch, interop, m, dev, cuda_step.plain_step, rng)
        for w_own, origin in ((None, (44, 0)), (41, (13, 90))):
            block_err = max(block_err, check_block(
                torch, cuda_block, cuda_tiled, m, st, 23, w_own, origin, 2,
                f"67x131 ragged at {origin} skip={skip}"))

    # -- phase 14 ---------------------------------------------------------------
    d_own = SHARDED_DEPTH // N_SHARDS
    print(f"phase 14: volume block kernel vs plain PyTorch (one shard's "
          f"{d_own + 2 * k_halo}x{vcfg.height}x{vcfg.width} block of "
          f"{SHARDED_DEPTH}x{vcfg.height}x{vcfg.width}, phase 10's seeded "
          f"volume)", flush=True)
    vblock_errs = {"slow": 0.0, "frozen": 0.0}
    for name, z0 in (("top", 0), ("interior", d_own),
                     ("bottom", SHARDED_DEPTH - d_own)):
        for dz in (1.0, 0.5):
            for n in (1, 2):
                err = check_volume_block(
                    torch, cuda_volume, cuda_volume_block, vmodel, sbase,
                    d_own, z0, n, dz, None, f"{name} shard dz_ratio={dz}")
                vblock_errs = {b: max(e, err)
                               for b, e in vblock_errs.items()}
        noskip = BeelerReuter(vcfg.replace(skip=False))
        vblock_errs["slow"] = max(vblock_errs["slow"], check_volume_block(
            torch, cuda_volume, cuda_volume_block, noskip, sbase, d_own, z0,
            2, 1.0, 1, f"{name} shard skip=False substeps=1"))

    # -- phase 15 ---------------------------------------------------------------
    print(f"phase 15: the sharded 2D main path, Simulation(mesh=4 shards on "
          f"cuda:0, wide_halo=True) at {cfg_large.width}x{cfg_large.height}, "
          f"{cfg_large.duration} ms", flush=True)
    mesh_rows = make_mesh(devices=["cuda:0"] * N_SHARDS)
    sim = Simulation(BeelerReuter(cfg_large), mesh=mesh_rows,
                     wide_halo=True).define()
    check(sim.route == "block", f"the sharded run routes {sim.route!r}")
    reset_counts()
    res_rows = sim.simulate()
    counts = read_counts()
    block_launches = counts["br_block"]
    print(f"  mesh 4x1, route {sim.route}, steps {res_rows.steps}, launches "
          f"{counts}, cycle_lengths {res_rows.cycle_lengths}", flush=True)
    check(block_launches == N_SHARDS * res_rows.steps
          and res_rows.steps == res_large.steps,
          f"{block_launches} block launches for {res_rows.steps} outer steps "
          f"on {N_SHARDS} shards")
    check_only(counts, "br_block", "the sharded 2048x2048 run")
    check_run(res_rows, large.state_shape(), CROSSING_STEP_LARGE)
    check_against_plain_run(res_rows, ref_large)
    check_sharded_against_unsharded(res_rows, res_large, "4x1")
    cfg_short = cfg_large.replace(duration=SHORT_MS)
    short = Simulation(BeelerReuter(cfg_short), device="cuda").define()
    check(short.route == "tiled", f"the short run routes {short.route!r}")
    res_short = short.simulate()
    sim = Simulation(BeelerReuter(cfg_short),
                     mesh=make_mesh(shape=(2, 2),
                                    devices=["cuda:0"] * N_SHARDS),
                     wide_halo=True).define()
    reset_counts()
    res_grid = sim.simulate()
    counts = read_counts()
    print(f"  mesh 2x2, {SHORT_MS} ms, steps {res_grid.steps}, launches "
          f"{counts}", flush=True)
    check(counts["br_block"] == N_SHARDS * res_grid.steps,
          f"{counts['br_block']} block launches for {res_grid.steps} steps")
    check_only(counts, "br_block", "the sharded 2x2 run")
    check_sharded_against_unsharded(res_grid, res_short, "2x2")

    # -- phase 16 ---------------------------------------------------------------
    sshape = cuda_volume.volume_shape(vmodel, SHARDED_DEPTH)
    sevents = [VolumeEvent(step=S2_STEP, loc="luq", z1=SHARDED_DEPTH // 2)]
    print(f"phase 16: the sharded volume path, run_volume(mesh=4 z shards on "
          f"cuda:0, wide_halo=True) at {sname}, {VOL_STEPS} outer steps, S2 "
          f"at step {S2_STEP} over z < {SHARDED_DEPTH // 2}", flush=True)
    vmesh = make_mesh(devices=["cuda:0"] * N_SHARDS)
    run_volume(vmodel, SHARDED_DEPTH, 2, mesh=vmesh, wide_halo=True)
    reset_counts()
    srun = run_volume_timed(run_volume, vmodel, SHARDED_DEPTH, sevents,
                            mesh=vmesh, wide_halo=True)
    counts = read_counts()
    vblock_launches = counts["br_volume_block"]
    print(f"  launches {counts}", flush=True)
    check(vblock_launches == {"slow": N_SHARDS * VOL_STEPS,
                              "frozen": N_SHARDS * 4 * VOL_STEPS},
          f"launches {vblock_launches} are not {N_SHARDS} x (1 slow + 4 "
          f"frozen) per outer step")
    check_only(counts, "br_volume_block", f"the sharded {sname} run")
    scross = check_volume_run(CycleLengthDetector, vmodel, srun, sshape)
    # the unsharded run of the same volume on the kernels, on the card's
    # cutover: the volume substep kernel, with no warning (phase 10 holds
    # the tiled volume kernel at this depth)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sroute = volume.volume_route(vmodel, SHARDED_DEPTH, "cuda", "auto")
        reset_counts()
        uns = run_volume_timed(run_volume, vmodel, SHARDED_DEPTH, sevents)
        counts = read_counts()
    print(f"  unsharded run: route {sroute}, launches {counts}, wall "
          f"{uns['wall_s']:.3f} s", flush=True)
    check(sroute == "substep",
          f"the unsharded {sname} run routes {sroute!r}")
    check(not caught, f"the unsharded {sname} run warned: "
          f"{[str(w.message) for w in caught]}")
    check(counts["br_volume"] == {"slow": VOL_STEPS,
                                  "frozen": 4 * VOL_STEPS},
          f"{counts['br_volume']} volume substep launches for {VOL_STEPS} "
          f"outer steps")
    check_only(counts, "br_volume", f"the unsharded {sname} run")
    check_sharded_volume(CycleLengthDetector, vmodel, srun, uns, scross,
                         "the unsharded kernel run")
    # and the unsharded run on the tiled volume kernel, at the reference's
    # cutover: 32 slices deep, with no warning
    with reference_cutover(volume), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        troute = volume.volume_route(vmodel, SHARDED_DEPTH, "cuda", "auto")
        reset_counts()
        uns_tiled = run_volume_timed(run_volume, vmodel, SHARDED_DEPTH,
                                     sevents)
        counts = read_counts()
    print(f"  unsharded run at the reference's cutover: route {troute}, "
          f"launches {counts}, wall {uns_tiled['wall_s']:.3f} s", flush=True)
    check(troute == "tiled", f"the unsharded {sname} run routes {troute!r} "
          f"at the reference's cutover")
    check(not caught, f"the unsharded tiled {sname} run warned: "
          f"{[str(w.message) for w in caught]}")
    check(counts["br_volume_tiled"] == VOL_STEPS,
          f"{counts['br_volume_tiled']} tiled volume launches for "
          f"{VOL_STEPS} outer steps")
    check_only(counts, "br_volume_tiled", f"the unsharded tiled {sname} run")
    check_sharded_volume(CycleLengthDetector, vmodel, srun, uns_tiled,
                         scross, "the unsharded tiled volume kernel run")
    before = read_counts()
    short_kw = dict(n_outer=SHORT_VOL_STEPS)
    sref = run_volume_timed(run_volume, vmodel, SHARDED_DEPTH, [],
                            kernel="xla", **short_kw)
    check(read_counts() == before, "the kernel='xla' run launched a kernel")
    sshort = run_volume_timed(run_volume, vmodel, SHARDED_DEPTH, [],
                              mesh=vmesh, wide_halo=True, **short_kw)
    check_sharded_volume(CycleLengthDetector, vmodel, sshort, sref, None,
                         f"the unsharded kernel='xla' run over "
                         f"{SHORT_VOL_STEPS} steps")

    # -- phase 17 ---------------------------------------------------------------
    print(f"phase 17: timings of the sharded paths on {card}", flush=True)
    bt = time_block(torch, bodies, cuda_block, cuda_tiled, large,
                    base_large, 512, (512, 0))
    print(f"  br_block, 522x2048 block (interior shard of 4x1): kernel "
          f"{bt['kernel_us']:.2f} us/outer step, plain {bt['plain_us']:.1f}; "
          f"one shard's halo copies (2 x 8 planes x 5x2048) "
          f"{bt['copies_us']:.2f} us (device) [{card}]", flush=True)
    print_split("br_block on the 522x2048 block", bt["split"], card)
    t2k = tiled_timing["2048x2048"]
    print(f"  beside it, phase 7's br_tiled at 2048x2048: "
          f"{t2k['tiled_us']:.2f} us against the substep route's "
          f"{t2k['substep_us']:.2f} us, ratio "
          f"{t2k['tiled_us'] / t2k['substep_us']:.4f} [{card}]", flush=True)
    vbt = time_volume_block(torch, bodies, cuda_volume_block, vmodel,
                            sbase, d_own, d_own)
    print(f"  br_volume_block, 18x128x512 block (interior shard): group of "
          f"5 launches {vbt['group_us']:.2f} us/outer step; SLOW launch "
          f"({vbt['slow_slices']} slices) {vbt['slow_us']:.3f} us, frozen "
          f"launches (mean of {vbt['frozen_slices']} slices) "
          f"{vbt['frozen_us']:.3f} us; plain SLOW / frozen substep on the "
          f"block {vbt['plain_slow_us']:.1f} / {vbt['plain_frozen_us']:.1f} "
          f"us; one shard's halo copies (2 x 8 planes x 5x128x512) "
          f"{vbt['copies_us']:.2f} us (device) [{card}]", flush=True)
    for name, run, uns_run in (("4x1, 700 ms", res_rows, res_large),
                               (f"2x2, {SHORT_MS} ms", res_grid, res_short)):
        print(f"  sharded simulate() at 2048x2048, mesh {name}: "
              f"{1.0 / run.sim_seconds_per_wall_second:.6f} wall-s/sim-s, "
              f"host-paced {run.elapsed / run.steps * 1e6:.2f} us/outer "
              f"step; unsharded tiled route "
              f"{1.0 / uns_run.sim_seconds_per_wall_second:.6f} wall-s/sim-s, "
              f"{uns_run.elapsed / uns_run.steps * 1e6:.2f} us/outer step "
              f"[{card}]", flush=True)
    print(f"  sharded run_volume at {sname}, {VOL_STEPS} outer steps: "
          f"{srun['wall_s'] / sim_s:.6f} wall-s/sim-s, host-paced "
          f"{srun['wall_s'] / VOL_STEPS * 1e6:.2f} us/outer step; unsharded "
          f"(route {sroute}) {uns['wall_s'] / sim_s:.6f} wall-s/sim-s, "
          f"{uns['wall_s'] / VOL_STEPS * 1e6:.2f} us/outer step; unsharded "
          f"on the tiled volume kernel {uns_tiled['wall_s'] / sim_s:.6f} "
          f"wall-s/sim-s [{card}]", flush=True)

    small_entries = small_model_phases(torch, types.SimpleNamespace(
        bodies=bodies,
        SimConfig=SimConfig, interop=interop, Simulation=Simulation,
        VolumeEvent=VolumeEvent, run_volume=run_volume, volume=volume,
        CycleLengthDetector=CycleLengthDetector, Fenton4v=Fenton4v,
        MitchellSchaeffer=MitchellSchaeffer, cuda_step=cuda_step,
        cuda_tiled=cuda_tiled, cuda_block=cuda_block,
        cuda_volume=cuda_volume, make_mesh=make_mesh,
        reset_counts=reset_counts, read_counts=read_counts), card, rng)
    variant_entries = variant_phases(torch, types.SimpleNamespace(
        bodies=bodies,
        SimConfig=SimConfig, interop=interop, Simulation=Simulation,
        VolumeEvent=VolumeEvent, run_volume=run_volume, volume=volume,
        CycleLengthDetector=CycleLengthDetector, BeelerReuter=BeelerReuter,
        Fenton4v=Fenton4v, MitchellSchaeffer=MitchellSchaeffer,
        cuda_step=cuda_step, cuda_tiled=cuda_tiled, cuda_block=cuda_block,
        cuda_volume=cuda_volume, cuda_volume_block=cuda_volume_block,
        enforce_boundary3d=enforce_boundary3d, make_mesh=make_mesh,
        reset_counts=reset_counts, read_counts=read_counts), card, rng)
    geometry_entries = geometry_phases(torch, types.SimpleNamespace(
        bodies=bodies,
        SimConfig=SimConfig, interop=interop, Simulation=Simulation,
        BeelerReuter=BeelerReuter, Fenton4v=Fenton4v,
        MitchellSchaeffer=MitchellSchaeffer, cuda_step=cuda_step,
        cuda_tiled=cuda_tiled, cuda_block=cuda_block, stencil=stencil,
        make_mesh=make_mesh, reset_counts=reset_counts,
        read_counts=read_counts), card, rng)
    court_entries = court_phases(torch, types.SimpleNamespace(
        bodies=bodies,
        SimConfig=SimConfig, interop=interop, Simulation=Simulation,
        run_volume=run_volume, volume=volume, Courtemanche=Courtemanche,
        CourtemancheUltra=CourtemancheUltra, cuda_step=cuda_step,
        cuda_volume=cuda_volume, stencil=stencil,
        reset_counts=reset_counts, read_counts=read_counts), card, rng)
    lrtp_entries = lrtp_phases(torch, types.SimpleNamespace(
        bodies=bodies,
        SimConfig=SimConfig, interop=interop, Simulation=Simulation,
        run_volume=run_volume, volume=volume, LuoRudy91=LuoRudy91,
        TenTusscher06=TenTusscher06,
        transmural_volume_state=transmural_volume_state,
        cuda_step=cuda_step, cuda_volume=cuda_volume, stencil=stencil,
        reset_counts=reset_counts, read_counts=read_counts), card, rng,
        lib_paths)
    large_entries = large_phases(torch, types.SimpleNamespace(
        bodies=bodies,
        SimConfig=SimConfig, interop=interop, Simulation=Simulation,
        run_volume=run_volume, Courtemanche=Courtemanche,
        CourtemancheUltra=CourtemancheUltra, LuoRudy91=LuoRudy91,
        TenTusscher06=TenTusscher06, cuda_step=cuda_step,
        cuda_block=cuda_block, cuda_volume_block=cuda_volume_block,
        stencil=stencil, make_mesh=make_mesh, reset_counts=reset_counts,
        read_counts=read_counts), card, rng, lib_paths)

    cells = int(np.prod(shape))
    cells_large = int(np.prod(large.state_shape()))
    vcells = int(np.prod(vshape))
    vcells_large = int(np.prod(vshape_large))
    kernels = []
    for body, slow in (("slow", True), ("frozen", False)):
        kernels.append(kernel_entry(
            f"br_substep<SLOW={str(slow).lower()}>",
            "fib_tf_tpu_torch/csrc/br_substep.cu",
            "fib_tf_tpu/ops/pallas_step.py:205", launches[body], errs[body],
            timing[body]["kernel_us"], timing[body]["plain_us"],
            launch_bound(cells, slow, volume=False)))
    big = tiled_timing["2048x2048"]
    kernels.append(kernel_entry(
        "br_tiled", "fib_tf_tpu_torch/csrc/br_tiled.cu",
        "fib_tf_tpu/ops/pallas_tiled.py:342", tiled_launches, tiled_err,
        big["tiled_us"], big["plain_us"],
        outer_step_bound(cells_large, large.launch_schedule,
                         volume=False)))
    vt = vtiming[vname]
    for body, slow in (("slow", True), ("frozen", False)):
        kernels.append(kernel_entry(
            f"br_volume<SLOW={str(slow).lower()}>",
            "fib_tf_tpu_torch/csrc/br_volume.cu",
            "fib_tf_tpu/ops/pallas_volume.py:499", vlaunches[body],
            verrs[body], vt[f"{body}_us"], vt[f"plain_{body}_us"],
            launch_bound(vcells, slow, volume=True)))
    vtl = vtiming[vname_large]
    kernels.append(kernel_entry(
        "br_volume_tiled", "fib_tf_tpu_torch/csrc/br_volume_tiled.cu",
        "fib_tf_tpu/ops/pallas_volume.py:659", vt_launches, vt_err,
        vtl["tiled_us"], vtl["plain_us"],
        outer_step_bound(vcells_large, vlarge.launch_schedule,
                         volume=True)))
    kernels.append(kernel_entry(
        "br_block", "fib_tf_tpu_torch/csrc/br_block.cu",
        "fib_tf_tpu/ops/pallas_tiled.py:202", block_launches, block_err,
        bt["kernel_us"], bt["plain_us"],
        block_bound(bt["ext_cells"], bt["own_cells"],
                    large.launch_schedule)))
    for body, slow in (("slow", True), ("frozen", False)):
        kernels.append(kernel_entry(
            f"br_volume_block<SLOW={str(slow).lower()}>",
            "fib_tf_tpu_torch/csrc/br_volume_block.cu",
            "fib_tf_tpu/ops/pallas_volume.py:397", vblock_launches[body],
            vblock_errs[body], vbt[f"{body}_us"], vbt[f"plain_{body}_us"],
            launch_bound(int(vbt[f"{body}_slices"] * vcfg.height
                             * vcfg.width), slow, volume=True)))
    kernels.extend(small_entries)
    kernels.extend(variant_entries)
    kernels.extend(geometry_entries)
    kernels.extend(court_entries)
    kernels.extend(lrtp_entries)
    kernels.extend(large_entries)
    for k in kernels:
        print(f"  {k['name']}: {k['ms'] * 1e3:.3f} us against a bound of "
              f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}) [{card}]",
              flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


@contextlib.contextmanager
def reference_cutover(volume):
    """run_volume routes as the reference does, at its 32 MB volume
    cutover: past it, the tiled volume kernel."""
    saved = volume.VOLUME_KERNEL_STATE_MB_MAX
    volume.VOLUME_KERNEL_STATE_MB_MAX = REFERENCE_VOLUME_MB
    try:
        yield
    finally:
        volume.VOLUME_KERNEL_STATE_MB_MAX = saved


def total_launches(count) -> int:
    return sum(count.values()) if isinstance(count, dict) else count


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


def check_against_plain_run(res, ref, key="V", atol=WHOLE_RUN_ATOL_MV,
                            exact=None):
    """A kernel run ends within `atol` (1e-3 of the model's range) of the
    kernel='xla' run in the potential `key`, and crosses at the same
    step.  With `exact`, a callable that returns the same run's final `key`
    on the plain path in float64, a run past `atol` is arbitrated: it
    passes when the kernel run ends no further from float64 (max abs)
    than the float32 plain run does."""
    dv = np.abs(res.state[key] - ref.state[key])
    print(f"  final {key} vs kernel='xla' run: max abs {dv.max():.4g} "
          f"(bound {atol}); crossings {ref.cycle_lengths}; probe max abs "
          f"{np.abs(res.probes['v'] - ref.probes['v']).max():.3g}",
          flush=True)
    if float(dv.max()) > atol and exact is not None:
        ex = exact()
        ke = float(np.abs(res.state[key] - ex).max())
        pe = float(np.abs(ref.state[key] - ex).max())
        print(f"  arbitrated by the float64 plain run: the kernel run ends "
              f"{ke:.4g} from it, the float32 plain run {pe:.4g}", flush=True)
        check(ke <= pe, f"final {key}: the kernel run ends {ke} from the "
                        f"float64 run, the float32 plain run {pe}")
    else:
        check(float(dv.max()) <= atol,
              f"final {key} differs from the kernel-free run by {dv.max()}")
    check(ref.cycle_lengths[:1] == res.cycle_lengths[:1],
          "kernel and kernel-free runs cross at different steps")


def check_tiled(torch, cuda_tiled, model, base, n_steps, reference, name,
                against="plain"):
    """`n_steps` outer steps of the tiled kernel vs the outer step
    `reference(state, probe, i)` from `base`: all planes and the probe
    (where the grid holds the probe pixel).  Returns the max abs error."""
    return check_outer_steps(
        torch, cuda_tiled.make_tiled_cuda_step(model), reference, base,
        n_steps, name, against,
        has_probe=model.probe_pixel[0] < model.state_shape()[0])


def run_outer_steps(torch, step, base, n_steps):
    """A copy of `base` after `n_steps` outer steps `step(state)`."""
    state = clone(base)
    for _ in range(n_steps):
        state = step(state)
    torch.cuda.synchronize()
    return state


def check_outer_steps(torch, step, reference, base, n_steps, name,
                      against="plain", has_probe=True, windows=None):
    """`n_steps` outer steps `step(state, probe, i)` vs `reference(state,
    probe, i)` from `base`: all planes and, with `has_probe`, the probe;
    with `windows` (`model.ill_conditioned`), cells past rtol/atol are
    arbitrated by
    `reference` run in float64 (compare).  Returns the max abs error over
    the planes."""
    dev = next(iter(base.values())).device
    pk = torch.zeros(n_steps, device=dev) if has_probe else None
    pp = torch.zeros(n_steps, device=dev) if has_probe else None
    got, want = clone(base), clone(base)
    for i in range(n_steps):
        got = step(got, pk, i)
        want = reference(want, pp, i)
    torch.cuda.synchronize()

    def exact():
        ex = {k: v.double() for k, v in base.items()}
        for i in range(n_steps):
            ex = reference(ex, None, i)
        return ex, base

    err = compare(f"{name}, {n_steps} outer step(s) vs {against}", got, want,
                  None if windows is None else exact, windows or ())
    if has_probe:
        compare_probes(name, pk, pp)
    return err


# -- the volume path -------------------------------------------------------------


def plain_volume(cuda_volume, model, dz_ratio=1.0):
    """The plain outer step of a volume as `reference(state, probe, i)`."""
    return lambda state, probe, i: cuda_volume.plain_volume_step(
        model, state, probe, i, dz_ratio=dz_ratio)


def seeded_volume(torch, interop, volume, cuda_volume, model, depth, dev,
                  rng):
    """The extruded initial state perturbed from `rng`, then 20 plain
    outer steps (10 ms) on the card, so that a wavefront has left the S1
    slab."""
    init = volume.volume_state(model, depth)
    shape = init["V"].shape
    init["V"] = init["V"] + rng.normal(0.0, 1.0, shape).astype(np.float32)
    for g in ("m", "h", "j", "d", "f", "x1"):
        init[g] = np.clip(init[g] * rng.uniform(0.98, 1.02, shape),
                          1e-5, 0.99999).astype(np.float32)
    init["C"] = (init["C"] * rng.uniform(0.9, 1.1, shape)).astype(np.float32)
    if model.cfg.ab2:
        init = model.bootstrap_ab2(init)
    base = interop.state_from_numpy(init, dev)
    for _ in range(20):
        cuda_volume.plain_volume_step(model, base)
    torch.cuda.synchronize()
    check(bool(base["V"].isfinite().all())
          and float(base["V"].max()) > WAVEFRONT_MV,
          f"{shape} seeded volume holds no wavefront")
    return base


def run_volume_timed(run_volume, model, depth, events, kernel="auto",
                     n_outer=VOL_STEPS, **kw):
    """One run_volume call of `n_outer` outer steps on the card, timed on
    the host clock: it returns host arrays, so its end is synchronised.
    The time includes the state's upload and the final read-back."""
    t0 = time.perf_counter()
    final, probes, frames = run_volume(model, depth, n_outer,
                                       events=events, kernel=kernel,
                                       device="cuda", **kw)
    return {"final": final, "probes": probes, "frames": frames,
            "wall_s": time.perf_counter() - t0}


def volume_crossings(detector_cls, model, probes):
    """The probe stream's crossings, found as the 2D engine finds them."""
    det = detector_cls(model.cfg.dt, model.dt_per_step,
                       model.cfg.plot_interval(model.dt_per_step),
                       lambda i, cl: None)
    det.feed(0, probes)
    return det.cycle_lengths


def check_volume_run(detector_cls, model, run, shape,
                     crossing=CROSSING_STEP, n_outer=VOL_STEPS):
    """A volume run's final state is finite and of `shape`, its probe
    stream has `n_outer` entries, and its first crossing is the 2D
    engine's at W=512 (for the bench configuration (CROSSING_STEP,
    166.0)), within CROSSING_SLACK."""
    for k, v in run["final"].items():
        check(v.shape == shape and np.isfinite(v).all(),
              f"final plane {k} not finite or of shape {v.shape}")
    check(run["probes"].shape == (n_outer,)
          and np.isfinite(run["probes"]).all(),
          f"probe stream of shape {run['probes'].shape} or not finite")
    check(run["frames"] is None, "frames recorded without frames_every")
    crossings = volume_crossings(detector_cls, model, run["probes"])
    print(f"  crossings {crossings}, wall {run['wall_s']:.3f} s", flush=True)
    check(len(crossings) >= 1, "the probe saw no wavefront")
    step, cl = crossings[0]
    step_ms = model.dt_per_step * model.cfg.dt
    check(abs(step - crossing) <= CROSSING_SLACK
          and abs(cl - crossing * step_ms)
          <= CROSSING_SLACK * step_ms + 1e-9,
          f"first crossing {(step, cl)}, expected ({crossing}, "
          f"{crossing * step_ms}) +- {CROSSING_SLACK} steps")
    return crossings


def check_against_plain_volume(detector_cls, model, run, ref, crossings):
    """A kernel volume run ends within WHOLE_RUN_ATOL_MV of the
    kernel='xla' run and crosses at the same step."""
    dv = np.abs(run["final"]["V"] - ref["final"]["V"])
    ref_crossings = volume_crossings(detector_cls, model, ref["probes"])
    print(f"  final V vs kernel='xla' run: max abs {dv.max():.4g} mV "
          f"(bound {WHOLE_RUN_ATOL_MV} mV); crossings {ref_crossings}; "
          f"probe max abs "
          f"{np.abs(run['probes'] - ref['probes']).max():.3g}; "
          f"xla wall {ref['wall_s']:.3f} s", flush=True)
    check(float(dv.max()) <= WHOLE_RUN_ATOL_MV,
          f"final V differs from the kernel-free run by {dv.max()} mV")
    check(ref_crossings[:1] == crossings[:1],
          "kernel and kernel-free volume runs cross at different steps")


# -- the sharded paths --------------------------------------------------------------


def wrapped_window(state, starts, sizes):
    """The window of a device state that starts at `starts` with `sizes`
    along its leading axes, wrapped round the domain's edges, as the first
    halo exchange wraps the ghosts beyond the domain."""
    import torch

    out = {}
    for k, v in state.items():
        for axis, (start, size) in enumerate(zip(starts, sizes)):
            index = (start + torch.arange(size, device=v.device)) % v.shape[
                axis]
            v = v.index_select(axis, index)
        out[k] = v.contiguous()
    return out


def check_block(torch, cuda_block, cuda_tiled, model, full, h_own, w_own,
                origin, n_steps, name, windows=None, maps=None):
    """`n_steps` outer steps of one shard's block, `h_own` rows (x `w_own`
    columns; None: the full width, a 1D mesh) at `origin` of `full`: each
    step the block is cut from the whole grid with its ghosts, the block
    kernel and its plain version advance it, and the whole grid advances
    through the tiled kernel (phase 5); `windows` as in
    check_outer_steps.  `maps` (bodies.GeometryMaps): the geometry, its
    phase field and diffusion map cut like the block (the GEOM entries).
    Returns the max abs error."""
    k = model.dt_per_step
    two_d = w_own is not None
    h, w = model.state_shape()
    rstart = origin[0] - k
    cstart = origin[1] - k if two_d else 0
    sizes = (h_own + 2 * k, w_own + 2 * k if two_d else w)
    owns = (origin[0] <= model.probe_pixel[0] < origin[0] + h_own and (
        not two_d or origin[1] <= model.probe_pixel[1] < origin[1] + w_own))
    fiber = None if maps is None else maps.fiber
    step = cuda_block.make_block_step(model, two_d, fiber)
    whole = (cuda_tiled.make_tiled_cuda_step(model) if maps is None else
             cuda_tiled.make_tiled_cuda_step(model, maps.phase, fiber,
                                             maps.dmap))
    ext_maps = [None, None]
    if maps is not None:
        ext_maps = [None if t is None else wrapped_window(
            {"m": t}, (rstart, cstart), sizes)["m"]
            for t in maps.tensors(next(iter(full.values())).device)]
    pe, de = ext_maps
    full = clone(full)
    worst = 0.0
    pot = model.pot_key
    for i in range(n_steps):
        ext = wrapped_window(full, (rstart, cstart), sizes)
        got = {kk: torch.zeros_like(v) for kk, v in ext.items()}
        want = {kk: torch.zeros_like(v) for kk, v in ext.items()}
        pk = torch.zeros(1, device=ext[pot].device) if owns else None
        pp = torch.zeros(1, device=ext[pot].device) if owns else None
        step(ext, got, rstart, cstart, pk, 0, phase_ext=pe, dmap_ext=de)
        cuda_block.plain_block_step(model, ext, want, rstart, cstart, two_d,
                                    pp, 0, pe, fiber, de)

        def exact(ext=ext):
            ex = {kk: torch.zeros_like(v, dtype=torch.float64)
                  for kk, v in ext.items()}
            cuda_block.plain_block_step(
                model, {kk: v.double() for kk, v in ext.items()}, ex, rstart,
                cstart, two_d, None, 0, pe, fiber, de)
            return ex, ext

        full = whole(full)
        torch.cuda.synchronize()
        worst = max(worst, compare(
            f"{name}, {'x'.join(map(str, sizes))} block, outer step {i + 1} "
            f"of {n_steps}", got, want, None if windows is None else exact,
            windows or ()))
        if owns:
            compare_probes(name, pk, pp)
        centre = cuda_block.centre(got[pot], k, two_d)
        own = full[pot][origin[0]:origin[0] + h_own]
        own = own[:, origin[1]:origin[1] + w_own] if two_d else own
        check(torch.equal(centre, own) or bool(
            ((centre - own).abs() <= ATOL + RTOL * own.abs()).all()),
            f"{name}: the block's centre differs from the tiled kernel's")
    return worst


def check_volume_block(torch, cuda_volume, cuda_volume_block, model, full,
                       d_own, z0, n_groups, dz_ratio, substeps, name,
                       windows=None):
    """`n_groups` groups of one shard's z-block, `d_own` slices at `z0` of
    `full`: each group the block is cut from the whole volume with its
    ghosts, the volume block kernel and its plain version advance it, and
    the whole volume advances through the volume substep kernel (phase
    8); `windows` as in check_outer_steps.  Returns the max abs error over
    the block's centre."""
    k = model.dt_per_step if substeps is None else substeps
    pot = model.pot_key
    depth = full[pot].shape[0]
    ext_d = d_own + 2 * k
    zstart = z0 - k
    zmid = depth // 2
    owns = z0 <= zmid < z0 + d_own
    step = cuda_volume_block.make_volume_block_step(model, ext_d, depth,
                                                    dz_ratio, substeps)
    full = clone(full)
    worst = 0.0
    for i in range(n_groups):
        ext = wrapped_window(full, (zstart,), (ext_d,))
        want = clone(ext)
        dev = ext[pot].device
        pk = torch.zeros(1, device=dev) if owns else None
        pp = torch.zeros(1, device=dev) if owns else None
        got, _ = step(ext, torch.empty_like(ext[pot]), zstart, pk, 0,
                      zmid - zstart)
        cuda_volume_block.plain_volume_block_step(
            model, want, zstart, depth, dz_ratio, substeps, pp, 0,
            zmid - zstart)

        def exact(ext=ext):
            ex = {kk: v.double() for kk, v in ext.items()}
            cuda_volume_block.plain_volume_block_step(
                model, ex, zstart, depth, dz_ratio, substeps)
            return ({kk: v[k:-k] for kk, v in ex.items()},
                    {kk: v[k:-k] for kk, v in ext.items()})

        if substeps is None:
            full = cuda_volume.make_volume_step(model, depth, dz_ratio)(full)
        else:
            for _ in range(substeps):
                full = cuda_volume.volume_substep(model, full, True,
                                                  dz_ratio=dz_ratio)
        torch.cuda.synchronize()
        worst = max(worst, compare(
            f"{name}, group {i + 1} of {n_groups}",
            {kk: v[k:-k] for kk, v in got.items()},
            {kk: v[k:-k] for kk, v in want.items()},
            None if windows is None else exact, windows or ()))
        if owns:
            compare_probes(name, pk, pp)
        own = full[pot][z0:z0 + d_own]
        check(bool(((got[pot][k:-k] - own).abs()
                    <= ATOL + RTOL * own.abs()).all()),
              f"{name}: the block's centre differs from the volume substep "
              f"kernel's")
    return worst


def check_sharded_against_unsharded(res, uns, name, key="V",
                                    atol=WHOLE_RUN_ATOL_MV):
    """A sharded run ends within `atol` of the unsharded tiled run in the
    potential `key`, bit-equal to it (the per-cell code is the same), with
    the same crossings."""
    dv = float(np.abs(res.state[key] - uns.state[key]).max())
    same = all(np.array_equal(res.state[k], uns.state[k]) for k in uns.state)
    print(f"  mesh {name}: final {key} vs the unsharded tiled run: max abs "
          f"{dv:.4g}; all {len(uns.state)} planes bit-equal: {same}; probes "
          f"bit-equal: {np.array_equal(res.probes['v'], uns.probes['v'])}",
          flush=True)
    check(dv <= atol,
          f"the {name} sharded run ends {dv} from the unsharded one")
    # kernels 2 and 3 share the tile skeleton and the cell body, so the
    # tiling does not change a cell's value
    check(same, f"the {name} sharded run is not bit-equal to the unsharded "
                f"tiled run")
    check(res.cycle_lengths == uns.cycle_lengths,
          f"the {name} sharded run crosses at {res.cycle_lengths}, the "
          f"unsharded one at {uns.cycle_lengths}")


def check_sharded_volume(detector_cls, model, run, ref, crossings, against):
    """A sharded volume run ends within WHOLE_RUN_ATOL_MV of `ref` and,
    where `crossings` are given, crosses with it."""
    dv = float(np.abs(run["final"]["V"] - ref["final"]["V"]).max())
    dp = float(np.abs(run["probes"] - ref["probes"]).max())
    same = all(np.array_equal(run["final"][k], ref["final"][k])
               for k in ref["final"])
    print(f"  final V vs {against}: max abs {dv:.4g} mV (bound "
          f"{WHOLE_RUN_ATOL_MV} mV); probe max abs {dp:.3g}; all 8 planes "
          f"bit-equal: {same}", flush=True)
    check(np.isfinite(run["final"]["V"]).all() and dv <= WHOLE_RUN_ATOL_MV,
          f"the sharded volume run ends {dv} mV from {against}")
    if crossings is not None:
        check(volume_crossings(detector_cls, model, ref["probes"])[:1]
              == crossings[:1],
              f"the sharded volume run and {against} cross at different "
              f"steps")


def block_bound(ext_cells: int, own_cells: int, schedule):
    """One outer step of a shard's block: 8 planes of the extended block
    read once, 8 planes of its centre written once, and the operations of
    the centre's substeps."""
    return bound(4 * 8 * (ext_cells + own_cells),
                 own_cells * sum(substep_flops(s, False) for s in schedule))


def time_copies(torch, state, k, volume):
    """Device time of one shard's halo copies as the sharded paths make
    them: k ghost rows (slices) of all planes from each of two neighbours,
    the planes stacked in one allocation.  2D: one strided copy per
    neighbour; volume: two, V from its own buffer and the other seven
    planes together."""
    a = torch.stack(list(state.values()))
    b = a.clone()
    parts = (slice(0, 1), slice(1, None)) if volume else (slice(None),)

    def copies():
        for dst, src in ((slice(0, k), slice(-2 * k, -k)),
                         (slice(-k, None), slice(k, 2 * k))):
            for planes in parts:
                a[planes, dst].copy_(b[planes, src], non_blocking=True)
    return device_us(torch, copies, reps=50)


def time_block(torch, bodies, cuda_block, cuda_tiled, model, full, h_own,
               origin):
    """Device time per outer step of the block kernel on one row shard's
    extended block, of its plain version (substep by substep, summed over
    the schedule, as in time_tiled) and of the shard's halo copies, and the
    kernel's memory-vs-compute split (time_split)."""
    k = model.dt_per_step
    h, w = model.state_shape()
    rstart = origin[0] - k
    ext = wrapped_window(full, (rstart, 0), (h_own + 2 * k, w))
    out = {kk: torch.zeros_like(v) for kk, v in ext.items()}
    step = cuda_block.make_block_step(model, False)
    geom = cuda_block.block_geometry(
        cuda_block.global_rows(rstart, h_own + 2 * k, ext["V"].device), h)
    plain = {slow: device_us(torch, lambda: model.solve(
        ext, geom, n=model.slow_n if slow else 0), reps=1)
        for slow in (True, False)}
    params = bodies.pack_params(model)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(schedule):
        cuda_block.KERNEL.launch(params, ext, out, rstart, 0, k, False, h, w,
                                 schedule, None, model.probe_pixel, 0, stream)

    return {
        "kernel_us": device_us(torch, lambda: step(ext, out, rstart, 0),
                               reps=50),
        "plain_us": sum(plain[slow]
                        for slow in model.launch_schedule),
        "copies_us": time_copies(torch, ext, k, volume=False),
        "ext_cells": (h_own + 2 * k) * w, "own_cells": h_own * w,
        "split": time_split(torch, launch, lambda n: tile_count(
            cuda_tiled, n, h_own, w), ext_rows=tile_rows(cuda_tiled)),
    }


def time_volume_block(torch, bodies, cuda_volume_block, model, full,
                      d_own, z0):
    """Device times of the volume block kernel on one shard's z-block: the
    group of an outer step, its SLOW launch alone (the frozen launches
    are the rest, each on the slices its substep still needs), the plain
    substeps on the block, and the shard's halo copies."""
    k = model.dt_per_step
    depth = full["V"].shape[0]
    ext_d = d_own + 2 * k
    zstart = z0 - k
    ext = wrapped_window(full, (zstart,), (ext_d,))
    spare = torch.empty_like(ext["V"])
    step = cuda_volume_block.make_volume_block_step(model, ext_d, depth)
    params = bodies.pack_params(model)
    stream = torch.cuda.current_stream().cuda_stream
    geom = cuda_volume_block.zblock_geometry(
        cuda_volume_block.global_slices(zstart, ext_d, ext["V"].device),
        depth)
    schedule = model.launch_schedule
    check(schedule == (True, False, False, False, False),
          f"the timed model's schedule is {schedule}")
    # substep i runs on the slices [i + 1, ext_d - 1 - i)
    slices = [ext_d - 2 - 2 * i for i in range(len(schedule))]

    def group():
        nonlocal spare
        _, spare = step(ext, spare, zstart)

    t = {
        "group_us": device_us(torch, group, reps=100),
        "slow_us": device_us(torch, lambda: cuda_volume_block.KERNEL.launch(
            params, ext, spare, True, 1.0, zstart, depth, 1, ext_d - 1, None,
            (0, 0, 0), 0, stream), reps=200),
        "slow_slices": slices[0],
        "frozen_slices": sum(slices[1:]) / (len(slices) - 1),
        "copies_us": time_copies(torch, ext, k, volume=True),
    }

    def frozen():
        # substeps 1-4 of the group, V back in its buffer after the four
        other_v = spare
        for i in range(1, len(schedule)):
            cuda_volume_block.KERNEL.launch(
                params, ext, other_v, False, 1.0, zstart, depth, i + 1,
                ext_d - 1 - i, None, (0, 0, 0), 0, stream)
            ext["V"], other_v = other_v, ext["V"]

    t["frozen_us"] = device_us(torch, frozen, reps=50) / (len(schedule) - 1)
    for body, slow in (("slow", True), ("frozen", False)):
        t[f"plain_{body}_us"] = device_us(torch, lambda: model.solve(
            ext, geom, n=model.slow_n if slow else 0), reps=1)
    return t


def substep_flops(slow: bool, volume: bool) -> int:
    """Float32 operations per cell of one BR substep (br_cell.cuh, counted
    by hand; logf counts as one): the 9-point stencil 10 and the z term 4,
    the Chebyshev terms 10, 16 per degree-8 fit (14 SLOW, 6 frozen), 4 per
    gate update (6 SLOW, 2 frozen), 20 for the currents, 6 for Ca, 5 for
    V."""
    fits, gates = (14, 6) if slow else (6, 2)
    return 10 + (4 if volume else 0) + 10 + 16 * fits + 4 * gates + 31


def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over HBM's rate and
    the operations over the float32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def launch_bound(cells: int, slow: bool, volume: bool):
    """One substep launch: 8 planes read, 8 written (SLOW) or 4 (V, C, m,
    h; frozen)."""
    return bound(4 * cells * (8 + (8 if slow else 4)),
                 cells * substep_flops(slow, volume))


def outer_step_bound(cells: int, schedule, volume: bool):
    """One fused outer step: 8 planes read once and written once, and the
    operations of the interior's substeps (the halo's recompute is not
    work the function needs)."""
    return bound(4 * cells * 16,
                 cells * sum(substep_flops(s, volume) for s in schedule))


def kernel_entry(name, source, replaces, launches, err, us, plain_us,
                 bound_pair):
    bound_ms, bound_by = bound_pair
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": us / 1e3, "plain_ms": plain_us / 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a BR substep
            "library_ms": None,
            # cells past rtol/atol that passed by float64 arbitration
            "arbitrated_cells": ARBITRATED.get(name.split("<")[0], 0)}


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


def time_kernels(torch, model, base, cuda_step, bodies):
    """Per-launch device times of the model's substep bodies (BR's slow
    and frozen; the other models' one, under "slow") and of the plain
    substeps, and the device and host-paced time of an outer step."""
    state = clone(base)
    params = bodies.pack_params(model)
    kernel = cuda_step.KERNELS[bodies.cell_body(model).name]
    schedule = model.launch_schedule
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for body, slow in (("slow", True), ("frozen", False)):
        if slow not in schedule:
            continue
        out[body] = {
            "kernel_us": device_us(torch, lambda: kernel.launch(
                params, state, slow, None, model.probe_pixel, 0, stream),
                reps=200),
            "plain_us": device_us(torch, lambda: cuda_step.plain_substep(
                model, state, slow), reps=2),
        }
    step = cuda_step.make_cuda_step(model)
    # 500 launches queued behind the spin kernel
    out["step_device_us"] = device_us(torch, lambda: step(state),
                                      reps=500 // len(schedule))
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
    """Device time per outer step of `large` (2048x2048) and `model`
    (512x512), keyed by their grids: the tiled kernel, the substep route
    and the plain step.  The plain outer step is timed substep by substep
    and summed over the schedule: its substeps queue more launches than
    the stream holds behind the spin kernel."""
    out = {}
    for i, (m, b) in enumerate(((large, base_large), (model, base))):
        state = clone(b)
        schedule = m.launch_schedule

        def run(step):
            return lambda: step(state)

        reps = 50 if i == 0 else 200
        plain = {slow: device_us(torch, lambda: cuda_step.plain_substep(
            m, state, slow), reps=1) for slow in set(schedule)}
        out["x".join(map(str, m.state_shape()))] = {
            "tiled_us": device_us(torch, run(
                cuda_tiled.make_tiled_cuda_step(m)), reps=reps),
            # as many launches as five-substep BR's
            "substep_us": device_us(torch, run(cuda_step.make_cuda_step(m)),
                                    reps=reps * 5 // len(schedule)),
            "plain_us": sum(plain[slow] for slow in schedule),
        }
    return out


def tile_rows(cuda_tiled) -> int:
    """Rows of the tile skeleton's extended tile (ops/cuda_tiled.py TILE)."""
    return cuda_tiled.TILE[1] * cuda_tiled.TILE[2]


def tile_count(cuda_tiled, n_sub: int, rows: int, cols: int) -> int:
    """Tiles of a rows x cols window at `n_sub` substeps: as many per axis
    as the largest interior needs."""
    th, tw = cuda_tiled.tile_interior(n_sub)
    return -(-rows // th) * -(-cols // tw)


def ring_rows(n_sub: int, rows: int) -> float:
    """The rows `n_sub` substeps update on a `rows`-row tile, in units of
    the first substep's (rows - 2): substep s updates rows - 2 - 2s."""
    return sum(rows - 2 - 2 * s for s in range(n_sub)) / (rows - 2)


def fit_line(xs, ys):
    """(intercept, slope) of the least-squares line through the points."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return my - slope * mx, slope


def time_split(torch, launch, tiles, ext_rows: int, reps: int = 30):
    """The memory-vs-compute split of a fused outer-step kernel from its
    existing arguments: device time of `launch(schedule)` for n_sub =
    1..5, all frozen and all SLOW, divided by `tiles(n_sub)` and fitted by
    a straight line in ring_rows(n_sub).  The intercept is what a tile
    costs besides its substeps (its load and store, where the compute does
    not hide them), the slopes one frozen and one SLOW substep over a
    whole (ext_rows - 2)-row ring (ns per tile)."""
    out = {}
    for body, slow in (("frozen", False), ("slow", True)):
        xs, ys = [], []
        for n in range(1, 6):
            us = device_us(torch, lambda: launch((slow,) * n), reps=reps)
            out[f"{body}_n{n}_us"] = us
            out[f"{body}_n{n}_tiles"] = tiles(n)
            xs.append(ring_rows(n, ext_rows))
            ys.append(us * 1e3 / tiles(n))
        out[f"{body}_intercept_ns"], out[f"{body}_slope_ns"] = fit_line(xs,
                                                                         ys)
    return out


def split_tiled(torch, bodies, cuda_tiled, model, base):
    """time_split of the tiled kernel on `base`."""
    state = clone(base)
    h, w = model.state_shape()
    params = bodies.pack_params(model)
    stream = torch.cuda.current_stream().cuda_stream
    return time_split(
        torch, lambda schedule: cuda_tiled.KERNEL.launch(
            params, state, schedule, None, model.probe_pixel, 0, stream),
        lambda n: tile_count(cuda_tiled, n, h, w),
        ext_rows=tile_rows(cuda_tiled))


def print_split(name, split, card):
    for body in ("frozen", "slow"):
        points = ", ".join(f"n={n} {split[f'{body}_n{n}_us']:.2f} us / "
                           f"{split[f'{body}_n{n}_tiles']} tiles"
                           for n in range(1, 6))
        print(f"  {name}, split all {body}: {points}; per tile "
              f"{split[f'{body}_intercept_ns']:.2f} ns + "
              f"{split[f'{body}_slope_ns']:.2f} ns per substep of a whole "
              f"ring (device) [{card}]", flush=True)


def time_volume(torch, bodies, cuda_volume, cuda_volume_tiled, sizes):
    """Device times at each (name, model, base) of `sizes`: both volume
    substep bodies per launch and their plain versions per substep; per
    outer step, the substep route (5 launches), the tiled volume kernel and
    the plain step (its substeps timed one by one and summed over the
    schedule, as in time_tiled)."""
    out = {}
    for size, m, b in sizes:
        state = clone(b)
        depth = state["V"].shape[0]
        params = bodies.pack_params(m)
        pixel = cuda_volume.volume_probe_pixel(m, depth)
        stream = torch.cuda.current_stream().cuda_stream
        t = {}
        for body, slow in (("slow", True), ("frozen", False)):
            t[f"{body}_us"] = device_us(
                torch, lambda: cuda_volume.KERNEL.launch(
                    params, state, slow, 1.0, None, pixel, 0, stream),
                reps=200)
            t[f"plain_{body}_us"] = device_us(
                torch, lambda: cuda_volume.plain_volume_substep(
                    m, state, slow), reps=1)
        substep_route = cuda_volume.make_volume_step(m, depth)
        tiled = cuda_volume_tiled.make_tiled_volume_step(m, depth)
        t["substep_us"] = device_us(torch, lambda: substep_route(state),
                                    reps=100)
        t["tiled_us"] = device_us(torch, lambda: tiled(state), reps=100)
        t["plain_us"] = sum(t["plain_slow_us" if slow else "plain_frozen_us"]
                            for slow in m.launch_schedule)
        t["shape"] = tuple(state["V"].shape)
        out[size] = t
    return out


# -- Fenton and Mitchell-Schaeffer (phases 18-23) ---------------------------------


def small_state(interop, name, shape, dev, rng):
    """A seeded Fenton or Mitchell-Schaeffer state on the card: every
    plane drawn per cell (SMALL_PLANES)."""
    return interop.state_from_numpy(
        {k: rng.uniform(0.0, hi, shape).astype(np.float32)
         for k, hi in SMALL_PLANES[name].items()}, dev)


def small_bound(name, cells, n_sub=1, volume=False, read_cells=None):
    """(bound_ms, bound_by) of `n_sub` fused substeps of a small model on
    `cells` cells: every plane read once (of `read_cells`, an extended
    block's, where given) and written once, and the cells' operations."""
    planes = len(SMALL_PLANES[name])
    read = cells if read_cells is None else read_cells
    return bound(4 * planes * (read + cells),
                 cells * n_sub * (SMALL_FLOPS[name] + (4 if volume else 0)))


def check_only(counts, name, run):
    """No kernel but `name` launched in `run`."""
    others = {k: c for k, c in counts.items()
              if k != name and total_launches(c)}
    check(not others, f"{run} launched other kernels: {others}")


def check_launched(counts, entry, want, run):
    """Exactly `want` launches of `entry`, and of no other kernel, in
    `run`."""
    check(counts[entry] == want,
          f"{run}: {entry} launched {counts[entry]}, expected {want}")
    check_only(counts, entry, run)


def small_model_phases(torch, m, card, rng):
    """Phases 18-23: Fenton and Mitchell-Schaeffer on kernels 1-4.  `m`
    carries the port's modules and main()'s launch counters; returns the
    eight kernels' entries of the JSON line."""
    dev = torch.device("cuda")
    k1, k2, k3, k4 = (m.cuda_step, m.cuda_tiled, m.cuda_block,
                      m.cuda_volume)
    bodies = m.bodies
    classes = {"fenton": m.Fenton4v, "ms": m.MitchellSchaeffer}
    cfg = m.SimConfig(**SMALL_CFG)
    cfg_large = m.SimConfig(**SMALL_CFG_LARGE)
    scroll = m.SimConfig(**SCROLL_CFG)
    errs, launches, times = {}, {}, {}
    grid = f"{cfg.height}x{cfg.width}"
    grid_large = f"{cfg_large.height}x{cfg_large.width}"
    vgrid = f"{SCROLL_DEPTH}x{grid}"

    # -- phase 18 ---------------------------------------------------------------
    print("phase 18: Fenton and Mitchell-Schaeffer on kernels 1-4 vs plain "
          "PyTorch, 2 outer steps from seeded states, exact launches",
          flush=True)
    bases = {}
    for name, cls in classes.items():
        model, large = cls(cfg), cls(cfg_large)
        vmodel = cls(scroll)
        bases[name] = {
            "grid": small_state(m.interop, name, model.state_shape(), dev,
                                rng),
            "large": small_state(m.interop, name, large.state_shape(), dev,
                                 rng),
            "volume": small_state(m.interop, name, (SCROLL_DEPTH,)
                                  + vmodel.state_shape(), dev, rng)}
        plain = lambda mod: (lambda st, p, i: k1.plain_step(mod, st, p, i))
        err = 0.0
        for mod, base, label in ((model, bases[name]["grid"], grid),
                                 (cls(cfg.replace(height=67, width=131)),
                                  small_state(m.interop, name, (67, 131),
                                              dev, rng), "67x131")):
            m.reset_counts()
            err = max(err, check_outer_steps(
                torch, k1.make_cuda_step(mod), plain(mod), base, 2,
                f"{name}_substep {label}"))
            check_launched(m.read_counts(), f"{name}_substep",
                           {"slow": 20, "frozen": 0}, f"{name} {label}")
        errs[(name, "substep")] = err
        err = 0.0
        for mod, base, label in ((large, bases[name]["large"], grid_large),
                                 (cls(cfg.replace(height=67, width=131)),
                                  small_state(m.interop, name, (67, 131),
                                              dev, rng), "67x131")):
            m.reset_counts()
            err = max(err, check_outer_steps(
                torch, k2.make_tiled_cuda_step(mod), plain(mod), base, 2,
                f"{name}_tiled {label}"))
            check_launched(m.read_counts(), f"{name}_tiled", 2,
                           f"{name} {label}")
        errs[(name, "tiled")] = err
        err = 0.0
        h, w = large.state_shape()
        row = h // N_SHARDS
        for label, h_own, w_own, origin in (
                ("4x1 top", row, None, (0, 0)),
                ("4x1 interior", row, None, (row, 0)),
                ("4x1 bottom", row, None, (h - row, 0)),
                ("2x2 corner", h // 2, w // 2, (h // 2, w // 2))):
            m.reset_counts()
            err = max(err, check_block(
                torch, k3, k2, large, bases[name]["large"], h_own, w_own,
                origin, 2, f"{name}_block {grid_large} {label}"))
            counts = m.read_counts()
            check(counts[f"{name}_block"] == 2
                  and counts[f"{name}_tiled"] == 2,
                  f"{name} {label}: launches {counts}")
        errs[(name, "block")] = err
        err = 0.0
        for depth, mod, base, label in (
                (SCROLL_DEPTH, vmodel, bases[name]["volume"], vgrid),
                (5, cls(scroll.replace(height=67, width=131)),
                 small_state(m.interop, name, (5, 67, 131), dev, rng),
                 "5x67x131")):
            for dz in (1.0, 0.5):
                m.reset_counts()
                err = max(err, check_outer_steps(
                    torch, k4.make_volume_step(mod, depth, dz),
                    plain_volume(k4, mod, dz), base, 2,
                    f"{name}_volume {label} dz_ratio={dz}"))
                check_launched(m.read_counts(), f"{name}_volume",
                               {"slow": 20, "frozen": 0},
                               f"{name} {label}")
        errs[(name, "volume")] = err

    # -- phase 19 ---------------------------------------------------------------
    fenton = m.Fenton4v(cfg)
    print(f"phase 19: Fenton, Table 1's row: Simulation(Fenton4v(cfg))"
          f".define().simulate() at {grid}, dt 0.1, diff 1.5, "
          f"{cfg.duration} ms", flush=True)
    sim = m.Simulation(fenton, device="cuda").define()
    check(sim.route == "substep", f"Fenton {grid} routes {sim.route!r}")
    m.reset_counts()
    res = sim.simulate()
    counts = m.read_counts()
    print(f"  route {sim.route}, steps {res.steps}, launches "
          f"{counts['fenton_substep']}, cycle_lengths {res.cycle_lengths}",
          flush=True)
    check_launched(counts, "fenton_substep",
                   {"slow": 10 * res.steps, "frozen": 0}, f"Fenton {grid}")
    launches[("fenton", "substep")] = 10 * res.steps
    check_run(res, fenton.state_shape(), SMALL_CROSSINGS["fenton"])
    before = m.read_counts()
    t0 = time.perf_counter()
    ref = m.Simulation(m.Fenton4v(cfg.replace(kernel="xla")),
                       device="cuda").define().simulate()
    print(f"  kernel='xla' run: {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(m.read_counts() == before, "the kernel='xla' run launched a kernel")
    check_against_plain_run(res, ref, "u", SMALL_ATOL)
    t = times[("fenton", "grid")] = time_kernels(
        torch, fenton, bases["fenton"]["grid"], k1, bodies)
    tt = times[("fenton", "tiled")] = time_tiled(
        torch, k1, k2, m.Fenton4v(cfg_large), bases["fenton"]["large"],
        fenton, bases["fenton"]["grid"])
    long = m.Simulation(m.Fenton4v(cfg.replace(duration=1000)),
                        device="cuda").define().simulate()
    # the cutover question (ROADMAP Queue 1 item 4): the same run on the
    # tiled route, one launch per outer step instead of ten
    cutover = m.Simulation.WHOLE_GRID_STATE_MB_MAX
    m.Simulation.WHOLE_GRID_STATE_MB_MAX = 0
    try:
        sim = m.Simulation(m.Fenton4v(cfg.replace(duration=1000)),
                           device="cuda").define()
    finally:
        m.Simulation.WHOLE_GRID_STATE_MB_MAX = cutover
    check(sim.route == "tiled", f"lowered cutover routes {sim.route!r}")
    long_tiled = sim.simulate()
    du = float(np.abs(long_tiled.state["u"] - long.state["u"]).max())
    check(du <= SMALL_ATOL, f"Fenton {grid} tiled and substep routes end "
                            f"{du} apart")
    print(f"  fenton_substep: {t['slow']['kernel_us']:.3f} us/launch "
          f"(device), plain substep {t['slow']['plain_us']:.1f} us; outer "
          f"step (10 launches): device {t['step_device_us']:.2f} us, "
          f"host-paced {t['step_wall_us']:.2f} us, host enqueue "
          f"{t['step_host_us']:.2f} us; tiled kernel at {grid} "
          f"{tt[grid]['tiled_us']:.2f} us/outer step "
          f"(device); simulate() {1.0 / long.sim_seconds_per_wall_second:.6f}"
          f" wall-s/sim-s over 1000 ms, on the tiled route (cutover "
          f"lowered) {1.0 / long_tiled.sim_seconds_per_wall_second:.6f} "
          f"(final u {du:.3g} apart), kernel='xla' "
          f"{1.0 / ref.sim_seconds_per_wall_second:.6f} over 400 ms "
          f"[{card}]", flush=True)

    # -- phase 20 ---------------------------------------------------------------
    print(f"phase 20: Fenton past the 32 MB cutover at {grid_large}, "
          f"{cfg_large.duration} ms", flush=True)
    large = m.Fenton4v(cfg_large)
    sim = m.Simulation(large, device="cuda").define()
    check(sim.route == "tiled", f"Fenton {grid_large} routes {sim.route!r}")
    m.reset_counts()
    res_large = sim.simulate()
    counts = m.read_counts()
    print(f"  route {sim.route}, steps {res_large.steps}, cycle_lengths "
          f"{res_large.cycle_lengths}", flush=True)
    check_launched(counts, "fenton_tiled", res_large.steps,
                   f"Fenton {grid_large}")
    launches[("fenton", "tiled")] = res_large.steps
    check_run(res_large, large.state_shape(), SMALL_CROSSINGS["fenton_2048"])
    before = m.read_counts()
    t0 = time.perf_counter()
    ref_large = m.Simulation(m.Fenton4v(cfg_large.replace(kernel="xla")),
                             device="cuda").define().simulate()
    print(f"  kernel='xla' run: {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(m.read_counts() == before, "the kernel='xla' run launched a kernel")
    check_against_plain_run(res_large, ref_large, "u", SMALL_ATOL)
    t = tt[grid_large]
    print(f"  {grid_large}: fenton_tiled {t['tiled_us']:.2f} us/outer step, "
          f"substep route (10 launches) {t['substep_us']:.2f}, ratio "
          f"{t['tiled_us'] / t['substep_us']:.4f}, plain "
          f"{t['plain_us']:.1f} (device); simulate() on the tiled route "
          f"{1.0 / res_large.sim_seconds_per_wall_second:.6f} wall-s/sim-s, "
          f"kernel='xla' {1.0 / ref_large.sim_seconds_per_wall_second:.6f} "
          f"[{card}]", flush=True)

    # -- phase 21 ---------------------------------------------------------------
    print(f"phase 21: Fenton at {grid_large} on four row shards of cuda:0, "
          f"wide_halo=True (K = 10)", flush=True)
    mesh = m.make_mesh(devices=["cuda:0"] * N_SHARDS)
    sim = m.Simulation(m.Fenton4v(cfg_large), mesh=mesh,
                       wide_halo=True).define()
    check(sim.route == "block", f"the sharded run routes {sim.route!r}")
    m.reset_counts()
    res_rows = sim.simulate()
    counts = m.read_counts()
    check_launched(counts, "fenton_block", N_SHARDS * res_rows.steps,
                   "the sharded Fenton run")
    launches[("fenton", "block")] = N_SHARDS * res_rows.steps
    check_run(res_rows, large.state_shape(), SMALL_CROSSINGS["fenton_2048"])
    check_sharded_against_unsharded(res_rows, res_large, "4x1", "u",
                                    SMALL_ATOL)
    t = times[("fenton", "block")] = time_small_block(
        torch, m, large, bases["fenton"]["large"])
    print(f"  fenton_block on the {t['ext_rows']}x{t['width']} block (interior "
          f"shard): {t['kernel_us']:.2f} us/outer step, plain "
          f"{t['plain_us']:.1f} (device); sharded simulate() "
          f"{1.0 / res_rows.sim_seconds_per_wall_second:.6f} wall-s/sim-s, "
          f"host-paced {res_rows.elapsed / res_rows.steps * 1e6:.2f} "
          f"us/outer step [{card}]", flush=True)

    # -- phase 22 ---------------------------------------------------------------
    print(f"phase 22: the Fenton scroll wave, run_volume(Fenton4v(cfg), "
          f"{SCROLL_DEPTH}, {SCROLL_STEPS}) at {vgrid}, dt "
          f"0.05, S2 at step {SCROLL_S2} over z < {SCROLL_DEPTH // 2}",
          flush=True)
    vmodel = m.Fenton4v(scroll)
    events = [m.VolumeEvent(step=SCROLL_S2, loc="luq", z1=SCROLL_DEPTH // 2)]
    route = m.volume.volume_route(vmodel, SCROLL_DEPTH, "cuda", "auto")
    check(route == "substep", f"the scroll wave routes {route!r}")
    m.run_volume(vmodel, SCROLL_DEPTH, 2, device="cuda")
    m.reset_counts()
    vrun = run_volume_timed(m.run_volume, vmodel, SCROLL_DEPTH, events,
                            n_outer=SCROLL_STEPS)
    counts = m.read_counts()
    check_launched(counts, "fenton_volume",
                   {"slow": 10 * SCROLL_STEPS, "frozen": 0},
                   "the scroll wave")
    launches[("fenton", "volume")] = 10 * SCROLL_STEPS
    vref = run_volume_timed(m.run_volume, vmodel, SCROLL_DEPTH, events,
                            kernel="xla", n_outer=SCROLL_STEPS)
    check_small_volume(m, vmodel, vrun, vref, SMALL_CROSSINGS["fenton_scroll"])
    t = times[("fenton", "volume")] = time_small_volume(
        torch, m, vmodel, bases["fenton"]["volume"])
    sim_s = SCROLL_STEPS * vmodel.dt_per_step * scroll.dt / 1000.0
    print(f"  fenton_volume at {vgrid}: {t['kernel_us']:.3f} "
          f"us/launch, outer step (10 launches) {t['step_us']:.2f} us, plain "
          f"substep {t['plain_us']:.1f} us (device); run_volume "
          f"{vrun['wall_s'] / sim_s:.6f} wall-s/sim-s, kernel='xla' "
          f"{vref['wall_s'] / sim_s:.6f} [{card}]", flush=True)

    # -- phase 23 ---------------------------------------------------------------
    print(f"phase 23: Mitchell-Schaeffer at {grid}, {cfg.duration} ms "
          f"(kernel 1), and {MS_SHORT_STEPS} outer steps on kernels 2-4 "
          f"({cfg_large.height}x{MS_LARGE_WIDTH})", flush=True)
    ms = m.MitchellSchaeffer(cfg)
    sim = m.Simulation(ms, device="cuda").define()
    check(sim.route == "substep", f"MS {grid} routes {sim.route!r}")
    m.reset_counts()
    res = sim.simulate()
    check_launched(m.read_counts(), "ms_substep",
                   {"slow": 10 * res.steps, "frozen": 0}, f"MS {grid}")
    launches[("ms", "substep")] = 10 * res.steps
    print(f"  steps {res.steps}, cycle_lengths {res.cycle_lengths}",
          flush=True)
    check_run(res, ms.state_shape(), SMALL_CROSSINGS["ms"])
    ref = m.Simulation(m.MitchellSchaeffer(cfg.replace(kernel="xla")),
                       device="cuda").define().simulate()
    check_against_plain_run(res, ref, "u", SMALL_ATOL)
    short = cfg_large.replace(duration=MS_SHORT_STEPS,
                              width=MS_LARGE_WIDTH)
    grid_ms = f"{short.height}x{short.width}"
    sim = m.Simulation(m.MitchellSchaeffer(short), device="cuda").define()
    check(sim.route == "tiled", f"MS {grid_ms} routes {sim.route!r}")
    m.reset_counts()
    res_large = sim.simulate()
    check_launched(m.read_counts(), "ms_tiled", res_large.steps,
                   f"MS {grid_ms}")
    launches[("ms", "tiled")] = res_large.steps
    ref_large = m.Simulation(m.MitchellSchaeffer(short.replace(
        kernel="xla")), device="cuda").define().simulate()
    check_against_plain_run(res_large, ref_large, "u", SMALL_ATOL)
    sim = m.Simulation(m.MitchellSchaeffer(short), mesh=mesh,
                       wide_halo=True).define()
    m.reset_counts()
    res_rows = sim.simulate()
    check_launched(m.read_counts(), "ms_block", N_SHARDS * res_rows.steps,
                   "the sharded MS run")
    launches[("ms", "block")] = N_SHARDS * res_rows.steps
    check_sharded_against_unsharded(res_rows, res_large, "4x1", "u",
                                    SMALL_ATOL)
    vms = m.MitchellSchaeffer(scroll)
    m.reset_counts()
    vrun = run_volume_timed(m.run_volume, vms, SCROLL_DEPTH, events,
                            n_outer=MS_SHORT_STEPS)
    check_launched(m.read_counts(), "ms_volume",
                   {"slow": 10 * MS_SHORT_STEPS, "frozen": 0}, "MS volume")
    launches[("ms", "volume")] = 10 * MS_SHORT_STEPS
    vref = run_volume_timed(m.run_volume, vms, SCROLL_DEPTH, events,
                            kernel="xla", n_outer=MS_SHORT_STEPS)
    check_small_volume(m, vms, vrun, vref, None)
    times[("ms", "grid")] = time_kernels(torch, ms, bases["ms"]["grid"], k1,
                                         bodies)
    times[("ms", "tiled")] = time_tiled(
        torch, k1, k2, m.MitchellSchaeffer(cfg_large), bases["ms"]["large"],
        ms, bases["ms"]["grid"])
    times[("ms", "block")] = time_small_block(
        torch, m, m.MitchellSchaeffer(cfg_large), bases["ms"]["large"])
    times[("ms", "volume")] = time_small_volume(torch, m, vms,
                                                bases["ms"]["volume"])
    t1, t2 = times[("ms", "grid")], times[("ms", "tiled")][grid_large]
    t3, t4 = times[("ms", "block")], times[("ms", "volume")]
    print(f"  ms_substep {t1['slow']['kernel_us']:.3f} us/launch at {grid} "
          f"(plain {t1['slow']['plain_us']:.1f}; outer step device "
          f"{t1['step_device_us']:.2f}"
          f", host-paced {t1['step_wall_us']:.2f}); ms_tiled "
          f"{t2['tiled_us']:.2f} us/outer step at {grid_large} against 10 "
          f"launches of ms_substep {t2['substep_us']:.2f}; ms_block "
          f"{t3['kernel_us']:.2f} us on the {t3['ext_rows']}x{t3['width']} "
          f"block; ms_volume {t4['kernel_us']:.3f} us/launch at {vgrid} "
          f"(device); simulate() at {grid} over {cfg.duration} ms "
          f"{1.0 / res.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
          f"[{card}]", flush=True)

    entries = []
    cells = int(np.prod(fenton.state_shape()))
    cells_large = int(np.prod(large.state_shape()))
    for name in classes:
        blk = times[(name, "block")]
        sub = times[(name, "grid")]["slow"]
        til = times[(name, "tiled")][grid_large]
        kind_rows = (
            ("substep", "br_substep.cu", "fib_tf_tpu/ops/pallas_step.py:205",
             sub["kernel_us"], sub["plain_us"], small_bound(name, cells)),
            ("tiled", "br_tiled.cu", "fib_tf_tpu/ops/pallas_tiled.py:342",
             til["tiled_us"], til["plain_us"],
             small_bound(name, cells_large, n_sub=10)),
            ("block", "br_block.cu", "fib_tf_tpu/ops/pallas_tiled.py:202",
             blk["kernel_us"], blk["plain_us"],
             small_bound(name, blk["own_cells"], n_sub=10,
                         read_cells=blk["ext_rows"] * blk["width"])),
            ("volume", "br_volume.cu",
             "fib_tf_tpu/ops/pallas_volume.py:499",
             times[(name, "volume")]["kernel_us"],
             times[(name, "volume")]["plain_us"],
             small_bound(name, SCROLL_DEPTH * cells, volume=True)))
        for kind, source, replaces, us, plain_us, pair in kind_rows:
            entries.append(kernel_entry(
                f"{name}_{kind}", f"fib_tf_tpu_torch/csrc/{source}",
                replaces, launches[(name, kind)], errs[(name, kind)], us,
                plain_us, pair))
    return entries


def check_small_volume(m, model, run, ref, crossing):
    """A small-model volume run is finite, within SMALL_ATOL of the
    kernel='xla' run, and crosses with it; with `crossing`, first at that
    pinned outer step +- CROSSING_SLACK."""
    u = run["final"]["u"]
    du = float(np.abs(u - ref["final"]["u"]).max())
    mine = volume_crossings(m.CycleLengthDetector, model, run["probes"])
    theirs = volume_crossings(m.CycleLengthDetector, model, ref["probes"])
    print(f"  crossings {mine}, kernel='xla' {theirs}; final u vs "
          f"kernel='xla': max abs {du:.4g} (bound {SMALL_ATOL}); wall "
          f"{run['wall_s']:.3f} s, kernel='xla' {ref['wall_s']:.3f} s",
          flush=True)
    check(all(np.isfinite(v).all() for v in run["final"].values()),
          "the volume run is not finite")
    check(du <= SMALL_ATOL, f"final u differs from kernel='xla' by {du}")
    check(mine[:1] == theirs[:1],
          "kernel and kernel-free volume runs cross at different steps")
    if crossing is not None:
        check(len(mine) >= 1 and abs(mine[0][0] - crossing) <= CROSSING_SLACK,
              f"first crossing {mine[:1]}, expected step {crossing} +- "
              f"{CROSSING_SLACK}")


def time_small_block(torch, m, model, full):
    """The block kernel on the interior row shard of a 4x1 mesh (a quarter
    of the rows, e.g. 512 of 2048, and K = 10 ghost rows each side):
    device time per outer step, and of the plain block step (one substep
    under `block_geometry`, timed alone, times ten: a whole plain step
    queues more launches than the stream holds behind the spin kernel)."""
    k = model.dt_per_step
    h, w = model.state_shape()
    row = h // N_SHARDS
    rstart = row - k
    ext = wrapped_window(full, (rstart, 0), (row + 2 * k, w))
    out = {kk: torch.zeros_like(v) for kk, v in ext.items()}
    step = m.cuda_block.make_block_step(model, False)
    geom = m.cuda_block.block_geometry(m.cuda_block.global_rows(
        rstart, row + 2 * k, ext[model.pot_key].device), h)
    return {
        "kernel_us": device_us(torch, lambda: step(ext, out, rstart, 0),
                               reps=50),
        "plain_us": model.dt_per_step * device_us(
            torch, lambda: model.solve(ext, geom), reps=1),
        "ext_rows": row + 2 * k, "width": w, "own_cells": row * w,
    }


def time_small_volume(torch, m, model, base):
    """Kernel 4 on the volume: device time per launch and per outer step
    (ten launches), and of the plain substep."""
    state = clone(base)
    depth = state["u"].shape[0]
    kernel = m.cuda_volume.KERNELS[model.name]
    params = m.bodies.pack_params(model)
    pixel = m.cuda_volume.volume_probe_pixel(model, depth)
    stream = torch.cuda.current_stream().cuda_stream
    step = m.cuda_volume.make_volume_step(model, depth)
    return {
        "kernel_us": device_us(torch, lambda: kernel.launch(
            params, state, True, 1.0, None, pixel, 0, stream), reps=100),
        "step_us": device_us(torch, lambda: step(state), reps=20),
        "plain_us": device_us(torch, lambda: m.cuda_volume.plain_volume_substep(
            model, state, True), reps=1),
    }


# -- the rest of Beeler-Reuter, the ab2 bodies, kernel 6's bodies (24-30) ----


def variant_flops(model, slow: bool, volume: bool) -> int:
    """Float32 operations per cell of one BrVariantCell substep
    (br_variant_cell.cuh, counted by hand, a transcendental as one): the
    stencil 10 (a volume's z term 4 more), the Chebyshev terms 10 when the
    gates are fitted; per gate advanced (m and h; SLOW also x1, j, d, f)
    the fold's two fits and 4 (36), the unfolded fits' two fits and 7
    (39), or the direct rates' two rates and 11 (27; alpha_m's linear term
    3 more); the V-only currents (their fits 35, the shared exponential
    25, the literal forms 31); the rest of the currents 20; Euler's C and
    V 11, AB2's 22."""
    gm, cm = model.gate_mode, model.current_mode
    n = 10 + (4 if volume else 0) + (10 if gm != "direct" else 0)
    n += (6 if slow else 2) * {"fold": 36, "cheby": 39, "direct": 27}[gm]
    n += 3 if gm == "direct" else 0
    n += {"cheby": 35, "fast": 25, "plain": 31}[cm] + 20
    return n + (22 if model.cfg.ab2 else 11)


def body_flops(bodies, model, slow: bool, volume: bool) -> int:
    """Float32 operations per cell-substep of the model's cell body."""
    name = bodies.cell_body(model).name
    if name == "br":
        return substep_flops(slow, volume)
    if name.startswith("br_variant"):
        return variant_flops(model, slow, volume)
    return SMALL_FLOPS[name] + (4 if volume else 0)


def body_bytes(bodies, model, slow: bool) -> int:
    """Bytes per cell of one launch of the model's cell body: every plane
    read, the planes that the substep stores written (BR's frozen substep
    leaves the slow gates)."""
    body = bodies.cell_body(model)
    planes = 1 + len(body.planes)
    writes = planes
    if body.name.startswith("br") and not slow:
        writes = 4 + (2 if model.cfg.ab2 else 0)
    return 4 * (planes + writes)


def body_launch_bound(bodies, model, cells: int, slow: bool,
                      volume: bool):
    """(bound_ms, bound_by) of one launch of the model's body on `cells`
    cells."""
    return bound(cells * body_bytes(bodies, model, slow),
                 cells * body_flops(bodies, model, slow, volume))


def body_step_bound(bodies, model, cells: int, read_cells=None):
    """(bound_ms, bound_by) of one fused outer step (kernels 2 and 3):
    every plane of `read_cells` (default `cells`) read once, of `cells`
    written once, and the cells' operations over the schedule."""
    planes = 1 + len(bodies.cell_body(model).planes)
    read = cells if read_cells is None else read_cells
    return bound(4 * planes * (read + cells),
                 cells * sum(body_flops(bodies, model, s, False)
                             for s in model.launch_schedule))


def expected_launches(model, n_steps: int, shards: int = 1):
    """{"slow": ..., "frozen": ...} of `n_steps` outer steps on `shards`
    shards of the substep-launch kernels (1, 4 and 6)."""
    schedule = model.launch_schedule
    slow = sum(schedule)
    return {"slow": shards * n_steps * slow,
            "frozen": shards * n_steps * (len(schedule) - slow)}


def fenton_seeded(torch, m, model, shape, dev, rng):
    """Fenton's initial state (its S1 stripe, over a volume's depth too)
    with u raised by U(0, 0.02) and v, w scaled by U(0.98, 1) per cell,
    its derivative planes bootstrapped, then 20 plain outer steps on
    the card, so that a wavefront has left the stripe.  Not a state drawn
    over [0, 1]: there some cells sit within the kernel's and the plain
    path's rounding of the thresholds (u = 0.23 switches v's rate), and
    with AB2's larger rounding a 2048x2048 state flips one of them."""
    init = model.initial_state()
    init = {k: np.ascontiguousarray(np.broadcast_to(v, shape), np.float32)
            for k, v in init.items() if not k.startswith("_")}
    init["u"] = init["u"] + rng.uniform(0.0, 0.02, shape).astype(np.float32)
    for k in ("v", "w"):
        init[k] = init[k] * rng.uniform(0.98, 1.0, shape).astype(np.float32)
    base = m.interop.state_from_numpy(model.bootstrap_ab2(init), dev)
    for _ in range(20):
        if len(shape) == 2:
            m.cuda_step.plain_step(model, base)
        else:
            m.cuda_volume.plain_volume_step(model, base)
    torch.cuda.synchronize()
    check(bool(base["u"].isfinite().all()) and float(base["u"].max()) > 0.5,
          f"{shape} seeded Fenton state holds no wavefront")
    return base


def time_body_block(torch, m, model, full):
    """Kernel 3 on the interior row shard of a 4x1 mesh of `full`
    (ghosts K = dt_per_step each side): device time per outer step, and of
    the plain block step, its substeps timed one by one and summed."""
    k = model.dt_per_step
    h, w = model.state_shape()
    row = h // N_SHARDS
    rstart = row - k
    ext = wrapped_window(full, (rstart, 0), (row + 2 * k, w))
    out = {kk: torch.zeros_like(v) for kk, v in ext.items()}
    step = m.cuda_block.make_block_step(model, False)
    geom = m.cuda_block.block_geometry(m.cuda_block.global_rows(
        rstart, row + 2 * k, ext[model.pot_key].device), h)
    schedule = model.launch_schedule
    plain = {slow: device_us(torch, lambda: model.commit(
        ext, geom, slow), reps=1) for slow in set(schedule)}
    return {
        "kernel_us": device_us(torch, lambda: step(ext, out, rstart, 0),
                               reps=50),
        "plain_us": sum(plain[slow] for slow in schedule),
        "ext_cells": (row + 2 * k) * w, "own_cells": row * w,
    }


def time_body_volume(torch, m, model, base):
    """Kernel 4: device time per launch of each of the body's forms on the
    volume, and of the plain substeps."""
    state = clone(base)
    depth = state[model.pot_key].shape[0]
    kernel = m.cuda_volume.KERNELS[m.bodies.cell_body(model).name]
    params = m.bodies.pack_params(model)
    pixel = m.cuda_volume.volume_probe_pixel(model, depth)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for slow in set(model.launch_schedule):
        out[slow] = {
            "kernel_us": device_us(torch, lambda: kernel.launch(
                params, state, slow, 1.0, None, pixel, 0, stream), reps=100),
            "plain_us": device_us(
                torch, lambda: m.cuda_volume.plain_volume_substep(
                    model, state, slow), reps=1)}
    return out


def time_body_volume_block(torch, m, model, full, d_own, z0):
    """Kernel 6 on one shard's z-block of `full` (d_own slices at z0 and
    dt_per_step ghosts each side): device time of each of the body's forms
    launched on all the block's inner slices, and of the plain substeps on
    the block; `slices` is the launch's slice count."""
    k = model.dt_per_step
    pot = model.pot_key
    depth = full[pot].shape[0]
    ext_d = d_own + 2 * k
    zstart = z0 - k
    ext = wrapped_window(full, (zstart,), (ext_d,))
    spare = torch.empty_like(ext[pot])
    kernel = m.cuda_volume_block.KERNELS[m.bodies.cell_body(model).name]
    params = m.bodies.pack_params(model)
    stream = torch.cuda.current_stream().cuda_stream
    geom = m.cuda_volume_block.zblock_geometry(
        m.cuda_volume_block.global_slices(zstart, ext_d, ext[pot].device),
        depth)
    out = {"slices": ext_d - 2}
    for slow in set(model.launch_schedule):
        out[slow] = {
            "kernel_us": device_us(torch, lambda: kernel.launch(
                params, ext, spare, slow, 1.0, zstart, depth, 1, ext_d - 1,
                None, (0, 0, 0), 0, stream), reps=100),
            "plain_us": device_us(torch, lambda: model.commit(
                ext, geom, slow), reps=1)}
    return out


def direct_volume_after_s2(torch, m, model, kernel_final, plain_final,
                           done):
    """Phase 28's direct-rates volume after its S2 (outer step `done` on):
    the kernel (kernel 4, one launch per substep) and the plain path
    advance the two runs' states substep by substep to VOL_STEPS.  alpha_m
    is literal, so a cell whose boundary-enforced V lands on -47.0 mV
    exactly turns m into 0/0 = NaN, in whichever run it lands; where it
    lands depends on float32 rounding, so the two runs may turn at
    different steps and cells.  Holds: both runs finite and
    within WHOLE_RUN_ATOL_MV of each other at every outer step before the
    first non-finite one of either, each run's first non-finite cells
    exactly those whose V entered that substep at -47.0, and the kernel
    launched once per substep; prints where each run turned."""
    runs = {"kernel": m.interop.state_from_numpy(kernel_final, "cuda"),
            "plain": m.interop.state_from_numpy(plain_final, "cuda")}
    advance = {"kernel": m.cuda_volume.volume_substep,
               "plain": m.cuda_volume.plain_volume_substep}
    turned = {}
    m.reset_counts()
    launched = {"slow": 0, "frozen": 0}
    for step in range(done, VOL_STEPS):
        for slow in model.launch_schedule:
            for name, st in runs.items():
                if name in turned:
                    continue
                v0 = m.enforce_boundary3d(st["V"])
                advance[name](model, st, slow)
                if name == "kernel":
                    launched["slow" if slow else "frozen"] += 1
                bad = None
                for k, v in st.items():
                    bad = ~v.isfinite() if bad is None else bad | ~v.isfinite()
                if bool(bad.any()):
                    cells = bad.nonzero().tolist()
                    at = v0 == -47.0
                    check(torch.equal(bad, at),
                          f"the {name} direct volume turned non-finite at "
                          f"{cells[:4]} (outer step {step + 1}), not where "
                          f"V was -47.0 mV: {at.nonzero().tolist()[:4]}")
                    turned[name] = (step + 1, cells)
        if turned:
            break
        dv = float((runs["kernel"]["V"] - runs["plain"]["V"]).abs().max())
        check(dv <= WHOLE_RUN_ATOL_MV,
              f"direct volume: kernel and plain V part by {dv} mV at outer "
              f"step {step + 1}")
    entry = f"{m.bodies.cell_body(model).name}_volume"
    check_launched(m.read_counts(), entry, launched,
                   "direct volume after the S2")
    print(f"  direct volume after the S2: first non-finite (outer step, "
          f"cells) {turned or 'none'} by outer step {VOL_STEPS}, each at "
          f"V = -47.0 mV exactly (alpha_m's 0/0); the same in both runs: "
          f"{len(turned) == 2 and turned['kernel'] == turned['plain']}",
          flush=True)


def run_or_none(fn, *args, **kw):
    """fn(...), or None where run_volume raised FloatingPointError (its
    result held a non-finite potential)."""
    try:
        return fn(*args, **kw)
    except FloatingPointError:
        return None


def replay_to_non_finite(m, model, events, sharded):
    """Phase 29's direct-rates volume when both the sharded and the
    unsharded run ended non-finite: both replayed one outer step per
    run_volume call; fails unless they stay bit-equal until both turn
    non-finite in the same outer step, which it returns."""
    states = {"sharded": None, "unsharded": None}
    for step in range(SHORT_VOL_STEPS):
        ev = [dataclasses.replace(e, step=0) for e in events
              if e.step == step]
        out = {name: run_or_none(
            lambda **kw: m.run_volume(model, SHARDED_DEPTH, 1,
                                      state=states[name], events=ev, **kw)[0],
            **(sharded if name == "sharded" else {"device": "cuda"}))
            for name in states}
        if out["sharded"] is None or out["unsharded"] is None:
            check(out["sharded"] is None and out["unsharded"] is None,
                  f"outer step {step + 1}: one of the replayed runs turned "
                  f"non-finite, the other did not")
            return step + 1
        check(all(np.array_equal(out["sharded"][k], out["unsharded"][k])
                  for k in out["unsharded"]),
              f"the replayed sharded and unsharded volumes part at outer "
              f"step {step + 1}")
        states = out
    fail("the replayed runs stayed finite where the whole ones did not")


def variant_phases(torch, m, card, rng):
    """Phases 24-30: the rest of Beeler-Reuter (BrVariantCell<false>), the
    ab2 bodies (BrVariantCell<true>, FentonAb2Cell) on kernels 1-4 and 6,
    and kernel 6 for Fenton and Mitchell-Schaeffer.  `m` carries the
    port's modules and main()'s launch counters; returns the new pairs'
    entries of the JSON line."""
    dev = torch.device("cuda")
    k1, k2, k3, k4, k6 = (m.cuda_step, m.cuda_tiled, m.cuda_block,
                          m.cuda_volume, m.cuda_volume_block)
    bodies = m.bodies
    BR, FEN, MS = m.BeelerReuter, m.Fenton4v, m.MitchellSchaeffer
    body_of = lambda model: bodies.cell_body(model).name
    errs, launches = {}, {}

    def seeded(model):
        return seeded_state(torch, m.interop, model, dev, k1.plain_step, rng)

    def seeded_vol(model, depth):
        return seeded_volume(torch, m.interop, m.volume, k4, model, depth,
                             dev, rng)

    def note(body, kind, err):
        errs[(body, kind)] = max(errs.get((body, kind), 0.0), err)

    # -- phase 24 ---------------------------------------------------------------
    print("phase 24: the new (kernel, body) pairs vs plain PyTorch, 2 outer "
          "steps (2 groups on kernel 6) from seeded states, exact launches",
          flush=True)
    cases = [(name, BR, dict(CFG, **flags),
              dict(VOL_CFG, **flags, **({"dt": BR_AB2_VOL["dt"]}
                                        if flags.get("ab2") else {})))
             for name, flags in VARIANT_CHECKS.items()]
    cases.append(("fenton-ab2", FEN, FENTON_AB2, FENTON_AB2_VOL))
    for name, cls, flat, vol in cases:
        model = cls(m.SimConfig(**flat))
        body = body_of(model)
        windows = model.ill_conditioned
        if cls is BR:
            state, vstate = seeded, seeded_vol
        else:
            state = lambda mod: fenton_seeded(torch, m, mod,
                                              mod.state_shape(), dev, rng)
            vstate = lambda mod, d: fenton_seeded(
                torch, m, mod, (d,) + mod.state_shape(), dev, rng)
        ragged = model.cfg.replace(height=67, width=131)
        for mod, label in ((model, "512x512"), (cls(ragged), "67x131")):
            m.reset_counts()
            note(body, "substep", check_outer_steps(
                torch, k1.make_cuda_step(mod),
                lambda st, p, i, mod=mod: k1.plain_step(mod, st, p, i),
                state(mod), 2, f"{body}_substep {name} {label}",
                has_probe=mod.probe_pixel[0] < mod.state_shape()[0],
                windows=windows))
            check_launched(m.read_counts(), f"{body}_substep",
                           expected_launches(mod, 2), f"{name} {label}")
        large = cls(model.cfg.replace(width=2048, height=2048))
        base_large = state(large)
        for mod, base, label in ((large, base_large, "2048x2048"),
                                 (cls(ragged), None, "67x131")):
            m.reset_counts()
            note(body, "tiled", check_outer_steps(
                torch, k2.make_tiled_cuda_step(mod),
                lambda st, p, i, mod=mod: k1.plain_step(mod, st, p, i),
                base if base is not None else state(mod), 2,
                f"{body}_tiled {name} {label}",
                has_probe=mod.probe_pixel[0] < mod.state_shape()[0],
                windows=windows))
            check_launched(m.read_counts(), f"{body}_tiled", 2,
                           f"{name} {label}")
        h, w = large.state_shape()
        row = h // N_SHARDS
        for label, h_own, w_own, origin in (
                ("4x1 top", row, None, (0, 0)),
                ("4x1 interior", row, None, (row, 0)),
                ("2x2 corner", h // 2, w // 2, (h // 2, w // 2))):
            m.reset_counts()
            note(body, "block", check_block(
                torch, k3, k2, large, base_large, h_own, w_own, origin, 2,
                f"{body}_block {name} {label}", windows))
            counts = m.read_counts()
            check(counts[f"{body}_block"] == 2
                  and counts[f"{body}_tiled"] == 2,
                  f"{name} {label}: launches {counts}")
        vmodel = cls(m.SimConfig(**vol))
        vdepth = SCROLL_DEPTH if cls is FEN else DEPTH
        for depth, mod, label in (
                (vdepth, vmodel, f"{vdepth}x{vmodel.cfg.height}x"
                                 f"{vmodel.cfg.width}"),
                (5, cls(vmodel.cfg.replace(height=67, width=131)),
                 "5x67x131")):
            base = vstate(mod, depth)
            for dz in (1.0, 0.5):
                m.reset_counts()
                note(body, "volume", check_outer_steps(
                    torch, k4.make_volume_step(mod, depth, dz),
                    plain_volume(k4, mod, dz), base, 2,
                    f"{body}_volume {name} {label} dz_ratio={dz}",
                    has_probe=False, windows=windows))
                check_launched(m.read_counts(), f"{body}_volume",
                               expected_launches(mod, 2),
                               f"{name} {label}")
        deep_model = cls(vmodel.cfg.replace(height=128))
        deep = vstate(deep_model, SHARDED_DEPTH)
        d_own = SHARDED_DEPTH // N_SHARDS
        for z0, label in ((0, "top"), (d_own, "interior"),
                          (SHARDED_DEPTH - d_own, "bottom")):
            m.reset_counts()
            note(body, "volume_block", check_volume_block(
                torch, k4, k6, deep_model, deep, d_own, z0, 2, 1.0, None,
                f"{body}_volume_block {name} {label}", windows))
            counts = m.read_counts()
            check(counts[f"{body}_volume_block"] == expected_launches(
                deep_model, 2), f"{name} {label}: launches {counts}")
    for name, cls, vol in (("br", BR, VOL_CFG), ("fenton", FEN, SCROLL_CFG),
                           ("ms", MS, SCROLL_CFG)):
        deep_model = cls(m.SimConfig(**dict(vol, height=128)))
        deep = (seeded_vol(deep_model, SHARDED_DEPTH) if cls is BR else
                small_state(m.interop, name, (SHARDED_DEPTH,)
                            + deep_model.state_shape(), dev, rng))
        d_own = SHARDED_DEPTH // N_SHARDS
        for z0, label in ((0, "top"), (d_own, "interior"),
                          (SHARDED_DEPTH - d_own, "bottom")):
            m.reset_counts()
            note(name, "volume_block", check_volume_block(
                torch, k4, k6, deep_model, deep, d_own, z0, 2, 1.0, None,
                f"{name}_volume_block {label}", deep_model.ill_conditioned))
            counts = m.read_counts()
            check(counts[f"{name}_volume_block"] == expected_launches(
                deep_model, 2), f"{name} {label}: launches {counts}")

    # -- phase 25 ---------------------------------------------------------------
    print(f"phase 25: Table 1 (python -m fib_tf_tpu bench) on the card: five "
          f"rows at {TABLE1_SIZE}x{TABLE1_SIZE}, {TABLE1_MS} ms, "
          f"{TABLE1_RUNS} runs each", flush=True)
    for family, flags in TABLE1_ROWS:
        cls = BR if family == "br" else FEN
        cfg = m.SimConfig(width=TABLE1_SIZE, height=TABLE1_SIZE, dt=0.1,
                          diff=0.809 if family == "br" else 1.5,
                          duration=TABLE1_MS, **flags)
        label = (f"BR cheby={flags['cheby']} skip={flags['skip']}"
                 if family == "br" else "Fenton 4v")
        sim = m.Simulation(cls(cfg), device="cuda").define()
        model = sim.model
        check(sim.route == "substep", f"{label} routes {sim.route!r}")
        entry = f"{body_of(model)}_substep"
        samples = []
        for _ in range(TABLE1_RUNS):
            m.reset_counts()
            res = sim.simulate(check_finite=False)
            counts = m.read_counts()
            check_launched(counts, entry, expected_launches(
                model, res.steps), f"Table 1 {label}")
            check_run(res, model.state_shape(),
                      TABLE1_CROSSINGS[(family,) + tuple(sorted(
                          flags.items()))])
            samples.append(res.elapsed / (TABLE1_MS / 1000.0))
        launches[(body_of(model), "substep")] = counts[entry]
        row = {"model": family, **flags,
               "value": float(np.median(samples)),
               "spread": [min(samples), max(samples)],
               "samples": len(samples), "unit": "wall-s/sim-s",
               "cell_updates_per_sec": round(res.cell_updates_per_sec),
               "card": card}
        print(json.dumps(row), flush=True)
        short = cfg.replace(duration=400)
        res = m.Simulation(cls(short), device="cuda").define().simulate()
        before = m.read_counts()
        ref = m.Simulation(cls(short.replace(kernel="xla")),
                           device="cuda").define().simulate()
        check(m.read_counts() == before,
              "the kernel='xla' run launched a kernel")
        check_against_plain_run(
            res, ref, model.pot_key,
            WHOLE_RUN_ATOL_MV if family == "br" else SMALL_ATOL)

    # -- phase 26 ---------------------------------------------------------------
    print("phase 26: Table 1's direct rows at 2048x2048 (kernel 2), and on "
          "four row shards of cuda:0 (kernel 3)", flush=True)
    mesh = m.make_mesh(devices=["cuda:0"] * N_SHARDS)
    for flags in (dict(cheby=False, skip=False), dict(cheby=False, skip=True)):
        cfg = m.SimConfig(**dict(CFG_LARGE, **flags))
        model = BR(cfg)
        body = body_of(model)
        sim = m.Simulation(model, device="cuda").define()
        check(sim.route == "tiled", f"{flags} 2048x2048 routes {sim.route!r}")
        m.reset_counts()
        res = sim.simulate()
        check_launched(m.read_counts(), f"{body}_tiled", res.steps,
                       f"direct {flags} 2048x2048")
        launches[(body, "tiled")] = res.steps
        check_run(res, model.state_shape(), DIRECT_CROSSING_2048)
        sim = m.Simulation(BR(cfg), mesh=mesh, wide_halo=True).define()
        check(sim.route == "block", f"the sharded run routes {sim.route!r}")
        m.reset_counts()
        rows = sim.simulate()
        check_launched(m.read_counts(), f"{body}_block",
                       N_SHARDS * rows.steps, f"sharded direct {flags}")
        launches[(body, "block")] = N_SHARDS * rows.steps
        check_run(rows, model.state_shape(), DIRECT_CROSSING_2048)
        check_sharded_against_unsharded(rows, res, f"4x1 direct {flags}")
        print(f"  simulate() at 2048x2048, {flags}: tiled route "
              f"{1.0 / res.sim_seconds_per_wall_second:.6f} wall-s/sim-s, "
              f"4x1 shards {1.0 / rows.sim_seconds_per_wall_second:.6f} "
              f"[{card}]", flush=True)

    # -- phase 27 ---------------------------------------------------------------
    print("phase 27: the ab2 paths on kernels 1-3: BR cheby+skip+ab2 and "
          "Fenton ab2 (dt 0.025) at 512x512 for 400 ms with an S2, against "
          "kernel='xla'; at 2048x2048 (kernel 2) and on four row shards "
          "(kernel 3), bit-equal", flush=True)
    for family, cls, flat in (("br", BR, BR_AB2),
                              ("fenton", FEN, FENTON_AB2)):
        cfg = m.SimConfig(**flat)
        s2_ms, s2_large_ms = AB2_S2_MS[family]

        def run(cfg_, s2, **kw):
            sim = m.Simulation(cls(cfg_), **kw).define()
            sim.add_pace_op("s2", "luq", sim.model.max_v)
            m.reset_counts()
            return sim, sim.simulate(
                schedule=[(s2, "s2")] if s2 is not None else [])

        sim, res = run(cfg, s2_ms, device="cuda")
        model = sim.model
        body = body_of(model)
        atol = WHOLE_RUN_ATOL_MV if family == "br" else SMALL_ATOL
        check(sim.route == "substep", f"{body} 512x512 routes {sim.route!r}")
        want = expected_launches(model, res.steps)
        check_launched(m.read_counts(), f"{body}_substep", want,
                       f"{family} ab2 512x512")
        launches[(body, "substep")] = want
        check_run(res, model.state_shape(), AB2_CROSSINGS[family])
        _, ref = run(cfg.replace(kernel="xla"), s2_ms, device="cuda")
        check(not any(total_launches(c) for c in m.read_counts().values()),
              "the kernel='xla' run launched a kernel")
        check_against_plain_run(res, ref, model.pot_key, atol)
        large_cfg = cfg.replace(width=2048, height=2048,
                                duration=AB2_LARGE_MS[family])
        sim, res_large = run(large_cfg, s2_large_ms, device="cuda")
        check(sim.route == "tiled", f"{body} 2048x2048 routes {sim.route!r}")
        check_launched(m.read_counts(), f"{body}_tiled", res_large.steps,
                       f"{family} ab2 2048x2048")
        launches[(body, "tiled")] = res_large.steps
        check_run(res_large, sim.model.state_shape(),
                  AB2_CROSSINGS[f"{family}_2048"])
        sim, rows = run(large_cfg, s2_large_ms, mesh=mesh, wide_halo=True)
        check(sim.route == "block", f"the sharded run routes {sim.route!r}")
        check_launched(m.read_counts(), f"{body}_block",
                       N_SHARDS * rows.steps, f"sharded {family} ab2")
        launches[(body, "block")] = N_SHARDS * rows.steps
        check_sharded_against_unsharded(rows, res_large, f"4x1 {family} ab2",
                                        model.pot_key, atol)
        print(f"  {family} ab2: 512x512 "
              f"{1.0 / res.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
              f"(kernel='xla' {1.0 / ref.sim_seconds_per_wall_second:.6f}),"
              f" 2048x2048 tiled "
              f"{1.0 / res_large.sim_seconds_per_wall_second:.6f}, 4x1 "
              f"shards {1.0 / rows.sim_seconds_per_wall_second:.6f} "
              f"[{card}]", flush=True)

    # -- phase 28 ---------------------------------------------------------------
    print(f"phase 28: run_volume on kernel 4: BR direct (Table 1's skip row) "
          f"and BR cheby+skip+ab2 (dt 0.05) at {DEPTH}x{VOL_CFG['height']}x"
          f"{VOL_CFG['width']} with phase 9's S2, against kernel='xla'; "
          f"Fenton ab2 at {SCROLL_DEPTH}x512x512 for {MS_SHORT_STEPS} outer "
          f"steps", flush=True)
    vshape = (DEPTH, VOL_CFG["height"], VOL_CFG["width"])
    s2 = [m.VolumeEvent(step=S2_STEP, loc="luq", z1=DEPTH // 2)]
    for vol, crossing in (
            (dict(VOL_CFG, cheby=False, skip=True),
             TABLE1_CROSSINGS[("br", ("cheby", False), ("skip", True))]),
            (BR_AB2_VOL, AB2_CROSSINGS["br_volume"])):
        vmodel = BR(m.SimConfig(**vol))
        body = body_of(vmodel)
        direct = vmodel.gate_mode == "direct"
        # the direct rates: up to the S2's step with run_volume, then
        # substep by substep (direct_volume_after_s2)
        n_outer = S2_STEP + 1 if direct else VOL_STEPS
        m.run_volume(vmodel, DEPTH, 2, device="cuda")
        m.reset_counts()
        vrun = run_volume_timed(m.run_volume, vmodel, DEPTH, s2,
                                n_outer=n_outer)
        want = expected_launches(vmodel, n_outer)
        check_launched(m.read_counts(), f"{body}_volume", want,
                       f"{body} volume")
        launches[(body, "volume")] = want
        crossings = check_volume_run(m.CycleLengthDetector, vmodel, vrun,
                                     vshape, crossing, n_outer)
        vref = run_volume_timed(m.run_volume, vmodel, DEPTH, s2,
                                kernel="xla", n_outer=n_outer)
        check_against_plain_volume(m.CycleLengthDetector, vmodel, vrun, vref,
                                   crossings)
        if direct:
            direct_volume_after_s2(torch, m, vmodel, vrun["final"],
                                   vref["final"], n_outer)
    fvol = FEN(m.SimConfig(**FENTON_AB2_VOL))
    fevents = [m.VolumeEvent(step=SCROLL_S2, loc="luq", z1=SCROLL_DEPTH // 2)]
    m.reset_counts()
    vrun = run_volume_timed(m.run_volume, fvol, SCROLL_DEPTH, fevents,
                            n_outer=MS_SHORT_STEPS)
    check_launched(m.read_counts(), "fenton_ab2_volume",
                   expected_launches(fvol, MS_SHORT_STEPS),
                   "Fenton ab2 volume")
    launches[("fenton_ab2", "volume")] = expected_launches(
        fvol, MS_SHORT_STEPS)
    vref = run_volume_timed(m.run_volume, fvol, SCROLL_DEPTH, fevents,
                            kernel="xla", n_outer=MS_SHORT_STEPS)
    check_small_volume(m, fvol, vrun, vref, None)

    # -- phase 29 ---------------------------------------------------------------
    print(f"phase 29: {SHARDED_DEPTH}x128x512 on four z shards of cuda:0 "
          f"(kernel 6) for BR direct, BR ab2, Fenton, Fenton ab2 and "
          f"Mitchell-Schaeffer, bit-equal to their unsharded runs (kernel 4)",
          flush=True)
    for cls, vol in ((BR, dict(VOL_CFG, cheby=False, skip=True)),
                     (BR, BR_AB2_VOL),
                     (FEN, SCROLL_CFG), (FEN, FENTON_AB2_VOL),
                     (MS, SCROLL_CFG)):
        vmodel = cls(m.SimConfig(**dict(vol, height=128)))
        body = body_of(vmodel)
        ev = [m.VolumeEvent(step=SHORT_VOL_STEPS // 2, loc="luq",
                            z1=SHARDED_DEPTH // 2)]
        # eight slices a shard: the ten-substep models exchange five ghost
        # slices per group of five substeps
        sharded = dict(wide_halo=True, halo_k=None if cls is BR else 5,
                       mesh=m.make_mesh(devices=["cuda:0"] * N_SHARDS))
        m.reset_counts()
        srun = run_or_none(run_volume_timed, m.run_volume, vmodel,
                           SHARDED_DEPTH, ev, n_outer=SHORT_VOL_STEPS,
                           **sharded)
        want = expected_launches(vmodel, SHORT_VOL_STEPS, N_SHARDS)
        check_launched(m.read_counts(), f"{body}_volume_block", want,
                       f"sharded {body} volume")
        launches[(body, "volume_block")] = want
        uns = run_or_none(run_volume_timed, m.run_volume, vmodel,
                          SHARDED_DEPTH, ev, n_outer=SHORT_VOL_STEPS)
        if srun is None or uns is None:
            check(vmodel.name == "br" and vmodel.gate_mode == "direct"
                  and srun is None and uns is None,
                  f"{body}: one of the sharded and unsharded volumes turned "
                  f"non-finite, the other did not")
            step = replay_to_non_finite(m, vmodel, ev, sharded)
            print(f"  {body}: sharded and unsharded both turned non-finite "
                  f"in outer step {step} (alpha_m's 0/0, see phase 28), "
                  f"bit-equal at every step before", flush=True)
            continue
        same = all(np.array_equal(srun["final"][k], uns["final"][k])
                   for k in uns["final"])
        print(f"  {body}: sharded vs unsharded, all {len(uns['final'])} "
              f"planes bit-equal: {same}; probes bit-equal: "
              f"{np.array_equal(srun['probes'], uns['probes'])}; wall "
              f"{srun['wall_s']:.3f} / {uns['wall_s']:.3f} s", flush=True)
        check(same and np.array_equal(srun["probes"], uns["probes"])
              and all(np.isfinite(v).all() for v in uns["final"].values()),
              f"the sharded {body} volume is not bit-equal to the unsharded "
              f"one")

    # -- phase 30 ---------------------------------------------------------------
    print(f"phase 30: device times and bounds of the new pairs [{card}]",
          flush=True)
    entries = []
    timed = (
        ("br_variant", BR, dict(CFG, cheby=False, skip=True),
         dict(VOL_CFG, cheby=False, skip=True)),
        ("br_variant_ab2", BR, BR_AB2, BR_AB2_VOL),
        ("fenton_ab2", FEN, FENTON_AB2, FENTON_AB2_VOL))
    for body, cls, flat, vol in timed:
        model = cls(m.SimConfig(**flat))
        large = cls(model.cfg.replace(width=2048, height=2048))
        if cls is BR:
            base, base_large = seeded(model), seeded(large)
        else:
            base = fenton_seeded(torch, m, model, model.state_shape(), dev,
                                 rng)
            base_large = fenton_seeded(torch, m, large, large.state_shape(),
                                       dev, rng)
        vmodel = cls(m.SimConfig(**vol))
        vdepth = SCROLL_DEPTH if cls is FEN else DEPTH
        vbase = (seeded_vol(vmodel, vdepth) if cls is BR else
                 fenton_seeded(torch, m, vmodel,
                               (vdepth,) + vmodel.state_shape(), dev, rng))
        deep_model = cls(vmodel.cfg.replace(height=128))
        deep = (seeded_vol(deep_model, SHARDED_DEPTH) if cls is BR else
                fenton_seeded(torch, m, deep_model, (SHARDED_DEPTH,)
                              + deep_model.state_shape(), dev, rng))
        t1 = time_kernels(torch, model, base, k1, bodies)
        t2 = time_tiled(torch, k1, k2, large, base_large, model,
                        base)["2048x2048"]
        t3 = time_body_block(torch, m, large, base_large)
        t4 = time_body_volume(torch, m, vmodel, vbase)
        d_own = SHARDED_DEPTH // N_SHARDS
        t6 = time_body_volume_block(torch, m, deep_model, deep, d_own, d_own)
        cells = int(np.prod(model.state_shape()))
        vcells = vdepth * int(np.prod(vmodel.state_shape()))
        bcells = t6["slices"] * int(np.prod(deep_model.state_shape()))
        for slow in sorted(set(model.launch_schedule), reverse=True):
            form = "slow" if slow else "frozen"
            suffix = (f"<SLOW={str(slow).lower()}>" if cls is BR else "")
            entries.append(kernel_entry(
                f"{body}_substep{suffix}",
                "fib_tf_tpu_torch/csrc/br_substep.cu",
                "fib_tf_tpu/ops/pallas_step.py:205",
                launches[(body, "substep")][form], errs[(body, "substep")],
                t1[form]["kernel_us"], t1[form]["plain_us"],
                body_launch_bound(bodies, model, cells, slow, False)))
            entries.append(kernel_entry(
                f"{body}_volume{suffix}", "fib_tf_tpu_torch/csrc/br_volume.cu",
                "fib_tf_tpu/ops/pallas_volume.py:499",
                launches[(body, "volume")][form], errs[(body, "volume")],
                t4[slow]["kernel_us"], t4[slow]["plain_us"],
                body_launch_bound(bodies, vmodel, vcells, slow, True)))
            entries.append(kernel_entry(
                f"{body}_volume_block{suffix}",
                "fib_tf_tpu_torch/csrc/br_volume_block.cu",
                "fib_tf_tpu/ops/pallas_volume.py:397",
                launches[(body, "volume_block")][form],
                errs[(body, "volume_block")], t6[slow]["kernel_us"],
                t6[slow]["plain_us"],
                body_launch_bound(bodies, deep_model, bcells, slow, True)))
        entries.append(kernel_entry(
            f"{body}_tiled", "fib_tf_tpu_torch/csrc/br_tiled.cu",
            "fib_tf_tpu/ops/pallas_tiled.py:342", launches[(body, "tiled")],
            errs[(body, "tiled")], t2["tiled_us"], t2["plain_us"],
            body_step_bound(bodies, large, int(np.prod(large.state_shape())))))
        entries.append(kernel_entry(
            f"{body}_block", "fib_tf_tpu_torch/csrc/br_block.cu",
            "fib_tf_tpu/ops/pallas_tiled.py:202", launches[(body, "block")],
            errs[(body, "block")], t3["kernel_us"], t3["plain_us"],
            body_step_bound(bodies, large, t3["own_cells"], t3["ext_cells"])))
        print(f"  {body}: substep {t1['slow']['kernel_us']:.3f} us/SLOW "
              f"launch at 512x512 (plain {t1['slow']['plain_us']:.1f}), outer "
              f"step device {t1['step_device_us']:.2f} us, host-paced "
              f"{t1['step_wall_us']:.2f} us; tiled {t2['tiled_us']:.2f} "
              f"us/outer step at 2048x2048 against {t2['substep_us']:.2f} "
              f"on the substep route; block {t3['kernel_us']:.2f} us on the "
              f"{t3['ext_cells'] // 2048}x2048 block; volume "
              f"{t4[True]['kernel_us']:.3f} us/SLOW launch; volume block "
              f"{t6[True]['kernel_us']:.3f} us/SLOW launch on "
              f"{t6['slices']} slices [{card}]", flush=True)
    for name, cls, vol in (("fenton", FEN, SCROLL_CFG),
                           ("ms", MS, SCROLL_CFG)):
        deep_model = cls(m.SimConfig(**dict(vol, height=128)))
        deep = small_state(m.interop, name, (SHARDED_DEPTH,)
                           + deep_model.state_shape(), dev, rng)
        d_own = SHARDED_DEPTH // N_SHARDS
        t6 = time_body_volume_block(torch, m, deep_model, deep, d_own, d_own)
        bcells = t6["slices"] * int(np.prod(deep_model.state_shape()))
        entries.append(kernel_entry(
            f"{name}_volume_block", "fib_tf_tpu_torch/csrc/br_volume_block.cu",
            "fib_tf_tpu/ops/pallas_volume.py:397",
            launches[(name, "volume_block")]["slow"],
            errs[(name, "volume_block")], t6[True]["kernel_us"],
            t6[True]["plain_us"],
            body_launch_bound(bodies, deep_model, bcells, True, True)))
    return entries


# The 2D geometry (phases 31-37): a phase field, a relative diffusion map
# and a fiber tensor on kernels 1-3 (their GEOM entries) for every body.
# Geometries of the kernel checks: (a) examples/br_spiral.py's hole
# (scaled to the grid) plus a neg=True rim, so that phi is not 1 at the
# border; (b) (a) plus fibrosis_map(density=0.25, strength=0.8, seed=0);
# (c) (b) plus fibers at 30 degrees, ratio 0.25
GEOM_KINDS = ("a", "b", "c")
FIBER_DEG, FIBER_RATIO = 30.0, 0.25
# the body each GEOM check runs, by entry prefix: BR's main path, Table 1's
# direct row with skip, BR cheby + skip + ab2, Fenton's Table 1 row, Fenton
# ab2 at dt 0.025, Mitchell-Schaeffer
GEOM_BODIES = {"br": ("br", CFG),
               "br_variant": ("br", dict(CFG, cheby=False, skip=True)),
               "br_variant_ab2": ("br", BR_AB2),
               "fenton": ("fenton", SMALL_CFG),
               "fenton_ab2": ("fenton", FENTON_AB2),
               "ms": ("ms", SMALL_CFG)}
# the full-width runs: examples/br_spiral.py (hole at (150, 200), r 40, S2
# luq 10.0 at 300 ms) and examples/fenton_spiral.py (hole at (256, 256), r
# 30, S2 luq 1.0 at 210 ms) at 512x512 for 400 ms, and the JAX engine's
# first crossings of the same runs, pinned on the CPU:
#   SimConfig(**CFG, kernel='xla') -> Simulation(BeelerReuter(cfg));
#   add_hole_to_phase_field(150, 200, 40); define(); add_pace_op('s2',
#   'luq', 10.0); simulate(schedule=[(300.0, 's2')]).cycle_lengths
# gives [(332, 166.0)]; Fenton's (SMALL_CFG, hole (256, 256, 30), S2 1.0
# at 210 ms) [(76, 76.0), (211, 135.0), (339, 128.0)]
BR_HOLE, BR_HOLE_S2 = (150, 200, 40), 300.0
FENTON_HOLE, FENTON_HOLE_S2 = (256, 256, 30), 210.0
GEOM_CROSSINGS = {"br": 332, "fenton": 76}
# examples/fiber_anisotropy.py at --size 512 --angle 30 --ratio 0.25
# (Fenton, 20 ms, a 4x4 stimulus at the centre, no S1): the wavefront's
# extents (u > 0.2) through the centre along x and y, from the JAX engine
# on the CPU: x 107, y 75 cells (long/short 1.4267); the card's may
# differ by a cell where u passes 0.2 within rounding
FIBER_EXTENTS, FIBER_SLACK = (107, 75), 1
# the 2048x2048 BR runs: br_spiral's hole scaled by 4 with (b)'s fibrosis,
# 700 ms, unsharded (kernel 2), on 4x1 shards (kernel 3); and with (c)'s
# fibers unsharded and on 2x2 shards
HOLE_2048 = (600, 800, 160)
# the short runs that put every body on every GEOM route (phase 36)
GEOM_ROUTE_STEPS = 10


def geometry_maps(bodies, stencil, kind, shape):
    """bodies.GeometryMaps of geometry `kind` on a grid of `shape`."""
    h, w = shape
    phase = stencil.add_hole_to_phase_field(
        None, h, w, w * 150 // 512, h * 200 // 512, max(w * 40 // 512, 4))
    phase = stencil.add_hole_to_phase_field(phase, h, w, w / 2, h / 2,
                                            min(h, w) / 2 + 10, neg=True)
    dmap = (stencil.fibrosis_map(h, w, density=0.25, strength=0.8, seed=0)
            if kind in "bc" else None)
    fiber = (stencil.fiber_tensor(np.deg2rad(FIBER_DEG), FIBER_RATIO)
             if kind == "c" else None)
    return bodies.GeometryMaps(shape, phase, fiber, dmap)


def geometry_flops(maps) -> int:
    """Float32 operations per cell-substep the geometry adds to the 9-point
    stencil (geometry.cuh, counted by hand): the phase correction 10 (two
    differences of q, two of V, the flux 3, 4 phi, the division, the sum),
    a diffusion map 5 more (d L and the four products q = d phi), the
    fiber tensor 7 more in the operator (17 against laplace9's 10) and 6
    in the flux."""
    n = 0
    if maps.phase is not None or maps.dmap is not None:
        n += 10 + (5 if maps.dmap is not None else 0)
        n += 6 if maps.fiber is not None else 0
    return n + (7 if maps.fiber is not None else 0)


def geometry_bytes(maps) -> int:
    """Bytes per cell a launch reads of the maps: each once."""
    return 4 * ((maps.phase is not None) + (maps.dmap is not None))


def float64_run(torch, m, model, hole, s2_ms, stim, n_steps):
    """The final potential of a hole run (Simulation with
    `add_hole_to_phase_field(*hole)` and a luq S2 of `stim` at `s2_ms`) on
    the plain path in float64, `n_steps` outer steps, the S2 fired where
    simulate() fires it."""
    dev = torch.device("cuda")
    h, w = model.state_shape()
    maps = m.bodies.GeometryMaps(
        (h, w), m.stencil.add_hole_to_phase_field(None, h, w, *hole))
    geom = maps.plain(dev)
    state = {k: torch.tensor(v, dtype=torch.float64, device=dev)
             for k, v in model.initial_state().items()}
    mask = torch.tensor(m.stencil.pace_mask(h, w, "luq", stim, model.min_v),
                        dtype=torch.float64, device=dev)
    fire = min(model.cfg.millisecond_to_step(s2_ms, model.dt_per_step) + 1,
               n_steps)
    for i in range(n_steps):
        m.cuda_step.plain_step(model, state, geom=geom)
        if i + 1 == fire:
            key = model.pot_key
            state[key] = torch.maximum(state[key], mask)
    return state[model.pot_key].cpu().numpy()


def geometry_phases(torch, m, card, rng):
    """Phases 31-37: the 2D geometry on kernels 1-3 (the GEOM entries) for
    all six bodies.  `m` carries the port's modules and main()'s launch
    counters; returns the GEOM entries of the JSON line."""
    dev = torch.device("cuda")
    k1, k2, k3, st_ = m.cuda_step, m.cuda_tiled, m.cuda_block, m.stencil
    bodies = m.bodies
    classes = {"br": m.BeelerReuter, "fenton": m.Fenton4v,
               "ms": m.MitchellSchaeffer}
    errs, launches = {}, {}

    def model_of(body, **kw):
        family, flat = GEOM_BODIES[body]
        return classes[family](m.SimConfig(**dict(flat, **kw)))

    def seeded(body, model):
        shape = model.state_shape()
        if body.startswith("br"):
            return seeded_state(torch, m.interop, model, dev, k1.plain_step,
                                rng)
        if body.startswith("fenton"):
            return fenton_seeded(torch, m, model, shape, dev, rng)
        return small_state(m.interop, "ms", shape, dev, rng)

    def note(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    def count(entry, counts):
        c = counts[entry]
        if isinstance(c, dict):
            old = launches.setdefault(entry, {"slow": 0, "frozen": 0})
            for kk in c:
                old[kk] += c[kk]
        else:
            launches[entry] = launches.get(entry, 0) + c

    t0 = time.perf_counter()

    def stamp(phase):
        print(f"  ({phase} starts {time.perf_counter() - t0:.1f} s into "
              f"phases 31-37)", flush=True)

    # -- phase 31 ---------------------------------------------------------------
    print("phase 31: every GEOM (kernel, body) pair vs plain PyTorch under "
          "geometries (a), (b), (c), one launch and 2 outer steps", flush=True)
    for body in GEOM_BODIES:
        cases = {
            "k1": [model_of(body), model_of(body, height=67, width=131)],
            "k2": [model_of(body, height=2048, width=2048),
                   model_of(body, height=67, width=131),
                   model_of(body, height=2047, width=2047)]}
        bases = {}
        for kernel, models in cases.items():
            for model in models:
                shape = model.state_shape()
                if shape not in bases:
                    bases[shape] = seeded(body, model)
                base = bases[shape]
                label = "x".join(map(str, shape))
                windows = model.ill_conditioned
                has_probe = model.probe_pixel[0] < shape[0]
                # the 2047x2047 grid (tiles of two sizes) under (c) alone
                for kind in (("c",) if shape == (2047, 2047)
                             else GEOM_KINDS):
                    maps = geometry_maps(bodies, st_, kind, shape)
                    geom = maps.plain(dev)
                    ref = (lambda s, p, i, model=model, geom=geom:
                           k1.plain_step(model, s, p, i, geom))
                    m.reset_counts()
                    if kernel == "k1":
                        name = f"{body}_substep_geom {label} ({kind})"
                        step = k1.make_cuda_step(model, maps.phase,
                                                 maps.fiber, maps.dmap)
                        pk = torch.zeros(1, device=dev) if has_probe else None
                        pp = torch.zeros(1, device=dev) if has_probe else None
                        got = k1.substep(model, clone(base), True, pk, 0,
                                         maps=maps)
                        want = k1.plain_substep(model, clone(base), True, pp,
                                                0, geom)
                        torch.cuda.synchronize()

                        def exact(model=model, base=base, geom=geom):
                            ex = {kk: v.double() for kk, v in base.items()}
                            return (k1.plain_substep(model, ex, True,
                                                     geom=geom), base)

                        note(("k1", body), compare(
                            f"{name}, one launch", got, want, exact,
                            windows))
                        if has_probe:
                            compare_probes(name, pk, pp)
                        note(("k1", body), check_outer_steps(
                            torch, step, ref, base, 2, name,
                            has_probe=has_probe, windows=windows))
                        entry = f"{body}_substep_geom"
                        want_n = expected_launches(model, 2)
                        want_n["slow"] += 1
                    else:
                        name = f"{body}_tiled_geom {label} ({kind})"
                        step = k2.make_tiled_cuda_step(model, maps.phase,
                                                       maps.fiber, maps.dmap)
                        steps = (1, 2) if shape == (2048, 2048) else (2,)
                        for n in steps:
                            note(("k2", body), check_outer_steps(
                                torch, step, ref, base, n, name,
                                has_probe=has_probe, windows=windows))
                        entry, want_n = f"{body}_tiled_geom", sum(steps)
                    check_launched(m.read_counts(), entry, want_n, name)
        # kernel 3: the 4x1 top and interior shards and a 2x2 corner shard
        # of 2048x2048, 2 outer steps each
        full_model = cases["k2"][0]
        full = bases[(2048, 2048)]
        for kind in GEOM_KINDS:
            maps = geometry_maps(bodies, st_, kind, (2048, 2048))
            m.reset_counts()
            for h_own, w_own, origin in ((512, None, (0, 0)),
                                         (512, None, (512, 0)),
                                         (1024, 1024, (0, 1024))):
                note(("k3", body), check_block(
                    torch, k3, k2, full_model, full, h_own, w_own, origin, 2,
                    f"{body}_block_geom ({kind}) at {origin}",
                    full_model.ill_conditioned, maps))
            counts = m.read_counts()
            check(counts[f"{body}_block_geom"] == 6
                  and counts[f"{body}_tiled_geom"] == 6,
                  f"{body} ({kind}): kernel 3's checks launched "
                  f"{counts[f'{body}_block_geom']} block and "
                  f"{counts[f'{body}_tiled_geom']} tiled GEOM launches")

    def geom_sim(model, holes=(), dmap=None, **kw):
        sim = m.Simulation(model, **kw)
        for hole in holes:
            sim.add_hole_to_phase_field(*hole)
        if dmap is not None:
            sim.set_diffusion_map(dmap)
        return sim

    stamp('phase 32')
    # -- phase 32 ---------------------------------------------------------------
    print("phase 32: examples/br_spiral.py at 512x512 for 400 ms (hole at "
          "(150, 200), r 40, S2 at 300 ms) on kernel 1's GEOM entry",
          flush=True)
    hole_runs = {}
    for family, model, hole, s2, key, atol, stim in (
            ("br", model_of("br"), BR_HOLE, BR_HOLE_S2, "V",
             WHOLE_RUN_ATOL_MV, 10.0),
            ("fenton", model_of("fenton"), FENTON_HOLE, FENTON_HOLE_S2, "u",
             SMALL_ATOL, 1.0)):
        if family == "fenton":
            print("phase 33: examples/fenton_spiral.py at 512x512 for 400 ms "
                  "(hole at (256, 256), r 30, S2 at 210 ms) on kernel 1's "
                  "GEOM entry", flush=True)
        runs = {}
        for kernel in ("auto", "xla"):
            mod = type(model)(model.cfg.replace(kernel=kernel))
            sim = geom_sim(mod, [hole], device="cuda").define()
            sim.add_pace_op("s2", "luq", stim)
            check(sim.route == ("substep" if kernel == "auto" else "plain"),
                  f"{family} hole run routes {sim.route!r}")
            m.reset_counts()
            runs[kernel] = res = sim.simulate(schedule=[(s2, "s2")])
            counts = m.read_counts()
            if kernel == "xla":
                check(all(total_launches(c) == 0 for c in counts.values()),
                      f"the kernel='xla' {family} run launched a kernel")
                continue
            entry = f"{family}_substep_geom"
            check_launched(counts, entry,
                           expected_launches(mod, res.steps),
                           f"the {family} 512x512 hole run")
            count(entry, counts)
            print(f"  {family}: route {sim.route}, steps {res.steps}, "
                  f"launches {counts[entry]}, cycle_lengths "
                  f"{res.cycle_lengths}, probe scale "
                  f"{sim._probe_scale():.6f}", flush=True)
            check_run(res, model.state_shape(), GEOM_CROSSINGS[family])
        check_against_plain_run(
            runs["auto"], runs["xla"], key=key, atol=atol,
            exact=lambda mod=mod, hole=hole, s2=s2, stim=stim: float64_run(
                torch, m, mod, hole, s2, stim, runs["xla"].steps))
        hole_runs[family] = runs["auto"]

    stamp('phase 34')
    # -- phase 34 ---------------------------------------------------------------
    print("phase 34: examples/fiber_anisotropy.py at 512x512 (Fenton, 30 "
          "degrees, ratio 0.25, 20 ms, a point stimulus)", flush=True)
    fcfg = model_of("fenton").cfg.replace(
        duration=20.0, fiber_angle=np.deg2rad(FIBER_DEG),
        fiber_ratio=FIBER_RATIO)
    extents = {}
    for kernel in ("auto", "xla"):
        sim = m.Simulation(m.Fenton4v(fcfg.replace(kernel=kernel)),
                           device="cuda").define(s1=False)
        state = sim.model.initial_state(s1=False)
        c = fcfg.width // 2
        state["u"][c - 2:c + 2, c - 2:c + 2] = 1.0
        m.reset_counts()
        res = sim.simulate(state=state)
        counts = m.read_counts()
        if kernel == "auto":
            check_launched(counts, "fenton_substep_geom",
                           expected_launches(sim.model, res.steps),
                           "the fiber run")
            count("fenton_substep_geom", counts)
            fiber_run = res
        u = res.state["u"]
        x, y = int((u[c, :] > 0.2).sum()), int((u[:, c] > 0.2).sum())
        extents[kernel] = (x, y)
        print(f"  kernel={kernel}: wavefront extents x {x}, y {y} cells, "
              f"long/short {max(x, y) / max(min(x, y), 1):.4f} (the JAX "
              f"engine: {FIBER_EXTENTS}, "
              f"{max(FIBER_EXTENTS) / min(FIBER_EXTENTS):.4f})", flush=True)
        check(all(abs(a - b) <= FIBER_SLACK
                  for a, b in zip((x, y), FIBER_EXTENTS)),
              f"fiber run kernel={kernel}: extents {(x, y)}, the JAX "
              f"engine's {FIBER_EXTENTS}")

    stamp('phase 35')
    # -- phase 35 ---------------------------------------------------------------
    print("phase 35: BR at 2048x2048 for 700 ms with the hole (600, 800), r "
          "160, and (b)'s fibrosis: kernel 2, then 4x1 shards (kernel 3), "
          "and with (c)'s fibers unsharded and on 2x2 shards, bit-equal",
          flush=True)
    big = model_of("br", height=2048, width=2048, duration=700)
    fib = st_.fibrosis_map(2048, 2048, density=0.25, strength=0.8, seed=0)
    big_runs = {}
    for label, cfg, mesh_shape, entry in (
            ("unsharded", big.cfg, None, "br_tiled_geom"),
            ("4x1", big.cfg, (N_SHARDS,), "br_block_geom"),
            ("unsharded fiber", big.cfg.replace(
                fiber_angle=np.deg2rad(FIBER_DEG), fiber_ratio=FIBER_RATIO),
             None, "br_tiled_geom"),
            ("2x2 fiber", big.cfg.replace(
                fiber_angle=np.deg2rad(FIBER_DEG), fiber_ratio=FIBER_RATIO),
             (2, 2), "br_block_geom")):
        kw = (dict(device="cuda") if mesh_shape is None else dict(
            mesh=m.make_mesh(shape=mesh_shape, devices=["cuda:0"] * 4),
            wide_halo=True))
        sim = geom_sim(m.BeelerReuter(cfg), [HOLE_2048], fib, **kw).define()
        check(sim.route == ("tiled" if mesh_shape is None else "block"),
              f"2048x2048 {label} routes {sim.route!r}")
        m.reset_counts()
        res = big_runs[label] = sim.simulate()
        counts = m.read_counts()
        shards = 1 if mesh_shape is None else N_SHARDS
        check_launched(counts, entry, shards * res.steps,
                       f"the 2048x2048 {label} run")
        count(entry, counts)
        check(all(np.isfinite(v).all() for v in res.state.values()),
              f"the 2048x2048 {label} run is not finite")
        print(f"  {label}: route {sim.route}, steps {res.steps}, launches "
              f"{counts[entry]}, cycle_lengths {res.cycle_lengths}, "
              f"{1.0 / res.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
              f"[{card}]", flush=True)
    check_sharded_against_unsharded(big_runs["4x1"], big_runs["unsharded"],
                                    "4x1 (geometry b)")
    check_sharded_against_unsharded(big_runs["2x2 fiber"],
                                    big_runs["unsharded fiber"],
                                    "2x2 (geometry c)")

    stamp('phase 36')
    # -- phase 36 ---------------------------------------------------------------
    print(f"phase 36: every body on every GEOM route through Simulation, "
          f"geometry (c), {GEOM_ROUTE_STEPS} outer steps: 512x512 (kernel "
          f"1), past the cutover (kernel 2) and on 4x1 and 2x2 shards of it "
          f"(kernel 3, bit-equal)", flush=True)
    for body in GEOM_BODIES:
        wide = body == "ms"    # two planes pass 32 MB at 2048x4096
        for label, shape, mesh_shape, entry in (
                ("substep", (512, 512), None, f"{body}_substep_geom"),
                ("tiled", (2048, 4096 if wide else 2048), None,
                 f"{body}_tiled_geom"),
                ("block", (2048, 4096 if wide else 2048), (N_SHARDS,),
                 f"{body}_block_geom"),
                ("block", (2048, 4096 if wide else 2048), (2, 2),
                 f"{body}_block_geom")):
            model = model_of(body, height=shape[0], width=shape[1])
            cfg = model.cfg.replace(
                duration=GEOM_ROUTE_STEPS * model.dt_per_step * model.cfg.dt,
                fiber_angle=np.deg2rad(FIBER_DEG), fiber_ratio=FIBER_RATIO)
            maps = geometry_maps(bodies, st_, "c", shape)
            kw = (dict(device="cuda") if mesh_shape is None else dict(
                mesh=m.make_mesh(shape=mesh_shape,
                                 devices=["cuda:0"] * N_SHARDS),
                wide_halo=True))
            sim = m.Simulation(type(model)(cfg), **kw)
            sim.phase = maps.phase
            sim.set_diffusion_map(maps.dmap)
            sim.define()
            check(sim.route == label, f"{body} {shape} routes {sim.route!r}")
            m.reset_counts()
            res = sim.simulate()
            counts = m.read_counts()
            want = (expected_launches(sim.model, res.steps)
                    if label == "substep" else
                    res.steps * (N_SHARDS if mesh_shape else 1))
            check_launched(counts, entry, want, f"{body} on the {label} route")
            count(entry, counts)
            check(all(np.isfinite(v).all() for v in res.state.values()),
                  f"{body} on the {label} route is not finite")
            if label == "tiled":
                tiled_run = res
            if label == "block":
                same = all(np.array_equal(res.state[k], tiled_run.state[k])
                           for k in res.state)
                check(same, f"{body}: the {mesh_shape} GEOM run is not "
                            f"bit-equal to the tiled one")
            print(f"  {body} {label} {shape} mesh {mesh_shape}: "
                  f"{counts[entry]} launches of {entry}", flush=True)

    stamp('phase 37')
    # -- phase 37 ---------------------------------------------------------------
    print(f"phase 37: GEOM kernels' device times against the isotropic "
          f"entries, the plain versions and their bounds, geometry (c) "
          f"[{card}]", flush=True)
    entries = []
    for body in GEOM_BODIES:
        model = model_of(body)
        maps = geometry_maps(bodies, st_, "c", (512, 512))
        base = seeded(body, model)
        state = clone(base)
        params = bodies.pack_params(model)
        stream = torch.cuda.current_stream().cuda_stream
        schedule = model.launch_schedule
        geom = maps.plain(dev)
        cells = 512 * 512
        for slow in sorted(set(schedule), reverse=True):
            flag = "slow" if slow else "frozen"
            us = device_us(torch, lambda: k1.GEOM_KERNELS[body].launch(
                params, state, slow, None, model.probe_pixel, 0, stream,
                maps.args(dev)), reps=200)
            iso = device_us(torch, lambda: k1.KERNELS[body].launch(
                params, state, slow, None, model.probe_pixel, 0, stream),
                reps=200)
            plain = device_us(torch, lambda: k1.plain_substep(
                model, state, slow, geom=geom), reps=2)
            b = bound(cells * (body_bytes(bodies, model, slow)
                               + geometry_bytes(maps)),
                      cells * (body_flops(bodies, model, slow, False)
                               + geometry_flops(maps)))
            print(f"  {body}_substep_geom<SLOW={str(slow).lower()}> 512x512: "
                  f"{us:.3f} us/launch (isotropic entry {iso:.3f}), plain "
                  f"{plain:.1f}, bound {b[0] * 1e3:.3f} us ({b[1]}) [{card}]",
                  flush=True)
            entries.append(kernel_entry(
                f"{body}_substep_geom<SLOW={str(slow).lower()}>",
                "fib_tf_tpu_torch/csrc/br_substep.cu",
                "fib_tf_tpu/ops/pallas_step.py:205",
                launches.get(f"{body}_substep_geom", {}).get(flag, 0),
                errs[("k1", body)], us, plain, b))
        # kernels 2 and 3 at 2048x2048 and on its interior 4x1 block
        large = model_of(body, height=2048, width=2048)
        maps = geometry_maps(bodies, st_, "c", (2048, 2048))
        full = seeded(body, large)
        state = clone(full)
        geom = maps.plain(dev)
        tiled = k2.make_tiled_cuda_step(large, maps.phase, maps.fiber,
                                        maps.dmap)
        iso_tiled = k2.make_tiled_cuda_step(large)
        us = device_us(torch, lambda: tiled(state), reps=30)
        iso = device_us(torch, lambda: iso_tiled(state), reps=30)
        # substep by substep: a plain outer step queues more launches than
        # the stream holds behind the spin kernel
        schedule = large.launch_schedule
        plain = {slow: device_us(torch, lambda: k1.plain_substep(
            large, state, slow, geom=geom), reps=1) for slow in set(schedule)}
        plain = sum(plain[slow] for slow in schedule)
        cells = 2048 * 2048
        iso_bound = body_step_bound(bodies, large, cells)
        b = bound(4 * cells * 2 * (1 + len(bodies.cell_body(large).planes))
                  + cells * geometry_bytes(maps),
                  cells * sum(body_flops(bodies, large, s, False)
                              + geometry_flops(maps)
                              for s in large.launch_schedule))
        print(f"  {body}_tiled_geom 2048x2048: {us:.2f} us/outer step "
              f"(isotropic entry {iso:.2f}), plain {plain:.1f}, bound "
              f"{b[0] * 1e3:.3f} us ({b[1]}; isotropic "
              f"{iso_bound[0] * 1e3:.3f}) "
              f"[{card}]", flush=True)
        entries.append(kernel_entry(
            f"{body}_tiled_geom", "fib_tf_tpu_torch/csrc/br_tiled.cu",
            "fib_tf_tpu/ops/pallas_tiled.py:342",
            launches.get(f"{body}_tiled_geom", 0), errs[("k2", body)], us,
            plain, b))
        k = large.dt_per_step
        row = 2048 // N_SHARDS
        rstart = row - k
        sizes = (row + 2 * k, 2048)
        ext = wrapped_window(full, (rstart, 0), sizes)
        out = {kk: torch.zeros_like(v) for kk, v in ext.items()}
        pe, de = (None if t is None else wrapped_window(
            {"m": t}, (rstart, 0), sizes)["m"] for t in maps.tensors(dev))
        bstep = k3.make_block_step(large, False, maps.fiber)
        iso_b = k3.make_block_step(large, False)
        us = device_us(torch, lambda: bstep(ext, out, rstart, 0, phase_ext=pe,
                                            dmap_ext=de), reps=50)
        iso = device_us(torch, lambda: iso_b(ext, out, rstart, 0), reps=50)
        bgeom = k3.block_geometry(
            k3.global_rows(rstart, sizes[0], dev), 2048, None, None, pe,
            maps.fiber, de)
        plain = {slow: device_us(torch, lambda: large.commit(
            ext, bgeom, slow), reps=1) for slow in set(schedule)}
        plain = sum(plain[slow] for slow in schedule)
        ext_cells, own = sizes[0] * 2048, row * 2048
        planes = 1 + len(bodies.cell_body(large).planes)
        b = bound(4 * planes * (ext_cells + own)
                  + ext_cells * geometry_bytes(maps),
                  own * sum(body_flops(bodies, large, s, False)
                            + geometry_flops(maps)
                            for s in large.launch_schedule))
        print(f"  {body}_block_geom {sizes[0]}x2048 block: {us:.2f} us/outer "
              f"step (isotropic entry {iso:.2f}), plain {plain:.1f}, bound "
              f"{b[0] * 1e3:.3f} us ({b[1]}) [{card}]", flush=True)
        entries.append(kernel_entry(
            f"{body}_block_geom", "fib_tf_tpu_torch/csrc/br_block.cu",
            "fib_tf_tpu/ops/pallas_tiled.py:202",
            launches.get(f"{body}_block_geom", 0), errs[("k3", body)], us,
            plain, b))
    for family, res in hole_runs.items():
        print(f"  {family} 512x512 hole run: "
              f"{1.0 / res.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
              f"[{card}]", flush=True)
    print(f"  fiber run 512x512: "
          f"{1.0 / fiber_run.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
          f"[{card}]", flush=True)
    for label, res in big_runs.items():
        print(f"  2048x2048 {label}: "
              f"{1.0 / res.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
              f"[{card}]", flush=True)
    stamp("the end")
    return entries


# Courtemanche and Courtemanche-ultra (phases 38-43).  The rate modes each
# entry runs (one entry per body hosts all three, a float of its parameter
# block): direct, the hybrid fits with folded gates, and without the fold
COURT_CHECKS = {"court": ("court", {}),
                "court-cheby": ("court", dict(court_cheby=True)),
                "court-unfolded": ("court", dict(court_cheby=True,
                                                 cheby_fold=False)),
                # healthy tissue, a dV cap that the upstroke meets, and a
                # factor on each of the 13 channels: every scale slot of
                # _pack_court and the kernel's clip
                "court-blocked": ("court", dict(
                    chronic=False, dv_max=2.0, g_scale=(
                        ("g_Na", 0.9), ("g_CaL", 0.7), ("g_Kr", 1.3),
                        ("g_Ks", 1.1), ("g_to", 0.6), ("g_Kur", 0.5),
                        ("g_K1", 1.2), ("g_NaK", 0.95), ("g_NaCa", 1.15),
                        ("g_pCa", 0.85), ("g_bNa", 1.05), ("g_bCa", 0.9),
                        ("g_bK", 2.0)))),
                "court_ultra": ("court_ultra", {}),
                "court_ultra-cheby": ("court_ultra", dict(court_cheby=True))}
# examples/court_run.py's first model (512x512, dt 0.1, diff 0.809, the
# annulus of a disk hole of radius n // 17 and a neg ring of n // 2 - 6, an
# S2 'luq' 10.0 at 350 ms, 1000 ms) and examples/court_ultra_run.py's
# run_small (diff 1.5, hole radius n // 50, S2 at 300 ms), and the JAX
# engine's first crossings of the same runs, pinned on the CPU:
#   SimConfig(width=512, height=512, dt=0.1, dt_per_plot=10, diff=D,
#             duration=1000.0, kernel='xla') -> Simulation(Model(cfg));
#   add_hole_to_phase_field(256, 256, r); add_hole_to_phase_field(256,
#   256, 250, neg=True); define(); add_pace_op('s2', 'luq', 10.0);
#   simulate(schedule=[(S2, 's2')]).cycle_lengths
COURT_CFG = dict(width=512, height=512, dt=0.1, dt_per_plot=10, diff=0.809,
                 duration=1000.0)
ULTRA_CFG = dict(COURT_CFG, diff=1.5)
COURT_HOLE, COURT_S2 = 512 // 17, 350.0
ULTRA_HOLE, ULTRA_S2 = 512 // 50, 300.0
COURT_RING = 512 // 2 - 6
# gives court [(148, 148.0), (628, 480.0), (864, 236.0)] and court_ultra
# [(119, 119.0), (538, 419.0), (743, 205.0), (938, 195.0)] (ultra_slow=True)
COURT_CROSSINGS = {"court": 148, "court_ultra": 119}
# the chronic-plane runs (the left half remodeled) and the volume runs
CHRONIC_MS = 400.0
COURT_VOL_STEPS = {"court": 300, "court_ultra": 100}
# whole runs: 1e-3 of the model's 150 mV range (tests/test_golden.py)
COURT_RUN_ATOL_MV = 0.15
# float32 operations per cell of each form (court_cell.cuh, counted by
# hand on the direct rates, a transcendental or a division as one; the
# fitted modes are within a tenth of it): the currents both commits need
# 99, the fast commit's own 79 and the stencil 10, the slow commit's own
# 383, ultra's us gate 23 more; a volume's z term 4
COURT_FLOPS = {"fast": 10 + 99 + 79, "slow": 99 + 383,
               "full": 10 + 99 + 79 + 383 + 23}
# the planes each form reads besides V, and writes (V included)
COURT_IO = {"fast": (15, 4), "slow": (18, 17), "full": (21, 22)}
# kernel 1's cached forms of court (court_cell.cuh kCachePlanes): the slow
# commit also writes the six planes of the cache, which a cached fast
# commit reads in place of seven; the slow commit adds, and the cached fast
# commit leaves out, the 18 operations of the six terms (E_K, E_Ca and
# I_pCa 3 each, I_to's gate prefix 4, I_Ks's 2, I_CaL's 3)
COURT_CACHE_PLANES, COURT_CACHE_FLOPS = 6, 18


def court_form(model, slow: bool) -> str:
    return ("full" if model.name == "court_ultra"
            else ("slow" if slow else "fast"))


def court_bound(model, cells: int, slow: bool, volume=False, maps=None,
                cached=False):
    """(bound_ms, bound_by) of one launch of a Courtemanche form on
    `cells` cells: V and the planes the form reads (the chronic plane
    where attached; a GEOM entry's maps where it takes the Laplacian), read
    once, the planes it commits written once, and its operations.  With
    `cached`, kernel 1's cached form: the slow commit that stores the
    cache, or a fast commit that reads it."""
    form = court_form(model, slow)
    reads, writes = COURT_IO[form]
    reads += 1 + len(model.het)
    flops = COURT_FLOPS[form]
    if cached and slow:
        writes += COURT_CACHE_PLANES
        flops += COURT_CACHE_FLOPS
    elif cached:
        reads += COURT_CACHE_PLANES - 7
        flops -= COURT_CACHE_FLOPS
    if form != "slow":
        flops += 4 if volume else 0
        if maps is not None:
            reads += geometry_bytes(maps) // 4
            flops += geometry_flops(maps)
    return bound(4 * cells * (reads + writes), cells * flops)


def court_seeded(torch, m, model, dev, rng, depth=None):
    """The initial state (S1 stripe, any chronic plane), V raised per cell
    by N(0, 1) mV, then 12 plain outer steps on the card, so that a
    wavefront has left the stripe; a volume extrudes it over `depth` with
    per-cell noise on V."""
    st = model.initial_state()
    shape = st["V"].shape
    st["V"] = st["V"] + rng.normal(0.0, 1.0, shape).astype(np.float32)
    base = m.interop.state_from_numpy(st, dev)
    for _ in range(12):
        m.cuda_step.plain_step(model, base)
    if depth is not None:
        base = {k: v[None].repeat(depth, 1, 1).contiguous()
                for k, v in base.items()}
        base["V"] += torch.randn(base["V"].shape, device=dev,
                                 generator=torch.Generator(dev).manual_seed(
                                     int(rng.integers(1 << 30))))
    torch.cuda.synchronize()
    check(bool(base["V"].isfinite().all())
          and float(base["V"].max()) > WAVEFRONT_MV,
          f"{model.name} {tuple(base['V'].shape)} seeded state holds no "
          f"wavefront")
    return base


def unequal_cells(got, want) -> int:
    """The number of cells, over every plane, where `got` and `want`
    differ at all."""
    return sum(int((got[k] != want[k]).sum()) for k in want)


def check_rounding(name, model, got, want):
    """A direct-rate Courtemanche launch rounds as the plain path does
    (court_cell.cuh): equal to it bit for bit.  The fitted modes sum their
    series in another order: their count is printed."""
    n = unequal_cells(got, want)
    print(f"    {n} cells not bit-equal to plain", flush=True)
    if model.rate_mode == "direct":
        check(n == 0, f"{name}: {n} cells differ from the plain version, "
                      f"which a direct-rate launch equals bit for bit")


def court_annulus(stencil, n, hole):
    """The phase field of examples/court_run.py's domain at n x n."""
    phase = stencil.add_hole_to_phase_field(None, n, n, n // 2, n // 2,
                                            hole)
    return stencil.add_hole_to_phase_field(phase, n, n, n // 2, n // 2,
                                           n // 2 - 6, neg=True)


def court_annulus_sim(m, cls, cfg, hole, annulus=True, **kw):
    """A defined Simulation of examples/court_run.py's domain (with its
    annulus unless `annulus` is False) and its luq S2 op; `kw` go to
    Simulation."""
    sim = m.Simulation(cls(cfg), **kw)
    if annulus:
        sim.add_hole_to_phase_field(cfg.width // 2, cfg.height // 2, hole)
        sim.add_hole_to_phase_field(cfg.width // 2, cfg.height // 2,
                                    cfg.width // 2 - 6, neg=True)
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0)
    return sim


def stream_us(torch, fn, reps: int) -> float:
    """Microseconds per call of `fn` between CUDA events on the stream,
    host gaps included: the plain Courtemanche substeps (about 350 small
    launches each) block the host when queued behind device_us's spin
    kernel, so they are timed as the stream runs them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def court_float64_run(torch, m, model, phase, s2_ms, n_steps):
    """The final V and the trend stream of a Courtemanche run (Simulation
    with `phase`, a luq S2 10.0 at `s2_ms`; either may be None) on the
    plain path in float64, the S2 fired where simulate() fires it."""
    dev = torch.device("cuda")
    h, w = model.state_shape()
    geom = m.bodies.GeometryMaps((h, w), phase).plain(dev)
    state = {k: torch.tensor(v, dtype=torch.float64, device=dev)
             for k, v in model.initial_state().items()}
    mask = torch.tensor(m.stencil.pace_mask(h, w, "luq", 10.0, model.min_v),
                        dtype=torch.float64, device=dev)
    fire = (-1 if s2_ms is None else min(
        model.cfg.millisecond_to_step(s2_ms, model.dt_per_step) + 1,
        n_steps))
    trend = []
    for i in range(n_steps):
        m.cuda_step.plain_step(model, state, geom=geom)
        if i + 1 == fire:
            state["V"] = torch.maximum(state["V"], mask)
        trend.append(model.trend_probe(state))
    return state["V"].cpu().numpy(), torch.stack(trend).cpu().numpy()


def court_arbitrate(name, res, ref, ex_v):
    """A kernel run `res` past COURT_RUN_ATOL_MV of the plain run `ref`:
    it passes when it ends no further from the float64 run's final V
    `ex_v` than `ref` does (max abs; PR 9's rule)."""
    ke = float(np.abs(res.state["V"] - ex_v).max())
    pe = float(np.abs(ref.state["V"] - ex_v).max())
    print(f"  {name}: arbitrated by the float64 plain run: the kernel run "
          f"ends {ke:.4g} from it (mean abs "
          f"{float(np.abs(res.state['V'] - ex_v).mean()):.4g}), the float32 "
          f"plain run {pe:.4g} (mean abs "
          f"{float(np.abs(ref.state['V'] - ex_v).mean()):.4g})", flush=True)
    check(ke <= pe,
          f"{name}: final V: the kernel run ends {ke} from the float64 run, "
          f"the float32 plain run {pe}")


def check_cached_form(torch, m, kernel, model, slowed, maps, geom, name,
                      windows):
    """Kernel 1's cached forms of a body with a cache (`kernel.cache`),
    after one slow commit gave `slowed`: the cache that commit stored
    against the model's `fast_invariants` of `slowed`, then one fast commit
    that reads it against `plain_cached_substep` from `slowed`, the probe
    included.  A direct-rate launch equals its plain version bit for bit.
    Returns the max abs error."""
    dev = slowed["V"].device
    k1 = m.cuda_step
    plain = model.fast_invariants(slowed)
    planes = kernel.cache.planes(slowed["V"])
    stored = {k: planes[i] for i, k in enumerate(kernel.cache.names)}
    err = compare(f"{name}, the cache it stored", stored, plain)
    check_rounding(f"{name}, the cache", model, stored, plain)
    pk = torch.zeros(1, device=dev)
    pp = torch.zeros(1, device=dev)
    got = clone(slowed)
    kernel.launch(m.bodies.pack_params(model), got, False, pk,
                  model.probe_pixel, 0,
                  torch.cuda.current_stream(dev).cuda_stream,
                  () if maps is None else maps.args(dev), True)
    want = k1.plain_cached_substep(model, clone(slowed), plain, pp, 0, geom)
    torch.cuda.synchronize()
    name = f"{name}, then a fast commit that reads the cache"

    def exact():
        ex = {k: v.double() for k, v in slowed.items()}
        return k1.plain_cached_substep(model, ex, model.fast_invariants(ex),
                                       geom=geom), slowed

    err = max(err, compare(f"{name}, one launch", got, want, exact,
                           windows))
    check_rounding(name, model, got, want)
    compare_probes(name, pk, pp)
    return err


def expected_cached(m, model, n_steps: int) -> int:
    """Fast commits that read the cache in `n_steps` outer steps of kernel
    1 (9 a step for court, 0 for a body without a cache)."""
    if not m.bodies.cell_body(model).cache:
        return 0
    return n_steps * sum(m.cuda_step.cache_schedule(model.launch_schedule))


def court_phases(torch, m, card, rng):
    """Phases 38-43: Courtemanche and Courtemanche-ultra on kernels 1
    (isotropic and GEOM) and 4.  `m` carries the port's modules and
    main()'s launch counters; returns their entries of the JSON line."""
    dev = torch.device("cuda")
    k1, k4, st_ = m.cuda_step, m.cuda_volume, m.stencil
    bodies = m.bodies
    classes = {"court": m.Courtemanche, "court_ultra": m.CourtemancheUltra}
    errs, launches, runs = {}, {}, {}
    bindings = {k.entry: k for k in (*k1.KERNELS.values(),
                                     *k1.GEOM_KERNELS.values())}
    t0 = time.perf_counter()

    def stamp(phase):
        print(f"  ({phase} starts {time.perf_counter() - t0:.1f} s into "
              f"phases 38-43)", flush=True)

    def model_of(key, **kw):
        body, flags = COURT_CHECKS[key]
        return classes[body](m.SimConfig(**dict(COURT_CFG, **flags, **kw)))

    def note(entry, err):
        errs[entry] = max(errs.get(entry, 0.0), err)

    def count(entry, counts, model=None, n_steps=0):
        """Add a run's launches of `entry`; for kernel 1's entries (given
        the run's model and outer steps) check and add its fast commits
        that read the cache."""
        old = launches.setdefault(entry, {"slow": 0, "frozen": 0,
                                          "cached": 0})
        for kk in counts[entry]:
            old[kk] += counts[entry][kk]
        if entry in bindings:
            n = bindings[entry].cached_launches
            check(n == expected_cached(m, model, n_steps),
                  f"{entry}: {n} fast commits read the cache in "
                  f"{n_steps} outer steps")
            old["cached"] += n

    # -- phase 38 ---------------------------------------------------------------
    print("phase 38: every Courtemanche entry vs plain PyTorch, every rate "
          "mode: kernel 1 at 512x512 (isotropic, and GEOM under the annulus "
          "of examples/court_run.py and under geometry (c)), kernel 4 at "
          "8x128x512; one launch of each form and 2 outer steps", flush=True)
    annulus = bodies.GeometryMaps((512, 512), court_annulus(st_, 512,
                                                        COURT_HOLE))
    for key in COURT_CHECKS:
        model = model_of(key)
        body = bodies.cell_body(model).name
        windows = model.ill_conditioned
        base = court_seeded(torch, m, model, dev, rng)
        for label, maps in (("isotropic", None), ("annulus", annulus),
                            ("(c)", geometry_maps(bodies, st_, "c",
                                                  (512, 512)))):
            geom = (k1.grid_geometry(device=dev) if maps is None
                    else maps.plain(dev))
            entry = f"{body}_substep" + ("" if maps is None else "_geom")
            kernel = bindings[entry]
            m.reset_counts()
            for slow in sorted(set(model.launch_schedule)):
                name = f"{entry} 512x512 {label} ({key}) slow={slow}"
                pk = torch.zeros(1, device=dev)
                pp = torch.zeros(1, device=dev)
                got = k1.substep(model, clone(base), slow, pk, 0, maps=maps)
                want = k1.plain_substep(model, clone(base), slow, pp, 0,
                                        geom)
                torch.cuda.synchronize()

                def exact(slow=slow, geom=geom):
                    ex = {kk: v.double() for kk, v in base.items()}
                    return k1.plain_substep(model, ex, slow, geom=geom), base

                note(entry, compare(f"{name}, one launch", got, want, exact,
                                    windows))
                check_rounding(name, model, got, want)
                compare_probes(name, pk, pp)
                if slow and kernel.cache is not None:
                    note(entry, check_cached_form(
                        torch, m, kernel, model, got, maps, geom, name,
                        windows))
            step = (k1.make_cuda_step(model) if maps is None else
                    k1.make_cuda_step(model, maps.phase, maps.fiber,
                                      maps.dmap))
            note(entry, check_outer_steps(
                torch, step, lambda s, p, i, geom=geom: k1.plain_step(
                    model, s, p, i, geom), base, 2,
                f"{entry} 512x512 {label} ({key})", windows=windows))
            want_n = expected_launches(model, 2)
            for slow in set(model.launch_schedule):
                want_n["slow" if slow else "frozen"] += 1
            n_read = int(kernel.cache is not None)
            want_n["frozen"] += n_read
            check_launched(m.read_counts(), entry, want_n,
                           f"{entry} ({key}, {label})")
            check(kernel.cached_launches
                  == expected_cached(m, model, 2) + n_read,
                  f"{entry} ({key}, {label}): {kernel.cached_launches} "
                  f"fast commits read the cache")
        vmodel = model_of(key, height=128)
        vbase = court_seeded(torch, m, vmodel, dev, rng, depth=DEPTH)
        entry = f"{body}_volume"
        m.reset_counts()
        for slow in sorted(set(vmodel.launch_schedule)):
            name = f"{entry} 8x128x512 ({key}) slow={slow}"
            got = k4.volume_substep(vmodel, clone(vbase), slow)
            want = k4.plain_volume_substep(vmodel, clone(vbase), slow)
            torch.cuda.synchronize()

            def exact(slow=slow):
                ex = {kk: v.double() for kk, v in vbase.items()}
                return k4.plain_volume_substep(vmodel, ex, slow), vbase

            note(entry, compare(f"{name}, one launch", got, want, exact,
                                vmodel.ill_conditioned))
            check_rounding(name, vmodel, got, want)
        note(entry, check_outer_steps(
            torch, k4.make_volume_step(vmodel, DEPTH),
            plain_volume(k4, vmodel), vbase, 2, f"{entry} 8x128x512 ({key})",
            windows=vmodel.ill_conditioned))
        want_n = expected_launches(vmodel, 2)
        for slow in set(vmodel.launch_schedule):
            want_n["slow" if slow else "frozen"] += 1
        check_launched(m.read_counts(), entry, want_n, f"{entry} ({key})")

    # -- phases 39 and 40 -------------------------------------------------------
    for body, cfg_kw, hole, s2, phase_no, example in (
            ("court", COURT_CFG, COURT_HOLE, COURT_S2, 39,
             "examples/court_run.py's first model"),
            ("court_ultra", ULTRA_CFG, ULTRA_HOLE, ULTRA_S2, 40,
             "examples/court_ultra_run.py's run_small")):
        stamp(f"phase {phase_no}")
        print(f"phase {phase_no}: {example} at 512x512 for 1000 ms (hole r "
              f"{hole}, ring r {COURT_RING}, S2 at {s2} ms) on kernel 1's "
              f"GEOM entry, against kernel='xla' on the card", flush=True)
        cls = classes[body]
        cfg = m.SimConfig(**cfg_kw)
        entry = f"{body}_substep_geom"
        out = {}
        for kernel in ("auto", "xla"):
            sim = court_annulus_sim(m, cls, cfg.replace(kernel=kernel), hole,
                                    device="cuda")
            check(sim.route == ("substep" if kernel == "auto" else "plain"),
                  f"{body} annulus run routes {sim.route!r}")
            seen = []
            key = "ultra" if body == "court_ultra" else "trend"
            sim.cl_observer = (lambda i, cl, sim=sim, seen=seen, key=key:
                               seen.append((i, sim.probe_at_step(i, key))))
            m.reset_counts()
            res = sim.simulate(schedule=[(s2, "s2")])
            counts = m.read_counts()
            out[kernel] = (sim, res, seen)
            if kernel == "xla":
                check(all(total_launches(c) == 0 for c in counts.values()),
                      f"the kernel='xla' {body} run launched a kernel")
                continue
            check_launched(counts, entry,
                           expected_launches(sim.model, res.steps),
                           f"the {body} annulus run")
            count(entry, counts, sim.model, res.steps)
            print(f"  {body}: route {sim.route}, steps {res.steps}, launches "
                  f"{counts[entry]}, cycle_lengths {res.cycle_lengths}, "
                  f"{1.0 / res.sim_seconds_per_wall_second:.6f} "
                  f"wall-s/sim-s [{card}]", flush=True)
            check_run(res, (512, 512), COURT_CROSSINGS[body])
            check(len(seen) == len(res.cycle_lengths),
                  f"{body}: the cl_observer ran {len(seen)} times")
            for i, value in seen:
                check(np.array_equal(value, res.probes[key][i]),
                      f"{body}: probe_at_step({i}, {key!r}) read {value}, "
                      f"the run recorded {res.probes[key][i]}")
            check(all(np.isfinite(res.probes[k]).all() for k in res.probes),
                  f"{body}: a probe stream is not finite")
            print(f"  {body}: {len(seen)} live reads of {key!r}, the first "
                  f"{seen[0][1] if seen else None}", flush=True)
        _, res, _ = out["auto"]
        runs[body] = res
        xsim, ref, _ = out["xla"]
        n_steps = ref.steps
        dv = float(np.abs(res.state["V"] - ref.state["V"]).max())
        dtrend = np.abs(res.probes["trend"] - ref.probes["trend"])
        fire = min(xsim.millisecond_to_step(s2) + 1, n_steps)
        print(f"  final V vs kernel='xla': max abs {dv:.4g} (bound "
              f"{COURT_RUN_ATOL_MV}), "
              f"{int((res.state['V'] != ref.state['V']).sum())} cells not "
              f"bit-equal; trend max abs {dtrend.max(0)} over the run, "
              f"{dtrend[:fire].max(0)} to the S2; crossings "
              f"{ref.cycle_lengths}", flush=True)
        check(ref.cycle_lengths[:1] == res.cycle_lengths[:1],
              f"{body}: kernel and kernel-free runs cross at different steps")
        upto = n_steps
        if dv > COURT_RUN_ATOL_MV:
            ex_v, ex_trend = court_float64_run(torch, m, xsim.model,
                                               xsim.phase, s2, n_steps)
            court_arbitrate(body, res, ref, ex_v)
            print(f"  {body}: the trend to the S2 within "
                  f"{np.abs(res.probes['trend'] - ex_trend)[:fire].max(0)} "
                  f"of float64's", flush=True)
            upto = fire
        check(bool((dtrend[:upto, 0] <= COURT_RUN_ATOL_MV).all()
                   and (dtrend[:upto, 1] <= 1e-3 * np.abs(
                       ref.probes["trend"][:upto, 1])).all()),
              f"{body}: the trend stream parts from kernel='xla' by "
              f"{dtrend[:upto].max(0)} over its first {upto} steps")
        if "ultra" in ref.probes:
            # the grid means of Na_i, f_Ca, us and the us rates
            dultra = np.abs(res.probes["ultra"] - ref.probes["ultra"])
            rel = dultra[:upto] / np.abs(ref.probes["ultra"][:upto])
            print(f"  {body}: ultra stream max rel {rel.max(0)} over its "
                  f"first {upto} steps", flush=True)
            check(bool((rel <= 1e-3).all()),
                  f"{body}: the ultra stream parts from kernel='xla' by "
                  f"{rel.max(0)} (relative) over its first {upto} steps")

    stamp("phase 41")
    # -- phase 41 ---------------------------------------------------------------
    print(f"phase 41: a regional _p_chronic plane (the left half remodeled, "
          f"a 0.5 border) at 512x512 for {CHRONIC_MS:.0f} ms on kernel 1, "
          f"Courtemanche and Courtemanche-ultra, against kernel='xla'",
          flush=True)
    plane = np.zeros((512, 512), np.float32)
    plane[:, :256] = 1.0
    plane[:, 248:264] = 0.5
    for body, cfg_kw in (("court", COURT_CFG), ("court_ultra", ULTRA_CFG)):
        cls = classes[body]
        out = {}
        for kernel in ("auto", "xla"):
            cfg = m.SimConfig(**dict(cfg_kw, duration=CHRONIC_MS,
                                     kernel=kernel))
            model = cls(cfg).set_het(chronic=plane)
            sim = m.Simulation(model, device="cuda").define()
            m.reset_counts()
            res = out[kernel] = sim.simulate()
            counts = m.read_counts()
            if kernel == "auto":
                check(sim.route == "substep", f"{body} routes {sim.route}")
                check_launched(counts, f"{body}_substep",
                               expected_launches(model, res.steps),
                               f"the {body} chronic-plane run")
                count(f"{body}_substep", counts, model, res.steps)
                check(all(np.isfinite(v).all() for v in res.state.values())
                      and len(res.cycle_lengths) >= 1,
                      f"the {body} chronic-plane run is not finite or saw "
                      f"no wavefront")
        dv = float(np.abs(out["auto"].state["V"]
                          - out["xla"].state["V"]).max())
        print(f"  {body}: final V vs kernel='xla': max abs {dv:.4g} (bound "
              f"{COURT_RUN_ATOL_MV}); crossings {out['xla'].cycle_lengths}",
              flush=True)
        check(out["xla"].cycle_lengths[:1] == out["auto"].cycle_lengths[:1],
              f"{body}: the chronic-plane runs cross at different steps")
        if dv > COURT_RUN_ATOL_MV:
            court_arbitrate(f"{body} chronic", out["auto"], out["xla"],
                            court_float64_run(torch, m, model, None, None,
                                              out["xla"].steps)[0])
        v = out["auto"].state["V"]
        print(f"  {body}: cycle_lengths {out['auto'].cycle_lengths}, mean V "
              f"remodeled {float(v[:, :248].mean()):.3f} mV, healthy "
              f"{float(v[:, 264:].mean()):.3f} mV, "
              f"{1.0 / out['auto'].sim_seconds_per_wall_second:.6f} "
              f"wall-s/sim-s [{card}]", flush=True)
        runs[f"{body} chronic"] = out["auto"]

    stamp("phase 42")
    # -- phase 42 ---------------------------------------------------------------
    print(f"phase 42: run_volume of Courtemanche ({COURT_VOL_STEPS['court']} "
          f"outer steps) and Courtemanche-ultra "
          f"({COURT_VOL_STEPS['court_ultra']}) at {DEPTH}x128x512 on kernel "
          f"4, against kernel='xla'", flush=True)
    # court_ultra's diff 1.5 takes dt 0.05 under the 3D explicit limit
    # 2 / ((8 + 8) diff)
    for body, cfg_kw in (("court", COURT_CFG),
                         ("court_ultra", dict(ULTRA_CFG, dt=0.05))):
        vcfg = m.SimConfig(**dict(cfg_kw, height=128))
        n_steps = COURT_VOL_STEPS[body]
        vol = {}
        for kernel in ("auto", "xla"):
            model = classes[body](vcfg)
            m.reset_counts()
            t = time.perf_counter()
            st, probes, _ = m.run_volume(model, DEPTH, n_steps,
                                         kernel=kernel)
            wall = time.perf_counter() - t
            counts = m.read_counts()
            vol[kernel] = (st, probes, wall)
            if kernel == "auto":
                check(m.volume.volume_route(model, DEPTH, "cuda", "auto")
                      == "substep", f"the {body} volume does not route "
                                    f"'substep'")
                check_launched(counts, f"{body}_volume", expected_launches(
                    model, n_steps), f"the {body} volume run")
                count(f"{body}_volume", counts)
            else:
                check(all(total_launches(c) == 0 for c in counts.values()),
                      f"the kernel='xla' {body} volume run launched a "
                      f"kernel")
        dv = float(np.abs(vol["auto"][0]["V"] - vol["xla"][0]["V"]).max())
        dp = float(np.abs(vol["auto"][1] - vol["xla"][1]).max())
        sim_s = n_steps * 10 * vcfg.dt / 1000.0
        print(f"  {body}: final V vs kernel='xla': max abs {dv:.4g}; probe "
              f"max abs {dp:.3g}, probe max "
              f"{float(vol['auto'][1].max()):.3f}; "
              f"{vol['auto'][2] / sim_s:.6f} wall-s/sim-s on kernel 4, "
              f"{vol['xla'][2] / sim_s:.6f} with kernel='xla' [{card}]",
              flush=True)
        check(all(np.isfinite(v).all() for v in vol["auto"][0].values()),
              f"the {body} volume run is not finite")
        if dv > COURT_RUN_ATOL_MV or dp > 1e-3:
            ex = {k: torch.tensor(v, dtype=torch.float64, device=dev)
                  for k, v in m.volume.volume_state(model, DEPTH).items()}
            for _ in range(n_steps):
                k4.plain_volume_step(model, ex)
            court_arbitrate(
                f"{body} volume",
                types.SimpleNamespace(state=vol["auto"][0]),
                types.SimpleNamespace(state=vol["xla"][0]),
                ex["V"].cpu().numpy())

    stamp("phase 43")
    # -- phase 43 ---------------------------------------------------------------
    print(f"phase 43: device time of every Courtemanche entry beside its "
          f"plain version and its bound [{card}]", flush=True)
    entries = []
    stream = torch.cuda.current_stream().cuda_stream
    cells = 512 * 512
    for body in ("court", "court_ultra"):
        model = model_of(body)
        base = court_seeded(torch, m, model, dev, rng)
        params = bodies.pack_params(model)
        for label, maps in (("", None), ("_geom", annulus)):
            kernel = (k1.KERNELS if maps is None else k1.GEOM_KERNELS)[body]
            geom = (k1.grid_geometry(device=dev) if maps is None
                    else maps.plain(dev))
            args = () if maps is None else maps.args(dev)
            # the slow commit (which stores a body's cache) first, then the
            # fast commit that computes its terms, and the one that reads
            # the cache
            has_cache = kernel.cache is not None
            n = launches.get(f"{body}_substep{label}", {})
            for slow, reads in [(s, False) for s in sorted(
                    set(model.launch_schedule), reverse=True)] + (
                    [(False, True)] if has_cache else []):
                state = clone(base)
                us = device_us(torch, lambda: kernel.launch(
                    params, state, slow, None, model.probe_pixel, 0, stream,
                    args, reads), reps=100)
                if reads:
                    inv = model.fast_invariants(state)
                    plain = stream_us(torch, lambda: k1.plain_cached_substep(
                        model, state, inv, geom=geom), reps=5)
                else:
                    plain = stream_us(torch, lambda: k1.plain_substep(
                        model, state, slow, geom=geom), reps=5)
                b = court_bound(model, cells, slow, maps=maps,
                                cached=has_cache and (slow or reads))
                name = (f"{body}_substep{label}<SLOW={str(slow).lower()}"
                        f"{',cached' if reads else ''}>")
                print(f"  {name} 512x512: {us:.3f} us/launch, plain "
                      f"{plain:.1f} us, bound {b[0] * 1e3:.3f} us ({b[1]}) "
                      f"[{card}]", flush=True)
                entries.append(kernel_entry(
                    name, "fib_tf_tpu_torch/csrc/br_substep.cu",
                    "fib_tf_tpu/ops/pallas_step.py:205",
                    n.get("slow", 0) if slow else n.get("cached", 0) if reads
                    else n.get("frozen", 0) - n.get("cached", 0),
                    errs[f"{body}_substep{label}"], us, plain, b))
        vmodel = model_of(body, height=128)
        vbase = court_seeded(torch, m, vmodel, dev, rng, depth=DEPTH)
        vparams = bodies.pack_params(vmodel)
        pixel = k4.volume_probe_pixel(vmodel, DEPTH)
        timing = {}
        for slow in set(vmodel.launch_schedule):
            state = clone(vbase)
            timing[slow] = {
                "kernel_us": device_us(torch, lambda: k4.KERNELS[body].launch(
                    vparams, state, slow, 1.0, None, pixel, 0, stream),
                    reps=100),
                "plain_us": stream_us(torch, lambda: k4.plain_volume_substep(
                    vmodel, state, slow), reps=5)}
        for slow in sorted(timing, reverse=True):
            b = court_bound(vmodel, DEPTH * 128 * 512, slow, volume=True)
            name = f"{body}_volume<SLOW={str(slow).lower()}>"
            print(f"  {name} {DEPTH}x128x512: "
                  f"{timing[slow]['kernel_us']:.3f} us/launch, plain "
                  f"{timing[slow]['plain_us']:.1f} us, bound "
                  f"{b[0] * 1e3:.3f} us ({b[1]}) [{card}]", flush=True)
            entries.append(kernel_entry(
                name, "fib_tf_tpu_torch/csrc/br_volume.cu",
                "fib_tf_tpu/ops/pallas_volume.py:499",
                launches.get(f"{body}_volume", {}).get(
                    "slow" if slow else "frozen", 0),
                errs[f"{body}_volume"], timing[slow]["kernel_us"],
                timing[slow]["plain_us"], b))
    for label, res in runs.items():
        print(f"  {label} 512x512 run: "
              f"{1.0 / res.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
              f"[{card}]", flush=True)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was not launched on a main "
                                 f"path")
    stamp("the end")
    return entries


# Luo-Rudy 1991 and ten Tusscher-Panfilov 2006 (phases 44-48).  Their
# configurations are the examples': examples/lr1_spiral.py (512x512, dt
# 0.02, diff 0.809, g_si 0.02 set after construction, skip off by default),
# examples/tp06_spiral.py (512x512, dt 0.02, diff 0.15, epi) and
# examples/tp06_transmural.py (a 4x256 strip, dt 0.02, diff 0.809, the
# transmural bands 0.25 / 0.60, paced at its left edge)
LRTP_SIZE = 512
LR1_CFG = dict(width=LRTP_SIZE, height=LRTP_SIZE, dt=0.02, dt_per_plot=10,
               diff=0.809, duration=1.0)
TP06_CFG = dict(LR1_CFG, diff=0.15)
TRANSMURAL_CFG = dict(width=256, height=4, dt=0.02, dt_per_plot=10,
                      diff=0.809, duration=800.0, cell_type="transmural",
                      cell_type_bands=(0.25, 0.60))
LR1_GSI = 0.02
# the spiral protocol: an S1 plane wave to the cut (lr1_spiral.py's default
# round(n / 2 / 2.2) ms; tp06_spiral.py's round(2 n / 3 / cv) ms at diff
# 0.15), the lower half of every plane reset to rest, then stage 2.  The
# plain kernel='xla' runs cost 18 ms (LR1) and 63 ms (tp06) per outer step
# at 512x512 on the card, so they cover LR1's whole stage 1, the first
# LRTP_PREFIX_MS of tp06's stage 1 and of the transmural beat, and
# LRTP_STAGE2_MS of stage 2 from the kernel run's cut state
LR1_CUT_MS = round(LRTP_SIZE / 2 / 2.2)
TP06_CUT_MS = round(2 * LRTP_SIZE / 3 / (2.22 * np.sqrt(0.15 / 0.809)))
LRTP_PREFIX_MS = 40.0
TRANSMURAL_PREFIX_MS = 60.0
LRTP_STAGE2_MS = 40.0
LRTP_GEOM_MS = 20.0
LRTP_VOL_STEPS = 50
# every form and het-plane subset on kernel 1: (body, configuration, what
# is set after construction, a g_kr dose plane)
LRTP_SCALES = {
    "lr1": (("g_Na", 0.9), ("g_si", 0.5), ("g_K", 1.2), ("g_K1", 1.1),
            ("g_Kp", 0.8), ("g_b", 1.3)),
    "tp06": (("g_Na", 0.8), ("g_CaL", 0.85), ("g_Kr", 0.9), ("g_Ks", 0.95),
             ("g_to", 1.0), ("g_K1", 1.05), ("g_NaK", 1.1),
             ("g_NaCa", 1.15), ("g_pCa", 1.2), ("g_pK", 1.25),
             ("g_bNa", 1.3), ("g_bCa", 1.35))}
LRTP_CHECKS = {
    "lr1-skip": ("lr1", dict(LR1_CFG, skip=True), LR1_GSI, False),
    "lr1": ("lr1", LR1_CFG, LR1_GSI, False),
    "lr1-scaled": ("lr1", dict(LR1_CFG, skip=True,
                               g_scale=LRTP_SCALES["lr1"]), LR1_GSI, False),
    "tp06-epi-skip": ("tp06", dict(TP06_CFG, skip=True), None, False),
    "tp06-epi": ("tp06", TP06_CFG, None, False),
    "tp06-endo-skip": ("tp06", dict(TP06_CFG, skip=True, cell_type="endo"),
                       None, False),
    "tp06-endo": ("tp06", dict(TP06_CFG, cell_type="endo"), None, False),
    "tp06-m-skip": ("tp06", dict(TP06_CFG, skip=True), "m", False),
    "tp06-m": ("tp06", TP06_CFG, "m", False),
    "tp06-transmural-skip": ("tp06", dict(LR1_CFG, skip=True,
                                          cell_type="transmural"), None,
                             False),
    "tp06-g_kr": ("tp06", TP06_CFG, None, True),
    "tp06-transmural-g_kr-scaled": ("tp06", dict(
        LR1_CFG, cell_type="transmural", g_scale=LRTP_SCALES["tp06"]), None,
        True),
}
# the GEOM entries' checks and runs (under the annulus of court_annulus and
# fibers at FIBER_DEG / FIBER_RATIO), and the volumes
LRTP_GEOM_CHECKS = ("lr1-skip", "tp06-transmural-skip")
LRTP_VOL_CHECKS = ("lr1-skip", "tp06-epi-skip", "tp06-transmural-skip")
# float32 operations per cell of each form (lr1_cell.cuh, tp06_cell.cuh,
# counted by hand, a transcendental or a division as one), the 9-point
# stencil's 10 included: LR1's fast gates 72, slow gates 81, currents 70,
# Cai and V 10; tp06's fast gates 154, slow gates 131, fcass 13, currents
# 135, SR and pools 98, V 4.  Each het plane adds its product, the endo
# blend 20 to the slow form; a volume's z term 4
LRTP_FLOPS = {("lr1", True): 243, ("lr1", False): 162,
              ("tp06", True): 545, ("tp06", False): 414}
# the planes each form writes besides V (lr1_cell.cuh, tp06_cell.cuh)
LRTP_WRITES = {("lr1", True): 7, ("lr1", False): 4,
               ("tp06", True): 18, ("tp06", False): 13}


def lrtp_model(m, key, **kw):
    """The model of LRTP_CHECKS[key] (the configuration with `kw`), with
    what is set after construction and its g_kr dose plane."""
    body, cfg, after, kr = LRTP_CHECKS[key]
    cls = {"lr1": m.LuoRudy91, "tp06": m.TenTusscher06}[body]
    model = cls(m.SimConfig(**dict(cfg, **kw)))
    if after is not None:
        setattr(model, "g_si" if body == "lr1" else "cell_type", after)
    if kr:
        h, w = model.state_shape()
        model.set_het(g_kr=np.linspace(0.2, 1.0, w, dtype=np.float32)[
            None].repeat(h, 0))
    return model


def lrtp_flops(model, slow: bool, volume: bool) -> int:
    """Float32 operations per cell-substep of the Luo-Rudy or tp06 body."""
    n = LRTP_FLOPS[(model.name, slow)] + (4 if volume else 0)
    het = getattr(model, "het", {})
    n += sum(k in het for k in ("g_to", "g_ks", "g_kr"))
    return n + (20 if slow and "endo" in het else 0)


def lrtp_bytes(model, slow: bool) -> int:
    """Bytes per cell of one launch: V and the per-cell planes read (the
    attached het planes too), V and the planes the form commits written."""
    body = model.name
    planes = {"lr1": 7, "tp06": 18}[body] + len(getattr(model, "het", {}))
    return 4 * ((1 + planes) + (1 + LRTP_WRITES[(body, slow)]))


def ptxas_kernels(log_text: str):
    """{mangled entry: (registers, spill store bytes)} from a library's
    -Xptxas -v log."""
    out, name, spill = {}, None, None
    for line in log_text.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name, spill = hit.group(1), None
            continue
        hit = re.search(r"(\d+) bytes spill stores", line)
        if hit:
            spill = int(hit.group(1))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name is not None:
            out[name] = (int(hit.group(1)), spill)
            name = None
    return out


def lrtp_ptxas(kernels, body: str, slow: bool, geom=None):
    """(registers, spills) of one (body, form) instantiation: substep_kernel
    <Body, SLOW, GEOM> (`geom` True or False) or volume_kernel<Body,
    SLOW> (`geom` None)."""
    cell = {"lr1": "7Lr1Cell", "tp06": "8Tp06Cell"}[body]
    flags = f"ELb{int(slow)}E" + ("" if geom is None else f"Lb{int(geom)}E")
    kind = "volume_kernel" if geom is None else "substep_kernel"
    found = [v for k, v in kernels.items()
             if kind in k and f"fibtorch{cell}{flags}" in k]
    check(len(found) == 1, f"ptxas log has {len(found)} entries for "
                           f"{kind}<{body}, {slow}, {geom}>")
    return found[0]


def lrtp_float64(torch, m, model, state, n_steps, maps=None, depth=None):
    """The final potential of `n_steps` outer steps from the numpy `state`
    on the plain path in float64 (under `maps`' geometry, or of a volume of
    `depth`)."""
    dev = torch.device("cuda")
    st = {k: torch.tensor(np.asarray(v), dtype=torch.float64, device=dev)
          for k, v in state.items()}
    for _ in range(n_steps):
        if depth is not None:
            m.cuda_volume.plain_volume_step(model, st)
        else:
            m.cuda_step.plain_step(model, st, geom=None if maps is None
                                   else maps.plain(dev))
    return st["V"].cpu().numpy()


def lrtp_against_xla(torch, m, name, got, ref, state, model, n_steps,
                     maps=None, depth=None):
    """A kernel run's final state `got` against the kernel='xla' run's
    `ref` from the same numpy `state`: bit for bit, or past that no further
    from a float64 plain run than the float32 plain run is (with no
    factor).  Returns the max abs difference of V."""
    unequal = sum(int((got[k] != ref[k]).sum()) for k in ref)
    dv = float(np.abs(got["V"] - ref["V"]).max())
    print(f"  {name}: vs kernel='xla': {unequal} cells not bit-equal over "
          f"{len(ref)} planes, V max abs {dv:.4g}", flush=True)
    check(all(np.isfinite(v).all() for v in got.values()),
          f"{name}: the kernel run is not finite")
    if unequal:
        ex = lrtp_float64(torch, m, model, state, n_steps, maps, depth)
        ke = float(np.abs(got["V"] - ex).max())
        pe = float(np.abs(ref["V"] - ex).max())
        print(f"  {name}: arbitrated by the float64 plain run: the kernel "
              f"run ends {ke:.4g} from it, the float32 plain run {pe:.4g}",
              flush=True)
        check(ke <= pe, f"{name}: the kernel run ends {ke} from the float64 "
                        f"run, the float32 plain run {pe}")
    return dv


def lrtp_phases(torch, m, card, rng, lib_paths):
    """Phases 44-48: Luo-Rudy 1991 and ten Tusscher-Panfilov 2006 on
    kernels 1 (isotropic and GEOM) and 4.  `m` carries the port's modules
    and main()'s launch counters, `lib_paths` the built libraries; returns
    their entries of the JSON line."""
    dev = torch.device("cuda")
    k1, k4, st_ = m.cuda_step, m.cuda_volume, m.stencil
    bodies = m.bodies
    classes = {"lr1": m.LuoRudy91, "tp06": m.TenTusscher06}
    errs, launches, runs = {}, {}, {}
    t0 = time.perf_counter()

    def stamp(phase):
        print(f"  ({phase} starts {time.perf_counter() - t0:.1f} s into "
              f"phases 44-48)", flush=True)

    def seeded(model, depth=None):
        """The initial state (S1 stripe, any het planes), V raised per cell
        by N(0, 1) mV, then 20 plain outer steps (4 ms) on the card, so
        that the S1 front has left its stripe; a volume extrudes it over
        `depth` with per-cell noise on V."""
        st = model.initial_state()
        shape = st["V"].shape
        st["V"] = st["V"] + rng.normal(0.0, 1.0, shape).astype(np.float32)
        base = m.interop.state_from_numpy(st, dev)
        for _ in range(20):
            k1.plain_step(model, base)
        if depth is not None:
            base = {k: v[None].repeat(depth, 1, 1).contiguous()
                    for k, v in base.items()}
            base["V"] += torch.randn(base["V"].shape, device=dev,
                                     generator=torch.Generator(dev)
                                     .manual_seed(int(rng.integers(1 << 30))))
        torch.cuda.synchronize()
        check(bool(base["V"].isfinite().all())
              and float(base["V"].max()) > WAVEFRONT_MV,
              f"{model.name} {tuple(base['V'].shape)} seeded state holds no "
              f"wavefront")
        return base

    def note(entry, err):
        errs[entry] = max(errs.get(entry, 0.0), err)

    def count(entry, counts):
        old = launches.setdefault(entry, {"slow": 0, "frozen": 0})
        for kk in counts[entry]:
            old[kk] += counts[entry][kk]

    def check_entry(key, model, base, entry, launch, plain, step, plain_step,
                    label):
        """One launch of each form and 2 outer steps of `entry` vs plain,
        bit for bit (the bodies round as the plain path does), with exact
        launches."""
        windows = model.ill_conditioned
        m.reset_counts()
        for slow in sorted(set(model.launch_schedule)):
            name = f"{entry} {label} ({key}) slow={slow}"
            got = launch(clone(base), slow)
            want = plain(clone(base), slow)
            torch.cuda.synchronize()

            def exact(slow=slow):
                return plain({kk: v.double() for kk, v in base.items()},
                             slow), base

            note(entry, compare(f"{name}, one launch", got, want, exact,
                                windows))
            n = unequal_cells(got, want)
            print(f"    {n} cells not bit-equal to plain", flush=True)
            check(n == 0, f"{name}: {n} cells differ from the plain version, "
                          f"which a launch equals bit for bit")
        note(entry, check_outer_steps(torch, step, plain_step, base, 2,
                                      f"{entry} {label} ({key})",
                                      windows=windows))
        want_n = expected_launches(model, 2)
        for slow in set(model.launch_schedule):
            want_n["slow" if slow else "frozen"] += 1
        check_launched(m.read_counts(), entry, want_n, f"{entry} ({key})")

    # -- phase 44 ---------------------------------------------------------------
    stamp("phase 44")
    print(f"phase 44: lr1_substep and tp06_substep vs plain PyTorch at "
          f"{LRTP_SIZE}x{LRTP_SIZE}: one launch of each form and 2 outer "
          f"steps, skip on and off, LR1 with g_si {LR1_GSI} set after "
          f"construction and every g_scale factor, tp06 in each cell type (m "
          f"set after construction), transmural, with a g_kr plane alone "
          f"and with both and every g_scale factor", flush=True)
    iso = k1.grid_geometry(device=dev)
    for key in LRTP_CHECKS:
        model = lrtp_model(m, key)
        body = bodies.cell_body(model).name
        check_entry(
            key, model, seeded(model), f"{body}_substep",
            lambda s, slow, model=model: k1.substep(model, s, slow),
            lambda s, slow, model=model: k1.plain_substep(model, s, slow,
                                                          geom=iso),
            k1.make_cuda_step(model),
            lambda s, p, i, model=model: k1.plain_step(model, s, p, i, iso),
            f"{LRTP_SIZE}x{LRTP_SIZE}")

    # -- phase 45 ---------------------------------------------------------------
    stamp("phase 45")
    maps = bodies.GeometryMaps(
        (LRTP_SIZE, LRTP_SIZE), court_annulus(st_, LRTP_SIZE, COURT_HOLE),
        st_.fiber_tensor(np.deg2rad(FIBER_DEG), FIBER_RATIO))
    print(f"phase 45: the GEOM entries under the annulus of "
          f"examples/court_run.py and fibers at {FIBER_DEG} degrees, ratio "
          f"{FIBER_RATIO}: one launch of each form and 2 outer steps; then "
          f"Simulation with the same geometry for {LRTP_GEOM_MS} ms against "
          f"kernel='xla'", flush=True)
    gplain = maps.plain(dev)
    for key in LRTP_GEOM_CHECKS:
        model = lrtp_model(m, key)
        body = bodies.cell_body(model).name
        check_entry(
            key, model, seeded(model), f"{body}_substep_geom",
            lambda s, slow, model=model: k1.substep(model, s, slow,
                                                    maps=maps),
            lambda s, slow, model=model: k1.plain_substep(model, s, slow,
                                                          geom=gplain),
            k1.make_cuda_step(model, maps.phase, maps.fiber),
            lambda s, p, i, model=model: k1.plain_step(model, s, p, i,
                                                       gplain),
            "annulus+fibers")
        out = {}
        for kernel in ("auto", "xla"):
            model = lrtp_model(m, key, duration=LRTP_GEOM_MS, kernel=kernel,
                             fiber_angle=np.deg2rad(FIBER_DEG),
                             fiber_ratio=FIBER_RATIO)
            sim = m.Simulation(model, device="cuda")
            sim.phase = maps.phase
            sim.define()
            m.reset_counts()
            out[kernel] = res = sim.simulate()
            counts = m.read_counts()
            if kernel == "auto":
                check(sim.route == "substep", f"{key} routes {sim.route}")
                check_launched(counts, f"{body}_substep_geom",
                               expected_launches(model, res.steps),
                               f"the {key} annulus run")
                count(f"{body}_substep_geom", counts)
            else:
                check(all(total_launches(c) == 0 for c in counts.values()),
                      f"the kernel='xla' {key} run launched a kernel")
        note(f"{body}_substep_geom", lrtp_against_xla(
            torch, m, f"{key} annulus+fibers run", out["auto"].state,
            out["xla"].state, model.initial_state(), model, out["xla"].steps,
            maps))
        runs[f"{key} annulus+fibers"] = out["auto"]

    # -- phase 46 ---------------------------------------------------------------
    stamp("phase 46")
    print(f"phase 46: lr1_volume and tp06_volume vs plain PyTorch at "
          f"{DEPTH}x128x{LRTP_SIZE}: one launch of each form and 2 outer "
          f"steps; run_volume for {LRTP_VOL_STEPS} outer steps against "
          f"kernel='xla' (tp06's wedge banded along z)", flush=True)
    for key in LRTP_VOL_CHECKS:
        vmodel = lrtp_model(m, key, height=128)
        body = bodies.cell_body(vmodel).name
        check_entry(
            key, vmodel, seeded(vmodel, depth=DEPTH), f"{body}_volume",
            lambda s, slow, vm=vmodel: k4.volume_substep(vm, s, slow),
            lambda s, slow, vm=vmodel: k4.plain_volume_substep(vm, s, slow),
            k4.make_volume_step(vmodel, DEPTH), plain_volume(k4, vmodel),
            f"{DEPTH}x128x{LRTP_SIZE}")
        state = (m.transmural_volume_state(vmodel, DEPTH)
                 if "transmural" in key
                 else m.volume.volume_state(vmodel, DEPTH))
        vol = {}
        for kernel in ("auto", "xla"):
            m.reset_counts()
            t = time.perf_counter()
            st, probes, _ = m.run_volume(vmodel, DEPTH, LRTP_VOL_STEPS,
                                         state=state, kernel=kernel)
            vol[kernel] = (st, time.perf_counter() - t)
            counts = m.read_counts()
            if kernel == "auto":
                check(m.volume.volume_route(vmodel, DEPTH, "cuda", "auto")
                      == "substep", f"the {key} volume does not route "
                                    f"'substep'")
                check_launched(counts, f"{body}_volume", expected_launches(
                    vmodel, LRTP_VOL_STEPS), f"the {key} volume run")
                count(f"{body}_volume", counts)
            else:
                check(all(total_launches(c) == 0 for c in counts.values()),
                      f"the kernel='xla' {key} volume run launched a kernel")
        note(f"{body}_volume", lrtp_against_xla(
            torch, m, f"{key} run_volume", vol["auto"][0], vol["xla"][0],
            state, vmodel, LRTP_VOL_STEPS, depth=DEPTH))
        sim_s = LRTP_VOL_STEPS * 10 * vmodel.cfg.dt / 1000.0
        print(f"  {key} run_volume: {vol['auto'][1] / sim_s:.6f} wall-s/sim-s "
              f"on kernel 4, {vol['xla'][1] / sim_s:.6f} with kernel='xla' "
              f"[{card}]", flush=True)

    # -- phase 47 ---------------------------------------------------------------
    stamp("phase 47")
    print(f"phase 47: the main path at full width under 'auto': "
          f"examples/lr1_spiral.py (g_si {LR1_GSI}; the cut at "
          f"{LR1_CUT_MS} ms) and examples/tp06_spiral.py (epi, diff 0.15; the "
          f"cut at {TP06_CUT_MS} ms), skip off and on, stage 2 for "
          f"{LRTP_STAGE2_MS} ms; "
          f"examples/tp06_transmural.py's strip for one {TRANSMURAL_CFG['duration']:.0f} ms "
          f"beat; each against kernel='xla' on the card", flush=True)

    def run(model, state=None):
        """A Simulation of `model` from `state` (None: its initial state),
        as the examples drive it, with its launch counts."""
        sim = m.Simulation(model, device="cuda")
        check(sim.route == ("plain" if model.cfg.kernel == "xla"
                            else "substep"),
              f"{model.name} routes {sim.route!r}")
        sim.define()
        m.reset_counts()
        res = sim.simulate(state=state)
        return res, m.read_counts()

    for label, key, cut_ms, prefix_ms in (
            ("lr1_spiral", "lr1", LR1_CUT_MS, float(LR1_CUT_MS)),
            ("lr1_spiral --skip", "lr1-skip", LR1_CUT_MS, float(LR1_CUT_MS)),
            ("tp06_spiral", "tp06-epi", TP06_CUT_MS, LRTP_PREFIX_MS),
            ("tp06_spiral --skip", "tp06-epi-skip", TP06_CUT_MS,
             LRTP_PREFIX_MS)):
        body = LRTP_CHECKS[key][0]
        entry = f"{body}_substep"
        # stage 1 on the kernel to the cut, and its first prefix_ms against
        # kernel='xla'
        stage1, counts = run(lrtp_model(m, key, duration=float(cut_ms)))
        check_launched(counts, entry, expected_launches(
            lrtp_model(m, key), stage1.steps), f"{label} stage 1")
        count(entry, counts)
        check(all(np.isfinite(v).all() for v in stage1.state.values()),
              f"{label}: stage 1 is not finite")
        pre = {}
        for kernel in ("auto", "xla"):
            model = lrtp_model(m, key, duration=prefix_ms, kernel=kernel)
            pre[kernel], counts = run(model)
            if kernel == "auto":
                count(entry, counts)
        note(entry, lrtp_against_xla(
            torch, m, f"{label} stage 1, {prefix_ms:.0f} ms",
            pre["auto"].state, pre["xla"].state, model.initial_state(),
            model, pre["xla"].steps))
        # the cut: the lower half of every plane back to rest
        cut = {k: np.array(v) for k, v in stage1.state.items()}
        rest = classes[body](m.SimConfig(width=LRTP_SIZE, height=LRTP_SIZE,
                                         dt=0.02, duration=1)
                             ).initial_state(s1=False)
        for k in cut:
            cut[k][LRTP_SIZE // 2:, :] = rest[k][LRTP_SIZE // 2:, :]
        stage2 = {}
        for kernel in ("auto", "xla"):
            model = lrtp_model(m, key, duration=LRTP_STAGE2_MS, kernel=kernel)
            t = time.perf_counter()
            stage2[kernel], counts = run(model, cut)
            wall = time.perf_counter() - t
            if kernel == "auto":
                check_launched(counts, entry, expected_launches(
                    model, stage2[kernel].steps), f"{label} stage 2")
                count(entry, counts)
            print(f"  {label} stage 2 ({kernel}): {stage2[kernel].steps} "
                  f"outer steps, {wall / (LRTP_STAGE2_MS / 1000.0):.6f} "
                  f"wall-s/sim-s [{card}]", flush=True)
        note(entry, lrtp_against_xla(
            torch, m, f"{label} stage 2", stage2["auto"].state,
            stage2["xla"].state, cut, model, stage2["xla"].steps))
        active = float((stage2["auto"].state["V"] > -40.0).mean())
        print(f"  {label}: stage 1 crossings {stage1.cycle_lengths}, "
              f"active fraction after stage 2 {active:.3f}, "
              f"{1.0 / stage1.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
              f"in stage 1 [{card}]", flush=True)
        check(0.0 < active < 1.0, f"{label}: no free wave end after the cut")
        runs[label] = stage1

    # the transmural strip: the whole beat on the kernel, its first
    # TRANSMURAL_PREFIX_MS against kernel='xla'
    beat, counts = run(classes["tp06"](m.SimConfig(**TRANSMURAL_CFG)))
    strip = classes["tp06"](m.SimConfig(**TRANSMURAL_CFG))
    check_launched(counts, "tp06_substep", expected_launches(
        strip, beat.steps), "the transmural beat")
    count("tp06_substep", counts)
    check(all(np.isfinite(v).all() for v in beat.state.values())
          and len(beat.cycle_lengths) >= 1,
          f"the transmural beat is not finite or never crossed its probe "
          f"{strip.probe_pixel}")
    pre = {}
    for kernel in ("auto", "xla"):
        model = classes["tp06"](m.SimConfig(**dict(
            TRANSMURAL_CFG, duration=TRANSMURAL_PREFIX_MS, kernel=kernel)))
        pre[kernel], counts = run(model)
        if kernel == "auto":
            count("tp06_substep", counts)
    note("tp06_substep", lrtp_against_xla(
        torch, m, f"tp06_transmural, {TRANSMURAL_PREFIX_MS:.0f} ms",
        pre["auto"].state, pre["xla"].state, model.initial_state(), model,
        pre["xla"].steps))
    v = beat.state["V"]
    print(f"  tp06_transmural: {beat.steps} outer steps, crossings "
          f"{beat.cycle_lengths} at {strip.probe_pixel}, final V by band "
          f"(endo, M, epi) {float(v[:, :64].mean()):.3f}, "
          f"{float(v[:, 64:153].mean()):.3f}, {float(v[:, 153:].mean()):.3f} "
          f"mV, {1.0 / beat.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
          f"[{card}]", flush=True)
    runs["tp06_transmural"] = beat

    # -- phase 48 ---------------------------------------------------------------
    stamp("phase 48")
    print(f"phase 48: device time of every Luo-Rudy and tp06 entry beside "
          f"its plain version, its bound and its registers [{card}]",
          flush=True)
    entries = []
    stream = torch.cuda.current_stream().cuda_stream
    ptx = {lib: ptxas_kernels(lib_paths[lib].with_name(
        lib_paths[lib].name + ".log").read_text())
        for lib in ("lrtp_substep", "lrtp_volume")}
    cells = LRTP_SIZE * LRTP_SIZE
    for key in ("lr1-skip", "tp06-transmural-skip"):
        model = lrtp_model(m, key)
        body = bodies.cell_body(model).name
        base = seeded(model)
        params = bodies.pack_params(model)
        for label, gm in (("", None), ("_geom", maps)):
            kernel = (k1.KERNELS if gm is None else k1.GEOM_KERNELS)[body]
            geom = iso if gm is None else gm.plain(dev)
            args = () if gm is None else gm.args(dev)
            for slow in (True, False):
                state = clone(base)
                us = device_us(torch, lambda: kernel.launch(
                    params, state, slow, None, model.probe_pixel, 0, stream,
                    args), reps=100)
                plain = stream_us(torch, lambda: k1.plain_substep(
                    model, state, slow, geom=geom), reps=5)
                extra = 0 if gm is None else geometry_bytes(gm)
                b = bound(cells * (lrtp_bytes(model, slow) + extra),
                          cells * (lrtp_flops(model, slow, False)
                                   + (0 if gm is None
                                      else geometry_flops(gm))))
                regs, spills = lrtp_ptxas(ptx["lrtp_substep"], body, slow,
                                          gm is not None)
                check(spills == 0, f"{body}_substep{label} spills {spills}")
                name = f"{body}_substep{label}<SLOW={str(slow).lower()}>"
                print(f"  {name} {LRTP_SIZE}x{LRTP_SIZE} ({key}): {us:.3f} "
                      f"us/launch, plain {plain:.1f} us, bound "
                      f"{b[0] * 1e3:.3f} us ({b[1]}), {regs} registers, "
                      f"{spills} bytes spilled [{card}]", flush=True)
                e = kernel_entry(
                    name, "fib_tf_tpu_torch/csrc/br_substep.cu",
                    "fib_tf_tpu/ops/pallas_step.py:205",
                    launches.get(f"{body}_substep{label}", {}).get(
                        "slow" if slow else "frozen", 0),
                    errs[f"{body}_substep{label}"], us, plain, b)
                e["registers"], e["spill_bytes"] = regs, spills
                entries.append(e)
        vmodel = lrtp_model(m, key, height=128)
        vbase = seeded(vmodel, depth=DEPTH)
        vparams = bodies.pack_params(vmodel)
        pixel = k4.volume_probe_pixel(vmodel, DEPTH)
        vcells = DEPTH * 128 * LRTP_SIZE
        for slow in (True, False):
            state = clone(vbase)
            us = device_us(torch, lambda: k4.KERNELS[body].launch(
                vparams, state, slow, 1.0, None, pixel, 0, stream),
                reps=100)
            plain = stream_us(torch, lambda: k4.plain_volume_substep(
                vmodel, state, slow), reps=5)
            b = bound(vcells * lrtp_bytes(vmodel, slow),
                      vcells * lrtp_flops(vmodel, slow, True))
            regs, spills = lrtp_ptxas(ptx["lrtp_volume"], body, slow)
            check(spills == 0, f"{body}_volume spills {spills}")
            name = f"{body}_volume<SLOW={str(slow).lower()}>"
            print(f"  {name} {DEPTH}x128x{LRTP_SIZE} ({key}): {us:.3f} "
                  f"us/launch, plain {plain:.1f} us, bound {b[0] * 1e3:.3f} "
                  f"us ({b[1]}), {regs} registers, {spills} bytes spilled "
                  f"[{card}]", flush=True)
            e = kernel_entry(
                name, "fib_tf_tpu_torch/csrc/br_volume.cu",
                "fib_tf_tpu/ops/pallas_volume.py:499",
                launches.get(f"{body}_volume", {}).get(
                    "slow" if slow else "frozen", 0),
                errs[f"{body}_volume"], us, plain, b)
            e["registers"], e["spill_bytes"] = regs, spills
            entries.append(e)
    for label, res in runs.items():
        print(f"  {label} run: {1.0 / res.sim_seconds_per_wall_second:.6f} "
              f"wall-s/sim-s [{card}]", flush=True)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was not launched on a main "
                                 f"path")
    stamp("the end")
    return entries



# The four large models on the sharded paths (phases 49-53): kernel 3's
# csrc/large_block.cu and kernel 6's large bodies.  Phase 49's blocks are a
# 2048x2048 domain's (4x1: 532x2048 with K = 10; 2x2: 1044x1044), its state
# the initial one with V raised per cell by N(0, 1) mV and a band of
# columns depolarized to +20 mV across every shard, so that each block
# holds two fronts (no plain outer steps at 2048x2048: the plain tp06 step
# costs 63 ms at 512x512).  The checks: (label, body, configuration, het)
LARGE_SIZE = 2048
LARGE_CHECKS = {
    "court": ("court", dict(COURT_CFG, width=LARGE_SIZE, height=LARGE_SIZE),
              "chronic"),
    "court_ultra": ("court_ultra", dict(ULTRA_CFG, width=LARGE_SIZE,
                                        height=LARGE_SIZE), None),
    "lr1-skip": ("lr1", dict(LR1_CFG, width=LARGE_SIZE, height=LARGE_SIZE,
                             skip=True), None),
    "tp06-transmural-g_kr-skip": ("tp06", dict(
        LR1_CFG, width=LARGE_SIZE, height=LARGE_SIZE, skip=True,
        cell_type="transmural"), "g_kr"),
}
# (row, column) origins of the blocks: the 4x1 mesh's top, an interior and
# the bottom shard (column None), and a 2x2 corner shard
LARGE_ORIGINS = ((0, None), (512, None), (1536, None), (0, 0))
LARGE_GEOM_ORIGINS = ((512, None), (0, 0))
# phase 50's iso runs and the kernel='xla' comparison, phase 51's short
# runs, and phase 52's volumes (four z shards of 10 slices, K = 10)
LARGE_SHORT_MS = 50.0
LARGE_GEOM_MS = 20.0
LARGE_VOL_DEPTH = 40
LARGE_VOL_STEPS = {"court": 100, "court_ultra": 100, "lr1": 50, "tp06": 50}
LARGE_CELLS = {"court": "9CourtCellILb0EE", "court_ultra": "9CourtCellILb1EE",
               "lr1": "7Lr1Cell", "tp06": "8Tp06Cell"}


def large_ptxas(kernels, kind: str, body: str, slow: bool, geom=None):
    """(registers, spills) of large_block_kernel<Body, SLOW, GEOM> (`kind`
    'large_block_kernel') or volume_block_kernel<Body, SLOW> ('volume_block
    _kernel', `geom` None)."""
    flags = f"Lb{int(slow)}E" + ("" if geom is None else f"Lb{int(geom)}E")
    token = f"fibtorch{LARGE_CELLS[body]}E{flags}"
    found = [v for k, v in kernels.items() if kind in k and token in k]
    check(len(found) == 1, f"ptxas log has {len(found)} entries for "
                           f"{kind}<{body}, {slow}, {geom}>")
    return found[0]


def large_form_bound(model, cells: int, slow: bool, volume=False,
                     maps=None):
    """(bound_ms, bound_by) of one launch of a large body's form on
    `cells` cells: court_bound for the Courtemanche bodies, lrtp_bytes /
    lrtp_flops (and a GEOM entry's maps) for Luo-Rudy and tp06."""
    if model.name.startswith("court"):
        return court_bound(model, cells, slow, volume, maps)
    extra_b = 0 if maps is None else geometry_bytes(maps)
    extra_f = 0 if maps is None else geometry_flops(maps)
    return bound(cells * (lrtp_bytes(model, slow) + extra_b),
                 cells * (lrtp_flops(model, slow, volume) + extra_f))


def large_phases(torch, m, card, rng, lib_paths):
    """Phases 49-53: Courtemanche, Courtemanche-ultra, Luo-Rudy 1991 and
    tp06 on the sharded paths, kernel 3 (csrc/large_block.cu, isotropic and
    GEOM) and kernel 6's large bodies.  `m` carries the port's modules and
    main()'s launch counters, `lib_paths` the built libraries; returns
    their entries of the JSON line."""
    dev = torch.device("cuda")
    k1, k3, k6, st_ = m.cuda_step, m.cuda_block, m.cuda_volume_block, m.stencil
    bodies = m.bodies
    classes = {"court": m.Courtemanche, "court_ultra": m.CourtemancheUltra,
               "lr1": m.LuoRudy91, "tp06": m.TenTusscher06}
    errs, launches, runs, unequal = {}, {}, {}, {}
    t0 = time.perf_counter()

    def stamp(phase):
        print(f"  ({phase} starts {time.perf_counter() - t0:.1f} s into "
              f"phases 49-53)", flush=True)

    def note(entry, err):
        errs[entry] = max(errs.get(entry, 0.0), err)

    def count(entry, counts):
        old = launches.setdefault(entry, {"slow": 0, "frozen": 0})
        for kk in counts[entry]:
            old[kk] += counts[entry][kk]

    def model_of(key, **kw):
        body, cfg, het = LARGE_CHECKS[key]
        model = classes[body](m.SimConfig(**dict(cfg, **kw)))
        h, w = model.state_shape()
        if body == "lr1":
            model.g_si = LR1_GSI
        if het == "chronic":
            plane = np.zeros((h, w), np.float32)
            plane[:, :w // 2] = 1.0
            model.set_het(chronic=plane)
        elif het == "g_kr":
            model.set_het(g_kr=np.linspace(0.2, 1.0, w, dtype=np.float32)[
                None].repeat(h, 0))
        return model

    def banded(model, depth=None):
        """The initial state on the card, V raised per cell by N(0, 1) mV
        and a band of columns (or, in a volume, of slices too) at +20 mV;
        a volume extrudes it over `depth` with per-cell noise."""
        st = model.initial_state()
        h, w = model.state_shape()
        st["V"] = st["V"] + rng.normal(0.0, 1.0, (h, w)).astype(np.float32)
        st["V"][:, int(0.44 * w):int(0.54 * w)] = 20.0
        base = m.interop.state_from_numpy(st, dev)
        if depth is not None:
            base = {k: v[None].repeat(depth, 1, 1).contiguous()
                    for k, v in base.items()}
            base["V"] += torch.randn(base["V"].shape, device=dev,
                                     generator=torch.Generator(dev)
                                     .manual_seed(int(rng.integers(1 << 30))))
        return base

    def window(full, rows, cols):
        return {k: v[rows][:, cols].contiguous() for k, v in full.items()}

    def block_geom(model, origin):
        """(two_d, rstart, cstart, row and column indices) of the block of
        `origin`, its ghosts wrapped round the domain."""
        h, w = model.state_shape()
        k = model.dt_per_step
        two_d = origin[1] is not None
        h_own, w_own = (h // 2, w // 2) if two_d else (h // 4, w)
        rstart = origin[0] - k
        cstart = origin[1] - k if two_d else 0
        eh, ew = k3.block_shape(h_own, w_own, k, two_d)
        rows = torch.arange(rstart, rstart + eh, device=dev) % h
        cols = torch.arange(cstart, cstart + ew, device=dev) % w
        return two_d, rstart, cstart, rows, cols

    def check_bit_equal(name, got, want, entry):
        n = unequal_cells(got, want)
        unequal[entry] = unequal.get(entry, 0) + n
        print(f"    {name}: {n} cells not bit-equal to plain", flush=True)
        check(n == 0, f"{name}: {n} cells differ from the plain version, "
                      f"which the large bodies equal bit for bit")

    annulus = court_annulus(st_, LARGE_SIZE, COURT_HOLE * 4)
    fiber = st_.fiber_tensor(np.deg2rad(FIBER_DEG), FIBER_RATIO)

    # -- phase 49 ---------------------------------------------------------------
    stamp("phase 49")
    print(f"phase 49: kernel 3's large bodies (csrc/large_block.cu) vs "
          f"plain_block_step at {LARGE_SIZE}x{LARGE_SIZE}: one outer step of "
          f"a 4x1 shard's 532x{LARGE_SIZE} block (the top, an interior and "
          f"the bottom shard) and a 2x2 shard's 1044x1044 block, and under "
          f"the annulus with fibers (an interior 4x1 shard and the 2x2 "
          f"one); every plane and the probe at rtol {RTOL} / atol {ATOL}, "
          f"and the cells not bit-equal", flush=True)
    block_cases = {}
    for key in LARGE_CHECKS:
        model = model_of(key)
        body = bodies.cell_body(model).name
        full = banded(model)
        k = model.dt_per_step
        schedule = model.launch_schedule
        per_step = {"slow": sum(schedule),
                    "frozen": len(schedule) - sum(schedule)}
        for geometry, origins in ((False, LARGE_ORIGINS),
                                  (True, LARGE_GEOM_ORIGINS)):
            entry = f"{body}_block" + ("_geom" if geometry else "")
            for origin in origins:
                two_d, rstart, cstart, rows, cols = block_geom(model, origin)
                ext = window(full, rows, cols)
                maps = {}
                if geometry:
                    phase = torch.tensor(annulus, device=dev)
                    maps = dict(phase_ext=phase[rows][:, cols].contiguous())
                r, c = model.probe_pixel
                owns = (rstart + k <= r < rstart + len(rows) - k
                        and (not two_d or cstart + k <= c
                             < cstart + len(cols) - k))
                outs, probes = [], []
                m.reset_counts()
                for kernel in (True, False):
                    out = {kk: torch.zeros_like(v) for kk, v in ext.items()}
                    probe = torch.zeros(1, device=dev)
                    if kernel:
                        k3.make_block_step(model, two_d,
                                           fiber if geometry else None)(
                            ext, out, rstart, cstart,
                            probe if owns else None, **maps)
                    else:
                        k3.plain_block_step(
                            model, ext, out, rstart, cstart, two_d,
                            probe if owns else None, 0,
                            maps.get("phase_ext"),
                            fiber if geometry else None)
                    outs.append(out)
                    probes.append(probe)
                torch.cuda.synchronize()
                check_launched(m.read_counts(), entry, per_step,
                               f"{entry} block at {origin}")
                name = (f"{entry} ({key}) {len(rows)}x{len(cols)} block at "
                        f"{origin}")
                got = {kk: k3.centre(v, k, two_d) for kk, v in outs[0].items()}
                want = {kk: k3.centre(v, k, two_d)
                        for kk, v in outs[1].items()}
                note(entry, compare(name, got, want))
                compare_probes(name, probes[0], probes[1])
                check_bit_equal(name, got, want, entry)
        block_cases[key] = (model, full)

    # -- phase 50 ---------------------------------------------------------------
    stamp("phase 50")
    print(f"phase 50: examples/court_run.py's first model on a 4x1 mesh and "
          f"examples/court_ultra_run.py's run_small on a 2x2 mesh (four "
          f"shards on the card, 512x512, the annulus, 1000 ms) under 'auto' "
          f"(court_block_geom, court_ultra_block_geom), bit-equal to the "
          f"unsharded kernel-1 runs (\"ultra\" within rtol 1e-5); the first "
          f"{LARGE_SHORT_MS:.0f} ms of the court run against the sharded "
          f"kernel='xla' run; {LARGE_SHORT_MS:.0f} ms of each without "
          f"geometry on the other mesh shape (court_block, "
          f"court_ultra_block)", flush=True)

    def mesh_of(shape):
        return m.make_mesh(shape=shape, devices=["cuda:0"] * 4)

    def court_sim(body, cfg, hole, mesh, annulus=True):
        return court_annulus_sim(m, classes[body], cfg, hole, annulus,
                                 device="cuda", mesh=mesh,
                                 wide_halo=mesh is not None)

    def check_equal_runs(name, got, want):
        """A sharded run against the unsharded one: every plane and the
        "v" and "trend" streams bit-equal, "ultra" within rtol 1e-5."""
        same = {k: np.array_equal(got.state[k], want.state[k])
                for k in want.state}
        dv = float(np.abs(got.state["V"] - want.state["V"]).max())
        print(f"  {name}: final V max abs {dv:.4g} from the unsharded run; "
              f"planes not bit-equal: {[k for k, v in same.items() if not v]}"
              f"; crossings {got.cycle_lengths} vs {want.cycle_lengths}",
              flush=True)
        check(all(same.values()),
              f"{name}: the sharded run is not bit-equal to the unsharded "
              f"one")
        check(sorted(got.probes) == sorted(want.probes),
              f"{name}: probe streams {sorted(got.probes)} vs "
              f"{sorted(want.probes)}")
        for key in want.probes:
            if key == "ultra":
                check(np.allclose(got.probes[key], want.probes[key],
                                  rtol=1e-5, atol=0),
                      f"{name}: ultra differs past rtol 1e-5")
            else:
                check(np.array_equal(got.probes[key], want.probes[key]),
                      f"{name}: the {key!r} stream is not bit-equal")
        check(got.cycle_lengths == want.cycle_lengths,
              f"{name}: crossings {got.cycle_lengths} vs "
              f"{want.cycle_lengths}")

    for body, cfg_kw, hole, s2, shape, iso_shape in (
            ("court", COURT_CFG, COURT_HOLE, COURT_S2, (4,), (2, 2)),
            ("court_ultra", ULTRA_CFG, ULTRA_HOLE, ULTRA_S2, (2, 2), (4,))):
        cfg = m.SimConfig(**cfg_kw)
        out = {}
        for label, mesh in (("sharded", mesh_of(shape)), ("unsharded", None)):
            sim = court_sim(body, cfg, hole, mesh)
            check(sim.route == ("block" if mesh is not None else "substep"),
                  f"{body} {label} routes {sim.route!r}")
            m.reset_counts()
            res = out[label] = sim.simulate(schedule=[(s2, "s2")])
            counts = m.read_counts()
            if mesh is not None:
                entry = f"{body}_block_geom"
                check_launched(counts, entry, expected_launches(
                    sim.model, res.steps, shards=4),
                    f"the sharded {body} annulus run")
                count(entry, counts)
            check_run(res, (512, 512), COURT_CROSSINGS[body])
        check_equal_runs(f"{body} {'x'.join(map(str, mesh_of(shape).grid))} "
                         f"annulus run", out["sharded"], out["unsharded"])
        print(f"  {body} annulus run: "
              f"{1.0 / out['sharded'].sim_seconds_per_wall_second:.6f} "
              f"wall-s/sim-s sharded, "
              f"{1.0 / out['unsharded'].sim_seconds_per_wall_second:.6f} "
              f"unsharded [{card}]", flush=True)
        runs[f"{body} annulus, sharded"] = out["sharded"]
        short = cfg.replace(duration=LARGE_SHORT_MS)
        if body == "court":
            # the first LARGE_SHORT_MS against the sharded kernel='xla' run
            pre = {}
            for kernel in ("auto", "xla"):
                sim = court_sim(body, short.replace(kernel=kernel), hole,
                                mesh_of(shape))
                m.reset_counts()
                pre[kernel] = sim.simulate()
                counts = m.read_counts()
                if kernel == "xla":
                    check(sim.route == "plain" and all(
                        total_launches(c) == 0 for c in counts.values()),
                        "the sharded kernel='xla' court run launched a "
                        "kernel")
                else:
                    count(f"{body}_block_geom", counts)
            n = unequal_cells(pre["auto"].state, pre["xla"].state)
            dv = float(np.abs(pre["auto"].state["V"]
                              - pre["xla"].state["V"]).max())
            print(f"  court sharded {LARGE_SHORT_MS:.0f} ms vs kernel='xla': "
                  f"{n} cells not bit-equal, V max abs {dv:.4g}", flush=True)
            check(dv <= COURT_RUN_ATOL_MV,
                  f"the sharded court run ends {dv} mV from kernel='xla'")
        # the isotropic entry: no geometry, on the other mesh shape
        iso = {}
        for label, mesh in (("sharded", mesh_of(iso_shape)),
                            ("unsharded", None)):
            sim = court_sim(body, short, hole, mesh, annulus=False)
            m.reset_counts()
            iso[label] = sim.simulate()
            counts = m.read_counts()
            if mesh is not None:
                check_launched(counts, f"{body}_block", expected_launches(
                    sim.model, iso[label].steps, shards=4),
                    f"the sharded {body} run")
                count(f"{body}_block", counts)
        check_equal_runs(f"{body} {LARGE_SHORT_MS:.0f} ms on "
                         f"{'x'.join(map(str, mesh_of(iso_shape).grid))}",
                         iso["sharded"], iso["unsharded"])

    # -- phase 51 ---------------------------------------------------------------
    stamp("phase 51")
    print(f"phase 51: examples/lr1_spiral.py and examples/tp06_spiral.py "
          f"(skip on) at 512x512 on a 4x1 mesh under 'auto' (lr1_block, "
          f"tp06_block): the S1 wave to the cut, the cut, {LRTP_STAGE2_MS:.0f}"
          f" ms of stage 2, bit-equal to the unsharded kernel-1 runs; tp06 "
          f"with its transmural het planes and a g_kr plane for "
          f"{LRTP_STAGE2_MS:.0f} ms; both models under the annulus with "
          f"fibers on a 2x2 mesh for {LARGE_GEOM_MS:.0f} ms "
          f"(lr1_block_geom, tp06_block_geom)", flush=True)

    def lrtp_pair(label, make, entry, state=None, shape=(4,), geom=False):
        """`make()`'s model sharded under 'auto' and unsharded, from
        `state`, bit-equal; returns the sharded run."""
        out = {}
        for kind, mesh in (("sharded", mesh_of(shape)), ("unsharded", None)):
            model = make()
            sim = m.Simulation(model, device="cuda", mesh=mesh,
                               wide_halo=mesh is not None)
            if geom:
                sim.phase = court_annulus(st_, LRTP_SIZE, COURT_HOLE)
            sim.define()
            m.reset_counts()
            res = out[kind] = sim.simulate(state=state)
            counts = m.read_counts()
            if mesh is not None:
                check(sim.route == "block", f"{label} routes {sim.route}")
                check_launched(counts, entry, expected_launches(
                    model, res.steps, shards=4), f"{label} sharded")
                count(entry, counts)
        check_equal_runs(f"{label} on "
                         f"{'x'.join(map(str, mesh_of(shape).grid))}",
                         out["sharded"], out["unsharded"])
        return out["sharded"]

    for label, key, cut_ms in (
            ("lr1_spiral --skip", "lr1-skip", LR1_CUT_MS),
            ("tp06_spiral --skip", "tp06-epi-skip", TP06_CUT_MS)):
        body = LRTP_CHECKS[key][0]
        stage1 = lrtp_pair(f"{label} stage 1", lambda: lrtp_model(
            m, key, duration=float(cut_ms)), f"{body}_block")
        cut = {k: np.array(v) for k, v in stage1.state.items()}
        rest = classes[body](m.SimConfig(width=LRTP_SIZE, height=LRTP_SIZE,
                                         dt=0.02, duration=1)
                             ).initial_state(s1=False)
        for k in cut:
            cut[k][LRTP_SIZE // 2:, :] = rest[k][LRTP_SIZE // 2:, :]
        stage2 = lrtp_pair(f"{label} stage 2", lambda: lrtp_model(
            m, key, duration=LRTP_STAGE2_MS), f"{body}_block", cut)
        active = float((stage2.state["V"] > -40.0).mean())
        print(f"  {label}: stage 1 crossings {stage1.cycle_lengths}, active "
              f"fraction after stage 2 {active:.3f}, "
              f"{1.0 / stage1.sim_seconds_per_wall_second:.6f} wall-s/sim-s "
              f"sharded in stage 1 [{card}]", flush=True)
        check(0.0 < active < 1.0, f"{label}: no free wave end after the cut")
        runs[f"{label}, sharded"] = stage1
    runs["tp06 transmural + g_kr, sharded"] = lrtp_pair(
        "tp06 transmural + g_kr", lambda: lrtp_model(
            m, "tp06-transmural-g_kr-scaled", duration=LRTP_STAGE2_MS),
        "tp06_block")
    for key in ("lr1-skip", "tp06-transmural-skip"):
        body = LRTP_CHECKS[key][0]
        runs[f"{key} annulus+fibers, sharded"] = lrtp_pair(
            f"{key} annulus+fibers", lambda: lrtp_model(
                m, key, duration=LARGE_GEOM_MS,
                fiber_angle=np.deg2rad(FIBER_DEG), fiber_ratio=FIBER_RATIO),
            f"{body}_block_geom", shape=(2, 2), geom=True)

    # -- phase 52 ---------------------------------------------------------------
    stamp("phase 52")
    print(f"phase 52: kernel 6's large bodies: one group of each entry on a "
          f"shard's 30x128x512 block (10 slices, K = 10) vs "
          f"plain_volume_block_step, bit-equal on the centre; run_volume at "
          f"{LARGE_VOL_DEPTH}x128x512 on four z shards under 'auto' against "
          f"the unsharded kernel-4 run, bit-equal ({LARGE_VOL_STEPS} outer "
          f"steps)", flush=True)
    vol_cases = {}
    for key, vkw in (("court", dict(height=128, width=512, dt=0.05)),
                     ("court_ultra", dict(height=128, width=512, dt=0.05)),
                     ("lr1-skip", dict(height=128, width=512)),
                     ("tp06-transmural-g_kr-skip",
                      dict(height=128, width=512))):
        vmodel = model_of(key, **vkw)
        body = bodies.cell_body(vmodel).name
        entry = f"{body}_volume_block"
        depth, k = LARGE_VOL_DEPTH, vmodel.dt_per_step
        vbase = banded(vmodel, depth)
        zstart = 10
        idx = torch.arange(zstart, zstart + 30, device=dev)
        block = {kk: v[idx].contiguous() for kk, v in vbase.items()}
        probes = [torch.zeros(1, device=dev) for _ in range(2)]
        m.reset_counts()
        got = clone(block)
        got, _ = k6.make_volume_block_step(vmodel, 30, depth)(
            got, torch.empty_like(got["V"]), zstart, probes[0], 0,
            depth // 2 - zstart)
        want = k6.plain_volume_block_step(vmodel, clone(block), zstart,
                                          depth, probe=probes[1],
                                          probe_slice=depth // 2 - zstart)
        torch.cuda.synchronize()
        schedule = vmodel.launch_schedule
        check_launched(m.read_counts(), entry,
                       {"slow": sum(schedule),
                        "frozen": len(schedule) - sum(schedule)},
                       f"{entry} group")
        name = f"{entry} ({key}) 30x128x512 block at slice {zstart}"
        gc = {kk: v[k:-k] for kk, v in got.items()}
        wc = {kk: v[k:-k] for kk, v in want.items()}
        note(entry, compare(name, gc, wc))
        check_bit_equal(name, gc, wc, entry)
        compare_probes(name, probes[0], probes[1])
        vol_cases[key] = (vmodel, block, zstart)
        # the main path
        state = {kk: v.cpu().numpy() for kk, v in vbase.items()}
        n_steps = LARGE_VOL_STEPS[body]
        vol = {}
        for kind, mesh in (("sharded", mesh_of((4,))), ("unsharded", None)):
            m.reset_counts()
            t = time.perf_counter()
            vol[kind] = m.run_volume(
                vmodel, depth, n_steps, state=state, mesh=mesh,
                wide_halo=mesh is not None, device="cuda")
            wall = time.perf_counter() - t
            counts = m.read_counts()
            if mesh is not None:
                check_launched(counts, entry, expected_launches(
                    vmodel, n_steps, shards=4), f"the sharded {key} "
                                                    f"volume")
                count(entry, counts)
            else:
                check_launched(counts, f"{body}_volume", expected_launches(
                    vmodel, n_steps), f"the unsharded {key} volume")
            print(f"  {key} run_volume {kind}: {wall:.3f} s for {n_steps} "
                  f"outer steps [{card}]", flush=True)
        same = [kk for kk in vol["unsharded"][0]
                if not np.array_equal(vol["sharded"][0][kk],
                                      vol["unsharded"][0][kk])]
        print(f"  {key} volume: planes not bit-equal to kernel 4: {same}; "
              f"probes bit-equal: "
              f"{np.array_equal(vol['sharded'][1], vol['unsharded'][1])}",
              flush=True)
        check(not same and np.array_equal(vol["sharded"][1],
                                          vol["unsharded"][1]),
              f"the sharded {key} volume is not bit-equal to kernel 4's")

    # -- phase 53 ---------------------------------------------------------------
    stamp("phase 53")
    print(f"phase 53: device time of every kernel-3 and kernel-6 entry of "
          f"the large bodies, per launch and per outer step (kernel 3 on "
          f"the interior 4x1 shard's 532x{LARGE_SIZE} block, kernel 6 on "
          f"the 30x128x512 block), beside its plain version, its bound and "
          f"its registers [{card}]", flush=True)
    entries = []
    stream = torch.cuda.current_stream()
    ptx = {lib: ptxas_kernels(lib_paths[lib].with_name(
        lib_paths[lib].name + ".log").read_text())
        for lib in ("court_block", "lrtp_block", "court_volume_block",
                    "lrtp_volume_block")}
    for key, (model, full) in block_cases.items():
        body = bodies.cell_body(model).name
        lib = bodies.BODIES[body].library.name("block")
        params = bodies.pack_params(model)
        schedule = model.launch_schedule
        k = model.dt_per_step
        two_d, rstart, cstart, rows, cols = block_geom(model, (512, None))
        ext = window(full, rows, cols)
        eh, ew = len(rows), len(cols)
        gm = bodies.GeometryMaps(model.state_shape(), annulus, fiber)
        for geometry in (False, True):
            entry = f"{body}_block" + ("_geom" if geometry else "")
            kernel = (k3.GEOM_KERNELS if geometry else k3.KERNELS)[body]
            phase_ext = (torch.tensor(annulus, device=dev)[rows][:, cols]
                         .contiguous() if geometry else None)
            fib = fiber if geometry else None
            args = (bodies.kernel_geometry_args(phase_ext, None, fib)
                    if geometry else ())
            geom = k3.block_geometry(k3.global_rows(rstart, eh, dev),
                                     model.cfg.height, None, None, phase_ext,
                                     fib)
            out = clone(ext)
            step_us = device_us(torch, lambda: kernel.step(
                params, schedule, ext, out, rstart, cstart, k, two_d,
                model.cfg.height, model.cfg.width, None, model.probe_pixel,
                0, stream, args), reps=10)
            step_plain = stream_us(torch, lambda: k3.plain_block_step(
                model, ext, out, rstart, cstart, two_d, None, 0, phase_ext,
                fib), reps=2)
            # launch s of the step computes rows [s + 1, ext_h - 1 - s)
            cells = (eh - 2) * ew
            step_b, done = 0.0, 0
            for slow in schedule:
                step_b += large_form_bound(
                    model, (eh - 2 - 2 * done) * ew, slow,
                    maps=gm if geometry else None)[0]
                done += int(bodies.BODIES[body].writes_potential(slow))
            for slow in sorted(set(schedule)):
                state = clone(ext)
                v_out = (torch.empty_like(state["V"])
                         if bodies.BODIES[body].writes_potential(slow)
                         else None)
                us = device_us(torch, lambda: kernel.launch(
                    params, slow, state["V"], v_out, state, state, rstart,
                    cstart, k, two_d, model.cfg.height, model.cfg.width, 0,
                    False, None, model.probe_pixel, 0, stream.cuda_stream,
                    args), reps=50)
                plain = stream_us(torch, lambda: k1.plain_substep(
                    model, state, slow, geom=geom), reps=2)
                b = large_form_bound(model, cells, slow,
                                     maps=gm if geometry else None)
                regs, spills = large_ptxas(ptx[lib], "large_block_kernel",
                                           body, slow, geometry)
                check(spills == 0, f"{entry} spills {spills}")
                name = f"{entry}<SLOW={str(slow).lower()}>"
                print(f"  {name} {eh}x{ew} ({key}): {us:.3f} us/launch, plain "
                      f"{plain:.1f} us, bound {b[0] * 1e3:.3f} us ({b[1]}); "
                      f"outer step ({len(schedule)} launches) {step_us:.3f} "
                      f"us, plain {step_plain:.1f} us, bound "
                      f"{step_b * 1e3:.3f} us; {regs} registers, {spills} "
                      f"bytes spilled [{card}]", flush=True)
                e = kernel_entry(
                    name, "fib_tf_tpu_torch/csrc/large_block.cu",
                    "fib_tf_tpu/ops/pallas_tiled.py:202",
                    launches.get(entry, {}).get(
                        "slow" if slow else "frozen", 0),
                    errs[entry], us, plain, b)
                e.update(registers=regs, spill_bytes=spills,
                         step_ms=step_us / 1e3, step_plain_ms=step_plain / 1e3,
                         step_bound_ms=step_b,
                         launches_per_step=len(schedule),
                         unequal_cells=unequal.get(entry, 0))
                entries.append(e)
    for key, (vmodel, block, zstart) in vol_cases.items():
        body = bodies.cell_body(vmodel).name
        lib = bodies.BODIES[body].library.name("volume_block")
        entry = f"{body}_volume_block"
        kernel = k6.KERNELS[body]
        params = bodies.pack_params(vmodel)
        schedule = vmodel.launch_schedule
        k, depth = vmodel.dt_per_step, LARGE_VOL_DEPTH
        step = k6.make_volume_block_step(vmodel, 30, depth)
        state = clone(block)
        spare = torch.empty_like(state["V"])
        step_us = device_us(torch, lambda: step(state, spare, zstart),
                            reps=10)
        geom = k6.zblock_geometry(k6.global_slices(zstart, 30, dev), depth)
        step_plain = stream_us(torch, lambda: k6.plain_volume_block_step(
            vmodel, state, zstart, depth), reps=2)
        plane_cells = 128 * 512
        step_b, done = 0.0, 0
        for slow in schedule:
            step_b += large_form_bound(vmodel, (28 - 2 * done) * plane_cells,
                                       slow, volume=True)[0]
            done += int(bodies.BODIES[body].writes_potential(slow))
        for slow in sorted(set(schedule)):
            state = clone(block)
            v_out = (torch.empty_like(state["V"])
                     if bodies.BODIES[body].writes_potential(slow)
                     else None)
            pixel = (min(vmodel.probe_pixel[0], 127), vmodel.probe_pixel[1])
            us = device_us(torch, lambda: kernel.launch(
                params, state, v_out, slow, 1.0, zstart, depth, 1, 29, None,
                (0,) + pixel, 0, stream.cuda_stream), reps=50)
            plain = stream_us(torch, lambda: k1.plain_substep(
                vmodel, state, slow, geom=geom), reps=2)
            b = large_form_bound(vmodel, 28 * plane_cells, slow, volume=True)
            regs, spills = large_ptxas(ptx[lib], "volume_block_kernel", body,
                                       slow)
            check(spills == 0, f"{entry} spills {spills}")
            name = f"{entry}<SLOW={str(slow).lower()}>"
            print(f"  {name} 30x128x512 ({key}): {us:.3f} us/launch, plain "
                  f"{plain:.1f} us, bound {b[0] * 1e3:.3f} us ({b[1]}); group "
                  f"({len(schedule)} launches) {step_us:.3f} us, plain "
                  f"{step_plain:.1f} us, bound {step_b * 1e3:.3f} us; {regs} "
                  f"registers, {spills} bytes spilled [{card}]", flush=True)
            e = kernel_entry(
                name, "fib_tf_tpu_torch/csrc/br_volume_block.cu",
                "fib_tf_tpu/ops/pallas_volume.py:397",
                launches.get(entry, {}).get("slow" if slow else "frozen", 0),
                errs[entry], us, plain, b)
            e.update(registers=regs, spill_bytes=spills,
                     step_ms=step_us / 1e3, step_plain_ms=step_plain / 1e3,
                     step_bound_ms=step_b, launches_per_step=len(schedule),
                     unequal_cells=unequal.get(entry, 0))
            entries.append(e)
    for label, res in runs.items():
        print(f"  {label} run: {1.0 / res.sim_seconds_per_wall_second:.6f} "
              f"wall-s/sim-s [{card}]", flush=True)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was not launched on a main "
                                 f"path")
    stamp("the end")
    return entries


if __name__ == "__main__":
    main()
