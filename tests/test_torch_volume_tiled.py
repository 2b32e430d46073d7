"""The tiled volume kernel's plan (ops/cuda_volume_tiled.py tile_plan) on
the CPU: its shared memory, tiles and ring slots at many depths, and a
torch emulation of the kernel's z-wavefront (csrc/br_volume_tiled.cu:
tile_plan's tiles, walk, levels, ring slots and copies, with small tiles
forced) held bit for bit against plain_volume_step; and the plain tiled
step against the JAX tiled volume kernel (interpret mode) past depth 18."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fib_tf_tpu.models.beeler_reuter as jbr
import fib_tf_tpu_torch.models.beeler_reuter as tbr
from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu.ops.pallas_volume import make_tiled_volume_step
from fib_tf_tpu_torch import interop
from fib_tf_tpu_torch.config import SimConfig
from fib_tf_tpu_torch.engine import volume
from fib_tf_tpu_torch.models.base import Geometry
from fib_tf_tpu_torch.ops import cuda_volume
from fib_tf_tpu_torch.ops import cuda_volume_tiled as cvt
from fib_tf_tpu_torch.ops.bodies import CELL_PLANES
from fib_tf_tpu_torch.ops.cuda_tiled import tile_spans
from test_torch_fixtures import one_torch_thread  # noqa: F401

# the reference's own kernel-vs-XLA bound for volumes
# (tests/test_volume.py:319-344, 463-475)
VOLUME_TOL = dict(rtol=2e-5, atol=2e-5)


def cfg(**kw):
    base = dict(width=24, height=16, dt=0.1, diff=0.809, duration=1,
                cheby=True, skip=True)
    base.update(kw)
    return SimConfig(**base)


def seeded_volume(model, depth, seed):
    """The extruded initial state perturbed per cell from a seed."""
    rng = np.random.RandomState(seed)
    st = volume.volume_state(model, depth)
    shape = st["V"].shape
    st["V"] = st["V"] + rng.normal(0, 2.0, shape).astype(np.float32)
    for g in tbr.GATES:
        st[g] = np.clip(st[g] * rng.uniform(0.9, 1.1, shape),
                        1e-5, 0.99999).astype(np.float32)
    st["C"] = (st["C"] * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
    return st


# -- the plan ------------------------------------------------------------------------

PLAN_SHAPES = [(d, h, w) for d in (3, 8, 18, 19, 32, 200)
               for h, w in ((512, 512), (67, 131), (9, 12))]


def _label_stream(plan):
    """Run the kernel's stream for every block with labels in place of
    values: each ring slot holds the (tile, slice) last written into it,
    and every read checks that its slot still holds the slice it wants.
    Copies land at the start of their step (the earliest they can).
    Returns the (tile, slice) pairs written out."""
    written = []
    for block in range(len(plan.walk)):
        vin = [None] * cvt.V_IN_SLOTS
        vring = [[None] * cvt.V_SLOTS for _ in range(cvt.MAX_SUB - 1)]
        planes = [None] * cvt.PLANE_SLOTS

        def copy(c):
            if c.what == "planes":
                planes[plan.plane_slot(c.p)] = (c.tile, c.z)
            else:
                vin[plan.v_in_slot(c.p)] = (c.tile, c.z)

        for c in plan.first_copies(block):
            copy(c)
        for t, levels, copies in plan.steps(block):
            for c in copies:
                copy(c)
            for lv in levels:
                assert planes[plan.plane_slot(lv.p)] == (lv.tile, lv.z)
                for zr in plan.z_reads(lv.z):
                    pr = lv.p - lv.z + zr
                    if lv.s == 0:
                        got = vin[plan.v_in_slot(pr)]
                    else:
                        got = vring[lv.s - 1][plan.v_slot(pr)]
                    assert got == (lv.tile, zr), (lv, zr, got)
                if lv.s < plan.n_sub - 1:
                    vring[lv.s][plan.v_slot(lv.p)] = (lv.tile, lv.z)
                else:
                    written.append((lv.tile, lv.z))
    return written


@pytest.mark.parametrize("dhw", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tile_plan_fits_owns_every_cell_and_never_aliases(dhw):
    """Any depth fits the same shared memory; on any grid the tiles'
    interiors cover the plane exactly once; over every block's stream no
    ring slot is overwritten while its slice is live, and every (tile,
    slice) is written out once."""
    d, h, w = dhw
    for n_blocks in (1, 7, 132):
        plan = cvt.tile_plan(d, h, w, 5, n_blocks=n_blocks)
        assert plan.smem_bytes == cvt.smem_bytes() <= cvt.SMEM_BYTES_MAX
        owned = np.zeros((h, w), np.int32)
        k = plan.n_sub
        for r0, c0, eh, ew in plan.tiles:
            assert eh <= plan.tile[0] and ew <= plan.tile[1]
            owned[r0 + k:r0 + eh - k, c0 + k:c0 + ew - k] += 1
        assert (owned == 1).all()
        written = _label_stream(plan)
        assert sorted(written) == sorted(
            itertools.product(range(len(plan.tiles)), range(d)))


def test_tile_plan_of_the_main_volume():
    """8x512x512 on 132 SMs: 30 x 32 extended tiles, 218 KB of shared
    memory; as few as fit would be 26 x 24 tiles of 19-20 x 21-22 (4.73
    waves), so the rows take 27 tiles of 18-19 (648 tiles, 4.91 waves).
    A block of five tiles runs 40 + 4 pipeline steps: its levels cross
    from one tile into the next, the barrier before a level that starts a
    tile's slice 0."""
    plan = cvt.tile_plan(8, 512, 512, 5)
    assert cvt.smem_bytes() == 222720
    assert len(plan.col_spans) == 24 and len(plan.row_spans) == 27
    assert len(tile_spans(512, 30 - 10)) == 26
    assert plan.tiles[0] == (-5, -5, 29, 32)
    assert plan.walk[0] == [0, 132, 264, 396, 528]
    steps = list(plan.steps(0))
    assert len(steps) == 44
    assert [(lv.s, lv.tile, lv.z) for lv in steps[0][1]] == [(0, 0, 0)]
    assert [(lv.s, lv.tile, lv.z, lv.barrier) for lv in steps[9][1]] == [
        (0, 132, 1, False), (1, 132, 0, True), (2, 0, 7, True),
        (3, 0, 6, True), (4, 0, 5, True)]
    assert plan.z_reads(0) == (1, 1, 1) and plan.z_reads(7) == (6, 6, 6)
    assert sum(plan.clamp_free(t) for t in plan.tiles) == 25 * 22
    # 32x128x512: 7 x 24 tiles would take 2 waves for 1.27; 11 x 24 fill
    # the same 2 waves with tiles of 11-12 rows
    deep = cvt.tile_plan(32, 128, 512, 5)
    assert len(deep.row_spans) == 11 and len(deep.tiles) == 2 * 132


def test_tile_plan_refusals():
    with pytest.raises(ValueError, match="D, H, W"):
        cvt.tile_plan(2, 64, 64, 5)
    with pytest.raises(ValueError, match="substeps"):
        cvt.tile_plan(8, 64, 64, 6)
    with pytest.raises(ValueError, match="substeps"):
        cvt.tile_plan(3, 9, 9, 0)
    with pytest.raises(ValueError, match="interior"):
        cvt.tile_plan(8, 64, 64, 5, tile=(10, 32))


def test_any_depth_builds_a_step():
    for depth in (3, 19, 200):
        step = cvt.make_tiled_volume_step(tbr.BeelerReuter(cfg()), depth)
        assert callable(step)


# -- the emulation of the kernel's wavefront --------------------------------------------


def _region(tile, lo, hi_pad, h, w):
    """Local rows and columns [lo, U - hi_pad) of a tile's used extent U
    that lie in the domain, as index tensors (local a, b; global gi, gj)."""
    r0, c0, eh, ew = tile
    a = torch.arange(max(lo, -r0), min(eh - hi_pad, h - r0))
    b = torch.arange(max(lo, -c0), min(ew - hi_pad, w - c0))
    a, b = torch.meshgrid(a, b, indexing="ij")
    return a.reshape(-1), b.reshape(-1), r0 + a.reshape(-1), c0 + b.reshape(-1)


def emulate(model, state, plan, dz_ratio):
    """One outer step as br_volume_tiled.cu runs it, on CPU tensors: every
    block walks its tiles; per step the copies of plan.copies land, and
    each level reads its input V from its ring slots (in the plane from
    the step's start unless a barrier precedes it, as in the kernel; its
    z neighbours at the clamped in-plane point, live), updates its ring
    cells and its slice's planes and writes level s+1's ring or the
    output.  The cell update is model.solve on full-volume tensors holding
    those cells, so each cell's arithmetic is the plain path's."""
    d, h, w = plan.depth, plan.height, plan.width
    eh_max, ew_max = plan.tile
    schedule = model.launch_schedule
    base = {k: v.clone() for k, v in state.items()}
    out = {k: torch.full_like(v, float("nan")) for k, v in state.items()}
    for block in range(len(plan.walk)):
        vin = torch.zeros(cvt.V_IN_SLOTS, eh_max, ew_max)
        vring = torch.zeros(cvt.MAX_SUB - 1, cvt.V_SLOTS, eh_max, ew_max)
        planes = torch.zeros(cvt.PLANE_SLOTS, len(CELL_PLANES), eh_max,
                             ew_max)

        def copy(c):
            tile = plan.tiles[c.tile]
            if c.what == "planes":
                a, b, gi, gj = _region(tile, 1, 1, h, w)
                for i, k in enumerate(CELL_PLANES):
                    planes[plan.plane_slot(c.p), i, a, b] = (
                        state[k][c.z, gi, gj])
            else:
                a, b, gi, gj = _region(tile, 0, 0, h, w)
                vin[plan.v_in_slot(c.p), a, b] = state["V"][c.z, gi, gj]

        for c in plan.first_copies(block):
            copy(c)
        for t, levels, copies in plan.steps(block):
            for c in copies:
                copy(c)
            at_start = (vin.clone(), vring.clone())
            for lv in levels:
                _level(model, plan, lv, schedule[lv.s], dz_ratio,
                       (vin, vring), at_start, planes[plan.plane_slot(lv.p)],
                       out, base)
    return out


def _level(model, plan, lv, slow, dz_ratio, live, at_start, planes, out,
           base):
    h, w = plan.height, plan.width
    s, z = lv.s, lv.z
    tile = plan.tiles[lv.tile]
    r0, c0 = tile[0], tile[1]
    a, b, gi, gj = _region(tile, s + 1, s + 1, h, w)

    def ring(rings, zr):
        vin, vring = rings
        pr = lv.p - z + zr
        if s == 0:
            return vin[plan.v_in_slot(pr)]
        return vring[s - 1, plan.v_slot(pr)]

    zu, zc, zd = plan.z_reads(z)
    pc = ring(live if lv.barrier else at_start, zc)
    pu, pd = ring(live, zu), ring(live, zd)
    rn = gi.sub(1).clamp(1, h - 2) - r0
    rc = gi.clamp(1, h - 2) - r0
    rs = gi.add(1).clamp(1, h - 2) - r0
    bw = gj.sub(1).clamp(1, w - 2) - c0
    bc = gj.clamp(1, w - 2) - c0
    be = gj.add(1).clamp(1, w - 2) - c0
    v0 = pc[rc, bc]
    planar = (pc[rn, bc] + pc[rs, bc] + pc[rc, bw] + pc[rc, be]
              + 0.5 * (pc[rn, bw] + pc[rs, bw] + pc[rn, be] + pc[rs, be])
              - 6.0 * v0)
    lap = planar + (2.0 * dz_ratio) * ((pu[rc, bc] - 2.0 * v0) + pd[rc, bc])
    full = {k: v.clone() for k, v in base.items()}
    v0_full = full["V"].clone()
    lap_full = torch.zeros_like(v0_full)
    v0_full[z, gi, gj] = v0
    lap_full[z, gi, gj] = lap
    for i, k in enumerate(CELL_PLANES):
        full[k][z, gi, gj] = planes[i, a, b]
    res = model.solve(full, Geometry(laplace=lambda x: lap_full,
                                     enforce_boundary=lambda x: v0_full),
                      n=model.slow_n if slow else 0)
    for i, k in enumerate(CELL_PLANES):
        # the frozen body leaves the slow gates as they are
        if slow or k in ("C", "m", "h"):
            planes[i, a, b] = res[k][z, gi, gj]
    v = res["V"][z, gi, gj]
    if s < plan.n_sub - 1:
        live[1][s, plan.v_slot(lv.p), a, b] = v
        return
    out["V"][z, gi, gj] = v
    for k in CELL_PLANES:
        out[k][z, gi, gj] = res[k][z, gi, gj]


# (depth, height, width, forced tile, persistent blocks): a volume smaller
# than one tile, ragged tiles, and depths past the old kernel's 18 with
# clamp-free tiles among edge tiles and several tiles per block
EMULATED = [((3, 12, 14), (12, 12), 5), ((5, 67, 131), (24, 32), 7),
            ((19, 30, 40), (16, 20), 3), ((33, 20, 24), (14, 18), 4)]


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dhw,tile,n_blocks", EMULATED,
                         ids=["x".join(map(str, e[0])) for e in EMULATED])
def test_emulated_wavefront_equals_plain_volume_step(dhw, tile, n_blocks,
                                                     skip):
    """Tolerance 0: the emulation's every cell update is the plain path's
    arithmetic on the same operands, so any wrong slot, slice, clamp or
    missing barrier shows as a difference."""
    d, h, w = dhw
    model = tbr.BeelerReuter(cfg(height=h, width=w, skip=skip))
    st = interop.state_from_numpy(seeded_volume(model, d, seed=d), "cpu")
    plan = cvt.tile_plan(d, h, w, model.dt_per_step, tile=tile,
                         n_blocks=n_blocks)
    if d > 3:
        assert any(plan.clamp_free(t) for t in plan.tiles)
    assert len(plan.tiles) > n_blocks
    got = emulate(model, st, plan, dz_ratio=0.5)
    want = cuda_volume.plain_volume_step(
        model, {k: v.clone() for k, v in st.items()}, dz_ratio=0.5)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -- against the JAX tiled volume kernel past depth 18 ---------------------------------


def test_plain_tiled_volume_step_matches_jax_past_depth_18():
    """20x32x128, the JAX kernel at tile_rows=16 (two row tiles, interpret
    mode), 1 outer step, skip on: the depth the old kernel refused."""
    c = cfg(height=32, width=128)
    jm = jbr.BeelerReuter(JaxSimConfig(**dataclasses.asdict(c)))
    tm = tbr.BeelerReuter(c)
    st = seeded_volume(tm, 20, seed=3)
    jstep = make_tiled_volume_step(jm, 20, 16, interpret=True)
    step = cvt.make_tiled_volume_step(tm, 20)
    want = jstep({k: jnp.asarray(v) for k, v in st.items()})
    probe = torch.zeros(1)
    got = step(interop.state_from_numpy(st, "cpu"), probe, 0)
    pixel = cuda_volume.volume_probe_pixel(tm, 20)
    ref = (float(want["V"][pixel]) - jm.min_v) / (jm.max_v - jm.min_v)
    assert abs(float(probe[0]) - ref) <= 2e-5
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **VOLUME_TOL)
