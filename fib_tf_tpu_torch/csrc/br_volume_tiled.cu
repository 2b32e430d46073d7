// One whole Beeler-Reuter outer step (all five substeps) of a [D, H, W]
// volume per launch on Hopper (sm_90a): in-plane tiles, temporally blocked
// with a halo of one ring per substep, each streamed through z as a
// wavefront of the substep levels.
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_volume.py::
// make_tiled_volume_step, which run_volume (engine/volume.py) runs past the
// 32 MB whole-volume envelope.  That kernel DMAs `tile_rows + 2K` full-width
// rows of every z-slice into VMEM, so the z coupling is complete inside the
// block.  No SM holds a full-depth column of eight planes, so this kernel
// never holds the depth: it walks it.  It computes the same function as
// five launches of br_volume.cu, and the per-cell arithmetic is the same
// code (br_cell.cuh, unchanged).
//
// The wavefront.  K = n_sub substep levels.  A block's in-plane tiles
// form one stream of slices, position p = D i + z for slice z of its i-th
// tile.  At pipeline step t level s updates position t - s on the in-plane
// ring [s+1, U-2-s] of its tile's used extent U, so the levels run on
// consecutive positions and cross from one tile into the next without a
// fill or a drain: a block of n tiles runs n D + K - 1 steps.  A level's
// inputs are level s-1's V (level 0: the loaded V) at slices clamp(z-1),
// clamp(z), clamp(z+1) of the same tile, with clamp(k) = min(max(k, 1),
// D-2): the cell reads its own v0 and the in-plane stencil at V[clamp(z),
// ...] and its z neighbours at the same in-plane point, as
// br_volume_cell.cuh does.  So each level keeps a ring of three positions
// of its input V in shared memory (the loaded V four: the fourth is being
// copied), and a slice is in flight from the step that copies it until
// level K-1 writes it out K-1 steps later.  Slices 0 and D-1 are computed
// at every level but never read by another slice; in the plane the same
// holds for the domain's edge rows and columns.
//
// What lives where, per in-plane cell of the extended tile, all in shared
// memory.  V's rings: 4 + 3 (K-1) floats.  The seven per-cell planes: a
// ring of K + 1 positions (the K in flight and the one being copied),
// 7 (K + 1) floats; each thread reads and writes only its own cells' planes,
// so they need no barrier.  58 floats per cell at K = 5: a 30 x 32 tile
// takes 218 KB and one 960-thread block per SM.  Registers hold only the
// cell body: keeping the fast planes C, m, h in registers, one set per
// slice in flight, spilled at 64 registers a thread and ran slower
// (PERF.md, Findings).  Ring slots are positions modulo the ring's size.
//
// The plan.  Each step's work (every level's tile, slice, ring offsets and
// barrier, and the step's copies) is one small table in shared memory,
// computed by warp 0 during the step before (row 0 of a tile takes no
// level) and double-buffered, so the threads read it instead of dividing
// positions by D each level.
//
// Barriers.  A level reads other threads' cells only in the plane at
// slice clamp(z), which level s-1 wrote at an earlier step except where
// clamp(z) > z, at z = 0.  Its z neighbours are its own cell's.  So in a
// tile that lies one cell inside every in-plane domain edge (clamp-free)
// the K levels of a step run back to back behind one barrier per step,
// plus one before a level on a slice 0.  A tile at a domain edge reads its
// z neighbours at the clamped in-plane point, another thread's cell, and
// takes a barrier before each of its levels.
//
// Two bodies.  The clamp-free body reads fixed offsets from the cell's own
// place; the edge body clamps on global indices and skips cells outside the
// domain.  The choice is block-uniform, per level.  Both read the same
// operands in the same order as br_volume_cell.cuh (laplace9, then planar
// + dz2 * ((up - 2 v0) + down)) and call the same cell body.
//
// The walk.  The domain is cut into equal interior tiles of at most
// (EH - 2K) x (EW - 2K) cells.  The grid holds G = SMs x resident blocks;
// block b takes tiles b, b + G, ... in row-major order
// (ops/cuda_volume_tiled.py tile_plan mirrors all of it).  A warp is one
// row of the tile, so a tile's cost is its rows: level s issues U - 2 - 2s
// warp-rows whatever the width up to EW.  The columns take as few tiles as
// fit (split_axis of br_tile.cuh); the rows take the number n of tiles
// that minimises waves x rows, ceil(n n_cols / G) x (ceil(H / n) + K - 1),
// so that a last, part-filled wave of large tiles becomes a full wave of
// shorter ones (balanced_rows).  At the start of each step a block copies,
// with cp.async, the planes of position t + 1 and the V of position t + 2
// into slots that hold no live slice, so the copies overlap the step's
// compute.  Level K-1's cells (the tile's interior) go from registers
// straight to device memory.
//
// Memory: every plane is read from `*_in` and written to `*_out`, all
// distinct: a block's halo holds its neighbours' interior cells, which
// those blocks rewrite while it may still be loading them.
//
// Schedule: bit s of `slow_mask` selects the SLOW body for level s.  The
// thread that owns the probe cell writes its normalised final V to
// probe[probe_index].
//
// What bounds it.  Per outer step it reads the state once and writes it
// once, 8 planes each way: 134 MB at 8x512x512 float32 (>= 40 us from
// HBM), plus the halo overfetch (U / interior = 2.2 at 8x512x512, mostly
// L2 hits).  The cell body's instruction issue binds, as in br_tile.cuh:
// at 8x512x512 the 29 x 32 tiles issue 1.76x the interior's
// cell-substeps once the idle lanes of the ring's edge warps are counted.
//
// Built by fib_tf_tpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface (no --use_fast_math: logf feeds e_Ca).

#include <cuda_runtime.h>
#include <string.h>

#include <atomic>

#include "br_cell.cuh"
#include "br_tile.cuh"
#include "geometry.cuh"

namespace {

using fibtorch::BeelerReuterCell;
using fibtorch::BrParams;
using fibtorch::Planes;
using fibtorch::Split;
using fibtorch::TileGeom;
using fibtorch::clamp_index;
using fibtorch::cp_async4;
using fibtorch::cp_async_commit;
using fibtorch::cp_async_wait_all;
using fibtorch::kParamFloats;
using fibtorch::laplace9;
using fibtorch::split_axis;

using Cell = BeelerReuterCell;

// The tile: kEw columns by kEh rows, thread (x, y) owns cell (y, x), so a
// warp is a row.  Two rows per thread (480 threads) ran slower (PERF.md,
// Findings).
constexpr int kEw = 32, kEh = 30, kE = kEw * kEh;
// the most substeps per outer step (each level keeps a V ring)
constexpr int kMaxSub = 5;
// ring slots: the loaded V, each later level's input V, the planes
constexpr int kVinSlots = 4, kVSlots = 3, kPlaneSlots = kMaxSub + 1;
constexpr int kP = Cell::kPlanes;

// Shared memory, in floats: the loaded V's ring, levels 1..kMaxSub-1's V
// rings, the plane ring (slot-major, then plane).
constexpr int kVinOff = 0;
constexpr int kVOff = kVinOff + kVinSlots * kE;
constexpr int kPlaneOff = kVOff + (kMaxSub - 1) * kVSlots * kE;
constexpr size_t kSmemBytes =
    (size_t)(kPlaneOff + kPlaneSlots * kP * kE) * sizeof(float);
// the most dynamic shared memory one block may take on sm_90
constexpr int kSmemMax = 232448;
static_assert(kSmemBytes <= kSmemMax, "the rings exceed 227 KB");

// What the launch writes.
struct Out {
  float* v_out;
  Planes<Cell::kPlanes> planes;
  float* probe;
  int probe_z, probe_row, probe_col;
  long long probe_index;
};

// Tile `tile` of the row-major tiling `rows` x `cols` at halo k; all zero
// past the last.
__device__ __forceinline__ TileGeom tile_geom(int tile, int n_tiles,
                                              const Split& rows,
                                              const Split& cols, int k) {
  if (tile >= n_tiles) return {0, 0, 0, 0};
  const int ti = tile / cols.n;
  const int tj = tile - ti * cols.n;
  return {ti * rows.base + min(ti, rows.rem) - k,
          tj * cols.base + min(tj, cols.rem) - k,
          rows.base + (ti < rows.rem ? 1 : 0) + 2 * k,
          cols.base + (tj < cols.rem ? 1 : 0) + 2 * k};
}

// Whether tile `g` may take the clamp-free body: every cell a level
// updates lies one cell inside every domain edge.
__device__ __forceinline__ bool clamp_free(const TileGeom& g, int height,
                                           int width) {
  return g.r0 >= 1 && g.r0 + g.eh <= height - 1 && g.c0 >= 1 &&
         g.c0 + g.ew <= width - 1;
}

// Start the copies of slice z of tile g's per-cell planes into ring slot
// `slot`, for the thread's own cells that level 0 updates and that lie in
// the domain.
__device__ __forceinline__ void stage_planes(const Planes<kP>& pl,
                                             const TileGeom& g, int z,
                                             int height, int width,
                                             float* slot) {
  const int tx = threadIdx.x, a = threadIdx.y;
  const int gj = g.c0 + tx, gi = g.r0 + a;
  if (tx < 1 || tx > g.ew - 2 || gj < 0 || gj >= width || a < 1 ||
      a > g.eh - 2 || gi < 0 || gi >= height) {
    return;
  }
  const long long idx = ((long long)z * height + gi) * width + gj;
  const int at = a * kEw + tx;
#pragma unroll
  for (int k = 0; k < kP; ++k) cp_async4(slot + k * kE + at, pl.in[k] + idx);
}

// Start the copies of V slice z of tile g, every cell of its used extent
// that lies in the domain, into `vslot`.
__device__ __forceinline__ void stage_v(const float* __restrict__ v_in,
                                        const TileGeom& g, int z, int height,
                                        int width, float* vslot) {
  const int tx = threadIdx.x, a = threadIdx.y;
  const int gj = g.c0 + tx, gi = g.r0 + a;
  if (tx >= g.ew || gj < 0 || gj >= width || a >= g.eh || gi < 0 ||
      gi >= height) {
    return;
  }
  cp_async4(vslot + a * kEw + tx,
            v_in + ((long long)z * height + gi) * width + gj);
}

// One entry of a step's plan, at stream position p of the block (its
// tiles' slices in order, D per tile): a level's slice, or the planes or V
// slice copied this step.  Warp 0 computes the next step's plan during each
// step (row 0 of a tile takes no level); every thread reads it from a
// double-buffered table in shared memory, four 16-byte words.
struct alignas(16) Entry {
  int active;            // 0: nothing at this entry this step
  int z;                 // the slice
  TileGeom g;            // its tile
  int edge;              // the tile touches a domain edge: the edge body
  int barrier;           // a barrier precedes the level
  int pc, pu, pd;        // shared-memory offsets of the input V at
                         // clamp(z), clamp(z-1), clamp(z+1); a copy's slot
  int nxt;               // offset of the output slot in the next level's
                         // ring, -1 at the last level
  int planes;            // offset of the slice's planes in the plane ring
  int pad[3];
};
static_assert(sizeof(Entry) == 64, "an entry is four 16-byte words");
// a plan's entries: the kMaxSub levels, the planes copied this step
// (position t + 1) and the V slice copied (position t + 2)
constexpr int kCopyPlanes = kMaxSub, kCopyV = kMaxSub + 1;
constexpr int kEntries = kMaxSub + 2;
static_assert(kEntries <= kEw, "warp 0 plans one entry per lane");

// What the launch covers.
struct Launch {
  int depth, height, width, n_sub;
  Split rows, cols;
  int n_tiles;
};

// Entry j of step t's plan for a block of `n_pos` stream positions.
__device__ Entry plan_entry(int j, int t, int n_pos, const Launch& l) {
  Entry e = {};
  const int p = j < kMaxSub ? t - j : (j == kCopyPlanes ? t + 1 : t + 2);
  if ((j < kMaxSub && j >= l.n_sub) || p < 0 || p >= n_pos) return e;
  const int i = p / l.depth;
  const int z = p - i * l.depth;
  // only slices 1..D-2 of V are ever read
  if (j == kCopyV && (z < 1 || z > l.depth - 2)) return e;
  e.active = 1;
  e.z = z;
  e.g = tile_geom(blockIdx.x + i * gridDim.x, l.n_tiles, l.rows, l.cols,
                  l.n_sub);
  e.edge = clamp_free(e.g, l.height, l.width) ? 0 : 1;
  e.planes = kPlaneOff + (p % kPlaneSlots) * (kP * kE);
  if (j == kCopyV) e.pc = kVinOff + (p % kVinSlots) * kE;
  if (j >= kMaxSub) return e;
  e.barrier = j > 0 && (z == 0 || e.edge);
  const int p0 = p - z;   // the tile's slice 0
  const int zc = p0 + clamp_index(z, l.depth);
  const int zu = p0 + clamp_index(z - 1, l.depth);
  const int zd = p0 + clamp_index(z + 1, l.depth);
  if (j == 0) {
    e.pc = kVinOff + (zc % kVinSlots) * kE;
    e.pu = kVinOff + (zu % kVinSlots) * kE;
    e.pd = kVinOff + (zd % kVinSlots) * kE;
  } else {
    const int ring = kVOff + (j - 1) * (kVSlots * kE);
    e.pc = ring + (zc % kVSlots) * kE;
    e.pu = ring + (zu % kVSlots) * kE;
    e.pd = ring + (zd % kVSlots) * kE;
  }
  e.nxt = j == l.n_sub - 1 ? -1
                           : kVOff + j * (kVSlots * kE) + (p % kVSlots) * kE;
  return e;
}

// The table is written by warp 0 before the barrier that starts a step and
// read after it, so plain 16-byte stores and loads suffice.
__device__ __forceinline__ void store_entry(Entry& d, const Entry& e) {
  int4* w = reinterpret_cast<int4*>(&d);
  w[0] = make_int4(e.active, e.z, e.g.r0, e.g.c0);
  w[1] = make_int4(e.g.eh, e.g.ew, e.edge, e.barrier);
  w[2] = make_int4(e.pc, e.pu, e.pd, e.nxt);
  w[3] = make_int4(e.planes, 0, 0, 0);
}

__device__ __forceinline__ Entry load_entry(const Entry& d) {
  const int4* w = reinterpret_cast<const int4*>(&d);
  const int4 a = w[0], b = w[1], c = w[2], f = w[3];
  Entry e;
  e.active = a.x;
  e.z = a.y;
  e.g = {a.z, a.w, b.x, b.y};
  e.edge = b.z;
  e.barrier = b.w;
  e.pc = c.x;
  e.pu = c.y;
  e.pd = c.z;
  e.nxt = c.w;
  e.planes = f.x;
  return e;
}

// Level s of the current step (plan entry `e`) on the ring [s+1, U-2-s] of
// its tile: read V at slices clamp(z) (in the plane, `pc`), clamp(z-1)
// (`pu`) and clamp(z+1) (`pd`, both at the cell's clamped in-plane point),
// advance the slice's `planes`, and write the new V into the next level's
// ring (`nxt`) or, at the last level (`nxt` null), every plane of the
// interior cell to device memory.  No output aliases an input, so a
// thread's rows may interleave.
template <bool SLOW, bool EDGE>
__device__ __forceinline__ void level(const BrParams& p, float dz2,
                                      const float* __restrict__ pc,
                                      const float* __restrict__ pu,
                                      const float* __restrict__ pd,
                                      float* __restrict__ planes,
                                      float* __restrict__ nxt,
                                      const Entry& e, int s, int height,
                                      int width, const Out& out) {
  const TileGeom& g = e.g;
  const int tx = threadIdx.x, a = threadIdx.y;
  if (tx < s + 1 || tx > g.ew - 2 - s || a < s + 1 || a > g.eh - 2 - s) {
    return;
  }
  const int gi = g.r0 + a, gj = g.c0 + tx;
  int rn = (a - 1) * kEw, rc = a * kEw, rs = (a + 1) * kEw;
  int bw = tx - 1, bc = tx, be = tx + 1;
  if (EDGE) {
    if (gi < 0 || gi >= height || gj < 0 || gj >= width) return;
    rn = (clamp_index(gi - 1, height) - g.r0) * kEw;
    rc = (clamp_index(gi, height) - g.r0) * kEw;
    rs = (clamp_index(gi + 1, height) - g.r0) * kEw;
    bw = clamp_index(gj - 1, width) - g.c0;
    bc = clamp_index(gj, width) - g.c0;
    be = clamp_index(gj + 1, width) - g.c0;
  }
  const float v0 = pc[rc + bc];
  const float planar = laplace9(pc[rn + bc], pc[rs + bc], pc[rc + bw],
                                pc[rc + be], pc[rn + bw], pc[rs + bw],
                                pc[rn + be], pc[rs + be], v0);
  const float lap = planar + dz2 * ((pu[rc + bc] - 2.0f * v0) + pd[rc + bc]);
  const int at = a * kEw + tx;
  float q[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) q[k] = planes[k * kE + at];
  // BR's body reads v0 alone; kernel 5 hosts no other body yet
  const float v = Cell::update<SLOW>(p, v0, v0, lap, q);
  if (nxt != nullptr) {
    nxt[at] = v;
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      // the frozen body leaves the slow gates as they are
      if (SLOW || k == Cell::kC || k == Cell::kM || k == Cell::kH) {
        planes[k * kE + at] = q[k];
      }
    }
    return;
  }
  const long long idx = ((long long)e.z * height + gi) * width + gj;
  out.v_out[idx] = v;
#pragma unroll
  for (int k = 0; k < kP; ++k) out.planes.out[k][idx] = q[k];
  if (out.probe != nullptr && e.z == out.probe_z && gi == out.probe_row &&
      gj == out.probe_col) {
    out.probe[out.probe_index] = Cell::probe(p, v);
  }
}

__global__ void __launch_bounds__(kE, 1)
volume_stream_kernel(const BrParams p, const float dz2,
                     const float* __restrict__ v_in, const Out out,
                     const Launch l, unsigned slow_mask) {
  extern __shared__ float smem[];
  __shared__ Entry plans[2][kEntries];
  // the block's tiles: blockIdx.x, + gridDim.x, ...; D stream positions
  // each
  const int n_pos =
      (l.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      l.depth;
  const bool planner = threadIdx.y == 0 && threadIdx.x < kEntries;
  if (planner) {
    store_entry(plans[0][threadIdx.x], plan_entry(threadIdx.x, 0, n_pos, l));
  }
  {
    // position 0's planes and position 1's V (slice 1 of the first tile)
    const TileGeom g = tile_geom(blockIdx.x, l.n_tiles, l.rows, l.cols,
                                 l.n_sub);
    stage_planes(out.planes, g, 0, l.height, l.width, smem + kPlaneOff);
    stage_v(v_in, g, 1, l.height, l.width, smem + kVinOff + 1 * kE);
    cp_async_commit();
  }
  const int n_steps = n_pos + l.n_sub - 1;
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait_all();
    __syncthreads();   // this step's slices are staged and planned
    const Entry* plan = plans[t & 1];
    {
      // the copies of the next positions: their slots hold no live slice
      const Entry c = load_entry(plan[kCopyPlanes]);
      if (c.active) {
        stage_planes(out.planes, c.g, c.z, l.height, l.width,
                     smem + c.planes);
      }
      const Entry v = load_entry(plan[kCopyV]);
      if (v.active) stage_v(v_in, v.g, v.z, l.height, l.width, smem + v.pc);
      cp_async_commit();
    }
    // a rolled loop: one copy of each body (an unrolled one, five, ran
    // slower: PERF.md, Findings)
#pragma unroll 1
    for (int s = 0; s < kMaxSub; ++s) {
      const Entry e = load_entry(plan[s]);
      if (!e.active) continue;
      // slice 0 reads slice 1 in the plane, written by level s-1 in this
      // step; a tile at a domain edge reads its z neighbours at the
      // clamped in-plane point, another thread's cell
      if (e.barrier) __syncthreads();
      const bool slow = (slow_mask >> s) & 1u;
      const float* pc = smem + e.pc;
      const float* pu = smem + e.pu;
      const float* pd = smem + e.pd;
      float* planes = smem + e.planes;
      float* nxt = e.nxt < 0 ? nullptr : smem + e.nxt;
      if (e.edge) {
        if (slow) {
          level<true, true>(p, dz2, pc, pu, pd, planes, nxt, e, s, l.height,
                            l.width, out);
        } else {
          level<false, true>(p, dz2, pc, pu, pd, planes, nxt, e, s,
                             l.height, l.width, out);
        }
      } else if (slow) {
        level<true, false>(p, dz2, pc, pu, pd, planes, nxt, e, s, l.height,
                           l.width, out);
      } else {
        level<false, false>(p, dz2, pc, pu, pd, planes, nxt, e, s, l.height,
                            l.width, out);
      }
    }
    if (planner) {
      store_entry(plans[(t + 1) & 1][threadIdx.x],
                  plan_entry(threadIdx.x, t + 1, n_pos, l));
    }
  }
}

// The launch's grid size for a device: SMs x resident blocks per SM, found
// once per device (with the kernel's shared-memory limit raised) and
// cached in this library; 0 on an error.
int persistent_blocks(int device) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  if (device >= 0 && device < kMaxDevices) {
    const int c = cached[device].load(std::memory_order_relaxed);
    if (c > 0) return c;
  }
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(volume_stream_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemBytes) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, volume_stream_kernel, kE, kSmemBytes) !=
          cudaSuccess) {
    return 0;
  }
  const int blocks = sms * per_sm;
  if (blocks > 0 && device >= 0 && device < kMaxDevices) {
    cached[device].store(blocks, std::memory_order_relaxed);
  }
  return blocks;
}

// The row split of a `height`-row domain whose columns take `n_cols`
// tiles, for a grid of `blocks`: among n = ceil(height / (EH - 2K)) ..
// 4 n tiles, the one with the least waves x (rows + K - 1), the fewest
// tiles on a tie (see The walk).
Split balanced_rows(int height, int n_sub, int n_cols, int blocks) {
  const Split least = split_axis(height, kEh - 2 * n_sub);
  if (blocks < 1) return least;
  Split best = least;
  long long best_cost = -1;
  for (int n = least.n; n <= height && n <= 4 * least.n; ++n) {
    const long long waves = ((long long)n * n_cols + blocks - 1) / blocks;
    const long long cost = waves * ((height + n - 1) / n + n_sub - 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = {n, height / n, height % n};
    }
  }
  return best;
}

}  // namespace

extern "C" {

// Number of floats the host passes as `params` (the BrParams layout).
int br_volume_tiled_param_floats() { return kParamFloats; }

// Number of per-cell planes besides V (BeelerReuterCell::kPlanes).
int br_volume_tiled_planes() { return Cell::kPlanes; }

// The design's layout: the extended tile's columns and rows, the threads
// per block, the most substeps, the ring slots of the loaded V, of each
// later level's V and of the per-cell planes, and the block's shared
// memory in bytes.
void br_volume_tiled_layout(int* tile_w, int* tile_h, int* threads,
                            int* max_sub, int* v_in_slots, int* v_slots,
                            int* plane_slots, int* smem_bytes) {
  *tile_w = kEw;
  *tile_h = kEh;
  *threads = kE;
  *max_sub = kMaxSub;
  *v_in_slots = kVinSlots;
  *v_slots = kVSlots;
  *plane_slots = kPlaneSlots;
  *smem_bytes = (int)kSmemBytes;
}

// The row split of balanced_rows (ops/cuda_volume_tiled.py tile_plan).
void br_volume_tiled_rows(int height, int n_sub, int n_cols, int blocks,
                          int* n, int* base, int* rem) {
  const Split s = balanced_rows(height, n_sub, n_cols, blocks);
  *n = s.n;
  *base = s.base;
  *rem = s.rem;
}

// Launch one outer step of `n_sub` substeps of a depth x height x width
// volume on `stream` of device `device` and return cudaGetLastError().
// `params` is a host array of br_volume_tiled_param_floats() floats;
// `planes_in` / `planes_out` are host arrays of `n_planes` device pointers
// in cuda_step.CELL_PLANES order.  No output may alias an input.  `probe`
// may be null.
int br_volume_tiled(const float* params, int n_params, float dz_ratio,
                    const float* v_in, float* v_out, void* const* planes_in,
                    void* const* planes_out, int n_planes, int depth,
                    int height, int width, int n_sub, unsigned slow_mask,
                    float* probe, int probe_z, int probe_row, int probe_col,
                    long long probe_index, int device, void* stream) {
  if (n_params != kParamFloats || n_planes != kP || depth < 3 ||
      height < 3 || width < 3 || n_sub < 1 || n_sub > kMaxSub ||
      kEw - 2 * n_sub < 1 || kEh - 2 * n_sub < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Out out;
  if (!fibtorch::gather_planes(v_in, v_out, planes_in, planes_out,
                               &out.planes)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = persistent_blocks(device);
  if (blocks < 1) {
    err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorLaunchOutOfResources);
  }
  const Split cols = split_axis(width, kEw - 2 * n_sub);
  const Split rows = balanced_rows(height, n_sub, cols.n, blocks);
  const long long n_tiles = (long long)rows.n * cols.n;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  BrParams p;
  memcpy(&p, params, sizeof(BrParams));
  // (2*dz_ratio) in float, as the plain version's scalar
  const float dz2 = 2.0f * dz_ratio;
  out.v_out = v_out;
  out.probe = probe;
  out.probe_z = probe_z;
  out.probe_row = probe_row;
  out.probe_col = probe_col;
  out.probe_index = probe_index;
  const int grid = (int)(n_tiles < blocks ? n_tiles : blocks);
  const Launch l = {depth, height, width, n_sub, rows, cols, (int)n_tiles};
  volume_stream_kernel<<<grid, dim3(kEw, kEh), kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      p, dz2, v_in, out, l, slow_mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
