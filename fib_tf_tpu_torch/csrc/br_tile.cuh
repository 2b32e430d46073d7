// The tile skeleton shared by br_tiled.cu (one outer step of a whole grid)
// and br_block.cu (one outer step of one shard's halo-extended block): 2D
// tiles, temporally blocked, with a halo of one ring per substep, walked by
// persistent blocks that stage the next tile while they compute this one.
// It is a template over the cell body (br_cell.cuh's contract) and the
// tile shape: both kernels instantiate it for every body, Beeler-Reuter's
// (K = 5 substeps, a 54 x 54 interior per 64 x 64 tile), Fenton's and
// Mitchell-Schaeffer's (K = 10, a 44 x 44 interior: 64^2 / 44^2 = 2.1x the
// interior's cells loaded and, in the first substeps, computed), each
// entry on its own thread shape (br_tiled.cu).  Shared memory per block is
// (3 + kPlanes) x 16 KB: BR 160 KB (192 KB with ab2's nine planes), Fenton
// 96 KB (160 KB with ab2), Mitchell-Schaeffer 64 KB, each above the 48 KB
// default, so each instantiation raises its own limit.
//
// What it computes.  A launch covers a WINDOW of the domain, rows
// [row0, row1) x columns [col0, col1) in global indices.  The window is cut
// into equal interior tiles (split_axis): along each axis n tiles of
// `base` or `base + 1` cells, n as small as the largest interior of the
// constexpr tile, (EH - 2K) x (EW - 2K) for K = n_sub, allows.  A tile is
// loaded extended by K rings (its USED extent, at most EH x EW), runs the K
// substeps and writes back its interior.  V lives in shared memory,
// double-buffered across substeps, because the stencil reads neighbours;
// the per-cell planes stay in registers for all K substeps.  Substep s
// updates only the local cells [s+1, U-2-s] of each axis of the used
// extent U: their neighbours were updated at substep s-1 (or loaded), so
// every value computed is exact, and after K substeps the interior [K, U-K)
// is.  The outer rings are recomputed by the neighbouring tiles (or, at the
// edge of the window, by the neighbouring shard), whose interiors they are.
//
// The walk.  The grid holds at most one block per SM (SMs x blocks per SM,
// cached per device); block b takes tiles b, b + gridDim.x, ... in row-major
// order, a static list (no atomics).  While it computes tile t it copies
// tile t + gridDim.x's extended V and per-cell planes into shared memory
// with cp.async (4-byte copies: any pitch and any origin), a part after
// each substep's compute, so that the copies spread over the tile instead
// of reaching the memory system all at once from every SM.  At the switch
// the threads move the staged planes into registers; the staged V is
// already the next tile's first V buffer.  Three V buffers rotate: the
// tile's loaded V, its ping-pong partner, and the next tile's V.  The last
// substep's ring is the tile's interior: each of its cells goes from
// registers straight to device memory as soon as it is computed.
//
// Two bodies.  A tile whose used extent lies inside the launch's reach and
// at least one cell from every domain edge needs no clamp and no reach
// test: its stencil reads fixed offsets from the cell's own address.  Every
// other tile (one that touches a domain edge) runs the edge body, which
// clamps on global indices and tests the reach.  The choice is
// block-uniform, per tile.  Both call the same laplace9 and the same cell
// body on the same operands in the same order, so a cell's value does not
// depend on which body or which tiling computed it (the sharded runs stay
// bit-equal to the unsharded one).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W limit, tools/torch_tile_bench.py
// and chip_smoke.py; PERF.md).  64 registers a thread, no spills, 160 KB
// of dynamic shared memory, one block per SM.  The previous skeleton (one
// tile per block: load, compute, store in turn) spent about 88 ns per tile
// on load and store (the intercept of its time per tile against the
// substeps run) beside 26 / 41 ns per frozen / SLOW substep; this one,
// whose copies and stores overlap the compute, took 234-240 us of its
// 265-268 us at 2048^2 with no copies and no stores at all: the cell
// body's instructions bind, at about two thirds of the peak issue rate.
// Its time per tile splits into about 95-108 ns of copies and switch and
// 11.8 / 30.4 ns per frozen / SLOW substep of a whole ring; BR's per-thread
// constant loads (br_cell.cuh BrParams) set much of the frozen part: 13.8
// ns with 7 LDC a cell-substep, 11.8 with 4.
//
// Where the cells live.  Every plane is an array of `pitch` floats per row
// whose element (0, 0) is the global cell (rstart, cstart): cell (gi, gj) is
// at (gi - rstart) * pitch + (gj - cstart).  For a whole grid rstart =
// cstart = 0, pitch = width and the window is the domain.  For a shard's
// block the array is the block extended by its ghost rows (and columns),
// the window is the block itself, and the tiles' halos are read from the
// ghosts: the caller guarantees that the window extended by n_sub rings,
// clipped to the domain, lies inside the array.  A tile never loads a cell
// beyond that region (its REACH).
//
// Boundary, on GLOBAL indices, every substep: a cell (i, j) of the domain
// reads its stencil point (i+di, j+dj) at V[clamp(i+di), clamp(j+dj)] with
// clamp(k) = min(max(k, 1), N-2) over the DOMAIN's extent N, the SYMMETRIC
// rewrite composed with the REFLECT pad (the TPU kernels' global-row masks in
// block_geometry compute the same).  Clamped points always lie in the
// domain and within one cell of (i, j), so the halo of a tile at the edge
// of the domain never needs cells outside it: those are neither loaded nor
// computed, and only a window that touches a domain edge reflects.  Ragged
// edges are masked, so any window of a domain with H, W >= 3 runs.
//
// Memory: every plane is read from `*_in` and written to `*_out`, all
// distinct and of the same layout.  The per-cell planes cannot be updated
// in place: a tile's halo holds its neighbours' interior cells, which
// other blocks rewrite while it may still be loading them.
//
// Geometry (GEOM = true, geometry.cuh): the diffusion operator takes the
// phase field, the diffusion map and the fiber tensor at the cell's global
// indices, the maps read through the read-only path from arrays of the
// planes' layout; every tile runs the edge body (off the domain's edges
// its clamps are the identity), which halves what nvcc compiles for the
// GEOM entries.  GEOM = false is the isotropic skeleton unchanged.
//
// Schedule: bit s of `slow_mask` selects the SLOW body for substep s (BR's;
// the other bodies ignore it).  Each cell body gets the cell's raw centre,
// cur[cell], beside the boundary-enforced v0 = cur[clamped cell]; they
// differ only in the edge body, on the domain's outer ring.  The
// thread that owns the probe pixel (global indices) writes its normalised
// final V to probe[probe_index].

#pragma once

#include <cuda_runtime.h>

#include <atomic>

#include "br_cell.cuh"
#include "geometry.cuh"

namespace fibtorch {

// Per-cell plane pointers, by value: read from `in`, written to `out`.
template <int N>
struct Planes {
  const float* in[N];
  float* out[N];
};

// The arrays' layout and the window a launch covers (see above).
struct Window {
  int rstart, cstart, pitch;
  int row0, row1, col0, col1;
};

// The cells a launch may load and compute: the window extended by n_sub
// rings, clipped to the domain.  A tile's used extent never leaves the
// window extended by n_sub rings, so the cells of a tile outside the reach
// lie outside the domain: they are neither loaded nor computed, and the
// clamp never reads them.
struct Reach {
  int row_lo, row_hi, col_lo, col_hi;
};

// The tile shape: kBx x kBy threads, each owning kRy cells of one column
// (rows ty, ty + kBy, ...), so the extended tile is EW = kBx wide and
// EH = kBy * kRy tall: 64 x 64 with 1024 threads (ops/cuda_tiled.py TILE).
constexpr int kBx = 64, kBy = 16, kRy = 4;

// One axis of the window cut into n equal tiles: tile i starts at
// i * base + min(i, rem) and spans base + (i < rem) cells
// (ops/cuda_tiled.py tile_spans).
struct Split {
  int n, base, rem;
};

inline Split split_axis(int len, int max_tile) {
  const int n = (len + max_tile - 1) / max_tile;
  return {n, len / n, len % n};
}

// A tile's place: the global row / column of its local cell (0, 0) and its
// used extent (interior + 2K per axis).
struct TileGeom {
  int r0, c0, eh, ew;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The launch's reach (see Reach).
__device__ __forceinline__ Reach launch_reach(const Window& win, int n_sub,
                                              int height, int width) {
  return {max(win.row0 - n_sub, 0), min(win.row1 + n_sub, height),
          max(win.col0 - n_sub, 0), min(win.col1 + n_sub, width)};
}

// The block-uniform state of the walk: the launch's reach and tiling, the
// block's current tile, its loaded V buffer (`rot`; its ping-pong partner
// is (rot + 2) % 3 and the next tile's V goes into (rot + 1) % 3), and the
// places of the current tile, the next one and the one after (all zero
// past the last).  The leader advances it between the two barriers that
// start a tile.  It lives in shared memory and is read where it is used,
// through a volatile reference, so that no register carries it through a
// tile's substeps: at 1024 threads a thread has 64 registers, and the
// per-cell planes and the cell body need them all.
struct Walk {
  Reach reach;
  Split rows, cols;
  int row_org, col_org;   // the window's first row and column less n_sub
  int k, n_tiles;
  int tile, rot;
  TileGeom g, next, after;
};

__device__ __forceinline__ TileGeom load_geom(const volatile TileGeom& g) {
  return {g.r0, g.c0, g.eh, g.ew};
}

__device__ __forceinline__ void store_geom(volatile TileGeom& dst,
                                           const TileGeom& g) {
  dst.r0 = g.r0;
  dst.c0 = g.c0;
  dst.eh = g.eh;
  dst.ew = g.ew;
}

// The place of tile `tile` of the walk's tiling; all zero past the last.
__device__ __forceinline__ TileGeom walk_geom(const volatile Walk& w,
                                              int tile) {
  if (tile >= w.n_tiles) return {0, 0, 0, 0};
  const Split rows = {w.rows.n, w.rows.base, w.rows.rem};
  const Split cols = {w.cols.n, w.cols.base, w.cols.rem};
  const int ti = tile / cols.n;
  const int tj = tile - ti * cols.n;
  const int k2 = 2 * w.k;
  return {w.row_org + ti * rows.base + min(ti, rows.rem),
          w.col_org + tj * cols.base + min(tj, cols.rem),
          rows.base + (ti < rows.rem ? 1 : 0) + k2,
          cols.base + (tj < cols.rem ? 1 : 0) + k2};
}

__device__ __forceinline__ Reach load_reach(const volatile Reach& r) {
  return {r.row_lo, r.row_hi, r.col_lo, r.col_hi};
}

// Whether tile `gv` may take the clamp-free body: its used extent lies in
// the reach and one cell inside every domain edge, so that the clamp is
// the identity on every stencil point it reads.
__device__ __forceinline__ bool clamp_free(const volatile TileGeom& gv,
                                           const volatile Reach& rv,
                                           int height, int width) {
  const TileGeom g = load_geom(gv);
  const Reach reach = load_reach(rv);
  return g.r0 >= max(reach.row_lo, 1) &&
         g.r0 + g.eh <= min(reach.row_hi, height - 1) &&
         g.c0 >= max(reach.col_lo, 1) &&
         g.c0 + g.ew <= min(reach.col_hi, width - 1);
}

// Start the copies of part `part` of `n_parts` of tile `g`: the thread's
// rows r with r * n_parts / RY == part, of the cells that lie in the reach,
// V into `vdst` and plane k into `pdst + k * EH * EW`, both at the local
// cell's place.  Cells outside the reach keep whatever the buffers held.
template <int kP, int BX, int BY, int RY>
__device__ __forceinline__ void stage_tile(const float* __restrict__ v_in,
                                           const Planes<kP>& planes,
                                           const Window& win,
                                           const Reach& reach,
                                           const TileGeom& g, float* vdst,
                                           float* pdst, int part,
                                           int n_parts) {
  constexpr int EW = BX, EH = BY * RY;
  const int tx = threadIdx.x;
  const int gj = g.c0 + tx;
  if (tx >= g.ew || gj < reach.col_lo || gj >= reach.col_hi) return;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int a = threadIdx.y + r * BY;
    const int gi = g.r0 + a;
    if (r * n_parts / RY != part || a >= g.eh || gi < reach.row_lo ||
        gi >= reach.row_hi) {
      continue;
    }
    const long long idx =
        (long long)(gi - win.rstart) * win.pitch + (gj - win.cstart);
    const int at = a * EW + tx;
    cp_async4(vdst + at, v_in + idx);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      cp_async4(pdst + k * (EH * EW) + at, planes.in[k] + idx);
    }
  }
}

// What a launch writes: the output planes and the probe.
template <int kP>
struct Outputs {
  float* v_out;
  const Planes<kP>& planes;
  const Window& win;
  float* probe;
  int probe_row, probe_col;
  long long probe_index;
};

// Substep s of the current tile on the ring [s+1, U-2-s] of its used
// extent: read V from `cur`, write the new V to `nxt`, advance the per-cell
// planes in `q`.  EDGE: clamp the stencil on global indices and skip cells
// outside the reach; otherwise every point is the cell's own neighbour.
// The ring of the last substep (`last`) is the tile's interior: each of its
// cells is written out as soon as it is computed.  GEOM: the diffusion
// operator of geometry.cuh at the cell's global indices.
template <class Body, int BX, int BY, int RY, bool SLOW, bool EDGE,
          bool GEOM>
__device__ __forceinline__ void tile_substep(
    const typename Body::Params& p, const float* __restrict__ cur,
    float* __restrict__ nxt, float (&q)[RY][Body::kPlanes], int s,
    bool last, const volatile TileGeom& g, const volatile Reach& reach,
    int height, int width, const Outputs<Body::kPlanes>& out,
    const GeometryArg<GEOM>& geo) {
  constexpr int EW = BX;
  const int tx = threadIdx.x;
  if (tx < s + 1 || tx > g.ew - 2 - s) return;
  int bw = tx - 1, bc = tx, be = tx + 1;
  if (EDGE) {
    const int c0 = g.c0;
    const int gj = c0 + tx;
    if (gj < reach.col_lo || gj >= reach.col_hi) return;
    bw = clamp_index(gj - 1, width) - c0;
    bc = clamp_index(gj, width) - c0;
    be = clamp_index(gj + 1, width) - c0;
  }
  const int last_row = g.eh - 2 - s;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int a = threadIdx.y + r * BY;
    if (a < s + 1 || a > last_row) continue;
    const float* rn = cur + (a - 1) * EW;
    const float* rc = cur + a * EW;
    const float* rs = cur + (a + 1) * EW;
    if (EDGE) {
      const int r0 = g.r0;
      const int gi = r0 + a;
      if (gi < reach.row_lo || gi >= reach.row_hi) continue;
      rn = cur + (clamp_index(gi - 1, height) - r0) * EW;
      rc = cur + (clamp_index(gi, height) - r0) * EW;
      rs = cur + (clamp_index(gi + 1, height) - r0) * EW;
    }
    const float v0 = rc[bc];
    float lap;
    if constexpr (GEOM) {
      lap = geometry_laplace(geo, g.r0 + a, g.c0 + tx, height, width, rn[bc],
                             rs[bc], rc[bw], rc[be], rn[bw], rs[bw], rn[be],
                             rs[be], v0);
    } else {
      lap = laplace9(rn[bc], rs[bc], rc[bw], rc[be], rn[bw], rs[bw], rn[be],
                     rs[be], v0);
    }
    // the cell's raw centre: v0 itself off the domain's outer ring
    const float raw = cur[a * EW + tx];
    const float v = Body::template update<SLOW>(p, v0, raw, lap, q[r]);
    if (!last) {
      nxt[a * EW + tx] = v;
      continue;
    }
    const int gi = g.r0 + a;
    const int gj = g.c0 + tx;
    const long long idx = (long long)(gi - out.win.rstart) * out.win.pitch +
                          (gj - out.win.cstart);
    out.v_out[idx] = v;
#pragma unroll
    for (int k = 0; k < Body::kPlanes; ++k) out.planes.out[k][idx] = q[r][k];
    if (out.probe != nullptr && gi == out.probe_row && gj == out.probe_col) {
      out.probe[out.probe_index] = Body::probe(p, v);
    }
  }
}

// The K substeps of the walk's current tile, V ping-ponging between the
// buffers `rot` (loaded) and (rot + 2) % 3.  After substep s each thread
// starts part s of its copies of the next tile (V into buffer (rot + 1) %
// 3, the planes into the staging area): they spread over the tile, and a
// warp that finishes its rows early issues them while the others compute.
// A thread copies exactly the cells whose planes it moves into registers
// at the next tile's start, so the staging area needs no barrier.  The last
// substep writes the tile out and leaves the barrier to the next tile.
template <class Body, int BX, int BY, int RY, bool EDGE, bool GEOM>
__device__ __forceinline__ void tile_substeps(
    const typename Body::Params& p, const float* __restrict__ v_in,
    float* smem, float (&q)[RY][Body::kPlanes], int n_sub,
    unsigned slow_mask, const volatile Walk& w, int height, int width,
    const Outputs<Body::kPlanes>& out, const GeometryArg<GEOM>& geo) {
  constexpr int kTile = BX * BY * RY;
  for (int s = 0; s < n_sub; ++s) {
    const int rot = w.rot;
    float* v0 = smem + rot * kTile;
    float* v1 = smem + (rot == 0 ? 2 : rot - 1) * kTile;
    const float* cur = (s & 1) ? v1 : v0;
    float* nxt = (s & 1) ? v0 : v1;
    const bool last = s == n_sub - 1;
    if ((slow_mask >> s) & 1u) {
      tile_substep<Body, BX, BY, RY, true, EDGE, GEOM>(
          p, cur, nxt, q, s, last, w.g, w.reach, height, width, out, geo);
    } else {
      tile_substep<Body, BX, BY, RY, false, EDGE, GEOM>(
          p, cur, nxt, q, s, last, w.g, w.reach, height, width, out, geo);
    }
    stage_tile<Body::kPlanes, BX, BY, RY>(
        v_in, out.planes, out.win, load_reach(w.reach), load_geom(w.next),
        smem + (w.rot == 2 ? 0 : w.rot + 1) * kTile, smem + 3 * kTile, s,
        n_sub);
    cp_async_commit();
    if (!last) __syncthreads();
  }
}

// Shared memory of one block: three V buffers and the staged planes.
template <class Body, int BX, int BY, int RY>
constexpr size_t tile_smem_bytes() {
  return (size_t)(3 + Body::kPlanes) * BX * BY * RY * sizeof(float);
}

template <class Body, int BX, int BY, int RY, bool GEOM>
__global__ void __launch_bounds__(BX * BY, 1)
tile_kernel(const typename Body::Params p, const float* __restrict__ v_in,
            float* __restrict__ v_out, const Planes<Body::kPlanes> planes,
            const Window win, const Split rows, const Split cols,
            int height, int width, int n_sub, unsigned slow_mask,
            float* __restrict__ probe, int probe_row, int probe_col,
            long long probe_index, const GeometryArg<GEOM> geo) {
  constexpr int EW = BX, EH = BY * RY, kP = Body::kPlanes;
  constexpr int kTile = EH * EW;
  extern __shared__ float smem[];   // V buffers 0-2, then kP staged planes
  __shared__ Walk walk;
  volatile Walk& w = walk;
  float* staged = smem + 3 * kTile;
  const bool leader = threadIdx.x == 0 && threadIdx.y == 0;
  const Outputs<kP> out = {v_out, planes, win, probe, probe_row, probe_col,
                           probe_index};
  if (leader) {
    const Reach reach = launch_reach(win, n_sub, height, width);
    w.reach.row_lo = reach.row_lo;
    w.reach.row_hi = reach.row_hi;
    w.reach.col_lo = reach.col_lo;
    w.reach.col_hi = reach.col_hi;
    w.rows.n = rows.n;
    w.rows.base = rows.base;
    w.rows.rem = rows.rem;
    w.cols.n = cols.n;
    w.cols.base = cols.base;
    w.cols.rem = cols.rem;
    w.row_org = win.row0 - n_sub;
    w.col_org = win.col0 - n_sub;
    w.k = n_sub;
    w.n_tiles = rows.n * cols.n;   // the grid holds no more blocks
    // as if the block had just run the tile before its first
    w.tile = (int)blockIdx.x - (int)gridDim.x;
    w.rot = 2;
    store_geom(w.next, walk_geom(w, blockIdx.x));
    store_geom(w.after, walk_geom(w, blockIdx.x + gridDim.x));
  }
  __syncthreads();
  stage_tile<kP, BX, BY, RY>(v_in, planes, win, load_reach(w.reach),
                             load_geom(w.next), smem, staged, 0, 1);
  cp_async_commit();

  float q[RY][kP];
  for (;;) {
    cp_async_wait_all();
    __syncthreads();   // the next tile is staged; no thread reads the walk
    if (leader) {
      w.tile = w.tile + gridDim.x;
      w.rot = w.rot == 2 ? 0 : w.rot + 1;
      store_geom(w.g, load_geom(w.next));
      store_geom(w.next, load_geom(w.after));
    }
    __syncthreads();   // the walk describes the tile to run
    if (w.tile >= w.n_tiles) break;
    {
      // only the cells that substep 0 updates: every plane moved is then
      // read by the compute before this thread's next copy into its place
      const TileGeom g = load_geom(w.g);
      const Reach reach = load_reach(w.reach);
      const int tx = threadIdx.x;
      const int gj = g.c0 + tx;
      const bool col = tx >= 1 && tx <= g.ew - 2 && gj >= reach.col_lo &&
                       gj < reach.col_hi;
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int a = threadIdx.y + r * BY;
        const int gi = g.r0 + a;
        const bool used = col && a >= 1 && a <= g.eh - 2 &&
                          gi >= reach.row_lo && gi < reach.row_hi;
        const int at = a * EW + tx;
#pragma unroll
        for (int k = 0; k < kP; ++k) {
          q[r][k] = used ? staged[k * kTile + at] : 0.0f;
        }
      }
    }
    if (leader) {
      // read by the leader alone, at the next tile's start
      store_geom(w.after, walk_geom(w, w.tile + 2 * gridDim.x));
    }
    if constexpr (GEOM) {
      // one body: off the domain's edges its clamps are the identity
      tile_substeps<Body, BX, BY, RY, true, GEOM>(
          p, v_in, smem, q, n_sub, slow_mask, w, height, width, out, geo);
    } else if (clamp_free(w.g, w.reach, height, width)) {
      tile_substeps<Body, BX, BY, RY, false, GEOM>(
          p, v_in, smem, q, n_sub, slow_mask, w, height, width, out, geo);
    } else {
      tile_substeps<Body, BX, BY, RY, true, GEOM>(
          p, v_in, smem, q, n_sub, slow_mask, w, height, width, out, geo);
    }
  }
}

// Launch state kept per library and device (internal linkage: each library
// registers its own copy of the kernel and must raise its own limit).
namespace {

// The launch's grid size for a device: SMs x resident blocks per SM, found
// once per device (with the kernel's shared-memory limit raised) and
// cached; 0 on an error.
template <class Body, int BX, int BY, int RY, bool GEOM>
int persistent_blocks(int device) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  if (device >= 0 && device < kMaxDevices) {
    const int c = cached[device].load(std::memory_order_relaxed);
    if (c > 0) return c;
  }
  constexpr size_t smem = tile_smem_bytes<Body, BX, BY, RY>();
  auto kernel = tile_kernel<Body, BX, BY, RY, GEOM>;
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BX * BY,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  const int blocks = sms * per_sm;
  if (blocks > 0 && device >= 0 && device < kMaxDevices) {
    cached[device].store(blocks, std::memory_order_relaxed);
  }
  return blocks;
}

}  // namespace

// Launch the tiles that cover `win` (which must lie inside the domain) on
// the current device and return cudaGetLastError().  With GEOM, under the
// geometry `geo`, whose maps no output may alias.
template <class Body, int BX, int BY, int RY, bool GEOM>
cudaError_t launch_tiles(const typename Body::Params& p, const float* v_in,
                         float* v_out, const Planes<Body::kPlanes>& planes,
                         const Window& win, int height, int width, int n_sub,
                         unsigned slow_mask, float* probe, int probe_row,
                         int probe_col, long long probe_index, int device,
                         cudaStream_t stream, const GeometryArg<GEOM>& geo) {
  constexpr int EW = BX, EH = BY * RY;
  constexpr size_t smem = tile_smem_bytes<Body, BX, BY, RY>();
  static_assert(smem <= 232448, "the tile's buffers exceed 227 KB");
  if (EW - 2 * n_sub < 1 || EH - 2 * n_sub < 1) {
    return cudaErrorInvalidValue;   // empty interior
  }
  if (win.row0 < 0 || win.row1 > height || win.row0 >= win.row1 ||
      win.col0 < 0 || win.col1 > width || win.col0 >= win.col1) {
    return cudaErrorInvalidValue;
  }
  const Split rows = split_axis(win.row1 - win.row0, EH - 2 * n_sub);
  const Split cols = split_axis(win.col1 - win.col0, EW - 2 * n_sub);
  const long long n_tiles = (long long)rows.n * cols.n;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if constexpr (GEOM) {
    if (!maps_apart(geo, v_out, (void* const*)planes.out, Body::kPlanes)) {
      return cudaErrorInvalidValue;
    }
  }
  const int blocks = persistent_blocks<Body, BX, BY, RY, GEOM>(device);
  if (blocks < 1) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorLaunchOutOfResources;
  }
  const int grid = (int)(n_tiles < blocks ? n_tiles : blocks);
  tile_kernel<Body, BX, BY, RY, GEOM><<<grid, dim3(BX, BY), smem, stream>>>(
      p, v_in, v_out, planes, win, rows, cols, height, width, n_sub,
      slow_mask, probe, probe_row, probe_col, probe_index, geo);
  return cudaGetLastError();
}

// Fill `planes` from the host's pointer arrays; false when an output
// aliases an input (V included).
template <int N>
bool gather_planes(const float* v_in, float* v_out, void* const* planes_in,
                   void* const* planes_out, Planes<N>* planes) {
  const void* ins[N + 1];
  const void* outs[N + 1];
  ins[0] = v_in;
  outs[0] = v_out;
  for (int k = 0; k < N; ++k) {
    planes->in[k] = static_cast<const float*>(planes_in[k]);
    planes->out[k] = static_cast<float*>(planes_out[k]);
    ins[k + 1] = planes_in[k];
    outs[k + 1] = planes_out[k];
  }
  for (int a = 0; a <= N; ++a) {
    for (int b = 0; b <= N; ++b) {
      if (outs[a] == ins[b]) return false;
    }
  }
  return true;
}

}  // namespace fibtorch
