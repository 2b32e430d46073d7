// The tile skeleton shared by br_tiled.cu (one outer step of a whole grid)
// and br_block.cu (one outer step of one shard's halo-extended block): 2D
// tiles, temporally blocked, with a halo of one ring per substep.
//
// What it computes.  A launch covers a WINDOW of the domain, rows
// [row0, row1) x columns [col0, col1) in global indices.  Block (bx, by) owns
// an interior tile of TH x TW cells of the window.  It loads the tile
// extended by K = n_sub rings (EH x EW = (TH + 2K) x (TW + 2K)) from device
// memory, runs the K substeps on it and writes back the interior.  V lives
// in shared memory, double-buffered across substeps, because the stencil
// reads neighbours; the per-cell planes stay in registers for all K
// substeps.  Substep s updates only the local cells [s+1, E-2-s] of each
// axis: their neighbours were updated at substep s-1 (or loaded), so every
// value computed is exact, and after K substeps the interior [K, E-K) is.
// The outer rings are recomputed by the neighbouring blocks (or, at the edge
// of the window, by the neighbouring shard), whose interiors they are.
//
// Where the cells live.  Every plane is an array of `pitch` floats per row
// whose element (0, 0) is the global cell (rstart, cstart): cell (gi, gj) is
// at (gi - rstart) * pitch + (gj - cstart).  For a whole grid rstart =
// cstart = 0, pitch = width and the window is the domain.  For a shard's
// block the array is the block extended by its ghost rows (and columns),
// the window is the block itself, and the tiles' halos are read from the
// ghosts: the caller guarantees that the window extended by n_sub rings,
// clipped to the domain, lies inside the array.  A tile never touches a
// cell beyond that region (its REACH), although its shape may extend past
// it.
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
// in place: a block's halo holds its neighbours' interior cells, which
// those blocks rewrite while it may still be loading them.
//
// Schedule: bit s of `slow_mask` selects the SLOW body for substep s.  The
// thread that owns the probe pixel (global indices) writes its normalised
// final V to probe[probe_index].

#pragma once

#include <cuda_runtime.h>

#include "br_cell.cuh"

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
// rings, clipped to the domain.  A cell on the rim of the reach that is not
// on a domain edge reads a neighbour that was never loaded; its value is
// garbage, and lies outside every cone that ends in the window.
struct Reach {
  int row_lo, row_hi, col_lo, col_hi;
};

// The tile shape: kBx x kBy threads, each owning kRy cells of one column
// (rows ty, ty + kBy, ...), so the extended tile is EW = kBx wide and
// EH = kBy * kRy tall: 64 x 64 with 1024 threads (ops/cuda_tiled.py TILE).
constexpr int kBx = 64, kBy = 16, kRy = 4;

// Substep s on the ring [s+1, E-2-s] of the tile: read V from `cur`, write
// the new V to `nxt`, advance the per-cell planes in `q`.  r0 / c0 are the
// global row / column of local cell (0, 0); `reach` bounds the cells the
// launch may touch.
template <class Body, int BX, int BY, int RY, bool SLOW>
__device__ __forceinline__ void tile_substep(const typename Body::Params& p,
                                             const float* __restrict__ cur,
                                             float* __restrict__ nxt,
                                             float (&q)[RY][Body::kPlanes],
                                             int s, int r0, int c0,
                                             const Reach& reach, int height,
                                             int width) {
  constexpr int EW = BX, EH = BY * RY;
  const int tx = threadIdx.x;
  const int gj = c0 + tx;
  if (gj < reach.col_lo || gj >= reach.col_hi || tx < s + 1 ||
      tx > EW - 2 - s) {
    return;
  }
  const int bw = clamp_index(gj - 1, width) - c0;
  const int bc = clamp_index(gj, width) - c0;
  const int be = clamp_index(gj + 1, width) - c0;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int a = threadIdx.y + r * BY;
    const int gi = r0 + a;
    if (gi < reach.row_lo || gi >= reach.row_hi || a < s + 1 ||
        a > EH - 2 - s) {
      continue;
    }
    const float* rn = cur + (clamp_index(gi - 1, height) - r0) * EW;
    const float* rc = cur + (clamp_index(gi, height) - r0) * EW;
    const float* rs = cur + (clamp_index(gi + 1, height) - r0) * EW;
    const float v0 = rc[bc];
    const float lap = laplace9(rn[bc], rs[bc], rc[bw], rc[be], rn[bw],
                               rs[bw], rn[be], rs[be], v0);
    nxt[a * EW + tx] = Body::template update<SLOW>(p, v0, lap, q[r]);
  }
}

template <class Body, int BX, int BY, int RY>
__global__ void __launch_bounds__(BX * BY)
tile_kernel(const typename Body::Params p, const float* __restrict__ v_in,
            float* __restrict__ v_out, const Planes<Body::kPlanes> planes,
            const Window win, int height, int width, int n_sub,
            unsigned slow_mask, float* __restrict__ probe, int probe_row,
            int probe_col, long long probe_index) {
  constexpr int EW = BX, EH = BY * RY, kP = Body::kPlanes;
  extern __shared__ float smem[];   // two EH x EW buffers of V
  const int tw = EW - 2 * n_sub;
  const int th = EH - 2 * n_sub;
  const int r0 = win.row0 + blockIdx.y * th - n_sub;
  const int c0 = win.col0 + blockIdx.x * tw - n_sub;
  const int tx = threadIdx.x;
  const int gj = c0 + tx;
  const Reach reach = {
      max(win.row0 - n_sub, 0), min(win.row1 + n_sub, height),
      max(win.col0 - n_sub, 0), min(win.col1 + n_sub, width)};
  const bool col_in = gj >= reach.col_lo && gj < reach.col_hi;

  float q[RY][kP];
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int a = threadIdx.y + r * BY;
    const int gi = r0 + a;
    if (col_in && gi >= reach.row_lo && gi < reach.row_hi) {
      const long long idx =
          (long long)(gi - win.rstart) * win.pitch + (gj - win.cstart);
      smem[a * EW + tx] = v_in[idx];
#pragma unroll
      for (int k = 0; k < kP; ++k) q[r][k] = planes.in[k][idx];
    }
  }
  __syncthreads();

  for (int s = 0; s < n_sub; ++s) {
    const float* cur = smem + (s & 1) * (EH * EW);
    float* nxt = smem + ((s + 1) & 1) * (EH * EW);
    if ((slow_mask >> s) & 1u) {
      tile_substep<Body, BX, BY, RY, true>(p, cur, nxt, q, s, r0, c0, reach,
                                           height, width);
    } else {
      tile_substep<Body, BX, BY, RY, false>(p, cur, nxt, q, s, r0, c0, reach,
                                            height, width);
    }
    __syncthreads();
  }

  const float* fin = smem + (n_sub & 1) * (EH * EW);
  if (gj < win.col0 || gj >= win.col1 || tx < n_sub || tx >= n_sub + tw) {
    return;
  }
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int a = threadIdx.y + r * BY;
    const int gi = r0 + a;
    if (gi < win.row0 || gi >= win.row1 || a < n_sub || a >= n_sub + th) {
      continue;
    }
    const long long idx =
        (long long)(gi - win.rstart) * win.pitch + (gj - win.cstart);
    const float v1 = fin[a * EW + tx];
    v_out[idx] = v1;
#pragma unroll
    for (int k = 0; k < kP; ++k) planes.out[k][idx] = q[r][k];
    if (probe != nullptr && gi == probe_row && gj == probe_col) {
      probe[probe_index] = Body::probe(p, v1);
    }
  }
}

// Launch the tiles that cover `win` (which must lie inside the domain) and
// return cudaGetLastError().
template <class Body, int BX, int BY, int RY>
cudaError_t launch_tiles(const typename Body::Params& p, const float* v_in,
                         float* v_out, const Planes<Body::kPlanes>& planes,
                         const Window& win, int height, int width, int n_sub,
                         unsigned slow_mask, float* probe, int probe_row,
                         int probe_col, long long probe_index,
                         cudaStream_t stream) {
  constexpr int EW = BX, EH = BY * RY;
  const int tw = EW - 2 * n_sub;
  const int th = EH - 2 * n_sub;
  if (tw < 1 || th < 1) return cudaErrorInvalidValue;   // empty interior
  if (win.row0 < 0 || win.row1 > height || win.row0 >= win.row1 ||
      win.col0 < 0 || win.col1 > width || win.col0 >= win.col1) {
    return cudaErrorInvalidValue;
  }
  const long long gx = (win.col1 - win.col0 + tw - 1) / tw;
  const long long gy = (win.row1 - win.row0 + th - 1) / th;
  if (gy > 65535 || gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = 2 * EH * EW * sizeof(float);
  // a larger tile needs cudaFuncAttributeMaxDynamicSharedMemorySize first
  static_assert(smem <= 48 * 1024, "V's two buffers exceed 48 KB");
  tile_kernel<Body, BX, BY, RY>
      <<<dim3((unsigned)gx, (unsigned)gy), dim3(BX, BY), smem, stream>>>(
          p, v_in, v_out, planes, win, height, width, n_sub, slow_mask, probe,
          probe_row, probe_col, probe_index);
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
