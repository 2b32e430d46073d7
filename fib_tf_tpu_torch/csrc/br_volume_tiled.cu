// One whole Beeler-Reuter outer step (all five substeps) of a [D, H, W]
// volume per launch on Hopper (sm_90a): in-plane tiles over the full depth,
// temporally blocked, with a halo of one ring per substep in the tiled
// directions and none along z.
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_volume.py::
// make_tiled_volume_step, which run_volume (engine/volume.py) runs past the
// 32 MB whole-volume envelope.  That kernel DMAs `tile_rows + 2K` full-width
// rows of every z-slice, so the z coupling is complete inside the block and
// only the row direction is temporally blocked.  This kernel keeps that idea
// (full depth per block, no z halo) and tiles both in-plane axes, as
// br_tiled.cu does in 2D: full-width rows of all D slices do not fit 227 KB.
// It computes the same function as five launches of br_volume.cu, and the
// per-cell arithmetic is the same code (br_cell.cuh, unchanged).
//
// What it computes.  Block (bx, by) owns an interior of TH x TW in-plane
// cells over all D slices.  It loads the tile extended by K = n_sub rings
// (EH x EW = (TH + 2K) x (TW + 2K) per slice, every slice), runs the K
// substeps on it and writes back the interior.  Substep s updates the
// in-plane ring [s+1, E-2-s] of every slice: the neighbours it reads (in
// plane, and in the slices above and below, which the block holds whole)
// were updated at substep s-1 or loaded, so every value computed is exact.
//
// Boundary, on GLOBAL indices, every substep: a cell (z, i, j) reads its
// stencil point (z+dz, i+di, j+dj) at V[clamp(z+dz), clamp(i+di),
// clamp(j+dj)] with clamp(k) = min(max(k, 1), N-2), as in br_volume.cu.
// Clamped points lie in the domain and within one cell, so a tile at the
// domain's edge never loads or computes outside it; ragged edges are
// masked, so any D, H, W >= 3 runs while the tile fits (below).
//
// What stays where.  BR has eight planes.  A thread block cannot keep the
// seven per-cell planes of a full-depth column in registers (7*D floats, 56
// at D = 8, per column), so this design keeps the whole extended tile in
// shared memory: V double-buffered across substeps (2 planes) and the seven
// per-cell planes (updated in place: the tile is the block's own copy),
// 9 * D * EH * EW floats.  The tile is EW = 32 columns wide (one warp, so
// shared-memory rows are conflict-free) and EH rows tall, the most that fits
// 227 KB at this depth, capped at 64; the host computes EH
// (ops/cuda_volume_tiled.py tile_rows) and passes it in.  At D = 8 that is
// 25 x 32 extended, 15 x 22 interior.  A deeper volume has a shorter tile;
// past D = 18 no interior is left after a 5-ring halo and run_volume takes
// the substep kernel instead.  The alternative that keeps the per-cell
// planes in a per-block scratch in device memory gets a larger tile (V
// alone in shared memory), but moves those planes through L2/HBM on every
// substep: 2 x 28 bytes per cell per substep against 32 read + 32 written
// per cell per outer step here.
//
// Memory: every plane is read from `*_in` and written to `*_out`, all
// distinct: a block's halo holds its neighbours' interior cells, which those
// blocks rewrite while it may still be loading them.
//
// Schedule: bit s of `slow_mask` selects the SLOW body for substep s.  The
// thread that owns the probe cell writes its normalised final V to
// probe[probe_index].
//
// What bounds it.  Per outer step it reads the state once and writes it
// once, 8 planes each way: 134 MB at 8x512x512 float32, plus the halo
// overfetch (EH*EW / TH*TW = 2.42 at D = 8, mostly L2 hits, since
// neighbouring blocks read the same rings), so >= 40 us from HBM.  Five
// launches of br_volume.cu move four times as much.  The price is the
// redundant compute in the rings (1.52x the interior's cells over the five
// substeps at D = 8, 1.84x counting the idle lanes of each warp) at about
// 180 FLOP per cell per substep.  One block of 1024 threads per SM (the
// tile takes all its shared memory), so loads and compute do not overlap.
// The better design streams through z with a five-level pipeline and the
// per-cell planes in registers (later work).
//
// Simple first: plain loads and stores, no TMA, cp.async or wgmma.
//
// Built by fib_tf_tpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface (no --use_fast_math: logf feeds e_Ca).

#include <cuda_runtime.h>
#include <string.h>

#include "br_cell.cuh"

namespace {

using fibtorch::BeelerReuterCell;
using fibtorch::BrParams;
using fibtorch::clamp_index;
using fibtorch::kParamFloats;
using fibtorch::laplace9;

// Per-cell plane pointers, by value: read from `in`, written to `out`.
template <int N>
struct Planes {
  const float* in[N];
  float* out[N];
};

// The tile: kTileW columns (one per thread in x) by tile_h rows per slice;
// kThreadsY threads in y stride over the D * tile_h rows of the tile.
constexpr int kTileW = 32;
constexpr int kThreadsY = 32;
constexpr int kTileHMax = 64;
// the most dynamic shared memory one block may take on sm_90
constexpr int kSmemMax = 232448;

// Substep s on the ring [s+1, E-2-s] of every slice of the tile: read V
// from `cur`, write the new V to `nxt`, advance the per-cell planes `q` in
// place.  r0 / c0 are the global row / column of local cell (0, 0).
template <class Body, bool SLOW>
__device__ __forceinline__ void substep(const typename Body::Params& p,
                                        float dz2, const float* cur,
                                        float* nxt, float* q, int s,
                                        int depth, int tile_h, int r0,
                                        int c0, int height, int width) {
  constexpr int EW = kTileW, kP = Body::kPlanes;
  const int slab = tile_h * EW;
  const int vol = depth * slab;
  const int b = threadIdx.x;
  const int gj = c0 + b;
  if (gj < 0 || gj >= width || b < s + 1 || b > EW - 2 - s) return;
  const int bw = clamp_index(gj - 1, width) - c0;
  const int bc = clamp_index(gj, width) - c0;
  const int be = clamp_index(gj + 1, width) - c0;
  for (int r = threadIdx.y; r < depth * tile_h; r += blockDim.y) {
    const int z = r / tile_h;
    const int a = r - z * tile_h;
    const int gi = r0 + a;
    if (gi < 0 || gi >= height || a < s + 1 || a > tile_h - 2 - s) continue;
    const int rn = (clamp_index(gi - 1, height) - r0) * EW;
    const int rc = (clamp_index(gi, height) - r0) * EW;
    const int rs = (clamp_index(gi + 1, height) - r0) * EW;
    const float* sc = cur + clamp_index(z, depth) * slab;
    const float* su = cur + clamp_index(z - 1, depth) * slab;
    const float* sd = cur + clamp_index(z + 1, depth) * slab;
    const float v0 = sc[rc + bc];
    const float planar = laplace9(sc[rn + bc], sc[rs + bc], sc[rc + bw],
                                  sc[rc + be], sc[rn + bw], sc[rs + bw],
                                  sc[rn + be], sc[rs + be], v0);
    const float lap =
        planar + dz2 * ((su[rc + bc] - 2.0f * v0) + sd[rc + bc]);
    const int l = r * EW + b;
    float qq[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) qq[k] = q[k * vol + l];
    nxt[l] = Body::template update<SLOW>(p, v0, lap, qq);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      // the frozen body leaves the slow gates as they are: skip their stores
      if (SLOW || k == Body::kC || k == Body::kM || k == Body::kH) {
        q[k * vol + l] = qq[k];
      }
    }
  }
}

template <class Body>
__global__ void __launch_bounds__(kTileW * kThreadsY, 1)
volume_tiled_kernel(const typename Body::Params p, const float dz2,
                    const float* __restrict__ v_in, float* __restrict__ v_out,
                    const Planes<Body::kPlanes> planes, int depth, int height,
                    int width, int tile_h, int n_sub, unsigned slow_mask,
                    float* __restrict__ probe, int probe_z, int probe_row,
                    int probe_col, long long probe_index) {
  constexpr int EW = kTileW, kP = Body::kPlanes;
  // V's two buffers, then the kP per-cell planes, each [depth][tile_h][EW]
  extern __shared__ float smem[];
  const int vol = depth * tile_h * EW;
  float* const q = smem + 2 * vol;
  const int tw = EW - 2 * n_sub;
  const int th = tile_h - 2 * n_sub;
  const int r0 = blockIdx.y * th - n_sub;
  const int c0 = blockIdx.x * tw - n_sub;
  const int b = threadIdx.x;
  const int gj = c0 + b;
  const bool col_in = gj >= 0 && gj < width;
  const long long plane = (long long)height * width;

  if (col_in) {
    for (int r = threadIdx.y; r < depth * tile_h; r += blockDim.y) {
      const int z = r / tile_h;
      const int gi = r0 + (r - z * tile_h);
      if (gi < 0 || gi >= height) continue;
      const long long g = z * plane + (long long)gi * width + gj;
      const int l = r * EW + b;
      smem[l] = v_in[g];
#pragma unroll
      for (int k = 0; k < kP; ++k) q[k * vol + l] = planes.in[k][g];
    }
  }
  __syncthreads();

  for (int s = 0; s < n_sub; ++s) {
    const float* cur = smem + (s & 1) * vol;
    float* nxt = smem + ((s + 1) & 1) * vol;
    if ((slow_mask >> s) & 1u) {
      substep<Body, true>(p, dz2, cur, nxt, q, s, depth, tile_h, r0, c0,
                          height, width);
    } else {
      substep<Body, false>(p, dz2, cur, nxt, q, s, depth, tile_h, r0, c0,
                           height, width);
    }
    __syncthreads();
  }

  const float* fin = smem + (n_sub & 1) * vol;
  if (!col_in || b < n_sub || b >= n_sub + tw) return;
  for (int r = threadIdx.y; r < depth * tile_h; r += blockDim.y) {
    const int z = r / tile_h;
    const int a = r - z * tile_h;
    const int gi = r0 + a;
    if (gi < 0 || gi >= height || a < n_sub || a >= n_sub + th) continue;
    const long long g = z * plane + (long long)gi * width + gj;
    const int l = r * EW + b;
    const float v1 = fin[l];
    v_out[g] = v1;
#pragma unroll
    for (int k = 0; k < kP; ++k) planes.out[k][g] = q[k * vol + l];
    if (probe != nullptr && z == probe_z && gi == probe_row &&
        gj == probe_col) {
      probe[probe_index] = Body::probe(p, v1);
    }
  }
}

// Shared memory of one block: V's two buffers and the per-cell planes.
size_t smem_bytes(int planes, int depth, int tile_h) {
  return (size_t)(2 + planes) * depth * tile_h * kTileW * sizeof(float);
}

}  // namespace

extern "C" {

// Number of floats the host passes as `params` (the BrParams layout).
int br_volume_tiled_param_floats() { return kParamFloats; }

// Number of per-cell planes besides V (BeelerReuterCell::kPlanes).
int br_volume_tiled_planes() { return BeelerReuterCell::kPlanes; }

// The tile's layout: its width in columns, the threads per block in y,
// the most rows per slice it takes, and the shared memory a block may use.
void br_volume_tiled_layout(int* tile_w, int* threads_y, int* tile_h_max,
                            int* smem_max) {
  *tile_w = kTileW;
  *threads_y = kThreadsY;
  *tile_h_max = kTileHMax;
  *smem_max = kSmemMax;
}

// Launch one outer step of `n_sub` substeps of a depth x height x width
// volume on `stream` of device `device` and return cudaGetLastError().
// `tile_h` is the extended tile's rows per slice (the host's tile_rows).
// `params` is a host array of br_volume_tiled_param_floats() floats;
// `planes_in` / `planes_out` are host arrays of `n_planes` device pointers
// in cuda_step.CELL_PLANES order.  No output may alias an input.  `probe`
// may be null.
int br_volume_tiled(const float* params, int n_params, float dz_ratio,
                    const float* v_in, float* v_out, void* const* planes_in,
                    void* const* planes_out, int n_planes, int depth,
                    int height, int width, int tile_h, int n_sub,
                    unsigned slow_mask, float* probe, int probe_z,
                    int probe_row, int probe_col, long long probe_index,
                    int device, void* stream) {
  using Body = BeelerReuterCell;
  const int tw = kTileW - 2 * n_sub;
  const int th = tile_h - 2 * n_sub;
  const size_t smem = smem_bytes(Body::kPlanes, depth, tile_h);
  if (n_params != kParamFloats || n_planes != Body::kPlanes || depth < 3 ||
      height < 3 || width < 3 || n_sub < 1 || n_sub > 32 || tw < 1 ||
      th < 1 || tile_h > kTileHMax || smem > (size_t)kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  const long long gx = (width + tw - 1) / tw;
  const long long gy = (height + th - 1) / th;
  if (gy > 65535 || gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Planes<Body::kPlanes> planes;
  const void* ins[Body::kPlanes + 1];
  const void* outs[Body::kPlanes + 1];
  ins[0] = v_in;
  outs[0] = v_out;
  for (int k = 0; k < Body::kPlanes; ++k) {
    planes.in[k] = static_cast<const float*>(planes_in[k]);
    planes.out[k] = static_cast<float*>(planes_out[k]);
    ins[k + 1] = planes_in[k];
    outs[k + 1] = planes_out[k];
  }
  for (int a = 0; a <= Body::kPlanes; ++a) {
    for (int c = 0; c <= Body::kPlanes; ++c) {
      if (outs[a] == ins[c]) return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // above 48 KB a block's dynamic shared memory must be allowed first; the
  // attribute is per device, set once on each
  static bool allowed[64] = {false};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(volume_tiled_kernel<Body>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return (int)err;
    allowed[device] = true;
  }
  BrParams p;
  memcpy(&p, params, sizeof(BrParams));
  const float dz2 = 2.0f * dz_ratio;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  volume_tiled_kernel<Body>
      <<<dim3((unsigned)gx, (unsigned)gy), dim3(kTileW, kThreadsY), smem,
         s>>>(p, dz2, v_in, v_out, planes, depth, height, width, tile_h,
              n_sub, slow_mask, probe, probe_z, probe_row, probe_col,
              probe_index);
  return (int)cudaGetLastError();
}

}  // extern "C"
