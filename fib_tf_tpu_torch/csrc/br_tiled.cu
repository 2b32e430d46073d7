// One whole Beeler-Reuter outer step (all five substeps) per launch on
// Hopper (sm_90a): 2D tiles, temporally blocked, with a halo of one ring per
// substep.
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_tiled.py::
// make_tiled_pallas_step, which the JAX engine runs for Beeler-Reuter once
// the state passes WHOLE_GRID_STATE_MB_MAX = 32 MB (any BR grid over 1024^2).
// It computes the same function as five launches of br_substep.cu, and the
// per-cell arithmetic is the same code (br_cell.cuh).
//
// What it computes.  Block (bx, by) owns an interior tile of TH x TW cells.
// It loads the tile extended by K = n_sub rings (EH x EW = (TH + 2K) x
// (TW + 2K)) from device memory, runs the K substeps on it and writes back
// the interior.  V lives in shared memory, double-buffered across substeps,
// because the stencil reads neighbours; the seven per-cell planes stay in
// registers for all K substeps.  Substep s updates only the local cells
// [s+1, E-2-s] of each axis: their neighbours were updated at substep s-1
// (or loaded), so every value computed is exact, and after K substeps the
// interior [K, E-K) is.  The outer rings are recomputed by the neighbouring
// blocks, whose interiors they are.
//
// Boundary, on GLOBAL indices, every substep: a cell (i, j) of the domain
// reads its stencil point (i+di, j+dj) at V[clamp(i+di), clamp(j+dj)] with
// clamp(k) = min(max(k, 1), N-2), the SYMMETRIC rewrite composed with the
// REFLECT pad, as in br_substep.cu (the TPU kernel's global-row masks in
// block_geometry compute the same).  Clamped points always lie in the
// domain and within one cell of (i, j), so the halo of a tile at the edge
// of the domain never needs cells outside it: those are neither loaded nor
// computed.  Ragged edges are masked, so any H, W >= 3 runs.
//
// Memory: every plane is read from `*_in` and written to `*_out`, all
// distinct.  Unlike br_substep.cu the per-cell planes cannot be updated in
// place: a block's halo holds its neighbours' interior cells, which those
// blocks rewrite while it may still be loading them.
//
// Schedule: bit s of `slow_mask` selects the SLOW body for substep s (the
// n=5 substep under skip advances the slow gates; the four n=0 substeps
// freeze them; without skip every substep is SLOW).  The thread that owns
// the probe pixel writes its normalised final V to probe[probe_index].
//
// What bounds it.  Per outer step it reads the state once and writes it
// once: 8 planes each way, 268 MB at 2048^2 float32, plus the halo
// overfetch (EH*EW / TH*TW, mostly served by L2, since neighbouring blocks
// read the same rings).  Five launches of br_substep.cu move four times as
// much (1.07 GB).  The price is redundant compute in the rings: about 180
// FLOP per cell per substep (14 degree-8 fits, the stencil, the currents,
// one logf), times the lanes the shrinking ring keeps busy per interior
// cell.  From the H100's data sheet (3.35 TB/s, 67 TFLOP/s fp32) both
// sides come to about 80 us per outer step at 2048^2.  Measured on an
// NVIDIA H100 80GB HBM3 at a 700 W limit, the kernel takes 334 us there
// against 395 us for five br_substep.cu launches (PERF.md): neither roof
// binds.  The likely binders, not yet profiled: instruction issue for the
// cell body, on 64-lane rows that stay busy across the ring, and the load
// and store phases, which one block per SM does not overlap with compute.
// The tile shape trades halo compute (larger tiles waste less) against
// registers per thread and threads per block.  Five shapes were timed
// against each other on the card (32x32 to 64x64 extended, 256 to 1024
// threads); the one built below was the fastest at 2048^2 (PERF.md).
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

// The tile shape: kBx x kBy threads, each owning kRy cells of one column
// (rows ty, ty + kBy, ...), so the extended tile is EW = kBx wide and
// EH = kBy * kRy tall: 64 x 64 with 1024 threads (ops/cuda_tiled.py TILE).
constexpr int kBx = 64, kBy = 16, kRy = 4;

// Substep s on the ring [s+1, E-2-s] of the tile: read V from `cur`, write
// the new V to `nxt`, advance the per-cell planes in `q`.  r0 / c0 are the
// global row / column of local cell (0, 0).
template <class Body, int BX, int BY, int RY, bool SLOW>
__device__ __forceinline__ void substep(const typename Body::Params& p,
                                        const float* __restrict__ cur,
                                        float* __restrict__ nxt,
                                        float (&q)[RY][Body::kPlanes],
                                        int s, int r0, int c0, int height,
                                        int width) {
  constexpr int EW = BX, EH = BY * RY;
  const int tx = threadIdx.x;
  const int gj = c0 + tx;
  if (gj < 0 || gj >= width || tx < s + 1 || tx > EW - 2 - s) return;
  const int bw = clamp_index(gj - 1, width) - c0;
  const int bc = clamp_index(gj, width) - c0;
  const int be = clamp_index(gj + 1, width) - c0;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int a = threadIdx.y + r * BY;
    const int gi = r0 + a;
    if (gi < 0 || gi >= height || a < s + 1 || a > EH - 2 - s) continue;
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
tiled_kernel(const typename Body::Params p, const float* __restrict__ v_in,
             float* __restrict__ v_out, const Planes<Body::kPlanes> planes,
             int height, int width, int n_sub, unsigned slow_mask,
             float* __restrict__ probe, int probe_row, int probe_col,
             long long probe_index) {
  constexpr int EW = BX, EH = BY * RY, kP = Body::kPlanes;
  extern __shared__ float smem[];   // two EH x EW buffers of V
  const int tw = EW - 2 * n_sub;
  const int th = EH - 2 * n_sub;
  const int r0 = blockIdx.y * th - n_sub;
  const int c0 = blockIdx.x * tw - n_sub;
  const int tx = threadIdx.x;
  const int gj = c0 + tx;
  const bool col_in = gj >= 0 && gj < width;

  float q[RY][kP];
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int a = threadIdx.y + r * BY;
    const int gi = r0 + a;
    if (col_in && gi >= 0 && gi < height) {
      const long long idx = (long long)gi * width + gj;
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
      substep<Body, BX, BY, RY, true>(p, cur, nxt, q, s, r0, c0, height,
                                      width);
    } else {
      substep<Body, BX, BY, RY, false>(p, cur, nxt, q, s, r0, c0, height,
                                       width);
    }
    __syncthreads();
  }

  const float* fin = smem + (n_sub & 1) * (EH * EW);
  if (!col_in || tx < n_sub || tx >= n_sub + tw) return;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int a = threadIdx.y + r * BY;
    const int gi = r0 + a;
    if (gi < 0 || gi >= height || a < n_sub || a >= n_sub + th) continue;
    const long long idx = (long long)gi * width + gj;
    const float v1 = fin[a * EW + tx];
    v_out[idx] = v1;
#pragma unroll
    for (int k = 0; k < kP; ++k) planes.out[k][idx] = q[r][k];
    if (probe != nullptr && gi == probe_row && gj == probe_col) {
      probe[probe_index] = Body::probe(p, v1);
    }
  }
}

template <class Body, int BX, int BY, int RY>
cudaError_t launch(const typename Body::Params& p, const float* v_in,
                   float* v_out, const Planes<Body::kPlanes>& planes,
                   int height, int width, int n_sub, unsigned slow_mask,
                   float* probe, int probe_row, int probe_col,
                   long long probe_index, cudaStream_t stream) {
  constexpr int EW = BX, EH = BY * RY;
  const int tw = EW - 2 * n_sub;
  const int th = EH - 2 * n_sub;
  if (tw < 1 || th < 1) return cudaErrorInvalidValue;   // empty interior
  const long long gx = (width + tw - 1) / tw;
  const long long gy = (height + th - 1) / th;
  if (gy > 65535 || gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = 2 * EH * EW * sizeof(float);
  // a larger tile needs cudaFuncAttributeMaxDynamicSharedMemorySize first
  static_assert(smem <= 48 * 1024, "V's two buffers exceed 48 KB");
  tiled_kernel<Body, BX, BY, RY>
      <<<dim3((unsigned)gx, (unsigned)gy), dim3(BX, BY), smem, stream>>>(
          p, v_in, v_out, planes, height, width, n_sub, slow_mask, probe,
          probe_row, probe_col, probe_index);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of floats the host passes as `params` (the BrParams layout).
int br_tiled_param_floats() { return kParamFloats; }

// Number of per-cell planes besides V (BeelerReuterCell::kPlanes).
int br_tiled_planes() { return BeelerReuterCell::kPlanes; }

// The tile shape: threads per block in x and y, and cells per thread
// along y.
void br_tiled_tile_shape(int* threads_x, int* threads_y,
                         int* rows_per_thread) {
  *threads_x = kBx;
  *threads_y = kBy;
  *rows_per_thread = kRy;
}

// Launch one outer step of `n_sub` substeps on `stream` of device
// `device` and return cudaGetLastError().  `params` is a host array of
// br_tiled_param_floats() floats; `planes_in` / `planes_out` are host
// arrays of `n_planes` device pointers in cuda_step.CELL_PLANES order.  No
// output may alias an input.  `probe` may be null.
int br_tiled(const float* params, int n_params, const float* v_in,
             float* v_out, void* const* planes_in, void* const* planes_out,
             int n_planes, int height, int width, int n_sub,
             unsigned slow_mask, float* probe, int probe_row, int probe_col,
             long long probe_index, int device, void* stream) {
  using Body = BeelerReuterCell;
  if (n_params != kParamFloats || n_planes != Body::kPlanes ||
      height < 3 || width < 3 || n_sub < 1 || n_sub > 32) {
    return (int)cudaErrorInvalidValue;
  }
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
    for (int b = 0; b <= Body::kPlanes; ++b) {
      if (outs[a] == ins[b]) return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BrParams p;
  memcpy(&p, params, sizeof(BrParams));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch<Body, kBx, kBy, kRy>(
      p, v_in, v_out, planes, height, width, n_sub, slow_mask, probe,
      probe_row, probe_col, probe_index, s);
}

}  // extern "C"
