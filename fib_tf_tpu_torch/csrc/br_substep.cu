// One Beeler-Reuter substep on Hopper (sm_90a), one thread per cell.
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_step.py::make_pallas_step as
// the engine launches it for Beeler-Reuter cheby+skip (one substep per
// launch), with the body of fib_tf_tpu/models/beeler_reuter.py::solve
// (cheby + cheby_fold + cheby_currents).  The template flag SLOW selects the
// body: true advances the slow gates x1/j/d/f (the n=5 substep under skip,
// every substep without skip); false freezes them (the four n=0 substeps).
//
// Per cell (i, j), with clamp(k) = min(max(k, 1), N-2):
//   * v0 at stencil point (i+di, j+dj) is V[clamp(i+di), clamp(j+dj)]: the
//     SYMMETRIC boundary rewrite composed with the REFLECT pad of the
//     Laplacian (ops/stencil.py enforce_boundary + laplace);
//   * lap = N + S + W + E + 0.5*(NW + SW + NE + SE) - 6*v0;
//   * x = (v0 - mid) / half, S0 = 1, S1 = x, Sk = (2x)*S(k-1), k <= 8, and
//     each fit is d0 + sum dk*Sk (ops/chebyshev.py);
//   * folded Rush-Larsen g' = clip(g + (g - g_inf)*r, 1e-5, 0.99999);
//   * the four currents, V' = clip(v0 + diff*dt*lap - dt*sum(I), -85, 25)
//     and C' = C + dt*(-1e-7*iCa + 0.07*(1e-7 - C)).
//
// Load-bearing quirks kept from the reference:
//   * the currents use the PRE-update gates (beeler_reuter.py:340-343);
//   * V is clipped to [-85, 25] every substep; the clip propagates NaN, so
//     the engine's finiteness check still sees a blow-up;
//   * the slow gates' folded fit bakes 5*dt under skip (the caller's guard
//     at beeler_reuter.py:238-246), so SLOW substeps advance them 5*dt;
//   * the S1 stimulus (column 1 at +10 mV) is part of the initial state,
//     and the kernel treats it like any other V.
//
// Memory: V is double-buffered.  Neighbours are read from v_in and the new
// V goes to v_out, which must not alias v_in.  The other seven planes are
// per-cell, so each thread reads and rewrites its own cell IN PLACE.
//
// What bounds it: bandwidth.  A SLOW substep reads 8 planes and writes 8
// (16 MB at 512x512 float32), a frozen one reads 8 and writes 4; the card
// moves 3.35 TB/s from HBM, and the 8 MB state also fits its 50 MB L2.  The
// arithmetic (14 degree-8 fits, one logf) is far below the FLOP roof.  This
// first design is deliberately simple: no shared-memory tile (the 9-point
// reads of V hit L1/L2), one launch per substep, no CUDA graph.  The fused
// design, five substeps per launch in shared-memory tiles with a K-ring
// halo, is br_tiled.cu, which the engine runs past its 32 MB cutover.  CUDA
// graphs over a chunk, against the host launch overhead, are later work.
//
// The per-cell arithmetic lives in br_cell.cuh, shared with br_tiled.cu.
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

template <bool SLOW>
__global__ void br_substep_kernel(const BrParams p,
                                  const float* __restrict__ v_in,
                                  float* __restrict__ v_out,
                                  float* __restrict__ c_pl,
                                  float* __restrict__ m_pl,
                                  float* __restrict__ h_pl,
                                  float* __restrict__ j_pl,
                                  float* __restrict__ d_pl,
                                  float* __restrict__ f_pl,
                                  float* __restrict__ x1_pl,
                                  int height, int width,
                                  float* __restrict__ probe,
                                  int probe_row, int probe_col,
                                  long long probe_index) {
  using Cell = BeelerReuterCell;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= height || col >= width) return;

  const int rn = clamp_index(row - 1, height) * width;
  const int rc = clamp_index(row, height) * width;
  const int rs = clamp_index(row + 1, height) * width;
  const int cw = clamp_index(col - 1, width);
  const int cc = clamp_index(col, width);
  const int ce = clamp_index(col + 1, width);

  const float v0 = v_in[rc + cc];
  const float lap = laplace9(v_in[rn + cc], v_in[rs + cc], v_in[rc + cw],
                             v_in[rc + ce], v_in[rn + cw], v_in[rs + cw],
                             v_in[rn + ce], v_in[rs + ce], v0);

  // the per-cell planes, in Cell::Plane order
  float* const planes[Cell::kPlanes] = {c_pl, m_pl, h_pl, j_pl,
                                        d_pl, f_pl, x1_pl};
  const long long idx = (long long)row * width + col;
  float q[Cell::kPlanes];
#pragma unroll
  for (int k = 0; k < Cell::kPlanes; ++k) q[k] = planes[k][idx];
  const float v1 = Cell::update<SLOW>(p, v0, lap, q);
  v_out[idx] = v1;
#pragma unroll
  for (int k = 0; k < Cell::kPlanes; ++k) {
    // the frozen body leaves the slow gates as they are: skip their stores
    if (SLOW || k == Cell::kC || k == Cell::kM || k == Cell::kH) {
      planes[k][idx] = q[k];
    }
  }
  if (probe != nullptr && row == probe_row && col == probe_col) {
    probe[probe_index] = Cell::probe(p, v1);
  }
}

}  // namespace

extern "C" {

// Number of floats the host passes as `params` (the BrParams layout).
int br_param_floats() { return kParamFloats; }

// Launch one substep on `stream` of device `device` and return
// cudaGetLastError().  `params` is a host array of br_param_floats() floats,
// copied into the kernel's by-value argument.  `probe` may be null;
// otherwise the thread at (probe_row, probe_col) writes the normalized new V
// to probe[probe_index].
int br_substep(int slow, const float* params, int n_params,
               const float* v_in, float* v_out, float* c, float* m, float* h,
               float* j, float* d, float* f, float* x1, int height,
               int width, float* probe, int probe_row, int probe_col,
               long long probe_index, int device, void* stream) {
  if (n_params != kParamFloats || height < 3 || width < 3 || v_in == v_out) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BrParams p;
  memcpy(&p, params, sizeof(BrParams));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slow) {
    br_substep_kernel<true><<<grid, block, 0, s>>>(
        p, v_in, v_out, c, m, h, j, d, f, x1, height, width, probe,
        probe_row, probe_col, probe_index);
  } else {
    br_substep_kernel<false><<<grid, block, 0, s>>>(
        p, v_in, v_out, c, m, h, j, d, f, x1, height, width, probe,
        probe_row, probe_col, probe_index);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
