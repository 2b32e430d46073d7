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
// reads of V hit L1/L2), one launch per substep, no CUDA graph.  Later work:
// shared-memory tiles, fusing the five substeps of an outer step with a
// K-ring halo (the design of the TPU's tiled kernel, ops/pallas_tiled.py),
// and CUDA graphs over a chunk to remove the host launch overhead.
//
// Built by fib_tf_tpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface (no --use_fast_math: logf feeds e_Ca).

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kDeg = 8;
constexpr int kTerms = kDeg + 1;

// Order of the fits in BrParams::coef; fib_tf_tpu_torch/ops/cuda_step.py
// packs them in the same order (FIT_ORDER).
enum Fit {
  X1_INF, X1_RL, M_INF, M_RL, H_INF, H_RL, J_INF, J_RL,
  D_INF, D_RL, F_INF, F_RL, I_K1, I_X1F, kFits
};

struct BrParams {
  float coef[kFits][kTerms];
  // conductances with their g_scale factors folded in: g_Na*4, g_NaC*0.005,
  // g_s*0.09, and the iK1 / ix1 factors
  float g_na, g_nac, g_s, s_k1, s_x1;
  float dt, diff_dt;      // dt and diff*dt, rounded from double once
  float cheb_mid, cheb_half;   // Chebyshev domain: x = (v - mid) / half
  float v_min, v_span;    // probe normalisation: (v - v_min) / v_span
};

constexpr int kParamFloats = sizeof(BrParams) / sizeof(float);

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  // NaN-propagating, like jnp.clip / torch.clamp
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float cheb(const float* d, const float* s) {
  float r = d[0];
#pragma unroll
  for (int k = 1; k < kTerms; ++k) r = r + d[k] * s[k];
  return r;
}

__device__ __forceinline__ float gate(const BrParams& p, int fit_inf,
                                      float g, const float* s) {
  const float inf = cheb(p.coef[fit_inf], s);
  const float rl = cheb(p.coef[fit_inf + 1], s);
  return clip(g + (g - inf) * rl, 0.00001f, 0.99999f);
}

__device__ __forceinline__ int clamp_index(int k, int n) {
  return min(max(k, 1), n - 2);
}

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
  const float lap = v_in[rn + cc] + v_in[rs + cc] + v_in[rc + cw] +
                    v_in[rc + ce] +
                    0.5f * (v_in[rn + cw] + v_in[rs + cw] + v_in[rn + ce] +
                            v_in[rs + ce]) -
                    6.0f * v0;

  float s[kTerms];
  const float x = (v0 - p.cheb_mid) / p.cheb_half;
  const float x2 = 2.0f * x;
  s[0] = 1.0f;
  s[1] = x;
#pragma unroll
  for (int k = 2; k < kTerms; ++k) s[k] = x2 * s[k - 1];

  const long long idx = (long long)row * width + col;
  const float c = c_pl[idx];
  const float m = m_pl[idx];
  const float h = h_pl[idx];
  const float jg = j_pl[idx];
  const float d = d_pl[idx];
  const float f = f_pl[idx];
  const float x1 = x1_pl[idx];

  m_pl[idx] = gate(p, M_INF, m, s);
  h_pl[idx] = gate(p, H_INF, h, s);
  if (SLOW) {
    x1_pl[idx] = gate(p, X1_INF, x1, s);
    j_pl[idx] = gate(p, J_INF, jg, s);
    d_pl[idx] = gate(p, D_INF, d, s);
    f_pl[idx] = gate(p, F_INF, f, s);
  }

  // currents from the pre-update gates
  const float i_k1 = p.s_k1 * cheb(p.coef[I_K1], s);
  const float i_x1 = p.s_x1 * (x1 * cheb(p.coef[I_X1F], s));
  const float i_na = (p.g_na * (m * m * m) * h * jg + p.g_nac) * (v0 - 50.0f);
  const float e_ca = -82.3f - 13.0278f * logf(c);
  const float i_ca = p.g_s * d * f * (v0 - e_ca);
  const float i_sum = i_k1 + i_x1 + i_na + i_ca;

  const float v1 = clip(v0 + p.diff_dt * lap - p.dt * i_sum, -85.0f, 25.0f);
  v_out[idx] = v1;
  c_pl[idx] = c + p.dt * (-1.0e-7f * i_ca + 0.07f * (1.0e-7f - c));
  if (probe != nullptr && row == probe_row && col == probe_col) {
    probe[probe_index] = (v1 - p.v_min) / p.v_span;
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
