// The per-cell Fenton 4v update (Cherry-Ehrlich-Nattel-Fenton 2007,
// left-atrial set): the cell bodies that kernels 1-4 and 6 of the port run
// for fib_tf_tpu_torch/models/fenton.py::Fenton4v (the reference's
// fib_tf_tpu/models/fenton.py), FentonCell with explicit Euler and
// FentonAb2Cell with Adams-Bashforth-2 (SimConfig.ab2).  The contract of a
// cell body is in br_cell.cuh.
//
// One substep, all in float32 and in the plain path's order of operations:
//   du = -(i_fi + i_si + i_so), the currents and the gate rates taken at the
//   cell's RAW u; u' = (u0 + dt*du) + (diff*dt)*lap with u0 the
//   boundary-enforced centre; v' = v + dt*dv, w' = w + dt*dw, s' = s + dt*ds.
// The step functions are the reference's sign() forms, H(0) = G(0) = 0.5,
// with a sign that passes NaN through, so a blow-up stays visible to the
// engine's finiteness check.  The branch thresholds U_C and U_W compare the
// raw u with float32 constants, as the plain path does.  Every substep is
// the same body: SLOW means nothing here.  Two tanhf per cell-substep; the
// division by C_SO stays a division (no --use_fast_math).
//
// With ab2, every plane takes g' = g + dt * (1.5 f - 0.5 f_prev) from its
// derivative plane (_du_, _dv_, _dw_, _ds_), u's rate with its diffusion
// term: gu = du + diff * lap, u' = u0 + dt * (1.5 gu - 0.5 _du_); the new
// rates replace the derivative planes.
//
// The constants are the port's copies of the reference's (models/fenton.py
// there and here), the products of two of them rounded from double once, as
// Python computes them before they meet a float32 tensor.

#pragma once

#include <cuda_runtime.h>

namespace fibtorch {

struct FentonParams {
  float dt, diff_dt;         // dt and diff*dt, rounded from double once
  float s_fi, s_si, s_so;    // the g_scale factors of the three currents
  float v_min, v_span;       // probe normalisation: (u - v_min) / v_span
};

struct FentonAb2Params {
  float dt, diff;            // dt and diff, rounded from double once
  float s_fi, s_si, s_so;    // the g_scale factors of the three currents
  float v_min, v_span;       // probe normalisation: (u - v_min) / v_span
};

namespace fenton {

constexpr float kTauVPlus = 3.33f;
constexpr float kTauVMinus = 19.2f;
constexpr float kTauWPlus = 160.0f;
constexpr float kTauWMinus1 = 75.0f;
constexpr float kTauWMinus2 = 75.0f;
constexpr float kTauD = 0.065f;
constexpr float kTauSi = 31.8364f;
constexpr float kTauSo = 31.8364f;
constexpr float kTauA = 0.009f;
constexpr float kUc = 0.23f;
constexpr float kUw = 0.146f;
constexpr float kU0 = 0.0f;
constexpr float kUm = 1.0f;
constexpr float kUcsi = 0.8f;
constexpr float kUso = 0.3f;
constexpr float kKs = 3.0f;
constexpr float kBso = 0.84f;
constexpr float kCso = 0.02f;
constexpr float kRsMinus = 1.2f;
// 0.5 * (A_SO - TAU_A) and R_S_PLUS - R_S_MINUS, in double, then rounded
constexpr float kSoHalfSpan = (float)(0.5 * (0.115 - 0.009));
constexpr float kRsSpan = (float)(0.02 - 1.2);

// sign(x) with sign(+-0) = +-0 and sign(NaN) = NaN, as jnp.sign.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// H(x) = (1 + sign(x)) / 2 and G(x) = (1 - sign(x)) / 2.
__device__ __forceinline__ float step_up(float x) {
  return (1.0f + sign_of(x)) * 0.5f;
}

__device__ __forceinline__ float step_down(float x) {
  return (1.0f - sign_of(x)) * 0.5f;
}

// du, dv, dw, ds at the raw centre u (fenton.py::differentiate), with the
// currents' g_scale factors s_fi, s_si, s_so.
__device__ __forceinline__ void rates(float s_fi, float s_si, float s_so,
                                      float u, float v, float w, float s,
                                      float& du, float& dv, float& dw,
                                      float& ds) {
  const float h_c = step_up(u - kUc);
  const float i_fi = s_fi * (-v * h_c * (u - kUc) * (kUm - u) / kTauD);
  const float i_si = s_si * (-w * s / kTauSi);
  const float i_so =
      s_so * (kSoHalfSpan * (1.0f + tanhf((u - kBso) / kCso)) +
              (u - kU0) * step_down(u - kUso) / kTauSo +
              step_up(u - kUso) * kTauA);
  du = -(i_fi + i_si + i_so);
  dv = u > kUc ? -v / kTauVPlus : (1.0f - v) / kTauVMinus;
  dw = u > kUc ? -w / kTauWPlus
               : (u > kUw ? (1.0f - w) / kTauWMinus2
                          : (1.0f - w) / kTauWMinus1);
  const float r_s = kRsSpan * h_c + kRsMinus;
  ds = r_s * (0.5f * (1.0f + tanhf((u - kUcsi) * kKs)) - s);
}

}  // namespace fenton

struct FentonCell {
  using Params = FentonParams;
  // the per-cell planes, in the order of cuda_step.FENTON_PLANES
  enum Plane { kV, kW, kS, kPlanes };

  template <bool SLOW>
  __host__ __device__ static constexpr bool stores(int) {
    return true;
  }

  // One explicit-Euler substep (fenton.py::solve): `u` is the raw centre,
  // `u0` the boundary-enforced one.
  template <bool SLOW>
  __device__ __forceinline__ static float update(const Params& p, float u0,
                                                 float u, float lap,
                                                 float (&q)[kPlanes]) {
    const float v = q[kV];
    const float w = q[kW];
    const float s = q[kS];
    float du, dv, dw, ds;
    fenton::rates(p.s_fi, p.s_si, p.s_so, u, v, w, s, du, dv, dw, ds);
    q[kV] = v + p.dt * dv;
    q[kW] = w + p.dt * dw;
    q[kS] = s + p.dt * ds;
    return u0 + p.dt * du + p.diff_dt * lap;
  }

  __device__ __forceinline__ static float probe(const Params& p, float u) {
    return (u - p.v_min) / p.v_span;
  }
};

struct FentonAb2Cell {
  using Params = FentonAb2Params;
  // the per-cell planes, in the order of cuda_step.FENTON_AB2_PLANES
  enum Plane { kV, kW, kS, kDu, kDv, kDw, kDs, kPlanes };

  template <bool SLOW>
  __host__ __device__ static constexpr bool stores(int) {
    return true;
  }

  // One Adams-Bashforth-2 substep (fenton.py::solve with ab2).
  template <bool SLOW>
  __device__ __forceinline__ static float update(const Params& p, float u0,
                                                 float u, float lap,
                                                 float (&q)[kPlanes]) {
    const float v = q[kV];
    const float w = q[kW];
    const float s = q[kS];
    float du, dv, dw, ds;
    fenton::rates(p.s_fi, p.s_si, p.s_so, u, v, w, s, du, dv, dw, ds);
    const float gu = du + p.diff * lap;
    q[kV] = v + p.dt * (1.5f * dv - 0.5f * q[kDv]);
    q[kW] = w + p.dt * (1.5f * dw - 0.5f * q[kDw]);
    q[kS] = s + p.dt * (1.5f * ds - 0.5f * q[kDs]);
    const float u1 = u0 + p.dt * (1.5f * gu - 0.5f * q[kDu]);
    q[kDu] = gu;
    q[kDv] = dv;
    q[kDw] = dw;
    q[kDs] = ds;
    return u1;
  }

  __device__ __forceinline__ static float probe(const Params& p, float u) {
    return (u - p.v_min) / p.v_span;
  }
};

}  // namespace fibtorch
