// The per-cell Beeler-Reuter update, and what every cell body shares: the
// clamped stencil and the 9-point Laplacian.  The kernels own the stencil
// and the memory traffic; a cell body owns what happens at one cell once
// its centre values and its Laplacian are known.  The same kernels run
// three bodies: BeelerReuterCell here, FentonCell (fenton_cell.cuh) and
// MsCell (ms_cell.cuh).
//
// A model's cell body is a struct with:
//   Params        the kernel's by-value parameter block (plain floats);
//   kPlanes       the number of per-cell planes besides the potential;
//   update<SLOW>  (params, v0, raw, lap, q[kPlanes]) -> new potential,
//                 updating q in place.  v0 is the boundary-enforced centre
//                 (the cell's clamped stencil point), raw the cell's own
//                 value: they differ on the domain's outer ring only.
//                 Fenton's and Mitchell-Schaeffer's rates take raw, BR
//                 ignores it;
//   stores<SLOW>  (k) -> whether the body may have changed plane k (the
//                 substep kernels skip the other stores);
//   probe         (params, v) -> the normalised potential the probe records.
// SLOW selects BR's substep that advances the slow gates; the other bodies
// ignore it.
//
// No --use_fast_math: logf feeds e_Ca and the fits want IEEE division.

#pragma once

#include <cuda_runtime.h>

namespace fibtorch {

constexpr int kDeg = 8;
constexpr int kTerms = kDeg + 1;

// Order of the fits in BrParams; fib_tf_tpu_torch/ops/cuda_step.py packs
// them in the same order (FIT_ORDER).
enum Fit {
  X1_INF, X1_RL, M_INF, M_RL, H_INF, H_RL, J_INF, J_RL,
  D_INF, D_RL, F_INF, F_RL, I_K1, I_X1F, kFits
};

// A fit is d0 + d1*S1 + ... + d8*S8, summed in that order (cheb).  ptxas
// takes no FFMA operand from the constant bank here: a coefficient reaches
// its FFMA in a uniform register (ULDC, one load for a warp) or in a
// register of every thread (LDC), and an FFMA takes one uniform register at
// most, so the first FFMA of a fit, d0 + d1*S1, takes one of the two in a
// thread's register.  BrParams holds each fit twice.  In `d0` and `coef`
// the constant terms lie apart, two fits' to a pair, so that one LDC.64
// serves both fits of a gate, and d1..d8 in pairs of one fit, which ptxas
// keeps in uniform registers: the tile kernels' 64-register body issues
// 4 LDC per frozen and 8 per SLOW cell-substep there, against 7 and 15 on
// `rows`, and kernels 2 and 3 ran 3.7% and 2.1% faster for it; kernels 4
// and 5 read it too.  In `rows` each fit's nine terms lie together; kernel
// 1, kernel 6 and the GEOM tiles, which have registers to spare, ran up to
// 1.8% slower on the split terms and read these (FIBTORCH_BR_FIT_ROWS,
// defined by their sources).  PERF.md has the times.
struct BrParams {
  float d0[kFits];            // each fit's constant term
  float coef[kFits][kDeg];    // each fit's d1..d8
  // conductances with their g_scale factors folded in: g_Na*4, g_NaC*0.005,
  // g_s*0.09, and the iK1 / ix1 factors
  float g_na, g_nac, g_s, s_k1, s_x1;
  float dt, diff_dt;      // dt and diff*dt, rounded from double once
  float cheb_mid, cheb_half;   // Chebyshev domain: x = (v - mid) / half
  float v_min, v_span;    // probe normalisation: (v - v_min) / v_span
  float pad;              // `rows` at an even float, as the loads pair them
  float rows[kFits][kTerms];   // each fit's d0..d8
};

constexpr int kParamFloats = sizeof(BrParams) / sizeof(float);

// The floats of a body's parameter block, as the host packs them.
template <class Body>
constexpr int param_floats() {
  return sizeof(typename Body::Params) / sizeof(float);
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  // NaN-propagating, like jnp.clip / torch.clamp
  return x < lo ? lo : (x > hi ? hi : x);
}

// The SYMMETRIC boundary rewrite composed with the REFLECT pad of the
// Laplacian: the stencil point k of an N-cell axis reads cell clamp(k).
__device__ __forceinline__ int clamp_index(int k, int n) {
  return min(max(k, 1), n - 2);
}

// The 9-point Laplacian of ops/stencil.py from the centre and its eight
// neighbours (n/s = row -/+ 1, w/e = column -/+ 1).
__device__ __forceinline__ float laplace9(float n, float s, float w, float e,
                                          float nw, float sw, float ne,
                                          float se, float c) {
  return n + s + w + e + 0.5f * (nw + sw + ne + se) - 6.0f * c;
}

__device__ __forceinline__ float cheb(const float* d, const float* s) {
  float r = d[0];
#pragma unroll
  for (int k = 1; k < kTerms; ++k) r = r + d[k] * s[k];
  return r;
}

// Fit `fit` of BrParams at the powers s.
__device__ __forceinline__ float br_fit(const BrParams& p, int fit,
                                        const float* s) {
#ifdef FIBTORCH_BR_FIT_ROWS
  return cheb(p.rows[fit], s);
#else
  float r = p.d0[fit];
#pragma unroll
  for (int k = 1; k < kTerms; ++k) r = r + p.coef[fit][k - 1] * s[k];
  return r;
#endif
}

__device__ __forceinline__ float gate(const BrParams& p, int fit_inf,
                                      float g, const float* s) {
  const float inf = br_fit(p, fit_inf, s);
  const float rl = br_fit(p, fit_inf + 1, s);
  return clip(g + (g - inf) * rl, 0.00001f, 0.99999f);
}

struct BeelerReuterCell {
  using Params = BrParams;
  // the per-cell planes, in the order of cuda_step.CELL_PLANES
  enum Plane { kC, kM, kH, kJ, kD, kF, kX1, kPlanes };

  // The frozen body leaves the slow gates as they are.
  template <bool SLOW>
  __host__ __device__ static constexpr bool stores(int k) {
    return SLOW || k == kC || k == kM || k == kH;
  }

  // One substep of the cell (beeler_reuter.py::solve with cheby +
  // cheby_fold + cheby_currents): SLOW advances the slow gates x1/j/d/f,
  // whose folded fit bakes 5*dt under skip; otherwise they stay frozen.
  // The currents use the PRE-update gates; V is clipped to [-85, 25].
  // Everything is taken at v0; the raw centre is not read.
  template <bool SLOW>
  __device__ __forceinline__ static float update(const Params& p, float v0,
                                                 float /* raw */, float lap,
                                                 float (&q)[kPlanes]) {
    float s[kTerms];
    const float x = (v0 - p.cheb_mid) / p.cheb_half;
    const float x2 = 2.0f * x;
    s[0] = 1.0f;
    s[1] = x;
#pragma unroll
    for (int k = 2; k < kTerms; ++k) s[k] = x2 * s[k - 1];

    const float c = q[kC];
    const float m = q[kM];
    const float h = q[kH];
    const float jg = q[kJ];
    const float d = q[kD];
    const float f = q[kF];
    const float x1 = q[kX1];

    q[kM] = gate(p, M_INF, m, s);
    q[kH] = gate(p, H_INF, h, s);
    if (SLOW) {
      q[kX1] = gate(p, X1_INF, x1, s);
      q[kJ] = gate(p, J_INF, jg, s);
      q[kD] = gate(p, D_INF, d, s);
      q[kF] = gate(p, F_INF, f, s);
    }

    // currents from the pre-update gates
    const float i_k1 = p.s_k1 * br_fit(p, I_K1, s);
    const float i_x1 = p.s_x1 * (x1 * br_fit(p, I_X1F, s));
    const float i_na = (p.g_na * (m * m * m) * h * jg + p.g_nac) * (v0 - 50.0f);
    const float e_ca = -82.3f - 13.0278f * logf(c);
    const float i_ca = p.g_s * d * f * (v0 - e_ca);
    const float i_sum = i_k1 + i_x1 + i_na + i_ca;

    q[kC] = c + p.dt * (-1.0e-7f * i_ca + 0.07f * (1.0e-7f - c));
    return clip(v0 + p.diff_dt * lap - p.dt * i_sum, -85.0f, 25.0f);
  }

  __device__ __forceinline__ static float probe(const Params& p, float v) {
    return (v - p.v_min) / p.v_span;
  }
};

}  // namespace fibtorch
