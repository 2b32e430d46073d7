// The per-cell Beeler-Reuter update for every variant but the main path's:
// the cell body BrVariantCell<AB2> that kernels 1-4 and 6 run for
// fib_tf_tpu_torch/models/beeler_reuter.py::BeelerReuter whenever its
// configuration is not cheby + cheby_fold + cheby_currents without ab2
// (that one is BeelerReuterCell, br_cell.cuh).  The contract of a cell
// body is in br_cell.cuh.
//
// The variant is a field of the parameter block, uniform across a launch,
// so that two instantiations (AB2 off and on) carry all eighteen
// combinations:
//   gate mode     kFold: g' = clip(g + (g - inf(V)) * r(V)), the multiplier
//                   r = expm1(-dt_g / tau) fitted at definition (the slow
//                   gates' fit bakes dt * slow_n);
//                 kChebyTau: Rush-Larsen on the fitted inf(V) and tau(V);
//                 kDirect: Rush-Larsen on a / (a + b) and 1 / (a + b) from
//                   the rate table (beeler_reuter.py::rate_torch, the
//                   linear term left out where c3 == 0);
//   current mode  kChebyCurrents: iK1 and ix1's voltage factor from their
//                   fits; kFastCurrents: one shared k = exp(0.04 V); kPlain:
//                   the five literal exponentials.
// Rush-Larsen is clip(g + (g - inf) * expm1f((-dt_n) / tau), 1e-5,
// 0.99999) with dt_n = dt for m and h and dt * slow_n for the slow gates
// (SLOW substeps only; frozen ones leave them as they are), each rounded
// from double once.  The divisions are IEEE divisions, as jnp's (the plain
// path's `rdiv`).
//
// Kept from the reference: the currents use the PRE-update gates; V is
// clipped to [-85, 25]; alpha_m's removable singularity at V = -47 mV (c3 =
// c6 = -1) and iK1's at V = -23 mV are evaluated literally, as the plain
// path does, so near them the kernel and the plain path lose digits to
// cancellation in their own ways.
//
// AB2 (SimConfig.ab2): V and C take Adams-Bashforth-2 steps from the
// derivative planes _dC_ and _dV_ (planes 7 and 8):
//   g_v = diff * lap - i_sum, v1_raw = v0 + dt * (1.5 g_v - 0.5 _dV_),
//   v1 = clip(v1_raw), _dV_' = g_v where v1 == v1_raw and (v1 - v0) / dt
//   where the clip fired; g_c = -1e-7 iCa + 0.07 (1e-7 - C),
//   C' = C + dt * (1.5 g_c - 0.5 _dC_), _dC_' = g_c.
//
// No --use_fast_math: expf, expm1f and logf are the precise ones.

#pragma once

#include <cuda_runtime.h>

#include "br_cell.cuh"

namespace fibtorch {

// Gate and current modes (ops/cuda_step.py packs them as floats).
enum BrGateMode { kFold = 0, kChebyTau = 1, kDirect = 2 };
enum BrCurrentMode { kChebyCurrents = 0, kFastCurrents = 1, kPlain = 2 };

// Fit slots: gate g (in the order x1, m, h, j, d, f) has its inf fit at 2g
// and its multiplier (kFold) or tau (kChebyTau) fit at 2g + 1; the current
// fits follow.  Rate slots: gate g's alpha at 2g, beta at 2g + 1.
enum VariantSlot { kIk1Fit = 12, kIx1fFit, kVariantFits };
constexpr int kRates = 12, kRateParams = 7;

struct BrVariantParams {
  float coef[kVariantFits][kTerms];
  float rate[kRates][kRateParams];
  // the fast currents' constants exp(0.04*85), exp(0.08*53), exp(0.04*53),
  // exp(-0.04*23), exp(0.04*77), exp(0.04*35), from double
  float a85, a53b, a53, a23, a77, a35;
  // conductances with their g_scale factors folded in, as in BrParams
  float g_na, g_nac, g_s, s_k1, s_x1;
  float dt, dt_slow;      // dt and dt * slow_n, rounded from double once
  float diff, diff_dt;    // diff (AB2) and diff * dt (Euler)
  float cheb_mid, cheb_half;   // Chebyshev domain: x = (v - mid) / half
  float v_min, v_span;    // probe normalisation: (v - v_min) / v_span
  float gate_mode, current_mode;   // BrGateMode, BrCurrentMode
};

namespace brv {

// rate(V) = (c0 exp(c1 (V + c2)) + c3 (V + c4)) / (exp(c5 (V + c2)) + c6)
__device__ __forceinline__ float rate(const float* c, float v) {
  const float e = c[0] * expf(c[1] * (v + c[2]));
  const float num = c[3] == 0.0f ? e : __fadd_rn(e, __fmul_rn(c[3], v + c[4]));
  return num / (expf(c[5] * (v + c[2])) + c[6]);
}

// Gate `gi` advanced by dt_n in the launch's gate mode.
__device__ __forceinline__ float advance(const BrVariantParams& p, int mode,
                                         int gi, float g, float v0,
                                         const float* s, float dt_n) {
  float inf, tau;
  if (mode == kFold) {
    inf = cheb(p.coef[2 * gi], s);
    const float r = cheb(p.coef[2 * gi + 1], s);
    return clip(g + (g - inf) * r, 0.00001f, 0.99999f);
  }
  if (mode == kChebyTau) {
    inf = cheb(p.coef[2 * gi], s);
    tau = cheb(p.coef[2 * gi + 1], s);
  } else {
    const float a = rate(p.rate[2 * gi], v0);
    const float b = rate(p.rate[2 * gi + 1], v0);
    inf = a / (a + b);
    tau = 1.0f / (a + b);
  }
  return clip(g + (g - inf) * expm1f((-dt_n) / tau), 0.00001f, 0.99999f);
}

}  // namespace brv

template <bool AB2>
struct BrVariantCell {
  using Params = BrVariantParams;
  // the per-cell planes, in the order of cuda_step.BR_VARIANT_PLANES (the
  // last two with AB2 only)
  enum Plane { kC, kM, kH, kJ, kD, kF, kX1, kDC, kDV };
  static constexpr int kPlanes = AB2 ? 9 : 7;

  // The frozen body leaves the slow gates as they are.
  template <bool SLOW>
  __host__ __device__ static constexpr bool stores(int k) {
    return SLOW || k == kC || k == kM || k == kH || k >= kDC;
  }

  // One substep of the cell (beeler_reuter.py::solve): SLOW advances the
  // slow gates x1/j/d/f by dt_slow; otherwise they stay frozen.  Everything
  // is taken at v0; the raw centre is not read.
  template <bool SLOW>
  __device__ __forceinline__ static float update(const Params& p, float v0,
                                                 float /* raw */, float lap,
                                                 float (&q)[kPlanes]) {
    const int gm = (int)p.gate_mode;
    const int cm = (int)p.current_mode;
    float s[kTerms];
    if (gm != kDirect) {
      const float x = (v0 - p.cheb_mid) / p.cheb_half;
      const float x2 = 2.0f * x;
      s[0] = 1.0f;
      s[1] = x;
#pragma unroll
      for (int k = 2; k < kTerms; ++k) s[k] = x2 * s[k - 1];
    }

    const float c = q[kC];
    const float m = q[kM];
    const float h = q[kH];
    const float jg = q[kJ];
    const float d = q[kD];
    const float f = q[kF];
    const float x1 = q[kX1];

    // gate g of the fit and rate slots: x1 0, m 1, h 2, j 3, d 4, f 5
    q[kM] = brv::advance(p, gm, 1, m, v0, s, p.dt);
    q[kH] = brv::advance(p, gm, 2, h, v0, s, p.dt);
    if (SLOW) {
      q[kX1] = brv::advance(p, gm, 0, x1, v0, s, p.dt_slow);
      q[kJ] = brv::advance(p, gm, 3, jg, v0, s, p.dt_slow);
      q[kD] = brv::advance(p, gm, 4, d, v0, s, p.dt_slow);
      q[kF] = brv::advance(p, gm, 5, f, v0, s, p.dt_slow);
    }

    // currents from the pre-update gates
    float i_k1, i_x1;
    if (cm == kChebyCurrents) {
      i_k1 = cheb(p.coef[kIk1Fit], s);
      i_x1 = x1 * cheb(p.coef[kIx1fFit], s);
    } else if (cm == kFastCurrents) {
      const float k = expf(0.04f * v0);
      i_k1 = 0.35f * (4.0f * (p.a85 * k - 1.0f) /
                          (p.a53b * k * k + p.a53 * k) +
                      0.2f * ((v0 + 23.0f) / (1.0f - p.a23 / k)));
      i_x1 = x1 * 0.8f * (p.a77 * k - 1.0f) / (p.a35 * k);
    } else {
      i_k1 = 0.35f * (4.0f * (expf(0.04f * (v0 + 85.0f)) - 1.0f) /
                          (expf(0.08f * (v0 + 53.0f)) +
                           expf(0.04f * (v0 + 53.0f))) +
                      0.2f * ((v0 + 23.0f) /
                              (1.0f - expf(-0.04f * (v0 + 23.0f)))));
      i_x1 = x1 * 0.8f * (expf(0.04f * (v0 + 77.0f)) - 1.0f) /
             expf(0.04f * (v0 + 35.0f));
    }
    i_k1 = p.s_k1 * i_k1;
    i_x1 = p.s_x1 * i_x1;
    const float i_na = (p.g_na * (m * m * m) * h * jg + p.g_nac) * (v0 - 50.0f);
    const float e_ca = -82.3f - 13.0278f * logf(c);
    const float i_ca = p.g_s * d * f * (v0 - e_ca);
    const float i_sum = i_k1 + i_x1 + i_na + i_ca;

    if constexpr (!AB2) {
      q[kC] = c + p.dt * (-1.0e-7f * i_ca + 0.07f * (1.0e-7f - c));
      return clip(v0 + p.diff_dt * lap - p.dt * i_sum, -85.0f, 25.0f);
    } else {
      const float g_v = p.diff * lap - i_sum;
      const float g_c = -1.0e-7f * i_ca + 0.07f * (1.0e-7f - c);
      const float v1_raw = v0 + p.dt * (1.5f * g_v - 0.5f * q[kDV]);
      const float v1 = clip(v1_raw, -85.0f, 25.0f);
      q[kDV] = v1 == v1_raw ? g_v : (v1 - v0) / p.dt;
      q[kC] = c + p.dt * (1.5f * g_c - 0.5f * q[kDC]);
      q[kDC] = g_c;
      return v1;
    }
  }

  __device__ __forceinline__ static float probe(const Params& p, float v) {
    return (v - p.v_min) / p.v_span;
  }
};

}  // namespace fibtorch
