// The per-cell Courtemanche-Ramirez-Nattel update (human atrium, 21
// variables) and Courtemanche-ultra's (22, with the ultra-slow Na gate us):
// the cell bodies that kernels 1 (br_substep.cu) and 4 (br_volume.cu) run
// for fib_tf_tpu_torch/models/courtemanche.py (the reference's
// fib_tf_tpu/models/courtemanche.py), CourtCell<false> and CourtCell<true>.
// The contract of a cell body is br_cell.cuh's, with cell_traits.cuh's
// nullable plane and kept potential.
//
// Forms.  One outer step of Courtemanche is the fast commit (V, Na_i, m, h
// advance dt), then the slow commit (the other 17 planes advance 10 dt)
// from a solve that reads the FAST-UPDATED state, then nine fast commits.
// The slow commit reads V at the cell's clamped stencil point, which on the
// domain's outer ring is a neighbour's new V: one launch per cell cannot
// do both, so substep 0 is two launches (11 per outer step).
//   SLOW = false, the fast commit: stores V (double-buffered), Na_i, m, h.
//     It evaluates only the intermediates those four need: i_K1a, g_Kur,
//     i_Kra, f_NaK, i_NaCaa, i_NaCab and m's and h's rates (the reference
//     leaves the rest to XLA's dead-code elimination);
//   SLOW = true, the slow commit: stores the 17 slow planes and neither V
//     nor its buffer (kSlowKeepsPotential); no Laplacian;
//   CourtCell<true> (ultra) has one form, the full commit of all 22 planes
//     every dt (ten launches per outer step, SLOW = true).
// Kernel 1 (br_substep.cu) runs CourtCell<false> in three forms, by the
// launch's place in the outer step: substep 0's fast commit computes its
// terms from the planes, as every other kernel's does; the slow commit
// also stores the six `invariant`s (E_K, E_Ca, I_pCa and three gate
// prefixes, which read only slow planes) from the planes it has just
// written into a cache of six planes outside the state (kCachePlanes,
// CACHED); the nine fast commits after it read the cache in place of the
// seven planes those terms come from.  The cache lives for one outer step:
// substep 0 never reads it, so no value crosses an outer step, a chunk, an
// event or a simulate() call.
//
// Rates (Params::mode, uniform over a launch): 0 direct (the reference's
// calc_intermediates, with its eps = V*1e-20 guards and branches taken on
// its conditions exactly), 1 the hybrid Chebyshev fits (26 degree-12 fits
// of the smooth intermediates in the S basis; h and j direct) with
// Rush-Larsen, 2 the same with the ten fitted gates' folded multipliers.
// Table mode runs on the plain path only.  The us gate is always direct.
//
// Constants.  Each compound constant is rounded from double once, where
// the reference's Python arithmetic rounds it (e.g. (R_GAS*TEMP)/FARADAY,
// 0.0337**2, 1e-15/(2 FARADAY)); the g_scale factors and the global chronic
// flag come folded into the conductances by the host (cuda_step
// _pack_court), and with the per-pixel `_p_chronic` plane the prefactor is
// formed per cell in the reference's order.  No --use_fast_math: expf,
// expm1f, logf, sqrtf, tanhf and every division are IEEE or libm's.
//
// Rounding.  The direct rates and the update round as the plain path
// (models/courtemanche.py under torch) does on the card, operation for
// operation: the library is built with -fmad=false, so no product is
// contracted into an FMA; each expression keeps the plain path's order;
// a plane over a Python number c is a product with inv(c), as torch
// computes it; and a Python number over a plane is one IEEE division
// (the plain path's rdiv).  A direct-rate launch then equals its plain
// version bit for bit, and so does a whole run: the Ca release threshold
// (u_inf's sigmoid is 1.367e-15 wide in fn) and an S2's reentry amplify
// any rounding difference to tens of mV within a second of simulated time.
// The fitted modes sum their series in their own order.
//
// What bounds it: per cell the fast commit reads 16 planes (17 with the
// chronic plane, 18 for ultra) and writes 4, the cached one 15 (the cache's
// six for seven planes); the slow commit reads 19 and writes 17, 23 with
// the cache; about 40 exponentials in the slow commit's direct rates.  At
// 2048x2048 on the H100 neither bytes nor instructions alone set the time:
// the fast commit runs at 1.5x its byte floor, and taking 8% of its
// instructions away saved nothing until it kept its five blocks an SM
// (br_substep.cu); latency at the occupancy its registers allow is what
// binds.  PERF.md keeps the measured times.

#pragma once

#include <cuda_runtime.h>

#include "br_cell.cuh"
#include "cell_traits.cuh"
#include "torch_rounding.cuh"

namespace fibtorch {

namespace court {

constexpr int kTerms = 13;   // degree 12

// The fits in CourtParams::coef: the smooth intermediates in the order of
// models/courtemanche.CHEBY_SMOOTH_KEYS, then the folded multipliers rl_<g>
// in FITTED_GATES order (cuda_step.COURT_FIT_ORDER).
enum Fit {
  D_INF, F_INF, TAU_W, TAU_D, TAU_F, W_INF, M_INF, TAU_OA, TAU_OI, TAU_UA,
  TAU_UI, TAU_XR, TAU_XS, TAU_M, OA_INF, OI_INF, UA_INF, UI_INF, XR_INF,
  XS_INF, G_KUR, F_NAK, I_NACAA, I_NACAB, I_K1A, I_KRA,
  RL_D, RL_F, RL_W, RL_M, RL_OA, RL_OI, RL_UA, RL_UI, RL_XR, RL_XS,
  kFits
};

// compound constants, from double as the reference's Python forms them
constexpr double kRT = 8.3143 * 310.0;
constexpr double kF = 96.4867;
// the rounding rules of torch on the card (torch_rounding.cuh)
using fibtorch::inv;
using fibtorch::rush_larsen;

constexpr float kRtF = (float)(kRT / kF);
constexpr float kRtF2 = (float)((kRT / kF) / 2.0);
constexpr float kInvRT = inv(kRT);
constexpr float kFf = (float)kF;
constexpr float kNegF01 = (float)(-0.1 * kF);
constexpr float kNegF = (float)(-kF);
constexpr float kGm1 = (float)(0.35 - 1.0);
constexpr float kGF = (float)(0.35 * kF);
constexpr float kGm1F = (float)((0.35 - 1.0) * kF);
constexpr float kNaCaDen = (float)((87.5 * 87.5 * 87.5 + 140.0 * 140.0 * 140.0)
                                   * (1.38 + 1.8));
constexpr float kNaCa = (float)(100.0 * 1600.0);
constexpr float kNaO3 = (float)(140.0 * 140.0 * 140.0);
constexpr float kK1a = (float)(100.0 * 0.09);
constexpr float kKra = (float)(100.0 * 0.029411765);
constexpr float kNeg0337Sq = (float)(-(0.0337 * 0.0337));
constexpr float kTauW0 = (float)((6.0 * 0.2) / 1.3);
constexpr double kVi = 20100.0 * 0.68;
constexpr double kVrel = 0.0048 * 20100.0;
constexpr double kVup = 0.0552 * 20100.0;
constexpr float kInvViF = inv(kVi * kF);
constexpr float kVrelf = (float)kVrel;
constexpr float kVupf = (float)kVup;
constexpr float kRel15 = (float)(1.0e-15 * kVrel);
constexpr float kFn15 = (float)(1.0e-15 / (2.0 * kF));
constexpr float kCsqn = (float)(10.0 * 0.8);
constexpr float kTrpn = (float)(0.07 * 0.0005);
constexpr float kCmdn = (float)(0.05 * 0.00238);
constexpr float kUsShift = (float)(-83.0 + 30.0);

__device__ __forceinline__ float cheb(const float* d, const float* s) {
  float r = d[0];
#pragma unroll
  for (int k = 1; k < kTerms; ++k) r = r + d[k] * s[k];
  return r;
}

// The direct intermediates (calc_intermediates), one at a time.
template <int K>
__device__ __forceinline__ float direct(float v) {
  const float eps = v * 1e-20f;
  const float vs = v + 10.0f;
  if constexpr (K == D_INF) {
    return 1.0f / (1.0f + expf((v + 10.0f) * inv(-8.0)));
  } else if constexpr (K == TAU_D) {
    const float t = v + 10.0001f;
    if (fabsf(t) < 1.0e-10f) {
      return 4.579f / (1.0f + expf((v + 10.0f) * inv(-6.24)));
    }
    return (1.0f - expf(t * inv(-6.24))) /
           (0.035f * t * (1.0f + expf(t * inv(-6.24))));
  } else if constexpr (K == F_INF) {
    const float e = expf(-(v + 28.0f) * inv(6.9));
    return e / (1.0f + e);
  } else if constexpr (K == TAU_F) {
    const float t = v + 10.0f;
    return 9.0f / (0.0197f * expf(kNeg0337Sq * (t * t)) + 0.02f);
  } else if constexpr (K == TAU_W) {
    const float t = v - 7.9f;
    if (fabsf(t) < 1.0e-10f) return eps + kTauW0;
    const float e = expf(-t * inv(5.0));
    return (6.0f * (1.0f - e)) / ((1.0f + 0.3f * e) * t);
  } else if constexpr (K == W_INF) {
    return 1.0f - 1.0f / (1.0f + expf(-(v - 40.0f) * inv(17.0)));
  } else if constexpr (K == M_INF || K == TAU_M) {
    const float t = v + 47.13f;
    const float am = fabsf(t) < 0.001f
                         ? eps + 3.2f
                         : (0.32f * t) / (1.0f - expf(-0.1f * t));
    const float bm = 0.08f * expf(-v * inv(11.0));
    return K == M_INF ? am / (am + bm) : 1.0f / (am + bm);
  } else if constexpr (K == TAU_OA || K == TAU_UA) {
    const float a =
        0.65f / (expf(vs * inv(-8.5)) + expf((vs - 40.0f) * inv(-59.0)));
    const float b = 0.65f / (2.5f + expf((vs + 72.0f) * inv(17.0)));
    return (1.0f / (a + b)) * inv(3.0);
  } else if constexpr (K == OA_INF) {
    return 1.0f / (1.0f + expf((vs + 10.47f) * inv(-17.54)));
  } else if constexpr (K == TAU_OI) {
    const float a = 1.0f / (18.53f + expf((vs + 103.7f) * inv(10.95)));
    const float b = 1.0f / (35.56f + expf((vs - 8.74f) * inv(-7.44)));
    return (1.0f / (a + b)) * inv(3.0);
  } else if constexpr (K == OI_INF) {
    return 1.0f / (1.0f + expf((vs + 33.1f) * inv(5.3)));
  } else if constexpr (K == UA_INF) {
    return 1.0f / (1.0f + expf((vs + 20.3f) * inv(-9.6)));
  } else if constexpr (K == TAU_UI) {
    const float a = 1.0f / (21.0f + expf((vs - 195.0f) * inv(-28.0)));
    const float b = 1.0f / expf((vs - 168.0f) * inv(-16.0));
    return (1.0f / (a + b)) * inv(3.0);
  } else if constexpr (K == UI_INF) {
    return 1.0f / (1.0f + expf((vs - 109.45f) * inv(27.48)));
  } else if constexpr (K == TAU_XR) {
    const float t = v + 14.1f;
    const float a = fabsf(t) < 1.0e-10f
                        ? eps + 0.0015f
                        : (0.0003f * t) / (1.0f - expf(t * inv(-5.0)));
    const float u = v - 3.3328f;
    const float b = fabsf(u) < 1.0e-10f
                        ? eps + 0.000378361f
                        : (7.3898e-05f * u) / (expf(u * inv(5.1237)) - 1.0f);
    return 1.0f / (a + b);
  } else if constexpr (K == XR_INF) {
    return 1.0f / (1.0f + expf((v + 14.1f) * inv(-6.5)));
  } else if constexpr (K == TAU_XS) {
    const float t = v - 19.9f;
    const bool pole = fabsf(t) < 1.0e-10f;
    const float a =
        pole ? eps + 0.00068f
             : (4.0e-05f * t) / (1.0f - expf(t * inv(-17.0)));
    const float b =
        pole ? eps + 0.000315f
             : (3.5e-05f * t) / (expf(t * inv(9.0)) - 1.0f);
    return 0.5f / (a + b);
  } else if constexpr (K == XS_INF) {
    return sqrtf(1.0f / (1.0f + expf((v - 19.9f) * inv(-12.7))));
  } else if constexpr (K == G_KUR) {
    return 0.005f + 0.05f / (1.0f + expf((v - 15.0f) * inv(-13.0)));
  } else if constexpr (K == F_NAK) {
    return 1.0f / (1.0f + 0.1245f * expf((kNegF01 * v) * kInvRT) +
                   0.0365f * expf((kNegF * v) * kInvRT));
  } else if constexpr (K == I_NACAA || K == I_NACAB) {
    const float den =
        kNaCaDen * (1.0f + 0.1f * expf(((kGm1 * v) * kFf) * kInvRT));
    if constexpr (K == I_NACAA) {
      return (kNaCa * (expf((kGF * v) * kInvRT) * 1.8f)) / den;
    } else {
      return (kNaCa * (expf((kGm1F * v) * kInvRT) * kNaO3)) / den;
    }
  } else if constexpr (K == I_K1A) {
    return kK1a / (1.0f + expf(0.07f * (v + 80.0f)));
  } else if constexpr (K == I_KRA) {
    return kKra / (1.0f + expf((v + 15.0f) * inv(22.4)));
  } else {
    static_assert(K < 0, "not a direct intermediate");
  }
}

// The branchy fast-Na inactivation rates (calc_hj_rates): inf and tau of h
// (J = false) or j (J = true), always direct.
template <bool J>
__device__ __forceinline__ void hj_rates(float v, float& inf, float& tau) {
  const float eps = v * 1e-20f;
  float a, b;
  if (v < -40.0f) {
    if constexpr (J) {
      a = ((-127140.0f * expf(0.2444f * v) - 3.474e-05f * expf(-0.04391f * v)) *
           (v + 37.78f)) /
          (1.0f + expf(0.311f * (v + 79.23f)));
      b = (0.1212f * expf(-0.01052f * v)) /
          (1.0f + expf(-0.1378f * (v + 40.14f)));
    } else {
      a = 0.135f * expf((v + 80.0f) * inv(-6.8));
      b = 3.56f * expf(0.079f * v) + 310000.0f * expf(0.35f * v);
    }
  } else {
    a = eps;
    if constexpr (J) {
      b = (0.3f * expf(-2.535e-07f * v)) / (1.0f + expf(-0.1f * (v + 32.0f)));
    } else {
      b = 1.0f / (0.13f * (1.0f + expf((v + 10.66f) * inv(-11.1))));
    }
  }
  inf = a / (a + b);
  tau = 1.0f / (a + b);
}

// The ultra-slow gate's inf and tau (us_rates).
__device__ __forceinline__ void us_rates(float v, float& inf, float& tau) {
  const float a = 3e-5f * (0.5f * (1.0f - tanhf((v - -83.0f) * inv(23.0))));
  const float b = 1e-5f * (0.5f * (1.0f + tanhf((v - kUsShift) * inv(23.0))));
  inf = a / (a + b);
  tau = 1.0f / (a + b);
}

}  // namespace court

struct CourtParams {
  float coef[court::kFits][court::kTerms];
  float mode;          // 0 direct, 1 fits + Rush-Larsen, 2 folded gates
  float het;           // 1: the _p_chronic plane is attached
  // with the global chronic flag c: (1 - 0.5c) CM (f g_to), (1 - 0.5c) CM,
  // (1 - 0.7c) CM (f g_CaL); and f g_to, f g_CaL for the per-pixel plane
  float k_to, k_kur, k_cal, g_to, g_cal;
  // the g_scale factors of the currents scaled as tensors
  float s_kur, s_k1, s_kr, s_naca;
  // CM (f g) of the constant conductances, and K_O / (K_O + KM_K_O)
  float k_ks, k_nak, k_nak2, k_bk, k_na, k_bna, k_cap, k_bca;
  float dt_fast, dt_slow;   // dt_for of the fast and of the slow states
  float diff_dt;            // diff * dt
  float dv_max, has_dv_max; // the |dV| cap per substep, and whether set
  float cheb_mid, cheb_half;  // Chebyshev domain: x = (v - mid) / half
  // probe normalisation (v - v_min) / (v_max - v_min), as torch takes it:
  // a product with the reciprocal, formed in double on the host
  float v_min, v_inv_span;
};

template <bool ULTRA>
struct CourtCell {
  using Params = CourtParams;
  // the per-cell planes, in the order of cuda_step.COURT_PLANES /
  // COURT_ULTRA_PLANES: Na_i, m, h (fast), the 17 slow, us (ultra), the
  // chronic plane (nullable)
  enum Plane {
    kNa, kM, kH, kJ, kK, kOa, kOi, kUa, kUi, kXr, kXs, kCa, kD, kF, kFca,
    kCaRel, kU, kVg, kW, kCaUp, kFirstExtra
  };
  static constexpr int kUs = kFirstExtra;   // ultra only
  static constexpr int kChronic = kFirstExtra + (ULTRA ? 1 : 0);
  static constexpr int kPlanes = kChronic + 1;
  static constexpr unsigned kNullablePlanes = 1u << kChronic;
  static constexpr bool kSlowKeepsPotential = !ULTRA;
  // the fast commit's invariants (store_invariants), the planes of kernel
  // 1's cache; ultra, which commits every plane every dt, has none
  enum Invariant { kEk, kECa, kICap, kPTo, kPKs, kPCaL, kInvariants };
  static constexpr int kCachePlanes = ULTRA ? 0 : kInvariants;

  // the fast commit stores Na_i, m, h; the slow commit the 17 slow planes;
  // ultra every plane but the chronic one
  template <bool SLOW>
  __host__ __device__ static constexpr bool stores(int k) {
    if (k == kChronic) return false;
    if (ULTRA) return true;
    const bool fast = k == kNa || k == kM || k == kH;
    return SLOW ? !fast : fast;
  }

  // The terms of the currents that read only planes the slow commit
  // writes, which `update` computes inline in the same order: E_K, E_Ca,
  // I_pCa and the gate prefixes of I_to, I_Ks and I_CaL (with the chronic
  // plane, their conductances per cell).  Between two slow commits they do
  // not change.  Stored from `q` into `cache`.
  __device__ __forceinline__ static void store_invariants(
      const Params& p, const float (&q)[kPlanes], float* cache) {
    const float c = q[kChronic];
    const bool het = p.het != 0.0f;
    const float ca = q[kCa];
    const float to_k = het ? ((1.0f - 0.5f * c) * 100.0f) * p.g_to : p.k_to;
    const float cal_k =
        het ? ((1.0f - 0.7f * c) * 100.0f) * p.g_cal : p.k_cal;
    const float oa = q[kOa];
    const float xs = q[kXs];
    cache[kEk] = court::kRtF * logf(5.4f / q[kK]);
    cache[kECa] = court::kRtF2 * logf(1.8f / ca);
    cache[kICap] = (p.k_cap * ca) / (0.0005f + ca);
    cache[kPTo] = (to_k * (oa * oa * oa)) * q[kOi];
    cache[kPKs] = p.k_ks * (xs * xs);
    cache[kPCaL] = ((cal_k * q[kD]) * q[kF]) * q[kFca];
  }

  // One commit.  CACHED (CourtCell<false> only): `cache` holds the
  // invariants; the slow commit stores them from the planes it has just
  // written, a fast commit reads them in place of K_i, oa, oi, xs, d, f and
  // f_Ca.
  template <bool SLOW, bool CACHED = false>
  __device__ __forceinline__ static float update(const Params& p, float v,
                                                 float /* raw */, float lap,
                                                 float (&q)[kPlanes],
                                                 float* cache = nullptr) {
    static_assert(!(CACHED && ULTRA), "ultra has no cache");
    constexpr bool kLoad = CACHED && !SLOW;
    constexpr bool kFastPart = ULTRA || !SLOW;   // V, Na_i, m, h
    constexpr bool kSlowPart = ULTRA || SLOW;    // the 17 slow planes
    const int mode = (int)p.mode;
    const bool fitted = mode != 0;

    float s[court::kTerms];
    if (fitted) {
      const float x = (v - p.cheb_mid) / p.cheb_half;
      const float x2 = 2.0f * x;
      s[0] = 1.0f;
      s[1] = x;
#pragma unroll
      for (int k = 2; k < court::kTerms; ++k) s[k] = x2 * s[k - 1];
    }
    // an intermediate: its fit or its direct form
#define COURT_INTER(K) \
    (fitted ? court::cheb(p.coef[K], s) : court::direct<K>(v))
    // a fitted gate: folded multiplier, or Rush-Larsen on its inf and tau
#define COURT_GATE(g, INF, TAU, RL, dt)                                     \
    (mode == 2 ? clip((g) + ((g) - court::cheb(p.coef[INF], s)) *           \
                                court::cheb(p.coef[RL], s),                 \
                      0.00001f, 0.99999f)                                   \
               : court::rush_larsen((g), COURT_INTER(INF), COURT_INTER(TAU), \
                                    (dt)))

    const float na = q[kNa];
    const float ca = q[kCa];
    const float ki = q[kK];
    const float c = q[kChronic];
    const bool het = p.het != 0.0f;

    // the currents both commits need; a cached fast commit (kLoad) reads
    // the invariants (store_invariants) from the cache
    const float e_k = kLoad ? cache[kEk] : court::kRtF * logf(5.4f / ki);
    const float i_k1 = (p.s_k1 * COURT_INTER(court::I_K1A)) * (v - e_k);
    const float to_k = het ? ((1.0f - 0.5f * c) * 100.0f) * p.g_to : p.k_to;
    const float oa = q[kOa];
    const float i_to =
        (kLoad ? cache[kPTo] : (to_k * (oa * oa * oa)) * q[kOi]) * (v - e_k);
    const float kur_k = het ? (1.0f - 0.5f * c) * 100.0f : p.k_kur;
    const float ua = q[kUa];
    const float i_kur = (((kur_k * (p.s_kur * COURT_INTER(court::G_KUR))) *
                          (ua * ua * ua)) * q[kUi]) * (v - e_k);
    const float i_kr =
        ((p.s_kr * COURT_INTER(court::I_KRA)) * q[kXr]) * (v - e_k);
    const float xs = q[kXs];
    const float i_ks = (kLoad ? cache[kPKs] : p.k_ks * (xs * xs)) * (v - e_k);
    const float r = 10.0f / na;
    const float i_nak = ((p.k_nak * COURT_INTER(court::F_NAK)) /
                         (1.0f + sqrtf(r * r * r))) * p.k_nak2;
    const float i_naca =
        p.s_naca * (COURT_INTER(court::I_NACAA) * (na * na * na) -
                    COURT_INTER(court::I_NACAB) * ca);
    const float cal_k =
        het ? ((1.0f - 0.7f * c) * 100.0f) * p.g_cal : p.k_cal;
    const float i_ca_l =
        (kLoad ? cache[kPCaL] : ((cal_k * q[kD]) * q[kF]) * q[kFca]) *
        (v - 65.0f);
    const float i_cap =
        kLoad ? cache[kICap] : (p.k_cap * ca) / (0.0005f + ca);
    const float e_ca =
        kLoad ? cache[kECa] : court::kRtF2 * logf(1.8f / ca);
    const float i_b_ca = p.k_bca * (v - e_ca);

    float v1 = v;
    if constexpr (kFastPart) {
      const float e_na = court::kRtF * logf(140.0f / na);
      const float m = q[kM];
      const float h = q[kH];
      float i_na = (((p.k_na * (m * m * m)) * h) * q[kJ]) * (v - e_na);
      if constexpr (ULTRA) i_na = i_na * q[kUs];
      const float i_b_na = p.k_bna * (v - e_na);

      const float sum = i_na + i_k1 + i_to + i_kur + i_kr + i_ks + i_b_na +
                        i_b_ca + i_nak + i_cap + i_naca + i_ca_l;
      const float dv = v + ((-sum) * court::inv(100.0)) * p.dt_fast;
      v1 = dv + p.diff_dt * lap;
      if (p.has_dv_max != 0.0f) v1 = v + clip(v1 - v, -p.dv_max, p.dv_max);

      q[kNa] = na + ((-3.0f * i_nak - (3.0f * i_naca + i_b_na + i_na)) *
                     court::kInvViF) * p.dt_fast;
      q[kM] =
          COURT_GATE(m, court::M_INF, court::TAU_M, court::RL_M, p.dt_fast);
      float h_inf, tau_h;
      court::hj_rates<false>(v, h_inf, tau_h);
      q[kH] = court::rush_larsen(h, h_inf, tau_h, p.dt_fast);
    }

    if constexpr (kSlowPart) {
      const float dt = p.dt_slow;
      // the release current from the pre-update gates
      const float ca_rel = q[kCaRel];
      const float ca_up = q[kCaUp];
      const float u = q[kU];
      const float i_rel =
          (((30.0f * (u * u)) * q[kVg]) * q[kW]) * (ca_rel - ca);
      const float i_b_k = p.k_bk * (v - e_k);
      q[kK] = ki + ((2.0f * i_nak -
                     (i_k1 + i_to + i_kur + i_kr + i_ks + i_b_k)) *
                    court::kInvViF) * dt;

      q[kD] = COURT_GATE(q[kD], court::D_INF, court::TAU_D, court::RL_D, dt);
      q[kF] = COURT_GATE(q[kF], court::F_INF, court::TAU_F, court::RL_F, dt);
      q[kW] = COURT_GATE(q[kW], court::W_INF, court::TAU_W, court::RL_W, dt);
      q[kOa] = COURT_GATE(oa, court::OA_INF, court::TAU_OA, court::RL_OA, dt);
      q[kOi] =
          COURT_GATE(q[kOi], court::OI_INF, court::TAU_OI, court::RL_OI, dt);
      q[kUa] = COURT_GATE(ua, court::UA_INF, court::TAU_UA, court::RL_UA, dt);
      q[kUi] =
          COURT_GATE(q[kUi], court::UI_INF, court::TAU_UI, court::RL_UI, dt);
      q[kXr] =
          COURT_GATE(q[kXr], court::XR_INF, court::TAU_XR, court::RL_XR, dt);
      q[kXs] = COURT_GATE(xs, court::XS_INF, court::TAU_XS, court::RL_XS, dt);
      float j_inf, tau_j;
      court::hj_rates<true>(v, j_inf, tau_j);
      q[kJ] = court::rush_larsen(q[kJ], j_inf, tau_j, dt);
      if constexpr (ULTRA) {
        float us_inf, tau_us;
        court::us_rates(v, us_inf, tau_us);
        q[kUs] = court::rush_larsen(q[kUs], us_inf, tau_us, dt);
      }
      q[kFca] = court::rush_larsen(
          q[kFca], 1.0f / (1.0f + ca * court::inv(0.00035)), 2.0f, dt);

      const float i_tr = (ca_up - ca_rel) * court::inv(180.0);
      const float rel = ca_rel + 0.8f;
      q[kCaRel] =
          ca_rel + ((i_tr - i_rel) / (1.0f + court::kCsqn / (rel * rel))) * dt;

      const float fn =
          1000.0f * (court::kRel15 * i_rel -
                     court::kFn15 * (0.5f * i_ca_l - 0.2f * i_naca));
      const float u_inf =
          1.0f / (1.0f + expf(-(fn - 3.4175e-13f) * court::inv(1.367e-15)));
      q[kU] = court::rush_larsen(u, u_inf, 8.0f, dt);
      const float tau_v = 1.91f + 2.09f * u_inf;
      const float v_inf =
          1.0f - 1.0f / (1.0f + expf(-(fn - 6.835e-14f) *
                                     court::inv(1.367e-15)));
      q[kVg] = court::rush_larsen(q[kVg], v_inf, tau_v, dt);

      const float i_up = 0.005f / (1.0f + 0.00092f / ca);
      const float i_up_leak = (0.005f * ca_up) * court::inv(15.0);
      q[kCaUp] = ca_up + (i_up - (i_up_leak + (i_tr * court::kVrelf) *
                                                 court::inv(court::kVup))) *
                             dt;

      const float b1 =
          (2.0f * i_naca - (i_cap + i_ca_l + i_b_ca)) *
              court::inv(2.0 * court::kVi * court::kF) +
          (court::kVupf * (i_up_leak - i_up) + i_rel * court::kVrelf) *
              court::inv(court::kVi);
      const float t = ca + 0.0005f;
      const float n = ca + 0.00238f;
      const float b2 = 1.0f + court::kTrpn / (t * t) + court::kCmdn / (n * n);
      q[kCa] = ca + (b1 / b2) * dt;
      if constexpr (CACHED) store_invariants(p, q, cache);
    }
#undef COURT_GATE
#undef COURT_INTER
    return v1;
  }

  __device__ __forceinline__ static float probe(const Params& p, float v) {
    return (v - p.v_min) * p.v_inv_span;
  }
};

}  // namespace fibtorch
