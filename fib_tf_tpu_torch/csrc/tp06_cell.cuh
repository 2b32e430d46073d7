// The per-cell ten Tusscher-Panfilov 2006 update (human ventricle, 19
// variables): the cell body that kernels 1 (br_substep.cu) and 4
// (br_volume.cu) run for fib_tf_tpu_torch/models/tp06.py (the reference's
// fib_tf_tpu/models/tp06.py), Tp06Cell.  The contract of a cell body is
// br_cell.cuh's, with cell_traits.cuh's nullable planes.
//
// Forms.  An outer step is ten substeps at dt (0.02 ms by default).
//   SLOW = true advances every plane, the slow gates f, f2, s, xr1, xs by
//     Params::dt_slow: 10 dt under skip (solve(n=10)), dt without
//     (solve(n=1));
//   SLOW = false freezes the five slow gates (solve(n=0)) and stores V and
//     the other 13 planes.
// Under skip an outer step is one SLOW launch and nine frozen ones; without,
// ten SLOW launches.
//
// Heterogeneity.  Four read-only planes follow the 18 per-cell planes, each
// a nullable pointer (kNullablePlanes) whose presence Params::has_* states:
//   _p_endo  the s-gate blend w (SLOW only): inf and tau are
//            w * endo-form + (1 - w) * epi/M-form; absent, the cell type's
//            own form (Params::endo);
//   _p_g_kr  a relative IKr dose: g_Kr = dose * g_Kr; absent, g_Kr;
//   _p_g_ks  an absolute G_Ks, scaled by its g_scale factor; absent, the
//            cell type's constant (scaled on the host);
//   _p_g_to  likewise for G_to.
//
// The L-type current's GHK drive (V - 15) num / expm1(x), x = 2 (V - 15)
// F/RT, takes its exact limit (RT/2F) (0.25 CaSS - Ca_o) where |x| < 1e-4,
// with expm1f (as the plain path's torch.expm1).  Near the window float32
// evaluation is ill-conditioned (models/tp06.py `ill_conditioned`).
//
// Rounding.  As lr1_cell.cuh's (torch_rounding.cuh): built with
// -fmad=false, each expression in the plain path's order (tp06.py under
// torch on the card), a plane over a
// Python number c a product with inv(c), a Python number over a plane one
// IEEE division, compound constants rounded from double once (here, or on
// the host: cuda_step._pack_tp06), so that a launch equals its plain
// version bit for bit.  The V update sums the twelve currents in the plain
// path's order.
//
// What bounds it: per cell a SLOW launch reads 19 planes (and the het
// planes attached) and writes 19, a frozen one reads as many and writes 14;
// about 60 exponentials, four logarithms and an expm1 in a SLOW launch.
// PERF.md keeps the measured times.

#pragma once

#include <cuda_runtime.h>

#include "br_cell.cuh"
#include "cell_traits.cuh"
#include "torch_rounding.cuh"

namespace fibtorch {

namespace tp06 {

// 1 / (1 + e): the logistic forms (divide(1.0, 1.0 + exp(...)))
__device__ __forceinline__ float logistic(float arg) {
  return 1.0f / (1.0f + expf(arg));
}

// compound constants, from double as the reference's Python forms them
constexpr double kRTF = 8314.472 * 310.0 / 96485.3415;
constexpr double kF = 96485.3415;
constexpr double kVc = 0.016404;
constexpr double kVsr = 0.001094;
constexpr double kVss = 0.00005468;
constexpr float kRtF = (float)kRTF;
constexpr float kFrt = (float)(1.0 / kRTF);
constexpr float kHalfRtF = (float)(0.5 * kRTF);
constexpr float kFf = (float)kF;
constexpr float kEksNum = (float)(5.4 + 0.03 * 140.0);
constexpr float kGm1 = (float)(0.35 - 1.0);
constexpr float kNaCaDen = (float)((87.5 * 87.5 * 87.5 + 140.0 * 140.0 * 140.0)
                                   * (1.38 + 2.0));
constexpr float kNaO3 = (float)(140.0 * 140.0 * 140.0);
constexpr float kNakDen = (float)(5.4 + 1.0);
constexpr float kBufC = (float)(0.2 * 0.001);
constexpr float kBufSr = (float)(10.0 * 0.3);
constexpr float kBufSs = (float)(0.4 * 0.00025);
constexpr float kCm2VcF = (float)(0.185 / (2.0 * kVc * kF));
constexpr float kVsrf = (float)kVsr;
constexpr float kVcf = (float)kVc;

}  // namespace tp06

struct Tp06Params {
  // the conductances with their g_scale factors folded in (g_to and g_ks
  // those of the instance's cell type, possibly set after construction)
  float g_na, g_bna, g_cal, g_bca, g_to, g_ks, g_kr, g_k1, g_naca;
  float g_nak;           // f g_NaK * K_O
  float g_pca, g_pk;
  float s_to, s_ks;      // the g_to and g_Ks factors, for the planes
  // 1: the plane is attached (_p_g_to, _p_g_ks, _p_endo, _p_g_kr)
  float has_to, has_ks, has_endo, has_kr;
  float endo;            // 1: the cell type is 'endo' (its s-gate form)
  float dt, dt_slow;     // dt, and the slow gates' step in a SLOW launch
  float diff_dt;         // diff * dt
  // probe normalisation (v - v_min) / (v_max - v_min), as torch takes it:
  // a product with the reciprocal, formed in double on the host
  float v_min, v_inv_span;
};

struct Tp06Cell {
  using Params = Tp06Params;
  // the per-cell planes, in the order of cuda_step.TP06_PLANES: the 18
  // per-cell planes (the state's sorted keys but V), then the four het
  // planes
  enum Plane {
    kCaSR, kCaSS, kCai, kKi, kNai, kRq, kD, kF, kF2, kFcass, kH, kJ, kM, kR,
    kS, kXr1, kXr2, kXs, kEndo, kGkr, kGks, kGto, kPlanes
  };
  static constexpr unsigned kNullablePlanes =
      (1u << kEndo) | (1u << kGkr) | (1u << kGks) | (1u << kGto);

  // a frozen launch leaves f, f2, s, xr1 and xs; no launch writes a het
  // plane
  template <bool SLOW>
  __host__ __device__ static constexpr bool stores(int k) {
    if (k >= kEndo) return false;
    return SLOW || !(k == kF || k == kF2 || k == kS || k == kXr1 || k == kXs);
  }

  template <bool SLOW>
  __device__ __forceinline__ static float update(const Params& p, float v,
                                                 float /* raw */, float lap,
                                                 float (&q)[kPlanes]) {
    using tp06::logistic;
    const float cai = q[kCai];
    const float ca_sr = q[kCaSR];
    const float ca_ss = q[kCaSS];
    const float nai = q[kNai];
    const float ki = q[kKi];
    const float rq = q[kRq];
    // the gates as the currents read them: before this substep's update
    const float m = q[kM], h = q[kH], j = q[kJ], d = q[kD], f = q[kF];
    const float f2 = q[kF2], fcass = q[kFcass], r = q[kR], s = q[kS];
    const float xr1 = q[kXr1], xr2 = q[kXr2], xs = q[kXs];
    const float dt = p.dt;

    // -- the fast gates, every substep (solve's FAST_GATES) --------------
    {
      const float t = 1.0f + expf((-56.86f - v) * inv(9.03));
      const float m_inf = 1.0f / (t * t);
      const float a = logistic((-60.0f - v) * inv(5.0));
      const float b = 0.1f / (1.0f + expf((v + 35.0f) * inv(5.0))) +
                      0.1f / (1.0f + expf((v - 50.0f) * inv(200.0)));
      q[kM] = rush_larsen(m, m_inf, a * b, dt);
    }
    {
      const float t = 1.0f + expf((v + 71.55f) * inv(7.43));
      const float hj_inf = 1.0f / (t * t);
      float a_h, b_h, a_j, b_j;
      if (v < -40.0f) {
        a_h = 0.057f * expf((-(v + 80.0f)) * inv(6.8));
        b_h = 2.7f * expf(0.079f * v) + 310000.0f * expf(0.3485f * v);
        a_j = ((-25428.0f * expf(0.2444f * v) -
                6.948e-6f * expf(-0.04391f * v)) *
               (v + 37.78f)) /
              (1.0f + expf(0.311f * (v + 79.23f)));
        b_j = (0.02424f * expf(-0.01052f * v)) /
              (1.0f + expf(-0.1378f * (v + 40.14f)));
      } else {
        a_h = 0.0f;
        b_h = 0.77f / (0.13f * (1.0f + expf((-(v + 10.66f)) * inv(11.1))));
        a_j = 0.0f;
        b_j = (0.6f * expf(0.057f * v)) / (1.0f + expf(-0.1f * (v + 32.0f)));
      }
      q[kH] = rush_larsen(h, hj_inf, 1.0f / (a_h + b_h), dt);
      q[kJ] = rush_larsen(j, hj_inf, 1.0f / (a_j + b_j), dt);
    }
    {
      const float inf = logistic((20.0f - v) * inv(6.0));
      const float t = v + 40.0f;
      const float tau = 9.5f * expf((-(t * t)) * inv(1800.0)) + 0.8f;
      q[kR] = rush_larsen(r, inf, tau, dt);
    }
    {
      const float inf = logistic((-8.0f - v) * inv(7.5));
      const float a = 1.4f / (1.0f + expf((-35.0f - v) * inv(13.0))) + 0.25f;
      const float b = 1.4f / (1.0f + expf((v + 5.0f) * inv(5.0)));
      const float g = logistic((50.0f - v) * inv(20.0));
      q[kD] = rush_larsen(d, inf, a * b + g, dt);
    }
    {
      const float inf = logistic((v + 88.0f) * inv(24.0));
      const float a = 3.0f / (1.0f + expf((-60.0f - v) * inv(20.0)));
      const float b = 1.12f / (1.0f + expf((v - 60.0f) * inv(20.0)));
      q[kXr2] = rush_larsen(xr2, inf, a * b, dt);
    }

    // -- the slow gates, by dt_slow in a SLOW launch ---------------------
    if constexpr (SLOW) {
      const float ds = p.dt_slow;
      const float t27 = v + 27.0f;
      {
        const float inf = logistic((v + 20.0f) * inv(7.0));
        const float tau =
            1102.5f * expf((-(t27 * t27)) * inv(225.0)) +
            200.0f / (1.0f + expf((13.0f - v) * inv(10.0))) +
            180.0f / (1.0f + expf((v + 30.0f) * inv(10.0))) + 20.0f;
        q[kF] = rush_larsen(f, inf, tau, ds);
      }
      {
        const float inf =
            0.67f / (1.0f + expf((v + 35.0f) * inv(7.0))) + 0.33f;
        const float tau =
            562.0f * expf((-(t27 * t27)) * inv(240.0)) +
            31.0f / (1.0f + expf((25.0f - v) * inv(10.0))) +
            80.0f / (1.0f + expf((v + 30.0f) * inv(10.0)));
        q[kF2] = rush_larsen(f2, inf, tau, ds);
      }
      {
        const bool blend = p.has_endo != 0.0f;
        const bool endo = p.endo != 0.0f;
        float inf_e = 0.0f, tau_e = 0.0f, inf_o = 0.0f, tau_o = 0.0f;
        if (blend || endo) {
          inf_e = logistic((v + 28.0f) * inv(5.0));
          const float t = v + 67.0f;
          tau_e = 1000.0f * expf((-(t * t)) * inv(1000.0)) + 8.0f;
        }
        if (blend || !endo) {
          inf_o = logistic((v + 20.0f) * inv(5.0));
          const float t = v + 45.0f;
          tau_o = 85.0f * expf((-(t * t)) * inv(320.0)) +
                  5.0f / (1.0f + expf((v - 20.0f) * inv(5.0))) + 3.0f;
        }
        float inf, tau;
        if (blend) {
          const float w = q[kEndo];
          inf = w * inf_e + (1.0f - w) * inf_o;
          tau = w * tau_e + (1.0f - w) * tau_o;
        } else if (endo) {
          inf = inf_e;
          tau = tau_e;
        } else {
          inf = inf_o;
          tau = tau_o;
        }
        q[kS] = rush_larsen(s, inf, tau, ds);
      }
      {
        const float inf = logistic((-26.0f - v) * inv(7.0));
        const float a = 450.0f / (1.0f + expf((-45.0f - v) * inv(10.0)));
        const float b = 6.0f / (1.0f + expf((v + 30.0f) * inv(11.5)));
        q[kXr1] = rush_larsen(xr1, inf, a * b, ds);
      }
      {
        const float inf = logistic((-5.0f - v) * inv(14.0));
        const float a =
            1400.0f / sqrtf(1.0f + expf((5.0f - v) * inv(6.0)));
        const float b = logistic((v - 35.0f) * inv(15.0));
        q[kXs] = rush_larsen(xs, inf, a * b + 80.0f, ds);
      }
    }

    // -- fcass, from the dyadic subspace calcium ---------------------------
    {
      const float c = ca_ss * inv(0.05);
      const float sq = c * c;
      q[kFcass] = rush_larsen(fcass, 0.6f / (1.0f + sq) + 0.4f,
                                    80.0f / (1.0f + sq) + 2.0f, dt);
    }

    // -- the twelve currents, from the pre-update gates and pools ---------
    const float e_na = tp06::kRtF * logf(140.0f / nai);
    const float e_k = tp06::kRtF * logf(5.4f / ki);
    const float e_ks =
        tp06::kRtF * logf(tp06::kEksNum / (ki + 0.03f * nai));
    const float e_ca = tp06::kHalfRtF * logf(2.0f / cai);

    const float i_na = (((p.g_na * ((m * m) * m)) * h) * j) * (v - e_na);
    const float i_b_na = p.g_bna * (v - e_na);
    // the GHK drive and its exact limit at V = 15 mV
    const float x = (2.0f * (v - 15.0f)) * tp06::kFrt;
    const float num = ((0.25f * ca_ss) * expf(x)) - 2.0f;
    const float drive = fabsf(x) < 1e-4f
                            ? tp06::kHalfRtF * ((0.25f * ca_ss) - 2.0f)
                            : ((v - 15.0f) * num) / expm1f(x);
    const float i_cal = (((((((p.g_cal * d) * f) * f2) * fcass) * 4.0f) *
                          tp06::kFf) * tp06::kFrt) * drive;
    const float i_b_ca = p.g_bca * (v - e_ca);
    const float g_to = p.has_to != 0.0f ? p.s_to * q[kGto] : p.g_to;
    const float i_to = ((g_to * r) * s) * (v - e_k);
    const float g_kr = p.has_kr != 0.0f ? q[kGkr] * p.g_kr : p.g_kr;
    const float i_kr = ((g_kr * xr1) * xr2) * (v - e_k);
    const float g_ks = p.has_ks != 0.0f ? p.s_ks * q[kGks] : p.g_ks;
    const float i_ks = (g_ks * (xs * xs)) * (v - e_ks);
    const float dvk = v - e_k;
    const float k1_a = 0.1f / (1.0f + expf(0.06f * (dvk - 200.0f)));
    const float k1_b = (3.0f * expf(0.0002f * (dvk + 100.0f)) +
                        expf(0.1f * (dvk - 10.0f))) /
                       (1.0f + expf(-0.5f * dvk));
    const float i_k1 = (p.g_k1 * (k1_a / (k1_a + k1_b))) * (v - e_k);
    const float evf = expf((0.35f * v) * tp06::kFrt);
    const float evf1 = expf((tp06::kGm1 * v) * tp06::kFrt);
    const float i_naca =
        (p.g_naca * (((evf * ((nai * nai) * nai)) * 2.0f) -
                     (((evf1 * tp06::kNaO3) * cai) * 2.5f))) /
        (tp06::kNaCaDen * (1.0f + 0.1f * evf1));
    const float i_nak =
        (p.g_nak * nai) /
        ((tp06::kNakDen * (nai + 40.0f)) *
         ((1.0f + 0.1245f * expf((-0.1f * v) * tp06::kFrt)) +
          0.0353f * expf((-v) * tp06::kFrt)));
    const float i_p_ca = (p.g_pca * cai) / (0.0005f + cai);
    const float i_p_k =
        (p.g_pk * (v - e_k)) / (1.0f + expf((25.0f - v) * inv(5.98)));
    const float sum = i_na + i_b_na + i_cal + i_b_ca + i_to + i_kr + i_ks +
                      i_k1 + i_naca + i_nak + i_p_ca + i_p_k;

    // -- SR release and the pools ------------------------------------------
    const float esr = 1.5f / ca_sr;
    const float kcasr = 2.5f - 1.5f / (1.0f + esr * esr);
    const float k1 = 0.15f / kcasr;
    const float k2 = 0.045f * kcasr;
    const float rq_tau = 1.0f / (k2 * ca_ss + 0.005f);
    q[kRq] = rush_larsen(rq, 0.005f * rq_tau, rq_tau, dt);
    const float ss2 = ca_ss * ca_ss;
    const float o_gate = ((k1 * ss2) * rq) / (0.06f + k1 * ss2);
    const float i_rel = (0.102f * o_gate) * (ca_sr - ca_ss);
    const float i_leak = 0.00036f * (ca_sr - cai);
    const float kup = 0.00025f / cai;
    const float i_up = 0.006375f / (1.0f + kup * kup);
    const float i_xfer = 0.0038f * (ca_ss - cai);
    const float bc = cai + 0.001f;
    const float buf_c = 1.0f / (1.0f + tp06::kBufC / (bc * bc));
    const float bsr = ca_sr + 0.3f;
    const float buf_sr = 1.0f / (1.0f + tp06::kBufSr / (bsr * bsr));
    const float bss = ca_ss + 0.00025f;
    const float buf_ss = 1.0f / (1.0f + tp06::kBufSs / (bss * bss));

    q[kCai] = cai + (dt * buf_c) *
                        ((((i_leak - i_up) * tp06::kVsrf) * inv(tp06::kVc) +
                          i_xfer) -
                         ((i_b_ca + i_p_ca) - 2.0f * i_naca) * tp06::kCm2VcF);
    q[kCaSR] = ca_sr + (dt * buf_sr) * ((i_up - i_rel) - i_leak);
    q[kCaSS] =
        ca_ss +
        (dt * buf_ss) *
            ((((-i_cal) * 0.185f) * inv(2.0 * tp06::kVss * tp06::kF) +
              (i_rel * tp06::kVsrf) * inv(tp06::kVss)) -
             (i_xfer * tp06::kVcf) * inv(tp06::kVss));
    q[kNai] = nai + dt * (((-(((i_na + i_b_na) + 3.0f * i_nak) +
                              3.0f * i_naca)) *
                           0.185f) *
                          inv(tp06::kVc * tp06::kF));
    q[kKi] = ki + dt * (((-(((((i_k1 + i_to) + i_kr) + i_ks) + i_p_k) -
                            2.0f * i_nak)) *
                         0.185f) *
                        inv(tp06::kVc * tp06::kF));
    return (v + p.diff_dt * lap) - dt * sum;
  }

  __device__ __forceinline__ static float probe(const Params& p, float v) {
    return (v - p.v_min) * p.v_inv_span;
  }
};

}  // namespace fibtorch
