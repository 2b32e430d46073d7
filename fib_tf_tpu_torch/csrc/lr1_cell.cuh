// The per-cell Luo-Rudy 1991 update (guinea-pig ventricle, 8 variables):
// the cell body that kernels 1 (br_substep.cu) and 4 (br_volume.cu) run for
// fib_tf_tpu_torch/models/luo_rudy.py (the reference's
// fib_tf_tpu/models/luo_rudy.py), Lr1Cell.  The contract of a cell body is
// br_cell.cuh's.
//
// Forms.  An outer step is ten substeps at dt (0.02 ms by default).
//   SLOW = true advances every plane, the slow gates x, d, f by
//     Params::dt_slow: 10 dt under skip (the outer step's first substep,
//     solve(n=10)), dt without (every substep, solve(n=1));
//   SLOW = false freezes x, d, f (solve(n=0), the nine substeps after the
//     first under skip) and stores V, Cai, m, h, j.
// Under skip an outer step is one SLOW launch and nine frozen ones; without,
// ten SLOW launches.
//
// Rates are direct (luo_rudy.py gate_rates, xi_factor, k1_inf), their
// branches taken on the reference's conditions (alpha_m's limit 3.2 where
// |V + 47.13| < 1e-3, Xi's limit where |V + 77| < 1e-3, h and j switching
// at V = -40 mV).  The currents read the PRE-update gates.
//
// Rounding.  The update rounds as the plain path (luo_rudy.py under torch)
// does on the card, operation for operation (torch_rounding.cuh): the
// library is built with -fmad=false (no product is contracted into an FMA);
// each expression keeps the plain path's order; a plane over a Python
// number c is a product with inv(c), as torch computes it; a Python number
// over a plane is one IEEE division (the plain path's `divide`); and the
// constants the reference forms in double (E_Na, E_K, E_K1, Xi's limit, the
// conductances with their g_scale factors) come from the host rounded to
// float once (cuda_step._pack_lr1).  A launch then equals its plain version
// bit for bit.
//
// What bounds it: per cell a SLOW launch reads 8 planes and writes 8, a
// frozen one reads 8 and writes 5; about 25 exponentials and a logarithm
// in a SLOW launch (16 frozen).  Bytes dominate at 3.35 TB/s; PERF.md keeps
// the measured times.

#pragma once

#include <cuda_runtime.h>

#include "br_cell.cuh"
#include "torch_rounding.cuh"

namespace fibtorch {

namespace lr1 {

// One gate's Rush-Larsen update from its alpha and beta (solve's
// tau = 1 / (a + b), inf = a * tau).
__device__ __forceinline__ float gate(float g, float a, float b, float dt) {
  const float tau = 1.0f / (a + b);
  return rush_larsen(g, a * tau, tau, dt);
}

}  // namespace lr1

struct Lr1Params {
  // the conductances with their g_scale factors folded in (g_si the
  // instance's, possibly set after construction)
  float g_na, g_si, g_k, g_k1, g_kp, g_b;
  // reversal potentials and Xi's limit at V = -77 mV, from double
  float e_na, e_k, e_k1, e_kp, e_b, xi_lim;
  float dt, dt_slow;   // dt, and the slow gates' step in a SLOW launch
  float diff_dt;       // diff * dt
  // probe normalisation (v - v_min) / (v_max - v_min), as torch takes it:
  // a product with the reciprocal, formed in double on the host
  float v_min, v_inv_span;
};

struct Lr1Cell {
  using Params = Lr1Params;
  // the per-cell planes, in the order of cuda_step.LR1_PLANES
  enum Plane { kCa, kM, kH, kJ, kD, kF, kX, kPlanes };

  // a frozen launch leaves x, d and f
  template <bool SLOW>
  __host__ __device__ static constexpr bool stores(int k) {
    return SLOW || !(k == kD || k == kF || k == kX);
  }

  template <bool SLOW>
  __device__ __forceinline__ static float update(const Params& p, float v,
                                                 float /* raw */, float lap,
                                                 float (&q)[kPlanes]) {
    const float m = q[kM];
    const float h = q[kH];
    const float j = q[kJ];
    const float d = q[kD];
    const float f = q[kF];
    const float x = q[kX];
    const float cai = q[kCa];

    // the fast Na gates, every substep
    const float dm = v + 47.13f;
    const float a_m = fabsf(dm) < 1e-3f
                          ? 3.2f
                          : (0.32f * dm) / (1.0f - expf(-0.1f * dm));
    const float b_m = 0.08f * expf((-v) * inv(11.0));
    q[kM] = lr1::gate(m, a_m, b_m, p.dt);
    float a_h, b_h, a_j, b_j;
    if (v < -40.0f) {
      a_h = 0.135f * expf((-(v + 80.0f)) * inv(6.8));
      b_h = 3.56f * expf(0.079f * v) + 310000.0f * expf(0.35f * v);
      a_j = ((-127140.0f * expf(0.2444f * v) -
              3.474e-5f * expf(-0.04391f * v)) *
             (v + 37.78f)) /
            (1.0f + expf(0.311f * (v + 79.23f)));
      b_j = (0.1212f * expf(-0.01052f * v)) /
            (1.0f + expf(-0.1378f * (v + 40.14f)));
    } else {
      a_h = 0.0f;
      b_h = 1.0f / (0.13f * (1.0f + expf((-(v + 10.66f)) * inv(11.1))));
      a_j = 0.0f;
      b_j = (0.3f * expf(-2.535e-7f * v)) /
            (1.0f + expf(-0.1f * (v + 32.0f)));
    }
    q[kH] = lr1::gate(h, a_h, b_h, p.dt);
    q[kJ] = lr1::gate(j, a_j, b_j, p.dt);

    // the slow gates, by dt_slow in a SLOW launch
    if constexpr (SLOW) {
      const float a_d = (0.095f * expf(-0.01f * (v - 5.0f))) /
                        (1.0f + expf(-0.072f * (v - 5.0f)));
      const float b_d = (0.07f * expf(-0.017f * (v + 44.0f))) /
                        (1.0f + expf(0.05f * (v + 44.0f)));
      const float a_f = (0.012f * expf(-0.008f * (v + 28.0f))) /
                        (1.0f + expf(0.15f * (v + 28.0f)));
      const float b_f = (0.0065f * expf(-0.02f * (v + 30.0f))) /
                        (1.0f + expf(-0.2f * (v + 30.0f)));
      const float a_x = (0.0005f * expf(0.083f * (v + 50.0f))) /
                        (1.0f + expf(0.057f * (v + 50.0f)));
      const float b_x = (0.0013f * expf(-0.06f * (v + 20.0f))) /
                        (1.0f + expf(-0.04f * (v + 20.0f)));
      q[kX] = lr1::gate(x, a_x, b_x, p.dt_slow);
      q[kD] = lr1::gate(d, a_d, b_d, p.dt_slow);
      q[kF] = lr1::gate(f, a_f, b_f, p.dt_slow);
    }

    // the six currents from the pre-update gates
    const float i_na = (((p.g_na * ((m * m) * m)) * h) * j) * (v - p.e_na);
    const float e_si = 7.7f - 13.0287f * logf(cai);
    const float i_si = ((p.g_si * d) * f) * (v - e_si);
    float xi = v > -100.0f ? (2.837f * (expf(0.04f * (v + 77.0f)) - 1.0f)) /
                                 ((v + 77.0f) * expf(0.04f * (v + 35.0f)))
                           : 1.0f;
    if (fabsf(v + 77.0f) < 1e-3f) xi = p.xi_lim;
    const float i_k = ((p.g_k * x) * xi) * (v - p.e_k);
    const float dv = v - p.e_k1;
    const float k1_a = 1.02f / (1.0f + expf(0.2385f * (dv - 59.215f)));
    const float k1_b = (0.49124f * expf(0.08032f * (dv + 5.476f)) +
                        expf(0.06175f * (dv - 594.31f))) /
                       (1.0f + expf(-0.5143f * (dv + 4.753f)));
    const float i_k1 = (p.g_k1 * (k1_a / (k1_a + k1_b))) * (v - p.e_k1);
    const float kp = 1.0f / (1.0f + expf((7.488f - v) * inv(5.98)));
    const float i_kp = (p.g_kp * kp) * (v - p.e_kp);
    const float i_b = p.g_b * (v - p.e_b);
    const float sum = i_na + i_si + i_k + i_k1 + i_kp + i_b;

    q[kCa] = cai + p.dt * (-1e-4f * i_si + 0.07f * (1e-4f - cai));
    // dt * sum / C_M: the division by C_M = 1 is exact
    return (v + p.diff_dt * lap) - p.dt * sum;
  }

  __device__ __forceinline__ static float probe(const Params& p, float v) {
    return (v - p.v_min) * p.v_inv_span;
  }
};

}  // namespace fibtorch
