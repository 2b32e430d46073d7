// The per-cell Mitchell-Schaeffer update, the cell body that kernels 1-4 of
// the port run for fib_tf_tpu_torch/models/mitchell_schaeffer.py (the
// reference's fib_tf_tpu/models/mitchell_schaeffer.py).  The contract of a
// cell body is in br_cell.cuh.
//
// One substep, in float32 and in the plain path's order of operations:
//   j_in = h*u*u*(1-u)/tau_in, j_out = -u/tau_out at the cell's RAW u;
//   u' = (u0 + dt*(j_in + j_out)) + (diff*dt)*lap, u0 the boundary-enforced
//   centre; h relaxes exactly: h' = 1 - (1-h)*exp(-dt/tau_open) where the
//   raw u < U_GATE (a float32 compare, as the plain path's), else
//   h' = h*exp(-dt/tau_close).  The two factors are constants of the run,
//   packed by the host in float32 as the plain path computes them
//   (mitchell_schaeffer.py::decay).  Every substep is the same body: SLOW
//   means nothing here.

#pragma once

#include <cuda_runtime.h>

namespace fibtorch {

struct MsParams {
  float dt, diff_dt;               // dt and diff*dt, rounded from double once
  float s_in, s_out;               // the g_scale factors of the two currents
  float decay_open, decay_close;   // exp(-dt/tau_open), exp(-dt/tau_close)
  float v_min, v_span;             // probe normalisation: (u - v_min) / v_span
};

struct MsCell {
  using Params = MsParams;
  // the per-cell planes, in the order of cuda_step.MS_PLANES
  enum Plane { kH, kPlanes };

  template <bool SLOW>
  __host__ __device__ static constexpr bool stores(int) {
    return true;
  }

  // One substep (mitchell_schaeffer.py::solve): `u` is the raw centre, `u0`
  // the boundary-enforced one.
  template <bool SLOW>
  __device__ __forceinline__ static float update(const Params& p, float u0,
                                                 float u, float lap,
                                                 float (&q)[kPlanes]) {
    constexpr float kTauIn = 0.3f, kTauOut = 6.0f, kUGate = 0.13f;
    const float h = q[kH];
    const float j_in = p.s_in * (h * u * u * (1.0f - u) / kTauIn);
    const float j_out = p.s_out * (-u / kTauOut);
    q[kH] = u < kUGate ? 1.0f - (1.0f - h) * p.decay_open
                       : h * p.decay_close;
    return u0 + p.dt * (j_in + j_out) + p.diff_dt * lap;
  }

  __device__ __forceinline__ static float probe(const Params& p, float u) {
    return (u - p.v_min) / p.v_span;
  }
};

}  // namespace fibtorch
