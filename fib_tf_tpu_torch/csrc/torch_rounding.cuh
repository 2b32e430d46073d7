// The rounding rules of torch's elementwise arithmetic on the card, for the
// cell bodies that round as their plain path does (court_cell.cuh,
// lr1_cell.cuh, tp06_cell.cuh, built with -fmad=false): with them and each
// expression in the plain path's order, a launch equals its plain version
// bit for bit.
//   * x / c, a plane over a Python number c, is x * inv(c): torch multiplies
//     by the reciprocal, formed in double and rounded to float once (for
//     1/17.54, 1/5.3 and 1/(R T), among others, that is not 1.0f / c);
//   * c / x, a Python number over a plane, is one IEEE division (the plain
//     path's `divide`), and so is x / y;
//   * rush_larsen is ops/integrators.rush_larsen: -dt / tau one division.

#pragma once

#include <cuda_runtime.h>

#include "br_cell.cuh"

namespace fibtorch {

__host__ __device__ constexpr float inv(double c) {
  return (float)(1.0 / c);
}

__device__ __forceinline__ float rush_larsen(float g, float inf, float tau,
                                             float dt) {
  return clip(g + (g - inf) * expm1f(-dt / tau), 0.00001f, 0.99999f);
}

}  // namespace fibtorch
