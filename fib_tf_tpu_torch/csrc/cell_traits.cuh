// What the kernels ask of a cell body beyond br_cell.cuh's contract, with
// defaults for the bodies that declare nothing (Beeler-Reuter, Fenton,
// Mitchell-Schaeffer keep their code unchanged):
//   kNullablePlane       the one per-cell plane the host may pass as a null
//                        pointer (a read-only parameter plane that is not
//                        attached); the kernels then load 0 in its place and
//                        the body reads its Params to know.  Default: none;
//   kSlowKeepsPotential  true when the SLOW form commits other planes only
//                        and must not write the potential (Courtemanche's
//                        slow commit, which reads the new V that the fast
//                        commit wrote).  The kernels then store no potential
//                        and need no Laplacian.  Default: false.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace fibtorch {

template <class Body, class = void>
struct NullablePlane : std::integral_constant<int, -1> {};

template <class Body>
struct NullablePlane<Body, std::void_t<decltype(Body::kNullablePlane)>>
    : std::integral_constant<int, Body::kNullablePlane> {};

template <class Body, class = void>
struct SlowKeepsPotential : std::false_type {};

template <class Body>
struct SlowKeepsPotential<Body,
                          std::void_t<decltype(Body::kSlowKeepsPotential)>>
    : std::integral_constant<bool, Body::kSlowKeepsPotential> {};

// Whether the form SLOW of `Body` writes the potential.
template <class Body, bool SLOW>
__host__ __device__ constexpr bool writes_potential() {
  return !(SLOW && SlowKeepsPotential<Body>::value);
}

// Load a cell's per-cell planes at element `idx`; the body's nullable
// plane reads 0 where its pointer is null.
template <class Body>
__device__ __forceinline__ void load_planes(float* const* planes,
                                            long long idx,
                                            float (&q)[Body::kPlanes]) {
  constexpr int nullable = NullablePlane<Body>::value;
#pragma unroll
  for (int k = 0; k < Body::kPlanes; ++k) {
    if (k == nullable) {
      q[k] = planes[k] != nullptr ? planes[k][idx] : 0.0f;
    } else {
      q[k] = planes[k][idx];
    }
  }
}

}  // namespace fibtorch
