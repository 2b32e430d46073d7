// What the kernels ask of a cell body beyond br_cell.cuh's contract, with
// defaults for the bodies that declare nothing (Beeler-Reuter, Fenton,
// Mitchell-Schaeffer keep their code unchanged):
//   kNullablePlanes      a bit mask of the per-cell planes the host may pass
//                        as null pointers (read-only parameter planes that
//                        are not attached: Courtemanche's chronic plane,
//                        tp06's four het planes); the kernels then load 0
//                        in their place and the body reads its Params to
//                        know.  Default: none;
//   kSlowKeepsPotential  true when the SLOW form commits other planes only
//                        and must not write the potential (Courtemanche's
//                        slow commit, which reads the new V that the fast
//                        commit wrote).  The kernels then store no potential
//                        and need no Laplacian.  Default: false;
//   kCachePlanes         the number of per-cell planes of the body's cache:
//                        terms of its fast commit that read only planes its
//                        slow commit writes (Courtemanche's six), which
//                        kernel 1's cached forms (br_substep.cu) store and
//                        read; the cache is not part of the state.  A body
//                        with one takes `update<SLOW, true>(..., cache)`:
//                        the SLOW form stores the cache, the other reads it.
//                        Default: 0, no cache.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace fibtorch {

template <class Body, class = void>
struct NullablePlanes : std::integral_constant<unsigned, 0u> {};

template <class Body>
struct NullablePlanes<Body, std::void_t<decltype(Body::kNullablePlanes)>>
    : std::integral_constant<unsigned, Body::kNullablePlanes> {};

// Whether the host may pass plane k of `Body` as a null pointer.
template <class Body>
__host__ __device__ constexpr bool nullable(int k) {
  return (NullablePlanes<Body>::value >> k) & 1u;
}

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

template <class Body, class = void>
struct CachePlanes : std::integral_constant<int, 0> {};

template <class Body>
struct CachePlanes<Body, std::void_t<decltype(Body::kCachePlanes)>>
    : std::integral_constant<int, Body::kCachePlanes> {};

// The number of per-cell planes of `Body`'s cache (0: none).
template <class Body>
__host__ __device__ constexpr int cache_planes() {
  return CachePlanes<Body>::value;
}

// Load a cell's per-cell planes at element `idx`; the body's nullable
// planes read 0 where their pointers are null.
template <class Body>
__device__ __forceinline__ void load_planes(float* const* planes,
                                            long long idx,
                                            float (&q)[Body::kPlanes]) {
#pragma unroll
  for (int k = 0; k < Body::kPlanes; ++k) {
    if (nullable<Body>(k)) {
      q[k] = planes[k] != nullptr ? planes[k][idx] : 0.0f;
    } else {
      q[k] = planes[k][idx];
    }
  }
}

}  // namespace fibtorch
