// One substep of one cell of a [D, H, W] volume, for any cell body
// (br_cell.cuh's contract): the 3D stencil and the cell update shared by
// br_volume.cu (a whole volume) and br_volume_block.cu (one shard's
// z-halo-extended block), each for every cell body.  The kernels decide which slices of their
// array hold the cell's z neighbours; this header owns everything in the
// plane and the arithmetic.
//
// In the plane, with clamp(k) = min(max(k, 1), N-2): every stencil point
// (i+di, j+dj) reads V[clamp(i+di), clamp(j+dj)], the SYMMETRIC face
// rewrite composed with the REFLECT pad (ops/stencil3d.py
// enforce_boundary3d + laplace3d).  Along z the caller passes the array's
// slice indices of clamp(z), clamp(z-1) and clamp(z+1), clamped over the
// volume's own depth.  lap = planar + (2*dz_ratio) * ((up - 2*v0) + down),
// summed in the reference's order (stencil3d.py:91-93); then the cell
// body's update, with the cell's raw centre v_in[z, row, col] beside v0.
//
// Memory: the potential is read from `v_in` and written to `v_out` (never
// the same array), except by a form that keeps it (cell_traits.cuh); the
// per-cell planes are read and rewritten in place, each thread its own
// cell.

#pragma once

#include <cuda_runtime.h>

#include "br_cell.cuh"
#include "cell_traits.cuh"

namespace fibtorch {

// `z` is the array's slice of the cell itself; `zc`, `zu`, `zd` those of
// clamp(z), clamp(z-1), clamp(z+1).  Returns the new potential.
template <class Body, bool SLOW>
__device__ __forceinline__ float volume_cell(
    const typename Body::Params& p, const float dz2,
    const float* __restrict__ v_in, float* __restrict__ v_out,
    float* const (&planes)[Body::kPlanes], int z, int zc, int zu, int zd,
    int row, int col, int height, int width) {
  const long long plane = (long long)height * width;
  const float* sc = v_in + zc * plane;
  const float* su = v_in + zu * plane;
  const float* sd = v_in + zd * plane;
  const int rn = clamp_index(row - 1, height) * width;
  const int rc = clamp_index(row, height) * width;
  const int rs = clamp_index(row + 1, height) * width;
  const int cw = clamp_index(col - 1, width);
  const int cc = clamp_index(col, width);
  const int ce = clamp_index(col + 1, width);

  const float v0 = sc[rc + cc];
  // a form that keeps the potential (cell_traits.cuh) needs no Laplacian
  float lap = 0.0f;
  if constexpr (writes_potential<Body, SLOW>()) {
    const float planar = laplace9(sc[rn + cc], sc[rs + cc], sc[rc + cw],
                                  sc[rc + ce], sc[rn + cw], sc[rs + cw],
                                  sc[rn + ce], sc[rs + ce], v0);
    lap = planar + dz2 * ((su[rc + cc] - 2.0f * v0) + sd[rc + cc]);
  }

  const long long idx = z * plane + (long long)row * width + col;
  float q[Body::kPlanes];
  load_planes<Body>(planes, idx, q);
  const float v1 = Body::template update<SLOW>(p, v0, v_in[idx], lap, q);
  if constexpr (writes_potential<Body, SLOW>()) v_out[idx] = v1;
#pragma unroll
  for (int k = 0; k < Body::kPlanes; ++k) {
    if (Body::template stores<SLOW>(k)) planes[k][idx] = q[k];
  }
  return v1;
}

}  // namespace fibtorch
