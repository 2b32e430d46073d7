// The 2D geometry forms of the diffusion operator, shared by the substep
// kernel (br_substep.cu) and the tile skeleton (br_tile.cuh: br_tiled.cu and
// br_block.cu): a phase field phi (the no-flux boundary of an irregular
// domain, e.g. a hole), a per-cell relative diffusion map d (fibrosis) and a
// constant fiber tensor (dxx, dxy, dyy).  Each kernel takes them as its
// GEOM = true instantiation; GEOM = false is the isotropic 9-point stencil
// alone, and takes an empty NoGeometry in their place.
//
// What it computes, at a cell (i, j) of an H x W domain, from the
// boundary-enforced V and its eight neighbours (the kernel's clamped
// stencil points, laplace9's arguments):
//   L = laplace9 (isotropic) or, with `tensor`, the fiber operator
//       2 (dxx Vxx + 2 dxy Vxy + dyy Vyy), Vxx = W - 2C + E,
//       Vyy = N - 2C + S, Vxy = (SE + NW - SW - NE) / 4;
//   without a phase field and a diffusion map: L;
//   otherwise, with q = d phi (d = 1 without a map, phi = 1 without a
//   field), gx = E - W, gy = S - N, qx = q_e - q_w, qy = q_s - q_n:
//       d_c L + (gy qy + gx qx) / (4 phi_c)                (isotropic)
//       d_c L + (gx (dxx qx + dxy qy) + gy (dxy qx + dyy qy)) / (4 phi_c)
// which is fib_tf_tpu/ops/stencil.py's laplace / anisotropic_laplace with
// `phase_padded` and `dmap_padded` (and the TPU kernels' vmem_laplace /
// vmem_anisotropic_laplace, pallas_step.py:60-145, and block_geometry,
// pallas_tiled.py:60-175).  A null map is the reference's "no dmap" form:
// d_c L with d = 1 is L and q = phi exactly, so one code path serves all
// combinations, branched uniformly on the struct.
//
// Boundary.  V's neighbour k is read at clamp(k) (the kernel's stencil
// points).  phi, d and q are only REFLECT-padded in the reference: their
// neighbour k is at reflect(k), which maps -1 to 1 and N to N - 2 and is
// the identity inside.  On row 1, clamp(0) = 1 but reflect(0) = 0, so the
// maps keep indices of their own.  The centre values phi_c and d_c are the
// cell's own.  On a shard's block the reflection runs on the DOMAIN's
// indices: inner edges read the block's ghosts.
//
// The maps are static: read through the read-only path (__ldg), five cells
// of each per cell and substep, L1/L2-resident.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "br_cell.cuh"

namespace fibtorch {

// A launch's geometry, by value.  `phase` and `dmap` (either may be null)
// are arrays of `pitch` floats per row whose element (0, 0) is the global
// cell (rstart, cstart); a kernel's reach never leaves them.
struct Geometry {
  const float* phase;
  const float* dmap;
  int rstart, cstart, pitch;
  int tensor;               // 1: the fiber operator with (dxx, dxy, dyy)
  float dxx, dxy, dyy;
};

// GEOM = false's stand-in: no geometry.
struct NoGeometry {};

template <bool GEOM>
using GeometryArg = typename std::conditional<GEOM, Geometry, NoGeometry>::type;

// The step from a cell to its neighbour in the REFLECT-padded maps along
// one axis of n cells, at index k of the domain: -1 / +1 inside, and at
// an edge the reflection of the step that would leave the domain (k = 0
// reads k + 1 for k - 1, k = n - 1 reads k - 1 for k + 1).
__device__ __forceinline__ int back_step(int k) { return k == 0 ? 1 : -1; }
__device__ __forceinline__ int forward_step(int k, int n) {
  return k == n - 1 ? -1 : 1;
}

// q = d phi at element `at` of the maps: d alone without a field, phi
// alone without a map (at least one is present).
__device__ __forceinline__ float q_at(const Geometry& g, long long at) {
  if (g.dmap == nullptr) return __ldg(g.phase + at);
  const float d = __ldg(g.dmap + at);
  return g.phase == nullptr ? d : d * __ldg(g.phase + at);
}

// The diffusion operator at global cell (gi, gj) of a height x width
// domain (see above); n, s, w, e, nw, sw, ne, se, c as laplace9's.
__device__ __forceinline__ float geometry_laplace(
    const Geometry& g, int gi, int gj, int height, int width, float n,
    float s, float w, float e, float nw, float sw, float ne, float se,
    float c) {
  float l;
  if (g.tensor) {
    const float vxx = w - 2.0f * c + e;
    const float vyy = n - 2.0f * c + s;
    const float vxy = 0.25f * (se + nw - sw - ne);
    l = 2.0f * (g.dxx * vxx + 2.0f * g.dxy * vxy + g.dyy * vyy);
  } else {
    l = laplace9(n, s, w, e, nw, sw, ne, se, c);
  }
  if (g.phase == nullptr && g.dmap == nullptr) return l;
  const long long at =
      (long long)(gi - g.rstart) * g.pitch + (gj - g.cstart);
  if (g.dmap != nullptr) l = __ldg(g.dmap + at) * l;
  const float phi = g.phase == nullptr ? 1.0f : __ldg(g.phase + at);
  const float qx = q_at(g, at + forward_step(gj, width)) -
                   q_at(g, at + back_step(gj));
  const float qy = q_at(g, at + forward_step(gi, height) * g.pitch) -
                   q_at(g, at + back_step(gi) * g.pitch);
  const float gx = e - w;
  const float gy = s - n;
  const float flux = g.tensor
      ? gx * (g.dxx * qx + g.dxy * qy) + gy * (g.dxy * qx + g.dyy * qy)
      : gy * qy + gx * qx;
  return l + flux / (4.0f * phi);
}

// Whether the maps alias none of a launch's outputs: `v_out` and the `n`
// arrays of `outs` (host side).
inline bool maps_apart(const Geometry& g, const void* v_out,
                       void* const* outs, int n) {
  const void* maps[2] = {g.phase, g.dmap};
  for (const void* m : maps) {
    if (m == nullptr) continue;
    if (m == v_out) return false;
    for (int k = 0; k < n; ++k) {
      if (m == outs[k]) return false;
    }
  }
  return true;
}

}  // namespace fibtorch
