// One Beeler-Reuter substep of a [D, H, W] volume on Hopper (sm_90a), one
// thread per cell.
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_volume.py::
// make_pallas_volume_step, which run_volume (engine/volume.py) runs for a
// volume whose state fits the 32 MB whole-volume envelope.  That kernel
// keeps the whole volume in VMEM for the five substeps of an outer step, in
// a flat [D*H, W] layout with slice-edge masks (flat_volume_geometry).  No
// SM holds 16 MB, so this kernel is the 2D substep kernel (br_substep.cu)
// with a third axis: one launch per substep, the state left to the 50 MB
// L2.  The per-cell arithmetic is br_cell.cuh, unchanged; the template flag
// SLOW selects the body (true: the n=5 substep that advances the slow gates;
// false: the four n=0 substeps that freeze them).
//
// Per cell (z, i, j), with clamp(k) = min(max(k, 1), N-2) on each axis:
// every stencil point (z+dz, i+di, j+dj) reads V[clamp(z+dz), clamp(i+di),
// clamp(j+dj)]; the stencil and the update are br_volume_cell.cuh, shared
// with br_volume_block.cu, and this kernel clamps z over the whole depth.
//
// Memory: V is double-buffered (v_out must not alias v_in); the seven
// per-cell planes are read and rewritten in place, each thread its own cell.
//
// What bounds it: bandwidth, as for br_substep.cu.  A SLOW substep reads 8
// planes and writes 8 (33.5 MB at 8x128x512 float32), a frozen one reads 8
// and writes 4 (25.2 MB), against 3.35 TB/s from HBM; the 16 MB state fits
// the L2.  The three z reads of V hit L1/L2.  The fused design (five
// substeps per launch in shared-memory tiles) is br_volume_tiled.cu, which
// run_volume takes past the 32 MB cutover.
//
// Built by fib_tf_tpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface (no --use_fast_math: logf feeds e_Ca).

#include <cuda_runtime.h>
#include <string.h>

#include "br_cell.cuh"
#include "br_volume_cell.cuh"

namespace {

using fibtorch::BeelerReuterCell;
using fibtorch::BrParams;
using fibtorch::clamp_index;
using fibtorch::kParamFloats;

template <bool SLOW>
__global__ void br_volume_kernel(const BrParams p, const float dz2,
                                 const float* __restrict__ v_in,
                                 float* __restrict__ v_out,
                                 float* __restrict__ c_pl,
                                 float* __restrict__ m_pl,
                                 float* __restrict__ h_pl,
                                 float* __restrict__ j_pl,
                                 float* __restrict__ d_pl,
                                 float* __restrict__ f_pl,
                                 float* __restrict__ x1_pl,
                                 int depth, int height, int width,
                                 float* __restrict__ probe, int probe_z,
                                 int probe_row, int probe_col,
                                 long long probe_index) {
  using Cell = BeelerReuterCell;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (row >= height || col >= width) return;

  // the per-cell planes, in Cell::Plane order
  float* const planes[Cell::kPlanes] = {c_pl, m_pl, h_pl, j_pl,
                                        d_pl, f_pl, x1_pl};
  const float v1 = fibtorch::volume_cell<SLOW>(
      p, dz2, v_in, v_out, planes, z, clamp_index(z, depth),
      clamp_index(z - 1, depth), clamp_index(z + 1, depth), row, col, height,
      width);
  if (probe != nullptr && z == probe_z && row == probe_row &&
      col == probe_col) {
    probe[probe_index] = Cell::probe(p, v1);
  }
}

}  // namespace

extern "C" {

// Number of floats the host passes as `params` (the BrParams layout).
int br_volume_param_floats() { return kParamFloats; }

// Launch one substep of a depth x height x width volume on `stream` of
// device `device` and return cudaGetLastError().  `params` is a host array
// of br_volume_param_floats() floats; `dz_ratio` scales the z coupling.
// `probe` may be null; otherwise the thread at (probe_z, probe_row,
// probe_col) writes the normalised new V to probe[probe_index].
int br_volume(int slow, const float* params, int n_params, float dz_ratio,
              const float* v_in, float* v_out, float* c, float* m, float* h,
              float* j, float* d, float* f, float* x1, int depth, int height,
              int width, float* probe, int probe_z, int probe_row,
              int probe_col, long long probe_index, int device,
              void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y, depth);
  if (n_params != kParamFloats || depth < 3 || height < 3 || width < 3 ||
      depth > 65535 || grid.y > 65535 || v_in == v_out) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BrParams p;
  memcpy(&p, params, sizeof(BrParams));
  // (2*dz_ratio) in float, as the plain version's scalar
  const float dz2 = 2.0f * dz_ratio;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slow) {
    br_volume_kernel<true><<<grid, block, 0, s>>>(
        p, dz2, v_in, v_out, c, m, h, j, d, f, x1, depth, height, width,
        probe, probe_z, probe_row, probe_col, probe_index);
  } else {
    br_volume_kernel<false><<<grid, block, 0, s>>>(
        p, dz2, v_in, v_out, c, m, h, j, d, f, x1, depth, height, width,
        probe, probe_z, probe_row, probe_col, probe_index);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
