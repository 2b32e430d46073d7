// One substep of a [D, H, W] volume on Hopper (sm_90a), one thread per
// cell.  The file keeps its first model's name; it hosts every cell body,
// one extern "C" entry each: br_volume (Beeler-Reuter's main path),
// br_variant_volume and br_variant_ab2_volume (BR's other variants),
// fenton_volume, fenton_ab2_volume and ms_volume (Fenton and
// Mitchell-Schaeffer, ten launches per outer step; e.g.
// examples/scroll_wave.py's Fenton scroll wave); and, as a second library
// of this source (-DFIBTORCH_COURT_ENTRIES -fmad=false), court_volume and
// court_ultra_volume (court_cell.cuh: eleven and ten launches per outer
// step); and, as a third (-DFIBTORCH_LRTP_ENTRIES -fmad=false), lr1_volume
// and tp06_volume (lr1_cell.cuh, tp06_cell.cuh: ten launches per outer
// step).
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_volume.py::
// make_pallas_volume_step, which run_volume (engine/volume.py) runs for a
// volume whose state fits the 32 MB whole-volume envelope.  That kernel
// keeps the whole volume in VMEM for the five substeps of an outer step, in
// a flat [D*H, W] layout with slice-edge masks (flat_volume_geometry).  No
// SM holds 16 MB, so this kernel is the 2D substep kernel (br_substep.cu)
// with a third axis: one launch per substep, the state left to the 50 MB
// L2.  The per-cell arithmetic is the cell body's, unchanged; for BR the
// template flag SLOW selects the body (true: the n=5 substep that advances
// the slow gates; false: the four n=0 substeps that freeze them).
//
// Per cell (z, i, j), with clamp(k) = min(max(k, 1), N-2) on each axis:
// every stencil point (z+dz, i+di, j+dj) reads V[clamp(z+dz), clamp(i+di),
// clamp(j+dj)]; the stencil and the update are br_volume_cell.cuh, shared
// with br_volume_block.cu, and this kernel clamps z over the whole depth.
//
// Memory: the potential is double-buffered (v_out must not alias v_in); the
// per-cell planes are read and rewritten in place, each thread its own cell.
//
// What bounds it: bandwidth, as for br_substep.cu.  A BR SLOW substep reads
// 8 planes and writes 8 (33.5 MB at 8x128x512 float32), a frozen one reads 8
// and writes 4 (25.2 MB), against 3.35 TB/s from HBM; the 16 MB state fits
// the L2.  A Fenton substep reads 4 planes and writes 4 (134 MB at
// 16x512x512, 40 us), a Mitchell-Schaeffer one 2 and 2.  The three z reads
// of V hit L1/L2.  The fused design (five substeps per launch in
// shared-memory tiles, BR only) is br_volume_tiled.cu, which run_volume
// takes only with its cutover lowered.
//
// Built by fib_tf_tpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface (no --use_fast_math: logf feeds e_Ca).

#include <cuda_runtime.h>
#include <string.h>

#include "br_cell.cuh"
#include "br_variant_cell.cuh"
#include "br_volume_cell.cuh"
#include "cell_traits.cuh"
#include "court_cell.cuh"
#include "fenton_cell.cuh"
#include "lr1_cell.cuh"
#include "ms_cell.cuh"
#include "torch_rounding.cuh"
#include "tp06_cell.cuh"

namespace {

using fibtorch::clamp_index;

// The per-cell planes besides the potential, in Body::Plane order.
template <int N>
struct CellPlanes {
  float* p[N];
};

template <class Body, bool SLOW>
__global__ void volume_kernel(const typename Body::Params p, const float dz2,
                              const float* __restrict__ v_in,
                              float* __restrict__ v_out,
                              const CellPlanes<Body::kPlanes> planes,
                              int depth, int height, int width,
                              float* __restrict__ probe, int probe_z,
                              int probe_row, int probe_col,
                              long long probe_index) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (row >= height || col >= width) return;

  const float v1 = fibtorch::volume_cell<Body, SLOW>(
      p, dz2, v_in, v_out, planes.p, z, clamp_index(z, depth),
      clamp_index(z - 1, depth), clamp_index(z + 1, depth), row, col, height,
      width);
  if (probe != nullptr && z == probe_z && row == probe_row &&
      col == probe_col) {
    probe[probe_index] = Body::probe(p, v1);
  }
}

// Launch one substep of body `Body` (see the entries below).
template <class Body>
int launch_volume(int slow, const float* params, int n_params,
                  float dz_ratio, const float* v_in, float* v_out,
                  void* const* planes, int n_planes, int depth, int height,
                  int width, float* probe, int probe_z, int probe_row,
                  int probe_col, long long probe_index, int device,
                  void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y, depth);
  // v_out is null exactly for a form that keeps the potential
  const bool writes = slow ? fibtorch::writes_potential<Body, true>()
                           : fibtorch::writes_potential<Body, false>();
  if (n_params != fibtorch::param_floats<Body>() ||
      n_planes != Body::kPlanes || depth < 3 || height < 3 || width < 3 ||
      depth > 65535 || grid.y > 65535 || v_in == v_out ||
      writes != (v_out != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  CellPlanes<Body::kPlanes> pl;
  for (int k = 0; k < Body::kPlanes; ++k) {
    pl.p[k] = static_cast<float*>(planes[k]);
    if ((pl.p[k] == nullptr && !fibtorch::nullable<Body>(k)) ||
        pl.p[k] == v_in || (pl.p[k] != nullptr && pl.p[k] == v_out)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  typename Body::Params p;
  memcpy(&p, params, sizeof(p));
  // (2*dz_ratio) in float, as the plain version's scalar
  const float dz2 = 2.0f * dz_ratio;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slow) {
    volume_kernel<Body, true><<<grid, block, 0, s>>>(
        p, dz2, v_in, v_out, pl, depth, height, width, probe, probe_z,
        probe_row, probe_col, probe_index);
  } else {
    volume_kernel<Body, false><<<grid, block, 0, s>>>(
        p, dz2, v_in, v_out, pl, depth, height, width, probe, probe_z,
        probe_row, probe_col, probe_index);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Per body <m> (br, br_variant, br_variant_ab2, fenton, fenton_ab2, ms):
//   <m>_volume_param_floats()  floats the host passes as `params`;
//   <m>_volume_planes()        per-cell planes besides the potential;
//   <m>_volume(...)            launch one substep of a depth x height x
//     width volume on `stream` of device `device` and return
//     cudaGetLastError().  `dz_ratio` scales the z coupling; `planes` is a
//     host array of `n_planes` device pointers in the body's Plane order,
//     updated in place.  `probe` may be null; otherwise the thread at
//     (probe_z, probe_row, probe_col) writes the normalised new potential
//     to probe[probe_index].
#define VOLUME_ENTRIES(m, Body)                                             \
  int m##_volume_param_floats() { return fibtorch::param_floats<Body>(); }  \
  int m##_volume_planes() { return Body::kPlanes; }                         \
  int m##_volume(int slow, const float* params, int n_params,               \
                 float dz_ratio, const float* v_in, float* v_out,           \
                 void* const* planes, int n_planes, int depth, int height,  \
                 int width, float* probe, int probe_z, int probe_row,       \
                 int probe_col, long long probe_index, int device,          \
                 void* stream) {                                            \
    return launch_volume<Body>(slow, params, n_params, dz_ratio, v_in,      \
                               v_out, planes, n_planes, depth, height,      \
                               width, probe, probe_z, probe_row, probe_col, \
                               probe_index, device, stream);                \
  }

// The Courtemanche bodies build as a library of their own, this source with
// -DFIBTORCH_COURT_ENTRIES (court_volume, court_ultra_volume), so that nvcc
// compiles them beside the rest, and with -fmad=false (court_cell.cuh's
// rounding); Luo-Rudy's and tp06's as a third, with -DFIBTORCH_LRTP_ENTRIES
// (lr1_volume, tp06_volume) and the same flag.
extern "C" {
#if defined(FIBTORCH_COURT_ENTRIES)
VOLUME_ENTRIES(court, fibtorch::CourtCell<false>)
VOLUME_ENTRIES(court_ultra, fibtorch::CourtCell<true>)
#elif defined(FIBTORCH_LRTP_ENTRIES)
VOLUME_ENTRIES(lr1, fibtorch::Lr1Cell)
VOLUME_ENTRIES(tp06, fibtorch::Tp06Cell)
#else
VOLUME_ENTRIES(br, fibtorch::BeelerReuterCell)
VOLUME_ENTRIES(br_variant, fibtorch::BrVariantCell<false>)
VOLUME_ENTRIES(br_variant_ab2, fibtorch::BrVariantCell<true>)
VOLUME_ENTRIES(fenton, fibtorch::FentonCell)
VOLUME_ENTRIES(fenton_ab2, fibtorch::FentonAb2Cell)
VOLUME_ENTRIES(ms, fibtorch::MsCell)
#endif
}  // extern "C"
