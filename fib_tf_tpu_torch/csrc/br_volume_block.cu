// One substep of ONE shard's z-halo-extended volume block on Hopper
// (sm_90a), one thread per cell: the per-shard compute of the wide-halo
// z-sharded volume path (fib_tf_tpu_torch/parallel/volume_spmd.py).  The
// kernel is a template over the cell body (br_cell.cuh's contract); the
// file keeps its first model's name and hosts every body, one extern "C"
// entry each: br_volume_block (Beeler-Reuter's main path),
// br_variant_volume_block and br_variant_ab2_volume_block (BR's other
// variants), fenton_volume_block, fenton_ab2_volume_block and
// ms_volume_block (Fenton and Mitchell-Schaeffer, whose groups are ten
// launches); and, as a second library of this source
// (-DFIBTORCH_COURT_ENTRIES -fmad=false), court_volume_block and
// court_ultra_volume_block (Courtemanche's group is eleven launches: its
// substep 0 is the fast commit and then the slow commit over the same
// slices, which stores no potential and reads no z neighbour away from a
// face), and as a third (-DFIBTORCH_LRTP_ENTRIES -fmad=false),
// lr1_volume_block and tp06_volume_block, as br_volume.cu builds them.
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_volume.py::
// make_volume_block_kernel (which the reference runs for fenton, br, court,
// court_ultra and ms under 'auto', fib_tf_tpu/engine/volume.py:228, and for
// every model under kernel='pallas', :213-226), which keeps a shard's
// [d + 2k, H, W] block in VMEM, in a flat [(d + 2k)*H, W] layout, for a
// fused group of substeps, with the global z-face masks taken from a plane
// of global slice indices.
// No SM holds such a block, so this is the volume substep kernel
// (br_volume.cu) on the extended block: one launch per substep of the group,
// V double-buffered, the per-cell planes in place, the state left to the
// L2.  Three ints carry what the TPU kernel's index planes carry: the
// block's slice 0 is the volume's slice `zstart`, and the volume is
// `d_total` slices deep.
//
// Per cell of local slice z (global slice zg = zstart + z):
//   * slices outside the volume (zg < 0 or zg >= d_total: the first shard's
//     upper ghosts, the last one's lower ghosts) are skipped;
//   * the z neighbours are the local slices clamp(zg - 1) - zstart,
//     clamp(zg) - zstart and clamp(zg + 1) - zstart, clamped over d_total, so
//     only a shard that owns a z face reflects there; the in-plane faces
//     reflect everywhere (br_volume_cell.cuh);
//   * a launch covers the local slices [z_lo, z_hi), 1 <= z_lo, z_hi <=
//     ext_d - 1, so no cell reads past the array.  Substep s of a group (from
//     0) is exact on the slices [s + 1, ext_d - 1 - s): their neighbours
//     were exact after substep s - 1.  The wrapper shrinks the range so, and
//     after k substeps the centre [k, ext_d - k) is exact.  A launch that
//     keeps the potential (Courtemanche's slow commit, cell_traits.cuh)
//     runs on its substep's range and shrinks nothing.
//
// What bounds it: bandwidth, as for br_volume.cu.  A BR SLOW substep reads
// 8 planes and writes 8 per computed cell, a frozen one reads 8 and writes
// 4 (with ab2 10 and 10, 10 and 6); Fenton reads and writes 4 (8 with ab2),
// Mitchell-Schaeffer 2; the large bodies' counts are br_volume.cu's.
//
// Built by fib_tf_tpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface (no --use_fast_math: logf feeds e_Ca).

// BR reads its fits from BrParams::rows (br_cell.cuh)
#define FIBTORCH_BR_FIT_ROWS

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
struct BlockPlanes {
  float* p[N];
};

template <class Body, bool SLOW>
__global__ void volume_block_kernel(
    const typename Body::Params p, const float dz2,
    const float* __restrict__ v_in, float* __restrict__ v_out,
    const BlockPlanes<Body::kPlanes> planes, int height, int width,
    int zstart, int d_total, int z_lo, float* __restrict__ probe,
    int probe_z, int probe_row, int probe_col, long long probe_index) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = z_lo + blockIdx.z;
  const int zg = zstart + z;
  if (row >= height || col >= width || zg < 0 || zg >= d_total) return;

  const float v1 = fibtorch::volume_cell<Body, SLOW>(
      p, dz2, v_in, v_out, planes.p, z, clamp_index(zg, d_total) - zstart,
      clamp_index(zg - 1, d_total) - zstart,
      clamp_index(zg + 1, d_total) - zstart, row, col, height, width);
  if (probe != nullptr && z == probe_z && row == probe_row &&
      col == probe_col) {
    probe[probe_index] = Body::probe(p, v1);
  }
}

// Launch one substep of body `Body` (see the entries below).
template <class Body>
int launch_volume_block(int slow, const float* params, int n_params,
                        float dz_ratio, const float* v_in, float* v_out,
                        void* const* planes, int n_planes, int ext_d,
                        int height, int width, int zstart, int d_total,
                        int z_lo, int z_hi, float* probe, int probe_z,
                        int probe_row, int probe_col, long long probe_index,
                        int device, void* stream) {
  const dim3 block(32, 8);
  // v_out is null exactly for a form that keeps the potential
  const bool writes = slow ? fibtorch::writes_potential<Body, true>()
                           : fibtorch::writes_potential<Body, false>();
  if (n_params != fibtorch::param_floats<Body>() ||
      n_planes != Body::kPlanes || d_total < 3 || height < 3 || width < 3 ||
      z_lo < 1 || z_hi > ext_d - 1 || z_lo >= z_hi || z_hi - z_lo > 65535 ||
      v_in == v_out || writes != (v_out != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y, z_hi - z_lo);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  BlockPlanes<Body::kPlanes> pl;
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
    volume_block_kernel<Body, true><<<grid, block, 0, s>>>(
        p, dz2, v_in, v_out, pl, height, width, zstart, d_total, z_lo, probe,
        probe_z, probe_row, probe_col, probe_index);
  } else {
    volume_block_kernel<Body, false><<<grid, block, 0, s>>>(
        p, dz2, v_in, v_out, pl, height, width, zstart, d_total, z_lo, probe,
        probe_z, probe_row, probe_col, probe_index);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Per body <m> (br, br_variant, br_variant_ab2, fenton, fenton_ab2, ms;
// court, court_ultra; lr1, tp06):
//   <m>_volume_block_param_floats()  floats the host passes as `params`;
//   <m>_volume_block_planes()        per-cell planes besides the potential;
//   <m>_volume_block(...)            launch one substep on the local slices
//     [z_lo, z_hi) of an ext_d x height x width block whose slice 0 is slice
//     `zstart` of a volume `d_total` deep, on `stream` of device `device`;
//     return cudaGetLastError().  `planes` is a host array of `n_planes`
//     device pointers in the body's Plane order, updated in place; `v_out`
//     must not alias `v_in` and is null exactly for a form that keeps the
//     potential; a nullable plane may be null.  `probe` may be null;
//     otherwise the thread at
//     the LOCAL cell (probe_z, probe_row, probe_col) writes the normalised
//     new potential to probe[probe_index].
#define VOLUME_BLOCK_ENTRIES(m, Body)                                       \
  int m##_volume_block_param_floats() {                                     \
    return fibtorch::param_floats<Body>();                                  \
  }                                                                         \
  int m##_volume_block_planes() { return Body::kPlanes; }                   \
  int m##_volume_block(int slow, const float* params, int n_params,         \
                       float dz_ratio, const float* v_in, float* v_out,     \
                       void* const* planes, int n_planes, int ext_d,        \
                       int height, int width, int zstart, int d_total,      \
                       int z_lo, int z_hi, float* probe, int probe_z,       \
                       int probe_row, int probe_col, long long probe_index, \
                       int device, void* stream) {                          \
    return launch_volume_block<Body>(                                       \
        slow, params, n_params, dz_ratio, v_in, v_out, planes, n_planes,    \
        ext_d, height, width, zstart, d_total, z_lo, z_hi, probe, probe_z,  \
        probe_row, probe_col, probe_index, device, stream);                 \
  }

// As br_volume.cu: the Courtemanche bodies build as a library of their own
// (-DFIBTORCH_COURT_ENTRIES: court_volume_block, court_ultra_volume_block)
// and Luo-Rudy's and tp06's as a third (-DFIBTORCH_LRTP_ENTRIES:
// lr1_volume_block, tp06_volume_block), both with -fmad=false.
extern "C" {
#if defined(FIBTORCH_COURT_ENTRIES)
VOLUME_BLOCK_ENTRIES(court, fibtorch::CourtCell<false>)
VOLUME_BLOCK_ENTRIES(court_ultra, fibtorch::CourtCell<true>)
#elif defined(FIBTORCH_LRTP_ENTRIES)
VOLUME_BLOCK_ENTRIES(lr1, fibtorch::Lr1Cell)
VOLUME_BLOCK_ENTRIES(tp06, fibtorch::Tp06Cell)
#else
VOLUME_BLOCK_ENTRIES(br, fibtorch::BeelerReuterCell)
VOLUME_BLOCK_ENTRIES(br_variant, fibtorch::BrVariantCell<false>)
VOLUME_BLOCK_ENTRIES(br_variant_ab2, fibtorch::BrVariantCell<true>)
VOLUME_BLOCK_ENTRIES(fenton, fibtorch::FentonCell)
VOLUME_BLOCK_ENTRIES(fenton_ab2, fibtorch::FentonAb2Cell)
VOLUME_BLOCK_ENTRIES(ms, fibtorch::MsCell)
#endif
}  // extern "C"
