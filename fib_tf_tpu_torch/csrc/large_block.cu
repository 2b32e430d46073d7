// One commit of the outer step of ONE shard's halo-extended block on Hopper
// (sm_90a), one thread per cell: the per-shard compute of the wide-halo
// sharded path (fib_tf_tpu_torch/parallel/spmd.py) for the cell bodies of
// 8-23 planes, which br_block.cu's tile skeleton cannot hold.  A template
// over the cell body, one extern "C" entry per body and form: built with
// -DFIBTORCH_COURT_ENTRIES -fmad=false, court_block[_geom] and
// court_ultra_block[_geom] (court_cell.cuh); with -DFIBTORCH_LRTP_ENTRIES
// -fmad=false, lr1_block[_geom] and tp06_block[_geom] (lr1_cell.cuh,
// tp06_cell.cuh).
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_tiled.py::make_block_kernel
// (pl.pallas_call at :292) for these bodies.  That kernel holds the shard's
// whole [h/n + 2K, W (+ 2K)] block in VMEM for the fused outer step, split
// into chained launches on the same block with `substeps_per_launch`
// (tp06: 5).  The tile skeleton of br_tile.cuh keeps (3 + planes) x 16 KB
// of shared memory per block: 368 KB for Courtemanche, 416 KB for tp06 with
// its het planes, past the 227 KB an SM gives a block.  So this kernel is
// the substep kernel (br_substep.cu) on the extended block, as
// br_volume_block.cu is the volume substep kernel on a z-extended block:
// one launch per commit of the outer step (K = dt_per_step = 10 substeps;
// Courtemanche's substep 0 is two launches, the fast commit and then the
// slow commit, as on kernel 1: eleven launches; the others ten).
//
// Per cell (r, c) of the block, global (gr, gc) = (rstart + r, cstart + c):
//   * a launch after s substeps of the step computes the local rows
//     [s + 1, ext_h - 1 - s) and, on a 2D mesh, the local columns [s + 1,
//     ext_w - 1 - s): their neighbours were exact after substep s - 1, so
//     after K substeps the centre is exact (br_volume_block.cu's z rule on
//     rows and columns).  Courtemanche's slow commit reads V at the cell's
//     clamped stencil point only, which is the cell itself away from a
//     domain edge and a cell of the same range at one: it runs on the fast
//     commit's range and shrinks nothing;
//   * cells outside the DOMAIN (the first shard's upper ghosts, the last
//     one's lower ghosts; the outer columns of a 2D mesh) are skipped, never
//     computed;
//   * the stencil clamps against the domain, clamp(k) = min(max(k, 1),
//     N - 2) on the global index, so only a shard that owns a domain edge
//     reflects there (the TPU kernel's global-index masks from the runtime
//     rstart / cstart, block_geometry in ops/pallas_tiled.py);
//   * lap = laplace9 of br_cell.cuh, or under a geometry geometry.cuh's
//     operator with the shard's maps extended like its block, and then the
//     body's update, exactly as br_substep.cu computes them: a sharded run
//     equals the unsharded kernel-1 run bit for bit.
//
// Memory: V is double-buffered: v_in and v_out never alias, and the
// wrapper alternates a scratch plane with the output block's V so that the
// last launch writes the output.  The other planes are read from
// `planes_in` and written to `planes_out`: the first launch of a step reads
// the input block and writes every plane of the output (copy_all: the
// planes its form does not commit are copied through), the others update
// the output block in place, each thread its own cell.  The input block is
// never written: the neighbours' halo copies may still read its centre.
//
// What bounds it: the bytes, as for br_substep.cu.  A Courtemanche fast
// commit reads 16 planes and writes 4, its slow commit reads 19 and writes
// 17; tp06 reads 19 (23 with its het planes) and writes 19; LR1 reads 8 and
// writes 8; on the whole extended block of each launch, shrinking by a
// ring per substep.  The simple design pays for it: the state makes 10-11
// round trips through L2/HBM per outer step where the TPU kernel made one,
// and the ghost rings are recomputed.  Fusing the commits into one launch
// with a K-ring halo in shared memory is later work (PERF.md section 7).
//
// Built by fib_tf_tpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface, with -fmad=false (the bodies round as the plain
// path does under torch on the card: torch_rounding.cuh).

#include <cuda_runtime.h>
#include <string.h>

#include "br_cell.cuh"
#include "cell_traits.cuh"
#include "court_cell.cuh"
#include "geometry.cuh"
#include "lr1_cell.cuh"
#include "torch_rounding.cuh"
#include "tp06_cell.cuh"

namespace {

using fibtorch::clamp_index;
using fibtorch::laplace9;

// The per-cell planes besides the potential, in Body::Plane order.
template <int N>
struct BlockPlanes {
  float* p[N];
};

template <class Body, bool SLOW, bool GEOM>
__global__ void large_block_kernel(
    const typename Body::Params p, const float* __restrict__ v_in,
    float* __restrict__ v_out, const BlockPlanes<Body::kPlanes> in,
    const BlockPlanes<Body::kPlanes> out, int ext_w, int rstart, int cstart,
    int height, int width, int r_lo, int c_lo, int n_rows, int n_cols,
    int copy_all, float* __restrict__ probe, int probe_r, int probe_c,
    long long probe_index, const fibtorch::GeometryArg<GEOM> geo) {
  const int c = c_lo + blockIdx.x * blockDim.x + threadIdx.x;
  const int r = r_lo + blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= r_lo + n_rows || c >= c_lo + n_cols) return;
  const int gr = rstart + r;
  const int gc = cstart + c;

  // the clamped stencil points, as local offsets of the block
  const int rn = (clamp_index(gr - 1, height) - rstart) * ext_w;
  const int rc = (clamp_index(gr, height) - rstart) * ext_w;
  const int rs = (clamp_index(gr + 1, height) - rstart) * ext_w;
  const int cw = clamp_index(gc - 1, width) - cstart;
  const int cc = clamp_index(gc, width) - cstart;
  const int ce = clamp_index(gc + 1, width) - cstart;

  const float v0 = v_in[rc + cc];
  // a form that keeps the potential (cell_traits.cuh) needs no Laplacian
  float lap = 0.0f;
  if constexpr (fibtorch::writes_potential<Body, SLOW>()) {
    if constexpr (GEOM) {
      lap = fibtorch::geometry_laplace(
          geo, gr, gc, height, width, v_in[rn + cc], v_in[rs + cc],
          v_in[rc + cw], v_in[rc + ce], v_in[rn + cw], v_in[rs + cw],
          v_in[rn + ce], v_in[rs + ce], v0);
    } else {
      lap = laplace9(v_in[rn + cc], v_in[rs + cc], v_in[rc + cw],
                     v_in[rc + ce], v_in[rn + cw], v_in[rs + cw],
                     v_in[rn + ce], v_in[rs + ce], v0);
    }
  }

  const long long idx = (long long)r * ext_w + c;
  float q[Body::kPlanes];
  fibtorch::load_planes<Body>(in.p, idx, q);
  const float v1 = Body::template update<SLOW>(p, v0, v_in[idx], lap, q);
  if constexpr (fibtorch::writes_potential<Body, SLOW>()) v_out[idx] = v1;
#pragma unroll
  for (int k = 0; k < Body::kPlanes; ++k) {
    if (Body::template stores<SLOW>(k)) {
      out.p[k][idx] = q[k];
    } else if (copy_all && out.p[k] != nullptr) {
      // the input's value, not the form's uncommitted one
      out.p[k][idx] = in.p[k][idx];
    }
  }
  if (probe != nullptr && r == probe_r && c == probe_c) {
    probe[probe_index] = Body::probe(p, v1);
  }
}

// Launch one commit of body `Body` (see the entries below); with GEOM,
// under the geometry `geo`, whose maps have the block's layout.
template <class Body, bool GEOM>
int launch_large_block(int slow, const float* params, int n_params,
                       const float* v_in, float* v_out,
                       void* const* planes_in, void* const* planes_out,
                       int n_planes, int ext_h, int ext_w, int rstart,
                       int cstart, int halo, int two_d, int height,
                       int width, int shrink, int copy_all, float* probe,
                       int probe_row, int probe_col, long long probe_index,
                       int device, void* stream,
                       fibtorch::GeometryArg<GEOM> geo) {
  // v_out is null exactly for a form that keeps the potential
  const bool writes = slow ? fibtorch::writes_potential<Body, true>()
                           : fibtorch::writes_potential<Body, false>();
  if (n_params != fibtorch::param_floats<Body>() ||
      n_planes != Body::kPlanes || height < 3 || width < 3 ||
      ext_h <= 2 * halo || shrink < 0 || shrink >= halo || v_in == v_out ||
      writes != (v_out != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // the centre must be a window of the domain; on a 1D mesh the block
  // spans the domain's width
  if (rstart + halo < 0 || rstart + ext_h - halo > height) {
    return (int)cudaErrorInvalidValue;
  }
  int r_lo = shrink + 1, r_hi = ext_h - 1 - shrink, c_lo, c_hi;
  if (two_d) {
    if (ext_w <= 2 * halo || cstart + halo < 0 ||
        cstart + ext_w - halo > width) {
      return (int)cudaErrorInvalidValue;
    }
    c_lo = shrink + 1;
    c_hi = ext_w - 1 - shrink;
  } else {
    if (cstart != 0 || ext_w != width) return (int)cudaErrorInvalidValue;
    c_lo = 0;
    c_hi = width;
  }
  // skip the cells outside the domain
  r_lo = r_lo > -rstart ? r_lo : -rstart;
  r_hi = r_hi < height - rstart ? r_hi : height - rstart;
  c_lo = c_lo > -cstart ? c_lo : -cstart;
  c_hi = c_hi < width - cstart ? c_hi : width - cstart;
  if (probe != nullptr &&
      (probe_row < rstart + halo || probe_row >= rstart + ext_h - halo ||
       probe_col < cstart + (two_d ? halo : 0) ||
       probe_col >= cstart + ext_w - (two_d ? halo : 0))) {
    return (int)cudaErrorInvalidValue;
  }
  BlockPlanes<Body::kPlanes> in, out;
  for (int k = 0; k < Body::kPlanes; ++k) {
    in.p[k] = static_cast<float*>(planes_in[k]);
    out.p[k] = static_cast<float*>(planes_out[k]);
    if ((in.p[k] == nullptr) != (out.p[k] == nullptr) ||
        (in.p[k] == nullptr && !fibtorch::nullable<Body>(k))) {
      return (int)cudaErrorInvalidValue;
    }
    if (in.p[k] == nullptr) continue;
    if (in.p[k] == v_out || out.p[k] == v_in || out.p[k] == v_out) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if constexpr (GEOM) {
    geo.rstart = rstart;
    geo.cstart = cstart;
    geo.pitch = ext_w;
    if (!fibtorch::maps_apart(geo, v_out, planes_out, Body::kPlanes)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const dim3 block(32, 8);
  const dim3 grid((c_hi - c_lo + block.x - 1) / block.x,
                  (r_hi - r_lo + block.y - 1) / block.y);
  if (r_hi <= r_lo || c_hi <= c_lo || grid.y > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  typename Body::Params p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pr = probe_row - rstart;
  const int pc = probe_col - cstart;
  if (slow) {
    large_block_kernel<Body, true, GEOM><<<grid, block, 0, s>>>(
        p, v_in, v_out, in, out, ext_w, rstart, cstart, height, width, r_lo,
        c_lo, r_hi - r_lo, c_hi - c_lo, copy_all, probe, pr, pc, probe_index,
        geo);
  } else {
    large_block_kernel<Body, false, GEOM><<<grid, block, 0, s>>>(
        p, v_in, v_out, in, out, ext_w, rstart, cstart, height, width, r_lo,
        c_lo, r_hi - r_lo, c_hi - c_lo, copy_all, probe, pr, pc, probe_index,
        geo);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Per body <m> (court, court_ultra; lr1, tp06):
//   <m>_block_param_floats()  floats the host passes as `params`;
//   <m>_block_planes()        per-cell planes besides the potential;
//   <m>_block(...)            launch one commit (form `slow`) on the
//     ext_h x ext_w extended block whose element (0, 0) is global cell
//     (rstart, cstart) of a height x width domain, after `shrink`
//     substeps of the outer step, on `stream` of device `device`; return
//     cudaGetLastError().  The block carries `halo` ghost rows on each
//     side and, when `two_d`, `halo` ghost columns; otherwise ext_w ==
//     width and cstart == 0.  `planes_in` / `planes_out` are host arrays of
//     `n_planes` device pointers in the body's Plane order, of the
//     extended layout (equal arrays update in place; with `copy_all` the
//     planes the form does not commit are copied from in to out); a
//     nullable plane is null in both or in neither.  V goes from `v_in`
//     to `v_out` (null exactly for a form that keeps the potential), which
//     alias neither each other nor a plane.  `probe` may be null;
//     otherwise the shard must own the global pixel (probe_row,
//     probe_col), whose normalised new potential goes to
//     probe[probe_index];
//   <m>_block_geom(...)       the same under a geometry (geometry.cuh):
//     `phase` and `dmap` are null or the shard's maps extended like the
//     block, and with `tensor` the operator is the fiber tensor's (dxx,
//     dxy, dyy).
#define LARGE_BLOCK_ENTRIES(m, Body)                                        \
  int m##_block_param_floats() { return fibtorch::param_floats<Body>(); }   \
  int m##_block_planes() { return Body::kPlanes; }                          \
  int m##_block(int slow, const float* params, int n_params,                \
                const float* v_in, float* v_out, void* const* planes_in,    \
                void* const* planes_out, int n_planes, int ext_h,           \
                int ext_w, int rstart, int cstart, int halo, int two_d,     \
                int height, int width, int shrink, int copy_all,            \
                float* probe, int probe_row, int probe_col,                 \
                long long probe_index, int device, void* stream) {          \
    return launch_large_block<Body, false>(                                 \
        slow, params, n_params, v_in, v_out, planes_in, planes_out,         \
        n_planes, ext_h, ext_w, rstart, cstart, halo, two_d, height, width, \
        shrink, copy_all, probe, probe_row, probe_col, probe_index, device, \
        stream, fibtorch::NoGeometry{});                                    \
  }                                                                         \
  int m##_block_geom(int slow, const float* params, int n_params,           \
                     const float* v_in, float* v_out,                       \
                     void* const* planes_in, void* const* planes_out,       \
                     int n_planes, int ext_h, int ext_w, int rstart,        \
                     int cstart, int halo, int two_d, int height,           \
                     int width, int shrink, int copy_all, float* probe,     \
                     int probe_row, int probe_col, long long probe_index,   \
                     int device, void* stream, const float* phase,          \
                     const float* dmap, int tensor, float dxx, float dxy,   \
                     float dyy) {                                           \
    const fibtorch::Geometry geo = {phase, dmap, 0, 0, 0,                  \
                                    tensor, dxx, dxy, dyy};                 \
    return launch_large_block<Body, true>(                                  \
        slow, params, n_params, v_in, v_out, planes_in, planes_out,         \
        n_planes, ext_h, ext_w, rstart, cstart, halo, two_d, height, width, \
        shrink, copy_all, probe, probe_row, probe_col, probe_index, device, \
        stream, geo);                                                       \
  }

// Two libraries of this source, each with the rounding flag of its bodies'
// kernel-1 library: the Courtemanche bodies (-DFIBTORCH_COURT_ENTRIES) and
// Luo-Rudy's and tp06's (-DFIBTORCH_LRTP_ENTRIES).
extern "C" {
#if defined(FIBTORCH_COURT_ENTRIES)
LARGE_BLOCK_ENTRIES(court, fibtorch::CourtCell<false>)
LARGE_BLOCK_ENTRIES(court_ultra, fibtorch::CourtCell<true>)
#elif defined(FIBTORCH_LRTP_ENTRIES)
LARGE_BLOCK_ENTRIES(lr1, fibtorch::Lr1Cell)
LARGE_BLOCK_ENTRIES(tp06, fibtorch::Tp06Cell)
#endif
}  // extern "C"
