// One whole outer step (all its substeps) of a grid per launch on Hopper
// (sm_90a): 2D tiles, temporally blocked, with a halo of one ring per
// substep.  The file keeps its first model's name; it hosts every cell body,
// one extern "C" entry each: br_tiled (Beeler-Reuter's main path, five
// substeps), br_variant_tiled and br_variant_ab2_tiled (BR's other
// variants), fenton_tiled, fenton_ab2_tiled and ms_tiled (Fenton and
// Mitchell-Schaeffer, ten substeps: a 44 x 44 interior per 64 x 64 tile).
// Each entry fixes its tile shape: BR's main body and Fenton's and
// Mitchell-Schaeffer's (ab2 too) run 1024 threads, 64 registers a thread
// (64 x 16 x 4); BrVariantCell, whose runtime modes keep every form's
// registers live, spills there (12 bytes at 64 registers, measured with
// -Xptxas -v), so its entries run 512 threads, which may take 128
// registers each (64 x 8 x 8; nine planes with ab2 use all 128, no
// spills).
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_tiled.py::
// make_tiled_pallas_step, which the JAX engine runs for Beeler-Reuter once
// the state passes WHOLE_GRID_STATE_MB_MAX = 32 MB (any BR grid over 1024^2).
// It computes the same function as an outer step of launches of
// br_substep.cu, and the per-cell arithmetic is the same code (the
// cell-body headers).
//
// The tile skeleton (what a block loads, computes and writes, the boundary
// on global indices, the memory rules and the schedule) is br_tile.cuh,
// shared with br_block.cu; here the window is the whole height x width
// domain and the planes are the grid's own arrays.  Any H, W >= 3 runs.
//
// Geometry: each entry's GEOM form, <m>_tiled_geom, replaces
// make_tiled_pallas_step with `phase`, `fiber` and `dmap`
// (block_geometry, pallas_tiled.py:60-175): the operator of geometry.cuh,
// the height x width maps read through the read-only path (one more
// plane of bytes each per launch, and about ten loads and the reflect
// arithmetic per cell-substep in the instruction-bound tiles).  BR's main
// body spills 4 bytes at 64 registers with it, so its GEOM entry runs 512
// threads (64 x 8 x 8).
//
// What bounds it.  Per outer step it reads the state once and writes it
// once: for BR 8 planes each way, 268 MB at 2048^2 float32 (80 us at 3.35
// TB/s), plus the halo overfetch (64^2 loaded per 54^2 written, mostly
// served by L2); for Fenton 4 planes (134 MB, 40 us) and Mitchell-Schaeffer
// 2 (67 MB, 20 us), with 64^2 loaded per 44^2 written.  An outer step of
// br_substep.cu launches moves 5-10 times as much.  The price is redundant
// compute in the rings, and for BR that is what binds: measured on
// an NVIDIA H100 80GB HBM3 at a 700 W limit (tools/torch_tile_bench.py,
// PERF.md), the skeleton runs at the SM clock's 1980 MHz, 64 registers a
// thread and no spills, and a variant with no copies and no stores took
// 234-240 us of the kernel's 265-268 us at 2048^2: the cell body's
// instructions on 1024 threads that meet at a barrier after every
// substep, issued at about two thirds of the SMs' peak rate.  In SASS the
// clamp-free body is 174.5 instructions a frozen and 303 a SLOW
// cell-substep (the form's code over its rows, the last substep's stores
// left out; 1.27 lane-substeps per useful cell-substep), 4 and 8 of them
// LDC, loads of a coefficient into every thread's registers; with
// BrParams laid out for that (br_cell.cuh) the kernel takes 255-258 us,
// where 7 and 15 LDC took 265-268.  The copies of the next tile, spread
// over the substeps, add about 16-30 us; the stores, issued from the last
// substep, add nothing measurable.  The previous, non-persistent skeleton
// (one tile per block, load, compute, store in turn, clamps on every
// cell) took 327-331 us.
//
// Built by fib_tf_tpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface (no --use_fast_math: logf feeds e_Ca).

// The GEOM entries' BR reads its fits from BrParams::rows (br_cell.cuh)
#ifdef FIBTORCH_GEOM_ENTRIES
#define FIBTORCH_BR_FIT_ROWS
#endif

#include <cuda_runtime.h>
#include <string.h>

#include "br_cell.cuh"
#include "br_tile.cuh"
#include "br_variant_cell.cuh"
#include "fenton_cell.cuh"
#include "geometry.cuh"
#include "ms_cell.cuh"

namespace {

// Launch one outer step of body `Body` on BX x BY-thread tiles of BY * RY
// rows (see the entries below); with GEOM, under the geometry `geo`.
template <class Body, int BX, int BY, int RY, bool GEOM>
int launch_tiled(const float* params, int n_params, const float* v_in,
                 float* v_out, void* const* planes_in,
                 void* const* planes_out, int n_planes, int height, int width,
                 int n_sub, unsigned slow_mask, float* probe, int probe_row,
                 int probe_col, long long probe_index, int device,
                 void* stream, const fibtorch::GeometryArg<GEOM>& geo) {
  if (n_params != fibtorch::param_floats<Body>() ||
      n_planes != Body::kPlanes || height < 3 || width < 3 || n_sub < 1 ||
      n_sub > 32) {
    return (int)cudaErrorInvalidValue;
  }
  fibtorch::Planes<Body::kPlanes> planes;
  if (!fibtorch::gather_planes(v_in, v_out, planes_in, planes_out,
                               &planes)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  typename Body::Params p;
  memcpy(&p, params, sizeof(p));
  // the whole grid: the arrays start at cell (0, 0) and the window is the
  // domain
  const fibtorch::Window win = {0, 0, width, 0, height, 0, width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)fibtorch::launch_tiles<Body, BX, BY, RY, GEOM>(
      p, v_in, v_out, planes, win, height, width, n_sub, slow_mask, probe,
      probe_row, probe_col, probe_index, device, s, geo);
}

}  // namespace

extern "C" {

// How a window axis of `len` cells is cut into tiles of at most `max_tile`
// (fibtorch::split_axis): `n` tiles, the first `rem` of `base + 1` cells,
// the others of `base`.
void br_tiled_split(int len, int max_tile, int* n, int* base, int* rem) {
  const fibtorch::Split s = fibtorch::split_axis(len, max_tile);
  *n = s.n;
  *base = s.base;
  *rem = s.rem;
}

}  // extern "C"

// Per body <m> (br, br_variant, br_variant_ab2, fenton, fenton_ab2, ms),
// with its tile of BX x BY threads, each owning RY rows of one column:
//   <m>_tiled_param_floats()  floats the host passes as `params`;
//   <m>_tiled_planes()        per-cell planes besides the potential;
//   <m>_tiled_tile_shape(...) the tile shape (BX, BY, RY);
//   <m>_tiled(...)            launch one outer step of `n_sub` substeps on
//     `stream` of device `device` and return cudaGetLastError().
//     `planes_in` / `planes_out` are host arrays of `n_planes` device
//     pointers in the body's Plane order.  No output may alias an input.
//     `probe` may be null.
#define TILED_ENTRIES(m, Body, BX, BY, RY)                                  \
  int m##_tiled_param_floats() { return fibtorch::param_floats<Body>(); }   \
  int m##_tiled_planes() { return Body::kPlanes; }                          \
  void m##_tiled_tile_shape(int* threads_x, int* threads_y,                 \
                            int* rows_per_thread) {                         \
    *threads_x = BX;                                                        \
    *threads_y = BY;                                                        \
    *rows_per_thread = RY;                                                  \
  }                                                                         \
  int m##_tiled(const float* params, int n_params, const float* v_in,       \
                float* v_out, void* const* planes_in,                       \
                void* const* planes_out, int n_planes, int height,          \
                int width, int n_sub, unsigned slow_mask, float* probe,     \
                int probe_row, int probe_col, long long probe_index,        \
                int device, void* stream) {                                 \
    return launch_tiled<Body, BX, BY, RY, false>(                           \
        params, n_params, v_in, v_out, planes_in, planes_out, n_planes,     \
        height, width, n_sub, slow_mask, probe, probe_row, probe_col,       \
        probe_index, device, stream, fibtorch::NoGeometry{});               \
  }

// The GEOM entries <m>_tiled_geom_param_floats, _planes, _tile_shape and
// <m>_tiled_geom: the same as <m>_tiled's under a geometry (geometry.cuh),
// with six more arguments: `phase` and `dmap`, height x width device
// arrays or null, and with `tensor` the fiber tensor's (dxx, dxy, dyy).
#define TILED_GEOM_ENTRIES(m, Body, BX, BY, RY)                             \
  int m##_tiled_geom_param_floats() {                                       \
    return fibtorch::param_floats<Body>();                                  \
  }                                                                         \
  int m##_tiled_geom_planes() { return Body::kPlanes; }                     \
  void m##_tiled_geom_tile_shape(int* threads_x, int* threads_y,            \
                                 int* rows_per_thread) {                    \
    *threads_x = BX;                                                        \
    *threads_y = BY;                                                        \
    *rows_per_thread = RY;                                                  \
  }                                                                         \
  int m##_tiled_geom(const float* params, int n_params, const float* v_in,  \
                     float* v_out, void* const* planes_in,                  \
                     void* const* planes_out, int n_planes, int height,     \
                     int width, int n_sub, unsigned slow_mask,              \
                     float* probe, int probe_row, int probe_col,            \
                     long long probe_index, int device, void* stream,       \
                     const float* phase, const float* dmap, int tensor,     \
                     float dxx, float dxy, float dyy) {                     \
    const fibtorch::Geometry geo = {phase, dmap, 0, 0, width,              \
                                    tensor, dxx, dxy, dyy};                 \
    return launch_tiled<Body, BX, BY, RY, true>(                            \
        params, n_params, v_in, v_out, planes_in, planes_out, n_planes,     \
        height, width, n_sub, slow_mask, probe, probe_row, probe_col,       \
        probe_index, device, stream, geo);                                  \
  }

// The source builds two libraries, the isotropic entries and, with
// FIBTORCH_GEOM_ENTRIES defined, the GEOM entries: two nvcc runs side by
// side take less time than one of both (ops/cuda_tiled.py).
#ifndef FIBTORCH_GEOM_ENTRIES
extern "C" {
TILED_ENTRIES(br, fibtorch::BeelerReuterCell, 64, 16, 4)
TILED_ENTRIES(br_variant, fibtorch::BrVariantCell<false>, 64, 8, 8)
TILED_ENTRIES(br_variant_ab2, fibtorch::BrVariantCell<true>, 64, 8, 8)
TILED_ENTRIES(fenton, fibtorch::FentonCell, 64, 16, 4)
TILED_ENTRIES(fenton_ab2, fibtorch::FentonAb2Cell, 64, 16, 4)
TILED_ENTRIES(ms, fibtorch::MsCell, 64, 16, 4)
}  // extern "C"
#else
// BR's main body spills 4 bytes at 64 registers under the geometry: its
// GEOM entry runs 512 threads
extern "C" {
TILED_GEOM_ENTRIES(br, fibtorch::BeelerReuterCell, 64, 8, 8)
TILED_GEOM_ENTRIES(br_variant, fibtorch::BrVariantCell<false>, 64, 8, 8)
TILED_GEOM_ENTRIES(br_variant_ab2, fibtorch::BrVariantCell<true>, 64, 8, 8)
TILED_GEOM_ENTRIES(fenton, fibtorch::FentonCell, 64, 16, 4)
TILED_GEOM_ENTRIES(fenton_ab2, fibtorch::FentonAb2Cell, 64, 16, 4)
TILED_GEOM_ENTRIES(ms, fibtorch::MsCell, 64, 16, 4)
}  // extern "C"
#endif
