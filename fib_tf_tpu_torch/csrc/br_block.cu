// One whole outer step (all its substeps) of ONE shard's halo-extended
// block per launch on Hopper (sm_90a): the per-shard compute of the
// wide-halo sharded path (fib_tf_tpu_torch/parallel/spmd.py).  The file
// keeps its first model's name; it hosts every cell body, one extern "C"
// entry each: br_block (Beeler-Reuter's main path, K = 5 ghost rows),
// br_variant_block and br_variant_ab2_block (BR's other variants),
// fenton_block, fenton_ab2_block and ms_block (Fenton and
// Mitchell-Schaeffer, K = 10: a 512-row shard of 2048^2 is a 532-row
// block), each on its body's tile shape (br_tiled.cu).
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_tiled.py::make_block_kernel,
// which holds a shard's whole extended block in VMEM for the fused substep
// group.  No SM holds such a block, so this is the tiled outer-step kernel
// (br_tiled.cu) on other arrays: the tile skeleton of br_tile.cuh with
//   * the planes being the shard's block extended by `halo` ghost rows on
//     each side (and `halo` ghost columns on a 2D mesh), whose element
//     (0, 0) is the global cell (rstart, cstart);
//   * the window being the shard's own cells, rows [rstart + halo,
//     rstart + ext_h - halo): each tile's halo is read from the ghosts,
//     never from outside the array (n_sub <= halo);
//   * the clamp running against the DOMAIN's height and width, so only a
//     shard that owns a domain edge reflects there (the TPU kernel's
//     global-index masks from the runtime rstart / cstart,
//     block_geometry in ops/pallas_tiled.py).  Ghost rows beyond the domain
//     (the first shard's top ghosts, the last one's bottom ghosts) are never
//     read.
// On a 1D mesh the block spans the full width: cstart = 0, no ghost
// columns, pitch = the domain's width.
//
// Geometry: each entry's GEOM form, <m>_block_geom, replaces
// make_block_kernel(has_phase=, fiber=, has_dmap=): the operator of
// geometry.cuh, the shard's phase field and diffusion map extended like
// its block (parallel/spmd.py builds them once) and read through the
// read-only path; only the domain's edges reflect them.  On the tile
// shapes of br_tiled.cu's GEOM entries.
//
// Memory: inputs and outputs are two extended buffers of the same layout;
// the kernel writes only the window (the centre) of the output, which fuses
// the reference's crop and leaves the halo exchange to fill the output's
// ghosts for the next step.
//
// What bounds it: the bytes of the extended block read once and of the
// centre written once (BR: 8 planes each, 20.2 us for a 522x2048 block at
// 3.35 TB/s; Fenton 4 planes, MS 2), but as for br_tiled.cu (whose note
// says what was measured) BR's cell body's instructions in the rings bind.
// For BR a 512-row shard of 2048^2 is cut into 10 x 38 = 380 equal tiles
// (52 or 51 rows, 54 or 53 columns), 2.88 for each of 132 persistent
// blocks (Fenton and MS: 12 x 47 = 564 tiles of 43-44, 4.27 a block): the
// blocks with three
// tiles set the time, three tiles of compute plus the first tile's load,
// which nothing overlaps.  Measured on an NVIDIA H100 80GB HBM3 at a
// 700 W limit: 79.7-80.4 us, against 98.9-100.0 us for the previous
// skeleton (tools/torch_tile_bench.py, PERF.md).
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

// Launch one outer step of body `Body` on one block, on BX x BY-thread
// tiles of BY * RY rows (see the entries below); with GEOM, under the
// geometry `geo`, whose maps have the block's layout.
template <class Body, int BX, int BY, int RY, bool GEOM>
int launch_block(const float* params, int n_params, const float* v_in,
                 float* v_out, void* const* planes_in,
                 void* const* planes_out, int n_planes, int ext_h, int ext_w,
                 int rstart, int cstart, int halo, int two_d, int height,
                 int width, int n_sub, unsigned slow_mask, float* probe,
                 int probe_row, int probe_col, long long probe_index,
                 int device, void* stream,
                 fibtorch::GeometryArg<GEOM> geo) {
  if (n_params != fibtorch::param_floats<Body>() ||
      n_planes != Body::kPlanes || height < 3 || width < 3 || n_sub < 1 ||
      n_sub > 32 || halo < n_sub || ext_h <= 2 * halo) {
    return (int)cudaErrorInvalidValue;
  }
  fibtorch::Window win;
  win.rstart = rstart;
  win.cstart = cstart;
  win.pitch = ext_w;
  win.row0 = rstart + halo;
  win.row1 = rstart + ext_h - halo;
  if (two_d) {
    if (ext_w <= 2 * halo) return (int)cudaErrorInvalidValue;
    win.col0 = cstart + halo;
    win.col1 = cstart + ext_w - halo;
  } else {
    if (cstart != 0 || ext_w != width) return (int)cudaErrorInvalidValue;
    win.col0 = 0;
    win.col1 = width;
  }
  if (probe != nullptr &&
      (probe_row < win.row0 || probe_row >= win.row1 ||
       probe_col < win.col0 || probe_col >= win.col1)) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (GEOM) {
    geo.rstart = rstart;
    geo.cstart = cstart;
    geo.pitch = ext_w;
  }
  // launch_tiles refuses a window that leaves the domain
  return (int)fibtorch::launch_tiles<Body, BX, BY, RY, GEOM>(
      p, v_in, v_out, planes, win, height, width, n_sub, slow_mask, probe,
      probe_row, probe_col, probe_index, device, s, geo);
}

}  // namespace

// Per body <m> (br, br_variant, br_variant_ab2, fenton, fenton_ab2, ms),
// on the tile shape of its br_tiled.cu entry:
//   <m>_block_param_floats()  floats the host passes as `params`;
//   <m>_block_planes()        per-cell planes besides the potential;
//   <m>_block_tile_shape(...) the tile shape (BX, BY, RY);
//   <m>_block(...)            launch one outer step of `n_sub` substeps on
//     the ext_h x ext_w extended block whose element (0, 0) is global cell
//     (rstart, cstart) of a height x width domain, on `stream` of device
//     `device`; return cudaGetLastError().  The block carries `halo` ghost
//     rows on each side and, when `two_d`, `halo` ghost columns; otherwise
//     ext_w == width and cstart == 0.  `planes_in` / `planes_out` are host
//     arrays of `n_planes` device pointers in the body's Plane order, all
//     of the extended layout; only the centre of the outputs is written.
//     No output may alias an input.  `probe` may be null; otherwise the
//     shard must own the global pixel (probe_row, probe_col).
#define BLOCK_ENTRIES(m, Body, BX, BY, RY)                                  \
  int m##_block_param_floats() { return fibtorch::param_floats<Body>(); }   \
  int m##_block_planes() { return Body::kPlanes; }                          \
  void m##_block_tile_shape(int* threads_x, int* threads_y,                 \
                            int* rows_per_thread) {                         \
    *threads_x = BX;                                                        \
    *threads_y = BY;                                                        \
    *rows_per_thread = RY;                                                  \
  }                                                                         \
  int m##_block(const float* params, int n_params, const float* v_in,       \
                float* v_out, void* const* planes_in,                       \
                void* const* planes_out, int n_planes, int ext_h,           \
                int ext_w, int rstart, int cstart, int halo, int two_d,     \
                int height, int width, int n_sub, unsigned slow_mask,       \
                float* probe, int probe_row, int probe_col,                 \
                long long probe_index, int device, void* stream) {          \
    return launch_block<Body, BX, BY, RY, false>(                           \
        params, n_params, v_in, v_out, planes_in, planes_out, n_planes,     \
        ext_h, ext_w, rstart, cstart, halo, two_d, height, width, n_sub,    \
        slow_mask, probe, probe_row, probe_col, probe_index, device,        \
        stream, fibtorch::NoGeometry{});                                    \
  }

// The GEOM entries <m>_block_geom_param_floats, _planes, _tile_shape and
// <m>_block_geom: the same as <m>_block's under a geometry (geometry.cuh),
// on the tile shapes of br_tiled.cu's GEOM entries, with six more
// arguments: `phase` and `dmap`, null or the shard's maps extended like
// the block (its layout), and with `tensor` the fiber tensor's (dxx, dxy,
// dyy).
#define BLOCK_GEOM_ENTRIES(m, Body, BX, BY, RY)                             \
  int m##_block_geom_param_floats() {                                       \
    return fibtorch::param_floats<Body>();                                  \
  }                                                                         \
  int m##_block_geom_planes() { return Body::kPlanes; }                     \
  void m##_block_geom_tile_shape(int* threads_x, int* threads_y,            \
                                 int* rows_per_thread) {                    \
    *threads_x = BX;                                                        \
    *threads_y = BY;                                                        \
    *rows_per_thread = RY;                                                  \
  }                                                                         \
  int m##_block_geom(const float* params, int n_params, const float* v_in,  \
                     float* v_out, void* const* planes_in,                  \
                     void* const* planes_out, int n_planes, int ext_h,      \
                     int ext_w, int rstart, int cstart, int halo,           \
                     int two_d, int height, int width, int n_sub,           \
                     unsigned slow_mask, float* probe, int probe_row,       \
                     int probe_col, long long probe_index, int device,      \
                     void* stream, const float* phase, const float* dmap,   \
                     int tensor, float dxx, float dxy, float dyy) {         \
    const fibtorch::Geometry geo = {phase, dmap, 0, 0, 0,                  \
                                    tensor, dxx, dxy, dyy};                 \
    return launch_block<Body, BX, BY, RY, true>(                            \
        params, n_params, v_in, v_out, planes_in, planes_out, n_planes,     \
        ext_h, ext_w, rstart, cstart, halo, two_d, height, width, n_sub,    \
        slow_mask, probe, probe_row, probe_col, probe_index, device,        \
        stream, geo);                                                       \
  }

// As br_tiled.cu: the isotropic entries, or with FIBTORCH_GEOM_ENTRIES
// defined the GEOM entries, two libraries built side by side.
#ifndef FIBTORCH_GEOM_ENTRIES
extern "C" {
BLOCK_ENTRIES(br, fibtorch::BeelerReuterCell, 64, 16, 4)
BLOCK_ENTRIES(br_variant, fibtorch::BrVariantCell<false>, 64, 8, 8)
BLOCK_ENTRIES(br_variant_ab2, fibtorch::BrVariantCell<true>, 64, 8, 8)
BLOCK_ENTRIES(fenton, fibtorch::FentonCell, 64, 16, 4)
BLOCK_ENTRIES(fenton_ab2, fibtorch::FentonAb2Cell, 64, 16, 4)
BLOCK_ENTRIES(ms, fibtorch::MsCell, 64, 16, 4)
}  // extern "C"
#else
extern "C" {
BLOCK_GEOM_ENTRIES(br, fibtorch::BeelerReuterCell, 64, 8, 8)
BLOCK_GEOM_ENTRIES(br_variant, fibtorch::BrVariantCell<false>, 64, 8, 8)
BLOCK_GEOM_ENTRIES(br_variant_ab2, fibtorch::BrVariantCell<true>, 64, 8, 8)
BLOCK_GEOM_ENTRIES(fenton, fibtorch::FentonCell, 64, 16, 4)
BLOCK_GEOM_ENTRIES(fenton_ab2, fibtorch::FentonAb2Cell, 64, 16, 4)
BLOCK_GEOM_ENTRIES(ms, fibtorch::MsCell, 64, 16, 4)
}  // extern "C"
#endif
