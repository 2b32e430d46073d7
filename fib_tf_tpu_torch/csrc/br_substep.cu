// One substep of a whole grid on Hopper (sm_90a), one thread per cell, for
// each of the port's cell bodies: Beeler-Reuter's main path (br_cell.cuh),
// its other variants without and with ab2 (br_variant_cell.cuh), Fenton
// without and with ab2 (fenton_cell.cuh) and Mitchell-Schaeffer
// (ms_cell.cuh).  The file keeps its first model's name; it hosts every
// body, one extern "C" entry each (br_substep, br_variant_substep,
// br_variant_ab2_substep, fenton_substep, fenton_ab2_substep, ms_substep);
// and, as a second library of this source (-DFIBTORCH_COURT_ENTRIES
// -fmad=false), court_substep and court_ultra_substep (court_cell.cuh:
// Courtemanche's fast and slow commits, eleven launches per outer step, the
// slow commit and the nine fast commits after it in their cached forms,
// cached_substep_kernel; and Courtemanche-ultra's full commit, ten); and,
// as a third (-DFIBTORCH_LRTP_ENTRIES -fmad=false), lr1_substep and
// tp06_substep (lr1_cell.cuh, tp06_cell.cuh: Luo-Rudy 1991 and ten
// Tusscher-Panfilov 2006, one SLOW launch and nine frozen ones per outer
// step under skip, ten SLOW ones without).
//
// Replaces the TPU kernel fib_tf_tpu/ops/pallas_step.py::make_pallas_step as
// the engine launches it for Beeler-Reuter cheby+skip (one substep per
// launch), with the body of fib_tf_tpu/models/beeler_reuter.py::solve
// (cheby + cheby_fold + cheby_currents).  The template flag SLOW selects the
// body: true advances the slow gates x1/j/d/f (the n=5 substep under skip,
// every substep without skip); false freezes them (the four n=0 substeps).
// Fenton and Mitchell-Schaeffer run ten launches of their one body per
// outer step (SLOW means nothing to them); their rates take the cell's raw
// centre, v_in[row, col], beside the boundary-enforced v0.
//
// Per cell (i, j), with clamp(k) = min(max(k, 1), N-2):
//   * v0 at stencil point (i+di, j+dj) is V[clamp(i+di), clamp(j+dj)]: the
//     SYMMETRIC boundary rewrite composed with the REFLECT pad of the
//     Laplacian (ops/stencil.py enforce_boundary + laplace);
//   * lap = N + S + W + E + 0.5*(NW + SW + NE + SE) - 6*v0;
//   * x = (v0 - mid) / half, S0 = 1, S1 = x, Sk = (2x)*S(k-1), k <= 8, and
//     each fit is d0 + sum dk*Sk (ops/chebyshev.py);
//   * folded Rush-Larsen g' = clip(g + (g - g_inf)*r, 1e-5, 0.99999);
//   * the four currents, V' = clip(v0 + diff*dt*lap - dt*sum(I), -85, 25)
//     and C' = C + dt*(-1e-7*iCa + 0.07*(1e-7 - C)).
//
// Load-bearing quirks kept from the reference:
//   * the currents use the PRE-update gates (beeler_reuter.py:340-343);
//   * V is clipped to [-85, 25] every substep; the clip propagates NaN, so
//     the engine's finiteness check still sees a blow-up;
//   * the slow gates' folded fit bakes 5*dt under skip (the caller's guard
//     at beeler_reuter.py:238-246), so SLOW substeps advance them 5*dt;
//   * the S1 stimulus (column 1 at +10 mV) is part of the initial state,
//     and the kernel treats it like any other V.
//
// Memory: the potential is double-buffered.  Neighbours are read from v_in
// and the new value goes to v_out, which must not alias v_in.  The other
// planes (BR 7, Fenton 3, Mitchell-Schaeffer 1) are per-cell, so each
// thread reads and rewrites its own cell IN PLACE.
//
// What bounds it: bandwidth.  A BR SLOW substep reads 8 planes and writes 8
// (16 MB at 512x512 float32), a frozen one reads 8 and writes 4 (Fenton
// reads and writes 4, Mitchell-Schaeffer 2); the card
// moves 3.35 TB/s from HBM, and the 8 MB state also fits its 50 MB L2.  The
// arithmetic (14 degree-8 fits, one logf) is far below the FLOP roof.  This
// first design is deliberately simple: no shared-memory tile (the 9-point
// reads of V hit L1/L2), one launch per substep, no CUDA graph.  The fused
// design, five substeps per launch in shared-memory tiles with a K-ring
// halo, is br_tiled.cu, which the engine runs past its 32 MB cutover.  CUDA
// graphs over a chunk, against the host launch overhead, are later work.
//
// Geometry.  Each entry has a second form, <m>_substep_geom, the GEOM =
// true instantiation: the diffusion operator of geometry.cuh (phase field,
// diffusion map, fiber tensor) in place of laplace9, which replaces
// make_pallas_step with `phase`, `fiber` and `dmap` (pallas_step.py:205-304,
// vmem_laplace and vmem_anisotropic_laplace).  It reads phi and d at the
// cell and its four neighbours from global memory; they are static and stay
// in L1/L2, so each adds one plane of bytes per launch.  GEOM = false is
// the isotropic kernel unchanged.
//
// The per-cell arithmetic lives in the cell-body headers, shared with the
// other kernels.
//
// Built by fib_tf_tpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface (no --use_fast_math: logf feeds e_Ca).

// BR reads its fits from BrParams::rows (br_cell.cuh)
#define FIBTORCH_BR_FIT_ROWS

#include <cuda_runtime.h>
#include <string.h>

#include "br_cell.cuh"
#include "br_variant_cell.cuh"
#include "cell_traits.cuh"
#include "court_cell.cuh"
#include "fenton_cell.cuh"
#include "geometry.cuh"
#include "lr1_cell.cuh"
#include "ms_cell.cuh"
#include "torch_rounding.cuh"
#include "tp06_cell.cuh"

namespace {

using fibtorch::clamp_index;
using fibtorch::laplace9;

// The per-cell planes besides the potential, in Body::Plane order.
template <int N>
struct CellPlanes {
  float* p[N];
};

// One cell of one launch.  With CACHED (a body with a cache,
// cell_traits.cuh kCachePlanes), `cache` is its planes: the SLOW form
// stores them, the other reads them.
template <class Body, bool SLOW, bool GEOM, bool CACHED>
__device__ __forceinline__ void substep_cell(
    const typename Body::Params& p, const float* __restrict__ v_in,
    float* __restrict__ v_out, float* const* planes, int height, int width,
    float* __restrict__ probe, int probe_row, int probe_col,
    long long probe_index, const fibtorch::GeometryArg<GEOM>& geo,
    float* const* cache) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= height || col >= width) return;

  const int rn = clamp_index(row - 1, height) * width;
  const int rc = clamp_index(row, height) * width;
  const int rs = clamp_index(row + 1, height) * width;
  const int cw = clamp_index(col - 1, width);
  const int cc = clamp_index(col, width);
  const int ce = clamp_index(col + 1, width);

  const float v0 = v_in[rc + cc];
  // a form that keeps the potential (cell_traits.cuh) needs no Laplacian
  float lap = 0.0f;
  if constexpr (fibtorch::writes_potential<Body, SLOW>()) {
    if constexpr (GEOM) {
      lap = fibtorch::geometry_laplace(
          geo, row, col, height, width, v_in[rn + cc], v_in[rs + cc],
          v_in[rc + cw], v_in[rc + ce], v_in[rn + cw], v_in[rs + cw],
          v_in[rn + ce], v_in[rs + ce], v0);
    } else {
      lap = laplace9(v_in[rn + cc], v_in[rs + cc], v_in[rc + cw],
                     v_in[rc + ce], v_in[rn + cw], v_in[rs + cw],
                     v_in[rn + ce], v_in[rs + ce], v0);
    }
  }

  const long long idx = (long long)row * width + col;
  float q[Body::kPlanes];
  fibtorch::load_planes<Body>(planes, idx, q);
  float v1;
  if constexpr (CACHED) {
    constexpr int kCache = fibtorch::cache_planes<Body>();
    float c[kCache];
    if constexpr (!SLOW) {
#pragma unroll
      for (int k = 0; k < kCache; ++k) c[k] = cache[k][idx];
    }
    v1 = Body::template update<SLOW, true>(p, v0, v_in[idx], lap, q, c);
    if constexpr (SLOW) {
#pragma unroll
      for (int k = 0; k < kCache; ++k) cache[k][idx] = c[k];
    }
  } else {
    v1 = Body::template update<SLOW>(p, v0, v_in[idx], lap, q);
  }
  if constexpr (fibtorch::writes_potential<Body, SLOW>()) v_out[idx] = v1;
#pragma unroll
  for (int k = 0; k < Body::kPlanes; ++k) {
    if (Body::template stores<SLOW>(k)) planes[k][idx] = q[k];
  }
  if (probe != nullptr && row == probe_row && col == probe_col) {
    probe[probe_index] = Body::probe(p, v1);
  }
}

template <class Body, bool SLOW, bool GEOM>
__global__ void substep_kernel(const typename Body::Params p,
                               const float* __restrict__ v_in,
                               float* __restrict__ v_out,
                               const CellPlanes<Body::kPlanes> planes,
                               int height, int width,
                               float* __restrict__ probe, int probe_row,
                               int probe_col, long long probe_index,
                               const fibtorch::GeometryArg<GEOM> geo) {
  substep_cell<Body, SLOW, GEOM, false>(p, v_in, v_out, planes.p, height,
                                        width, probe, probe_row, probe_col,
                                        probe_index, geo, nullptr);
}

// The threads of a block of every entry below.
constexpr int kBlockX = 32, kBlockY = 8;

// The cached forms of a body with a cache.  A fast commit that reads it is
// held to five blocks an SM (48 registers), as its uncached form compiles:
// at 49 registers it held four and ran slower than that form (PERF.md §6).
// The slow commit keeps the four blocks its uncached form holds.
template <class Body, bool SLOW, bool GEOM>
__global__ void __launch_bounds__(kBlockX * kBlockY, SLOW ? 4 : 5)
    cached_substep_kernel(const typename Body::Params p,
                          const float* __restrict__ v_in,
                          float* __restrict__ v_out,
                          const CellPlanes<Body::kPlanes> planes, int height,
                          int width, float* __restrict__ probe,
                          int probe_row, int probe_col, long long probe_index,
                          const fibtorch::GeometryArg<GEOM> geo,
                          const CellPlanes<fibtorch::cache_planes<Body>()>
                              cache) {
  substep_cell<Body, SLOW, GEOM, true>(p, v_in, v_out, planes.p, height,
                                       width, probe, probe_row, probe_col,
                                       probe_index, geo, cache.p);
}

// Launch one substep of body `Body` (see the entries below); with GEOM,
// under the geometry `geo`, whose maps no output may alias.  `form` is the
// flag SLOW (bit 0), plus 2 for a cached form of a body with a cache, whose
// planes then follow the body's in `planes`; such a body's slow commit is
// always the cached form, the one that stores the cache.
template <class Body, bool GEOM>
int launch_substep(int form, const float* params, int n_params,
                   const float* v_in, float* v_out, void* const* planes,
                   int n_planes, int height, int width, float* probe,
                   int probe_row, int probe_col, long long probe_index,
                   int device, void* stream,
                   const fibtorch::GeometryArg<GEOM>& geo) {
  constexpr int kCache = fibtorch::cache_planes<Body>();
  const bool slow = (form & 1) != 0;
  const bool cached = form >= 2;
  // a body with a cache stores it in every slow commit: it has no form 1
  if (form < 0 || form > 3 || (cached && kCache == 0) ||
      (slow && !cached && kCache > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  // v_out is null exactly for a form that keeps the potential
  const bool writes = slow ? fibtorch::writes_potential<Body, true>()
                           : fibtorch::writes_potential<Body, false>();
  if (n_params != fibtorch::param_floats<Body>() ||
      n_planes != Body::kPlanes + (cached ? kCache : 0) || height < 3 ||
      width < 3 || v_in == v_out || writes != (v_out != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  CellPlanes<Body::kPlanes> pl;
  for (int k = 0; k < n_planes; ++k) {
    float* plane = static_cast<float*>(planes[k]);
    if ((plane == nullptr &&
         (k >= Body::kPlanes || !fibtorch::nullable<Body>(k))) ||
        plane == v_in || (plane != nullptr && plane == v_out)) {
      return (int)cudaErrorInvalidValue;
    }
    if (k < Body::kPlanes) pl.p[k] = plane;
  }
  if constexpr (GEOM) {
    if (!fibtorch::maps_apart(geo, v_out, planes, n_planes)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  typename Body::Params p;
  memcpy(&p, params, sizeof(p));
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kCache > 0) {
    if (cached) {
      CellPlanes<kCache> cache;
      for (int k = 0; k < kCache; ++k) {
        cache.p[k] = static_cast<float*>(planes[Body::kPlanes + k]);
      }
      if (slow) {
        cached_substep_kernel<Body, true, GEOM><<<grid, block, 0, s>>>(
            p, v_in, v_out, pl, height, width, probe, probe_row, probe_col,
            probe_index, geo, cache);
      } else {
        cached_substep_kernel<Body, false, GEOM><<<grid, block, 0, s>>>(
            p, v_in, v_out, pl, height, width, probe, probe_row, probe_col,
            probe_index, geo, cache);
      }
    } else {
      substep_kernel<Body, false, GEOM><<<grid, block, 0, s>>>(
          p, v_in, v_out, pl, height, width, probe, probe_row, probe_col,
          probe_index, geo);
    }
  } else if (slow) {
    substep_kernel<Body, true, GEOM><<<grid, block, 0, s>>>(
        p, v_in, v_out, pl, height, width, probe, probe_row, probe_col,
        probe_index, geo);
  } else {
    substep_kernel<Body, false, GEOM><<<grid, block, 0, s>>>(
        p, v_in, v_out, pl, height, width, probe, probe_row, probe_col,
        probe_index, geo);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Per body <m> (br, br_variant, br_variant_ab2, fenton, fenton_ab2, ms):
//   <m>_substep_param_floats()  floats the host passes as `params`;
//   <m>_substep_planes()        per-cell planes besides the potential;
//   <m>_substep_cache_planes()  planes of the body's cache (0: none);
//   <m>_substep(...)            launch one substep on `stream` of device
//     `device` and return cudaGetLastError().  `form` is 0 (SLOW = false)
//     or 1 (SLOW = true); for a body with a cache 0 (a fast commit that
//     computes its terms from the planes), 2 (a fast commit that reads the
//     cache) or 3 (the slow commit, which stores it).
//     `params` is a host array of <m>_substep_param_floats() floats,
//     copied into the kernel's by-value argument; `planes` a host array of
//     <m>_substep_planes() device pointers in the body's Plane order
//     (cuda_step's plane tuples), updated in place, then for forms 2-3 the
//     <m>_substep_cache_planes() planes of the cache.  The new potential
//     goes to `v_out`, which must not alias `v_in`.  `probe` may be null;
//     otherwise the thread at (probe_row, probe_col) writes the normalised
//     new potential to probe[probe_index];
//   <m>_substep_geom(...)       the same under a geometry (geometry.cuh):
//     `phase` and `dmap` are height x width device arrays or null, and
//     with `tensor` the operator is the fiber tensor's (dxx, dxy, dyy).
#define SUBSTEP_ENTRIES(m, Body)                                            \
  int m##_substep_param_floats() { return fibtorch::param_floats<Body>(); } \
  int m##_substep_planes() { return Body::kPlanes; }                        \
  int m##_substep_cache_planes() {                                          \
    return fibtorch::cache_planes<Body>();                                  \
  }                                                                         \
  int m##_substep(int form, const float* params, int n_params,              \
                  const float* v_in, float* v_out, void* const* planes,     \
                  int n_planes, int height, int width, float* probe,        \
                  int probe_row, int probe_col, long long probe_index,      \
                  int device, void* stream) {                               \
    return launch_substep<Body, false>(                                     \
        form, params, n_params, v_in, v_out, planes, n_planes, height,      \
        width, probe, probe_row, probe_col, probe_index, device, stream,    \
        fibtorch::NoGeometry{});                                            \
  }                                                                         \
  int m##_substep_geom(int form, const float* params, int n_params,         \
                       const float* v_in, float* v_out,                     \
                       void* const* planes, int n_planes, int height,       \
                       int width, float* probe, int probe_row,              \
                       int probe_col, long long probe_index, int device,    \
                       void* stream, const float* phase, const float* dmap, \
                       int tensor, float dxx, float dxy, float dyy) {       \
    const fibtorch::Geometry geo = {phase, dmap, 0, 0, width,              \
                                    tensor, dxx, dxy, dyy};                 \
    return launch_substep<Body, true>(                                      \
        form, params, n_params, v_in, v_out, planes, n_planes, height,      \
        width, probe, probe_row, probe_col, probe_index, device, stream,    \
        geo);                                                               \
  }

// The Courtemanche bodies build as a library of their own, this source with
// -DFIBTORCH_COURT_ENTRIES (court_substep[_geom], court_ultra_substep[_geom]),
// so that nvcc compiles them beside the rest, and with -fmad=false
// (court_cell.cuh's rounding); Luo-Rudy's and tp06's as a third, with
// -DFIBTORCH_LRTP_ENTRIES (lr1_substep[_geom], tp06_substep[_geom]) and the
// same flag.
extern "C" {
#if defined(FIBTORCH_COURT_ENTRIES)
SUBSTEP_ENTRIES(court, fibtorch::CourtCell<false>)
SUBSTEP_ENTRIES(court_ultra, fibtorch::CourtCell<true>)
#elif defined(FIBTORCH_LRTP_ENTRIES)
SUBSTEP_ENTRIES(lr1, fibtorch::Lr1Cell)
SUBSTEP_ENTRIES(tp06, fibtorch::Tp06Cell)
#else
SUBSTEP_ENTRIES(br, fibtorch::BeelerReuterCell)
SUBSTEP_ENTRIES(br_variant, fibtorch::BrVariantCell<false>)
SUBSTEP_ENTRIES(br_variant_ab2, fibtorch::BrVariantCell<true>)
SUBSTEP_ENTRIES(fenton, fibtorch::FentonCell)
SUBSTEP_ENTRIES(fenton_ab2, fibtorch::FentonAb2Cell)
SUBSTEP_ENTRIES(ms, fibtorch::MsCell)
#endif
}  // extern "C"
