// The fused shading tail for Hopper (sm_90a): BSDF eval toward the NEE
// light sample, the shadow trace, MIS, BSDF sampling and Russian roulette
// for one path vertex per lane, in one kernel.
//
// Replaces the Pallas TPU kernel of mitsuba_tpu/accel/shade_kernel.py:
// make_shade_kernel (:75), launched by _run_shade (:252), for the 13 leaf
// families other than rough plastic (whose transmittance rows the K_IN
// input does not carry) with the two-sided adapter. Its plain version is
// shade_plain in accel/shade_kernel.py, which this kernel matches op for
// op.
//
// Design: one thread per lane, 128-thread blocks. The input is the JAX
// kernel's K_IN = 50 rows and the output its K_OUT = 16 rows, one column
// per lane (structure of arrays), so a warp's loads and stores of a row
// are coalesced. The TPU's [K*8, N/8] packing and per-block live flags are
// gone: a lane inactive on entry writes the pass-through rows of the JAX
// kernel's dead blocks. A per-lane branch on the material code runs only
// that family's arithmetic (bsdf_common.cuh).
//
// The shadow ray is traced only for lanes that contribute (the JAX
// kernel's contrib0), so delta materials never trace one, and with the
// trace kernel's own warp walk (trace_common.cuh trace_ray_warp): per-lane
// slab gates, and a cluster that few lanes enter scanned by the whole warp
// one ray at a time. That walk needs all 32 lanes of the warp at the call,
// so no lane returns before it: a lane past n or inactive on entry runs
// along with nothing to trace and writes its rows after the walk. The
// kernel is split as the megakernels' bounce is: the BSDF eval and
// contrib0 (shade_front), the walk, then MIS, the BSDF sample and Russian
// roulette. It is a template on the walk, and the launch picks the
// cooperative instantiation past one walked cluster (coop_walk), as the
// trace kernel's and the megakernels' launches do.
//
// What bounds it on the H100: at the main path's shapes the 264 bytes of
// rows per lane move in a few microseconds at 3.35 TB/s, and the fp32
// work per lane is a few hundred operations plus the shadow rays'
// triangle tests, so bytes and operations are of one order; the launch
// itself (a few microseconds) is of that order too. The shadow walk is
// nearly all of the time: a launch in which no lane traces takes a few
// microseconds. Its rays are sparse and incoherent past bounce 0 (a few
// percent of the lanes, spread over most warps), the case the warp walk's
// cooperative branch is for. Divergence between material branches is the
// design's other cost; sorting lanes by material is later work.
//
// Arithmetic: compiled with -fmad=false; every float expression is written
// in shade_plain's order (PyTorch rounds after every op), and PyTorch's
// `c / x` for a Python scalar c is reciprocal(x) * c.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bsdf_common.cuh"
#include "path_common.cuh"
#include "trace_common.cuh"

namespace {

using namespace mitsuba_path;
using mitsuba_bsdf::BsdfSample;
using mitsuba_bsdf::bsdf_eval_pdf;
using mitsuba_bsdf::bsdf_sample;
using mitsuba_walk::Ray;
using mitsuba_walk::trace_ray_warp;

// input rows (accel/shade_kernel.py I_*)
constexpr int kP = 0, kNg = 3, kS = 6, kT = 9, kN = 12, kD = 15, kTp = 18;
constexpr int kL = 21, kMat = 24, kTwo = 37, kNd = 38, kNDist = 41;
constexpr int kNPdf = 42, kNVal = 43, kNDelta = 46, kHit = 47, kAct = 48;
constexpr int kEta = 49;
constexpr int kMatCols = 13;
constexpr uint32_t kSensorDims = 4, kDimsPerBounce = 8;
constexpr uint32_t kDimBsdfU2 = 2, kDimBsdfU1 = 3, kDimRR = 4;
constexpr int kThreads = 128;

// (a.x * b.x + a.y * b.y) + a.z * b.z: shade_plain's row-wise dot
__device__ __forceinline__ float dot_rows(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  return (ax * bx + ay * by) + az * bz;
}

__device__ __forceinline__ float max_abs(float x, float y, float z) {
  return fmaxf(fmaxf(fabsf(x), fabsf(y)), fabsf(z));
}

// What the kernel computes for a lane active on entry before its shadow
// walk, and carries across it.
struct Front {
  float px, py, pz, ngx, ngy, ngz;
  float sx, sy, sz, tx, ty, tz, nx, ny, nz;
  float dx, dy, dz;
  float m[kMatCols];
  float wix, wiy, wiz, fsign;   // wi in the shading frame, flipped
  float f[3], pdf_fwd, pdf_nee;
  float eps_o;                  // origin offset scale at the hit
  bool hit, contrib;            // contrib: the lane traces `shadow`
  Ray shadow;
};

__device__ __forceinline__ float row_of(const float* c, int n, int k) {
  return c[static_cast<size_t>(k) * n];
}

// The BSDF eval toward the NEE sample, contrib0 and the shadow ray.
__device__ __forceinline__ Front shade_front(const float* c, int n,
                                             int bounce, int max_depth) {
  const auto row = [&](int k) { return row_of(c, n, k); };
  Front v;
  v.px = row(kP), v.py = row(kP + 1), v.pz = row(kP + 2);
  v.dx = row(kD), v.dy = row(kD + 1), v.dz = row(kD + 2);
  v.ngx = row(kNg), v.ngy = row(kNg + 1), v.ngz = row(kNg + 2);
  v.sx = row(kS), v.sy = row(kS + 1), v.sz = row(kS + 2);
  v.tx = row(kT), v.ty = row(kT + 1), v.tz = row(kT + 2);
  v.nx = row(kN), v.ny = row(kN + 1), v.nz = row(kN + 2);
  const float ldx = row(kNd), ldy = row(kNd + 1), ldz = row(kNd + 2);
#pragma unroll
  for (int j = 0; j < kMatCols; ++j) v.m[j] = row(kMat + j);
  v.hit = row(kHit) > 0.5f;
  v.pdf_nee = row(kNPdf);

  // wi in the shading frame; the two-sided flip mirrors back-side
  // incidence into z > 0
  v.wix = -dot_rows(v.dx, v.dy, v.dz, v.sx, v.sy, v.sz);
  v.wiy = -dot_rows(v.dx, v.dy, v.dz, v.tx, v.ty, v.tz);
  const float wiz_r = -dot_rows(v.dx, v.dy, v.dz, v.nx, v.ny, v.nz);
  v.fsign = row(kTwo) > 0.5f && wiz_r < 0.f ? -1.f : 1.f;
  v.wiz = wiz_r * v.fsign;

  // ---- NEE: BSDF eval toward the light and its pdf --------------------
  const float wol_x = dot_rows(ldx, ldy, ldz, v.sx, v.sy, v.sz);
  const float wol_y = dot_rows(ldx, ldy, ldz, v.tx, v.ty, v.tz);
  const float wol_z = dot_rows(ldx, ldy, ldz, v.nx, v.ny, v.nz) * v.fsign;
  bsdf_eval_pdf<false>(v.m, v.wix, v.wiy, v.wiz, wol_x, wol_y, wol_z, v.f,
                       v.pdf_fwd);
  const int depth = bounce + 2;
  v.contrib = v.hit && depth + 1 <= max_depth + 1 && v.pdf_nee > 0.f
              && (v.f[0] > 0.f || v.f[1] > 0.f || v.f[2] > 0.f);

  // ---- the shadow ray, traced only where it can contribute ------------
  const float side = sign_of(dot_rows(ldx, ldy, ldz, v.ngx, v.ngy, v.ngz));
  v.eps_o = F32(1e-4) * (1.f + max_abs(v.px, v.py, v.pz));
  const float sox = v.px + (side * v.eps_o) * v.ngx;
  const float soy = v.py + (side * v.eps_o) * v.ngy;
  const float soz = v.pz + (side * v.eps_o) * v.ngz;
  const float smint = F32(1e-4) * (1.f + max_abs(sox, soy, soz));
  const float smaxt = v.contrib ? row(kNDist) * F32(1.0 - 1e-3) : 0.f;
  v.shadow = Ray{sox, soy, soz, ldx, ldy, ldz, smint, smaxt};
  return v;
}

// kCoop: mitsuba_walk::coop_walk, which the launch picks. The launch
// bound asks for four blocks an SM, so at most 128 registers a thread, as
// the megakernels have.
template <bool kCoop>
__global__ void __launch_bounds__(kThreads, 4)
shade(const float4* __restrict__ woop, const float* __restrict__ aabb,
      int tris, const float* __restrict__ in, float* __restrict__ out,
      const int* __restrict__ pixel, const int* __restrict__ samp, int n,
      uint32_t seed, int bounce, int rr_depth, int max_depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < n;
  const float* c = in + i;
  const auto row = [&](int k) { return row_of(c, n, k); };
  // a lane past n or inactive on entry takes part in the warp's shadow
  // walk with nothing to trace
  const bool act = lane_ok && row(kAct) > 0.5f;
  Front v{};
  if (act) v = shade_front(c, n, bounce, max_depth);
  const bool occluded = trace_ray_warp<true, kCoop>(woop, aabb, tris,
                                                    v.contrib, v.shadow)
                            .found;
  if (!lane_ok) return;
  float* o = out + i;
  const auto put = [&](int k, float x) { o[static_cast<size_t>(k) * n] = x; };
  const float eta = row(kEta);
  if (!act) {
    // inactive on entry: the carry passes through (L kept, o = p)
    const float through[16] = {row(kP), row(kP + 1), row(kP + 2), row(kD),
                               row(kD + 1), row(kD + 2), 0.f, 0.f, 0.f,
                               row(kL), row(kL + 1), row(kL + 2),
                               0.f, 1.f, 1.f, eta};
#pragma unroll
    for (int k = 0; k < 16; ++k) put(k, through[k]);
    return;
  }
  const float w_nee = row(kNDelta) > 0.5f ? 1.f
                                          : mis_power(v.pdf_nee, v.pdf_fwd);
  const float cgate = (v.contrib && !occluded ? 1.f : 0.f) * w_nee;
  const float lr = row(kL) + ((row(kTp) * row(kNVal)) * v.f[0]) * cgate;
  const float lg = row(kL + 1) + ((row(kTp + 1) * row(kNVal + 1)) * v.f[1])
                                 * cgate;
  const float lb = row(kL + 2) + ((row(kTp + 2) * row(kNVal + 2)) * v.f[2])
                                 * cgate;

  // ---- BSDF sample → next ray -----------------------------------------
  const uint32_t pix = static_cast<uint32_t>(pixel[i]);
  const uint32_t smp = static_cast<uint32_t>(samp[i]);
  const uint32_t dim = kSensorDims
                       + static_cast<uint32_t>(bounce) * kDimsPerBounce;
  const float2 ub = rng2(seed, pix, dim + kDimBsdfU2, smp);
  const float uc = rng2(seed, pix, dim + kDimBsdfU1, smp).x;
  const BsdfSample bs = bsdf_sample<false>(v.m, v.wix, v.wiy, v.wiz, ub.x,
                                           ub.y, uc);
  const float nwz = bs.wo[2] * v.fsign;  // un-flip (two-sided adapter)
  const float ndx = (bs.wo[0] * v.sx + bs.wo[1] * v.tx) + nwz * v.nx;
  const float ndy = (bs.wo[0] * v.sy + bs.wo[1] * v.ty) + nwz * v.ny;
  const float ndz = (bs.wo[0] * v.sz + bs.wo[1] * v.tz) + nwz * v.nz;
  const float tp_r = row(kTp) * bs.w[0];
  const float tp_g = row(kTp + 1) * bs.w[1];
  const float tp_b = row(kTp + 2) * bs.w[2];
  const int depth = bounce + 2;
  bool alive = v.hit && bs.pdf > 0.f
               && (tp_r > 0.f || tp_g > 0.f || tp_b > 0.f)
               && depth <= max_depth;

  // ---- Russian roulette (path.cpp:278-289) ----------------------------
  const float eta_next = eta * bs.eta;
  const float q = clamp_max((fmaxf(fmaxf(tp_r, tp_g), tp_b) * eta_next)
                            * eta_next, 0.95f);
  float rs = 1.f;
  if (depth >= rr_depth) {
    const bool rr = rng2(seed, pix, dim + kDimRR, smp).x < q;
    rs = rr ? 1.f / clamp_min(q, F32(1e-6)) : 1.f;
    alive = alive && rr;
  }
  const float af = alive ? 1.f : 0.f;
  const float side_n = sign_of(dot_rows(ndx, ndy, ndz, v.ngx, v.ngy, v.ngz));
  put(0, v.px + (side_n * v.eps_o) * v.ngx);
  put(1, v.py + (side_n * v.eps_o) * v.ngy);
  put(2, v.pz + (side_n * v.eps_o) * v.ngz);
  put(3, alive ? ndx : v.dx);
  put(4, alive ? ndy : v.dy);
  put(5, alive ? ndz : v.dz);
  put(6, (tp_r * rs) * af);
  put(7, (tp_g * rs) * af);
  put(8, (tp_b * rs) * af);
  put(9, lr);
  put(10, lg);
  put(11, lb);
  put(12, af);
  put(13, bs.delta ? 1.f : bs.pdf);
  put(14, bs.delta ? 1.f : 0.f);
  put(15, eta_next);
}

}  // namespace

// C entry point (ctypes, accel/shade_kernel.py). Pointers are device
// pointers: woop [C, 3*64] float4, aabb [C, 8], in [50, n], out [16, n],
// pixel and samp [n] int32; the walk covers the first n_tris triangles
// (the real ones: padding follows them), with the instantiation coop_walk
// picks. Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int mitsuba_shade(const void* woop, const void* aabb,
                             int n_clusters, int n_tris, const void* in,
                             void* out, const void* pixel, const void* samp,
                             int n, uint32_t seed, int bounce, int rr_depth,
                             int max_depth, void* stream) {
  if (n <= 0) return 0;
  const int tris = mitsuba_walk::walk_tris(n_tris, n_clusters);
  const auto kernel = mitsuba_walk::coop_walk(tris) ? shade<true>
                                                    : shade<false>;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(woop), static_cast<const float*>(aabb),
      tris, static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const int*>(pixel), static_cast<const int*>(samp), n, seed,
      bounce, rr_depth, max_depth);
  return static_cast<int>(cudaGetLastError());
}
