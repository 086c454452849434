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
// that family's arithmetic (bsdf_common.cuh). The shadow ray is traced,
// with the SIMT any-hit cluster walk of trace_common.cuh (trace_ray, which
// stops at the last real triangle), only for lanes that contribute (the
// JAX kernel's contrib0), so delta materials never trace one; the warp
// walk of the other kernels needs every lane at the call, and here the
// trace sits inside that divergent branch.
//
// What bounds it on the H100: at the Cornell-like shapes of the main path
// the 264 bytes of rows per lane move in a few microseconds at 3.35 TB/s,
// and the fp32 work per lane is a few hundred operations plus the shadow
// trace's triangle tests, so bytes and operations are of one order; the
// launch itself (a few microseconds) is of that order too. Divergence
// between material branches and between tracing and non-tracing lanes of
// a warp is the design's cost; sorting lanes by material is later work.
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
using mitsuba_walk::trace_ray;

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

__global__ void __launch_bounds__(kThreads)
shade(const float4* __restrict__ woop, const float* __restrict__ aabb,
      int tris, const float* __restrict__ in, float* __restrict__ out,
      const int* __restrict__ pixel, const int* __restrict__ samp, int n,
      uint32_t seed, int bounce, int rr_depth, int max_depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* c = in + i;
  float* o = out + i;
  const auto row = [&](int k) { return c[static_cast<size_t>(k) * n]; };
  const auto put = [&](int k, float x) { o[static_cast<size_t>(k) * n] = x; };

  const float px = row(kP), py = row(kP + 1), pz = row(kP + 2);
  const float dx = row(kD), dy = row(kD + 1), dz = row(kD + 2);
  const float eta = row(kEta);
  if (!(row(kAct) > 0.5f)) {
    // inactive on entry: the carry passes through (L kept, o = p)
    const float through[16] = {px, py, pz, dx, dy, dz, 0.f, 0.f, 0.f,
                               row(kL), row(kL + 1), row(kL + 2),
                               0.f, 1.f, 1.f, eta};
#pragma unroll
    for (int k = 0; k < 16; ++k) put(k, through[k]);
    return;
  }
  const float ngx = row(kNg), ngy = row(kNg + 1), ngz = row(kNg + 2);
  const float sx = row(kS), sy = row(kS + 1), sz = row(kS + 2);
  const float tx = row(kT), ty = row(kT + 1), tz = row(kT + 2);
  const float nx = row(kN), ny = row(kN + 1), nz = row(kN + 2);
  const float ldx = row(kNd), ldy = row(kNd + 1), ldz = row(kNd + 2);
  float m[kMatCols];
#pragma unroll
  for (int j = 0; j < kMatCols; ++j) m[j] = row(kMat + j);
  const bool hit = row(kHit) > 0.5f;
  const float pdf_nee = row(kNPdf);

  // wi in the shading frame; the two-sided flip mirrors back-side
  // incidence into z > 0
  const float wix = -dot_rows(dx, dy, dz, sx, sy, sz);
  const float wiy = -dot_rows(dx, dy, dz, tx, ty, tz);
  const float wiz_r = -dot_rows(dx, dy, dz, nx, ny, nz);
  const float fsign = row(kTwo) > 0.5f && wiz_r < 0.f ? -1.f : 1.f;
  const float wiz = wiz_r * fsign;

  // ---- NEE: BSDF eval toward the light and its pdf --------------------
  const float wol_x = dot_rows(ldx, ldy, ldz, sx, sy, sz);
  const float wol_y = dot_rows(ldx, ldy, ldz, tx, ty, tz);
  const float wol_z = dot_rows(ldx, ldy, ldz, nx, ny, nz) * fsign;
  float f[3], pdf_fwd;
  bsdf_eval_pdf<false>(m, wix, wiy, wiz, wol_x, wol_y, wol_z, f, pdf_fwd);
  const int depth = bounce + 2;
  const bool contrib = hit && depth + 1 <= max_depth + 1 && pdf_nee > 0.f
                       && (f[0] > 0.f || f[1] > 0.f || f[2] > 0.f);

  // ---- the shadow ray, traced only where it can contribute ------------
  const float side = sign_of(dot_rows(ldx, ldy, ldz, ngx, ngy, ngz));
  const float eps_o = F32(1e-4) * (1.f + max_abs(px, py, pz));
  const float sox = px + (side * eps_o) * ngx;
  const float soy = py + (side * eps_o) * ngy;
  const float soz = pz + (side * eps_o) * ngz;
  bool occluded = false;
  if (contrib) {
    const float smint = F32(1e-4) * (1.f + max_abs(sox, soy, soz));
    const float smaxt = row(kNDist) * F32(1.0 - 1e-3);
    occluded = trace_ray<true>(woop, aabb, tris, Ray{sox, soy, soz, ldx, ldy,
                                                     ldz, smint, smaxt})
                   .found;
  }
  const float w_nee = row(kNDelta) > 0.5f ? 1.f : mis_power(pdf_nee, pdf_fwd);
  const float cgate = (contrib && !occluded ? 1.f : 0.f) * w_nee;
  const float lr = row(kL) + ((row(kTp) * row(kNVal)) * f[0]) * cgate;
  const float lg = row(kL + 1) + ((row(kTp + 1) * row(kNVal + 1)) * f[1])
                                 * cgate;
  const float lb = row(kL + 2) + ((row(kTp + 2) * row(kNVal + 2)) * f[2])
                                 * cgate;

  // ---- BSDF sample → next ray -----------------------------------------
  const uint32_t pix = static_cast<uint32_t>(pixel[i]);
  const uint32_t smp = static_cast<uint32_t>(samp[i]);
  const uint32_t dim = kSensorDims
                       + static_cast<uint32_t>(bounce) * kDimsPerBounce;
  const float2 ub = rng2(seed, pix, dim + kDimBsdfU2, smp);
  const float uc = rng2(seed, pix, dim + kDimBsdfU1, smp).x;
  const BsdfSample bs = bsdf_sample<false>(m, wix, wiy, wiz, ub.x, ub.y,
                                           uc);
  const float nwz = bs.wo[2] * fsign;    // un-flip (two-sided adapter)
  const float ndx = (bs.wo[0] * sx + bs.wo[1] * tx) + nwz * nx;
  const float ndy = (bs.wo[0] * sy + bs.wo[1] * ty) + nwz * ny;
  const float ndz = (bs.wo[0] * sz + bs.wo[1] * tz) + nwz * nz;
  const float tp_r = row(kTp) * bs.w[0];
  const float tp_g = row(kTp + 1) * bs.w[1];
  const float tp_b = row(kTp + 2) * bs.w[2];
  bool alive = hit && bs.pdf > 0.f && (tp_r > 0.f || tp_g > 0.f || tp_b > 0.f)
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
  const float side_n = sign_of(dot_rows(ndx, ndy, ndz, ngx, ngy, ngz));
  put(0, px + (side_n * eps_o) * ngx);
  put(1, py + (side_n * eps_o) * ngy);
  put(2, pz + (side_n * eps_o) * ngz);
  put(3, alive ? ndx : dx);
  put(4, alive ? ndy : dy);
  put(5, alive ? ndz : dz);
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
// (the real ones: padding follows them). Launches on `stream` and returns
// the cudaError_t of the launch.
extern "C" int mitsuba_shade(const void* woop, const void* aabb,
                             int n_clusters, int n_tris, const void* in,
                             void* out, const void* pixel, const void* samp,
                             int n, uint32_t seed, int bounce, int rr_depth,
                             int max_depth, void* stream) {
  if (n <= 0) return 0;
  shade<<<(n + kThreads - 1) / kThreads, kThreads, 0,
          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(woop), static_cast<const float*>(aabb),
      mitsuba_walk::walk_tris(n_tris, n_clusters),
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const int*>(pixel), static_cast<const int*>(samp), n, seed,
      bounce, rr_depth, max_depth);
  return static_cast<int>(cudaGetLastError());
}
