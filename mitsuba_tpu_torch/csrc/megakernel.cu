// Path-tracing megakernels for Hopper (sm_90a): one bounce per launch
// (mega_bounce), whole paths per lane (mega_path), and a pixel's whole
// sample loop per lane with in-kernel camera-ray regeneration
// (mega_persistent), all three over one __device__ bounce.
//
// Replaces the Pallas TPU kernels of mitsuba_tpu/accel/megakernel.py:
// make_bounce_kernel (:1395, launched by run_bounce :1511),
// make_path_kernel (:1423, run_path :1552) and make_persistent_kernel
// (:2478, run_persistent :2661), whose shared body is _bounce_rows
// (:606-1384), for the Cornell subset: pinhole camera, flat shading, the
// diffuse BSDF and area emitters, without medium or textures.
//
// Design: one thread per lane. The path state lives in registers for the
// whole launch; scene tables (per-triangle attributes, materials, emitter
// rows) are gathered per thread through the read-only cache, and the trace
// is the trace kernel's own cluster walk (trace_common.cuh), so hits are
// those of trace_kernel and of the plain intersector, bit for bit. A lane
// whose path is dead on entry to a bounce leaves it unchanged, as the
// plain version (PathTracer.bounce) does, so mega_path can stop each lane
// at its own last bounce. The persistent kernel banks a dead path's L,
// counts it, and regenerates a camera ray for the next sample until the
// lane has finished `spp` paths.
//
// What bounds it on the H100: fp32 instruction throughput and warp
// divergence, not bytes. A bounce is two traces of ~40 fp32 ops per
// triangle test plus ~300 ops of shading, against a few hundred bytes of
// table that every lane of a warp reads from L1; paths of a warp die at
// different bounces, so lanes idle while the warp's longest path runs. The persistent kernel answers
// the divergence the way the TPU kernel does: a lane whose path dies
// starts its next sample at once, so a warp stays busy until its lanes
// have all finished their spp. One lane per pixel gives 65,536 lanes at
// 256² (~15 warps per SM); splitting a pixel's samples over several lanes
// is later work.
//
// Arithmetic: this file is compiled with -fmad=false and writes every
// float expression in the plain version's order, so each operation rounds
// as PyTorch's eager ops do (torch's CUDA sum over a length-3 axis adds
// (a + c) + b, see sum3). sqrtf and division are IEEE; rsqrtf, cosf and
// sinf are the same library calls PyTorch makes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "path_common.cuh"
#include "trace_common.cuh"

namespace {

using namespace mitsuba_path;
using mitsuba_walk::Hit;
using mitsuba_walk::kMiss;
using mitsuba_walk::trace_ray;

constexpr int kState = 16;    // rows of the bounce state
constexpr int kPState = 24;   // rows of the persistent state
constexpr int kAttr = 25;     // per-triangle attribute row
constexpr int kMat = 24;      // material row
constexpr int kEmRow = 24;    // emissive-triangle row
constexpr int kEmMeta = 16;   // emitter row
constexpr uint32_t kSensorDims = 4, kDimsPerBounce = 8;
constexpr uint32_t kDimNeeSel = 0, kDimNeePos = 1, kDimBsdfU2 = 2;
constexpr uint32_t kDimRR = 4, kDimPixel = 0;

struct Tables {
  const float4* woop;     // [C, 3*64] Woop rows (trace_common.cuh)
  const float* aabb;      // [C, 8]
  int n_clusters;
  const float* attr;      // [T, 25]
  const float* mat;       // [M, 24]
  const float* em_rows;   // [ET_pad, 24]
  int et_real;
  const float* em_meta;   // [E_pad, 16]
  const float* em_cdf;    // [E+1]
  int n_em;
};

struct Camera {           // megakernel.py camera_consts
  float r[9];             // rotation rows, camera -> world
  float pos[3];
  float tan_half, aspect, width, height;
};

struct State {
  V3 o, d, tp, L;
  float active, prev_pdf, prev_delta, eta;
};

// emitter/emitter.py sample_direct (area emitters)
struct DirectSample {
  V3 d, value;
  float dist, pdf;
};

__device__ __forceinline__ DirectSample sample_direct(const Tables& T, V3 p,
                                                      float u_sel, float2 u2) {
  DirectSample ds{V3{0.f, 0.f, 1.f}, V3{0.f, 0.f, 0.f}, 0.f, 0.f};
  if (T.n_em == 0) return ds;
  // emitter pick with sample reuse: searchsorted(cdf, u, right=True) - 1
  int cnt = 0;
  for (int k = 0; k <= T.n_em; ++k) cnt += __ldg(T.em_cdf + k) <= u_sel;
  const int e = min(max(cnt - 1, 0), T.n_em - 1);
  const float* meta = T.em_meta + e * kEmMeta;
  const float pmf = __ldg(meta + 1);
  const float lo = __ldg(T.em_cdf + e);
  const float one_m = F32(1.0 - 1e-7);
  const float u_re = clamp_max(
      clamp_min((u_sel - lo) / clamp_min(pmf, F32(1e-20)), 0.f), one_m);
  // triangle within it from the globalized cdf (values in (e, e+1])
  const float key = static_cast<float>(e) + clamp_max(clamp_min(u_re, 0.f),
                                                      one_m);
  int hi = 0;
  for (int j = 0; j < T.et_real; ++j)
    hi += __ldg(T.em_rows + j * kEmRow + 12) <= key;
  const float* row = T.em_rows + min(max(hi, 0), T.et_real - 1) * kEmRow;
  const float sq = sqrtf(clamp_min(1.f - u2.x, 0.f));
  const float b0 = 1.f - sq, b1 = u2.y * sq;
  const V3 r0 = row3(row), r1 = row3(row + 3), r2 = row3(row + 6);
  const V3 nl = row3(row + 9);
  const V3 pl{(r0.x + b0 * r1.x) + b1 * r2.x, (r0.y + b0 * r1.y) + b1 * r2.y,
              (r0.z + b0 * r1.z) + b1 * r2.z};
  const V3 tl{pl.x - p.x, pl.y - p.y, pl.z - p.z};
  const float dist2 = clamp_min(dot3(tl, tl), F32(1e-12));
  ds.dist = sqrtf(dist2);
  ds.d = V3{tl.x / ds.dist, tl.y / ds.dist, tl.z / ds.dist};
  const float cos_l = -dot3(ds.d, nl);
  const float area = __ldg(meta + 6);
  float pdf = safe_div(dist2, cos_l * clamp_min(area, F32(1e-12)));
  pdf = (cos_l > F32(1e-6) ? pdf : 0.f) * pmf;
  ds.pdf = pdf;
  if (pdf > 0.f)
    ds.value = V3{safe_div(__ldg(meta + 3), pdf),
                  safe_div(__ldg(meta + 4), pdf),
                  safe_div(__ldg(meta + 5), pdf)};
  return ds;
}

// One bounce of integrator/path.py PathTracer.bounce for one lane. A lane
// inactive on entry is left unchanged. traced: this lane traced a
// closest-hit ray; shadow: it attempted a shadow ray.
__device__ __forceinline__ void path_bounce(const Tables& T, State& s,
                                            uint32_t seed, uint32_t pixel,
                                            uint32_t samp, int bounce,
                                            int max_depth, int rr_depth,
                                            bool& traced, bool& shadow) {
  traced = shadow = false;
  if (!(s.active > 0.5f)) return;
  traced = true;
  const uint32_t dim = kSensorDims + static_cast<uint32_t>(bounce)
                       * kDimsPerBounce;

  // ---- closest hit and its record (accel/dense.py fill_intersection) ----
  const Hit h = trace_ray<false>(T.woop, T.aabb, T.n_clusters, s.o.x, s.o.y,
                                 s.o.z, s.d.x, s.d.y, s.d.z, ray_mint(s.o),
                                 kMiss);
  const bool hit = h.found;
  const float* A = T.attr + (hit ? h.tri : 0) * kAttr;
  const V3 ng = row3(A);
  const V3 vn0 = row3(A + 5), dv1 = row3(A + 8), dv2 = row3(A + 11);
  const V3 vn1{vn0.x + dv1.x, vn0.y + dv1.y, vn0.z + dv1.z};
  const V3 vn2{vn0.x + dv2.x, vn0.y + dv2.y, vn0.z + dv2.z};
  const float b0 = (1.f - h.u) - h.v;
  V3 ns{(vn0.x * b0 + vn1.x * h.u) + vn2.x * h.v,
        (vn0.y * b0 + vn1.y * h.u) + vn2.y * h.v,
        (vn0.z * b0 + vn1.z * h.u) + vn2.z * h.v};
  const float inv_len = rsqrtf(clamp_min(dot3(ns, ns), F32(1e-20)));
  ns = V3{ns.x * inv_len, ns.y * inv_len, ns.z * inv_len};
  const int mat_id = hit ? static_cast<int>(__ldg(A + 3)) : -1;
  const int em_id = hit ? static_cast<int>(__ldg(A + 4)) : -1;
  const float t_safe = hit ? h.t : 1.f;
  const V3 p{s.o.x + t_safe * s.d.x, s.o.y + t_safe * s.d.y,
             s.o.z + t_safe * s.d.z};

  // ---- emitter hit on a surface (eval_area, pdf_direct_area) ----------
  if (hit) {
    const float cos_surf = -dot3(s.d, ng);
    const bool em_ok = em_id >= 0;
    const bool front = em_ok && cos_surf > 0.f;
    const V3 le{front ? __ldg(A + 14) : 0.f, front ? __ldg(A + 15) : 0.f,
                front ? __ldg(A + 16) : 0.f};
    float pdf_hit = safe_div(h.t * h.t,
                             cos_surf * clamp_min(__ldg(A + 17), F32(1e-12)))
                    * __ldg(A + 18);
    pdf_hit = em_ok && cos_surf > F32(1e-6) ? pdf_hit : 0.f;
    const float w = s.prev_delta > 0.5f ? 1.f : mis_power(s.prev_pdf, pdf_hit);
    s.L = V3{s.L.x + (s.tp.x * le.x) * w, s.L.y + (s.tp.y * le.y) * w,
             s.L.z + (s.tp.z * le.z) * w};
  }

  const int depth = bounce + 2;   // path vertices: camera = 1, this hit
  const float* M = T.mat + max(mat_id, 0) * kMat;
  const bool diffuse = __ldg(M + 12) == 0.f;
  const V3 alb = row3(M);
  V3 fs, ft;
  coordinate_system(ns, fs, ft);
  const V3 wi = to_local(fs, ft, ns, V3{-s.d.x, -s.d.y, -s.d.z});

  // ---- next-event estimation ------------------------------------------
  const bool nee_allowed = hit && depth + 1 <= max_depth + 1;
  const float u_sel = rng2(seed, pixel, dim + kDimNeeSel, samp).x;
  const float2 u_pos = rng2(seed, pixel, dim + kDimNeePos, samp);
  const DirectSample ds = sample_direct(T, p, u_sel, u_pos);
  shadow = nee_allowed && ds.pdf > 0.f;
  const V3 wo = to_local(fs, ft, ns, ds.d);
  const bool both_up = wi.z > 0.f && wo.z > 0.f;
  const float cos_o = clamp_min(wo.z, 0.f);
  V3 f{0.f, 0.f, 0.f};
  if (diffuse && both_up)
    f = V3{(alb.x * F32(1.0 / kPi)) * cos_o, (alb.y * F32(1.0 / kPi)) * cos_o,
           (alb.z * F32(1.0 / kPi)) * cos_o};
  bool contributes = shadow && any_pos(f);
  if (contributes) {
    // shadow ray over [eps, dist * (1 - ShadowEpsilon)] (scene.cpp:846)
    const V3 so = offset_ray_origin(p, ng, ds.d);
    contributes = !trace_ray<true>(T.woop, T.aabb, T.n_clusters, so.x, so.y,
                                   so.z, ds.d.x, ds.d.y, ds.d.z, ray_mint(so),
                                   ds.dist * F32(1.0 - 1e-3)).found;
  }
  if (contributes) {
    const float pdf_bsdf = diffuse && both_up ? cos_o * F32(1.0 / kPi) : 0.f;
    const float w = mis_power(ds.pdf, pdf_bsdf);
    s.L = V3{s.L.x + ((s.tp.x * ds.value.x) * f.x) * w,
             s.L.y + ((s.tp.y * ds.value.y) * f.y) * w,
             s.L.z + ((s.tp.z * ds.value.z) * f.z) * w};
  }

  // ---- BSDF sampling (the diffuse branch) -------------------------------
  const float2 ub = rng2(seed, pixel, dim + kDimBsdfU2, samp);
  V3 wn{0.f, 0.f, 0.f}, weight{0.f, 0.f, 0.f};
  float pdf = 0.f;
  if (diffuse) {
    wn = cosine_hemisphere(ub.x, ub.y);
    if (wi.z > 0.f) {
      weight = alb;
      pdf = clamp_min(wn.z, 0.f) * F32(1.0 / kPi);
    }
  }
  const V3 d_next{(fs.x * wn.x + ft.x * wn.y) + ns.x * wn.z,
                  (fs.y * wn.x + ft.y * wn.y) + ns.y * wn.z,
                  (fs.z * wn.x + ft.z * wn.y) + ns.z * wn.z};
  const V3 o_next = offset_ray_origin(p, ng, d_next);
  V3 tn{s.tp.x * weight.x, s.tp.y * weight.y, s.tp.z * weight.z};
  bool alive = hit && pdf > 0.f && any_pos(tn) && depth <= max_depth;

  // ---- Russian roulette (path.cpp:278-289); the diffuse eta is 1 ------
  if (depth >= rr_depth) {
    const float q = clamp_max(fmaxf(fmaxf(tn.x, tn.y), tn.z)
                              * (s.eta * s.eta), 0.95f);
    const bool rr = rng2(seed, pixel, dim + kDimRR, samp).x < q;
    if (rr) {
      const float qc = clamp_min(q, F32(1e-6));
      tn = V3{tn.x / qc, tn.y / qc, tn.z / qc};
    }
    alive = alive && rr;
  }
  s.o = o_next;
  if (alive) s.d = d_next;
  s.tp = alive ? tn : V3{0.f, 0.f, 0.f};
  s.active = alive ? 1.f : 0.f;
  s.prev_pdf = pdf;
  s.prev_delta = 0.f;
}

__device__ __forceinline__ State load_state(const float* __restrict__ st,
                                            int n, int i) {
  const float* c = st + i;
  State s;
  s.o = V3{c[0], c[n], c[2 * n]};
  s.d = V3{c[3 * n], c[4 * n], c[5 * n]};
  s.tp = V3{c[6 * n], c[7 * n], c[8 * n]};
  s.L = V3{c[9 * n], c[10 * n], c[11 * n]};
  s.active = c[12 * n];
  s.prev_pdf = c[13 * n];
  s.prev_delta = c[14 * n];
  s.eta = c[15 * n];
  return s;
}

__device__ __forceinline__ void store_state(float* __restrict__ st, int n,
                                            int i, const State& s) {
  float* c = st + i;
  c[0] = s.o.x;
  c[n] = s.o.y;
  c[2 * n] = s.o.z;
  c[3 * n] = s.d.x;
  c[4 * n] = s.d.y;
  c[5 * n] = s.d.z;
  c[6 * n] = s.tp.x;
  c[7 * n] = s.tp.y;
  c[8 * n] = s.tp.z;
  c[9 * n] = s.L.x;
  c[10 * n] = s.L.y;
  c[11 * n] = s.L.z;
  c[12 * n] = s.active;
  c[13 * n] = s.prev_pdf;
  c[14 * n] = s.prev_delta;
  c[15 * n] = s.eta;
}

// A fresh camera path for `pixel` at sample `samp`: render.py's jitter and
// sensor.py's pinhole PerspectiveCamera.sample_ray, op for op. PyTorch's
// CUDA division by a Python scalar multiplies by the scalar's reciprocal,
// so the pixel position is scaled by 1/width, not divided by width.
__device__ __forceinline__ void camera_path(const Camera& cam, uint32_t seed,
                                            uint32_t pixel, uint32_t samp,
                                            State& s) {
  const float2 j = rng2(seed, pixel, kDimPixel, samp);
  const uint32_t w = static_cast<uint32_t>(cam.width);
  const float px = static_cast<float>(pixel % w) + j.x;
  const float py = static_cast<float>(pixel / w) + j.y;
  const float lx = (1.f - (px * (1.f / cam.width)) * 2.f) * cam.tan_half;
  const float ly = ((1.f - (py * (1.f / cam.height)) * 2.f) * cam.tan_half)
                   * cam.aspect;
  V3 d{(lx * cam.r[0] + ly * cam.r[1]) + cam.r[2],
       (lx * cam.r[3] + ly * cam.r[4]) + cam.r[5],
       (lx * cam.r[6] + ly * cam.r[7]) + cam.r[8]};
  const float inv = rsqrtf(clamp_min(dot3(d, d), F32(1e-30)));
  s.o = V3{cam.pos[0], cam.pos[1], cam.pos[2]};
  s.d = V3{d.x * inv, d.y * inv, d.z * inv};
  s.tp = V3{1.f, 1.f, 1.f};
  s.L = V3{0.f, 0.f, 0.f};
  s.active = s.prev_pdf = s.prev_delta = s.eta = 1.f;
}

__global__ void __launch_bounds__(128)
mega_bounce(Tables T, const float* __restrict__ in, float* __restrict__ out,
            const int* __restrict__ pixel, const int* __restrict__ samp,
            int n, uint32_t seed, int bounce, int max_depth, int rr_depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  State s = load_state(in, n, i);
  bool traced, shadow;
  path_bounce(T, s, seed, static_cast<uint32_t>(pixel[i]),
              static_cast<uint32_t>(samp[i]), bounce, max_depth, rr_depth,
              traced, shadow);
  store_state(out, n, i, s);
  out[kState * n + i] = traced ? 1.f : 0.f;
  out[(kState + 1) * n + i] = shadow ? 1.f : 0.f;
}

__global__ void __launch_bounds__(128)
mega_path(Tables T, const float* __restrict__ in, float* __restrict__ out,
          const int* __restrict__ pixel, const int* __restrict__ samp, int n,
          uint32_t seed, int n_bounces, int max_depth, int rr_depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  State s = load_state(in, n, i);
  const uint32_t px = static_cast<uint32_t>(pixel[i]);
  const uint32_t sp = static_cast<uint32_t>(samp[i]);
  int n_traced = 0, n_shadow = 0;
  for (int b = 0; b < n_bounces && s.active > 0.5f; ++b) {
    bool traced, shadow;
    path_bounce(T, s, seed, px, sp, b, max_depth, rr_depth, traced, shadow);
    n_traced += traced;
    n_shadow += shadow;
  }
  store_state(out, n, i, s);
  out[kState * n + i] = static_cast<float>(n_traced);
  out[(kState + 1) * n + i] = static_cast<float>(n_shadow);
}

__global__ void __launch_bounds__(128)
mega_persistent(Tables T, const float* __restrict__ in,
                float* __restrict__ out, const int* __restrict__ pixel,
                const int* __restrict__ samp0, int n, uint32_t seed, int spp,
                int max_depth, int rr_depth, int iter_cap, Camera cam) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  State s = load_state(in, n, i);
  const float* c = in + i;
  int bounce = static_cast<int>(c[16 * n]);
  int done = static_cast<int>(c[17 * n]);
  V3 lsum{c[18 * n], c[19 * n], c[20 * n]};
  float iters = c[21 * n], n_traced = c[22 * n], n_shadow = c[23 * n];
  const uint32_t px = static_cast<uint32_t>(pixel[i]);
  const int s0 = samp0[i];
  for (int it = 0; it < iter_cap && s.active > 0.5f; ++it) {
    bool traced, shadow;
    path_bounce(T, s, seed, px, static_cast<uint32_t>(s0 + done), bounce,
                max_depth, rr_depth, traced, shadow);
    iters += 1.f;
    n_traced += traced ? 1.f : 0.f;
    n_shadow += shadow ? 1.f : 0.f;
    ++bounce;
    if (s.active > 0.5f) continue;
    // the path died: bank its radiance, count it, start the next sample
    lsum = V3{lsum.x + s.L.x, lsum.y + s.L.y, lsum.z + s.L.z};
    if (++done < spp) {
      camera_path(cam, seed, px, static_cast<uint32_t>(s0 + done), s);
      bounce = 0;
    }
  }
  store_state(out, n, i, s);
  float* o = out + i;
  o[16 * n] = static_cast<float>(bounce);
  o[17 * n] = static_cast<float>(done);
  o[18 * n] = lsum.x;
  o[19 * n] = lsum.y;
  o[20 * n] = lsum.z;
  o[21 * n] = iters;
  o[22 * n] = n_traced;
  o[23 * n] = n_shadow;
}

Tables make_tables(const void* woop, const void* aabb, int n_clusters,
                   const void* attr, const void* mat, const void* em_rows,
                   int et_real, const void* em_meta, const void* em_cdf,
                   int n_em) {
  return Tables{static_cast<const float4*>(woop),
                static_cast<const float*>(aabb), n_clusters,
                static_cast<const float*>(attr),
                static_cast<const float*>(mat),
                static_cast<const float*>(em_rows), et_real,
                static_cast<const float*>(em_meta),
                static_cast<const float*>(em_cdf), n_em};
}

constexpr int kThreads = 128;

}  // namespace

// C entry points (ctypes, accel/megakernel.py). Pointers are device
// pointers except `cam`, a host array of 16 floats; each launches on
// `stream` and returns the cudaError_t of the launch.
#define MEGA_TABLE_PARAMS                                                    \
  const void *woop, const void *aabb, int n_clusters, const void *attr,      \
      const void *mat, const void *em_rows, int et_real, const void *em_meta, \
      const void *em_cdf, int n_em
#define MEGA_TABLES \
  make_tables(woop, aabb, n_clusters, attr, mat, em_rows, et_real, em_meta, \
              em_cdf, n_em)

extern "C" int mitsuba_mega_bounce(MEGA_TABLE_PARAMS, const void* state_in,
                                   void* state_out, const void* pixel,
                                   const void* samp, int n, uint32_t seed,
                                   int bounce, int max_depth, int rr_depth,
                                   void* stream) {
  if (n <= 0) return 0;
  mega_bounce<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      MEGA_TABLES, static_cast<const float*>(state_in),
      static_cast<float*>(state_out), static_cast<const int*>(pixel),
      static_cast<const int*>(samp), n, seed, bounce, max_depth, rr_depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mitsuba_mega_path(MEGA_TABLE_PARAMS, const void* state_in,
                                 void* state_out, const void* pixel,
                                 const void* samp, int n, uint32_t seed,
                                 int n_bounces, int max_depth, int rr_depth,
                                 void* stream) {
  if (n <= 0) return 0;
  mega_path<<<(n + kThreads - 1) / kThreads, kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      MEGA_TABLES, static_cast<const float*>(state_in),
      static_cast<float*>(state_out), static_cast<const int*>(pixel),
      static_cast<const int*>(samp), n, seed, n_bounces, max_depth,
      rr_depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mitsuba_mega_persistent(MEGA_TABLE_PARAMS,
                                       const void* state_in, void* state_out,
                                       const void* pixel, const void* samp0,
                                       int n, uint32_t seed, int spp,
                                       int max_depth, int rr_depth,
                                       int iter_cap, const void* cam,
                                       void* stream) {
  if (n <= 0) return 0;
  Camera c;
  const float* f = static_cast<const float*>(cam);
  for (int k = 0; k < 9; ++k) c.r[k] = f[k];
  for (int k = 0; k < 3; ++k) c.pos[k] = f[9 + k];
  c.tan_half = f[12];
  c.aspect = f[13];
  c.width = f[14];
  c.height = f[15];
  mega_persistent<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      MEGA_TABLES, static_cast<const float*>(state_in),
      static_cast<float*>(state_out), static_cast<const int*>(pixel),
      static_cast<const int*>(samp0), n, seed, spp, max_depth, rr_depth,
      iter_cap, c);
  return static_cast<int>(cudaGetLastError());
}
