// Path-tracing megakernels for Hopper (sm_90a): one bounce per launch
// (mega_bounce), whole paths per lane (mega_path), and a pixel's whole
// sample loop per lane with in-kernel camera-ray regeneration
// (mega_persistent), all three over one __device__ bounce.
//
// Replaces the Pallas TPU kernels of mitsuba_tpu/accel/megakernel.py:
// make_bounce_kernel (:1395, launched by run_bounce :1511),
// make_path_kernel (:1423, run_path :1552) and make_persistent_kernel
// (:2478, run_persistent :2661), whose shared body is _bounce_rows
// (:606-1384), for surface scenes: pinhole camera, flat or smooth shading
// normals, the 14 leaf BSDF families of bsdf_common.cuh with the
// two-sided adapter, and area emitters, without composites, medium or
// textures.
//
// Design: one thread per lane. The path state lives in registers for the
// whole launch; scene tables (per-triangle attributes, materials, emitter
// rows) are gathered per thread through the read-only cache, and both
// traces of a bounce are the trace kernel's own warp walk
// (trace_common.cuh trace_ray_warp: per-lane slab gates, a cluster that
// few lanes enter scanned by the whole warp one ray at a time, the walk
// stopping at the last real triangle; each kernel is a template on
// whether the walk is cooperative, and the launch picks the
// instantiation by coop_walk), so hits are those of trace_kernel
// and of the plain intersector, bit for bit. The warp walk needs all 32
// lanes at each call: the kernels keep their warps whole (a lane past n,
// or whose path or whose spp are done, runs along with nothing to trace)
// and loop until no lane of the warp has work left. A lane whose path is
// dead on entry to a bounce leaves it unchanged, as the plain version
// (MegaPlainTracer.bounce) does, so mega_path can stop each lane at its
// own last bounce. The persistent kernel banks a dead path's L, counts
// it, and regenerates a camera ray for the next sample until the
// lane has finished `spp` paths.
//
// What bounds it on the H100: fp32 instruction throughput and warp
// divergence, not bytes. A bounce is two traces of ~40 fp32 ops per
// triangle test plus ~300 ops of shading, against a few hundred bytes of
// table that every lane of a warp reads from L1; lanes at different
// bounces trace rays that diverge, which the warp walk's cooperative
// branch answers (trace_common.cuh); paths of a warp die at
// different bounces, so lanes idle while the warp's longest path runs,
// and lanes of one warp that hit different materials run their families'
// branches one after another. The persistent kernel answers
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

#include "bsdf_common.cuh"
#include "path_common.cuh"
#include "trace_common.cuh"

namespace {

using namespace mitsuba_path;
using mitsuba_bsdf::BsdfSample;
using mitsuba_bsdf::bsdf_eval_pdf;
using mitsuba_bsdf::bsdf_sample;
using mitsuba_walk::Hit;
using mitsuba_walk::kMiss;
using mitsuba_walk::Ray;
using mitsuba_walk::trace_ray_warp;

constexpr int kState = 16;    // rows of the bounce state
constexpr int kPState = 24;   // rows of the persistent state
constexpr int kAttr = 25;     // per-triangle attribute row
constexpr int kMat = 69;      // material row (accel/megakernel.py N_MAT)
constexpr int kEmRow = 24;    // emissive-triangle row
constexpr int kEmMeta = 16;   // emitter row
constexpr uint32_t kSensorDims = 4, kDimsPerBounce = 8;
constexpr uint32_t kDimNeeSel = 0, kDimNeePos = 1, kDimBsdfU2 = 2;
constexpr uint32_t kDimBsdfU1 = 3, kDimRR = 4, kDimPixel = 0;

struct Tables {
  const float4* woop;     // [C, 3*64] Woop rows (trace_common.cuh)
  const float* aabb;      // [C, 8] cluster boxes
  int tris;               // triangles the walk covers (walk_tris)
  const float* attr;      // [T, 25]
  const float* mat;       // [M, 69]
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

// What a bounce carries from its closest hit across the shadow trace.
struct Vertex {
  V3 p, ng, ns, fs, ft, wi;
  const float* M;           // the hit's material row
  float fsign, wiz;         // the two-sided flip and the flipped wi.z
  bool hit;
  DirectSample ds;          // the NEE sample toward a light
  float f[3], pdf_fwd;      // the BSDF toward it
  V3 so;                    // its shadow ray's origin (when traced)
  bool shadow, contributes;  // NEE attempted; its shadow ray traced
};

// The bounce up to its shadow ray, for an active lane: the hit record
// (accel/dense.py fill_intersection), the emitter hit, the NEE sample and
// the BSDF toward it.
__device__ __forceinline__ Vertex bounce_front(const Tables& T, State& s,
                                               const Hit& h, uint32_t seed,
                                               uint32_t pixel, uint32_t samp,
                                               int bounce, int max_depth) {
  Vertex v;
  const uint32_t dim = kSensorDims + static_cast<uint32_t>(bounce)
                       * kDimsPerBounce;
  v.hit = h.found;
  const float* A = T.attr + (v.hit ? h.tri : 0) * kAttr;
  v.ng = row3(A);
  const V3 vn0 = row3(A + 5), dv1 = row3(A + 8), dv2 = row3(A + 11);
  const V3 vn1{vn0.x + dv1.x, vn0.y + dv1.y, vn0.z + dv1.z};
  const V3 vn2{vn0.x + dv2.x, vn0.y + dv2.y, vn0.z + dv2.z};
  const float b0 = (1.f - h.u) - h.v;
  V3 ns{(vn0.x * b0 + vn1.x * h.u) + vn2.x * h.v,
        (vn0.y * b0 + vn1.y * h.u) + vn2.y * h.v,
        (vn0.z * b0 + vn1.z * h.u) + vn2.z * h.v};
  const float inv_len = rsqrtf(clamp_min(dot3(ns, ns), F32(1e-20)));
  v.ns = V3{ns.x * inv_len, ns.y * inv_len, ns.z * inv_len};
  const int mat_id = v.hit ? static_cast<int>(__ldg(A + 3)) : -1;
  const int em_id = v.hit ? static_cast<int>(__ldg(A + 4)) : -1;
  const float t_safe = v.hit ? h.t : 1.f;
  v.p = V3{s.o.x + t_safe * s.d.x, s.o.y + t_safe * s.d.y,
           s.o.z + t_safe * s.d.z};

  // ---- emitter hit on a surface (eval_area, pdf_direct_area) ----------
  if (v.hit) {
    const float cos_surf = -dot3(s.d, v.ng);
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
  v.M = T.mat + max(mat_id, 0) * kMat;
  coordinate_system(v.ns, v.fs, v.ft);
  v.wi = to_local(v.fs, v.ft, v.ns, V3{-s.d.x, -s.d.y, -s.d.z});
  // the two-sided adapter mirrors back-side incidence into z > 0; the
  // light direction's z and the sampled direction's z follow it
  v.fsign = __ldg(v.M + 15) > 0.5f && v.wi.z < 0.f ? -1.f : 1.f;
  v.wiz = v.wi.z * v.fsign;

  // ---- next-event estimation ------------------------------------------
  const bool nee_allowed = v.hit && depth + 1 <= max_depth + 1;
  const float u_sel = rng2(seed, pixel, dim + kDimNeeSel, samp).x;
  const float2 u_pos = rng2(seed, pixel, dim + kDimNeePos, samp);
  v.ds = sample_direct(T, v.p, u_sel, u_pos);
  v.shadow = nee_allowed && v.ds.pdf > 0.f;
  const V3 wo = to_local(v.fs, v.ft, v.ns, v.ds.d);
  bsdf_eval_pdf<true>(v.M, v.wi.x, v.wi.y, v.wiz, wo.x, wo.y,
                      wo.z * v.fsign, v.f, v.pdf_fwd);
  v.contributes = v.shadow && (v.f[0] > 0.f || v.f[1] > 0.f || v.f[2] > 0.f);
  // shadow ray over [eps, dist * (1 - ShadowEpsilon)] (scene.cpp:846)
  v.so = v.contributes ? offset_ray_origin(v.p, v.ng, v.ds.d) : v.p;
  return v;
}

// The bounce after its shadow ray, for an active lane: NEE's radiance
// unless occluded, BSDF sampling into the next ray, Russian roulette.
__device__ __forceinline__ void bounce_back(const Vertex& v, bool occluded,
                                            State& s, uint32_t seed,
                                            uint32_t pixel, uint32_t samp,
                                            int bounce, int max_depth,
                                            int rr_depth) {
  const uint32_t dim = kSensorDims + static_cast<uint32_t>(bounce)
                       * kDimsPerBounce;
  const int depth = bounce + 2;
  if (v.contributes && !occluded) {
    const float w = mis_power(v.ds.pdf, v.pdf_fwd);
    s.L = V3{s.L.x + ((s.tp.x * v.ds.value.x) * v.f[0]) * w,
             s.L.y + ((s.tp.y * v.ds.value.y) * v.f[1]) * w,
             s.L.z + ((s.tp.z * v.ds.value.z) * v.f[2]) * w};
  }

  // ---- BSDF sampling → next ray ------------------------------------------
  const float2 ub = rng2(seed, pixel, dim + kDimBsdfU2, samp);
  const float uc = rng2(seed, pixel, dim + kDimBsdfU1, samp).x;
  const BsdfSample bs = bsdf_sample<true>(v.M, v.wi.x, v.wi.y, v.wiz, ub.x,
                                          ub.y, uc);
  const V3 wn{bs.wo[0], bs.wo[1], bs.wo[2] * v.fsign};   // un-flip
  const V3 fs = v.fs, ft = v.ft, ns = v.ns;
  const V3 d_next{(fs.x * wn.x + ft.x * wn.y) + ns.x * wn.z,
                  (fs.y * wn.x + ft.y * wn.y) + ns.y * wn.z,
                  (fs.z * wn.x + ft.z * wn.y) + ns.z * wn.z};
  const V3 o_next = offset_ray_origin(v.p, v.ng, d_next);
  V3 tn{s.tp.x * bs.w[0], s.tp.y * bs.w[1], s.tp.z * bs.w[2]};
  bool alive = v.hit && bs.pdf > 0.f && any_pos(tn) && depth <= max_depth;

  // ---- Russian roulette (path.cpp:278-289) ------------------------------
  s.eta = s.eta * bs.eta;
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
  s.prev_pdf = bs.delta ? 1.f : bs.pdf;
  s.prev_delta = bs.delta ? 1.f : 0.f;
}

// One bounce of accel/megakernel.py MegaPlainTracer.bounce. All 32 lanes
// of a warp call it together, because its two traces are warp walks: the
// closest hit for the active lanes, the shadow ray for the lanes whose
// NEE contributes. A lane inactive on entry is left unchanged. traced:
// this lane traced a closest-hit ray; shadow: it attempted a shadow ray.
// kCoop: mitsuba_walk::coop_walk, which the launch picks.
template <bool kCoop>
__device__ __forceinline__ void path_bounce(const Tables& T, State& s,
                                            uint32_t seed, uint32_t pixel,
                                            uint32_t samp, int bounce,
                                            int max_depth, int rr_depth,
                                            bool& traced, bool& shadow) {
  const bool active = s.active > 0.5f;
  const Hit h = trace_ray_warp<false, kCoop>(
      T.woop, T.aabb, T.tris, active,
      Ray{s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z, ray_mint(s.o), kMiss});
  Vertex v{};
  if (active) v = bounce_front(T, s, h, seed, pixel, samp, bounce, max_depth);
  const bool occluded = trace_ray_warp<true, kCoop>(
      T.woop, T.aabb, T.tris, v.contributes,
      Ray{v.so.x, v.so.y, v.so.z, v.ds.d.x, v.ds.d.y, v.ds.d.z,
          ray_mint(v.so), v.ds.dist * F32(1.0 - 1e-3)}).found;
  if (active) bounce_back(v, occluded, s, seed, pixel, samp, bounce,
                          max_depth, rr_depth);
  traced = active;
  shadow = v.shadow;
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

// The kernels run whole warps: a lane past n (the ragged last warp) takes
// part in the warp walks with an inactive path and stores nothing. Their
// launch bounds ask for four blocks an SM: at most 128 registers a thread,
// so all 512 blocks of a 256² launch are resident at once (132 SMs), and
// ptxas does not trade spills for a higher occupancy (it spilled in
// mega_bounce's SIMT-walk build when the bound named threads alone).
template <bool kCoop>
__global__ void __launch_bounds__(128, 4)
mega_bounce(Tables T, const float* __restrict__ in, float* __restrict__ out,
            const int* __restrict__ pixel, const int* __restrict__ samp,
            int n, uint32_t seed, int bounce, int max_depth, int rr_depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < n;
  State s{};
  if (lane_ok) s = load_state(in, n, i);
  bool traced, shadow;
  path_bounce<kCoop>(T, s, seed,
                     lane_ok ? static_cast<uint32_t>(pixel[i]) : 0u,
                     lane_ok ? static_cast<uint32_t>(samp[i]) : 0u, bounce,
                     max_depth, rr_depth, traced, shadow);
  if (!lane_ok) return;
  store_state(out, n, i, s);
  out[kState * n + i] = traced ? 1.f : 0.f;
  out[(kState + 1) * n + i] = shadow ? 1.f : 0.f;
}

template <bool kCoop>
__global__ void __launch_bounds__(128, 4)
mega_path(Tables T, const float* __restrict__ in, float* __restrict__ out,
          const int* __restrict__ pixel, const int* __restrict__ samp, int n,
          uint32_t seed, int n_bounces, int max_depth, int rr_depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < n;
  State s{};
  if (lane_ok) s = load_state(in, n, i);
  const uint32_t px = lane_ok ? static_cast<uint32_t>(pixel[i]) : 0u;
  const uint32_t sp = lane_ok ? static_cast<uint32_t>(samp[i]) : 0u;
  int n_traced = 0, n_shadow = 0;
  // until every path of the warp has died: a dead lane's bounce leaves it
  // unchanged and counts nothing
  for (int b = 0; __any_sync(mitsuba_walk::kFullMask,
                             b < n_bounces && s.active > 0.5f); ++b) {
    bool traced, shadow;
    path_bounce<kCoop>(T, s, seed, px, sp, b, max_depth, rr_depth, traced,
                       shadow);
    n_traced += traced;
    n_shadow += shadow;
  }
  if (!lane_ok) return;
  store_state(out, n, i, s);
  out[kState * n + i] = static_cast<float>(n_traced);
  out[(kState + 1) * n + i] = static_cast<float>(n_shadow);
}

template <bool kCoop>
__global__ void __launch_bounds__(128, 4)
mega_persistent(Tables T, const float* __restrict__ in,
                float* __restrict__ out, const int* __restrict__ pixel,
                const int* __restrict__ samp0, int n, uint32_t seed, int spp,
                int max_depth, int rr_depth, int iter_cap, Camera cam) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < n;
  State s{};
  int bounce = 0, done = 0, s0 = 0;
  V3 lsum{0.f, 0.f, 0.f};
  float iters = 0.f, n_traced = 0.f, n_shadow = 0.f;
  uint32_t px = 0;
  if (lane_ok) {
    s = load_state(in, n, i);
    const float* c = in + i;
    bounce = static_cast<int>(c[16 * n]);
    done = static_cast<int>(c[17 * n]);
    lsum = V3{c[18 * n], c[19 * n], c[20 * n]};
    iters = c[21 * n];
    n_traced = c[22 * n];
    n_shadow = c[23 * n];
    px = static_cast<uint32_t>(pixel[i]);
    s0 = samp0[i];
  }
  // until every lane of the warp has finished its spp: a finished lane
  // runs its (dead) bounce with the warp and changes nothing
  for (int it = 0; __any_sync(mitsuba_walk::kFullMask,
                              it < iter_cap && s.active > 0.5f); ++it) {
    const bool running = s.active > 0.5f;
    bool traced, shadow;
    path_bounce<kCoop>(T, s, seed, px, static_cast<uint32_t>(s0 + done),
                       bounce, max_depth, rr_depth, traced, shadow);
    if (!running) continue;
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
  if (!lane_ok) return;
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
                   int n_tris, const void* attr, const void* mat,
                   const void* em_rows, int et_real, const void* em_meta,
                   const void* em_cdf, int n_em) {
  return Tables{static_cast<const float4*>(woop),
                static_cast<const float*>(aabb),
                mitsuba_walk::walk_tris(n_tris, n_clusters),
                static_cast<const float*>(attr),
                static_cast<const float*>(mat),
                static_cast<const float*>(em_rows), et_real,
                static_cast<const float*>(em_meta),
                static_cast<const float*>(em_cdf), n_em};
}

constexpr int kThreads = 128;

}  // namespace

// C entry points (ctypes, accel/megakernel.py). Pointers are device
// pointers except `cam`, a host array of 16 floats; n_tris is the count
// of real triangles (the table's padding follows them); each launches on
// `stream` and returns the cudaError_t of the launch.
#define MEGA_TABLE_PARAMS                                                     \
  const void *woop, const void *aabb, int n_clusters, int n_tris,             \
      const void *attr, const void *mat, const void *em_rows, int et_real,    \
      const void *em_meta, const void *em_cdf, int n_em
#define MEGA_TABLES                                                          \
  make_tables(woop, aabb, n_clusters, n_tris, attr, mat, em_rows, et_real,   \
              em_meta, em_cdf, n_em)
// the instantiation of `kernel` for the walk coop_walk picks
#define MEGA_WALK(kernel, tables)                                            \
  (mitsuba_walk::coop_walk((tables).tris) ? kernel<true> : kernel<false>)

extern "C" int mitsuba_mega_bounce(MEGA_TABLE_PARAMS, const void* state_in,
                                   void* state_out, const void* pixel,
                                   const void* samp, int n, uint32_t seed,
                                   int bounce, int max_depth, int rr_depth,
                                   void* stream) {
  if (n <= 0) return 0;
  const Tables T = MEGA_TABLES;
  const auto kernel = MEGA_WALK(mega_bounce, T);
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      T, static_cast<const float*>(state_in),
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
  const Tables T = MEGA_TABLES;
  const auto kernel = MEGA_WALK(mega_path, T);
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      T, static_cast<const float*>(state_in),
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
  const Tables T = MEGA_TABLES;
  const auto kernel = MEGA_WALK(mega_persistent, T);
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      T, static_cast<const float*>(state_in),
      static_cast<float*>(state_out), static_cast<const int*>(pixel),
      static_cast<const int*>(samp0), n, seed, spp, max_depth, rr_depth,
      iter_cap, c);
  return static_cast<int>(cudaGetLastError());
}
