// The path bounce shared by the path megakernels (megakernel.cu) and the
// ablation probe (ablate.cu): the scene tables and the lane's path state,
// the bounce before and after its shadow ray (bounce_front, bounce_back)
// and the whole bounce over a policy for its two traces (path_bounce,
// WarpTraces), the state's [16, N] layout in device memory (load_state,
// store_state) and the tables from the C entry points' arguments
// (make_tables). megakernel.cu's header comment sets out the design and
// the arithmetic; everything here is compiled with -fmad=false.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bsdf_common.cuh"
#include "path_common.cuh"
#include "trace_common.cuh"

namespace mitsuba_mega {

using namespace mitsuba_path;
using mitsuba_bsdf::BsdfSample;
using mitsuba_bsdf::bsdf_eval_pdf;
using mitsuba_bsdf::bsdf_sample;
using mitsuba_walk::Hit;
using mitsuba_walk::kMiss;
using mitsuba_walk::Ray;
using mitsuba_walk::trace_ray_warp;

constexpr int kState = 16;    // rows of the bounce state
constexpr int kAttr = 25;     // per-triangle attribute row
constexpr int kMat = 69;      // material row (accel/megakernel.py N_MAT)
constexpr int kTexRow = 24;   // its procedural-texture columns (TEXROW)
constexpr int kEmRow = 24;    // emissive-triangle row
constexpr int kEmMeta = 16;   // emitter row
constexpr uint32_t kSensorDims = 4, kDimsPerBounce = 8;
constexpr uint32_t kDimNeeSel = 0, kDimNeePos = 1, kDimBsdfU2 = 2;
constexpr uint32_t kDimBsdfU1 = 3, kDimRR = 4, kDimPixel = 0;
constexpr uint32_t kDimMedium = 5, kDimPhase = 6;
constexpr uint32_t kDimAperture = 1;
// emitter type codes (scene/scene.py)
constexpr float kEmArea = 0.f, kEmPoint = 1.f, kEmConstant = 2.f;
constexpr float kEmDirectional = 4.f, kEmSpot = 5.f;
constexpr float kEnvDist = 1e30f;    // emitter.py ENV_DIST

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
  int env;                // the constant environment's emitter row, or -1
  bool med;               // a homogeneous medium fills the scene
  V3 med_st, med_al;      // its σt and albedo rgb
  float med_g, med_bound;  // HG asymmetry, extent along a ray
};

struct State {
  V3 o, d, tp, L;
  float active, prev_pdf, prev_delta, eta;
};

// emitter/emitter.py sample_direct: area emitters, and under kExt the
// point, spot, directional and constant ones
struct DirectSample {
  V3 d, value;
  float dist, pdf;
  bool delta;             // point, spot or directional: MIS weight 1
};

// A delta emitter's value, radiance / pmf, zero where the pmf is not > 0
__device__ __forceinline__ V3 delta_value(V3 rad, float pmf) {
  const float p = clamp_min(pmf, F32(1e-12));
  return pmf > 0.f ? V3{rad.x / p, rad.y / p, rad.z / p} : V3{0.f, 0.f, 0.f};
}

template <bool kExt>
__device__ __forceinline__ DirectSample sample_direct(const Tables& T, V3 p,
                                                      float u_sel, float2 u2) {
  DirectSample ds{V3{0.f, 0.f, 1.f}, V3{0.f, 0.f, 0.f}, 0.f, 0.f, false};
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
  if (kExt) {
    const float type = __ldg(meta + 2);
    const V3 rad = row3(meta + 3), pos = row3(meta + 8);
    if (type == kEmPoint || type == kEmSpot) {
      const V3 tp{pos.x - p.x, pos.y - p.y, pos.z - p.z};
      const float pd2 = clamp_min(dot3(tp, tp), F32(1e-12));
      ds.dist = sqrtf(pd2);
      ds.d = V3{tp.x / ds.dist, tp.y / ds.dist, tp.z / ds.dist};
      V3 val{rad.x / pd2, rad.y / pd2, rad.z / pd2};
      if (type == kEmSpot) {   // linear falloff from beam width to cutoff
        const float cos_cut = __ldg(meta + 14);
        const float cos_ang = dot3(row3(meta + 11),
                                   V3{-ds.d.x, -ds.d.y, -ds.d.z});
        const float fall = clamp_max(clamp_min(
            (cos_ang - cos_cut)
            / clamp_min(__ldg(meta + 15) - cos_cut, F32(1e-6)), 0.f), 1.f);
        val = V3{val.x * fall, val.y * fall, val.z * fall};
      }
      ds.value = delta_value(val, pmf);
      ds.pdf = pmf;
      ds.delta = true;
      return ds;
    }
    if (type == kEmDirectional) {
      ds.d = V3{-pos.x, -pos.y, -pos.z};
      ds.dist = kEnvDist;
      ds.value = delta_value(rad, pmf);
      ds.pdf = pmf;
      ds.delta = true;
      return ds;
    }
    if (type == kEmConstant) {   // the uniform sphere
      ds.d = uniform_sphere(u2.x, u2.y);
      ds.dist = kEnvDist;
      ds.pdf = F32(1.0 / (4.0 * kPi)) * pmf;
      if (ds.pdf > 0.f)
        ds.value = V3{safe_div(rad.x, ds.pdf), safe_div(rad.y, ds.pdf),
                      safe_div(rad.z, ds.pdf)};
      return ds;
    }
  }
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

// ---- the homogeneous medium (accel/megakernel.py medium_segment,
// hg_value, hg_sample_kernel) ----------------------------------------------

// Tr = exp(-min(σt·d, 80)) per channel
__device__ __forceinline__ V3 med_tr(V3 st, float d) {
  return V3{expf(-clamp_max(st.x * d, 80.f)), expf(-clamp_max(st.y * d, 80.f)),
            expf(-clamp_max(st.z * d, 80.f))};
}

// The HG value at cos = -(d·wo): (1/4π)(1 - g²) / (den·sqrt(den))
__device__ __forceinline__ float hg_value(float g, float cos) {
  const float den = clamp_min((2.f * g) * cos + (1.f + g * g), F32(1e-8));
  return (F32(1.0 / (4.0 * kPi)) * (1.f - g * g)) / (den * sqrtf(den));
}

// The HG continuation about d: the exact inverse CDF (1 - 2u below
// |g| = 1e-4), the direction in coordinate_system(d)'s frame, its pdf.
__device__ __forceinline__ V3 hg_sample(float g, V3 d, float2 u, float& pdf) {
  float cos_t;
  if (static_cast<double>(fabsf(g)) < 1e-4) {
    cos_t = 1.f - 2.f * u.x;
  } else {
    const float sqr = (1.f - g * g) / ((2.f * g) * u.x + (1.f - g));
    cos_t = ((1.f + g * g) - sqr * sqr) / (2.f * g);
  }
  cos_t = clamp_max(clamp_min(cos_t, -1.f), 1.f);
  const float sin_t = sqrtf(clamp_min(1.f - cos_t * cos_t, 0.f));
  const float phi = F32(2.0 * kPi) * u.y;
  V3 s, t;
  coordinate_system(d, s, t);
  const float sc = sin_t * cosf(phi), ss = sin_t * sinf(phi);
  const V3 wo{(sc * s.x + ss * t.x) + cos_t * d.x,
              (sc * s.y + ss * t.y) + cos_t * d.y,
              (sc * s.z + ss * t.z) + cos_t * d.z};
  pdf = hg_value(g, -((d.x * wo.x + d.y * wo.y) + d.z * wo.z));
  return wo;
}

// ---- the procedural albedo (accel/megakernel.py proc_albedo) ------------

// 1 where the texel at (xw, yw) of the rasterized checker or grid holds
// color0, else 0: the cell's parity, or the grid-line test (rounding half
// to even, as torch.round)
__device__ __forceinline__ float proc_c0_weight(bool grid, float xw, float yw,
                                                float tres, float ttil,
                                                float lw) {
  if (grid) {
    const float ax = ((xw + 0.5f) / tres) * ttil;
    const float ay = ((yw + 0.5f) / tres) * ttil;
    return fabsf(ax - rintf(ax)) < lw || fabsf(ay - rintf(ay)) < lw ? 1.f
                                                                    : 0.f;
  }
  const float cxy = floorf((xw * ttil) / tres) + floorf((yw * ttil) / tres);
  return 1.f - (cxy - 2.f * floorf(cxy * 0.5f));
}

// The bilinear checker or grid albedo of material row m at (u, v): the
// level-0 lookup of the rasterized bitmap (texel centres at -0.5, v
// flipped, repeat wrap) with proc_c0_weight in place of each corner's
// texel
__device__ __forceinline__ void proc_albedo(const float* m, float u, float v,
                                            float alb[3]) {
  const float* t = m + kTexRow;
  const float tres = clamp_min(__ldg(t + 7), 1.f);
  const float ttil = clamp_min(__ldg(t + 8), 1.f);
  const float lw = __ldg(t + 9) * ttil;
  const bool grid = __ldg(t) == 1.f;
  const float fx = u * tres - 0.5f;
  const float fy = (1.f - v) * tres - 0.5f;
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float tx = fx - x0, ty = fy - y0;
  const float x1 = x0 + 1.f, y1 = y0 + 1.f;
  const float xw0 = x0 - floorf(x0 / tres) * tres;
  const float xw1 = x1 - floorf(x1 / tres) * tres;
  const float yw0 = y0 - floorf(y0 / tres) * tres;
  const float yw1 = y1 - floorf(y1 / tres) * tres;
  const float s0w =
      (((proc_c0_weight(grid, xw0, yw0, tres, ttil, lw) * (1.f - tx))
        * (1.f - ty)
        + (proc_c0_weight(grid, xw1, yw0, tres, ttil, lw) * tx) * (1.f - ty))
       + (proc_c0_weight(grid, xw0, yw1, tres, ttil, lw) * (1.f - tx)) * ty)
      + (proc_c0_weight(grid, xw1, yw1, tres, ttil, lw) * tx) * ty;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    alb[ch] = __ldg(t + 1 + ch) * s0w + __ldg(t + 4 + ch) * (1.f - s0w);
}

// What a bounce carries from its closest hit across the shadow trace.
// (Under kExt M may be a composite, whose children the helpers of
// bsdf_common.cuh read from the table.)
struct Vertex {
  V3 p, ng, ns, fs, ft, wi;
  const float* M;           // the hit's material row
  float fsign, wiz;         // the two-sided flip and the flipped wi.z
  bool hit;                 // the ray hit a surface
  bool in_med;              // it scattered in the medium before it
  V3 pe;                    // the scatter point (in_med)
  DirectSample ds;          // the NEE sample toward a light
  float f[3], pdf_fwd;      // the BSDF toward it
  V3 so;                    // its shadow ray's origin (when traced)
  bool shadow, contributes;  // NEE attempted; its shadow ray traced
};

// The bounce up to its shadow ray, for an active lane: the hit record
// (accel/dense.py fill_intersection), row h.tri of `attr` (row 0 on a
// miss), the emitter hit, the NEE sample and the BSDF toward it. Mt: room
// for a material row (kTex), which a procedurally textured lane fills and
// shades with. max_depth <= 0: the path is unbounded.
template <bool kExt, bool kTex>
__device__ __forceinline__ Vertex bounce_front(const Tables& T,
                                               const float* attr, State& s,
                                               const Hit& h, uint32_t seed,
                                               uint32_t pixel, uint32_t samp,
                                               int bounce, int max_depth,
                                               float* Mt) {
  Vertex v;
  const uint32_t dim = kSensorDims + static_cast<uint32_t>(bounce)
                       * kDimsPerBounce;
  v.hit = h.found;
  const float* A = attr + (v.hit ? h.tri : 0) * kAttr;
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

  // ---- the medium: balance distance sampling over the segment to the
  // surface; the throughput takes σs·Tr(t)/pdfSuccess where the lane
  // scatters, Tr(ts)/pdfFailure where it does not ---------------------------
  v.in_med = false;
  if (kExt && T.med) {
    const float2 um = rng2(seed, pixel, dim + kDimMedium, samp);
    const V3 st = T.med_st;
    const int ch = min(static_cast<int>(um.x * 3.f), 2);
    const float sig_c = clamp_min(ch == 0 ? st.x : (ch == 1 ? st.y : st.z),
                                  F32(1e-8));
    const float t =
        -log1pf(-clamp_max(clamp_min(um.y, 0.f), F32(1.0 - 1e-7))) / sig_c;
    const float seg = clamp_max(v.hit ? h.t : 1e30f, T.med_bound);
    v.in_med = t < seg;
    const V3 tt = med_tr(st, t), ts = med_tr(st, seg);
    const float third = F32(1.0 / 3.0);
    const float pdf_succ = clamp_min(
        ((st.x * tt.x + st.y * tt.y) + st.z * tt.z) * third, F32(1e-20));
    const float pdf_fail = clamp_min(((ts.x + ts.y) + ts.z) * third,
                                     F32(1e-20));
    const float imf = v.in_med ? 1.f : 0.f;
    const V3 al = T.med_al;
    s.tp = V3{s.tp.x * (imf * (((st.x * al.x) * tt.x) / pdf_succ)
                        + (1.f - imf) * (ts.x / pdf_fail)),
              s.tp.y * (imf * (((st.y * al.y) * tt.y) / pdf_succ)
                        + (1.f - imf) * (ts.y / pdf_fail)),
              s.tp.z * (imf * (((st.z * al.z) * tt.z) / pdf_succ)
                        + (1.f - imf) * (ts.z / pdf_fail))};
    v.pe = V3{s.o.x + t * s.d.x, s.o.y + t * s.d.y, s.o.z + t * s.d.z};
  }
  const bool surf = v.hit && !v.in_med;   // a surface event

  // ---- an escaped ray sees the constant environment (eval_env,
  // pdf_direct_env) ------------------------------------------------------
  if (kExt && !v.hit && !v.in_med && T.env >= 0) {
    const float* env = T.em_meta + T.env * kEmMeta;
    const float pdf_env = F32(1.0 / (4.0 * kPi)) * __ldg(env + 1);
    const float w = s.prev_delta > 0.5f ? 1.f : mis_power(s.prev_pdf, pdf_env);
    const V3 le = row3(env + 3);
    s.L = V3{s.L.x + (s.tp.x * le.x) * w, s.L.y + (s.tp.y * le.y) * w,
             s.L.z + (s.tp.z * le.z) * w};
  }

  // ---- emitter hit on a surface (eval_area, pdf_direct_area) ----------
  if (surf) {
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
  // ---- the procedural albedo at the hit's uv (the corners rebuilt as
  // uv0 + Δ and interpolated as the shading normal is), into columns 0-2
  // of a copy of the row: its leaf columns, and a rough plastic's
  // transmittance rows ----------------------------------------------------
  if (kTex && __ldg(v.M + kTexRow) >= 0.f) {
    const float u0 = __ldg(A + 19), w0 = __ldg(A + 20);
    float alb[3];
    proc_albedo(v.M,
                (u0 * b0 + (u0 + __ldg(A + 21)) * h.u)
                    + (u0 + __ldg(A + 23)) * h.v,
                (w0 * b0 + (w0 + __ldg(A + 22)) * h.u)
                    + (w0 + __ldg(A + 24)) * h.v,
                alb);
    for (int j = 3; j < kTexRow; ++j) Mt[j] = __ldg(v.M + j);
    if (Mt[12] == mitsuba_bsdf::kMatRoughPlastic)
      for (int j = mitsuba_bsdf::kRtRow; j < kMat; ++j)
        Mt[j] = __ldg(v.M + j);
    Mt[0] = alb[0];
    Mt[1] = alb[1];
    Mt[2] = alb[2];
    v.M = Mt;
  }
  coordinate_system(v.ns, v.fs, v.ft);
  v.wi = to_local(v.fs, v.ft, v.ns, V3{-s.d.x, -s.d.y, -s.d.z});
  // the two-sided adapter mirrors back-side incidence into z > 0; the
  // light direction's z and the sampled direction's z follow it (under
  // kTex the row may be the copy: a plain load)
  v.fsign = (kTex ? v.M[15] : __ldg(v.M + 15)) > 0.5f && v.wi.z < 0.f
                ? -1.f : 1.f;
  v.wiz = v.wi.z * v.fsign;

  // ---- next-event estimation from the event point (the scatter point
  // or the hit) -------------------------------------------------------------
  const bool nee_allowed = (v.hit || v.in_med)
                           && (max_depth <= 0 || depth + 1 <= max_depth + 1);
  const float u_sel = rng2(seed, pixel, dim + kDimNeeSel, samp).x;
  const float2 u_pos = rng2(seed, pixel, dim + kDimNeePos, samp);
  v.ds = sample_direct<kExt>(T, v.in_med ? v.pe : v.p, u_sel, u_pos);
  v.shadow = nee_allowed && v.ds.pdf > 0.f;
  if (kExt && v.in_med) {     // the phase function toward the light
    const V3 l = v.ds.d;
    v.f[0] = v.f[1] = v.f[2] = v.pdf_fwd =
        hg_value(T.med_g, -((s.d.x * l.x + s.d.y * l.y) + s.d.z * l.z));
  } else {
    const V3 wo = to_local(v.fs, v.ft, v.ns, v.ds.d);
    if (kExt)
      mitsuba_bsdf::mat_eval(T.mat, kMat, v.M, v.wi.x, v.wi.y, v.wiz, wo.x,
                             wo.y, wo.z * v.fsign, v.f, v.pdf_fwd);
    else
      bsdf_eval_pdf<true>(v.M, v.wi.x, v.wi.y, v.wiz, wo.x, wo.y,
                          wo.z * v.fsign, v.f, v.pdf_fwd);
  }
  v.contributes = v.shadow && (v.f[0] > 0.f || v.f[1] > 0.f || v.f[2] > 0.f);
  // shadow ray over [eps, dist * (1 - ShadowEpsilon)] (scene.cpp:846), from
  // the scatter point itself in the medium
  v.so = !v.contributes ? v.p
         : (v.in_med ? v.pe : offset_ray_origin(v.p, v.ng, v.ds.d));
  return v;
}

// The bounce after its shadow ray, for an active lane: NEE's radiance
// unless occluded (a delta emitter's with MIS weight 1), BSDF sampling
// into the next ray, Russian roulette. max_depth <= 0: unbounded.
template <bool kExt>
__device__ __forceinline__ void bounce_back(const Tables& T, const Vertex& v,
                                            bool occluded,
                                            State& s, uint32_t seed,
                                            uint32_t pixel, uint32_t samp,
                                            int bounce, int max_depth,
                                            int rr_depth) {
  const uint32_t dim = kSensorDims + static_cast<uint32_t>(bounce)
                       * kDimsPerBounce;
  const int depth = bounce + 2;
  if (v.contributes && !occluded) {
    const float w = kExt && v.ds.delta ? 1.f
                                       : mis_power(v.ds.pdf, v.pdf_fwd);
    V3 c{(s.tp.x * v.ds.value.x) * v.f[0], (s.tp.y * v.ds.value.y) * v.f[1],
         (s.tp.z * v.ds.value.z) * v.f[2]};
    if (kExt && T.med) {   // the medium's transmittance over min(d, bound)
      const V3 tr = med_tr(T.med_st, clamp_max(v.ds.dist, T.med_bound));
      c = V3{c.x * tr.x, c.y * tr.y, c.z * tr.z};
    }
    s.L = V3{s.L.x + c.x * w, s.L.y + c.y * w, s.L.z + c.z * w};
  }

  // ---- continuation: BSDF sampling, or HG in the medium -------------------
  BsdfSample bs;
  V3 d_next, o_next;
  if (kExt && v.in_med) {   // from the scatter point; weight eval/pdf = 1
    d_next = hg_sample(T.med_g, s.d, rng2(seed, pixel, dim + kDimPhase, samp),
                       bs.pdf);
    o_next = v.pe;
    bs.w[0] = bs.w[1] = bs.w[2] = bs.eta = 1.f;
    bs.delta = false;
  } else {
    const float2 ub = rng2(seed, pixel, dim + kDimBsdfU2, samp);
    const float uc = rng2(seed, pixel, dim + kDimBsdfU1, samp).x;
    bs = kExt ? mitsuba_bsdf::mat_sample(T.mat, kMat, v.M, v.wi.x, v.wi.y,
                                         v.wiz, ub.x, ub.y, uc)
              : bsdf_sample<true>(v.M, v.wi.x, v.wi.y, v.wiz, ub.x, ub.y, uc);
    const V3 wn{bs.wo[0], bs.wo[1], bs.wo[2] * v.fsign};   // un-flip
    const V3 fs = v.fs, ft = v.ft, ns = v.ns;
    d_next = V3{(fs.x * wn.x + ft.x * wn.y) + ns.x * wn.z,
                (fs.y * wn.x + ft.y * wn.y) + ns.y * wn.z,
                (fs.z * wn.x + ft.z * wn.y) + ns.z * wn.z};
    o_next = offset_ray_origin(v.p, v.ng, d_next);
  }
  V3 tn{s.tp.x * bs.w[0], s.tp.y * bs.w[1], s.tp.z * bs.w[2]};
  bool alive = (v.hit || v.in_med) && bs.pdf > 0.f && any_pos(tn)
               && (max_depth <= 0 || depth <= max_depth);

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

// path_bounce's default policy for its two traces: the warp walks of
// trace_common.cuh over the scene's clusters, the closest hit's record
// read from the scene's own table. A policy has these three members; the
// ablation probe's (ablate.cu) stub one trace or both, or the record.
template <bool kCoop>
struct WarpTraces {
  // the closest hit of a lane's ray (want: the lane traces one)
  __device__ __forceinline__ Hit closest(const Tables& T, bool want,
                                         const Ray& r) {
    return trace_ray_warp<false, kCoop>(T.woop, T.aabb, T.tris, want, r);
  }
  // the table of hit records (kAttr floats a row) the hit's row is read
  // from, at its triangle index
  __device__ __forceinline__ const float* records(const Tables& T) const {
    return T.attr;
  }
  // whether a lane's shadow ray is occluded (want: the lane traces one)
  __device__ __forceinline__ bool occluded(const Tables& T, bool want,
                                           const Ray& r) {
    return trace_ray_warp<true, kCoop>(T.woop, T.aabb, T.tris, want, r)
        .found;
  }
};

// One bounce of accel/megakernel.py MegaPlainTracer.bounce. All 32 lanes
// of a warp call it together, because its two traces are warp walks: the
// closest hit for the active lanes, the shadow ray for the lanes whose
// NEE contributes. A lane inactive on entry is left unchanged. traced:
// this lane traced a closest-hit ray; shadow: it attempted a shadow ray.
// kCoop: mitsuba_walk::coop_walk, which the launch picks; kExt: the
// scene has non-area lights, composites or a medium (or the camera a thin
// lens), MegaTables.ext, and kTex (with kExt) procedural textures,
// MegaTables.textured, which the launch picks too. tr: the two traces (a
// policy as WarpTraces, the default; passed as an lvalue, it is the
// caller's object, whose state the traces may change).
template <bool kCoop, bool kExt, bool kTex, class Traces = WarpTraces<kCoop>>
__device__ __forceinline__ void path_bounce(const Tables& T, State& s,
                                            uint32_t seed, uint32_t pixel,
                                            uint32_t samp, int bounce,
                                            int max_depth, int rr_depth,
                                            bool& traced, bool& shadow,
                                            Traces&& tr = Traces()) {
  const bool active = s.active > 0.5f;
  const Hit h = tr.closest(
      T, active,
      Ray{s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z, ray_mint(s.o), kMiss});
  float Mt[kTex ? kMat : 1];   // a textured lane's material row
  Vertex v{};
  if (active)
    v = bounce_front<kExt, kTex>(T, tr.records(T), s, h, seed, pixel, samp,
                                 bounce, max_depth, Mt);
  const bool occluded = tr.occluded(
      T, v.contributes,
      Ray{v.so.x, v.so.y, v.so.z, v.ds.d.x, v.ds.d.y, v.ds.d.z,
          ray_mint(v.so), v.ds.dist * F32(1.0 - 1e-3)});
  if (active)
    bounce_back<kExt>(T, v, occluded, s, seed, pixel, samp, bounce,
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

// med: a host array of the medium's 8 floats (σt rgb, albedo rgb, g,
// bound), or null
inline Tables make_tables(const void* woop, const void* aabb, int n_clusters,
                   int n_tris, const void* attr, const void* mat,
                   const void* em_rows, int et_real, const void* em_meta,
                   const void* em_cdf, int n_em, int env, const void* med) {
  const float* m = static_cast<const float*>(med);
  return Tables{static_cast<const float4*>(woop),
                static_cast<const float*>(aabb),
                mitsuba_walk::walk_tris(n_tris, n_clusters),
                static_cast<const float*>(attr),
                static_cast<const float*>(mat),
                static_cast<const float*>(em_rows), et_real,
                static_cast<const float*>(em_meta),
                static_cast<const float*>(em_cdf), n_em, env, m != nullptr,
                m ? V3{m[0], m[1], m[2]} : V3{0.f, 0.f, 0.f},
                m ? V3{m[3], m[4], m[5]} : V3{0.f, 0.f, 0.f},
                m ? m[6] : 0.f, m ? m[7] : 0.f};
}

}  // namespace mitsuba_mega
