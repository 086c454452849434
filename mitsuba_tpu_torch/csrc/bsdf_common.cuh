// BSDF device code for Hopper (sm_90a): the JAX megakernel's in-kernel
// dispatch (mitsuba_tpu/accel/megakernel.py _bsdf_eval_pdf :1744,
// _bsdf_sample :1951, _ggx_d, _ggx_g1, _fresnel_cond) for the diffuse,
// conductor, isotropic-GGX rough-conductor and smooth-dielectric families.
// Used by the fused shade kernel (shade.cu); the megakernel's other
// families are to join it here.
//
// A material is columns 0..12 of its row (`m`, column 12 the type code).
// Every expression is written in the order of its plain version,
// accel/megakernel.py bsdf_eval_pdf / bsdf_sample, and an including file
// is compiled with -fmad=false, so the two round alike. PyTorch computes
// `c / x` for a Python scalar c as reciprocal(x) * c, written so here.
#pragma once

#include "path_common.cuh"

namespace mitsuba_bsdf {

using namespace mitsuba_path;

constexpr float kMatDiffuse = 0.f, kMatConductor = 1.f;
constexpr float kMatRoughConductor = 2.f, kMatDielectric = 3.f;

__device__ __forceinline__ float inv_pi() { return F32(1.0 / kPi); }

// megakernel.py normalize3 (rsqrt of the clamped squared length)
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = rsqrtf(clamp_min((x * x + y * y) + z * z, F32(1e-30)));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// isotropic GGX D(h), zero below the horizon
__device__ __forceinline__ float ggx_d(float hx, float hy, float hz, float a) {
  const float qx = hx / a, qy = hy / a;
  const float t = (qx * qx + qy * qy) + hz * hz;
  const float d = 1.f / (((F32(kPi) * a) * a) * clamp_min(t * t, F32(1e-12)));
  return hz > 0.f ? d : 0.f;
}

// isotropic GGX Smith G1(v, h)
__device__ __forceinline__ float ggx_g1(float vx, float vy, float vz,
                                        float hx, float hy, float hz,
                                        float a) {
  const float vz2 = vz * vz;
  const float tan2 = clamp_min(1.f - vz2, 0.f) / clamp_min(vz2, F32(1e-12));
  float g = (1.f / (1.f + sqrtf(1.f + (a * a) * tan2))) * 2.f;
  g = tan2 < F32(1e-12) ? 1.f : g;
  return ((vx * hx + vy * hy) + vz * hz) * vz <= 0.f ? 0.f : g;
}

// exact conductor Fresnel per channel: eta in m[0..2], k in m[3..5]
__device__ __forceinline__ void fresnel_cond(const float* m, float ci,
                                             float out[3]) {
  const float c2 = ci * ci;
  const float s2 = 1.f - c2;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float e2 = m[ch] * m[ch], k2 = m[3 + ch] * m[3 + ch];
    const float t0 = (e2 - k2) - s2;
    const float a2pb2 = sqrtf(clamp_min(t0 * t0 + (4.f * e2) * k2,
                                        F32(1e-12)));
    const float t1 = a2pb2 + c2;
    const float a = sqrtf(clamp_min(0.5f * (a2pb2 + t0), F32(1e-12)));
    const float t2 = (2.f * a) * ci;
    const float rs = (t1 - t2) / clamp_min(t1 + t2, F32(1e-6));
    const float t3 = c2 * a2pb2 + s2 * s2;
    const float t4 = t2 * s2;
    const float rp = (rs * (t3 - t4)) / clamp_min(t3 + t4, F32(1e-6));
    out[ch] = 0.5f * (rp + rs);
  }
}

// f·cosθo (f[3]) and the solid-angle pdf toward wo of the smooth lobes;
// the delta families (conductor, dielectric) give 0
__device__ __forceinline__ void bsdf_eval_pdf(const float* m, float wix,
                                              float wiy, float wiz, float wox,
                                              float woy, float woz,
                                              float f[3], float& pdf) {
  f[0] = f[1] = f[2] = pdf = 0.f;
  if (!(wiz > 0.f && woz > 0.f)) return;
  const float mtype = m[12];
  if (mtype == kMatDiffuse) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) f[ch] = (m[ch] * inv_pi()) * woz;
    pdf = woz * inv_pi();
  } else if (mtype == kMatRoughConductor) {
    float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
    normalize3(hx, hy, hz);
    const float a = clamp_min(m[9], F32(1e-4));
    const float d = ggx_d(hx, hy, hz, a);
    const float g1i = ggx_g1(wix, wiy, wiz, hx, hy, hz, a);
    const float g1o = ggx_g1(wox, woy, woz, hx, hy, hz, a);
    const float wim = (wix * hx + wiy * hy) + wiz * hz;
    float fr[3];
    fresnel_cond(m, fabsf(wim), fr);
    const float base = ((d * g1i) * g1o) / clamp_min(4.f * wiz, F32(1e-7));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) f[ch] = (fr[ch] * m[6 + ch]) * base;
    const float pdf_h = ((g1i * fabsf(wim)) * d) / clamp_min(wiz, F32(1e-12));
    pdf = pdf_h / clamp_min(4.f * fabsf((wox * hx + woy * hy) + woz * hz),
                            F32(1e-7));
  }
}

struct BsdfSample {
  float wo[3];    // sampled direction, local frame
  float w[3];     // weight f·cos/pdf
  float pdf;      // solid-angle pdf (delta: the discrete probability)
  float eta;      // relative ior of the sampled event
  bool delta;
};

// One BSDF sample: u0, u1 drive the 2-D warps, uc the dielectric's pick.
// A type code outside the four families samples nothing (weight 0).
__device__ __forceinline__ BsdfSample bsdf_sample(const float* m, float wix,
                                                  float wiy, float wiz,
                                                  float u0, float u1,
                                                  float uc) {
  BsdfSample s{{0.f, 0.f, 1.f}, {0.f, 0.f, 0.f}, 0.f, 1.f, false};
  const float mtype = m[12];
  if (mtype == kMatDiffuse) {
    const V3 c = cosine_hemisphere(u0, u1);
    s.wo[0] = c.x;
    s.wo[1] = c.y;
    s.wo[2] = c.z;
    if (wiz > 0.f) {
      s.w[0] = m[0];
      s.w[1] = m[1];
      s.w[2] = m[2];
      s.pdf = c.z * inv_pi();
    }
  } else if (mtype == kMatConductor) {
    s.wo[0] = -wix;
    s.wo[1] = -wiy;
    s.wo[2] = wiz;
    if (wiz > 0.f) {
      float fr[3];
      fresnel_cond(m, clamp_min(wiz, 0.f), fr);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s.w[ch] = fr[ch] * m[6 + ch];
      s.pdf = 1.f;
      s.delta = true;
    }
  } else if (mtype == kMatRoughConductor) {
    // GGX visible normals (Heitz 2018)
    const float a = clamp_min(m[9], F32(1e-4));
    float vx = a * wix, vy = a * wiy, vz = wiz;
    normalize3(vx, vy, vz);
    const float lensq = vx * vx + vy * vy;
    const float inv_len = rsqrtf(clamp_min(lensq, F32(1e-20)));
    const bool big = lensq > F32(1e-20);
    const float t1x = big ? -vy * inv_len : 1.f;
    const float t1y = big ? vx * inv_len : 0.f;
    const float t1z = 0.f;
    const float t2x = vy * t1z - vz * t1y;
    const float t2y = vz * t1x - vx * t1z;
    const float t2z = vx * t1y - vy * t1x;
    const float rr = sqrtf(clamp_min(u0, 0.f));
    const float ph = F32(2.0 * kPi) * u1;
    const float p1 = rr * cosf(ph);
    float p2 = rr * sinf(ph);
    const float ss = 0.5f * (1.f + vz);
    p2 = (1.f - ss) * sqrtf(clamp_min(1.f - p1 * p1, 0.f)) + ss * p2;
    const float p3 = sqrtf(clamp_min((1.f - p1 * p1) - p2 * p2, 0.f));
    float mx = a * ((p1 * t1x + p2 * t2x) + p3 * vx);
    float my = a * ((p1 * t1y + p2 * t2y) + p3 * vy);
    float mz = clamp_min((p1 * t1z + p2 * t2z) + p3 * vz, F32(1e-6));
    normalize3(mx, my, mz);
    const float wim = (wix * mx + wiy * my) + wiz * mz;
    const float rx = (2.f * wim) * mx - wix;
    const float ry = (2.f * wim) * my - wiy;
    const float rz = (2.f * wim) * mz - wiz;
    const float d = ggx_d(mx, my, mz, a);
    const float g1i = ggx_g1(wix, wiy, wiz, mx, my, mz, a);
    const float g1o = ggx_g1(rx, ry, rz, mx, my, mz, a);
    const float pdf_h = ((g1i * fabsf(wim)) * d) / clamp_min(wiz, F32(1e-12));
    const float pdf_c =
        pdf_h / clamp_min(4.f * fabsf((rx * mx + ry * my) + rz * mz),
                          F32(1e-7));
    s.wo[0] = rx;
    s.wo[1] = ry;
    s.wo[2] = rz;
    if (wiz > F32(1e-7) && rz > F32(1e-7) && pdf_c > 0.f) {
      float fr[3];
      fresnel_cond(m, fabsf(wim), fr);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s.w[ch] = (fr[ch] * m[6 + ch]) * g1o;
      s.pdf = pdf_c;
    }
  } else if (mtype == kMatDielectric) {
    // smooth glass: delta reflect/refract, two-sided
    const float eta_r = clamp_min(m[0], F32(1e-3));
    const bool outside = wiz >= 0.f;
    const float eta_it = outside ? eta_r : 1.f / eta_r;
    const float eta_ti = 1.f / eta_it;
    const float cos_i = fabsf(wiz);
    const float sin_t2 = (eta_ti * eta_ti) * (1.f - cos_i * cos_i);
    const bool tir = sin_t2 >= 1.f;
    const float cos_t = tir ? 0.f : sqrtf(clamp_min(1.f - sin_t2, F32(1e-12)));
    const float rs = (cos_i - eta_it * cos_t)
                     / clamp_min(cos_i + eta_it * cos_t, F32(1e-4));
    const float rp = (eta_it * cos_i - cos_t)
                     / clamp_min(eta_it * cos_i + cos_t, F32(1e-4));
    const float f = tir ? 1.f : 0.5f * (rs * rs + rp * rp);
    const float cos_theta_t = tir ? 0.f : (outside ? -cos_t : cos_t);
    const bool pick_r = uc < f;
    const float scale = cos_theta_t < 0.f ? 1.f / eta_r : eta_r;
    const float t_fac = eta_ti * eta_ti;
    s.wo[0] = pick_r ? -wix : -scale * wix;
    s.wo[1] = pick_r ? -wiy : -scale * wiy;
    s.wo[2] = pick_r ? wiz : cos_theta_t;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      s.w[ch] = pick_r ? m[1 + ch] : m[4 + ch] * t_fac;
    s.pdf = pick_r ? f : 1.f - f;
    s.delta = true;
    s.eta = pick_r ? 1.f : eta_it;
  }
  return s;
}

}  // namespace mitsuba_bsdf
