// BSDF device code for Hopper (sm_90a): the JAX megakernel's in-kernel
// dispatch (mitsuba_tpu/accel/megakernel.py _bsdf_eval_pdf :1744,
// _bsdf_sample :1951 and their helpers _rd_terms :1578, _rp_terms :1637,
// _leadr_terms :1691, _fresnel_diel_f :207, _powf :224, _fdr :230,
// _ggx_d, _ggx_g1, _fresnel_cond) for the 14 leaf BSDF families. Shared by
// the path megakernel (megakernel.cu) and the fused shade kernel
// (shade.cu).
//
// A material is the row `m` of the megakernel's material table
// (accel/megakernel.py N_MAT columns: the scene's mat_params, column 12
// the type code, then the rough-plastic transmittance rows from RTROW);
// the shade kernel passes columns 0..12 only and instantiates the
// helpers with kRp = false, which leaves rough plastic out of the
// dispatch. Each family runs only its own branch: a lane evaluates one
// material.
//
// Every expression is written in the order of its plain version,
// accel/megakernel.py bsdf_eval_pdf / bsdf_sample and the helpers they
// call, and an including file is compiled with -fmad=false, so the two
// round alike. PyTorch computes `c / x` for a Python scalar c as
// reciprocal(x) * c, written so here; `x ** 2` is x * x; a Python float
// constant is rounded to float32 (F32). exp, log, sin and cos are the
// library calls PyTorch makes (expf, logf, sinf, cosf); powf is never
// used: a^b is expf(b * logf(a)), as the JAX _powf.
#pragma once

#include "path_common.cuh"

namespace mitsuba_bsdf {

using namespace mitsuba_path;

constexpr float kMatDiffuse = 0.f, kMatConductor = 1.f;
constexpr float kMatRoughConductor = 2.f, kMatDielectric = 3.f;
constexpr float kMatPlastic = 4.f, kMatRoughDielectric = 5.f;
constexpr float kMatRoughPlastic = 6.f, kMatPhong = 7.f, kMatWard = 8.f;
constexpr float kMatRoughDiffuse = 9.f, kMatNull = 10.f;
constexpr float kMatThinDielectric = 11.f, kMatDifftrans = 12.f;
constexpr float kMatAnisoRoughDiffuse = 19.f;
constexpr int kRtRow = 34;     // accel/megakernel.py RTROW
constexpr int kRtKnots = 32;   // RT_KNOTS

__device__ __forceinline__ float inv_pi() { return F32(1.0 / kPi); }

// megakernel.py normalize3 (rsqrt of the clamped squared length)
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = rsqrtf(clamp_min((x * x + y * y) + z * z, F32(1e-30)));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float dot_xyz(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  return (ax * bx + ay * by) + az * bz;
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
  return dot_xyz(vx, vy, vz, hx, hy, hz) * vz <= 0.f ? 0.f : g;
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

// Unpolarized dielectric Fresnel F for a signed cos_i (_fresnel_diel_f)
__device__ __forceinline__ float fresnel_diel_f(float cos_i, float eta) {
  eta = clamp_min(eta, F32(1e-3));
  const bool outside = cos_i >= 0.f;
  const float eta_it = outside ? eta : 1.f / eta;
  const float eta_ti = 1.f / eta_it;
  const float ci = fabsf(cos_i);
  const float sin_t2 = (eta_ti * eta_ti) * (1.f - ci * ci);
  const bool tir = sin_t2 >= 1.f;
  const float ct = tir ? 0.f : sqrtf(clamp_min(1.f - sin_t2, F32(1e-12)));
  const float rs = (ci - eta_it * ct) / clamp_min(ci + eta_it * ct, F32(1e-4));
  const float rp = (eta_it * ci - ct) / clamp_min(eta_it * ci + ct, F32(1e-4));
  return tir ? 1.f : 0.5f * (rs * rs + rp * rp);
}

// a^b for a > 0 as exp(b·log a) (_powf)
__device__ __forceinline__ float powf_el(float a, float b) {
  return expf(b * logf(a));
}

// diffuse Fresnel reflectance polynomial fits (_fdr)
__device__ __forceinline__ float fdr(float eta) {
  const float inv_eta = 1.f / eta;
  const float below = ((F32(-1.4399) * (eta * eta) + F32(0.7099) * eta)
                       + F32(0.6681)) + F32(0.0636) * inv_eta;
  const float ie2 = inv_eta * inv_eta;
  const float ie3 = ie2 * inv_eta;
  const float above =
      ((((F32(0.919317) - F32(3.4793) * inv_eta) + F32(6.75335) * ie2)
        - F32(7.80989) * ie3) + (F32(4.98554) * ie2) * ie2)
      - (F32(1.36881) * ie2) * ie3;
  return eta < 1.f ? below : above;
}

// GGX visible normal (Heitz 2018) for the view v (megakernel.py _vndf)
__device__ __forceinline__ void vndf(float a, float vx, float vy, float vz,
                                     float u0, float u1, float& mx,
                                     float& my, float& mz) {
  vx = a * vx;
  vy = a * vy;
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
  mx = a * ((p1 * t1x + p2 * t2x) + p3 * vx);
  my = a * ((p1 * t1y + p2 * t2y) + p3 * vy);
  mz = clamp_min((p1 * t1z + p2 * t2z) + p3 * vz, F32(1e-6));
  normalize3(mx, my, mz);
}

// max(ks) / (max(kd) + max(ks)) of phong and ward
__device__ __forceinline__ float spec_prob(const float* m) {
  const float sd = fmaxf(fmaxf(m[0], m[1]), m[2]);
  const float ss = fmaxf(fmaxf(m[3], m[4]), m[5]);
  return ss / clamp_min(sd + ss, F32(1e-7));
}

// Oren-Nayar A + B·max(cos Δφ, 0)·sin α·tan β
__device__ __forceinline__ float oren_nayar(const float* m, float wix,
                                            float wiy, float wiz, float wox,
                                            float woy, float woz) {
  const float sigma = m[9] * F32(0.70711);
  const float sigma2 = sigma * sigma;
  const float a = 1.f - sigma2 / (2.f * (sigma2 + F32(0.33)));
  const float bb = (F32(0.45) * sigma2) / (sigma2 + F32(0.09));
  const float st_i = sqrtf(clamp_min(1.f - wiz * wiz, 0.f));
  const float st_o = sqrtf(clamp_min(1.f - woz * woz, 0.f));
  const float denom = clamp_min(st_i * st_o, F32(1e-7));
  const float cos_dphi = clamp_max(
      clamp_min((wix * wox + wiy * woy) / denom, -1.f), 1.f);
  const float sin_alpha = fmaxf(st_i, st_o);
  const float tan_beta = fminf(st_i / clamp_min(wiz, F32(1e-7)),
                               st_o / clamp_min(woz, F32(1e-7)));
  return a + ((bb * clamp_min(cos_dphi, 0.f)) * sin_alpha) * tan_beta;
}

// plastic's compensated diffuse weight of channel ch
__device__ __forceinline__ float plastic_dw(const float* m, int ch,
                                            float fdr_int, float inv_eta2) {
  const float kd = m[1 + ch];
  const float den = m[7] > 0.5f ? 1.f - kd * fdr_int : 1.f - fdr_int;
  return (kd * inv_eta2) / clamp_min(den, F32(1e-4));
}

// phong: alpha^n and the pdf's glossy term at (wi, wo)
__device__ __forceinline__ void phong_lobe(const float* m, float wix,
                                           float wiy, float wiz, float wox,
                                           float woy, float woz, float& an,
                                           float& pdf_s) {
  const float nexp = m[6];
  const float alpha = clamp_min(((-wix) * wox - wiy * woy) + wiz * woz,
                                F32(1e-7));
  an = powf_el(alpha, nexp);
  pdf_s = ((nexp + 1.f) * F32(0.5 / kPi)) * an;
}

// ward: the specular value (unnormalized half vector) and the half-vector
// pdf with its Jacobian (normalized half vector) at (wi, wo)
__device__ __forceinline__ void ward_terms(float au, float av, float wix,
                                           float wiy, float wiz, float wox,
                                           float woy, float woz,
                                           float& spec, float& pdf_s) {
  const float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
  const float qx = hx / au, qy = hy / av;
  const float ex = -(qx * qx + qy * qy) / clamp_min(hz * hz, F32(1e-12));
  spec = expf(ex) / (((F32(4.0 * kPi) * au) * av)
                     * clamp_min(sqrtf(clamp_min(wiz * woz, 0.f)),
                                 F32(1e-6)));
  float hnx = hx, hny = hy, hnz = hz;
  normalize3(hnx, hny, hnz);
  const float rx = hnx / au, ry = hny / av;
  const float exn = -(rx * rx + ry * ry) / clamp_min(hnz * hnz, F32(1e-12));
  const float pdf_h = expf(exn) / (((F32(kPi) * au) * av)
                                   * clamp_min((hnz * hnz) * hnz, F32(1e-6)));
  pdf_s = pdf_h / clamp_min(4.f * fabsf(dot_xyz(wox, woy, woz, hnx, hny,
                                                 hnz)), F32(1e-6));
}

// rough dielectric eval/pdf terms at (wi, wo) (_rd_terms)
struct RdTerms {
  float vs, pdf;
  bool refl, ok;
};

__device__ __forceinline__ RdTerms rd_terms(const float* m, float wix,
                                            float wiy, float wiz, float wox,
                                            float woy, float woz) {
  const float eta = clamp_min(m[0], F32(1e-3));
  const float a = clamp_min(m[9], F32(1e-4));
  const float ci = wiz, co = woz;
  RdTerms r;
  r.refl = ci * co > 0.f;
  const float eta_it_w = ci > 0.f ? eta : 1.f / eta;
  float mx, my, mz;
  if (r.refl) {
    mx = wix + wox;
    my = wiy + woy;
    mz = wiz + woz;
  } else {
    mx = wix + eta_it_w * wox;
    my = wiy + eta_it_w * woy;
    mz = wiz + eta_it_w * woz;
  }
  normalize3(mx, my, mz);
  const float sgn_m = mz >= 0.f ? 1.f : -1.f;
  mx = mx * sgn_m;
  my = my * sgn_m;
  mz = mz * sgn_m;
  const float wim = dot_xyz(wix, wiy, wiz, mx, my, mz);
  const float wom = dot_xyz(wox, woy, woz, mx, my, mz);
  const bool outs = wim >= 0.f;
  const float eta_itm = outs ? eta : 1.f / eta;
  const float eta_tim = 1.f / eta_itm;
  const float cia = fabsf(wim);
  const float sin_t2 = (eta_tim * eta_tim) * (1.f - cia * cia);
  const bool tir = sin_t2 >= 1.f;
  const float cts = tir ? 0.f : sqrtf(clamp_min(1.f - sin_t2, F32(1e-12)));
  const float rs_ = (cia - eta_itm * cts)
                    / clamp_min(cia + eta_itm * cts, F32(1e-4));
  const float rp_ = (eta_itm * cia - cts)
                    / clamp_min(eta_itm * cia + cts, F32(1e-4));
  const float fre = tir ? 1.f : 0.5f * (rs_ * rs_ + rp_ * rp_);
  const float d_ndf = ggx_d(mx, my, mz, a);
  const float g_both = ggx_g1(wix, wiy, wiz, mx, my, mz, a)
                       * ggx_g1(wox, woy, woz, mx, my, mz, a);
  const float den_t = (wim + eta_itm * wom) * (wim + eta_itm * wom);
  if (r.refl)
    r.vs = ((fre * d_ndf) * g_both) / clamp_min(4.f * fabsf(ci), F32(1e-7));
  else
    r.vs = ((((1.f - fre) * d_ndf) * g_both) * fabsf(wim * wom))
           / clamp_min(fabsf(ci) * den_t, F32(1e-7));
  const float sw = wiz >= 0.f ? 1.f : -1.f;
  const float g1up = ggx_g1(wix * sw, wiy * sw, wiz * sw, mx, my, mz, a);
  const float pdf_m = ((g1up * fabsf(wim)) * d_ndf)
                      / clamp_min(fabsf(wiz), F32(1e-12));
  if (r.refl)
    r.pdf = pdf_m * (fre * (1.f / clamp_min(4.f * fabsf(wom), F32(1e-7))));
  else
    r.pdf = pdf_m * ((1.f - fre) * (((fabsf(wom) * eta_itm) * eta_itm)
                                    / clamp_min(den_t, F32(1e-7))));
  const bool chir = r.refl ? wim * wom > 0.f : wim * wom < 0.f;
  r.ok = fabsf(ci) > F32(1e-7) && chir;
  return r;
}

// rough plastic f·cosθo and pdf at (wi, wo) (_rp_terms), with the
// material's transmittance slice: T(cosθ) at 32 knots from m[kRtRow + 1]
__device__ __forceinline__ float rt_interp(const float* m, float ct) {
  const float c0 = m[kRtRow + 1 + kRtKnots];
  const float c1 = m[kRtRow + 2 + kRtKnots];
  const float inv_span = (1.f / clamp_min(c1 - c0, F32(1e-6)))
                         * static_cast<float>(kRtKnots - 1);
  const float xx = (fminf(fmaxf(ct, c0), c1) - c0) * inv_span;
  const float i0 = clamp_max(clamp_min(floorf(xx), 0.f),
                             static_cast<float>(kRtKnots - 2));
  const float fcv = xx - i0;
  const int k = static_cast<int>(i0);
  return m[kRtRow + 1 + k] * (1.f - fcv) + m[kRtRow + 2 + k] * fcv;
}

__device__ __forceinline__ void rp_terms(const float* m, float wix,
                                         float wiy, float wiz, float wox,
                                         float woy, float woz, float f[3],
                                         float& pdf) {
  const float eta = clamp_min(m[0], F32(1e-3));
  const float a = clamp_min(m[9], F32(1e-4));
  float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
  normalize3(hx, hy, hz);
  const float wih = dot_xyz(wix, wiy, wiz, hx, hy, hz);
  const float fm = fresnel_diel_f(wih, eta);
  const float d_h = ggx_d(hx, hy, hz, a);
  const float g1i = ggx_g1(wix, wiy, wiz, hx, hy, hz, a);
  const float g1o = ggx_g1(wox, woy, woz, hx, hy, hz, a);
  const float spec_base = (((fm * d_h) * g1i) * g1o)
                          / clamp_min(4.f * wiz, F32(1e-7));
  const float t12 = rt_interp(m, wiz);
  const float t21 = rt_interp(m, woz);
  const float fdr_r = m[kRtRow];
  const float inv_eta2 = 1.f / (eta * eta);
  const float base_d = ((inv_pi() * t12) * t21) * clamp_min(woz, 0.f);
  const bool nonlin = m[7] > 0.5f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float kd = m[1 + ch], ks = m[4 + ch];
    const float den = nonlin ? 1.f - kd * fdr_r : 1.f - fdr_r;
    f[ch] = ks * spec_base
            + ((kd * inv_eta2) / clamp_min(den, F32(1e-4))) * base_d;
  }
  const float prob_s = clamp_max(clamp_min(fresnel_diel_f(wiz, eta),
                                           F32(0.25)), F32(0.9));
  const float pdf_h = ((g1i * fabsf(wih)) * d_h) / clamp_min(wiz, F32(1e-12));
  const float woh = dot_xyz(wox, woy, woz, hx, hy, hz);
  const float pdf_s = pdf_h / clamp_min(4.f * fabsf(woh), F32(1e-7));
  const float pdf_d = clamp_min(woz, 0.f) * inv_pi();
  pdf = prob_s * pdf_s + (1.f - prob_s) * pdf_d;
}

// LEADR: Smith Λ of direction w from the slope moments
__device__ __forceinline__ float leadr_lambda(float wx, float wy, float wz,
                                              float mux, float muy,
                                              float sx2, float sy2,
                                              float cxy) {
  const float st = sqrtf(clamp_min(1.f - wz * wz, 0.f));
  const float st_s = clamp_min(st, F32(1e-7));
  const float cphi = wx / st_s, sphi = wy / st_s;
  const float cot = wz / st_s;
  const float mu_phi = cphi * mux + sphi * muy;
  const float s2phi = clamp_min(((cphi * cphi) * sx2 + (sphi * sphi) * sy2)
                                + ((2.f * cphi) * sphi) * cxy, F32(1e-12));
  const float v = (cot - mu_phi) / sqrtf(2.f * s2phi);
  const float lm =
      v < 0.f ? F32(1e8)
              : (v < F32(1.6)
                     ? ((1.f - F32(1.259) * v) + (F32(0.396) * v) * v)
                           / clamp_min(F32(3.535) * v + (F32(2.181) * v) * v,
                                       F32(1e-12))
                     : 0.f);
  return st < F32(1e-6) ? 0.f : lm;
}

// LEADR anisotropic rough diffuse (_leadr_terms): f·cosθo = albedo·scale
// where `valid`
__device__ __forceinline__ float leadr_terms(const float* m, float wix,
                                             float wiy, float wiz, float wox,
                                             float woy, float woz,
                                             bool& valid) {
  const float mux = m[3], muy = m[4];
  const float sx2 = clamp_min(m[5] - mux * mux, F32(1e-8));
  const float sy2 = clamp_min(m[6] - muy * muy, F32(1e-8));
  const float cxy = m[7] - mux * muy;
  const bool use_vis = m[11] > 0.5f;
  const float ml = rsqrtf((mux * mux + muy * muy) + 1.f);
  const float mnx = (-mux) * ml, mny = (-muy) * ml, mnz = ml;
  const float win = dot_xyz(wix, wiy, wiz, mnx, mny, mnz);
  const float g2 =
      1.f / ((1.f + leadr_lambda(wix, wiy, wiz, mux, muy, sx2, sy2, cxy))
             + leadr_lambda(wox, woy, woz, mux, muy, sx2, sy2, cxy));
  const float l11 = sqrtf(sx2);
  const float l21 = cxy / l11;
  const float l22 = sqrtf(clamp_min(sy2 - l21 * l21, F32(1e-12)));
  const float s2c = F32(1.4142135623730951);
  const float z0s[4] = {s2c, -s2c, 0.f, 0.f};
  const float z1s[4] = {0.f, 0.f, s2c, -s2c};
  float r = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float sx = mux + l11 * z0s[q];
    const float sy = (muy + l21 * z0s[q]) + l22 * z1s[q];
    const float il = rsqrtf((sx * sx + sy * sy) + 1.f);
    const float wmx = (-sx) * il, wmy = (-sy) * il, wmz = il;
    const float di = clamp_min(dot_xyz(wmx, wmy, wmz, wix, wiy, wiz), 0.f);
    const float d_o = clamp_min(dot_xyz(wmx, wmy, wmz, wox, woy, woz), 0.f);
    float term = (di * d_o) / wmz;
    term = use_vis && di > F32(1e-7) && d_o > F32(1e-7)
               ? term * g2
               : (use_vis ? 0.f : term);
    r = r + 0.25f * term;
  }
  valid = win > 0.f;
  return ((inv_pi() * mnz) / clamp_min(win, F32(1e-7))) * r;
}

// f·cosθo (f[3]) and the solid-angle pdf toward wo of the smooth lobes
// (_bsdf_eval_pdf); the delta families give 0
template <bool kRp>
__device__ __forceinline__ void bsdf_eval_pdf(const float* m, float wix,
                                              float wiy, float wiz, float wox,
                                              float woy, float woz,
                                              float f[3], float& pdf) {
  f[0] = f[1] = f[2] = pdf = 0.f;
  const float mtype = m[12];
  if (mtype == kMatDifftrans) {
    // opposite hemispheres
    if (wiz * woz < 0.f) {
      const float awz = fabsf(woz);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) f[ch] = (m[ch] * inv_pi()) * awz;
      pdf = awz * inv_pi();
    }
    return;
  }
  if (mtype == kMatRoughDielectric) {
    // Walter rough glass: reflection and transmission, two-sided
    const RdTerms rd = rd_terms(m, wix, wiy, wiz, wox, woy, woz);
    if (rd.ok) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        f[ch] = rd.vs * (rd.refl ? m[1 + ch] : m[4 + ch]);
      pdf = rd.pdf;
    }
    return;
  }
  if (!(wiz > 0.f && woz > 0.f)) return;
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
    const float wim = dot_xyz(wix, wiy, wiz, hx, hy, hz);
    float fr[3];
    fresnel_cond(m, fabsf(wim), fr);
    const float base = ((d * g1i) * g1o) / clamp_min(4.f * wiz, F32(1e-7));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) f[ch] = (fr[ch] * m[6 + ch]) * base;
    const float pdf_h = ((g1i * fabsf(wim)) * d) / clamp_min(wiz, F32(1e-12));
    pdf = pdf_h / clamp_min(4.f * fabsf(dot_xyz(wox, woy, woz, hx, hy, hz)),
                            F32(1e-7));
  } else if (mtype == kMatAnisoRoughDiffuse) {
    bool vl;
    const float sc = leadr_terms(m, wix, wiy, wiz, wox, woy, woz, vl);
    if (vl) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) f[ch] = m[ch] * sc;
    }
    pdf = woz * inv_pi();
  } else if (kRp && mtype == kMatRoughPlastic) {
    rp_terms(m, wix, wiy, wiz, wox, woy, woz, f, pdf);
  } else if (mtype == kMatRoughDiffuse) {
    const float on = (oren_nayar(m, wix, wiy, wiz, wox, woy, woz) * inv_pi())
                     * clamp_min(woz, 0.f);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) f[ch] = m[ch] * on;
    pdf = woz * inv_pi();
  } else if (mtype == kMatPlastic) {
    const float eta = clamp_min(m[0], F32(1e-3));
    const float fi = fresnel_diel_f(wiz, eta);
    const float fo = fresnel_diel_f(woz, eta);
    const float fdr_int = fdr(1.f / eta), inv_eta2 = 1.f / (eta * eta);
    const float base = ((inv_pi() * (1.f - fi)) * (1.f - fo))
                       * clamp_min(woz, 0.f);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      f[ch] = plastic_dw(m, ch, fdr_int, inv_eta2) * base;
    pdf = (woz * inv_pi()) * (1.f - fi);
  } else if (mtype == kMatPhong) {
    float an, pdf_s;
    phong_lobe(m, wix, wiy, wiz, wox, woy, woz, an, pdf_s);
    const float ct_o = clamp_min(woz, 0.f);
    const float glossy = (((m[6] + 2.f) * F32(0.5 / kPi)) * an) * ct_o;
    const float diff = inv_pi() * ct_o;
    const float prob_s = spec_prob(m);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) f[ch] = m[3 + ch] * glossy + m[ch] * diff;
    pdf = prob_s * pdf_s + ((1.f - prob_s) * woz) * inv_pi();
  } else if (mtype == kMatWard) {
    const float au = clamp_min(m[9], F32(1e-3));
    const float av = clamp_min(m[10], F32(1e-3));
    float spec, pdf_s;
    ward_terms(au, av, wix, wiy, wiz, wox, woy, woz, spec, pdf_s);
    const float prob_s = spec_prob(m);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      f[ch] = (m[ch] * inv_pi()) * woz + (m[3 + ch] * spec) * woz;
    pdf = prob_s * pdf_s + ((1.f - prob_s) * woz) * inv_pi();
  }
}

struct BsdfSample {
  float wo[3];    // sampled direction, local frame
  float w[3];     // weight f·cos/pdf
  float pdf;      // solid-angle pdf (delta: the discrete probability)
  float eta;      // relative ior of the sampled event
  bool delta;
};

// One BSDF sample (_bsdf_sample): u0, u1 drive the 2-D warps, uc the lobe
// pick. A type code outside the dispatch samples nothing (weight 0).
template <bool kRp>
__device__ __forceinline__ BsdfSample bsdf_sample(const float* m, float wix,
                                                  float wiy, float wiz,
                                                  float u0, float u1,
                                                  float uc) {
  BsdfSample s{{0.f, 0.f, 1.f}, {0.f, 0.f, 0.f}, 0.f, 1.f, false};
  const float mtype = m[12];
  const bool up = wiz > 0.f;
  // the cosine-hemisphere candidate (MEGA_COS_FAMILIES)
  const bool cos_family =
      mtype == kMatDiffuse || mtype == kMatRoughDiffuse ||
      mtype == kMatPlastic || mtype == kMatPhong || mtype == kMatWard ||
      mtype == kMatDifftrans || mtype == kMatAnisoRoughDiffuse ||
      (kRp && mtype == kMatRoughPlastic);
  V3 c{0.f, 0.f, 1.f};
  float pdf_cos = 0.f;
  if (cos_family) {
    c = cosine_hemisphere(u0, u1);
    pdf_cos = c.z * inv_pi();
  }
  const auto set_wo = [&](float x, float y, float z) {
    s.wo[0] = x;
    s.wo[1] = y;
    s.wo[2] = z;
  };

  if (mtype == kMatDiffuse) {
    set_wo(c.x, c.y, c.z);
    if (up) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s.w[ch] = m[ch];
      s.pdf = pdf_cos;
    }
  } else if (mtype == kMatAnisoRoughDiffuse) {
    // cosine sample, weight = f/pdf
    bool vl;
    const float sc = leadr_terms(m, wix, wiy, wiz, c.x, c.y, c.z, vl);
    const bool both = up && c.z > 0.f;
    const float inv_pc = 1.f / clamp_min(pdf_cos, F32(1e-6));
    set_wo(c.x, c.y, c.z);
    if (both && vl) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s.w[ch] = (m[ch] * sc) * inv_pc;
    }
    s.pdf = both ? pdf_cos : 0.f;
  } else if (mtype == kMatConductor) {
    set_wo(-wix, -wiy, wiz);
    if (up) {
      float fr[3];
      fresnel_cond(m, clamp_min(wiz, 0.f), fr);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s.w[ch] = fr[ch] * m[6 + ch];
      s.pdf = 1.f;
      s.delta = true;
    }
  } else if (mtype == kMatRoughConductor) {
    const float a = clamp_min(m[9], F32(1e-4));
    float mx, my, mz;
    vndf(a, wix, wiy, wiz, u0, u1, mx, my, mz);
    const float wim = dot_xyz(wix, wiy, wiz, mx, my, mz);
    const float rx = (2.f * wim) * mx - wix;
    const float ry = (2.f * wim) * my - wiy;
    const float rz = (2.f * wim) * mz - wiz;
    const float d = ggx_d(mx, my, mz, a);
    const float g1i = ggx_g1(wix, wiy, wiz, mx, my, mz, a);
    const float g1o = ggx_g1(rx, ry, rz, mx, my, mz, a);
    const float pdf_h = ((g1i * fabsf(wim)) * d) / clamp_min(wiz, F32(1e-12));
    const float pdf_c = pdf_h / clamp_min(
        4.f * fabsf(dot_xyz(rx, ry, rz, mx, my, mz)), F32(1e-7));
    set_wo(rx, ry, rz);
    if (wiz > F32(1e-7) && rz > F32(1e-7) && pdf_c > 0.f) {
      float fr[3];
      fresnel_cond(m, fabsf(wim), fr);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s.w[ch] = (fr[ch] * m[6 + ch]) * g1o;
      s.pdf = pdf_c;
    }
  } else if (mtype == kMatRoughDiffuse) {
    // Oren-Nayar: cosine sample; f/pdf cancels (1/π)·cosθo
    const float on = oren_nayar(m, wix, wiy, wiz, c.x, c.y, c.z);
    set_wo(c.x, c.y, c.z);
    if (up && c.z > 0.f) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s.w[ch] = m[ch] * on;
    }
    s.pdf = up ? pdf_cos : 0.f;
  } else if (mtype == kMatPlastic) {
    // delta coat over diffuse
    const float eta = clamp_min(m[0], F32(1e-3));
    const float fi = fresnel_diel_f(wiz, eta);
    const bool pick = uc < fi;
    const float pwz = pick ? wiz : c.z;
    const float fo = fresnel_diel_f(pwz, eta);
    const float fdr_int = fdr(1.f / eta), inv_eta2 = 1.f / (eta * eta);
    const float dfac = ((1.f - fi) * (1.f - fo))
                       / clamp_min(1.f - fi, F32(1e-7));
    set_wo(pick ? -wix : c.x, pick ? -wiy : c.y, pwz);
    if (up) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        s.w[ch] = pick ? m[4 + ch]
                       : plastic_dw(m, ch, fdr_int, inv_eta2) * dfac;
      s.pdf = pick ? fi : ((1.f - fi) * c.z) * inv_pi();
    }
    s.delta = pick;
  } else if (mtype == kMatPhong) {
    const float prob_s = spec_prob(m);
    const bool pick = uc < prob_s;
    // glossy lobe around the mirror direction
    const float cos_a = powf_el(clamp_min(u0, F32(1e-7)), 1.f / (m[6] + 1.f));
    const float sin_a = sqrtf(clamp_min(1.f - cos_a * cos_a, 0.f));
    const float ph = F32(2.0 * kPi) * u1;
    const float lx = sin_a * cosf(ph);
    const float ly = sin_a * sinf(ph);
    const V3 r{-wix, -wiy, wiz};
    V3 fs, ft;
    coordinate_system(r, fs, ft);
    const float pwx = pick ? (lx * fs.x + ly * ft.x) + cos_a * r.x : c.x;
    const float pwy = pick ? (lx * fs.y + ly * ft.y) + cos_a * r.y : c.y;
    const float pwz = pick ? (lx * fs.z + ly * ft.z) + cos_a * r.z : c.z;
    const bool valid = up && pwz > 0.f;
    float an, pdf_s;
    phong_lobe(m, wix, wiy, wiz, pwx, pwy, pwz, an, pdf_s);
    const float pdf_c = valid ? prob_s * pdf_s
                                    + ((1.f - prob_s) * pwz) * inv_pi()
                              : 0.f;
    const float ct_o = clamp_min(pwz, 0.f);
    const float glossy = (((m[6] + 2.f) * F32(0.5 / kPi)) * an) * ct_o;
    const float diff = inv_pi() * ct_o;
    const float inv_p = 1.f / clamp_min(pdf_c, F32(1e-6));
    const float wgate = ((pdf_c > F32(1e-6) ? 1.f : 0.f)
                         * (valid ? 1.f : 0.f)) * inv_p;
    set_wo(pwx, pwy, pwz);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      s.w[ch] = (m[3 + ch] * glossy + m[ch] * diff) * wgate;
    s.pdf = pdf_c;
  } else if (mtype == kMatWard) {
    const float au = clamp_min(m[9], F32(1e-3));
    const float av = clamp_min(m[10], F32(1e-3));
    const float prob_s = spec_prob(m);
    const bool pick = uc < prob_s;
    // cos/sin of atan2(av·s0, au·c0) directly
    const float c0 = cosf(F32(2.0 * kPi) * u1);
    const float s0 = sinf(F32(2.0 * kPi) * u1);
    const float ac = au * c0, as = av * s0;
    const float hyp = sqrtf(clamp_min(ac * ac + as * as, F32(1e-20)));
    const float cp = ac / hyp, sp = as / hyp;
    const float qx = cp / au, qy = sp / av;
    const float t2 = (-logf(clamp_min(u0, F32(1e-7)))) / (qx * qx + qy * qy);
    const float cth = 1.f / sqrtf(1.f + t2);
    const float sth = sqrtf(clamp_min(1.f - cth * cth, 0.f));
    const float hx = sth * cp, hy = sth * sp, hz = cth;
    const float wih = dot_xyz(wix, wiy, wiz, hx, hy, hz);
    const float pwx = pick ? (2.f * wih) * hx - wix : c.x;
    const float pwy = pick ? (2.f * wih) * hy - wiy : c.y;
    const float pwz = pick ? (2.f * wih) * hz - wiz : c.z;
    const bool valid = up && pwz > 0.f;
    float spec, pdf_s;
    ward_terms(au, av, wix, wiy, wiz, pwx, pwy, pwz, spec, pdf_s);
    const float pdf_c = valid ? prob_s * pdf_s
                                    + ((1.f - prob_s) * pwz) * inv_pi()
                              : 0.f;
    const float wgate = ((pdf_c > F32(1e-6) ? 1.f : 0.f)
                         * (valid ? 1.f : 0.f))
                        / clamp_min(pdf_c, F32(1e-6));
    set_wo(pwx, pwy, pwz);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      s.w[ch] = ((m[ch] * inv_pi()) * pwz + (m[3 + ch] * spec) * pwz)
                * wgate;
    s.pdf = pdf_c;
  } else if (mtype == kMatThinDielectric) {
    // thin slab: delta reflect or pass through, internal bounces
    const float f0 = fresnel_diel_f(fabsf(wiz), clamp_min(m[0], F32(1e-3)));
    const float f = f0 < 1.f ? f0 + (((1.f - f0) * (1.f - f0)) * f0)
                                    / clamp_min(1.f - f0 * f0, F32(1e-7))
                             : f0;
    const bool pick = uc < f;
    set_wo(-wix, -wiy, pick ? wiz : -wiz);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s.w[ch] = pick ? m[1 + ch] : m[4 + ch];
    s.pdf = pick ? f : 1.f - f;
    s.delta = true;
  } else if (mtype == kMatDifftrans) {
    // diffuse transmitter: the cosine lobe on the far side
    const float sgnw = wiz >= 0.f ? 1.f : -1.f;
    set_wo(c.x, c.y, (-sgnw) * c.z);
    if (fabsf(wiz) > 0.f) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s.w[ch] = m[ch];
      s.pdf = pdf_cos;
    }
  } else if (mtype == kMatNull) {
    set_wo(-wix, -wiy, -wiz);
    s.w[0] = s.w[1] = s.w[2] = 1.f;
    s.pdf = 1.f;
    s.delta = true;
  } else if (kRp && mtype == kMatRoughPlastic) {
    // GGX lobe or cosine base, picked by the clamped Fresnel weight;
    // weight = f/pdf at the chosen wo
    const float a = clamp_min(m[9], F32(1e-4));
    const float prob_s = clamp_max(
        clamp_min(fresnel_diel_f(wiz, clamp_min(m[0], F32(1e-3))),
                  F32(0.25)), F32(0.9));
    const bool pick = uc < prob_s;
    float mx, my, mz;
    vndf(a, wix, wiy, wiz, u0, u1, mx, my, mz);
    const float wim = dot_xyz(wix, wiy, wiz, mx, my, mz);
    const float csx = pick ? (2.f * wim) * mx - wix : c.x;
    const float csy = pick ? (2.f * wim) * my - wiy : c.y;
    const float csz = pick ? (2.f * wim) * mz - wiz : c.z;
    float f[3], rp_pdf;
    rp_terms(m, wix, wiy, wiz, csx, csy, csz, f, rp_pdf);
    set_wo(csx, csy, csz);
    if (up && csz > 0.f && rp_pdf > F32(1e-12)) {
      const float inv_rp = 1.f / clamp_min(rp_pdf, F32(1e-12));
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s.w[ch] = f[ch] * inv_rp;
      s.pdf = rp_pdf;
    }
  } else if (mtype == kMatRoughDielectric) {
    // rough glass: a GGX visible normal from the upper-hemisphere wi, a
    // Fresnel lobe pick, weight = eval/pdf with the micronormal
    // re-derived from (wi, wo)
    const float eta = clamp_min(m[0], F32(1e-3));
    const float a = clamp_min(m[9], F32(1e-4));
    const float sw = wiz >= 0.f ? 1.f : -1.f;
    float mx, my, mz;
    vndf(a, wix * sw, wiy * sw, wiz * sw, u0, u1, mx, my, mz);
    const float wim = dot_xyz(wix, wiy, wiz, mx, my, mz);   // signed
    const bool outs = wim >= 0.f;
    const float eta_itm = outs ? eta : 1.f / eta;
    const float eta_tim = 1.f / eta_itm;
    const float cia = fabsf(wim);
    const float sin_t2 = (eta_tim * eta_tim) * (1.f - cia * cia);
    const bool tir = sin_t2 >= 1.f;
    const float cts = tir ? 0.f : sqrtf(clamp_min(1.f - sin_t2, F32(1e-12)));
    const float rs_ = (cia - eta_itm * cts)
                      / clamp_min(cia + eta_itm * cts, F32(1e-4));
    const float rp_ = (eta_itm * cia - cts)
                      / clamp_min(eta_itm * cia + cts, F32(1e-4));
    const float fre = tir ? 1.f : 0.5f * (rs_ * rs_ + rp_ * rp_);
    const float cos_tt = tir ? 0.f : (outs ? -cts : cts);
    const bool pick = uc < fre;
    float cx, cy, cz;
    if (pick) {
      cx = (2.f * wim) * mx - wix;
      cy = (2.f * wim) * my - wiy;
      cz = (2.f * wim) * mz - wiz;
    } else {
      const float wtf = eta_tim * wim + cos_tt;
      cx = (-eta_tim) * wix + wtf * mx;
      cy = (-eta_tim) * wiy + wtf * my;
      cz = (-eta_tim) * wiz + wtf * mz;
      normalize3(cx, cy, cz);
    }
    const RdTerms rd = rd_terms(m, wix, wiy, wiz, cx, cy, cz);
    const bool side_ok = pick ? wiz * cz > F32(1e-10) : wiz * cz < F32(-1e-10);
    set_wo(cx, cy, cz);
    if (rd.ok && fabsf(wiz) > F32(1e-7) && rd.pdf > F32(1e-12) && side_ok) {
      const float w_rd = rd.vs * (1.f / clamp_min(rd.pdf, F32(1e-12)));
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        s.w[ch] = w_rd * (rd.refl ? m[1 + ch] : m[4 + ch]);
      s.pdf = rd.pdf;
    }
    s.eta = pick ? 1.f : eta_itm;
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
    set_wo(pick_r ? -wix : (-scale) * wix, pick_r ? -wiy : (-scale) * wiy,
           pick_r ? wiz : cos_theta_t);
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
