// Device helpers shared by the path megakernel (megakernel.cu) and the
// fused shade kernel (shade.cu), for Hopper (sm_90a): the integrator's
// vector and MIS helpers, the PCG4D counter RNG, shading frames and the
// cosine-hemisphere warp.
//
// Each function writes its float expression in the order of the PyTorch
// code it mirrors (named beside it); an including file is compiled with
// -fmad=false, so every operation rounds as PyTorch's eager ops do.
// sqrtf and division are IEEE; rsqrtf, cosf and sinf are the same library
// calls PyTorch makes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Python float constants of the plain versions, rounded to float32 as
// PyTorch rounds a scalar operand of a float32 op
#define F32(x) static_cast<float>(x)

namespace mitsuba_path {

constexpr double kPi = 3.141592653589793;

struct V3 {
  float x, y, z;
};

// torch's CUDA sum over a contiguous length-3 last axis: the axis is split
// over two lanes, {a, c} and {b}, whose partial sums are then added.
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
// torch.clamp(x, min=lo) / (x, max=hi): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float sign_of(float x) {  // torch.sign
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}
__device__ __forceinline__ float max_abs3(V3 p) {
  return fmaxf(fmaxf(fabsf(p.x), fabsf(p.y)), fabsf(p.z));
}
__device__ __forceinline__ bool any_pos(V3 v) {
  return v.x > 0.f || v.y > 0.f || v.z > 0.f;
}
__device__ __forceinline__ V3 row3(const float* p) {
  return V3{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// integrator/common.py
__device__ __forceinline__ float ray_mint(V3 p) {
  return F32(1e-4) * (1.f + max_abs3(p));
}
__device__ __forceinline__ V3 offset_ray_origin(V3 p, V3 ng, V3 d) {
  const float eps = F32(1e-4) * (1.f + max_abs3(p));
  const float se = sign_of(dot3(d, ng)) * eps;
  return V3{p.x + se * ng.x, p.y + se * ng.y, p.z + se * ng.z};
}
__device__ __forceinline__ float mis_power(float pdf_a, float pdf_b) {
  float r = pdf_b / clamp_min(pdf_a, F32(1e-6));
  r = clamp_max(clamp_min(r, 0.f), F32(1e6));
  return pdf_a > 0.f ? 1.f / (1.f + r * r) : 0.f;
}
// core/math.py safe_div
__device__ __forceinline__ float safe_div(float a, float b) {
  const float eps = F32(1e-8);
  return a / (fabsf(b) < eps ? (b < 0.f ? -eps : eps) : b);
}

// core/rng.py: PCG4D on the counter [pixel, dim, seed, samp + 0x9E3779B9]
__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z,
                                      uint32_t& w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
}
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return static_cast<float>(bits >> 8) * F32(1.0 / 16777216.0);
}
__device__ __forceinline__ float2 rng2(uint32_t seed, uint32_t pixel,
                                       uint32_t dim, uint32_t samp) {
  uint32_t x = pixel, y = dim, z = seed, w = samp + 0x9E3779B9u;
  pcg4d(x, y, z, w);
  return make_float2(to_unit(x), to_unit(y));
}

// core/math.py coordinate_system (Duff et al.)
__device__ __forceinline__ void coordinate_system(V3 n, V3& s, V3& t) {
  const float sg = n.z >= 0.f ? 1.f : -1.f;
  const float a = -(1.f / (sg + n.z));
  const float b = (n.x * n.y) * a;
  s = V3{1.f + ((sg * n.x) * n.x) * a, sg * b, -sg * n.x};
  t = V3{b, sg + (n.y * n.y) * a, -n.y};
}
__device__ __forceinline__ V3 to_local(V3 s, V3 t, V3 n, V3 v) {
  return V3{dot3(v, s), dot3(v, t), dot3(v, n)};
}

// core/warp.py square_to_uniform_disk_concentric (Shirley-Chiu)
__device__ __forceinline__ void concentric_disk(float u0, float u1, float& px,
                                                float& py) {
  const float ox = 2.f * u0 - 1.f, oy = 2.f * u1 - 1.f;
  const bool is_zero = ox == 0.f && oy == 0.f;
  const bool use_x = fabsf(ox) > fabsf(oy);
  float r = use_x ? ox : oy;
  float ratio = use_x ? oy / (ox == 0.f ? 1.f : ox)
                      : ox / (oy == 0.f ? 1.f : oy);
  ratio = is_zero ? 0.f : ratio;
  const float phi = use_x ? ratio * F32(kPi / 4.0)
                          : F32(kPi / 2.0) - ratio * F32(kPi / 4.0);
  r = is_zero ? 0.f : r;
  px = r * cosf(phi);
  py = r * sinf(phi);
}

// core/warp.py square_to_cosine_hemisphere (concentric disk + lift)
__device__ __forceinline__ V3 cosine_hemisphere(float u0, float u1) {
  float px, py;
  concentric_disk(u0, u1, px, py);
  return V3{px, py, sqrtf(clamp_min((1.f - px * px) - py * py, 0.f))};
}

// core/warp.py square_to_uniform_sphere (lat-long, warp.h:43)
__device__ __forceinline__ V3 uniform_sphere(float u0, float u1) {
  const float z = 1.f - 2.f * u0;
  const float r = sqrtf(clamp_min(1.f - z * z, 0.f));
  const float phi = F32(2.0 * kPi) * u1;
  return V3{r * cosf(phi), r * sinf(phi), z};
}

}  // namespace mitsuba_path
