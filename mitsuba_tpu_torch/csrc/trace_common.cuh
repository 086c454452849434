// The cluster walk shared by the trace kernel (trace.cu) and the path
// megakernel (megakernel.cu): one ray against Woop-transformed 64-triangle
// clusters, for Hopper (sm_90a).
//
// Clusters are visited in index order; each is slab-tested against the ray
// with the far bound min(maxt, t_best), and an entered cluster's 64
// triangles are tested in index order. The best hit is replaced only on a
// strictly smaller t, so among equal t the lowest triangle index wins, as
// in the plain version (accel/dense.py) and the Pallas kernels. Any-hit
// mode returns at the first valid hit.
//
// Float operations are written with the _rn intrinsics so nvcc cannot
// contract them into FMAs, whatever the including file's flags: the walk
// then rounds exactly as the plain PyTorch version does, op for op, and
// the two agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mitsuba_walk {

constexpr int kTrisPerCluster = 64;  // build_woop_clustered's cluster size
constexpr float kMiss = 1e30f;       // t reported for a miss
constexpr float kDzEps = 1e-12f;     // |d'_z| below this: ray parallel
// Relative slack on the slab test: entering a cluster never changes the
// result, so the gate is widened to stay conservative under rounding for
// hits that lie on a cluster's bounding box (flat walls, shared vertices).
constexpr float kSlabSlack = 1e-5f;

__device__ __forceinline__ float safe_inv(float x) {
  return fabsf(x) < 1e-12f ? (x >= 0.f ? 1e30f : -1e30f) : __frcp_rn(x);
}

// ((a.x*x + a.y*y) + a.z*z) + w, rounded after every operation.
__device__ __forceinline__ float affine(float4 a, float x, float y, float z,
                                        float w) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.x, x), __fmul_rn(a.y, y)),
                             __fmul_rn(a.z, z)), w);
}

struct Hit {
  float t, u, v;
  int tri;
  bool found;
};

// One ray (o, d) within (mint, maxt) against clusters woop [C, 3*64]
// (float4 rows w0, w1, w2, translation) gated by aabb [C, 8]. A miss
// reports t = kMiss, tri = 0, u = v = 0 and found = false.
template <bool kAnyHit>
__device__ __forceinline__ Hit trace_ray(
    const float4* __restrict__ woop, const float* __restrict__ aabb,
    int n_clusters, float ox, float oy, float oz, float dx, float dy,
    float dz, float mint, float maxt) {
  Hit h{kMiss, 0.f, 0.f, 0, false};
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  for (int c = 0; c < n_clusters && !(kAnyHit && h.found); ++c) {
    // row c: (min x, min y, min z, max x) then (max y, max z)
    const float4 r0 = __ldg(reinterpret_cast<const float4*>(aabb + 8 * c));
    const float2 r1 = __ldg(reinterpret_cast<const float2*>(aabb + 8 * c + 4));
    const float lx = r0.x, ly = r0.y, lz = r0.z;
    const float hx = r0.w, hy = r1.x, hz = r1.y;
    if (lx > hx || ly > hy || lz > hz) continue;  // padding cluster
    const float t0x = (lx - ox) * ix, t1x = (hx - ox) * ix;
    const float t0y = (ly - oy) * iy, t1y = (hy - oy) * iy;
    const float t0z = (lz - oz) * iz, t1z = (hz - oz) * iz;
    const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), mint));
    const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                            fminf(fmaxf(t0z, t1z), fminf(maxt, h.t)));
    if (near > far + kSlabSlack * fabsf(far)) continue;
    const float4* w = woop + (size_t)c * 3 * kTrisPerCluster;
    for (int k = 0; k < kTrisPerCluster; ++k) {
      const float4 wx = __ldg(w + k);
      const float4 wy = __ldg(w + kTrisPerCluster + k);
      const float4 wz = __ldg(w + 2 * kTrisPerCluster + k);
      const float dpz = affine(wz, dx, dy, dz, 0.f);
      if (fabsf(dpz) < kDzEps) continue;
      const float opz = affine(wz, ox, oy, oz, wz.w);
      const float t = __fdiv_rn(-opz, dpz);
      if (!(t > mint && t < maxt && t < h.t)) continue;
      const float u = __fadd_rn(affine(wx, ox, oy, oz, wx.w),
                                __fmul_rn(t, affine(wx, dx, dy, dz, 0.f)));
      const float v = __fadd_rn(affine(wy, ox, oy, oz, wy.w),
                                __fmul_rn(t, affine(wy, dx, dy, dz, 0.f)));
      if (fminf(fminf(u, v), __fsub_rn(__fsub_rn(1.f, u), v)) < 0.f) continue;
      h.found = true;
      if (kAnyHit) break;
      h.t = t;
      h.u = u;
      h.v = v;
      h.tri = c * kTrisPerCluster + k;
    }
  }
  return h;
}

}  // namespace mitsuba_walk
