// Closest-hit / any-hit ray tracing against Woop-transformed triangle
// clusters, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels mitsuba_tpu/accel/pallas_trace.py::
// _trace_kernel_fused (whole cluster table resident, in-kernel cluster
// loop) and ::_trace_kernel (the ray-block x cluster grid used past 8 MB of
// table). Both compute the same function, and so does this kernel, at any
// table size: the table is read from global memory through the read-only
// cache, so no size switch is needed.
//
// Design: one thread per ray. Clusters are visited in index order; each is
// slab-tested against the ray with the far bound min(maxt, t_best), and an
// entered cluster's 64 triangles are tested in index order. The best hit is
// replaced only on a strictly smaller t, so among equal t the lowest
// triangle index wins, as in the plain version (accel/dense.py) and the
// Pallas kernels. Any-hit mode returns at the first valid hit.
//
// What bounds it on the H100: fp32 arithmetic. A ray-triangle test is ~40
// fp32 operations on 48 bytes of table that every thread of a warp reads at
// the same address (a broadcast from L1), while a ray moves only 32 bytes in
// and 17 out; the cluster slab gate is what keeps the test count down. The
// TPU kernel's front-to-back ordered walk with early exit is not ported yet.
//
// Float operations are written with the _rn intrinsics so nvcc cannot
// contract them into FMAs: the kernel then rounds exactly as the plain
// PyTorch version does, op for op, and the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <bool kAnyHit>
__global__ void __launch_bounds__(128)
trace_kernel(const float4* __restrict__ woop,   // [C, 3*64] (w0,w1,w2,tr)
             const float* __restrict__ aabb,    // [C, 8] min xyz, max xyz
             int n_clusters,
             const float* __restrict__ ray_o,   // [N, 3]
             const float* __restrict__ ray_d,   // [N, 3]
             const float* __restrict__ mint_in, // [N]
             const float* __restrict__ maxt_in, // [N]
             const uint8_t* __restrict__ live,  // [N] or null
             int n,
             float* __restrict__ t_out,         // [N] (closest hit only)
             int* __restrict__ tri_out,
             float* __restrict__ u_out,
             float* __restrict__ v_out,
             uint8_t* __restrict__ hit_out) {   // [N]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t_best = kMiss, u_best = 0.f, v_best = 0.f;
  int tri_best = 0;
  bool found = false;
  if (live == nullptr || live[i]) {
    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1],
                oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1],
                dz = ray_d[3 * i + 2];
    const float mint = mint_in[i], maxt = maxt_in[i];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    for (int c = 0; c < n_clusters && !(kAnyHit && found); ++c) {
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
                              fminf(fmaxf(t0z, t1z), fminf(maxt, t_best)));
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
        if (!(t > mint && t < maxt && t < t_best)) continue;
        const float u = __fadd_rn(affine(wx, ox, oy, oz, wx.w),
                                  __fmul_rn(t, affine(wx, dx, dy, dz, 0.f)));
        const float v = __fadd_rn(affine(wy, ox, oy, oz, wy.w),
                                  __fmul_rn(t, affine(wy, dx, dy, dz, 0.f)));
        if (fminf(fminf(u, v), __fsub_rn(__fsub_rn(1.f, u), v)) < 0.f) continue;
        found = true;
        if (kAnyHit) break;
        t_best = t;
        u_best = u;
        v_best = v;
        tri_best = c * kTrisPerCluster + k;
      }
    }
  }
  hit_out[i] = found;
  if (!kAnyHit) {
    t_out[i] = t_best;
    tri_out[i] = tri_best;
    u_out[i] = u_best;
    v_out[i] = v_best;
  }
}

}  // namespace

// Launches one trace on `stream`. Pointers are device pointers; t/tri/u/v
// may be null when any_hit != 0. Returns the cudaError_t of the launch.
extern "C" int mitsuba_trace(const void* woop, const void* aabb,
                             int n_clusters, const void* ray_o,
                             const void* ray_d, const void* mint,
                             const void* maxt, const void* live, int n,
                             int any_hit, void* t, void* tri, void* u,
                             void* v, void* hit, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const dim3 grid((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* w = static_cast<const float4*>(woop);
  const float* a = static_cast<const float*>(aabb);
  const float* o = static_cast<const float*>(ray_o);
  const float* d = static_cast<const float*>(ray_d);
  const float* lo = static_cast<const float*>(mint);
  const float* hi = static_cast<const float*>(maxt);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  uint8_t* h = static_cast<uint8_t*>(hit);
  if (any_hit) {
    trace_kernel<true><<<grid, threads, 0, s>>>(
        w, a, n_clusters, o, d, lo, hi, lv, n, nullptr, nullptr, nullptr,
        nullptr, h);
  } else {
    trace_kernel<false><<<grid, threads, 0, s>>>(
        w, a, n_clusters, o, d, lo, hi, lv, n, static_cast<float*>(t),
        static_cast<int*>(tri), static_cast<float*>(u),
        static_cast<float*>(v), h);
  }
  return static_cast<int>(cudaGetLastError());
}
