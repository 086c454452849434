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
// Design: one thread per ray, each walking the clusters with
// mitsuba_walk::trace_ray (trace_common.cuh, shared with the path
// megakernel in megakernel.cu): clusters in index order behind a slab gate,
// triangles in index order, the best hit replaced only on a strictly
// smaller t, so the lowest triangle index wins among equal t as in the
// plain version (accel/dense.py) and the Pallas kernels. Any-hit mode
// returns at the first valid hit.
//
// What bounds it on the H100: fp32 arithmetic. A ray-triangle test is ~40
// fp32 operations on 48 bytes of table that every thread of a warp reads at
// the same address (a broadcast from L1), while a ray moves only 32 bytes in
// and 17 out; the cluster slab gate is what keeps the test count down. The
// TPU kernel's front-to-back ordered walk with early exit is not ported yet.
//
// The walk writes its float operations with the _rn intrinsics, so nvcc
// cannot contract them into FMAs: the kernel rounds exactly as the plain
// PyTorch version does, op for op, and the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

using mitsuba_walk::Hit;
using mitsuba_walk::kMiss;

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
  Hit h{kMiss, 0.f, 0.f, 0, false};
  if (live == nullptr || live[i]) {
    h = mitsuba_walk::trace_ray<kAnyHit>(
        woop, aabb, n_clusters, ray_o[3 * i], ray_o[3 * i + 1],
        ray_o[3 * i + 2], ray_d[3 * i], ray_d[3 * i + 1], ray_d[3 * i + 2],
        mint_in[i], maxt_in[i]);
  }
  hit_out[i] = h.found;
  if (!kAnyHit) {
    t_out[i] = h.t;
    tri_out[i] = h.tri;
    u_out[i] = h.u;
    v_out[i] = h.v;
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
