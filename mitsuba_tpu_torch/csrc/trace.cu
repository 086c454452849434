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
// Design: one thread per ray, 128 threads a block; the warp walks the
// clusters together with mitsuba_walk::trace_ray_warp (trace_common.cuh,
// shared with the path megakernels in megakernel.cu): clusters in index
// order up to the last real triangle behind a per-lane slab gate, entered
// clusters scanned by their lanes when many enter and cooperatively, one
// ray at a time over the warp's 32 lanes, when few do; on a table of one
// walked cluster each lane walks its own ray (coop_walk picks the
// kernel's instantiation at launch). Out-of-range and dead lanes take
// part in the walk with no ray of their own.
//
// What bounds it on the H100: fp32 arithmetic. A ray-triangle test is ~40
// fp32 operations on 48 bytes of table, while a ray moves only 32 bytes
// in and 17 out; the cluster slab gate keeps the test count down, and the
// cooperative branch keeps a warp whose rays diverge from running every
// triangle of every cluster any of its lanes enters. The TPU kernel's
// front-to-back ordered walk with early exit is not ported yet.
//
// The walk writes its float operations with the _rn intrinsics, so nvcc
// cannot contract them into FMAs: the kernel rounds exactly as the plain
// PyTorch version does, op for op, and the two agree bit for bit.
// Build defines of the walk: see trace_common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

using mitsuba_walk::Hit;
using mitsuba_walk::Ray;

// The launch bound asks for four blocks an SM at least, so ptxas does not
// trade spills for a higher occupancy (it spilled in the SIMT-walk build
// when the bound named threads alone). kCoop: mitsuba_walk::coop_walk.
template <bool kAnyHit, bool kCoop>
__global__ void __launch_bounds__(128, 4)
trace_kernel(const float4* __restrict__ woop,   // [C, 3*64] (w0,w1,w2,tr)
             const float* __restrict__ aabb,    // [C, 8] min xyz, max xyz
             int tris,                          // walk_tris
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
  const bool want = i < n && (live == nullptr || live[i]);
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f};
  if (want) {
    r = Ray{ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2], ray_d[3 * i],
            ray_d[3 * i + 1], ray_d[3 * i + 2], mint_in[i], maxt_in[i]};
  }
  const Hit h = mitsuba_walk::trace_ray_warp<kAnyHit, kCoop>(woop, aabb, tris,
                                                             want, r);
  if (i >= n) return;
  hit_out[i] = h.found;
  if (!kAnyHit) {
    t_out[i] = h.t;
    tri_out[i] = h.tri;
    u_out[i] = h.u;
    v_out[i] = h.v;
  }
}

}  // namespace

// Launches one trace on `stream` over the first n_tris triangles of the
// n_clusters-cluster table (the real ones: padding follows them), with
// the walk coop_walk picks. Pointers are device pointers; t/tri/u/v may
// be null when any_hit != 0. Returns the cudaError_t of the launch.
extern "C" int mitsuba_trace(const void* woop, const void* aabb,
                             int n_clusters, int n_tris, const void* ray_o,
                             const void* ray_d, const void* mint,
                             const void* maxt, const void* live, int n,
                             int any_hit, void* t, void* tri, void* u,
                             void* v, void* hit, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const dim3 grid((n + threads - 1) / threads);
  const int tris = mitsuba_walk::walk_tris(n_tris, n_clusters);
  const bool coop = mitsuba_walk::coop_walk(tris);
  const auto kernel = any_hit ? (coop ? trace_kernel<true, true>
                                      : trace_kernel<true, false>)
                              : (coop ? trace_kernel<false, true>
                                      : trace_kernel<false, false>);
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(woop), static_cast<const float*>(aabb),
      tris, static_cast<const float*>(ray_o),
      static_cast<const float*>(ray_d), static_cast<const float*>(mint),
      static_cast<const float*>(maxt), static_cast<const uint8_t*>(live), n,
      static_cast<float*>(t), static_cast<int*>(tri), static_cast<float*>(u),
      static_cast<float*>(v), static_cast<uint8_t*>(hit));
  return static_cast<int>(cudaGetLastError());
}
