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
// shared with the path megakernels in megakernel.cu): on a table with the
// front-to-back order tables (8 to 128 clusters, as the JAX package's
// _order_tables) the clusters nearest the warp's rays first, stopping once
// no cluster left can hold a closer hit (the TPU kernel's ordered branch,
// at the warp's granularity where the TPU takes a block of rays), else in
// index order up to the last real triangle; each cluster behind a
// per-lane slab gate, entered clusters scanned by their lanes when many
// enter and cooperatively, one ray at a time over the warp's 32 lanes,
// when few do; on a table of one walked cluster each lane walks its own
// ray (coop_walk picks the kernel's instantiation at launch, and the
// ordered walk is a cooperative one). Out-of-range and dead lanes take
// part in the walk with no ray of their own and report a miss.
//
// What bounds it on the H100: fp32 arithmetic. A ray-triangle test is ~40
// fp32 operations on 48 bytes of table, while a ray moves only 32 bytes
// in and 17 out; the cluster slab gate and the ordered walk's exit keep
// the test count down, and the cooperative branch keeps a warp whose rays
// diverge from running every triangle of every cluster any of its lanes
// enters.
//
// The walk writes its float operations with the _rn intrinsics, so nvcc
// cannot contract them into FMAs: the kernel rounds exactly as the plain
// PyTorch versions do, op for op (accel/dense.py for the hits,
// accel/trace.py ordered_walk_plain for the ordered walk's visits), and
// they agree bit for bit. Build defines of the walk: see
// trace_common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

using mitsuba_walk::Hit;
using mitsuba_walk::Ray;

// The launch bound asks for four blocks an SM at least, so ptxas does not
// trade spills for a higher occupancy (it spilled in the SIMT-walk build
// when the bound named threads alone). kCoop: mitsuba_walk::coop_walk;
// kOrdered: the ordered walk over `ord`.
template <bool kAnyHit, bool kCoop, bool kOrdered>
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
             uint8_t* __restrict__ hit_out,     // [N]
             mitsuba_walk::Order ord) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool want = i < n && (live == nullptr || live[i]);
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f};
  if (want) {
    r = Ray{ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2], ray_d[3 * i],
            ray_d[3 * i + 1], ray_d[3 * i + 2], mint_in[i], maxt_in[i]};
  }
  int visited = 0;
  const Hit h = mitsuba_walk::trace_ray_warp<kAnyHit, kCoop, kOrdered>(
      woop, aabb, tris, want, r, &ord, &visited);
  if (i >= n) return;
  if (kOrdered && ord.visits != nullptr && (i & 31) == 0)
    ord.visits[i >> 5] = visited;
  hit_out[i] = h.found;
  if (!kAnyHit) {
    t_out[i] = h.t;
    tri_out[i] = h.tri;
    u_out[i] = h.u;
    v_out[i] = h.v;
  }
}

template <bool kAnyHit>
using Kernel = decltype(&trace_kernel<kAnyHit, true, true>);

template <bool kAnyHit>
Kernel<kAnyHit> pick(bool coop, bool ordered) {
  return ordered ? trace_kernel<kAnyHit, true, true>
                 : coop ? trace_kernel<kAnyHit, true, false>
                        : trace_kernel<kAnyHit, false, false>;
}

}  // namespace

// Launches one trace on `stream` over the first n_tris triangles of the
// n_clusters-cluster table (the real ones: padding follows them), with
// the walk coop_walk picks; ordered where meta, order and odist (the
// order tables, [C, 8], [C, C], [C, C]) are not null, the walk is
// cooperative and MITSUBA_WALK_ORDER is on. Pointers are device
// pointers; t/tri/u/v may be null when any_hit != 0; visits
// ([ceil(n / 32)] int32, the cluster positions each warp of 32 rays
// stepped through) is written by the ordered walk where not null.
// Returns the cudaError_t of the launch.
extern "C" int mitsuba_trace(const void* woop, const void* aabb,
                             int n_clusters, int n_tris, const void* ray_o,
                             const void* ray_d, const void* mint,
                             const void* maxt, const void* live, int n,
                             int any_hit, void* t, void* tri, void* u,
                             void* v, void* hit, const void* meta,
                             const void* order, const void* odist,
                             void* visits, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const dim3 grid((n + threads - 1) / threads);
  const int tris = mitsuba_walk::walk_tris(n_tris, n_clusters);
  const bool coop = mitsuba_walk::coop_walk(tris);
  const bool ordered = MITSUBA_WALK_ORDER && coop && meta != nullptr
                       && order != nullptr && odist != nullptr;
  const mitsuba_walk::Order ord{static_cast<const float*>(meta),
                                static_cast<const int*>(order),
                                static_cast<const float*>(odist), n_clusters,
                                static_cast<int*>(visits)};
  const auto args = [&](auto kernel) {
    kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(woop), static_cast<const float*>(aabb),
        tris, static_cast<const float*>(ray_o),
        static_cast<const float*>(ray_d), static_cast<const float*>(mint),
        static_cast<const float*>(maxt), static_cast<const uint8_t*>(live),
        n, static_cast<float*>(t), static_cast<int*>(tri),
        static_cast<float*>(u), static_cast<float*>(v),
        static_cast<uint8_t*>(hit), ord);
  };
  if (any_hit) {
    args(pick<true>(coop, ordered));
  } else {
    args(pick<false>(coop, ordered));
  }
  return static_cast<int>(cudaGetLastError());
}
