// The megakernel bounce's cost by component, on Hopper (sm_90a): n_iter
// bounces of every lane in one launch, with no regeneration and no early
// exit, under seven variants that stub parts of the bounce.
//
// Replaces the Pallas TPU kernel of experiments/_exp_ablate.py::run_fixed
// (:106-175, launched at :154), which loops the JAX megakernel bounce over
// a [16, 8192] state in a fori_loop of 512 steps with the closest-hit
// trace, the shadow trace, the hit record's select or the shading swapped
// for stubs (:37-103). Here the bounce is the megakernels' own
// (mega_common.cuh path_bounce, kExt = kTex = false) and each variant is a
// policy for its two traces, one template instantiation each:
//
//   0 full bounce              WarpTraces: both warp walks
//   1 no shadow trace          the any-hit walk replaced by "occluded"
//                              (the TPU stub's t = 1 < _MISS: no NEE)
//   2 no closest trace         the closest walk replaced by a hit at t = 1
//                              on the stub record
//   3 no traces                1 and 2 together
//   4 no attr select           the closest walk for t and found, the stub
//                              record in place of the hit triangle's row:
//                              on the card this takes out the gather of
//                              the hit's 25-float row (the TPU kernel's
//                              per-candidate select, :46, stood there)
//   5 closest = transform only the closest walk replaced by the Woop
//                              transform of o and d against all 64 rows of
//                              every cluster of the table (padding
//                              included, as the TPU stub loops), summed
//                              and min-reduced per cluster into an
//                              accumulator: t = 1 + 0·acc on the stub
//                              record
//   6 traces only (no shading) noshade: the closest walk, a shadow walk
//                              from o + (0.01, 0, 0) along (dy, dz, dx),
//                              and the TPU stub's small state update
//                              (_bounce_noshade, :81-103)
//
// Each step is bounce `bounce0 + step` of lane i's path at pixel i, sample
// 0, seed 1, with Russian roulette from depth 99 and no depth bound
// (max_depth 0); after it the lane is kept alive as the TPU probe keeps it
// (:129-135): rows 0:6 as returned, the throughput max(·, 0.25) (NaN
// kept), L times 0, active 1, rows 13:16 as returned. The stub record is
// the hit the TPU stub's docstring means (:26-27): ng = vn0 = (0, 1, 0),
// vn1 - vn0 = vn2 - vn0 = 0, material 0, emitter -1, uv 0, the other rows
// 0; it is a 25-float array of its own, passed by pointer, read at row 0
// with barycentrics (0, 0) (so the shading normal is (0, 1, 0) exactly).
//
// Output [18, N]: the 16 state rows, then per lane the closest rays that
// reported a hit and the shadow rays traced that reported occluded over
// the launch (the policies count them; they also keep variant 6's shadow
// walk, whose result nothing else reads, from being optimized away).
//
// What bounds it on the H100: what bounds the megakernels (megakernel.cu):
// fp32 instructions and warp divergence; variant 5 is the fp32 work of the
// transform alone, ~39 operations a row for every row of the table, which
// every lane of a warp reads at the same address (a broadcast from L1).
// The build is -fmad=false without fast-math, so variant 5's 0·acc is not
// folded: acc could be Inf or NaN.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mega_common.cuh"

namespace {

using namespace mitsuba_mega;

constexpr int kThreads = 128;
constexpr uint32_t kSeed = 1;     // the TPU probe's jnp.int32(1)
constexpr int kRrDepth = 99;      // its rr_depth, no roulette in 98 bounces
constexpr int kMaxDepth = 0;      // unbounded

enum Variant {
  kFull = 0, kNoShadow, kNoClosest, kNoTraces, kNoAttr, kTransform,
  kNoShade, kVariants
};

// The hit a stubbed closest trace reports: row 0 of the stub record at
// barycentrics (0, 0), at t (found where the lane traces and t < kMiss).
__device__ __forceinline__ Hit stub_hit(float t, bool want) {
  return Hit{t, 0.f, 0.f, 0, want && t < kMiss};
}

// The variants' policy for path_bounce's two traces (WarpTraces' members),
// counting the closest rays that hit and the shadow rays reported occluded.
template <int kVariant, bool kCoop>
struct AblateTraces {
  const float* stub;   // the stub record, kAttr floats
  int n_clusters;      // clusters of the table (variant 5's loop)
  float hits = 0.f, occl = 0.f;

  __device__ __forceinline__ Hit closest(const Tables& T, bool want,
                                         const Ray& r) {
    Hit h;
    if (kVariant == kNoClosest || kVariant == kNoTraces) {
      h = stub_hit(1.f, want);
    } else if (kVariant == kTransform) {
      h = stub_hit(want ? 1.f + 0.f * transform_acc(T, r) : kMiss, want);
    } else {
      h = trace_ray_warp<false, kCoop>(T.woop, T.aabb, T.tris, want, r);
      if (kVariant == kNoAttr) h = Hit{h.t, 0.f, 0.f, 0, h.found};
    }
    hits += h.found ? 1.f : 0.f;
    return h;
  }

  __device__ __forceinline__ const float* records(const Tables& T) const {
    return kVariant == kNoClosest || kVariant == kNoTraces
                   || kVariant == kNoAttr || kVariant == kTransform
               ? stub : T.attr;
  }

  __device__ __forceinline__ bool occluded(const Tables& T, bool want,
                                           const Ray& r) {
    const bool occ =
        kVariant == kNoShadow || kVariant == kNoTraces
            ? true
            : trace_ray_warp<true, kCoop>(T.woop, T.aabb, T.tris, want, r)
                  .found;
    occl += want && occ ? 1.f : 0.f;
    return occ;
  }

  // the TPU stub's transform-only loop (_exp_ablate.py:47-68): for each
  // cluster the min over its 64 rows of
  // ((((o'x + o'y) + o'z) + d'x) + d'y) + d'z, o' = ((w0·ox + w1·oy) +
  // w2·oz) + w3 and d' = (w0·dx + w1·dy) + w2·dz, summed over the clusters
  __device__ __forceinline__ float transform_acc(const Tables& T,
                                                 const Ray& r) const {
    constexpr int kTc = mitsuba_walk::kTrisPerCluster;
    float acc = 0.f;
    for (int c = 0; c < n_clusters; ++c) {
      const float4* w = T.woop + (size_t)c * 3 * kTc;
      float m = 0.f;
#pragma unroll 4
      for (int k = 0; k < kTc; ++k) {
        const float4 wx = __ldg(w + k), wy = __ldg(w + kTc + k);
        const float4 wz = __ldg(w + 2 * kTc + k);
        const float opx = ((wx.x * r.ox + wx.y * r.oy) + wx.z * r.oz) + wx.w;
        const float opy = ((wy.x * r.ox + wy.y * r.oy) + wy.z * r.oz) + wy.w;
        const float opz = ((wz.x * r.ox + wz.y * r.oy) + wz.z * r.oz) + wz.w;
        const float dpx = (wx.x * r.dx + wx.y * r.dy) + wx.z * r.dz;
        const float dpy = (wy.x * r.dx + wy.y * r.dy) + wy.z * r.dz;
        const float dpz = (wz.x * r.dx + wz.y * r.dy) + wz.z * r.dz;
        const float v = ((((opx + opy) + opz) + dpx) + dpy) + dpz;
        m = k == 0 ? v : fminf(m, v);
      }
      acc = acc + m;
    }
    return acc;
  }
};

// Variant 6, _bounce_noshade (:81-103): the closest walk from o along d
// over (mint, 1e30), mint = 1e-4·(1 + |ox|), and a shadow walk from
// o + (0.01, 0, 0) along (dy, dz, dx) over (mint, 5e29); then o += 0.001·t·d
// (t 1 on a miss), throughput ·0.999, L += 0.0001·ng of the hit (0 on a
// miss), the other rows as they were. All 32 lanes of a warp call it
// together; want: the lane is a real one.
template <bool kCoop>
__device__ __forceinline__ void noshade(const Tables& T, State& s, bool want,
                                        float& hits, float& occl) {
  const float mint = 1e-4f * (1.f + fabsf(s.o.x));
  const Hit h = trace_ray_warp<false, kCoop>(
      T.woop, T.aabb, T.tris, want,
      Ray{s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z, mint, kMiss});
  const bool occ = trace_ray_warp<true, kCoop>(
      T.woop, T.aabb, T.tris, want,
      Ray{s.o.x + 0.01f, s.o.y, s.o.z, s.d.y, s.d.z, s.d.x, mint,
          kMiss * 0.5f}).found;
  hits += h.found ? 1.f : 0.f;
  occl += want && occ ? 1.f : 0.f;
  if (!want) return;
  const float k = 0.001f * (h.found ? h.t : 1.f);
  const V3 ng = h.found ? row3(T.attr + h.tri * kAttr) : V3{0.f, 0.f, 0.f};
  s.o = V3{s.o.x + k * s.d.x, s.o.y + k * s.d.y, s.o.z + k * s.d.z};
  s.tp = V3{s.tp.x * 0.999f, s.tp.y * 0.999f, s.tp.z * 0.999f};
  s.L = V3{s.L.x + 0.0001f * ng.x, s.L.y + 0.0001f * ng.y,
           s.L.z + 0.0001f * ng.z};
}

// max(x, 0.25) that keeps a NaN, as jnp.maximum and torch.maximum do
__device__ __forceinline__ float keep_tp(float x) {
  return x > 0.25f || x != x ? x : 0.25f;
}

// The probe's keep-alive step after each bounce (:129-135).
__device__ __forceinline__ void keep_alive(State& s) {
  s.tp = V3{keep_tp(s.tp.x), keep_tp(s.tp.y), keep_tp(s.tp.z)};
  s.L = V3{s.L.x * 0.f, s.L.y * 0.f, s.L.z * 0.f};
  s.active = 1.f;
}

// One thread per lane, n_iter steps; a lane past n runs along inactive
// (the warp walks need all 32 lanes) and stores nothing. Four blocks an
// SM, as the megakernels' instantiations without kExt.
template <int kVariant, bool kCoop>
__global__ void __launch_bounds__(kThreads, 4)
ablate_kernel(Tables T, const float* __restrict__ stub, int n_clusters,
              const float* __restrict__ in, float* __restrict__ out, int n,
              int n_iter, int bounce0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < n;
  State s{};
  if (lane_ok) s = load_state(in, n, i);
  AblateTraces<kVariant, kCoop> tr{stub, n_clusters};
  for (int it = 0; it < n_iter; ++it) {
    if (kVariant == kNoShade) {
      noshade<kCoop>(T, s, lane_ok, tr.hits, tr.occl);
    } else {
      bool traced, shadow;
      path_bounce<kCoop, false, false>(
          T, s, kSeed, lane_ok ? static_cast<uint32_t>(i) : 0u, 0u,
          bounce0 + it, kMaxDepth, kRrDepth, traced, shadow, tr);
    }
    if (lane_ok) keep_alive(s);
  }
  if (!lane_ok) return;
  store_state(out, n, i, s);
  out[kState * n + i] = tr.hits;
  out[(kState + 1) * n + i] = tr.occl;
}

typedef void (*AblateFn)(Tables, const float*, int, const float*, float*,
                         int, int, int);

template <bool kCoop>
AblateFn variant_kernel(int variant) {
  switch (variant) {
    case kFull: return ablate_kernel<kFull, kCoop>;
    case kNoShadow: return ablate_kernel<kNoShadow, kCoop>;
    case kNoClosest: return ablate_kernel<kNoClosest, kCoop>;
    case kNoTraces: return ablate_kernel<kNoTraces, kCoop>;
    case kNoAttr: return ablate_kernel<kNoAttr, kCoop>;
    case kTransform: return ablate_kernel<kTransform, kCoop>;
    case kNoShade: return ablate_kernel<kNoShade, kCoop>;
    default: return nullptr;
  }
}

}  // namespace

// C entry point (ctypes, experiments/ablate.py): the tables as the
// megakernels' entry points take them (device pointers; n_tris the real
// triangles; the kExt = false bounce, so no medium, no composite and area
// emitters only), the stub record (25 device floats), the [16, n] state in
// and the [18, n] out, the steps, the first step's bounce index and the
// variant 0-6. Launches on `stream` under the walk coop_walk picks and
// returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// variant out of range).
extern "C" int mitsuba_ablate(const void* woop, const void* aabb,
                              int n_clusters, int n_tris, const void* attr,
                              const void* mat, const void* em_rows,
                              int et_real, const void* em_meta,
                              const void* em_cdf, int n_em, const void* stub,
                              const void* state_in, void* state_out, int n,
                              int n_iter, int bounce0, int variant,
                              void* stream) {
  if (variant < 0 || variant >= kVariants) return 1;
  if (n <= 0) return 0;
  const Tables T = make_tables(woop, aabb, n_clusters, n_tris, attr, mat,
                               em_rows, et_real, em_meta, em_cdf, n_em, -1,
                               nullptr);
  const AblateFn kernel = mitsuba_walk::coop_walk(T.tris)
                              ? variant_kernel<true>(variant)
                              : variant_kernel<false>(variant);
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      T, static_cast<const float*>(stub), n_clusters,
      static_cast<const float*>(state_in), static_cast<float*>(state_out), n,
      n_iter, bounce0);
  return static_cast<int>(cudaGetLastError());
}
