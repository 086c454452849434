// The cluster walk shared by the trace kernel (trace.cu), the path
// megakernels (megakernel.cu), the fused shade kernel (shade.cu) and the
// trace-only probe (roofline.cu): rays against Woop-transformed
// 64-triangle clusters, for Hopper (sm_90a).
//
// Three walks compute the same function:
//  - trace_ray, one ray per thread by itself (SIMT): clusters in index
//    order, each slab-tested against the ray with the far bound
//    min(maxt, t_best), an entered cluster's triangles in index order.
//    trace_ray_warp runs it for each wanting lane where the walk is not
//    cooperative (coop_walk).
//  - trace_ray_warp, called by all 32 lanes of a warp at once, each with
//    its own ray and a `want` flag. On a table of more than one walked
//    cluster (coop_walk; else each lane runs trace_ray) the warp loops
//    over the clusters in index order; each wanting lane slab-tests the
//    cluster as trace_ray does and __ballot_sync gathers the lanes that
//    enter. When many enter (kCoopFrom of 32 for a full cluster), those
//    lanes scan the cluster themselves, as trace_ray would. When fewer
//    enter, the warp takes them one at a time: the lane's ray is
//    broadcast with __shfl_sync, lane l tests triangles l and l + 32
//    (coalesced 16-byte rows: row k*64 + t of build_woop_clustered), and
//    a reduction over the warp hands the closest hit (smallest t, then
//    lowest index) to the ray's lane. SIMT lanes run the union of the
//    clusters their lanes enter, each for all its triangles; the
//    cooperative branch spends 2 triangle tests a lane on each (ray,
//    cluster) pair that some lane enters.
//  - trace_ray_warp<.., kOrdered = true> (the trace kernel only, on tables
//    of 8 to 128 clusters; port of the ordered branch of
//    mitsuba_tpu/accel/pallas_trace.py::_trace_kernel_fused): the
//    cooperative walk over the clusters front to back, in the order of
//    build_cluster_order's row for a hint cluster k (the centre nearest
//    the warp's first wanting origin, scored 4 centres a lane and reduced
//    with shuffles), stopping once no cluster left can hold a closer hit:
//    every kExitEvery clusters the warp stops when
//    (odist[k][i] - d_box) - r_max exceeds the largest min(t_best, cap)
//    · |d| over its lanes still looking (d_box: the farthest corner of
//    their origins' box from k's centre; cap: min(maxt, t_exit·1.001 +
//    1e-3), t_exit the ray's exit from the scene box). Scaling by |d|
//    makes the test compare distances with distances for any direction;
//    the reference compares them with t, right for unit directions only.
//    A hit replaces the best on a smaller (t, triangle index) pair, so
//    among equal t the lowest index still wins in any cluster order.
//
// Every walk stops at the last real triangle: n_tris is the count before
// the builder's padding, which exists only past it and never hits (its
// Woop z-row is zero, so d'_z = 0; accel/trace.py real_tris checks this),
// so the walk visits ceil(n_tris / 64) clusters and tests
// min(64, n_tris - 64c) triangles of cluster c.
//
// Results are those of the plain version (accel/dense.py) and the Pallas
// kernels, bit for bit: in index order the best hit is replaced only on a
// strictly smaller t, so among equal t the lowest triangle index wins,
// and the cooperative reduction picks the same (t, index) pair, moving
// values with shuffles that leave their bits unchanged. Any-hit mode
// stops a ray at its first valid hit. Float operations are written with
// the _rn intrinsics so nvcc cannot contract them into FMAs, whatever the
// including file's flags: the walk rounds exactly as the plain PyTorch
// version does, op for op (the ordered walk's exit decisions too:
// accel/trace.py ordered_walk_plain). No tensor cores: a ray-triangle
// test under wgmma/TF32 would keep 10 mantissa bits and lose that
// equality, and the work is scalar fp32 anyway.
//
// Build defines (chip_smoke.py's A/B and the card tests only; the
// wrappers build the defaults):
//   MITSUBA_WALK_COOP=0  every launch takes the SIMT walk (coop_walk is
//                        false)
//   MITSUBA_WALK_STOP=0  walk every cluster of the table, 64 triangles
//                        each, as the walk did before the padding stop
//   MITSUBA_WALK_T=k     the cooperative threshold kCoopFrom
//   MITSUBA_WALK_ORDER=0 the trace kernel keeps the index order on every
//                        table (trace.cu)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MITSUBA_WALK_COOP
#define MITSUBA_WALK_COOP 1
#endif
#ifndef MITSUBA_WALK_STOP
#define MITSUBA_WALK_STOP 1
#endif
#ifndef MITSUBA_WALK_T
#define MITSUBA_WALK_T 24
#endif
#ifndef MITSUBA_WALK_ORDER
#define MITSUBA_WALK_ORDER 1
#endif

namespace mitsuba_walk {

constexpr int kTrisPerCluster = 64;  // build_woop_clustered's cluster size
constexpr float kMiss = 1e30f;       // t reported for a miss
constexpr float kDzEps = 1e-12f;     // |d'_z| below this: ray parallel
// Relative slack on the slab test: entering a cluster never changes the
// result, so the gate is widened to stay conservative under rounding for
// hits that lie on a cluster's bounding box (flat walls, shared vertices).
constexpr float kSlabSlack = 1e-5f;
constexpr unsigned kFullMask = 0xffffffffu;
// Fewer entering lanes than this, for a cluster of 64 triangles: the warp
// scans the cluster for them one ray at a time (chosen by the threshold
// sweep of chip_smoke.py). The threshold scales with the triangles a
// cluster holds, as the lanes' own scan costs in proportion to them and
// the cooperative scan in proportion to the entering lanes.
constexpr int kCoopFrom = MITSUBA_WALK_T;
// Clusters between two exit tests of the ordered walk: 4, as the TPU kernel
// (there to spread a [1, B] -> scalar reduction). A warp's reduction is 5
// shuffles, but on every scene of chip_smoke.py phase 22 the exit fires
// only at the first padding cluster, and testing every cluster measured
// 1-4% slower on an H100 80GB HBM3 at 700 W (PERF.md §6).
constexpr int kExitEvery = 4;

// Triangles the walk covers: the real ones (the whole padded table when
// MITSUBA_WALK_STOP=0).
__host__ __device__ __forceinline__ int walk_tris(int n_tris,
                                                  int n_clusters) {
  return MITSUBA_WALK_STOP ? n_tris : n_clusters * kTrisPerCluster;
}

__host__ __device__ __forceinline__ int walk_clusters(int tris) {
  return (tris + kTrisPerCluster - 1) / kTrisPerCluster;
}

// Triangles of cluster c that the walk tests.
__device__ __forceinline__ int cluster_tris(int tris, int c) {
  return MITSUBA_WALK_STOP ? min(kTrisPerCluster, tris - c * kTrisPerCluster)
                           : kTrisPerCluster;
}

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

struct Ray {
  float ox, oy, oz, dx, dy, dz, mint, maxt;
};

// Does the ray enter cluster c's box (rows of `box`: min x, y, z, max x,
// then max y, max z) before `far_cap`? An inverted box (no real triangle)
// is never entered.
__device__ __forceinline__ bool enters(const float* box, int c,
                                       const Ray& r, float ix, float iy,
                                       float iz, float far_cap) {
  const float4 r0 = __ldg(reinterpret_cast<const float4*>(box + 8 * c));
  const float2 r1 = __ldg(reinterpret_cast<const float2*>(box + 8 * c + 4));
  const float lx = r0.x, ly = r0.y, lz = r0.z;
  const float hx = r0.w, hy = r1.x, hz = r1.y;
  if (lx > hx || ly > hy || lz > hz) return false;
  const float t0x = (lx - r.ox) * ix, t1x = (hx - r.ox) * ix;
  const float t0y = (ly - r.oy) * iy, t1y = (hy - r.oy) * iy;
  const float t0z = (lz - r.oz) * iz, t1z = (hz - r.oz) * iz;
  const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), r.mint));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fminf(fmaxf(t0z, t1z), far_cap));
  return !(near > far + kSlabSlack * fabsf(far));
}

// Triangle k of the cluster at `w` against the ray: true on a valid hit
// with mint < t < min(maxt, t_cap), giving t, u, v; kPair also takes t ==
// t_cap where the triangle's index `idx` is below `tri_cap` (the ordered
// walk's (t, index) order). Its three rows are loaded before the test, so
// their latencies overlap (loading w0 and w1 only past the t test measured
// slower on the card).
template <bool kPair = false>
__device__ __forceinline__ bool test_tri(const float4* __restrict__ w, int k,
                                         const Ray& r, float t_cap, float& t,
                                         float& u, float& v, int tri_cap = 0,
                                         int idx = 0) {
  const float4 wx = __ldg(w + k);
  const float4 wy = __ldg(w + kTrisPerCluster + k);
  const float4 wz = __ldg(w + 2 * kTrisPerCluster + k);
  const float dpz = affine(wz, r.dx, r.dy, r.dz, 0.f);
  if (fabsf(dpz) < kDzEps) return false;
  const float opz = affine(wz, r.ox, r.oy, r.oz, wz.w);
  t = __fdiv_rn(-opz, dpz);
  if (!(t > r.mint && t < r.maxt
        && (t < t_cap || (kPair && t == t_cap && idx < tri_cap))))
    return false;
  u = __fadd_rn(affine(wx, r.ox, r.oy, r.oz, wx.w),
                __fmul_rn(t, affine(wx, r.dx, r.dy, r.dz, 0.f)));
  v = __fadd_rn(affine(wy, r.ox, r.oy, r.oz, wy.w),
                __fmul_rn(t, affine(wy, r.dx, r.dy, r.dz, 0.f)));
  return !(fminf(fminf(u, v), __fsub_rn(__fsub_rn(1.f, u), v)) < 0.f);
}

// The index below which a hit at t == h.t replaces h under kPair: none
// before a hit.
__device__ __forceinline__ int tie_cap(const Hit& h) {
  return h.found ? h.tri : -1;
}

// The first `count` triangles of cluster c in index order, for one ray;
// kCount > 0 is `count` known at compile time; kPair: test_tri's.
template <bool kAnyHit, int kCount, bool kPair = false>
__device__ __forceinline__ void scan_tris(const float4* __restrict__ woop,
                                          int c, int count, const Ray& r,
                                          Hit& h) {
  const float4* w = woop + (size_t)c * 3 * kTrisPerCluster;
  const int n = kCount > 0 ? kCount : count;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    float t, u, v;
    if (!test_tri<kPair>(w, k, r, h.t, t, u, v, tie_cap(h),
                         c * kTrisPerCluster + k))
      continue;
    h.found = true;
    if (kAnyHit) break;
    h.t = t;
    h.u = u;
    h.v = v;
    h.tri = c * kTrisPerCluster + k;
  }
}

// trace_ray's scan of a cluster: a full cluster with the trip count fixed
// at 64 (with its count at run time the same loop made shade.cu 4-5%
// slower on an H100), the last, partial one with its count.
template <bool kAnyHit>
__device__ __forceinline__ void scan_cluster(const float4* __restrict__ woop,
                                             int c, int count, const Ray& r,
                                             Hit& h) {
  if (count == kTrisPerCluster) {
    scan_tris<kAnyHit, kTrisPerCluster>(woop, c, count, r, h);
  } else {
    scan_tris<kAnyHit, 0>(woop, c, count, r, h);
  }
}

// One ray within (mint, maxt) against clusters woop [C, 3*64] (float4 rows
// w0, w1, w2, translation) gated by `box` [C, 8], over the first `tris`
// triangles (walk_tris). A miss reports t = kMiss, tri = 0, u = v = 0 and
// found = false.
template <bool kAnyHit>
__device__ __forceinline__ Hit trace_ray(const float4* __restrict__ woop,
                                         const float* box, int tris,
                                         const Ray& r) {
  Hit h{kMiss, 0.f, 0.f, 0, false};
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const int n_c = walk_clusters(tris);
  for (int c = 0; c < n_c && !(kAnyHit && h.found); ++c) {
    if (!enters(box, c, r, ix, iy, iz, fminf(r.maxt, h.t))) continue;
    scan_cluster<kAnyHit>(woop, c, cluster_tris(tris, c), r, h);
  }
  return h;
}

// The walk a launch over `tris` (walk_tris) takes: the cooperative one
// where a warp's lanes can diverge across clusters, i.e. past one walked
// cluster (Cornell's 36 triangles are one: its lanes' own scan measured
// faster there), never under MITSUBA_WALK_COOP=0. The kernels are
// templates on it, so each walk gets its own register allocation.
__host__ __forceinline__ bool coop_walk(int tris) {
  return MITSUBA_WALK_COOP && walk_clusters(tris) > 1;
}

// The ordered walk's visit of cluster c, a step of trace_ray_warp's
// cooperative loop: each busy lane slab-tests it, and the lanes that
// enter scan it themselves (many) or one ray at a time over the warp
// (few); a closest hit replaces the best on a smaller (t, index) pair
// (test_tri's kPair), as clusters come out of index order. Every lane of
// the warp calls it together.
template <bool kAnyHit>
__device__ __forceinline__ void walk_cluster(const float4* __restrict__ woop,
                                             const float* box, int tris,
                                             int c, const Ray& r, float ix,
                                             float iy, float iz, bool& busy,
                                             Hit& h) {
  constexpr bool kPair = !kAnyHit;
  const int lane = threadIdx.x & 31;
  const bool enter = busy && enters(box, c, r, ix, iy, iz,
                                    fminf(r.maxt, h.t));
  unsigned owners = __ballot_sync(kFullMask, enter);
  if (owners == 0) return;
  const int count = cluster_tris(tris, c);
  if (__popc(owners) * kTrisPerCluster >= kCoopFrom * count) {
    // the count at run time: the megakernels measured slower with
    // scan_cluster's second loop, for full clusters, here
    if (enter) scan_tris<kAnyHit, 0, kPair>(woop, c, count, r, h);
  } else {
    const float4* w = woop + (size_t)c * 3 * kTrisPerCluster;
    const int base = c * kTrisPerCluster;
    do {
      const int src = __ffs(owners) - 1;
      owners &= owners - 1;
      const Ray b{__shfl_sync(kFullMask, r.ox, src),
                  __shfl_sync(kFullMask, r.oy, src),
                  __shfl_sync(kFullMask, r.oz, src),
                  __shfl_sync(kFullMask, r.dx, src),
                  __shfl_sync(kFullMask, r.dy, src),
                  __shfl_sync(kFullMask, r.dz, src),
                  __shfl_sync(kFullMask, r.mint, src),
                  __shfl_sync(kFullMask, r.maxt, src)};
      const float cap = __shfl_sync(kFullMask, h.t, src);
      const int cap_tri = __shfl_sync(kFullMask, tie_cap(h), src);
      // this lane's best of triangles lane and lane + 32, the lower
      // index kept on equal t
      float t = cap, u = 0.f, v = 0.f, t1, u1, v1;
      int k = -1;
      if (lane < count && test_tri<kPair>(w, lane, b, cap, t1, u1, v1,
                                          cap_tri, base + lane)) {
        t = t1, u = u1, v = v1, k = lane;
      }
      if (lane + 32 < count
          && test_tri<kPair>(w, lane + 32, b, t, t1, u1, v1,
                             k >= 0 ? base + lane : cap_tri,
                             base + lane + 32)) {
        t = t1, u = u1, v = v1, k = lane + 32;
      }
      if (!__any_sync(kFullMask, k >= 0)) continue;
      if (kAnyHit) {
        if (lane == src) h.found = true;
        continue;
      }
      // the warp's smallest t, then its lowest triangle index
      float best = k >= 0 ? t : __int_as_float(0x7f800000);   // +inf
      for (int off = 16; off > 0; off >>= 1)
        best = fminf(best, __shfl_xor_sync(kFullMask, best, off));
      const unsigned lo = __ballot_sync(kFullMask, k >= 0 && k < 32
                                                       && t == best);
      const unsigned hi = __ballot_sync(kFullMask, k >= 32 && t == best);
      const int win = __ffs(lo ? lo : hi) - 1;
      const float wt = __shfl_sync(kFullMask, t, win);
      const float wu = __shfl_sync(kFullMask, u, win);
      const float wv = __shfl_sync(kFullMask, v, win);
      if (lane == src) {
        h.t = wt;
        h.u = wu;
        h.v = wv;
        h.tri = base + win + (lo ? 0 : 32);
        h.found = true;
      }
    } while (owners);
  }
  if (kAnyHit) busy = busy && !h.found;
}

// The front-to-back order of accel/trace.py build_cluster_order, on the
// device: meta [C, 8] (centre xyz, half-diagonal; r_max at [0][4]; the
// scene box's min and max at [0][5:8] and [1][5:8]), order [C, C] (row k:
// the clusters by centre distance from cluster k) and odist [C, C] (those
// distances). visits [warps]: the cluster positions each warp stepped
// through, written where not null.
struct Order {
  const float* meta;
  const int* order;
  const float* odist;
  int n_clusters;
  int* visits;
};

__device__ __forceinline__ float warp_min(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

// ((x*x + y*y) + z*z) without contraction.
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// The ordered walk (see the head of this file); returns the cluster
// positions the warp stepped through in `visited`.
template <bool kAnyHit>
__device__ __forceinline__ Hit ordered_walk(const float4* __restrict__ woop,
                                            const float* box, int tris,
                                            bool want, const Ray& r,
                                            const Order& ord, int& visited) {
  const float kInf = __int_as_float(0x7f800000);
  Hit h{kMiss, 0.f, 0.f, 0, false};
  visited = 0;
  const unsigned wanting = __ballot_sync(kFullMask, want);
  if (wanting == 0) return h;
  const int lane = threadIdx.x & 31;
  const int n_cl = ord.n_clusters;
  const float* meta = ord.meta;
  // the hint: the centre nearest the first wanting lane's origin (the
  // lowest index among equal distances; NaN never wins)
  const int first = __ffs(wanting) - 1;
  const float fx = __shfl_sync(kFullMask, r.ox, first);
  const float fy = __shfl_sync(kFullMask, r.oy, first);
  const float fz = __shfl_sync(kFullMask, r.oz, first);
  float near2 = kInf;
  int k = 0;
  for (int c = lane; c < n_cl; c += 32) {
    const float d2 = norm2(__fsub_rn(fx, meta[8 * c]),
                           __fsub_rn(fy, meta[8 * c + 1]),
                           __fsub_rn(fz, meta[8 * c + 2]));
    if (d2 < near2) near2 = d2, k = c;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float o2 = __shfl_xor_sync(kFullMask, near2, off);
    const int ok = __shfl_xor_sync(kFullMask, k, off);
    if (o2 < near2 || (o2 == near2 && ok < k)) near2 = o2, k = ok;
  }
  // d_box: k's centre to the farthest corner of the wanting origins' box
  const float ckx = meta[8 * k], cky = meta[8 * k + 1], ckz = meta[8 * k + 2];
  const float r_max = meta[4];
  const float bx = fmaxf(fabsf(__fsub_rn(warp_min(want ? r.ox : kInf), ckx)),
                         fabsf(__fsub_rn(warp_max(want ? r.ox : -kInf), ckx)));
  const float by = fmaxf(fabsf(__fsub_rn(warp_min(want ? r.oy : kInf), cky)),
                         fabsf(__fsub_rn(warp_max(want ? r.oy : -kInf), cky)));
  const float bz = fmaxf(fabsf(__fsub_rn(warp_min(want ? r.oz : kInf), ckz)),
                         fabsf(__fsub_rn(warp_max(want ? r.oz : -kInf), ckz)));
  const float d_box = __fsqrt_rn(norm2(bx, by, bz));
  // the lane's cap: its exit from the scene box (a hit lies inside it),
  // as a distance along the ray
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const float ex = fmaxf(__fmul_rn(__fsub_rn(meta[5], r.ox), ix),
                         __fmul_rn(__fsub_rn(meta[13], r.ox), ix));
  const float ey = fmaxf(__fmul_rn(__fsub_rn(meta[6], r.oy), iy),
                         __fmul_rn(__fsub_rn(meta[14], r.oy), iy));
  const float ez = fmaxf(__fmul_rn(__fsub_rn(meta[7], r.oz), iz),
                         __fmul_rn(__fsub_rn(meta[15], r.oz), iz));
  const float cap = fminf(r.maxt, __fadd_rn(__fmul_rn(fminf(fminf(ex, ey), ez),
                                                     1.001f), 1e-3f));
  const float len = __fsqrt_rn(norm2(r.dx, r.dy, r.dz));
  // row k of the order and its distances, 32 positions at a time: lane l
  // holds position i + l, read as one coalesced load and handed out with
  // shuffles, so a position's box load waits on no load of the order
  const int* row = ord.order + (size_t)k * n_cl;
  const float* dist = ord.odist + (size_t)k * n_cl;
  const int n_c = walk_clusters(tris);
  bool busy = want;   // this lane's ray is still looking
  int i = 0, next_c = 0;
  float next_d = 0.f;
  for (; i < n_cl; ++i) {
    if (!__any_sync(kFullMask, busy)) break;
    if ((i & 31) == 0) {
      const int j = min(i + lane, n_cl - 1);
      next_c = __ldg(row + j);
      next_d = __ldg(dist + j);
    }
    if (i % kExitEvery == 0) {
      // the farthest a looking lane may still find a closer hit (a NaN
      // reach, from a zero direction, finds nothing and holds no lane)
      const float far = __fmul_rn(fminf(h.t, cap), len);
      const float reach = warp_max(busy && far == far ? far : -kInf);
      const float d_i = __shfl_sync(kFullMask, next_d, i & 31);
      if (__fsub_rn(__fsub_rn(d_i, d_box), r_max) > reach) break;
    }
    const int c = __shfl_sync(kFullMask, next_c, i & 31);
    if (c < n_c)
      walk_cluster<kAnyHit>(woop, box, tris, c, r, ix, iy, iz, busy, h);
  }
  visited = i;
  return h;
}

// trace_ray for the lanes of a warp that want a ray; every lane of the
// warp calls it together (lanes with want = false get a miss). kCoop:
// coop_walk; without it each wanting lane runs trace_ray. kOrdered (with
// kCoop): the clusters front to back by `ord`, with the early exit, the
// positions stepped through in *visited.
template <bool kAnyHit, bool kCoop, bool kOrdered = false>
__device__ __forceinline__ Hit trace_ray_warp(const float4* __restrict__ woop,
                                              const float* box, int tris,
                                              bool want, const Ray& r,
                                              const Order* ord = nullptr,
                                              int* visited = nullptr) {
  static_assert(kCoop || !kOrdered, "the ordered walk is cooperative");
  if constexpr (kOrdered) {
    return ordered_walk<kAnyHit>(woop, box, tris, want, r, *ord, *visited);
  }
  // the index order: walk_cluster's steps without the (t, index) pair,
  // kept as a loop of its own: calling walk_cluster here cost the trace
  // kernel's cooperative instantiations 2-8 registers on the H100, and
  // the megakernels and the shade kernel share this loop
  Hit h{kMiss, 0.f, 0.f, 0, false};
  if (!kCoop) {
    if (want) h = trace_ray<kAnyHit>(woop, box, tris, r);
    return h;
  }
  const int lane = threadIdx.x & 31;
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const int n_c = walk_clusters(tris);
  bool busy = want;   // this lane's ray is still looking
  for (int c = 0; c < n_c; ++c) {
    if (!__any_sync(kFullMask, busy)) break;
    const bool enter = busy && enters(box, c, r, ix, iy, iz,
                                      fminf(r.maxt, h.t));
    unsigned owners = __ballot_sync(kFullMask, enter);
    if (owners == 0) continue;
    const int count = cluster_tris(tris, c);
    if (__popc(owners) * kTrisPerCluster >= kCoopFrom * count) {
      // the count at run time: the megakernels measured slower with
      // scan_cluster's second loop, for full clusters, here
      if (enter) scan_tris<kAnyHit, 0>(woop, c, count, r, h);
    } else {
      const float4* w = woop + (size_t)c * 3 * kTrisPerCluster;
      do {
        const int src = __ffs(owners) - 1;
        owners &= owners - 1;
        const Ray b{__shfl_sync(kFullMask, r.ox, src),
                    __shfl_sync(kFullMask, r.oy, src),
                    __shfl_sync(kFullMask, r.oz, src),
                    __shfl_sync(kFullMask, r.dx, src),
                    __shfl_sync(kFullMask, r.dy, src),
                    __shfl_sync(kFullMask, r.dz, src),
                    __shfl_sync(kFullMask, r.mint, src),
                    __shfl_sync(kFullMask, r.maxt, src)};
        const float cap = __shfl_sync(kFullMask, h.t, src);
        // this lane's best of triangles lane and lane + 32, the lower
        // index kept on equal t
        float t = cap, u = 0.f, v = 0.f, t1, u1, v1;
        int k = -1;
        if (lane < count && test_tri(w, lane, b, cap, t1, u1, v1)) {
          t = t1, u = u1, v = v1, k = lane;
        }
        if (lane + 32 < count && test_tri(w, lane + 32, b, t, t1, u1, v1)) {
          t = t1, u = u1, v = v1, k = lane + 32;
        }
        if (!__any_sync(kFullMask, k >= 0)) continue;
        if (kAnyHit) {
          if (lane == src) h.found = true;
          continue;
        }
        // the warp's smallest t, then its lowest triangle index
        float best = k >= 0 ? t : __int_as_float(0x7f800000);   // +inf
        for (int off = 16; off > 0; off >>= 1)
          best = fminf(best, __shfl_xor_sync(kFullMask, best, off));
        const unsigned lo = __ballot_sync(kFullMask, k >= 0 && k < 32
                                                         && t == best);
        const unsigned hi = __ballot_sync(kFullMask, k >= 32 && t == best);
        const int win = __ffs(lo ? lo : hi) - 1;
        const float wt = __shfl_sync(kFullMask, t, win);
        const float wu = __shfl_sync(kFullMask, u, win);
        const float wv = __shfl_sync(kFullMask, v, win);
        if (lane == src) {
          h.t = wt;
          h.u = wu;
          h.v = wv;
          h.tri = c * kTrisPerCluster + win + (lo ? 0 : 32);
          h.found = true;
        }
      } while (owners);
    }
    if (kAnyHit) busy = busy && !h.found;
  }
  return h;
}

}  // namespace mitsuba_walk
