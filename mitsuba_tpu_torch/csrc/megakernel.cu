// Path-tracing megakernels for Hopper (sm_90a): one bounce per launch
// (mega_bounce), whole paths per lane (mega_path), and a pixel's whole
// sample loop per lane with in-kernel camera-ray regeneration
// (mega_persistent), all three over one __device__ bounce, path_bounce,
// which mega_common.cuh holds (with the tables, the state and the
// bounce's parts) for this file and the ablation probe (ablate.cu); this
// file holds the camera, the kernels and their C entry points.
//
// Replaces the Pallas TPU kernels of mitsuba_tpu/accel/megakernel.py:
// make_bounce_kernel (:1395, launched by run_bounce :1511),
// make_path_kernel (:1423, run_path :1552) and make_persistent_kernel
// (:2478, run_persistent :2661), whose shared body is _bounce_rows
// (:606-1384): pinhole or thin-lens camera, flat or smooth shading
// normals, the 14 leaf BSDF families of bsdf_common.cuh with the
// two-sided adapter and its composites over leaf children, area, point,
// spot and directional emitters and the constant environment, the global
// homogeneous medium, and the closed-form checker or grid albedo of
// textures with procedural provenance. Each kernel is a template
// on kExt: the instantiation without it has the area emitters, leaf
// families and pinhole only, so scenes that need no more run the code
// (and the registers) they ran before; the launch picks kExt from the
// tables (MegaTables.ext) or the camera's aperture. The medium is a
// branch of the kExt instantiations, taken when the tables carry one
// (Tables.med): each bounce samples a scatter distance against the
// surface's, and a lane that scatters takes HG-phase NEE and an HG
// continuation from the scatter point (VolPathTracer's bounce, with the
// JAX megakernel's forms of the medium terms: accel/megakernel.py
// medium_segment, hg_value, hg_sample_kernel). The procedural albedo is a
// template parameter of its own, kTex, on top of kExt, which the launch
// picks when the tables carry one (MegaTables.textured): a lane whose
// material row names a checker or grid texture (TEXROW) evaluates it at
// the hit's uv (proc_albedo) and shades with a copy of its row, in a local
// array, whose columns 0-2 hold that albedo. As a runtime branch of kExt
// the copy and its generic row pointer took the kExt instantiations from
// 163-166 to 172-179 registers (mega_persistent), past the 168 that
// leave three blocks an SM; as a template the scenes without textures
// keep the kExt code they had.
//
// Design: one thread per lane. The path state lives in registers for the
// whole launch; scene tables (per-triangle attributes, materials, emitter
// rows) are gathered per thread through the read-only cache, and both
// traces of a bounce are the trace kernel's own warp walk
// (trace_common.cuh trace_ray_warp: per-lane slab gates, a cluster that
// few lanes enter scanned by the whole warp one ray at a time, the walk
// stopping at the last real triangle; each kernel is a template on
// whether the walk is cooperative, and the launch picks the
// instantiation by coop_walk), so hits are those of trace_kernel
// and of the plain intersector, bit for bit. The warp walk needs all 32
// lanes at each call: the kernels keep their warps whole (a lane past n,
// or whose path or whose spp are done, runs along with nothing to trace)
// and loop until no lane of the warp has work left. A lane whose path is
// dead on entry to a bounce leaves it unchanged, as the plain version
// (MegaPlainTracer.bounce) does, so mega_path can stop each lane at its
// own last bounce. The persistent kernel banks a dead path's L, counts
// it, and regenerates a camera ray for the next sample until the
// lane has finished `spp` paths.
//
// What bounds it on the H100: fp32 instruction throughput and warp
// divergence, not bytes. A bounce is two traces of ~40 fp32 ops per
// triangle test plus ~300 ops of shading, against a few hundred bytes of
// table that every lane of a warp reads from L1; lanes at different
// bounces trace rays that diverge, which the warp walk's cooperative
// branch answers (trace_common.cuh); lanes of one warp that hit different
// materials run their families' branches one after another; and paths
// die at different bounces, so in mega_path lanes idle while the warp's
// longest path runs. The persistent kernel answers the last the way the
// TPU kernel does: a lane whose path dies starts its next sample at once,
// so a warp stays busy until its lanes have all finished their spp.
// mega_path keeps its idle lanes: packing each block's live paths into
// its first warps before every bounce was measured (PERF.md §6) and lost
// on scenes of many clusters (leaf-families 0.86 -> 1.07 ms a launch on
// an H100 80GB HBM3 at 700 W), where the cooperative walk's work grows
// with the rays a warp holds and fewer, fuller warps hide less latency;
// it gained 8% on the Cornell box. One lane per pixel gives 65,536 lanes at 256²
// (~15 warps per SM); splitting a pixel's samples over several lanes is
// later work.
//
// Arithmetic: this file is compiled with -fmad=false and writes every
// float expression in the plain version's order, so each operation rounds
// as PyTorch's eager ops do (torch's CUDA sum over a length-3 axis adds
// (a + c) + b, see sum3). sqrtf and division are IEEE; rsqrtf, cosf and
// sinf are the same library calls PyTorch makes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mega_common.cuh"

namespace {

using namespace mitsuba_mega;

struct Camera {           // megakernel.py camera_consts
  float r[9];             // rotation rows, camera -> world
  float pos[3];
  float tan_half, aspect, width, height;
  float aperture, focus;  // thin lens (aperture 0: pinhole)
};

// A fresh camera path for `pixel` at sample `samp`: render.py's jitter and
// sensor.py's PerspectiveCamera.sample_ray, pinhole or (under kExt, with
// an aperture) thin lens, op for op. PyTorch's CUDA division by a Python
// scalar multiplies by the scalar's reciprocal, so the pixel position is
// scaled by 1/width, not divided by width.
template <bool kExt>
__device__ __forceinline__ void camera_path(const Camera& cam, uint32_t seed,
                                            uint32_t pixel, uint32_t samp,
                                            State& s) {
  const float2 j = rng2(seed, pixel, kDimPixel, samp);
  const uint32_t w = static_cast<uint32_t>(cam.width);
  const float px = static_cast<float>(pixel % w) + j.x;
  const float py = static_cast<float>(pixel / w) + j.y;
  const float lx = (1.f - (px * (1.f / cam.width)) * 2.f) * cam.tan_half;
  const float ly = ((1.f - (py * (1.f / cam.height)) * 2.f) * cam.tan_half)
                   * cam.aspect;
  V3 d{(lx * cam.r[0] + ly * cam.r[1]) + cam.r[2],
       (lx * cam.r[3] + ly * cam.r[4]) + cam.r[5],
       (lx * cam.r[6] + ly * cam.r[7]) + cam.r[8]};
  s.o = V3{cam.pos[0], cam.pos[1], cam.pos[2]};
  if (kExt && cam.aperture > 0.f) {
    // a concentric-disk point of the aperture, aimed through the focus
    // plane: o = R·(lens, 0) + pos, d = R·(focus·(lx, ly, 1) - (lens, 0))
    const float2 ap = rng2(seed, pixel, kDimAperture, samp);
    float ex, ey;
    concentric_disk(ap.x, ap.y, ex, ey);
    ex = ex * cam.aperture;
    ey = ey * cam.aperture;
    const float f = cam.focus;
    const float dx = lx * f - ex, dy = ly * f - ey, dz = 1.f * f - 0.f;
    d = V3{(dx * cam.r[0] + dy * cam.r[1]) + dz * cam.r[2],
           (dx * cam.r[3] + dy * cam.r[4]) + dz * cam.r[5],
           (dx * cam.r[6] + dy * cam.r[7]) + dz * cam.r[8]};
    s.o = V3{((ex * cam.r[0] + ey * cam.r[1]) + 0.f * cam.r[2]) + cam.pos[0],
             ((ex * cam.r[3] + ey * cam.r[4]) + 0.f * cam.r[5]) + cam.pos[1],
             ((ex * cam.r[6] + ey * cam.r[7]) + 0.f * cam.r[8]) + cam.pos[2]};
  }
  const float inv = rsqrtf(clamp_min(dot3(d, d), F32(1e-30)));
  s.d = V3{d.x * inv, d.y * inv, d.z * inv};
  s.tp = V3{1.f, 1.f, 1.f};
  s.L = V3{0.f, 0.f, 0.f};
  s.active = s.prev_pdf = s.prev_delta = s.eta = 1.f;
}

// The kernels run whole warps: a lane past n (the ragged last warp) takes
// part in the warp walks with an inactive path and stores nothing. Their
// launch bounds ask for four blocks an SM: at most 128 registers a thread,
// so all 512 blocks of a 256² launch are resident at once (132 SMs), and
// ptxas does not trade spills for a higher occupancy (it spilled in
// mega_bounce's SIMT-walk build when the bound named threads alone). The
// kExt instantiations, whose composite BSDFs hold a second material row
// and a coat's state across a child's eval or sample, ask for two: at
// most 255 registers, so they do not spill either.
#define MEGA_BOUNDS __launch_bounds__(128, kExt ? 2 : 4)

template <bool kCoop, bool kExt, bool kTex>
__global__ void MEGA_BOUNDS
mega_bounce(Tables T, const float* __restrict__ in, float* __restrict__ out,
            const int* __restrict__ pixel, const int* __restrict__ samp,
            int n, uint32_t seed, int bounce, int max_depth, int rr_depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < n;
  State s{};
  if (lane_ok) s = load_state(in, n, i);
  bool traced, shadow;
  path_bounce<kCoop, kExt, kTex>(T, s, seed,
                           lane_ok ? static_cast<uint32_t>(pixel[i]) : 0u,
                           lane_ok ? static_cast<uint32_t>(samp[i]) : 0u,
                           bounce, max_depth, rr_depth, traced, shadow);
  if (!lane_ok) return;
  store_state(out, n, i, s);
  out[kState * n + i] = traced ? 1.f : 0.f;
  out[(kState + 1) * n + i] = shadow ? 1.f : 0.f;
}

template <bool kCoop, bool kExt, bool kTex>
__global__ void MEGA_BOUNDS
mega_path(Tables T, const float* __restrict__ in, float* __restrict__ out,
          const int* __restrict__ pixel, const int* __restrict__ samp, int n,
          uint32_t seed, int n_bounces, int max_depth, int rr_depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < n;
  State s{};
  if (lane_ok) s = load_state(in, n, i);
  const uint32_t px = lane_ok ? static_cast<uint32_t>(pixel[i]) : 0u;
  const uint32_t sp = lane_ok ? static_cast<uint32_t>(samp[i]) : 0u;
  int n_traced = 0, n_shadow = 0;
  // until every path of the warp has died: a dead lane's bounce leaves it
  // unchanged and counts nothing
  for (int b = 0; __any_sync(mitsuba_walk::kFullMask,
                             b < n_bounces && s.active > 0.5f); ++b) {
    bool traced, shadow;
    path_bounce<kCoop, kExt, kTex>(T, s, seed, px, sp, b, max_depth,
                                   rr_depth, traced, shadow);
    n_traced += traced;
    n_shadow += shadow;
  }
  if (!lane_ok) return;
  store_state(out, n, i, s);
  out[kState * n + i] = static_cast<float>(n_traced);
  out[(kState + 1) * n + i] = static_cast<float>(n_shadow);
}

template <bool kCoop, bool kExt, bool kTex>
__global__ void MEGA_BOUNDS
mega_persistent(Tables T, const float* __restrict__ in,
                float* __restrict__ out, const int* __restrict__ pixel,
                const int* __restrict__ samp0, int n, uint32_t seed, int spp,
                int max_depth, int rr_depth, int iter_cap, Camera cam) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < n;
  State s{};
  int bounce = 0, done = 0, s0 = 0;
  V3 lsum{0.f, 0.f, 0.f};
  float iters = 0.f, n_traced = 0.f, n_shadow = 0.f;
  uint32_t px = 0;
  if (lane_ok) {
    s = load_state(in, n, i);
    const float* c = in + i;
    bounce = static_cast<int>(c[16 * n]);
    done = static_cast<int>(c[17 * n]);
    lsum = V3{c[18 * n], c[19 * n], c[20 * n]};
    iters = c[21 * n];
    n_traced = c[22 * n];
    n_shadow = c[23 * n];
    px = static_cast<uint32_t>(pixel[i]);
    s0 = samp0[i];
  }
  // until every lane of the warp has finished its spp: a finished lane
  // runs its (dead) bounce with the warp and changes nothing
  for (int it = 0; __any_sync(mitsuba_walk::kFullMask,
                              it < iter_cap && s.active > 0.5f); ++it) {
    const bool running = s.active > 0.5f;
    bool traced, shadow;
    path_bounce<kCoop, kExt, kTex>(T, s, seed, px,
                             static_cast<uint32_t>(s0 + done), bounce,
                             max_depth, rr_depth, traced, shadow);
    if (!running) continue;
    iters += 1.f;
    n_traced += traced ? 1.f : 0.f;
    n_shadow += shadow ? 1.f : 0.f;
    ++bounce;
    if (s.active > 0.5f) continue;
    // the path died: bank its radiance, count it, start the next sample
    lsum = V3{lsum.x + s.L.x, lsum.y + s.L.y, lsum.z + s.L.z};
    if (++done < spp) {
      camera_path<kExt>(cam, seed, px, static_cast<uint32_t>(s0 + done), s);
      bounce = 0;
    }
  }
  if (!lane_ok) return;
  store_state(out, n, i, s);
  float* o = out + i;
  o[16 * n] = static_cast<float>(bounce);
  o[17 * n] = static_cast<float>(done);
  o[18 * n] = lsum.x;
  o[19 * n] = lsum.y;
  o[20 * n] = lsum.z;
  o[21 * n] = iters;
  o[22 * n] = n_traced;
  o[23 * n] = n_shadow;
}

constexpr int kThreads = 128;

}  // namespace

namespace mitsuba_mega_shares {

// One launch's arguments as its C entry point got them (a: the bounce,
// n_bounces or spp; cam: the persistent kernel's host array of 18 floats).
struct Launch {
  mitsuba_mega::Tables T;
  int ext, tex;
  const float* in;
  float* out;
  const int* pixel;
  const int* samp;
  int n;
  uint32_t seed;
  int a, max_depth, rr_depth, iter_cap;
  const float* cam;
  cudaStream_t stream;
};

// The six shares of the kernels: one entry point's under one walk each.
int bounce_coop(const Launch& L);
int bounce_simt(const Launch& L);
int path_coop(const Launch& L);
int path_simt(const Launch& L);
int persistent_coop(const Launch& L);
int persistent_simt(const Launch& L);

}  // namespace mitsuba_mega_shares

namespace {

using mitsuba_mega_shares::Launch;

// the instantiation of `kernel` under the walk kCoop for L.ext and L.tex
#define MEGA_EXT(kernel, coop)                                               \
  (L.tex ? kernel<coop, true, true>                                          \
         : (L.ext ? kernel<coop, true, false> : kernel<coop, false, false>))

template <bool kCoop>
int run_bounce(const Launch& L) {
  const auto kernel = MEGA_EXT(mega_bounce, kCoop);
  kernel<<<(L.n + kThreads - 1) / kThreads, kThreads, 0, L.stream>>>(
      L.T, L.in, L.out, L.pixel, L.samp, L.n, L.seed, L.a, L.max_depth,
      L.rr_depth);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCoop>
int run_path(const Launch& L) {
  const auto kernel = MEGA_EXT(mega_path, kCoop);
  kernel<<<(L.n + kThreads - 1) / kThreads, kThreads, 0, L.stream>>>(
      L.T, L.in, L.out, L.pixel, L.samp, L.n, L.seed, L.a, L.max_depth,
      L.rr_depth);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCoop>
int run_persistent(const Launch& L) {
  Camera c;
  const float* f = L.cam;
  for (int k = 0; k < 9; ++k) c.r[k] = f[k];
  for (int k = 0; k < 3; ++k) c.pos[k] = f[9 + k];
  c.tan_half = f[12];
  c.aspect = f[13];
  c.width = f[14];
  c.height = f[15];
  c.aperture = f[16];
  c.focus = f[17];
  const auto kernel = MEGA_EXT(mega_persistent, kCoop);
  kernel<<<(L.n + kThreads - 1) / kThreads, kThreads, 0, L.stream>>>(
      L.T, L.in, L.out, L.pixel, L.samp, L.n, L.seed, L.a, L.max_depth,
      L.rr_depth, L.iter_cap, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Built with -DMITSUBA_PART=k (k = 1..6) the file defines share k alone,
// and so compiles only its kernels' three instantiations (kExt, kTex):
// bounce, path and persistent for k = 1-2, 3-4, 5-6, under the
// cooperative walk for odd k, whose object also holds that entry point;
// accel/trace.py build_library compiles the six at once and links them
// into one library. Without it the file defines all six.
#ifndef MITSUBA_PART
#define MITSUBA_PART 0
#endif
#define MEGA_PART(k) (MITSUBA_PART == 0 || MITSUBA_PART == (k))

#if MEGA_PART(1)
int mitsuba_mega_shares::bounce_coop(const Launch& L) {
  return run_bounce<true>(L);
}
#endif
#if MEGA_PART(2)
int mitsuba_mega_shares::bounce_simt(const Launch& L) {
  return run_bounce<false>(L);
}
#endif
#if MEGA_PART(3)
int mitsuba_mega_shares::path_coop(const Launch& L) {
  return run_path<true>(L);
}
#endif
#if MEGA_PART(4)
int mitsuba_mega_shares::path_simt(const Launch& L) {
  return run_path<false>(L);
}
#endif
#if MEGA_PART(5)
int mitsuba_mega_shares::persistent_coop(const Launch& L) {
  return run_persistent<true>(L);
}
#endif
#if MEGA_PART(6)
int mitsuba_mega_shares::persistent_simt(const Launch& L) {
  return run_persistent<false>(L);
}
#endif

// C entry points (ctypes, accel/megakernel.py). Pointers are device
// pointers except `cam`, a host array of 18 floats, and `med`, a host
// array of the medium's 8 floats or null; n_tris is the count of real
// triangles (the table's padding follows them); env is the constant
// environment's emitter row (-1: none); ext picks the kExt instantiations
// (MegaTables.ext: set with a medium or procedural textures too, or a
// thin lens); tex picks the kTex ones (MegaTables.textured); each
// launches, in the share of the walk coop_walk picks, on `stream` and
// returns the cudaError_t of the launch.
#define MEGA_TABLE_PARAMS                                                     \
  const void *woop, const void *aabb, int n_clusters, int n_tris,             \
      const void *attr, const void *mat, const void *em_rows, int et_real,    \
      const void *em_meta, const void *em_cdf, int n_em, int env, int ext,    \
      const void *med, int tex
#define MEGA_RUN_PARAMS                                                       \
  const void *state_in, void *state_out, const void *pixel, const void *samp, \
      int n, uint32_t seed
#define MEGA_LAUNCH(a, iter_cap, cam)                                         \
  Launch {                                                                    \
    make_tables(woop, aabb, n_clusters, n_tris, attr, mat, em_rows, et_real,  \
                em_meta, em_cdf, n_em, env, med),                             \
        ext, tex, static_cast<const float*>(state_in),                        \
        static_cast<float*>(state_out), static_cast<const int*>(pixel),       \
        static_cast<const int*>(samp), n, seed, a, max_depth, rr_depth,       \
        iter_cap, static_cast<const float*>(cam),                             \
        static_cast<cudaStream_t>(stream)                                     \
  }
#define MEGA_SHARE(name, L)                                                   \
  (mitsuba_walk::coop_walk((L).T.tris) ? mitsuba_mega_shares::name##_coop(L) \
                                       : mitsuba_mega_shares::name##_simt(L))

#if MEGA_PART(1)
extern "C" int mitsuba_mega_bounce(MEGA_TABLE_PARAMS, MEGA_RUN_PARAMS,
                                   int bounce, int max_depth, int rr_depth,
                                   void* stream) {
  if (n <= 0) return 0;
  const Launch L = MEGA_LAUNCH(bounce, 0, nullptr);
  return MEGA_SHARE(bounce, L);
}
#endif

#if MEGA_PART(3)
extern "C" int mitsuba_mega_path(MEGA_TABLE_PARAMS, MEGA_RUN_PARAMS,
                                 int n_bounces, int max_depth, int rr_depth,
                                 void* stream) {
  if (n <= 0) return 0;
  const Launch L = MEGA_LAUNCH(n_bounces, 0, nullptr);
  return MEGA_SHARE(path, L);
}
#endif

#if MEGA_PART(5)
extern "C" int mitsuba_mega_persistent(MEGA_TABLE_PARAMS, MEGA_RUN_PARAMS,
                                       int spp, int max_depth, int rr_depth,
                                       int iter_cap, const void* cam,
                                       void* stream) {
  if (n <= 0) return 0;
  const Launch L = MEGA_LAUNCH(spp, iter_cap, cam);
  return MEGA_SHARE(persistent, L);
}
#endif
