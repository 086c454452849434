// Roofline probes for Hopper (sm_90a): the card's fp32 arithmetic ceiling
// and the cluster walk's rate with no shading.
//
// Replaces the Pallas TPU kernels of experiments/_exp_roofline.py:
//  - e0_vpu_peak (:19-58): four independent x*k + c chains on [rows, B]
//    f32 for n_iter steps, writing a + b + c + d. Here the coefficients
//    are kernel arguments, so nvcc cannot fold the chains (Mosaic folded
//    the TPU kernel's constants). Two variants: kFma, one FFMA a step
//    (2 flops an instruction, the data sheet's 67 TFLOP/s), and FMUL then
//    FADD, as the port's kernels round (FMA contraction off), 2 flops in
//    2 instructions. What bounds both: the fp32 pipes; each thread's four
//    chains give the schedulers 4 independent instructions a warp, and
//    the grid fills every SM (the wrapper's shape).
//  - e1_trace_only (:62-136): a persistent loop of n_iter steps, each a
//    closest trace of the lanes' rays (mint 1e-4, maxt 1e30), a second
//    one from o + (0.1, 0, 0) along -d (maxt 5e29), and the update
//    ox += 0.001 t1, oz += 0.001 t2, all in one launch through
//    mitsuba_walk::trace_ray_warp (trace_common.cuh), which the trace
//    kernel and the megakernels share: the walk's rays/s with no
//    shading. What bounds it: fp32 operations of the triangle tests, as
//    the trace kernel. hits [n_iter, 2] (where not null) counts the lanes
//    whose first and second trace hit at each step, one atomic a warp.
//
// Float operations use the _rn intrinsics: no contraction, so the FMUL/FADD
// variant and e1 round as their plain PyTorch versions
// (mitsuba_tpu_torch/experiments/roofline.py) do, op for op.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

struct Chains {
  float k0[4], c0[4];   // a = x*k0 + c0, ...
  float k[4], c[4];     // then n_iter times a = a*k + c
};

template <bool kFma>
__device__ __forceinline__ float step(float a, float k, float c) {
  return kFma ? __fmaf_rn(a, k, c) : __fadd_rn(__fmul_rn(a, k), c);
}

template <bool kFma>
__global__ void __launch_bounds__(256)
e0_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
          int n_iter, Chains ch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float a = step<kFma>(xi, ch.k0[0], ch.c0[0]);
  float b = step<kFma>(xi, ch.k0[1], ch.c0[1]);
  float c = step<kFma>(xi, ch.k0[2], ch.c0[2]);
  float d = step<kFma>(xi, ch.k0[3], ch.c0[3]);
#pragma unroll 8
  for (int s = 0; s < n_iter; ++s) {
    a = step<kFma>(a, ch.k[0], ch.c[0]);
    b = step<kFma>(b, ch.k[1], ch.c[1]);
    c = step<kFma>(c, ch.k[2], ch.c[2]);
    d = step<kFma>(d, ch.k[3], ch.c[3]);
  }
  out[i] = __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

// st [6, b] (ox, oy, oz, dx, dy, dz rows) in and out.
template <bool kCoop, bool kOrdered>
__global__ void __launch_bounds__(128, 4)
e1_kernel(const float4* __restrict__ woop, const float* __restrict__ box,
          int tris, const float* __restrict__ st_in, float* __restrict__ st,
          int b, int n_iter, mitsuba_walk::Order ord, int* __restrict__ hits) {
  using mitsuba_walk::Hit;
  using mitsuba_walk::Ray;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool want = i < b;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  if (want) {
    ox = st_in[i], oy = st_in[b + i], oz = st_in[2 * b + i];
    dx = st_in[3 * b + i], dy = st_in[4 * b + i], dz = st_in[5 * b + i];
  }
  int visited;
  for (int s = 0; s < n_iter; ++s) {
    const Hit h1 = mitsuba_walk::trace_ray_warp<false, kCoop, kOrdered>(
        woop, box, tris, want,
        Ray{ox, oy, oz, dx, dy, dz, 1e-4f, mitsuba_walk::kMiss}, &ord,
        &visited);
    const Hit h2 = mitsuba_walk::trace_ray_warp<false, kCoop, kOrdered>(
        woop, box, tris, want,
        Ray{__fadd_rn(ox, 0.1f), oy, oz, -dx, -dy, -dz, 1e-4f,
            mitsuba_walk::kMiss * 0.5f}, &ord, &visited);
    if (hits != nullptr) {
      const unsigned m1 = __ballot_sync(mitsuba_walk::kFullMask,
                                        want && h1.found);
      const unsigned m2 = __ballot_sync(mitsuba_walk::kFullMask,
                                        want && h2.found);
      if ((threadIdx.x & 31) == 0) {
        if (m1) atomicAdd(hits + 2 * s, __popc(m1));
        if (m2) atomicAdd(hits + 2 * s + 1, __popc(m2));
      }
    }
    ox = __fadd_rn(ox, __fmul_rn(0.001f, h1.t));
    oz = __fadd_rn(oz, __fmul_rn(0.001f, h2.t));
  }
  if (!want) return;
  st[i] = ox, st[b + i] = oy, st[2 * b + i] = oz;
  st[3 * b + i] = dx, st[4 * b + i] = dy, st[5 * b + i] = dz;
}

}  // namespace

// e0 on n floats of x into out, n_iter steps; fma != 0 takes the FFMA
// variant; coef: k0[4], c0[4], k[4], c[4] (host floats). Returns the
// cudaError_t of the launch.
extern "C" int mitsuba_e0(const void* x, void* out, int n, int n_iter,
                          int fma, const float* coef, void* stream) {
  if (n <= 0) return 0;
  Chains ch;
  for (int j = 0; j < 4; ++j) {
    ch.k0[j] = coef[j], ch.c0[j] = coef[4 + j];
    ch.k[j] = coef[8 + j], ch.c[j] = coef[12 + j];
  }
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads);
  const auto s = static_cast<cudaStream_t>(stream);
  if (fma) {
    e0_kernel<true><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, n_iter,
        ch);
  } else {
    e0_kernel<false><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, n_iter,
        ch);
  }
  return static_cast<int>(cudaGetLastError());
}

// e1 on the b lanes of st_in [6, b] into st [6, b] against the table woop
// [C, 3*64] / box [C, 8] over its first n_tris triangles, n_iter steps;
// ordered where meta/order/odist are not null and the walk is
// cooperative (as the trace kernel); hits [n_iter, 2] int32, zeroed by the
// caller, or null. Returns the cudaError_t of the launch.
extern "C" int mitsuba_e1(const void* woop, const void* box, int n_clusters,
                          int n_tris, const void* st_in, void* st, int b,
                          int n_iter, const void* meta, const void* order,
                          const void* odist, void* hits, void* stream) {
  if (b <= 0) return 0;
  const int threads = 128;
  const dim3 grid((b + threads - 1) / threads);
  const int tris = mitsuba_walk::walk_tris(n_tris, n_clusters);
  const bool coop = mitsuba_walk::coop_walk(tris);
  const bool ordered = coop && meta != nullptr && order != nullptr
                       && odist != nullptr;
  const mitsuba_walk::Order ord{static_cast<const float*>(meta),
                                static_cast<const int*>(order),
                                static_cast<const float*>(odist), n_clusters,
                                nullptr};
  const auto launch = [&](auto kernel) {
    kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(woop), static_cast<const float*>(box),
        tris, static_cast<const float*>(st_in), static_cast<float*>(st), b,
        n_iter, ord, static_cast<int*>(hits));
  };
  if (ordered) {
    launch(e1_kernel<true, true>);
  } else if (coop) {
    launch(e1_kernel<true, false>);
  } else {
    launch(e1_kernel<false, false>);
  }
  return static_cast<int>(cudaGetLastError());
}
