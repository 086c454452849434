// Per-lane table loads for Hopper (sm_90a): take_along_axis on either axis
// of a row-major f32 table, and the column gather table[idx, col].
//
// Replaces the Pallas TPU kernels of experiments/_exp_gather_probe.py
// (`probe`, :17-75: table[idx, 0] from [512, 128] by [8, 1024] indices)
// and _exp_gather_probe2.py (`probe`, :12-57: take_along_axis on axis 0 of
// [T, 128] (T 8 ... 4096) and [512, 1024] tables, and on axis 1 of
// [8, 1024]), which asked which per-lane indexing forms Mosaic lowers. On
// the card a gather is a load, so one kernel covers every form:
//   axis 0: out[r, j] = tab[idx[r, j], col < 0 ? j : col]
//   axis 1: out[r, j] = tab[r, idx[r, j]]
// What bounds it: bytes. Each thread reads 4 indices as one 16-byte load
// and writes 4 outputs as one (neighbouring threads on neighbouring
// addresses); the table rows are read through the read-only cache, where
// the small tables of the probe stay (the L2 holds 50 MB). Indices must
// lie in the table (the wrapper checks them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
gather_kernel(const float* __restrict__ tab, int ld,
              const int4* __restrict__ idx, float4* __restrict__ out,
              int rows, int cols, int axis, int col) {
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t e = 4 * q;
  if (e >= (size_t)rows * cols) return;
  const size_t r = e / cols;
  const int j = (int)(e - r * cols);
  const int4 k = __ldg(idx + q);
  float4 o;
  if (axis == 0) {
    const bool own = col < 0;
    o.x = __ldg(tab + (size_t)k.x * ld + (own ? j : col));
    o.y = __ldg(tab + (size_t)k.y * ld + (own ? j + 1 : col));
    o.z = __ldg(tab + (size_t)k.z * ld + (own ? j + 2 : col));
    o.w = __ldg(tab + (size_t)k.w * ld + (own ? j + 3 : col));
  } else {
    const float* row = tab + r * ld;
    o.x = __ldg(row + k.x);
    o.y = __ldg(row + k.y);
    o.z = __ldg(row + k.z);
    o.w = __ldg(row + k.w);
  }
  out[q] = o;
}

}  // namespace

// out [rows, cols] from tab (leading dimension ld) by idx [rows, cols]
// int32 on axis 0 (col < 0: column j of row idx[r, j]; else column col) or
// axis 1; cols % 4 == 0 and 16-byte aligned idx and out (the wrapper
// checks). Returns the cudaError_t of the launch.
extern "C" int mitsuba_gather(const void* tab, int ld, const void* idx,
                              void* out, int rows, int cols, int axis,
                              int col, void* stream) {
  const size_t n4 = (size_t)rows * cols / 4;
  if (n4 == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((n4 + threads - 1) / threads));
  gather_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), ld, static_cast<const int4*>(idx),
      static_cast<float4*>(out), rows, cols, axis, col);
  return static_cast<int>(cudaGetLastError());
}
