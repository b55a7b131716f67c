// The row chain of the linear detector's weight gradient: (N,) d and
// (N, C) xs float32 -> (C,) float32, out[j] = acc after
// acc = fma(d[i], xs[i][j], acc) over the rows i in order from acc = 0,
// each step rounded once.
//
// Replaces no Pallas kernel: the reference's fit takes this product inside
// XLA's compiled gradient (src/repro/serving/cascade.py:280,
// jax.jit(jax.grad(loss))), whose CPU code runs the rows as one chain of
// fused multiply-adds a channel. The port's fit (serving/cascade.py
// _fit_grad) needs the same chain to stay array-equal to it.
//
// Bound: bytes (4 (N + N C + C)), unreachable: the chain is N dependent
// FMAs, about 4 cycles each, so N = 992 rows take ~2 µs at ~2 GHz.
// Design: a block owns 32 channels. All its threads stage a tile of up to
// kMaxRows rows of d and of those channels into shared memory by cp.async
// (every copy in flight at once); then one warp runs the chain over the
// tile, a lane a channel, with __fmaf_rn (exact by construction, whatever
// -fmad says), loading 8 rows from shared memory before their 8 FMAs. One
// thread a channel reading device memory in the chain's loop waited on a
// load every few rows (0.025 ms at N = 992 on an H100), and register
// staging with an unrolled loop still took 0.0146 ms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kCols = 32;       // channels a block: one lane of the chain warp each
constexpr int kThreads = 512;   // all stage a tile; warp 0 runs the chain
constexpr int kMaxRows = 1536;  // rows a tile: (1 + 32) * 1536 * 4 = 202 752 B of shared memory
constexpr int kGroup = 8;       // rows the chain warp loads before it runs their FMAs

__global__ void __launch_bounds__(kThreads)
    fma_rows_kernel(const float* __restrict__ d, const float* __restrict__ xs,
                    float* __restrict__ out, int n, int c, int tile) {
  extern __shared__ float smem[];
  float* d_s = smem;         // [tile]
  float* x_s = smem + tile;  // [tile][kCols]; a column past c is never read out
  const int j0 = blockIdx.x * kCols;
  const int cols = min(kCols, c - j0);
  const int lane = threadIdx.x;
  float acc = 0.0f;
  for (int r0 = 0; r0 < n; r0 += tile) {
    const int rows = min(tile, n - r0);
    for (int r = threadIdx.x; r < rows; r += kThreads) cp_async4(d_s + r, d + r0 + r);
    for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
      const int k = i % kCols;
      if (k < cols) cp_async4(x_s + i, xs + static_cast<int64_t>(r0 + i / kCols) * c + j0 + k);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (lane < kCols) {
      int r = 0;
      for (; r + kGroup <= rows; r += kGroup) {  // the group's loads, then its chain
        float dv[kGroup], xv[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          dv[u] = d_s[r + u];
          xv[u] = x_s[(r + u) * kCols + lane];
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) acc = __fmaf_rn(dv[u], xv[u], acc);
      }
      for (; r < rows; ++r) acc = __fmaf_rn(d_s[r], x_s[r * kCols + lane], acc);
    }
    __syncthreads();
  }
  if (lane < cols) out[j0 + lane] = acc;
}

}  // namespace

// d (n,) and xs (n, c) contiguous float32; out (c,) float32.
extern "C" int fma_rows_launch(const void* d, const void* xs, void* out, int n, int c,
                               void* stream) {
  if (n < 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fma_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (1 + kCols) * kMaxRows * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = n < kMaxRows ? n : kMaxRows;
  fma_rows_kernel<<<(c + kCols - 1) / kCols, kThreads, (1 + kCols) * tile * 4,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const float*>(xs), static_cast<float*>(out), n, c,
      tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fma_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
