// Saturating int24 GEMM: (M, K) int32 activation codes x (K, N) int8 weight
// codes -> (M, N) int32.
//
// Replaces src/repro/kernels/intgemm/kernel.py:28 _intgemm_kernel /
// :46 intgemm_pallas (the TPU's MXU int8 path with a K-sequential grid).
//
// Bound: bytes. At the classifier's shapes (M = streams, K <= 48,
// N <= 144) the work is ~2 * M * K * N integer operations over
// 4 * M * (K + N) bytes, far below the card's operations-per-byte line.
// Design: one block per 32 output rows; the whole (K, N) weight matrix is
// staged once per block in shared memory; one thread per output element
// (strided over the block's 32 x N outputs) runs the shared exact int32
// dot of intgemm.cuh. Threads of one row read the same activation row, so
// those loads broadcast.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intgemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
    intgemm_kernel(const int32_t* __restrict__ x,
                   const int8_t* __restrict__ w, int32_t* __restrict__ out,
                   int m, int k, int n) {
  extern __shared__ int8_t w_s[];
  for (int i = threadIdx.x; i < k * n; i += kThreads) w_s[i] = w[i];
  __syncthreads();
  const int row0 = blockIdx.x * kRows;
  for (int item = threadIdx.x; item < kRows * n; item += kThreads) {
    const int r = row0 + item / n;
    const int col = item % n;
    if (r < m) {
      out[static_cast<int64_t>(r) * n + col] =
          intgemm_dot(x + static_cast<int64_t>(r) * k, w_s, k, n, col);
    }
  }
}

}  // namespace

extern "C" int intgemm_launch(const void* x, const void* w, void* out, int m,
                              int k, int n, void* stream) {
  const int smem = k * n;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        intgemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (m + kRows - 1) / kRows;
  intgemm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* intgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
