// Saturating integer dot product of the IC's HPE datapath (Section III-E),
// shared by the standalone GEMM (intgemm.cu) and the tick kernel
// (tick_fused.cu), so both run the same arithmetic.
//
// Tensor cores have no int16 x int8 product, and the classifier's shapes
// are small (K <= 48, N <= 144), so this is a CUDA-core int32 dot. The
// sum is exact in int32 for 14-bit activations, 8-bit weights and
// K < 2^11 (|x.w| < 2^20 per term); it is clipped ONCE, at the end, to the
// 24-bit accumulator range, exactly where the reference clips.
#pragma once

#include <stdint.h>

#define INTGEMM_ACC_MIN (-(1 << 23))
#define INTGEMM_ACC_MAX ((1 << 23) - 1)

// sum_k x[k] * w[k * ldw + col], saturated to int24.
__device__ __forceinline__ int32_t intgemm_dot(const int32_t* x,
                                               const int8_t* w, int k_dim,
                                               int ldw, int col) {
  int32_t acc = 0;
  for (int k = 0; k < k_dim; ++k) {
    acc += x[k] * static_cast<int32_t>(w[k * ldw + col]);
  }
  return min(max(acc, INTGEMM_ACC_MIN), INTGEMM_ACC_MAX);
}
