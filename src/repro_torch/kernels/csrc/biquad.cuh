// The transposed-DF-II biquad step of the feature extractor, shared by the
// serving tick (tick_fused.cu) and the batch filterbank kernels
// (fex_fused.cu), so every CUDA path filters bit for bit alike.
//
// Rounding: __fmaf_rn exactly where the reference's compiled scan fuses
// (b0*x + s1, b1*x - a1*y, b2*x - a2*y); the files that include this one
// are compiled with -fmad=false, so everything else rounds as the plain
// version (repro_torch.core.fex._biquad_step with fma_f32) does.
#pragma once

#include <cuda_runtime.h>

struct Biquad {
  float b0, b1, b2, a1, a2;
};

// Channel c of stacked (5, nc) coefficients b0, b1, b2, a1, a2.
__device__ __forceinline__ Biquad load_biquad(const float* coeffs, int c, int nc) {
  return Biquad{coeffs[c], coeffs[nc + c], coeffs[2 * nc + c], coeffs[3 * nc + c],
                coeffs[4 * nc + c]};
}

// One step: returns y and advances the carry (s1, s2).
__device__ __forceinline__ float biquad_y(const Biquad& q, float x, float& s1, float& s2) {
  const float y = __fmaf_rn(q.b0, x, s1);
  const float s1n = __fadd_rn(__fmaf_rn(q.b1, x, -__fmul_rn(q.a1, y)), s2);
  s2 = __fmaf_rn(q.b2, x, -__fmul_rn(q.a2, y));
  s1 = s1n;
  return y;
}
