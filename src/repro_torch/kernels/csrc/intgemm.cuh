// Saturating integer products of the IC's HPE datapath (Section III-E),
// for the standalone GEMM (intgemm.cu: the clip) and the tick kernel
// (tick_fused.cu: the clip and the register tile), so both run the same
// arithmetic: a sum exact in int32
// for 14-bit activations, 8-bit weights and K < 2^11 (|x.w| < 2^20 per
// term, so its order is free), clipped ONCE, at the end, to the 24-bit
// accumulator range, exactly where the reference clips.
//
// The tick's register tile (intgemm_tile): a thread owns R rows x 4
// columns. Per k it reads the 4 adjacent int8 weight codes of its columns
// as ONE 32-bit word (w is (K, N) row-major) and the rows' activations from
// the 16-byte vectors that hold 4 consecutive k of each row: at R = 4, 2
// shared-memory loads feed 16 IMADs (0.125 a MAC).
#pragma once

#include <stdint.h>

#define INTGEMM_ACC_MIN (-(1 << 23))
#define INTGEMM_ACC_MAX ((1 << 23) - 1)

__device__ __forceinline__ int32_t intgemm_clip(int32_t acc) {
  return min(max(acc, INTGEMM_ACC_MIN), INTGEMM_ACC_MAX);
}

// Byte I of a word of four int8 codes, sign-extended (one PRMT: a selector
// nibble with its top bit set replicates the selected byte's sign).
template <int I>
__device__ __forceinline__ int32_t int8_lane(uint32_t word) {
  constexpr uint32_t sel = I | ((8 | I) << 4) | ((8 | I) << 8) | ((8 | I) << 12);
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(word), "n"(sel));
  return static_cast<int32_t>(r);
}

// Lane i (a constant after unrolling) of a 16-byte vector.
__device__ __forceinline__ int32_t int4_lane(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[r][c] += sum_k x[r * ldx + k] * w[k * ldw + c] over k < depth (a
// multiple of 4), for the tile's R rows and 4 columns. x: the tile's first
// row, 16-byte aligned, ldx a multiple of 4; w: its first column, 4-byte
// aligned, ldw a multiple of 4.
template <int R>
__device__ __forceinline__ void intgemm_tile(const int32_t* __restrict__ x, int ldx,
                                             const int8_t* __restrict__ w, int ldw,
                                             int depth, int32_t acc[R][4]) {
  for (int k0 = 0; k0 < depth; k0 += 4) {
    int4 xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) xv[r] = *reinterpret_cast<const int4*>(x + r * ldx + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(w + (k0 + kk) * ldw);
      const int32_t wc[4] = {int8_lane<0>(word), int8_lane<1>(word), int8_lane<2>(word),
                             int8_lane<3>(word)};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int32_t xr = int4_lane(xv[r], kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += xr * wc[c];
      }
    }
  }
}
