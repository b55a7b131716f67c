// One ZOH tick of K5's carry (csrc/tdc.cu), shared with the chain probe
// of chip_ab.py so that both build the same instructions.
#pragma once

constexpr float kMagic = 0x1p23f;

// r += d; incr = floor(r); r -= incr; acc += incr. MAGIC floors by the
// 2^23 add, fl_down(s + 2^23) - 2^23, which is floorf(s) exactly for
// 0 <= s < 2^23; else by floorf.
template <bool MAGIC>
__device__ __forceinline__ void tick(float d, float& r, float& acc) {
  const float s = __fadd_rn(r, d);
  const float incr = MAGIC ? __fsub_rn(__fadd_rd(s, kMagic), kMagic) : floorf(s);
  r = __fsub_rn(s, incr);
  acc = __fadd_rn(acc, incr);
}
