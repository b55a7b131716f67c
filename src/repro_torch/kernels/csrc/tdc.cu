// K5: the SRO ΔΣ TDC of the batch "hardware-pallas" frontend.
//
// Replaces src/repro/kernels/tdc/kernel.py:77 tdc_pallas (body _tdc_kernel
// :35). Plain version: repro_torch/kernels/tdc/ref.py tdc_counts_plain.
//
// Computes, per (clip, channel), over samples_per_frame samples a frame:
//   delta = scale * max(f0_eff + k_eff * u, 0)        (scale = n_phases / f_tdc)
//   os times (the zero-order hold to the TDC rate):
//     r += delta; incr = floor(r); r -= incr; acc += incr
// and writes acc per frame; the fractional carry r runs on across frames.
// (B, T, C) float32 rectified input and (C,) f0_eff, k_eff float32 ->
// (B, T / samples_per_frame, C) float32 counts.
//
// Bound: bytes against the data sheet (4 bytes of u a sample and channel),
// but in practice the carry: every ZOH tick depends on the previous r
// through an add, a floor and a subtract, so a thread runs T * os dependent
// steps.
// Design: one thread per (clip, channel), sequential over the frames and
// their samples with the os ticks as an inner loop (the TPU kernel's
// sequential frame grid axis and VMEM carry become the thread's loop and a
// register). A block holds 32 / C clips and stages up to 128 samples of them
// in shared memory, double buffered: the next round's copies (cp.async,
// coalesced) are in flight while the carry loop runs the current round from
// shared memory, so it never waits on device memory. With one warp a block
// nothing hides a latency, so the sample loop runs branch-free up to the
// end of a frame or round, with the next sample read one step ahead and the
// ZOH ticks unrolled at compile time for os = 2 (the paper's TDC rate).
// Rounding: f0 + k*u is one fused multiply-add, as the reference's compiled
// body contracts it; everything else rounds once per operation (-fmad=false),
// as the plain version does, so kernel and plain agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int MAX_CHUNK = 128;  // samples of each clip staged per round
constexpr int STAGE_FLOATS = 6 * 1024;  // per buffer; two fill 48 kB of shared memory

// Stage samples [t0, t0 + n) of this thread's clip into its region of the
// buffer: the clip's C threads copy consecutive words, each every C-th.
__device__ __forceinline__ void stage(float* region, const float* clip_u, int t0, int n, int c,
                                      int nc) {
  for (int j = c; j < n * nc; j += nc) cp_async4(region + j, clip_u + static_cast<int64_t>(t0) * nc + j);
}

// OS: the ZOH ticks a sample, fixed at compile time (2), or 0 for os at run
// time.
template <int OS>
__global__ void tdc_kernel(const float* __restrict__ u, const float* __restrict__ f0,
                           const float* __restrict__ kg, float* __restrict__ out, int b, int t,
                           int spf, int os, float scale, int chunk) {
  // [2][clips per block][chunk * C + C], double buffered; the C words of
  // padding put the clips of a block on different shared-memory banks
  extern __shared__ float us[];
  const int nc = blockDim.x;
  const int c = threadIdx.x;
  const int lc = threadIdx.y;
  const int cpb = blockDim.y;
  const int clip = blockIdx.x * cpb + lc;
  const bool live = clip < b;
  const int region = chunk * nc + nc;
  const float* clip_u = u + static_cast<int64_t>(live ? clip : 0) * t * nc;
  const float f0c = f0[c];
  const float kc = kg[c];
  const int n_frames = t / spf;
  float r = 0.0f, acc = 0.0f;
  int in_frame = 0, f = 0;
  if (live) stage(us + lc * region, clip_u, 0, min(chunk, t), c, nc);
  cp_async_commit();
  for (int round = 0, t0 = 0; t0 < t; ++round, t0 += chunk) {
    const int n = min(chunk, t - t0);
    if (live && t0 + chunk < t) {  // the next round's copies go out now
      stage(us + (((round + 1) & 1) * cpb + lc) * region, clip_u, t0 + chunk,
            min(chunk, t - t0 - chunk), c, nc);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this round's copies have landed
    __syncthreads();
    const float* row = us + ((round & 1) * cpb + lc) * region + c;
    float un = row[0];  // the next sample, read one step ahead (row[n * C] is in bounds)
    int k = 0;
    while (live && k < n) {
      // a branch-free run up to the end of the frame or of the round
      const int stop = min(n, k + spf - in_frame);
      in_frame += stop - k;
      for (; k < stop; ++k) {
        const float uk = un;
        un = row[(k + 1) * nc];
        const float d = __fmul_rn(scale, fmaxf(__fmaf_rn(kc, uk, f0c), 0.0f));
#pragma unroll
        for (int o = 0; o < (OS > 0 ? OS : os); ++o) {
          r = __fadd_rn(r, d);
          const float incr = floorf(r);
          r = __fsub_rn(r, incr);
          acc = __fadd_rn(acc, incr);
        }
      }
      if (in_frame == spf) {
        out[(static_cast<int64_t>(clip) * n_frames + f) * nc + c] = acc;
        acc = 0.0f;
        in_frame = 0;
        ++f;
      }
    }
    __syncthreads();  // this round's buffer is consumed before it is refilled
  }
}

}  // namespace

// u: (b, t, c) float32 with t a whole number of frames; f0, k: (c,)
// float32; out: (b, t / spf, c) float32.
extern "C" int tdc_launch(const void* u, const void* f0, const void* k, void* out, int b, int t,
                          int c, int spf, int os, float scale, void* stream) {
  if (b <= 0 || t <= 0 || c <= 0 || c > 1024 || spf <= 0 || os <= 0 || t % spf != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpb = c >= 32 ? 1 : 32 / c;
  const dim3 block(c, cpb);
  const int grid = (b + cpb - 1) / cpb;
  const int chunk = max(1, min(MAX_CHUNK, STAGE_FLOATS / (cpb * c) - 1));
  const size_t smem = sizeof(float) * 2 * cpb * (chunk * c + c);
  auto kern = os == 2 ? tdc_kernel<2> : tdc_kernel<0>;
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(f0), static_cast<const float*>(k),
      static_cast<float*>(out), b, t, spf, os, scale, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
