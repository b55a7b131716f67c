// The batch filterbank of the feature extractor, two entry points:
//
//   fex_fused_launch     K1: biquad filterbank + |y| + frame mean.
//                        (B, T) float32 or bfloat16 audio at the internal
//                        rate and (5, C) float32 coefficients -> (B,
//                        T / frame_len, C) float32 frames of mean |y|, the
//                        IIR carry running on across frames. Replaces
//                        src/repro/kernels/fex_fused/kernel.py:82
//                        fex_fused_pallas (body _fex_fused_kernel :39).
//   biquad_stream_launch the same IIR step writing y per sample, (B, T, C)
//                        float32, from and back into an (s1, s2) carry: the
//                        batch Rec-BPF scan of the hardware frontends
//                        (src/repro/core/fex.py:105-136, a lax.scan outside
//                        any Pallas kernel in the reference).
//
// Plain versions: repro_torch/kernels/fex_fused/ref.py (fex_fused_ref,
// biquad_stream_ref).
//
// Bound: operations for K1 (10 flops per clip, channel and sample against
// 4 bytes a sample for 16 channels), bytes for the scan entry (64 bytes of y
// a clip and sample). Both run bound by latency instead: each step sits on a
// dependent chain (s1 -> y -> a1*y -> fma -> +s2, four roundings deep) and
// there is one thread per (clip, channel) only.
// Design: one thread per (clip, channel), sequential over time, the (s1, s2)
// carry in registers (the TPU kernel's VMEM scratch carried over its
// sequential frame grid axis becomes the thread's loop). A block holds
// 32 / C clips; it stages CHUNK samples of each clip in shared memory, double
// buffered: the next round's copies (cp.async, coalesced) are in flight
// while the C channel threads of a clip filter the current round from
// shared memory. bfloat16 audio is staged synchronously (cp.async moves
// whole 4-byte words). The biquad step is biquad.cuh's, the tick's own.
// With one warp a block nothing hides a latency, so the sample loop runs
// branch-free between events (the end of a 32-sample block or frame, or of
// the round), unrolled by 4, with the next sample read one step ahead.
//
// Order of the frame sum: |y| is summed in consecutive blocks of 32
// samples, each block from zero, and the block sums are added in order: the
// order of the reference's compiled frame mean (XLA's CPU backend rewrites
// the 512-long reduction into 16 windows of 32). The plain version sums in
// the same order, so the two agree bit for bit. The mean is sum * (1 /
// frame_len), as XLA folds the division.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "biquad.cuh"

namespace {

constexpr int CHUNK = 256;  // samples of each clip staged per round
constexpr int SUM_BLOCK = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A clip's staged samples: CHUNK words plus one of padding, so the clips of
// a block read different shared-memory banks.
constexpr int ROW = CHUNK + 1;

// Stage samples [t0, t0 + n) of this thread's clip into its row of buf: the
// clip's C threads copy every C-th sample (asynchronous word copies for
// float32, converting loads for bfloat16).
template <typename T>
__device__ __forceinline__ void stage(float* row, const T* clip_x, int t0, int n, int c, int nc) {
  for (int k = c; k < n; k += nc) {
    if constexpr (sizeof(T) == 4) {
      cp_async4(row + k, reinterpret_cast<const float*>(clip_x + t0 + k));
    } else {
      row[k] = to_f32(clip_x[t0 + k]);
    }
  }
}

// blockDim = (C, clips per block). FRAMES: K1 (frames of mean |y|, carry
// from zero); else the scan entry (y per sample, carry in and out).
template <typename T, bool FRAMES>
__global__ void filterbank_kernel(const T* __restrict__ x, const float* __restrict__ coeffs,
                                  int b, int t, int frame_len, float inv_frame,
                                  float* s1_io, float* s2_io, float* __restrict__ out) {
  extern __shared__ float xs[];  // [2][clips per block][ROW], double buffered
  const int nc = blockDim.x;
  const int c = threadIdx.x;
  const int lc = threadIdx.y;
  const int cpb = blockDim.y;
  const int clip = blockIdx.x * cpb + lc;
  const bool live = clip < b;
  const T* clip_x = x + static_cast<int64_t>(live ? clip : 0) * t;
  const Biquad q = load_biquad(coeffs, c, nc);
  float s1 = 0.0f, s2 = 0.0f;
  if (!FRAMES && live) {
    s1 = s1_io[static_cast<int64_t>(clip) * nc + c];
    s2 = s2_io[static_cast<int64_t>(clip) * nc + c];
  }
  float frame = 0.0f, part = 0.0f;
  int in_frame = 0, f = 0;
  const int n_frames = FRAMES ? t / frame_len : 0;
  if (live) stage(xs + lc * ROW, clip_x, 0, min(CHUNK, t), c, nc);
  cp_async_commit();
  for (int round = 0, t0 = 0; t0 < t; ++round, t0 += CHUNK) {
    const int n = min(CHUNK, t - t0);
    if (live && t0 + CHUNK < t) {  // the next round's copies go out now
      stage(xs + (((round + 1) & 1) * cpb + lc) * ROW, clip_x, t0 + CHUNK,
            min(CHUNK, t - t0 - CHUNK), c, nc);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this round's copies have landed
    __syncthreads();
    const float* row = xs + ((round & 1) * cpb + lc) * ROW;
    // (written only for a live clip; selecting clip 0 for the others here
    // measured 1.7x slower on the scan, the compiler's addressing changes)
    float* y_out = FRAMES ? nullptr : out + (static_cast<int64_t>(clip) * t + t0) * nc + c;
    float xn = row[0];  // the next sample, read one step ahead (row[n] is in bounds)
    int k = 0;
    while (live && k < n) {
      // a branch-free run up to the next event: the end of a 32-sample
      // block or of a frame (K1), or of the round
      const int stop = FRAMES ? min(n, k + min(SUM_BLOCK - in_frame % SUM_BLOCK,
                                                frame_len - in_frame))
                              : n;
      const int start = k;
#pragma unroll 4
      for (; k < stop; ++k) {
        const float xk = xn;
        xn = row[k + 1];
        const float y = biquad_y(q, xk, s1, s2);
        if (FRAMES) {
          part = __fadd_rn(part, fabsf(y));
        } else {
          y_out[static_cast<int64_t>(k) * nc] = y;
        }
      }
      if (FRAMES) {
        in_frame += k - start;
        if (in_frame % SUM_BLOCK == 0 || in_frame == frame_len) {
          frame = __fadd_rn(frame, part);
          part = 0.0f;
        }
        if (in_frame == frame_len) {
          out[(static_cast<int64_t>(clip) * n_frames + f) * nc + c] = __fmul_rn(frame, inv_frame);
          frame = 0.0f;
          in_frame = 0;
          ++f;
        }
      }
    }
    __syncthreads();  // this round's buffer is consumed before it is refilled
  }
  if (!FRAMES && live) {
    s1_io[static_cast<int64_t>(clip) * nc + c] = s1;
    s2_io[static_cast<int64_t>(clip) * nc + c] = s2;
  }
}

template <typename T, bool FRAMES>
int launch(const void* x, const void* coeffs, int b, int t, int c, int frame_len,
           float inv_frame, void* s1, void* s2, void* out, void* stream) {
  if (b <= 0 || t <= 0 || c <= 0 || c > 1024 || (FRAMES && frame_len <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpb = c >= 32 ? 1 : 32 / c;
  const dim3 block(c, cpb);
  const int grid = (b + cpb - 1) / cpb;
  const size_t smem = sizeof(float) * 2 * cpb * ROW;
  filterbank_kernel<T, FRAMES><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(coeffs), b, t, frame_len, inv_frame,
      static_cast<float*>(s1), static_cast<float*>(s2), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, t) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1), t a whole number
// of frames; coeffs (5, c) float32; out (b, t / frame_len, c) float32.
extern "C" int fex_fused_launch(const void* x, int x_bf16, const void* coeffs, void* out,
                                int b, int t, int c, int frame_len, float inv_frame,
                                void* stream) {
  if (x_bf16) {
    return launch<__nv_bfloat16, true>(x, coeffs, b, t, c, frame_len, inv_frame, nullptr,
                                       nullptr, out, stream);
  }
  return launch<float, true>(x, coeffs, b, t, c, frame_len, inv_frame, nullptr, nullptr, out,
                             stream);
}

// x: (b, t) float32; coeffs (5, c); s1, s2 (b, c) float32, read and
// overwritten with the carry after the last sample; y (b, t, c) float32.
extern "C" int biquad_stream_launch(const void* x, const void* coeffs, void* s1, void* s2,
                                    void* y, int b, int t, int c, void* stream) {
  return launch<float, false>(x, coeffs, b, t, c, 0, 0.0f, s1, s2, y, stream);
}

extern "C" const char* fex_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
