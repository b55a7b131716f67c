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
// Bound: the roofline's is bytes (4 bytes of u a sample and channel), but
// no bit-equal form can reach it: every ZOH tick depends on the previous r
// through an add, a floor and a subtract, and r <- frac(fl(r + d)) rounds at
// an exponent that depends on r, so time cannot be split. The floor is the
// chain: T * os ticks of (FADD -> floor -> FADD) a (clip, channel), whatever
// the number of SMs. `chip_ab.py` measures the chain's cycles a tick with a
// probe of the same instructions and the SM clock in the same call, and
// PERF.md gives the floor it implies beside the roofline bound.
// Design: only the carry stays on the carry warp. A block has three warps
// and 32 / C clips (or one clip and 32 of its channels for C > 32):
//  - a producer thread stages each clip's chunk of kChunk samples, in
//    (B, T, C) one contiguous run, with one bulk copy (cp.async.bulk
//    completing on an mbarrier) into a ring of kStages buffers; where the
//    run is not 16-byte aligned it only hands the empty buffer on;
//  - a helper warp turns the chunk into d = scale * max(fma(k, u, f0), 0)
//    in place (reading u from global memory where nothing was copied) and
//    notes whether any d reached 2^22;
//  - the carry warp, one lane a (clip, channel), reads d from shared memory
//    two samples ahead and runs the os ticks.
// Three mbarriers a buffer (full, ready, empty) pass it round the ring. With
// os = 2 and a chunk that divides samples_per_frame (128 of 512 at the
// paper's config) frames end on chunk boundaries: the carry loop has a
// compile-time trip count (the chunk, 2 ticks a sample) and no frame
// bookkeeping inside a chunk. Other os and frames that end inside a chunk
// take the generic loop.
// The floor: in a fast chunk where the helper saw every d below 2^22,
// s = r + d < 2^23 and floor(s) is computed as fl_down(s + 2^23) - 2^23,
// exactly floorf(s); elsewhere floorf. Both are bit-equal to the plain
// version. On the H100 the add's chain is 17 cycles a tick against
// floorf's 26 (FRND alone ~18; `chip_ab.py` measures both), so the chain
// floor at (64, 31 744, 16), os = 2, is 63 488 ticks x 17 cycles / 1.98 GHz
// = 0.545 ms (0.834 ms with floorf) against a bytes bound of 0.039 ms.
// Rounding: f0 + k*u is one fused multiply-add, as the reference's compiled
// body contracts it; everything else rounds once per operation (-fmad=false),
// as the plain version does, so kernel and plain agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "tdc_tick.cuh"

namespace {

constexpr int kThreads = 96;       // producer, helper and carry warp
constexpr int kHeaderBytes = 512;  // barriers, flags and the channels' f0 / k
constexpr int kStages = 4;         // one filling, one turned into d, one carried, one slack
// samples of a clip a buffer holds: divides the paper's 512 samples a
// frame, so at os = 2 frames end on buffer boundaries (kernels/tdc/ops.py
// CHUNK)
constexpr int kChunk = 128;
constexpr float kMagicLimit = 0x1p22f;  // every d below: r + d < 2^23

// floats from one clip's tile to the next in a buffer of cpb clips of cw
// channels: a pad of one row puts the block's clips on different banks
__host__ __device__ __forceinline__ int ring_stride(int cw, int cpb) {
  return kChunk * cw + (cpb > 1 ? (cw + 3) / 4 * 4 : 0);
}
// the largest block (32 carry lanes in two or more clips) fits an SM's
// 227 KB of shared memory, and the barriers and flags fit before f0 / k
static_assert(kHeaderBytes + kStages * (kChunk * 32 + 32) * 4 <= 232448, "ring too large");
static_assert(kStages * (3 * 8 + 4) <= 256, "header too large");

// d = scale * max(f0 + k u, 0), the fused multiply-add rounding once
__device__ __forceinline__ float delta(float x, float k, float f0, float scale) {
  return __fmul_rn(scale, fmaxf(__fmaf_rn(k, x, f0), 0.0f));
}

// A whole chunk at os = 2, d read two samples ahead.
template <bool MAGIC>
__device__ __forceinline__ void carry_chunk(const float* dp, int row, float& r, float& acc) {
  float d0 = dp[0], d1 = dp[row];
#pragma unroll 16
  for (int k = 0; k < kChunk; ++k) {
    const float d2 = dp[min(k + 2, kChunk - 1) * row];
    tick<MAGIC>(d0, r, acc);
    tick<MAGIC>(d0, r, acc);
    d0 = d1;
    d1 = d2;
  }
}

// FAST: os = 2 and samples_per_frame a multiple of kChunk.
template <bool FAST>
__global__ void __launch_bounds__(kThreads, 1) tdc_kernel(
    const float* __restrict__ u, const float* __restrict__ f0, const float* __restrict__ kg,
    float* __restrict__ out, int b, int t, int ts, int nc, int spf, int os, float scale,
    int cpb, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // the chunk is in the buffer
  uint64_t* ready = full + kStages;                     // ... and turned into d
  uint64_t* empty = ready + kStages;                    // ... and consumed
  int* big = reinterpret_cast<int*>(empty + kStages);   // a d of the chunk >= 2^22
  float* f0s = reinterpret_cast<float*>(smem + 256);
  float* ks = f0s + 32;
  float* ring = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = nc <= 32 ? nc : 32;          // channels a clip has in the block
  const int c0 = blockIdx.y * 32;             // the block's first channel
  const int cols = min(cw, nc - c0);          // ... and how many it takes
  const int stride = ring_stride(cw, cpb);
  const int clip0 = blockIdx.x * cpb;
  const int clips = min(cpb, b - clip0);
  const int n_chunks = (t + kChunk - 1) / kChunk;
  if (threadIdx.x < cols) {
    f0s[threadIdx.x] = f0[c0 + threadIdx.x];
    ks[threadIdx.x] = kg[c0 + threadIdx.x];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 32);
      mbar_init(&empty[s], 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {  // producer
    if (lane != 0) return;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kStages, lap = i / kStages;
      if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
      if (bulk) {
        const unsigned bytes = static_cast<unsigned>(min(kChunk, t - i * kChunk) * cols) * 4u;
        mbar_arrive_tx(&full[s], bytes * clips);
        for (int lc = 0; lc < clips; ++lc) {
          bulk_copy(ring + (s * cpb + lc) * stride,
                    u + (static_cast<int64_t>(clip0 + lc) * ts + static_cast<int64_t>(i) * kChunk) * nc,
                    bytes, &full[s]);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  if (warp == 1) {  // helper: u -> d in place, four loads in flight a lane
    // staged tiles with 4 | cols | 128: a lane's float4 words always hold
    // the same 4 channels
    const bool vec = bulk && cols % 4 == 0 && 128 % cols == 0;
    const int c4 = vec ? (4 * lane) % cols : 0;
    const float4 f0v = make_float4(f0s[c4], f0s[c4 + 1], f0s[c4 + 2], f0s[c4 + 3]);
    const float4 kv = make_float4(ks[c4], ks[c4 + 1], ks[c4 + 2], ks[c4 + 3]);
    // otherwise element j = lane + 32 m of a clip's chunk is (row, col) of
    // a row-major n x cols tile; step the pair without dividing
    const int drow = 32 / cols, dcol = 32 % cols;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kStages, lap = i / kStages;
      const int t0 = i * kChunk, n = min(kChunk, t - t0), nt = n * cols;
      mbar_wait(&full[s], lap & 1);
      bool hi = false;
      for (int lc = 0; lc < clips; ++lc) {
        float* tile = ring + (s * cpb + lc) * stride;
        if (vec) {
          float4* t4 = reinterpret_cast<float4*>(tile);
          for (int m = lane; m < nt / 4; m += 128) {
            float4 x[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (m + 32 * q < nt / 4) x[q] = t4[m + 32 * q];
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (m + 32 * q < nt / 4) {
                const float4 d = make_float4(delta(x[q].x, kv.x, f0v.x, scale),
                                             delta(x[q].y, kv.y, f0v.y, scale),
                                             delta(x[q].z, kv.z, f0v.z, scale),
                                             delta(x[q].w, kv.w, f0v.w, scale));
                hi |= !(fmaxf(fmaxf(d.x, d.y), fmaxf(d.z, d.w)) < kMagicLimit);
                t4[m + 32 * q] = d;
              }
            }
          }
          continue;
        }
        const float* src = u + (static_cast<int64_t>(clip0 + lc) * ts + t0) * nc + c0;
        int row = lane / cols, col = lane % cols;
        for (int j0 = lane; j0 < nt; j0 += 128) {
          float x[4];
          int cs[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cs[q] = col;
            if (j0 + 32 * q < nt) {
              x[q] = bulk ? tile[j0 + 32 * q] : __ldg(src + static_cast<int64_t>(row) * nc + col);
            }
            row += drow;
            col += dcol;
            if (col >= cols) {
              col -= cols;
              ++row;
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (j0 + 32 * q < nt) {
              const float d = delta(x[q], ks[cs[q]], f0s[cs[q]], scale);
              hi |= !(d < kMagicLimit);
              tile[j0 + 32 * q] = d;
            }
          }
        }
      }
      hi = __any_sync(0xffffffffu, hi);
      if (lane == 0) big[s] = hi;
      fence_proxy_async();  // the next bulk copy into this buffer comes after these writes
      mbar_arrive(&ready[s]);
    }
    return;
  }

  // carry warp: lane = (clip lc, channel col)
  const int lc = lane / cw, col = lane % cw;
  const bool live = lc < clips && col < cols;
  const int n_frames = t / spf;
  float* out_at = out + (static_cast<int64_t>(clip0 + lc) * n_frames) * nc + c0 + col;
  float r = 0.0f, acc = 0.0f;
  int f = 0, in_frame = 0;
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages, lap = i / kStages;
    const int n = min(kChunk, t - i * kChunk);
    mbar_wait(&ready[s], lap & 1);
    const float* dp = ring + (s * cpb + lc) * stride + col;
    if (live) {
      if (FAST) {
        if (!big[s]) {
          carry_chunk<true>(dp, cols, r, acc);
        } else {
          carry_chunk<false>(dp, cols, r, acc);
        }
        in_frame += n;
        if (in_frame == spf) {
          out_at[static_cast<int64_t>(f) * nc] = acc;
          acc = 0.0f;
          in_frame = 0;
          ++f;
        }
      } else {
        int k = 0;
        while (k < n) {  // runs up to the end of a frame or of the chunk
          const int stop = min(n, k + spf - in_frame);
          in_frame += stop - k;
          for (; k < stop; ++k) {
            const float d = dp[k * cols];
            for (int o = 0; o < os; ++o) tick<false>(d, r, acc);
          }
          if (in_frame == spf) {
            out_at[static_cast<int64_t>(f) * nc] = acc;
            acc = 0.0f;
            in_frame = 0;
            ++f;
          }
        }
      }
    }
    mbar_arrive(&empty[s]);
  }
}

}  // namespace

// u: (b, ts, c) float32, of which the first t (a whole number of frames)
// samples of each clip are counted; f0, k: (c,) float32; out:
// (b, t / spf, c) float32. The wrapper (repro_torch/kernels/tdc/ops.py
// tdc_geometry) chooses cpb clips a block; bulk: stage with bulk copies
// (every clip's run and every chunk of it 16-byte aligned and a multiple
// of 16 bytes, c <= 32); fast: os = 2 and spf % kChunk == 0.
extern "C" int tdc_launch(const void* u, const void* f0, const void* k, void* out, int b, int t,
                          int ts, int c, int spf, int os, float scale, int cpb, int bulk,
                          int fast, void* stream) {
  const int cw = c <= 32 ? c : 32;
  const bool ok =
      b > 0 && t > 0 && ts >= t && c > 0 && spf > 0 && os > 0 && t % spf == 0 && cpb >= 1 &&
      cpb * cw <= 32 &&
      (!bulk || (c <= 32 && (static_cast<int64_t>(ts) * c) % 4 == 0 &&
                 (static_cast<int64_t>(t) * c) % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(u) % 16 == 0)) &&
      (!fast || (os == 2 && spf % kChunk == 0));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kHeaderBytes + kStages * cpb * ring_stride(cw, cpb) * 4;
  auto kern = fast ? tdc_kernel<true> : tdc_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((b + cpb - 1) / cpb, (c + 31) / 32);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(f0), static_cast<const float*>(k),
      static_cast<float*>(out), b, t, ts, c, spf, os, scale, cpb, bulk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
