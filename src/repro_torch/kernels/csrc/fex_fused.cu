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
// a clip and sample). No bit-equal form reaches either: each step sits on a
// dependent chain (s1 -> y = fma -> a1*y -> fma -> +s2, four roundings
// deep) that cannot be reassociated or split in time, so the floor is T
// chain steps a (clip, channel), whatever the number of SMs. `chip_ab.py`
// measures the chain's cycles a sample with a probe of biquad_y and the SM
// clock in the same call; PERF.md gives the floor beside the roofline bound.
//
// Design: the filter warp issues the chain and almost nothing else. A block
// has 32 / C clips (or one clip and 32 of its channels for C > 32) and two
// or three warps:
//  - a producer thread keeps each clip's next chunks of kChunk samples in
//    flight with one bulk copy a clip (cp.async.bulk completing on an
//    mbarrier) into a ring of kStages buffers, in the audio's own dtype
//    (bfloat16 is converted on read). Where a clip's run is not whole
//    16-byte words from a 16-byte aligned address the producer warp stages
//    with cp.async words (bfloat16: plain loads) and arrives on the same
//    barrier;
//  - the filter warp, one lane a (clip, channel), reads four samples with
//    one 16-byte shared load (a broadcast to the clip's lanes) issued four
//    chain steps before their use, and runs biquad.cuh's step (the tick's
//    own). K1 adds |y| into the 32-sample part sum; where frame_len is a
//    multiple of 32 a 32-sample block is a compile-time body with no branch
//    inside, and the frame sum and its store happen only at block and frame
//    ends (other frame lengths take a per-sample event loop). The scan
//    writes y into a shared (chunk, clip, C) ring with one store a sample;
//  - a writer thread (scan only) sends each clip's chunk of y, n * C * 4
//    contiguous bytes of (B, T, C), with one bulk store, and hands the
//    buffer back once the store has read it. Where the chunk is not whole
//    16-byte words, or C > 32 splits its rows, the writer warp copies it.
// Two mbarriers a buffer and direction (full, empty) pass the buffers round
// the rings; there is no __syncthreads after the set-up. The clips are read
// in place at their row stride, so a trimmed view of untrimmed audio is not
// copied.
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

constexpr int kChunk = 256;       // samples of a clip a buffer holds
constexpr int kStages = 3;        // one filling, one filtered, one slack
constexpr int kSumBlock = 32;     // the frame sum's block
constexpr int kHeaderBytes = 128;  // 4 x kStages mbarriers
constexpr int kPadBytes = 16;     // a clip's row: kChunk samples and 16 bytes
static_assert(4 * kStages * 8 <= kHeaderBytes, "header too large");
static_assert(kChunk % kSumBlock == 0, "blocks of 32 end on chunk boundaries");

// Bytes of a clip's row of staged samples: 16-byte aligned, read four
// samples past a chunk, and 4 words off a multiple of 32 banks, so the
// clips of a block read different banks.
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return kChunk * static_cast<int>(sizeof(T)) + kPadBytes;
}

// floats from one clip's tile of y to the next in a buffer: a pad of
// round4(cw) words keeps 16-byte alignment and puts the clips on
// different banks
__host__ __device__ constexpr int y_stride(int cw) { return kChunk * cw + (cw + 3) / 4 * 4; }

// the largest scan block (32 lanes in 32 clips of one channel) fits an SM's
// 227 KB of shared memory
static_assert(kHeaderBytes + kStages * 32 * (row_bytes<float>() + y_stride(1) * 4) <= 232448,
              "rings too large");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive staged samples (16-byte aligned for float32, 8-byte for
// bfloat16) as float32: one shared load.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // element 0 in the low half
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

template <bool FRAMES>
__host__ __device__ constexpr int threads() {
  return FRAMES ? 64 : 96;  // producer, (writer,) filter warp
}

// K1's state in the filter lane: the part sum of the current 32-sample
// block, the frame sum, and where in the frame the lane is.
struct Frames {
  float frame = 0.0f, part = 0.0f;
  int in_frame = 0, f = 0;
};

// K1 over a chunk of n samples (a multiple of 32) with frame_len a multiple
// of 32: blocks of 32 start on chunk boundaries; samples four at a time, the
// next four read before the current four are filtered.
template <typename T>
__device__ __forceinline__ void frames_fast(const T* xr, int n, const Biquad& q, float& s1,
                                            float& s2, Frames& st, int frame_len,
                                            float inv_frame, float* out_at, int nc) {
  float4 a = load4(xr);
  for (int k = 0; k < n; k += kSumBlock) {
    float part = 0.0f;
#pragma unroll
    for (int g = 0; g < kSumBlock; g += 4) {
      const float4 nx = load4(xr + k + g + 4);  // at most 4 past n: the row's pad
      part = __fadd_rn(part, fabsf(biquad_y(q, a.x, s1, s2)));
      part = __fadd_rn(part, fabsf(biquad_y(q, a.y, s1, s2)));
      part = __fadd_rn(part, fabsf(biquad_y(q, a.z, s1, s2)));
      part = __fadd_rn(part, fabsf(biquad_y(q, a.w, s1, s2)));
      a = nx;
    }
    st.frame = __fadd_rn(st.frame, part);
    st.in_frame += kSumBlock;
    if (st.in_frame == frame_len) {
      out_at[static_cast<int64_t>(st.f) * nc] = __fmul_rn(st.frame, inv_frame);
      st.frame = 0.0f;
      st.in_frame = 0;
      ++st.f;
    }
  }
}

// K1 over a chunk of n samples, any frame length: branch-free runs up to
// the next event (the end of a 32-sample block or of a frame, or of the
// chunk), the next sample read one step ahead.
template <typename T>
__device__ __forceinline__ void frames_generic(const T* xr, int n, const Biquad& q, float& s1,
                                               float& s2, Frames& st, int frame_len,
                                               float inv_frame, float* out_at, int nc) {
  float xn = to_f32(xr[0]);
  int k = 0;
  while (k < n) {
    const int stop =
        min(n, k + min(kSumBlock - st.in_frame % kSumBlock, frame_len - st.in_frame));
    const int start = k;
    for (; k < stop; ++k) {
      const float xk = xn;
      xn = to_f32(xr[k + 1]);  // xr[n] is the row's pad
      st.part = __fadd_rn(st.part, fabsf(biquad_y(q, xk, s1, s2)));
    }
    st.in_frame += k - start;
    if (st.in_frame % kSumBlock == 0 || st.in_frame == frame_len) {
      st.frame = __fadd_rn(st.frame, st.part);
      st.part = 0.0f;
    }
    if (st.in_frame == frame_len) {
      out_at[static_cast<int64_t>(st.f) * nc] = __fmul_rn(st.frame, inv_frame);
      st.frame = 0.0f;
      st.in_frame = 0;
      ++st.f;
    }
  }
}

// The scan over a whole chunk: y into the shared tile (row width cols).
__device__ __forceinline__ void scan_chunk(const float* xr, float* yr, int cols, const Biquad& q,
                                           float& s1, float& s2) {
  float4 a = load4(xr);
#pragma unroll 2
  for (int k = 0; k < kChunk; k += 16) {
#pragma unroll
    for (int g = 0; g < 16; g += 4) {
      const float4 nx = load4(xr + k + g + 4);
      yr[0] = biquad_y(q, a.x, s1, s2);
      yr += cols;
      yr[0] = biquad_y(q, a.y, s1, s2);
      yr += cols;
      yr[0] = biquad_y(q, a.z, s1, s2);
      yr += cols;
      yr[0] = biquad_y(q, a.w, s1, s2);
      yr += cols;
      a = nx;
    }
  }
}

// The scan over the last, shorter chunk: sample by sample.
__device__ __forceinline__ void scan_tail(const float* xr, int n, float* yr, int cols,
                                          const Biquad& q, float& s1, float& s2) {
  for (int k = 0; k < n; ++k) yr[k * cols] = biquad_y(q, xr[k], s1, s2);
}

// FRAMES: K1 (frames of mean |y|, carry from zero; fast: frame_len % 32 ==
// 0); else the scan entry (y per sample, carry in and out; ybulk: y leaves
// by bulk stores). bulk: the audio arrives by bulk copies. x holds b clips
// of t samples at row stride ts.
template <typename T, bool FRAMES>
__global__ void __launch_bounds__(threads<FRAMES>(), 1) filterbank_kernel(
    const T* __restrict__ x, const float* __restrict__ coeffs, int b, int t, int ts, int nc,
    int frame_len, float inv_frame, int cpb, int bulk, int fast, int ybulk,
    float* __restrict__ s1_io, float* __restrict__ s2_io, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // the chunk is staged
  uint64_t* empty = full + kStages;                     // ... and filtered
  uint64_t* yfull = empty + kStages;                    // y of the chunk is written
  uint64_t* yempty = yfull + kStages;                   // ... and stored
  unsigned char* ring = smem + kHeaderBytes;
  float* yring = reinterpret_cast<float*>(ring + kStages * cpb * row_bytes<T>());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = nc <= 32 ? nc : 32;   // channels a clip has in the block
  const int c0 = blockIdx.y * 32;      // the block's first channel
  const int cols = min(cw, nc - c0);   // ... and how many it takes
  const int ystride = y_stride(cw);
  const int clip0 = blockIdx.x * cpb;
  const int clips = min(cpb, b - clip0);
  const int n_chunks = (t + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], bulk ? 1 : 32);
      mbar_init(&empty[s], 32);
      mbar_init(&yfull[s], 32);
      mbar_init(&yempty[s], ybulk ? 1 : 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {  // producer
    if (bulk && lane != 0) return;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kStages, lap = i / kStages;
      const int t0 = i * kChunk, n = min(kChunk, t - t0);
      if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
      unsigned char* buf = ring + s * cpb * row_bytes<T>();
      if (bulk) {
        const unsigned bytes = static_cast<unsigned>(n) * sizeof(T);
        mbar_arrive_tx(&full[s], bytes * clips);
        for (int lc = 0; lc < clips; ++lc) {
          bulk_copy(buf + lc * row_bytes<T>(), x + static_cast<int64_t>(clip0 + lc) * ts + t0,
                    bytes, &full[s]);
        }
        continue;
      }
      for (int lc = 0; lc < clips; ++lc) {
        T* row = reinterpret_cast<T*>(buf + lc * row_bytes<T>());
        const T* src = x + static_cast<int64_t>(clip0 + lc) * ts + t0;
        for (int k = lane; k < n; k += 32) {
          if constexpr (sizeof(T) == 4) {
            cp_async4(row + k, src + k);
          } else {
            row[k] = src[k];
          }
        }
      }
      if constexpr (sizeof(T) == 4) {
        cp_async_mbar_arrive(&full[s]);  // arrives once this lane's copies have landed
      } else {
        mbar_arrive(&full[s]);
      }
    }
    if (!bulk) cp_async_wait<0>();  // no copy outlives its thread
    return;
  }

  if (!FRAMES && warp == 1) {  // writer: y tiles -> (B, T, C)
    if (ybulk && lane != 0) return;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kStages, lap = i / kStages;
      const int t0 = i * kChunk, n = min(kChunk, t - t0);
      mbar_wait(&yfull[s], lap & 1);
      const float* tiles = yring + s * cpb * ystride;
      if (ybulk) {
        for (int lc = 0; lc < clips; ++lc) {
          bulk_store(out + (static_cast<int64_t>(clip0 + lc) * t + t0) * nc, tiles + lc * ystride,
                     static_cast<unsigned>(n * nc) * 4u);
        }
        bulk_commit();
        bulk_wait_read<0>();  // the buffer may be written again
      } else {
        for (int lc = 0; lc < clips; ++lc) {
          for (int j = lane; j < n * cols; j += 32) {
            out[(static_cast<int64_t>(clip0 + lc) * t + t0 + j / cols) * nc + c0 + j % cols] =
                tiles[lc * ystride + j];
          }
        }
      }
      mbar_arrive(&yempty[s]);
    }
    if (ybulk) bulk_wait<0>();
    return;
  }

  // filter warp: lane = (clip lc, channel col)
  const int lc = lane / cw, col = lane % cw;
  const bool live = lc < clips && col < cols;
  const int ch = c0 + (live ? col : 0);
  const int64_t clip = clip0 + (live ? lc : 0);
  const Biquad q = load_biquad(coeffs, ch, nc);
  float s1 = 0.0f, s2 = 0.0f;
  if (!FRAMES && live) {
    s1 = s1_io[clip * nc + ch];
    s2 = s2_io[clip * nc + ch];
  }
  Frames st;
  float* out_at = FRAMES ? out + clip * (t / frame_len) * nc + ch : nullptr;
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages, lap = i / kStages;
    const int n = min(kChunk, t - i * kChunk);
    const T* xr = reinterpret_cast<const T*>(ring + (s * cpb + lc) * row_bytes<T>());
    mbar_wait(&full[s], lap & 1);
    if (FRAMES) {
      if (live) {
        if (fast) {
          frames_fast(xr, n, q, s1, s2, st, frame_len, inv_frame, out_at, nc);
        } else {
          frames_generic(xr, n, q, s1, s2, st, frame_len, inv_frame, out_at, nc);
        }
      }
      mbar_arrive(&empty[s]);
      continue;
    }
    if (lap > 0) mbar_wait(&yempty[s], (lap - 1) & 1);
    if (live) {
      float* yr = yring + (s * cpb + lc) * ystride + col;
      const float* xf = reinterpret_cast<const float*>(xr);
      if (n == kChunk) {
        scan_chunk(xf, yr, cols, q, s1, s2);
      } else {
        scan_tail(xf, n, yr, cols, q, s1, s2);
      }
    }
    mbar_arrive(&empty[s]);
    if (ybulk) fence_proxy_async();  // the bulk store reads these writes
    mbar_arrive(&yfull[s]);
  }
  if (!FRAMES && live) {
    s1_io[clip * nc + ch] = s1;
    s2_io[clip * nc + ch] = s2;
  }
}

template <typename T, bool FRAMES>
int launch(const void* x, const void* coeffs, int b, int t, int ts, int c, int frame_len,
           float inv_frame, int cpb, int bulk, int fast, int ybulk, void* s1, void* s2,
           void* out, void* stream) {
  // cpb, bulk, fast and ybulk come from the wrapper's fex_geometry, the
  // one place their rules live; only the shapes are checked here
  const int cw = c <= 32 ? c : 32;
  const bool ok = b > 0 && t > 0 && ts >= t && c > 0 && cpb >= 1 && cpb * cw <= 32 &&
                  (!FRAMES || (frame_len > 0 && t % frame_len == 0));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kHeaderBytes + kStages * cpb * row_bytes<T>() +
                   (FRAMES ? 0 : kStages * cpb * y_stride(cw) * 4);
  auto kern = filterbank_kernel<T, FRAMES>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((b + cpb - 1) / cpb, (c + 31) / 32);
  kern<<<grid, threads<FRAMES>(), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(coeffs), b, t, ts, c, frame_len,
      inv_frame, cpb, bulk, fast, ybulk, static_cast<float*>(s1), static_cast<float*>(s2),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: b clips of t samples (a whole number of frames) at row stride ts,
// float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1); coeffs (5, c) float32; out
// (b, t / frame_len, c) float32. The wrapper (repro_torch/kernels/fex_fused/
// ops.py fex_geometry) chooses cpb clips a block; bulk: stage with bulk
// copies (x 16-byte aligned, ts and t whole 16-byte words); fast:
// frame_len % 32 == 0. The launch trusts these flags.
extern "C" int fex_fused_launch(const void* x, int x_bf16, const void* coeffs, void* out,
                                int b, int t, int ts, int c, int frame_len, float inv_frame,
                                int cpb, int bulk, int fast, void* stream) {
  if (x_bf16) {
    return launch<__nv_bfloat16, true>(x, coeffs, b, t, ts, c, frame_len, inv_frame, cpb, bulk,
                                       fast, 0, nullptr, nullptr, out, stream);
  }
  return launch<float, true>(x, coeffs, b, t, ts, c, frame_len, inv_frame, cpb, bulk, fast, 0,
                             nullptr, nullptr, out, stream);
}

// x: b clips of t float32 samples at row stride ts; coeffs (5, c); s1, s2
// (b, c) float32, read and overwritten with the carry after the last
// sample; y (b, t, c) float32. ybulk: y leaves by bulk stores (c <= 32, t * c
// a multiple of 4, y 16-byte aligned).
extern "C" int biquad_stream_launch(const void* x, const void* coeffs, void* s1, void* s2,
                                    void* y, int b, int t, int ts, int c, int cpb, int bulk,
                                    int ybulk, void* stream) {
  return launch<float, false>(x, coeffs, b, t, ts, c, 0, 0.0f, cpb, bulk, 0, ybulk, s1, s2, y,
                              stream);
}

extern "C" const char* fex_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
