// K7: the RWKV6 recurrence with its state resident for the whole sequence.
//
// Replaces src/repro/kernels/wkv6/kernel.py:62 wkv6_pallas (body _wkv6_kernel
// :37). Plain version: repro_torch/kernels/wkv6/ref.py wkv6_plain (the
// backbone's sequential form, repro_torch/models/rwkv6.py wkv6_sequential).
//
// Computes, per (batch, head), from S = 0 (P x P, keyed [key p, value v]):
//   y_t[v] = sum_p r_t[p] * (S[p, v] + u[p] * k_t[p] * v_t[v])
//   S[p, v] <- exp(logw_t[p]) * S[p, v] + k_t[p] * v_t[v]
// r, k, v, logw (B, T, H, P) float32 or bfloat16 (one dtype), u (H, P)
// float32 -> y (B, T, H, P) in r's dtype; the state is not returned.
//
// Bound: bytes at P = 64 (5 P words moved per (b, h, t) against 5 P^2 flops:
// r . S, the decay, k v^T and its add; the bonus is O(P)). On CUDA cores the
// floor is 3 FP instructions per (key, column, step) once the bonus is out of
// the key loop: 512 x 4096 x 4096 x 3 at 128 a clock on 132 SMs, ~0.77 ms at
// 1.98 GHz for (8, 4096, 64, 64).
// Design: the bonus is factored out, y_t[v] = sum_p r_p S[p, v] + a_t v_t[v]
// with a_t = sum_p r_p u_p k_p once a step. A block of 128 threads runs one
// (b, h): thread (key group kg, value group vg) keeps a 4 x 8 register tile
// of S (keys 4 kg.., values 8 vg..), so 20 words of shared memory (r, k,
// exp(logw) of its keys, v of its values) feed 96 FP instructions a step.
// Warp w holds key quarter w: its lanes are 4 key groups x 8 value groups.
// The partial sums of y are reduce-scattered over a value group's 4 lanes
// with six shuffles, leaving two values a lane (the tile's columns are
// ordered so that a lane keeps its first half, then its first quarter: no
// selects), and the 4 quarters' partials meet in shared memory. Steps are
// staged in chunks of kL = 16: the next chunk's r, k, v and logw rows are in
// flight (16-byte cp.async, double buffered) while the block computes the
// current one; once a chunk the block turns logw into exp(logw) in place,
// computes a_t for its 16 steps, and sums and writes the previous chunk's y
// (two barriers a chunk, not one a step). bfloat16 input and rows that are
// not 16-byte aligned (P % 4 != 0) are staged by plain loads instead. The
// kernel is built at one width, kP = 64: a narrower P is padded with zeros
// (k = r = exp(logw) = 0 beyond P), which adds exact zeros.
// Occupancy: 49 280 bytes of shared memory put four blocks (16 warps) on an
// SM, so the 512 (b, h) of (8, 4096, 64, 64) run in one wave on 132 SMs.
// A 4 x 4 tile (256 threads, 32 warps an SM, at most 64 registers) was
// slower on the card: it moves 1.6x the shared-memory bytes a MAC and
// spilled (PERF.md §6).
// Rounding: each key's terms are explicit fused multiply-adds in ascending
// key order inside a tile; the 16 key groups' partials are summed
// (g0 + g2) + (g1 + g3) within a quarter and (q0 + q1) + (q2 + q3) across
// quarters, then y = fma(a_t, v_t, sum); a_t sums 8 fused chains of 8 keys
// pairwise; exp is expf. tests/test_torch_wkv6.py rehearses this order in
// numpy against the reference; held to the plain version within a stated
// tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kP = 64;         // the one width the kernel is built at
constexpr int kL = 16;         // steps a chunk
constexpr int kVT = 8;         // values a thread's tile spans (4 keys x kVT)
constexpr int kThreads = 128;  // 16 key groups x 8 value groups
constexpr int kAThreads = kThreads / kL;  // threads summing one step's a_t
constexpr int kAKeys = kP / kAThreads;    // keys each of them chains
constexpr int kStaged = kL * kP / 4 / kThreads;  // 16-byte words a thread stages per input
constexpr int kR = 0, kK = 1, kV = 2, kW = 3;    // the staged rows
constexpr unsigned kFull = 0xffffffffu;

struct Shared {
  float buf[2][4][kL][kP];  // r, k, v, logw -> exp(logw) of a chunk, double buffered
  float part[kL][4][kP];    // y partials of the 4 key quarters
  float a[2][kL];           // the bonus sum_p r_p u_p k_p of each step
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Stage n steps from t0 of the four inputs into dst: 16-byte cp.async (VEC:
// float32, P % 4 == 0, aligned; one commit group; `off` holds this thread's
// words' offsets at t = 0) or plain loads, zero beyond P and n.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(float (*dst)[kL][kP], const T* const* src,
                                      const int64_t* off, int64_t base, int64_t step, int t0,
                                      int n, int p, int tid) {
  if constexpr (VEC) {
#pragma unroll
    for (int m = 0; m < kStaged; ++m) {
      const int e = tid + m * kThreads, row = e / (kP / 4), col = (e % (kP / 4)) * 4;
      if (row < n && col < p) {
        const int64_t at = off[m] + t0 * step;
#pragma unroll
        for (int a = 0; a < 4; ++a) cp_async16(&dst[a][row][col], src[a] + at);
      }
    }
    cp_async_commit();
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      for (int e = tid; e < kL * kP; e += kThreads) {
        const int row = e / kP, col = e % kP;
        dst[a][row][col] = row < n && col < p
                               ? to_float(src[a][base + static_cast<int64_t>(t0 + row) * step + col])
                               : 0.0f;
      }
    }
  }
}

__device__ __forceinline__ float sum4(float x0, float x1, float x2, float x3) {
  return __fadd_rn(__fadd_rn(x0, x1), __fadd_rn(x2, x3));
}

// y of a staged chunk's first n steps: the quarters' partials, then the
// bonus; four columns a thread and 16-byte stores where VEC.
template <bool VEC, typename T>
__device__ __forceinline__ void write_y(const Shared& sh, int pb, T* y, int64_t base, int64_t step,
                                        int t0, int n, int p, int tid) {
  if constexpr (VEC) {
    for (int e = tid; e < kL * kP / 4; e += kThreads) {
      const int row = e / (kP / 4), col = (e % (kP / 4)) * 4;
      if (row < n && col < p) {
        float4 q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = *reinterpret_cast<const float4*>(&sh.part[row][i][col]);
        const float4 v4 = *reinterpret_cast<const float4*>(&sh.buf[pb][kV][row][col]);
        const float a = sh.a[pb][row];
        *reinterpret_cast<float4*>(y + base + static_cast<int64_t>(t0 + row) * step + col) =
            make_float4(__fmaf_rn(a, v4.x, sum4(q[0].x, q[1].x, q[2].x, q[3].x)),
                        __fmaf_rn(a, v4.y, sum4(q[0].y, q[1].y, q[2].y, q[3].y)),
                        __fmaf_rn(a, v4.z, sum4(q[0].z, q[1].z, q[2].z, q[3].z)),
                        __fmaf_rn(a, v4.w, sum4(q[0].w, q[1].w, q[2].w, q[3].w)));
      }
    }
  } else {
    for (int e = tid; e < kL * kP; e += kThreads) {
      const int row = e / kP, col = e % kP;
      if (row < n && col < p) {
        const float sum = sum4(sh.part[row][0][col], sh.part[row][1][col], sh.part[row][2][col],
                               sh.part[row][3][col]);
        store(y + base + static_cast<int64_t>(t0 + row) * step + col,
              __fmaf_rn(sh.a[pb][row], sh.buf[pb][kV][row][col], sum));
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ lw, const float* __restrict__ u, T* __restrict__ y, int tn,
                int nh, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;  // b * H + h
  const int head = bh % nh;
  // element (b, t, h, col) sits at base + t * step + col
  const int64_t base = static_cast<int64_t>(bh / nh) * tn * nh * p + static_cast<int64_t>(head) * p;
  const int64_t step = static_cast<int64_t>(nh) * p;
  const T* const src[4] = {r, k, v, lw};
  const float* uh = u + head * p;
  int64_t off[kStaged];
#pragma unroll
  for (int m = 0; m < kStaged; ++m) {
    const int e = tid + m * kThreads;
    off[m] = base + (e / (kP / 4)) * step + (e % (kP / 4)) * 4;
  }

  // columns at and beyond P are never copied: they stay zero
  for (int e = tid; e < 2 * 4 * kL * kP / 4; e += kThreads) {
    reinterpret_cast<float4*>(&sh.buf[0][0][0][0])[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const int n_chunks = (tn + kL - 1) / kL;
  stage<T, VEC>(sh.buf[0], src, off, base, step, 0, min(kL, tn), p, tid);

  // this thread's tile of S and its place in the reductions
  const int kq = warp;                 // key quarter
  const int kg = kq * 4 + (lane & 3);  // keys 4 kg .. 4 kg + 3
  const int vg = lane >> 2;            // values 8 vg .. 8 vg + 7
  // the tile's local column pair q holds a pair of values: first the half
  // the lane keeps in the reduce-scatter, within it first the pair it keeps
  const int b1 = (lane >> 1) & 1, b0 = lane & 1;
  int vq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) vq[q] = kVT * vg + (((q >> 1) ^ b1) * 2 + ((q & 1) ^ b0)) * 2;
  // the chunk prologue's thread: step arow, keys akey .. akey + kAKeys - 1
  const int arow = tid / kAThreads, akey = (tid % kAThreads) * kAKeys;
  float s[4][kVT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kVT; ++j) s[i][j] = 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int nb = c & 1, t0 = c * kL, n = min(kL, tn - t0);
    if constexpr (VEC) cp_async_wait<0>();
    __syncthreads();  // chunk c is staged; chunk c - 1's partials are written
    // y of chunk c - 1 (its v rows are still in the other buffer)
    if (c > 0) write_y<VEC>(sh, nb ^ 1, y, base, step, t0 - kL, kL, p, tid);
    // exp(logw) in place (zero beyond P), then a_t for each step of the chunk
    for (int e = tid; e < kL * kP / 4; e += kThreads) {
      const int row = e / (kP / 4), col = (e % (kP / 4)) * 4;
      float4* w4 = reinterpret_cast<float4*>(&sh.buf[nb][kW][row][col]);
      const float4 x = *w4;
      const float e0 = expf(x.x), e1 = expf(x.y), e2 = expf(x.z), e3 = expf(x.w);
      *w4 = make_float4(col + 0 < p ? e0 : 0.0f, col + 1 < p ? e1 : 0.0f, col + 2 < p ? e2 : 0.0f,
                        col + 3 < p ? e3 : 0.0f);
    }
    {
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kAKeys; q += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sh.buf[nb][kR][arow][akey + q]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sh.buf[nb][kK][arow][akey + q]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = akey + q + i;
          const float ui = key < p ? __ldg(uh + key) : 0.0f;
          acc = __fmaf_rn(rr[i], __fmul_rn(ui, kk[i]), acc);
        }
      }
#pragma unroll
      for (int m = 1; m < kAThreads; m <<= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, m));
      if (tid % kAThreads == 0) sh.a[nb][arow] = acc;
    }
    __syncthreads();  // exp(logw) and a_t are in place; chunk c - 1's y is out
    if (c + 1 < n_chunks) {
      stage<T, VEC>(sh.buf[nb ^ 1], src, off, base, step, t0 + kL, min(kL, tn - t0 - kL), p, tid);
    }
    for (int row = 0; row < n; ++row) {
      const float4 r4 = *reinterpret_cast<const float4*>(&sh.buf[nb][kR][row][4 * kg]);
      const float4 k4 = *reinterpret_cast<const float4*>(&sh.buf[nb][kK][row][4 * kg]);
      const float4 w4 = *reinterpret_cast<const float4*>(&sh.buf[nb][kW][row][4 * kg]);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
      float vv[kVT];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v2 = *reinterpret_cast<const float2*>(&sh.buf[nb][kV][row][vq[q]]);
        vv[2 * q] = v2.x;
        vv[2 * q + 1] = v2.y;
      }
      float acc[kVT];
#pragma unroll
      for (int j = 0; j < kVT; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // y reads S before the update
#pragma unroll
        for (int j = 0; j < kVT; ++j) acc[j] = __fmaf_rn(rr[i], s[i][j], acc[j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kVT; ++j) s[i][j] = __fmaf_rn(ww[i], s[i][j], __fmul_rn(kk[i], vv[j]));
      }
      // reduce-scatter over the value group's 4 key groups (lane bits 1,
      // 0): keep the first half of the local columns and send the second,
      // then the same within the kept half
      float keep[kVT / 2];
#pragma unroll
      for (int j = 0; j < kVT / 2; ++j) {
        keep[j] = __fadd_rn(acc[j], __shfl_xor_sync(kFull, acc[j + kVT / 2], 2));
      }
      const float y0 = __fadd_rn(keep[0], __shfl_xor_sync(kFull, keep[2], 1));
      const float y1 = __fadd_rn(keep[1], __shfl_xor_sync(kFull, keep[3], 1));
      // the kept pair is values vq[0], vq[0] + 1 = 2 lane, 2 lane + 1
      *reinterpret_cast<float2*>(&sh.part[row][kq][2 * lane]) = make_float2(y0, y1);
    }
  }
  __syncthreads();
  const int last = n_chunks - 1;
  write_y<VEC>(sh, last & 1, y, base, step, last * kL, tn - last * kL, p, tid);
}

template <typename T, bool VEC>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
                   void* y, int b, int t, int h, int p, cudaStream_t stream) {
  auto kern = wkv6_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Shared)));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  kern<<<b * h, kThreads, sizeof(Shared), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), u, static_cast<T*>(y), t, h, p);
  return cudaGetLastError();
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

}  // namespace

// r, k, v, logw (B, T, H, P) float32 (bf16 = 0) or bfloat16 (1); u (H, P)
// float32; y (B, T, H, P) in r's dtype. P <= 64. Returns a cudaError_t.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* lw,
                           const float* u, void* y, int bf16, int b, int t, int h, int p,
                           cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || p <= 0 || p > kP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (bf16) {
    err = launch<__nv_bfloat16, false>(r, k, v, lw, u, y, b, t, h, p, stream);
  } else if (p % 4 == 0 && aligned16(r) && aligned16(k) && aligned16(v) && aligned16(lw)) {
    err = launch<float, true>(r, k, v, lw, u, y, b, t, h, p, stream);
  } else {
    err = launch<float, false>(r, k, v, lw, u, y, b, t, h, p, stream);
  }
  return static_cast<int>(err);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
