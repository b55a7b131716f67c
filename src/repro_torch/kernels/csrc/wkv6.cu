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
// r . S, the decay, k v^T and its add; the bonus r . (u * k) v is O(P));
// the time is set by the per-step dependent work of a block and by how many
// blocks the card runs at once.
// Design: one block per (b, h), one thread per value column v, which keeps
// its column S[:, v] (P floats) in registers for all T steps: the TPU
// kernel's VMEM scratch and sequential T grid axis become registers and a
// loop, and S never touches memory. Each step, thread p loads r, k, v and
// logw at key p (consecutive threads, consecutive words: one 4 P-byte row
// each), computes exp(logw) and u * k once, and publishes them in shared
// memory (double buffered, so one barrier a step); every thread then reads
// them as broadcasts. y uses S before the update, as the reference does. The
// next step's four words are loaded into registers before the step's sums.
// The kernel is built at one width, kMaxP = 64: a narrower P is padded with
// zeros (k = r = 0 beyond P), which adds exact zeros.
// Occupancy: a block has kMaxP threads (two warps) and ptxas gives a thread
// 126 registers; at (B, H) = (8, 64) the grid's 512 blocks all fit at once,
// three or four on each of the 132 SMs (6-8 warps an SM).
// Rounding: each key's term is explicit fused multiply-adds; y sums the
// keys in four interleaved partial sums; exp is expf. Held to the plain
// version within a stated tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 64;  // the one width the kernel is built at

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kMaxP) wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                                                     const T* __restrict__ v, const T* __restrict__ lw,
                                                     const float* __restrict__ u, T* __restrict__ y,
                                                     int tn, int nh, int p) {
  // [2][4][kMaxP]: r, k, u * k and exp(logw) at every key, double buffered
  __shared__ __align__(16) float sh[2][4][kMaxP];
  const int lane = threadIdx.x;  // key p for the loads, value column v for the sums
  const int bh = blockIdx.x;     // b * H + h
  const int head = bh % nh;
  const bool live = lane < p;
  const float u_p = live ? u[head * p + lane] : 0.0f;
  // element (b, t, h, lane) sits at (bh / H * T + t) * H * P + head * P + lane
  const int64_t base = static_cast<int64_t>(bh / nh) * tn * nh * p + static_cast<int64_t>(head) * p + lane;
  const int64_t step = static_cast<int64_t>(nh) * p;

  float s[kMaxP];
#pragma unroll
  for (int q = 0; q < kMaxP; ++q) s[q] = 0.0f;
  float nr = 0.0f, nk = 0.0f, nv = 0.0f, nw = 0.0f;
  if (live && tn > 0) {
    nr = load(r + base);
    nk = load(k + base);
    nv = load(v + base);
    nw = load(lw + base);
  }
  for (int t = 0; t < tn; ++t) {
    float(*cur)[kMaxP] = sh[t & 1];
    const float vv = nv;
    cur[0][lane] = nr;
    cur[1][lane] = nk;
    cur[2][lane] = u_p * nk;
    cur[3][lane] = live ? expf(nw) : 0.0f;
    if (live && t + 1 < tn) {  // the next step's words go out now
      const int64_t at = base + (t + 1) * step;
      nr = load(r + at);
      nk = load(k + at);
      nv = load(v + at);
      nw = load(lw + at);
    }
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < kMaxP; q += 4) {
      const float4 rq = *reinterpret_cast<const float4*>(&cur[0][q]);
      const float4 kq = *reinterpret_cast<const float4*>(&cur[1][q]);
      const float4 ukq = *reinterpret_cast<const float4*>(&cur[2][q]);
      const float4 wq = *reinterpret_cast<const float4*>(&cur[3][q]);
      const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
      const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
      const float uk[4] = {ukq.x, ukq.y, ukq.z, ukq.w};
      const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[c] = __fmaf_rn(rr[c], __fmaf_rn(uk[c], vv, s[q + c]), acc[c]);
        s[q + c] = __fmaf_rn(ww[c], s[q + c], __fmul_rn(kk[c], vv));
      }
    }
    if (live) store(y + base + t * step, (acc[0] + acc[1]) + (acc[2] + acc[3]));
    // the buffer this step read is rewritten two steps on, after the next
    // step's barrier; nothing else waits here
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
                   void* y, int b, int t, int h, int p, cudaStream_t stream) {
  wkv6_kernel<T><<<b * h, kMaxP, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), u, static_cast<T*>(y), t, h, p);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, logw (B, T, H, P) float32 (bf16 = 0) or bfloat16 (1); u (H, P)
// float32; y (B, T, H, P) in r's dtype. P <= 64. Returns a cudaError_t.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* lw,
                           const float* u, void* y, int bf16, int b, int t, int h, int p,
                           cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || p <= 0 || p > kMaxP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = bf16 ? launch<__nv_bfloat16>(r, k, v, lw, u, y, b, t, h, p, stream)
                               : launch<float>(r, k, v, lw, u, y, b, t, h, p, stream);
  return static_cast<int>(err);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
