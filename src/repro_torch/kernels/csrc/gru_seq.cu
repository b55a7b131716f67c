// K6: the weights-resident float GRU over a whole sequence.
//
// Replaces src/repro/kernels/gru/kernel.py:73 gru_sequence_pallas (body
// _gru_seq_kernel :30). Plain version: repro_torch/kernels/gru/ref.py
// gru_sequence_plain (the core float GRU, repro_torch/core/gru.py).
//
// Computes, per batch row and step t, in the PyTorch gate convention:
//   gi = x_t W + b_i, gh = h U + b_h                     (3H columns r, z, n)
//   r = sigmoid(gi_r + gh_r), z = sigmoid(gi_z + gh_z)
//   n = tanh(gi_n + r * gh_n), h' = (1 - z) * n + z * h
// x (B, T, I) batch-major, float32 or bfloat16; W (I, 3H), U (H, 3H),
// b_i, b_h (3H,), h0 (B, H) float32 -> all h' (B, T, H) in x's dtype.
//
// Bound: operations, 2 (I + H) 3H flops per row and step; the bytes (x in,
// h out, the weights once) are a third of that time at the paper's widths.
// Design: one launch runs the whole sequence. A block takes ROWS batch rows
// and loops over t inside the kernel (the TPU kernel's sequential T grid
// axis and VMEM scratch become the loop and shared memory; rows are
// independent, so no block waits on another). W, U and the biases are
// loaded into shared memory once per block and stay there, as the TPU
// kernel keeps them resident in VMEM. h lives in shared memory, double
// buffered with the x tile, so one barrier a step suffices: step t reads
// buffer t & 1 and writes buffer (t + 1) & 1. Each thread owns one hidden
// unit j for RPT rows: per k it reads the three gate weights of column j
// once from shared memory (consecutive threads, consecutive words) and the
// rows' x / h values as broadcasts, so a weight load serves RPT rows. The
// next step's x tile is loaded into registers before the step's sums and
// stored after them, hiding the device-memory latency behind the step.
// Rows past B (the ragged last tile) read zeros and write nothing; nothing
// is padded in device memory.
// Rounding: the sums are explicit fused multiply-adds in ascending k, then
// the bias is added, as the plain version adds it after its product;
// sigmoid is 1 / (1 + expf(-v)) and tanh tanhf. Neither matches torch's or
// XLA's last bit, so the kernel is held to its plain version within a
// stated tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RPT = 4;            // rows a thread computes
constexpr int GROUPS = 4;         // thread groups of H threads each
constexpr int ROWS = RPT * GROUPS;  // batch rows a block takes (_ROWS in ops.py)
constexpr int PRE = 4;            // x words a thread prefetches in registers

__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_h(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_h(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Word e of the tile's x at step t (rows past B read zero).
template <typename T>
__device__ __forceinline__ float tile_x(const T* x, int row0, int e, int t, int b, int tn, int i) {
  const int row = e / i;
  if (row0 + row >= b) return 0.0f;
  return load_x(x + (static_cast<int64_t>(row0 + row) * tn + t) * i + (e - row * i));
}

template <typename T>
__global__ void gru_seq_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               const float* __restrict__ u, const float* __restrict__ bi,
                               const float* __restrict__ bh, const float* __restrict__ h0,
                               T* __restrict__ out, int b, int tn, int i, int h) {
  extern __shared__ float sm[];
  const int g = 3 * h;
  float* ws = sm;              // (I, 3H)
  float* us = ws + i * g;      // (H, 3H)
  float* bis = us + h * g;     // (3H,)
  float* bhs = bis + g;        // (3H,)
  float* hbuf = bhs + g;       // [2][ROWS][H]
  float* xbuf = hbuf + 2 * ROWS * h;  // [2][ROWS][I]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int j = tid % h;
  const int r0 = (tid / h) * RPT;  // this thread's first row in the tile
  const int row0 = blockIdx.x * ROWS;
  const int nx = ROWS * i;

  for (int e = tid; e < i * g; e += nthreads) ws[e] = w[e];
  for (int e = tid; e < h * g; e += nthreads) us[e] = u[e];
  for (int e = tid; e < g; e += nthreads) {
    bis[e] = bi[e];
    bhs[e] = bh[e];
  }
  for (int e = tid; e < ROWS * h; e += nthreads) {
    const int row = row0 + e / h;
    hbuf[e] = row < b ? h0[static_cast<int64_t>(row) * h + e % h] : 0.0f;
  }
  for (int e = tid; e < nx; e += nthreads) xbuf[e] = tile_x(x, row0, e, 0, b, tn, i);
  __syncthreads();

  const float b_ir = bis[j], b_iz = bis[h + j], b_in = bis[2 * h + j];
  const float b_hr = bhs[j], b_hz = bhs[h + j], b_hn = bhs[2 * h + j];
  for (int t = 0; t < tn; ++t) {
    const float* hc = hbuf + (t & 1) * ROWS * h;
    const float* xc = xbuf + (t & 1) * ROWS * i;
    float* hn = hbuf + ((t + 1) & 1) * ROWS * h;
    float* xn = xbuf + ((t + 1) & 1) * ROWS * i;
    const bool more = t + 1 < tn;
    float pre[PRE];
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int e = tid + q * nthreads;
      pre[q] = (more && e < nx) ? tile_x(x, row0, e, t + 1, b, tn, i) : 0.0f;
    }
    // the rest of a tile wider than PRE words a thread, loaded now
    if (more) {
      for (int e = tid + PRE * nthreads; e < nx; e += nthreads) xn[e] = tile_x(x, row0, e, t + 1, b, tn, i);
    }

    float ir[RPT], iz[RPT], in_[RPT], hr[RPT], hz[RPT], hnn[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) ir[q] = iz[q] = in_[q] = hr[q] = hz[q] = hnn[q] = 0.0f;
    for (int k = 0; k < i; ++k) {
      const float wr = ws[k * g + j], wz = ws[k * g + h + j], wn = ws[k * g + 2 * h + j];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const float xv = xc[(r0 + q) * i + k];
        ir[q] = __fmaf_rn(xv, wr, ir[q]);
        iz[q] = __fmaf_rn(xv, wz, iz[q]);
        in_[q] = __fmaf_rn(xv, wn, in_[q]);
      }
    }
    for (int k = 0; k < h; ++k) {
      const float ur = us[k * g + j], uz = us[k * g + h + j], un = us[k * g + 2 * h + j];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const float hv = hc[(r0 + q) * h + k];
        hr[q] = __fmaf_rn(hv, ur, hr[q]);
        hz[q] = __fmaf_rn(hv, uz, hz[q]);
        hnn[q] = __fmaf_rn(hv, un, hnn[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int row = r0 + q;
      const float r = sigmoid((ir[q] + b_ir) + (hr[q] + b_hr));
      const float z = sigmoid((iz[q] + b_iz) + (hz[q] + b_hz));
      const float n = tanhf((in_[q] + b_in) + r * (hnn[q] + b_hn));
      const float hv = (1.0f - z) * n + z * hc[row * h + j];
      hn[row * h + j] = hv;
      if (row0 + row < b) store_h(out + (static_cast<int64_t>(row0 + row) * tn + t) * h + j, hv);
    }
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int e = tid + q * nthreads;
      if (more && e < nx) xn[e] = pre[q];
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* u, const float* bi, const float* bh,
                   const float* h0, void* out, int b, int t, int i, int h, int smem,
                   cudaStream_t stream) {
  auto kernel = gru_seq_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (b + ROWS - 1) / ROWS;
  kernel<<<blocks, GROUPS * h, smem, stream>>>(static_cast<const T*>(x), w, u, bi, bh, h0,
                                                static_cast<T*>(out), b, t, i, h);
  return cudaGetLastError();
}

}  // namespace

// x (B, T, I) float32 (x_bf16 = 0) or bfloat16 (1); w, u, bi, bh, h0 float32;
// out (B, T, H) in x's dtype. smem: the block's shared memory in bytes
// (ops.py smem_bytes). Returns a cudaError_t (0 on success).
extern "C" int gru_seq_launch(const void* x, int x_bf16, const float* w, const float* u,
                              const float* bi, const float* bh, const float* h0, void* out, int b,
                              int t, int i, int h, int smem, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || i <= 0 || h <= 0 || GROUPS * h > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      x_bf16 ? launch<__nv_bfloat16>(x, w, u, bi, bh, h0, out, b, t, i, h, smem, stream)
             : launch<float>(x, w, u, bi, bh, h0, out, b, t, i, h, smem, stream);
  return static_cast<int>(err);
}

extern "C" const char* gru_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
