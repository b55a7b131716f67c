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
// Bound: operations, 2 (I + H) 3H flops per row and step on the float32
// CUDA cores; the bytes (x in, h out, the weights once) are a fraction of
// that time at the paper's widths.
// Design: one launch runs the whole sequence. A block takes ROWS batch rows
// and loops over t inside the kernel (the TPU kernel's sequential T grid
// axis and VMEM scratch become the loop and shared memory; rows are
// independent, so no block waits on another). W and U are copied into
// shared memory once per block, row-major (K, 3H), and stay there; h lives
// in shared memory, double buffered, so one barrier a step suffices: step t
// reads buffer t & 1 and writes buffer (t + 1) & 1.
// - Register tiles: a thread owns R = 2 rows x U = 2 adjacent hidden units
//   and keeps the six sums of each (gi and gh of r, z, n: 24 registers)
//   across the k loop. Per k it loads the U units' weight of each gate as
//   one 8-byte load (3 loads), and per 4 k each row's x or h as one 16-byte
//   broadcast (8-byte for bf16 x): 3.5 shared loads for 12 FMAs, where one
//   unit for 4 rows took 7. The row group is the fastest thread index, so a
//   warp reads 4 units' weights (32 bytes) and 8 rows' x (128 bytes) a
//   load; x and h rows are padded to a stride of 16 mod 32 bytes, so the 8
//   rows of a broadcast land in distinct banks. Measured on the H100 (the
//   K6 probes of chip_ab.py --k6): 4 x 2 tiles (48 sums, 6 warps an SM) ran
//   1.2x slower than 2 x 2 (12 warps an SM), and 1 x 2 (24 warps) 1.3x
//   slower: the loop is bound by its loads' latency at this occupancy, not
//   by their count, and 4096 rows give few warps (2 blocks an SM).
// - Widths known at compile time: the paper's layers (I, H) = (16, 48) and
//   (48, 48) are instantiations with fully unrolled k loops; every other
//   shape takes the generic instantiation (runtime widths, scalar loads, a
//   last unit past an odd H computed on a clamped column and not stored).
// - The gates run stage by stage over the thread's (row, unit) pairs (all
//   expf, then all divisions, all tanhf, all updates), so the pairs' chains
//   interleave between the divisions' branches to their slow path (8 a step).
// - x arrives ahead: a ring of STAGES steps' x tiles is filled by cp.async,
//   STAGES - 1 steps ahead of the step that reads it, so the threads carry
//   no x through registers and the device-memory latency hides behind three
//   steps of sums. 16-byte copies where every row's run is whole 16-byte
//   words at 16-byte addresses, 4-byte copies where it is whole words, and
//   for bf16 rows of an odd length or a base off 4 bytes (no cp.async size
//   fits) loads through registers; ops.py gru_seq_geometry decides.
// - The card filled: 16 rows a block give 256 blocks at 4096 rows, two a
//   SM (32 rows on 124 SMs, 16 on 8); 192 threads a block at H = 48.
// No tensor cores: 1xTF32 keeps about three decimal digits, which breaks
// the float backend's 1e-5 tolerance and the port's TF32-off rule; a
// split-float 3xTF32 scheme gives up the sums' fixed FMA chains below; and
// wgmma's 64-row tiles would leave half the SMs idle at 4096 rows.
// Rows past B (the ragged last tile) read zeros and write nothing; nothing
// is padded in device memory.
// Rounding: each sum is an explicit fused multiply-add chain in ascending k
// from 0, then the bias is added, as the plain version adds it after its
// product; sigmoid is 1 / (1 + expf(-v)) and tanh tanhf (build.py keeps
// -fmad=false, so nothing else is contracted). Neither matches torch's or
// XLA's last bit, so the kernel is held to its plain version within a
// stated tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int R = 2;            // rows a thread
constexpr int U = 2;            // adjacent hidden units a thread
constexpr int ROWS = 16;        // rows a block (ops.py ROWS)
constexpr int NRG = ROWS / R;   // row groups: the fastest thread index
constexpr int STAGES = 4;       // x ring: steps in flight (ops.py STAGES)
constexpr int MAX_THREADS = 512;  // the generic instantiation's bound (ops.py MAX_THREADS)

// How the x ring is filled (ops.py COPY_*).
enum Copy { COPY16 = 0, COPY_WORDS = 1, COPY_ELEMS = 2 };

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }
// Bytes of a padded row: whole 16-byte words, 16 mod 32 (ops.py _stride).
__host__ __device__ constexpr int padded(int bytes) {
  return round16(bytes) % 32 == 0 ? round16(bytes) + 16 : round16(bytes);
}

// The block's shared memory, in bytes (ops.py smem_bytes): W, U, h [2][ROWS]
// and the x ring [STAGES][ROWS].
__host__ __device__ constexpr int smem_bytes(int i, int h, int es) {
  return round16(i * 3 * h * 4) + round16(h * 3 * h * 4) + 2 * ROWS * padded(h * 4) +
         STAGES * ROWS * padded(i * es);
}


__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// x[k .. k + 3] of a ring row (k a multiple of 4).
__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void store_out(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_out(float* p, float a) { *p = a; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

// Copy n float32 words into shared memory (dst 16-byte aligned): 16-byte
// copies where src is 16-byte aligned, words for the rest.
__device__ __forceinline__ void stage_words(float* dst, const float* src, int n, int tid, int nt) {
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int e = tid; e < n / 4; e += nt) cp_async16(dst + 4 * e, src + 4 * e);
    e0 = n / 4 * 4;
  }
  for (int e = e0 + tid; e < n; e += nt) cp_async4(dst + e, src + e);
}

// Stage step t of the block's rows (nrows of them) into ring slot `slot`
// (xsb bytes a row), by `copy`.
template <typename T>
__device__ __forceinline__ void stage_x(unsigned char* slot, const T* x, int64_t row0, int nrows,
                                        int t, int tn, int i, int xsb, int copy, int tid, int nt) {
  const int run = i * static_cast<int>(sizeof(T));  // bytes of a row's step
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x);
  const int64_t row_bytes = static_cast<int64_t>(tn) * run;
  if (copy == COPY16) {
    const int per = run / 16;
    for (int e = tid; e < nrows * per; e += nt) {
      const int q = e / per, c = e - q * per;
      cp_async16(slot + q * xsb + 16 * c,
                 src + (row0 + q) * row_bytes + static_cast<int64_t>(t) * run + 16 * c);
    }
  } else if (copy == COPY_WORDS) {
    const int per = run / 4;
    for (int e = tid; e < nrows * per; e += nt) {
      const int q = e / per, c = e - q * per;
      cp_async4(reinterpret_cast<float*>(slot + q * xsb + 4 * c),
                reinterpret_cast<const float*>(src + (row0 + q) * row_bytes +
                                               static_cast<int64_t>(t) * run + 4 * c));
    }
  } else {
    for (int e = tid; e < nrows * i; e += nt) {
      const int q = e / i, c = e - q * i;
      reinterpret_cast<T*>(slot + q * xsb)[c] = x[((row0 + q) * tn + t) * i + c];
    }
  }
}

// acc[q][v][gate] = sum over k < K, ascending from 0, of rows[q][k] times
// m[k][gate H + v] (m row-major (K, 3H), offset to this thread's first
// unit), one fused multiply-add a term: per 4 k a 16-byte (bf16: 8-byte)
// load of each row, per k an 8-byte load of each gate's U units.
template <int K, int H, typename T>
__device__ __forceinline__ void tile_sums(float (&acc)[R][U][3], const T* const (&rows)[R],
                                          const float* m) {
#pragma unroll
  for (int k4 = 0; k4 < K; k4 += 4) {
    float4 xv[R];
#pragma unroll
    for (int q = 0; q < R; ++q) xv[q] = load_x4(rows[q] + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* mk = m + (k4 + kk) * 3 * H;
      float2 wv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) wv[c] = *reinterpret_cast<const float2*>(mk + c * H);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float xq = kk == 0 ? xv[q].x : kk == 1 ? xv[q].y : kk == 2 ? xv[q].z : xv[q].w;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[q][0][c] = __fmaf_rn(xq, wv[c].x, acc[q][0][c]);
          acc[q][1][c] = __fmaf_rn(xq, wv[c].y, acc[q][1][c]);
        }
      }
    }
  }
}

// IC, HC: the layer's widths, or 0 for the generic instantiation (runtime
// widths i and h).
template <typename T, int IC, int HC>
__global__ void __launch_bounds__(IC > 0 ? NRG * HC / U : MAX_THREADS)
    gru_seq_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ bi,
                   const float* __restrict__ bh, const float* __restrict__ h0,
                   T* __restrict__ out, int b, int tn, int i_arg, int h_arg, int copy) {
  constexpr bool FAST = IC > 0;
  const int i = FAST ? IC : i_arg;
  const int h = FAST ? HC : h_arg;
  const int g = 3 * h;
  const int hs = padded(h * 4) / 4;                         // h row stride, words
  const int xsb = padded(i * static_cast<int>(sizeof(T)));  // x ring row stride, bytes
  extern __shared__ __align__(16) unsigned char sm[];
  float* ws = reinterpret_cast<float*>(sm);                                   // (I, 3H)
  float* us = reinterpret_cast<float*>(sm + round16(i * g * 4));              // (H, 3H)
  float* hbuf = reinterpret_cast<float*>(sm + round16(i * g * 4) + round16(h * g * 4));
  unsigned char* ring = reinterpret_cast<unsigned char*>(hbuf + 2 * ROWS * hs);
  // hbuf [2][ROWS][hs] floats, then the ring [STAGES][ROWS][xsb] bytes
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int rg = tid % NRG;       // rows rg, rg + NRG, ...
  const int ug = tid / NRG;       // units U ug, U ug + 1
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int nrows = static_cast<int>(min(static_cast<int64_t>(ROWS), b - row0));

  // The layer, h0 and the first STAGES - 1 steps of x, by cp.async; rows
  // past B zeroed (nothing copies there).
  stage_words(ws, w, i * g, tid, nt);
  stage_words(us, u, h * g, tid, nt);
  for (int e = tid; e < ROWS * h; e += nt) {
    const int q = e / h, c = e - q * h;
    if (q < nrows) {
      cp_async4(hbuf + q * hs + c, h0 + (row0 + q) * h + c);
    } else {
      hbuf[q * hs + c] = 0.0f;
    }
  }
  for (int e = tid; e < STAGES * (ROWS - nrows) * xsb / 4; e += nt) {
    const int s = e / ((ROWS - nrows) * xsb / 4), rest = e - s * ((ROWS - nrows) * xsb / 4);
    reinterpret_cast<float*>(ring + (s * ROWS + nrows) * xsb)[rest] = 0.0f;
  }
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tn) stage_x(ring + s * ROWS * xsb, x, row0, nrows, s, tn, i, xsb, copy, tid, nt);
    cp_async_commit();
  }

  // This thread's units (clamped to the last for a unit past an odd H) and
  // their biases.
  int jj[U];
  float b_ir[U], b_iz[U], b_in[U], b_hr[U], b_hz[U], b_hn[U];
#pragma unroll
  for (int v = 0; v < U; ++v) {
    jj[v] = min(U * ug + v, h - 1);
    b_ir[v] = bi[jj[v]];
    b_iz[v] = bi[h + jj[v]];
    b_in[v] = bi[2 * h + jj[v]];
    b_hr[v] = bh[jj[v]];
    b_hz[v] = bh[h + jj[v]];
    b_hn[v] = bh[2 * h + jj[v]];
  }
  bool unit_ok[U];
#pragma unroll
  for (int v = 0; v < U; ++v) unit_ok[v] = U * ug + v < h;
  cp_async_wait<STAGES - 2>();
  __syncthreads();

  for (int t = 0; t < tn; ++t) {
    const float* hc = hbuf + (t & 1) * ROWS * hs;
    float* hn = hbuf + ((t + 1) & 1) * ROWS * hs;
    const unsigned char* xc = ring + (t % STAGES) * ROWS * xsb;
    if (t + STAGES - 1 < tn) {
      stage_x(ring + ((t + STAGES - 1) % STAGES) * ROWS * xsb, x, row0, nrows, t + STAGES - 1, tn,
              i, xsb, copy, tid, nt);
    }
    cp_async_commit();

    // [row][unit][gate r, z, n]
    float si[R][U][3], sh[R][U][3];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int v = 0; v < U; ++v)
#pragma unroll
        for (int c = 0; c < 3; ++c) si[q][v][c] = sh[q][v][c] = 0.0f;

    if constexpr (FAST) {
      const T* xrows[R];
      const float* hrows[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        xrows[q] = reinterpret_cast<const T*>(xc + (rg + NRG * q) * xsb);
        hrows[q] = hc + (rg + NRG * q) * hs;
      }
      tile_sums<IC, HC>(si, xrows, ws + U * ug);
      tile_sums<HC, HC>(sh, hrows, us + U * ug);
    } else {
      for (int k = 0; k < i; ++k) {
        float wv[U][3];
#pragma unroll
        for (int v = 0; v < U; ++v)
#pragma unroll
          for (int c = 0; c < 3; ++c) wv[v][c] = ws[k * g + c * h + jj[v]];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float xq = load_x(reinterpret_cast<const T*>(xc + (rg + NRG * q) * xsb) + k);
#pragma unroll
          for (int v = 0; v < U; ++v)
#pragma unroll
            for (int c = 0; c < 3; ++c) si[q][v][c] = __fmaf_rn(xq, wv[v][c], si[q][v][c]);
        }
      }
      for (int k = 0; k < h; ++k) {
        float wv[U][3];
#pragma unroll
        for (int v = 0; v < U; ++v)
#pragma unroll
          for (int c = 0; c < 3; ++c) wv[v][c] = us[k * g + c * h + jj[v]];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float hq = hc[(rg + NRG * q) * hs + k];
#pragma unroll
          for (int v = 0; v < U; ++v)
#pragma unroll
            for (int c = 0; c < 3; ++c) sh[q][v][c] = __fmaf_rn(hq, wv[v][c], sh[q][v][c]);
        }
      }
    }

    // The gates, each stage for every (row, unit) before the next, so the
    // chains interleave: sigmoid(v) = 1 / (1 + expf(-v)), tanhf, then
    // (1 - z) n + z h, each expression as the plain version's.
    float gr[R][U], gz[R][U], hv[R][U];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int v = 0; v < U; ++v) {
        gr[q][v] = expf(-((si[q][v][0] + b_ir[v]) + (sh[q][v][0] + b_hr[v])));
        gz[q][v] = expf(-((si[q][v][1] + b_iz[v]) + (sh[q][v][1] + b_hz[v])));
      }
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int v = 0; v < U; ++v) {
        gr[q][v] = 1.0f / (1.0f + gr[q][v]);
        gz[q][v] = 1.0f / (1.0f + gz[q][v]);
      }
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int v = 0; v < U; ++v)
        hv[q][v] = tanhf((si[q][v][2] + b_in[v]) + gr[q][v] * (sh[q][v][2] + b_hn[v]));
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int row = rg + NRG * q;
#pragma unroll
      for (int v = 0; v < U; ++v)
        hv[q][v] = (1.0f - gz[q][v]) * hv[q][v] + gz[q][v] * hc[row * hs + jj[v]];
      T* orow = out + ((row0 + row) * tn + t) * h;
      if constexpr (FAST) {
        *reinterpret_cast<float2*>(hn + row * hs + U * ug) = make_float2(hv[q][0], hv[q][1]);
        if (row < nrows) store_out(orow + U * ug, hv[q][0], hv[q][1]);
      } else {
#pragma unroll
        for (int v = 0; v < U; ++v) {
          if (unit_ok[v]) {
            hn[row * hs + jj[v]] = hv[q][v];
            if (row < nrows) store_out(orow + jj[v], hv[q][v]);
          }
        }
      }
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
  }
}

template <typename T, int IC, int HC>
cudaError_t launch_one(const void* x, const float* w, const float* u, const float* bi,
                       const float* bh, const float* h0, void* out, int b, int t, int i, int h,
                       int copy, int threads, int smem, cudaStream_t stream) {
  auto kernel = gru_seq_kernel<T, IC, HC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (b + ROWS - 1) / ROWS;
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const T*>(x), w, u, bi, bh, h0,
                                            static_cast<T*>(out), b, t, i, h, copy);
  return cudaGetLastError();
}

// The kernel of instantiation `inst` (0 generic, 1 (16, 48), 2 (48, 48))
// for x's dtype.
template <typename T>
void* kernel_for(int inst) {
  if (inst == 1) return reinterpret_cast<void*>(gru_seq_kernel<T, 16, 48>);
  if (inst == 2) return reinterpret_cast<void*>(gru_seq_kernel<T, 48, 48>);
  return reinterpret_cast<void*>(gru_seq_kernel<T, 0, 0>);
}

template <typename T>
cudaError_t launch(int inst, const void* x, const float* w, const float* u, const float* bi,
                   const float* bh, const float* h0, void* out, int b, int t, int i, int h,
                   int copy, int threads, int smem, cudaStream_t stream) {
  auto launcher = inst == 1   ? &launch_one<T, 16, 48>
                  : inst == 2 ? &launch_one<T, 48, 48>
                              : &launch_one<T, 0, 0>;
  return launcher(x, w, u, bi, bh, h0, out, b, t, i, h, copy, threads, smem, stream);
}

bool valid(int inst, int x_bf16, int i, int h, int copy, int threads, int smem) {
  const int es = x_bf16 ? 2 : 4;
  if (i <= 0 || h <= 0 || copy < COPY16 || copy > COPY_ELEMS || inst < 0 || inst > 2) return false;
  if ((inst == 1 && (i != 16 || h != 48)) || (inst == 2 && (i != 48 || h != 48))) return false;
  if ((copy == COPY16 && (i * es) % 16) || (copy == COPY_WORDS && (i * es) % 4)) return false;
  return threads == NRG * ((h + U - 1) / U) && threads <= MAX_THREADS &&
         smem == smem_bytes(i, h, es);
}

}  // namespace

// x (B, T, I) float32 (x_bf16 = 0) or bfloat16 (1); w, u, bi, bh, h0 float32;
// out (B, T, H) in x's dtype. inst, copy, threads and smem from ops.py
// gru_seq_geometry (checked against this file's layout). Returns a
// cudaError_t (0 on success).
extern "C" int gru_seq_launch(const void* x, int x_bf16, const float* w, const float* u,
                              const float* bi, const float* bh, const float* h0, void* out, int b,
                              int t, int i, int h, int inst, int copy, int threads, int smem,
                              cudaStream_t stream) {
  if (b <= 0 || t <= 0 || !valid(inst, x_bf16, i, h, copy, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto launcher = x_bf16 ? &launch<__nv_bfloat16> : &launch<float>;
  const cudaError_t err =
      launcher(inst, x, w, u, bi, bh, h0, out, b, t, i, h, copy, threads, smem, stream);
  return static_cast<int>(err);
}

// Blocks an SM of instantiation `inst` at `threads` and `smem` (the CUDA
// occupancy API).
extern "C" int gru_seq_occupancy(int inst, int x_bf16, int threads, int smem, int* blocks) {
  void* kernel = x_bf16 ? kernel_for<__nv_bfloat16>(inst) : kernel_for<float>(inst);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  return static_cast<int>(err);
}

extern "C" const char* gru_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
