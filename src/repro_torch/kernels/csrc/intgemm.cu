// Saturating int24 GEMM: (M, K) int32 activation codes x (K, N) int8 weight
// codes -> (M, N) int32.
//
// Replaces src/repro/kernels/intgemm/kernel.py:28 _intgemm_kernel /
// :46 intgemm_pallas (the TPU's MXU int8 path with a K-sequential grid).
//
// Bound: at the classifier's shapes (M = streams, K <= 48, N <= 144) the
// data sheet puts it on bytes (4 * M * (K + N) bytes against 2 * M * K * N
// operations at the float32 rate). The work itself is 28.3 M MACs at
// (4096, 48) x (48, 144); as 4-way int8 dot products (DP4A) that is two
// instructions for 4 MACs of a 14-bit activation, so the launch and the
// blocks' staging, not the products, set the time.
// Design: a block owns 16 rows and a tile of up to 256 columns (a 2-D
// grid; 4096 rows give 256 blocks, two an SM). Per chunk of 64 k it stages
// the rows' codes as two int8 planes, each 14-bit code split exactly into
// x = 128 hi + lo with hi = x >> 7 in [-64, 63] and lo = x & 127, packed 4
// consecutive k to a 32-bit word, and the weights transposed in registers
// so that a word holds one column's 4 consecutive k (zeros past K and N).
// Each thread then runs a 4 x 4 register tile: per 4 k, three 16-byte
// shared-memory loads (4 rows' hi / lo words, 4 columns' weight words) feed
// 32 DP4As, 64 MACs; the sum is 128 * sum(hi w) + sum(lo w), exact in int32
// for 14-bit codes and K < 2^11, clipped once at the end; 16-byte stores
// where N allows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intgemm.cuh"

namespace {

constexpr int BM = 16;       // rows a block
constexpr int KC = 64;       // k a staged chunk
constexpr int KQ = KC / 4;   // 4-k words a chunk
constexpr int MAX_BN = 256;  // columns a block (a thread a 4 x 4 tile: <= 256 threads)

// The low bytes of four words, packed into one.
__device__ __forceinline__ uint32_t pack_bytes(int32_t a, int32_t b, int32_t c, int32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__global__ void __launch_bounds__(MAX_BN)
    intgemm_kernel(const int32_t* __restrict__ x, const int8_t* __restrict__ w,
                   int32_t* __restrict__ out, int m, int k, int n, int bn,
                   int x_vec, int w_vec, int out_vec) {
  // x_s[q][r] = (hi word, lo word) of row r's codes 4q..4q+3
  __shared__ __align__(16) int32_t x_s[KQ * BM * 2];
  // w_s[q][c] = column c's weight codes 4q..4q+3
  __shared__ __align__(16) uint32_t w_s[KQ * MAX_BN];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * bn;
  const int ctiles = bn / 4;
  const int rt = tid / ctiles;  // the thread's tile: rows 4 rt.., columns 4 ct..
  const int ct = tid % ctiles;
  int32_t hi[4][4] = {}, lo[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += KC) {
    const int nq = (min(KC, k - k0) + 3) / 4;
    for (int i = tid; i < BM * nq; i += nthreads) {
      const int r = i / nq;
      const int q = i % nq;
      const int64_t row = m0 + r;
      const int kk = k0 + 4 * q;
      int4 v = make_int4(0, 0, 0, 0);
      if (x_vec && row < m) {
        v = __ldg(reinterpret_cast<const int4*>(x + row * k + kk));
      } else if (row < m) {
        const int32_t* p = x + row * k + kk;
        v = make_int4(p[0], kk + 1 < k ? p[1] : 0, kk + 2 < k ? p[2] : 0,
                      kk + 3 < k ? p[3] : 0);
      }
      *reinterpret_cast<int2*>(x_s + (q * BM + r) * 2) = make_int2(
          pack_bytes(v.x >> 7, v.y >> 7, v.z >> 7, v.w >> 7),
          pack_bytes(v.x & 127, v.y & 127, v.z & 127, v.w & 127));
    }
    for (int i = tid; i < nq * ctiles; i += nthreads) {
      const int q = i / ctiles;
      const int c = n0 + 4 * (i % ctiles);
      uint32_t rows[4];  // codes (4q + j, c..c+3), one row a word
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + 4 * q + j;
        const int8_t* p = w + static_cast<int64_t>(kk) * n + c;
        if (kk >= k) {
          rows[j] = 0;
        } else if (w_vec && c + 3 < n) {
          rows[j] = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
          rows[j] = pack_bytes(p[0], c + 1 < n ? p[1] : 0, c + 2 < n ? p[2] : 0,
                               c + 3 < n ? p[3] : 0);
        }
      }
      const uint32_t b01 = __byte_perm(rows[0], rows[1], 0x5140);  // bytes 0, 1 of rows 0, 1
      const uint32_t b23 = __byte_perm(rows[0], rows[1], 0x7362);  // bytes 2, 3
      const uint32_t d01 = __byte_perm(rows[2], rows[3], 0x5140);
      const uint32_t d23 = __byte_perm(rows[2], rows[3], 0x7362);
      *reinterpret_cast<uint4*>(w_s + q * bn + (c - n0)) =
          make_uint4(__byte_perm(b01, d01, 0x5410), __byte_perm(b01, d01, 0x7632),
                     __byte_perm(b23, d23, 0x5410), __byte_perm(b23, d23, 0x7632));
    }
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      const int4 xa = *reinterpret_cast<const int4*>(x_s + (q * BM + 4 * rt) * 2);
      const int4 xb = *reinterpret_cast<const int4*>(x_s + (q * BM + 4 * rt + 2) * 2);
      const uint4 wq = *reinterpret_cast<const uint4*>(w_s + q * bn + 4 * ct);
      const int xh[4] = {xa.x, xa.z, xb.x, xb.z};
      const int xl[4] = {xa.y, xa.w, xb.y, xb.w};
      const int wc[4] = {static_cast<int>(wq.x), static_cast<int>(wq.y),
                         static_cast<int>(wq.z), static_cast<int>(wq.w)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          hi[r][c] = __dp4a(xh[r], wc[c], hi[r][c]);
          lo[r][c] = __dp4a(xl[r], wc[c], lo[r][c]);
        }
      }
    }
    __syncthreads();
  }
  const int c0 = n0 + 4 * ct;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = m0 + 4 * rt + r;
    if (row >= m) break;
    int32_t acc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] = intgemm_clip(static_cast<int32_t>((static_cast<uint32_t>(hi[r][c]) << 7) +
                                                 static_cast<uint32_t>(lo[r][c])));
    }
    int32_t* o = out + row * n + c0;
    if (out_vec && c0 + 3 < n) {
      *reinterpret_cast<int4*>(o) = make_int4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c0 + c < n) o[c] = acc[c];
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int intgemm_launch(const void* x, const void* w, void* out, int m,
                              int k, int n, void* stream) {
  // a block's column tile: all of N (rounded up to 4 columns) up to 256
  const int n4 = (n + 3) & ~3;
  const int bn = n4 <= MAX_BN ? n4 : MAX_BN;
  const int x_vec = k % 4 == 0 && aligned16(x);
  const int w_vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 3) == 0;
  const int out_vec = n % 4 == 0 && aligned16(out);
  const dim3 grid((m + BM - 1) / BM, (n + bn - 1) / bn);
  const int threads = (BM / 4) * (bn / 4);
  intgemm_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), m, k, n, bn, x_vec, w_vec, out_vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* intgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
