// The row chain of the linear detector's weight gradient: (N,) d and
// (N, C) xs float32 -> (C,) float32, out[j] = acc after
// acc = fma(d[i], xs[i][j], acc) over the rows i in order from acc = 0,
// each step rounded once. On at most one channel, `head` (the wrapper's
// `head_channel`: C = 1 past 32 rows, channel 0 at C = 2, channel C - 1 at
// C = 8k + 1, from 3 rows), the first up to 8 rows are multiplied and
// added apart (acc = d[0] xs[0], then acc + d[i] xs[i], product and sum
// each rounded) and the fused chain runs from row 8: XLA's CPU code takes
// the product as a column-major GEMV whose first row tile is compiled so
// on that channel. Every other channel is the fused chain from row 0.
//
// Replaces no Pallas kernel: the reference's fit takes this product inside
// XLA's compiled gradient (src/repro/serving/cascade.py:280,
// jax.jit(jax.grad(loss))), whose CPU code runs the rows as one chain of
// fused multiply-adds a channel. The port's fit (serving/cascade.py
// _fit_grad) needs the same chain to stay array-equal to it.
//
// Bound: bytes (4 (N + N C + C)), unreachable: the chain is N dependent
// FMAs, ~4.9 cycles each, so N = 992 rows take ~2.4 µs at 1.98 GHz, and
// an empty launch ~2.7 µs. What the design can do is start the chain as
// soon as its first rows have landed and keep only the FMA latency on it.
// One warp's shared loads are the other limit (a few cycles of issue
// each): a row-major chunk, a load of d and one of xs a row, held the
// chain at ~15 cycles a row on an H100.
// Design: a block owns up to 256 channels (one lane a channel in each of
// its chain warps), one producer warp and four helper warps. Rows arrive
// in a ring of chunks of `rows` rows (a multiple of 8): where the block
// owns whole rows (C <= 256) a chunk of d and one of xs are each one
// contiguous run, sent by one bulk copy of its whole 16-byte words, the
// words past them (a ragged last chunk) and every chunk of an input whose
// base is off 16 bytes by cp.async words completing on the same barrier;
// where C > 256 each row's slice goes by words. The producer sends the
// first chunk while the other barriers are still being initialised, and
// few large chunks (issuing a bulk copy takes it ~400 cycles). The helper
// warps turn each landed chunk of xs column-major ([channel][row], rows
// padded to a multiple of 32 plus 4 so the chain's vector loads are free
// of bank conflicts; 4 x 4 register transposes where C % 4 == 0), so a
// chain lane reads 4 rows of its channel, and 4 rows of d, with one
// 16-byte load each: 0.5 loads a row. The chain warps run a chunk's whole
// groups of 8 rows in two register sets (group g + 1 loads while group
// g's FMAs run) on __fmaf_rn (exact by construction, whatever -fmad
// says), with nothing else on the path, then its last rows one by one.
// Warps off the path poll their barriers with a sleep between polls. The
// wrapper's `fma_rows_geometry` picks rows, stages and the copies; the
// dynamic shared memory limit is raised once per device, not at every
// launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kMaxCols = 256;     // channels a block: 8 chain warps
constexpr int kMaxStages = 16;    // chunks in flight
constexpr int kHelpers = 4;       // warps that turn a chunk column-major
constexpr int kGroup = 8;         // rows a chain step loads ahead
constexpr int kBarBytes = 3 * kMaxStages * 8;
constexpr int kMaxSmem = kBarBytes + 192 * 1024;  // barriers + the ring
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// mbar_wait for a warp off the chain's path (the producer, the helpers):
// it sleeps between polls, so its polls do not take issue slots and
// shared-memory cycles from the chain warp (polling warps held the chain
// at ~20 cycles a row, against 4.6 alone).
__device__ __forceinline__ void mbar_wait_sleep(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    __nanosleep(128);
  }
}

__global__ void fma_rows_kernel(const float* __restrict__ d, const float* __restrict__ xs,
                                float* __restrict__ out, int n, int c, int head_ch, int rows,
                                int stages, int cb, int flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [kMaxStages] chunk landed
  uint64_t* ready = full + kMaxStages;                  // [kMaxStages] chunk column-major
  uint64_t* empty = ready + kMaxStages;                 // [kMaxStages] chunk read
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  const int j0 = blockIdx.x * cb;
  const int cols = min(cb, c - j0);
  const bool whole = cols == c;     // the block owns whole rows
  const int ld = whole ? c : cb;    // a landed row's words
  const int cstride = rows + 4;     // a column's words in the column-major copy
  // a stage: d [rows], xs as landed [rows][ld], xs column-major [cb][cstride],
  // kGroup words of padding
  const int stage_words = rows * (1 + ld) + cb * cstride + kGroup;  // + the chain's overread
  const int chain_warps = blockDim.x / 32 - 1 - kHelpers;  // the same in every block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = (n + rows - 1) / rows;
  // the producer warp sends chunk k into its stage
  auto issue = [&](int k) {
    const int st = k % stages;
    if (k >= stages) mbar_wait_sleep(&empty[st], (k / stages - 1) & 1);
    float* d_s = ring + st * stage_words;
    float* x_s = d_s + rows;
    const int r0 = k * rows;
    const int nr = min(rows, n - r0);
    // the leading whole 16-byte words by bulk copy, the rest by words
    const int d_bulk = (flags & 1) ? nr / 4 * 4 : 0;
    const int x_bulk = (flags & 2) && whole ? nr * c / 4 * 4 : 0;
    if (lane == 0) {
      mbar_arrive_tx(&full[st], 4u * (d_bulk + x_bulk));
      if (d_bulk) bulk_copy(d_s, d + r0, 4u * d_bulk, &full[st]);
      if (x_bulk) bulk_copy(x_s, xs + static_cast<int64_t>(r0) * c, 4u * x_bulk, &full[st]);
    }
    for (int e = d_bulk + lane; e < nr; e += 32) cp_async4(d_s + e, d + r0 + e);
    if (whole) {
      const float* src = xs + static_cast<int64_t>(r0) * c;
      for (int e = x_bulk + lane; e < nr * c; e += 32) cp_async4(x_s + e, src + e);
    } else {
      for (int e = lane; e < nr * cols; e += 32) {
        const int r = e / cols;
        const int j = e - r * cols;
        cp_async4(x_s + r * ld + j, xs + static_cast<int64_t>(r0 + r) * c + j0 + j);
      }
    }
    if (!(flags & 4)) cp_async_mbar_arrive(&full[st]);
  };
  // The producer's lane 0 initialises the landing barriers and the
  // producer sends the first chunk before the block barrier, which orders
  // the other barriers' initialisation (by chain threads) before their
  // first use: the first chunk is in flight meanwhile.
  if (warp == chain_warps) {
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) {
        // the expect-tx arrival, and each producer lane's cp.async arrival
        // unless every copy of the launch is a bulk copy (flags bit 2)
        mbar_init(&full[s], (flags & 4) ? 1 : 1 + 32);
      }
      mbar_fence_init();
    }
    __syncwarp();
    if (chunks > 0) issue(0);
  } else if (threadIdx.x < stages) {  // a chain thread a stage
    mbar_init(&ready[threadIdx.x], 32 * kHelpers);
    mbar_init(&empty[threadIdx.x], chain_warps);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == chain_warps) {  // the producer warp: the other chunks
    for (int k = 1; k < chunks; ++k) issue(k);
    cp_async_wait<0>();
    return;
  }

  if (warp > chain_warps) {  // a helper warp: each landed chunk, column-major
    // a helper thread copies channel hj (and every per_row-th after it) of
    // every rstep-th row from row hr: no division in the loops
    const int h = threadIdx.x - 32 * (chain_warps + 1);
    const bool vec = whole && c % 4 == 0;  // a landed row is whole 16-byte words
    const int per_row = min(cols, 32 * kHelpers);
    const int rstep = 32 * kHelpers / per_row;
    const int hj = h % per_row;
    const int hr = h / per_row;
    int st = 0;
    unsigned parity = 0;
    for (int k = 0; k < chunks; ++k) {
      mbar_wait_sleep(&full[st], parity);
      const float* x_s = ring + st * stage_words + rows;
      float* x_c = ring + st * stage_words + rows * (1 + ld);
      const int nr = min(rows, n - k * rows);
      if (vec) {  // 4 rows x 4 channels a task: four 16-byte loads, four stores
        const int quads = c / 4;
        for (int t = h; t < (nr + 3) / 4 * quads; t += 32 * kHelpers) {
          const int p = t / quads;
          const int q = t - p * quads;
          const float* src = x_s + 4 * p * ld + 4 * q;
          const float4 a = ld4(src), b = ld4(src + ld), e = ld4(src + 2 * ld),
                       f = ld4(src + 3 * ld);
          float* dst = x_c + 4 * q * cstride + 4 * p;
          *reinterpret_cast<float4*>(dst) = make_float4(a.x, b.x, e.x, f.x);
          *reinterpret_cast<float4*>(dst + cstride) = make_float4(a.y, b.y, e.y, f.y);
          *reinterpret_cast<float4*>(dst + 2 * cstride) = make_float4(a.z, b.z, e.z, f.z);
          *reinterpret_cast<float4*>(dst + 3 * cstride) = make_float4(a.w, b.w, e.w, f.w);
        }
      } else if (hr < rstep) {
        for (int r = hr; r < nr; r += rstep) {
          for (int j = hj; j < cols; j += per_row) x_c[j * cstride + r] = x_s[r * ld + j];
        }
      }
      mbar_arrive(&ready[st]);
      if (++st == stages) {
        st = 0;
        parity ^= 1;
      }
    }
    return;
  }

  // a chain warp: lane j owns channel j0 + 32 warp + j (a lane past the
  // block's channels runs column 0's chain and writes nothing). It walks
  // each chunk's rows in groups of 8, two groups in flight in two register
  // sets (group g + 1 loads while group g's FMAs run), then the chunk's
  // last rows one by one. Nothing but loads and FMAs is on the path: with
  // a chunk test and a bounds test a group the same loop ran at ~15.6
  // cycles a row on an H100, without them at ~4.6.
  const int j = warp * 32 + lane;
  const int jj = j < cols ? j : 0;
  const int head_j = head_ch - j0;  // the head channel's lane in the block, if it is here
  const bool head_warp = head_ch >= 0 && head_j >= warp * 32 && head_j < warp * 32 + 32;
  float acc = 0.0f;
  auto chain = [&](const float4 (&dd)[2], const float4 (&xx)[2]) {
    acc = __fmaf_rn(dd[0].x, xx[0].x, acc);
    acc = __fmaf_rn(dd[0].y, xx[0].y, acc);
    acc = __fmaf_rn(dd[0].z, xx[0].z, acc);
    acc = __fmaf_rn(dd[0].w, xx[0].w, acc);
    acc = __fmaf_rn(dd[1].x, xx[1].x, acc);
    acc = __fmaf_rn(dd[1].y, xx[1].y, acc);
    acc = __fmaf_rn(dd[1].z, xx[1].z, acc);
    acc = __fmaf_rn(dd[1].w, xx[1].w, acc);
  };
  // In the warp that holds the head channel, the first chunk's first rows
  // (up to kGroup) go first, before the chunk loop: multiplied and added
  // apart on that lane (XLA's GEMV tile as compiled there), the fused
  // chain on the others; the loop then starts chunk 0 past them.
  int head_rows = 0;
  if (head_warp && chunks > 0) {
    mbar_wait(&ready[0], 0);
    const float* d_s = ring;
    const float* x_c = d_s + rows * (1 + ld) + jj * cstride;
    head_rows = min(kGroup, n);
    if (j == head_j) {
      acc = __fmul_rn(d_s[0], x_c[0]);
      for (int r = 1; r < head_rows; ++r) acc = __fadd_rn(__fmul_rn(d_s[r], x_c[r]), acc);
    } else {
      for (int r = 0; r < head_rows; ++r) acc = __fmaf_rn(d_s[r], x_c[r], acc);
    }
  }
  int st = 0;           // the stage of chunk k
  unsigned parity = 0;  // its ready barrier's phase parity
  for (int k = 0; k < chunks; ++k) {
    mbar_wait(&ready[st], parity);
    const float* d_s = ring + st * stage_words;
    const float* x_c = d_s + rows * (1 + ld) + jj * cstride;
    const int nr = min(rows, n - k * rows);
    const int head = k == 0 ? head_rows : 0;
    const int groups = (nr - head) / kGroup;
    // the chunk's whole groups with nothing on the path but loads and
    // FMAs: the loads of the group after the last one read the stage's
    // padding, not past it. They start a whole group in (after a head,
    // which is a whole group wherever a group follows it) or at the
    // chunk's start, so the 16-byte loads stay aligned.
    const float* dp = d_s + (head ? kGroup : 0);
    const float* xp = x_c + (head ? kGroup : 0);
    auto load = [&](float4 (&dd)[2], float4 (&xx)[2]) {
      dd[0] = ld4(dp);
      dd[1] = ld4(dp + 4);
      xx[0] = ld4(xp);
      xx[1] = ld4(xp + 4);
      dp += kGroup;
      xp += kGroup;
    };
    float4 da[2], xa[2], db[2], xb[2];
    load(da, xa);
    int g = 0;
    for (; g + 2 <= groups; g += 2) {
      load(db, xb);
      chain(da, xa);
      load(da, xa);
      chain(db, xb);
    }
    if (g < groups) chain(da, xa);
    for (int r = head + groups * kGroup; r < nr; ++r) acc = __fmaf_rn(d_s[r], x_c[r], acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // every load of the chunk is done
    if (++st == stages) {
      st = 0;
      parity ^= 1;
    }
  }
  if (j < cols) out[j0 + j] = acc;
}

}  // namespace

// d (n,) and xs (n, c) contiguous float32; out (c,) float32. head: the
// channel whose first rows are taken apart, or -1 (the wrapper's
// head_channel). rows (a multiple of 8), stages, cb (channels a block) and
// flags (bit 0: d by bulk copy, bit 1: xs by bulk copy, bit 2: no word
// copies at all) from the wrapper's fma_rows_geometry;
// smem = 384 + stages * (rows * (1 + row words) + cb * (rows + 4) + 8) * 4.
extern "C" int fma_rows_launch(const void* d, const void* xs, void* out, int n, int c, int head,
                               int rows, int stages, int cb, int flags, int smem, void* stream) {
  if (n < 0 || c <= 0 || head < -1 || head >= c || rows <= 0 || rows % kGroup || stages <= 0 ||
      stages > kMaxStages ||
      cb <= 0 || cb > kMaxCols || flags < 0 || flags > 7 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(fma_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const int blocks = (c + cb - 1) / cb;
  const int threads = 32 * ((min(cb, c) + 31) / 32 + 1 + kHelpers);
  fma_rows_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const float*>(xs), static_cast<float*>(out), n, c,
      head, rows, stages, cb, flags);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fma_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
