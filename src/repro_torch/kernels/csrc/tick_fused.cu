// The whole 16 ms serving tick as one launch, for the float, qat, integer,
// delta and delta-int classifiers, on raw audio hops (software or hardware
// frontend) or FV_Norm frames, with or without the stage-1 cascade gate.
//
// Replaces src/repro/kernels/tick_fused/kernel.py:256 tick_fused_pallas
// (pallas_call at :368) and, in its ΔGRU branch, the gather-compacted
// column update K4 of src/repro/kernels/tick_fused/kernel.py:76-182 that
// runs inside it; the math is src/repro/kernels/tick_fused/ref.py:48
// tick_reference, whose PyTorch twin is repro_torch/kernels/tick_fused/ref.py
// (with gather.py as K4's plain version).
//
// Bound: operations for the dense backends (per stream and tick the
// frontend runs 512 dependent biquad steps for each of 16 channels, ~6 k
// flops a channel, and the classifier ~47 k operations, against ~1.1 kB of
// input and state); bytes come close for the ΔGRU backends, whose state is
// ~3.3 kB a stream read and written each tick.
// Design: one block of 256 threads owns 16 streams.
//   * Frontend: one thread per (stream, channel) oversamples the hop
//     inline (edge-replicated, as _chunk_to_internal), runs the TDF-II
//     chain with its (s1, s2) carry in registers, and turns the rectified
//     frame mean into FV_Norm (12-bit quantizer, log ROM, normalizer,
//     Q6.8). The hardware frontends ("hardware", "hardware-pallas": the
//     same streaming step) instead pass each sample through the VTC, run
//     the die's mismatched biquad, sum the SRO frequency
//     max((f_free + k_sro |y|) gain, 0) over the frame (blocks of 32
//     samples, then the block sums: the reference's compiled order), and
//     count tot = r + scale * sum + (j - j), counts = floor(tot),
//     r' = tot - counts; beta / alpha calibration and the code scale give
//     the FV_Raw code, and the log ROM, normalizer and Q6.8 follow as for
//     the software frontend. The carry r is written back, j is read only.
//   * Classifier: the int8 weight codes (23.6 kB) and int32 bias codes sit
//     in shared memory. The dense gate accumulators (qat, integer, float)
//     and the FC head of every backend run on register tiles: a thread owns
//     4 streams x 4 columns of one product (x . W_i or h . W_h; 288 tiles a
//     layer over 256 threads, the state product first so that the 32
//     tiles of the second round are the input's); the FC head, 1/16 of
//     the MACs, runs 48 tiles of 1 stream x 4 classes, which keeps its
//     critical path short (the ΔGRU ticks run it too). Per k a gate tile
//     loads the 4 columns' weights as one 32-bit word (one 16-byte vector
//     for float) and the 4 streams' activations once, from 16-byte vectors
//     of 4 consecutive k: 0.125 shared-memory loads a MAC (one thread an
//     accumulator would issue 2, and for qat an I2F and a multiply a
//     term); qat turns 4 codes into code * 2^-7 once per k for all 4
//     streams, with an integer op and an exact subtraction (w_lsb). What
//     is left bounds the phase: the FMA / IMAD issue (16 a k-step a
//     thread; IMAD runs at half the FMA rate), about 1/5 of the
//     instructions of one thread an accumulator. Then threads
//     stride over (stream, unit) for the gates, which are Q6.8 ROM lookups
//     with round-half-even rescales, layer by layer. The float backend
//     reads its float32 weights (96.8 kB) through the read-only cache
//     instead, so a block keeps ~53 kB of shared memory and four blocks fit
//     on an SM; its gates are expf / tanhf.
//   * ΔGRU (K4): per layer, threads over (stream, column) form the
//     thresholded deltas of the input and the state against their
//     reference memories (|Δ| > θ on the Q6.8 grid) and advance the
//     memories where a delta fires; warp 0 (input columns) and warp 1
//     (state columns) build the block's fired-column lists in shared
//     memory with __ballot_sync and a __popc prefix sum over the columns
//     that fired for any submitting stream; then each (stream, gate column)
//     thread adds one rank-1 term per listed column, in ascending column
//     order, to its accumulator (the contribution is clipped to int24 once
//     in the code domain, as intgemm clips) and forms the gate
//     preactivation from the accumulator plus bias. Skipped / total column
//     counters advance per submitting stream.
//   * Cascade (the reference's gated branch, ref.py:89-112): after the
//     frontend, one thread per stream scores the block's 16 FV_Norm values
//     ("energy": relu summed left to right, times 1/16; "linear": a chain
//     of fused multiply-adds from 0, + b, then XLA's CPU sigmoid with its
//     Cephes exp, flushed below the smallest normal), advances the
//     detector state {awake, hang, woken, ticks} of a submitting stream
//     and sets the stream's wake flag (submitted and gated open). The
//     classifier, K4's fired-column lists, the state write-back and the
//     tail read the wake flag; the frontend carry and the detector read
//     the submitted flag. A gated stream's classifier work is computed and
//     discarded, as in the reference (modelled sparsity); its scores are
//     multiplied by score_decay when that is not 1. Without a cascade the
//     wake flag is the submitted flag.
//   * Tail: one thread per stream: softmax, smoothing, the masked state
//     advance and first-index argmax.
// Streams that did not submit are skipped (they contribute no columns) and
// keep every state byte; the ragged last block is bounds-checked. State is
// updated in place (the counterpart of the reference's buffer donation).
//
// Rounding: the IIR uses __fmaf_rn exactly where the reference's compiled
// scan fuses (b0*x + s1, b1*x - a1*y, b2*x - a2*y), and the hardware
// branch where the compiled streaming step fuses (the VTC's cubic term,
// f_free + k_sro*|y|, r + scale*sum); everything else is compiled with
// -fmad=false so it rounds as the plain version does. QAT and
// delta accumulate in float32 on the exact code * 2^-7 weights; integer and
// delta-int in exact int32 (intgemm.cuh's tile, and K4's sparse terms),
// clipped once to int24. Every dense accumulator sums in ascending k from 0
// (the tiles change which thread sums, not the order). A qat product of a
// Q6.8-grid activation and a weight is exact, so there the tile fuses the
// multiply-add (__fmaf_rn rounds as __fadd_rn(acc, __fmul_rn(x, w)));
// layer 1's input product, whose FV_Norm input may lie off the grid on an
// FV tick, and the float backend, whose products are not exact, multiply
// then add. On the fixed-point grids these sums are exact; the float
// backend's is not, and it agrees with the plain version within a tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

#include "biquad.cuh"
#include "intgemm.cuh"

namespace {

constexpr int C = 16;      // channels
constexpr int H = 48;      // hidden units
constexpr int G = 3 * H;   // gate columns (r, z, n)
constexpr int K = 12;      // classes
constexpr int HOP = 256;   // raw samples per tick
constexpr int SB = 16;     // streams per block
constexpr int THREADS = SB * C;
constexpr int ACT_MIN = -8192;
constexpr int ACT_MAX = 8191;
constexpr int LUT_MIN = 2 * ACT_MIN;
constexpr int LUT_SIZE = 2 * (ACT_MAX - ACT_MIN) + 1;
constexpr int LOG_SIZE = 4096;
constexpr float Q68_LSB = 0.00390625f;         // 2^-8
constexpr float ACC_LSB = 3.0517578125e-05f;   // 2^-15

// The classifier backends, as the wrapper numbers them.
enum Backend { BK_QAT = 0, BK_INTEGER = 1, BK_FLOAT = 2, BK_DELTA = 3, BK_DELTA_INT = 4 };

// Packed weights (int8 codes, or float32 for the float backend) and biases
// (int32 codes, or float32), layer by layer; offsets in elements.
constexpr int W_L1I = 0;
constexpr int W_L1H = W_L1I + C * G;
constexpr int W_L2I = W_L1H + H * G;
constexpr int W_L2H = W_L2I + H * G;
constexpr int W_FC = W_L2H + H * G;
constexpr int W_TOTAL = W_FC + H * K;
constexpr int B_L1I = 0;
constexpr int B_L1H = G;
constexpr int B_L2I = 2 * G;
constexpr int B_L2H = 3 * G;
constexpr int B_FC = 4 * G;
constexpr int B_TOTAL = 4 * G + K;
static_assert(W_TOTAL % 16 == 0, "weights are staged as 16-byte vectors");

// Shared memory: weights, biases, 3 x [SB][H] activations (input frame,
// h1, h2; float bits for float / qat / delta, codes for integer /
// delta-int), [SB][2][G] gate preactivations, [SB][K] logits, [SB][C]
// FV_Norm frames (the detector's input), [SB] submitted and [SB] wake
// flags; the ΔGRU branch adds [SB][H] input and state deltas (codes), the
// [2][H] fired-column lists and their [2] lengths.
constexpr int SMEM_BASE = W_TOTAL + 4 * B_TOTAL + 4 * 3 * SB * H +
                          4 * SB * 2 * G + 4 * SB * K + 4 * SB * C + 4 * 2 * SB;
constexpr int SMEM_DELTA = 4 * 2 * SB * H + 4 * 2 * H + 4 * 2;

// Per-layer classifier state. The dense backends use h only; the ΔGRU
// backends all seven (float32 for delta, int32 for delta-int; the counters
// are int32 for both). The wrapper mirrors this layout in ctypes.
struct GruState {
  void* h[2];
  void* x_ref[2];
  void* h_ref[2];
  void* acc_x[2];
  void* acc_h[2];
  int32_t* skipped[2];
  int32_t* total[2];
};

// The hardware frontends' operands and their two extra carry leaves (on is
// 0 for the software frontend). The wrapper mirrors this layout in ctypes.
struct HwFrontend {
  float* r;             // [n][C] fractional phase carry, read and written
  const float* j;       // [n][C] frame-edge phase jitter, read only
  const float* gain;    // [C] 1 + gain mismatch (ones for an ideal die)
  const float* beta;    // [C]
  const float* alpha;   // [C]
  float f_free;         // SRO free-running frequency (Hz)
  float k_sro;          // SRO gain (Hz per unit rectified input)
  float tdc_scale;      // n_phases * tdc_oversample / f_tdc
  float fv_scale;       // 4095 / full-scale counts, folded
  float hd2;            // VTC distortion coefficients
  float hd3;
  int shared_hd;        // hd2 == hd3: the compiled graph shares hd2*x*x
  int on;
};

// The stage-1 cascade gate (on is 0 without one). The wrapper mirrors this
// layout in ctypes.
struct Cascade {
  uint8_t* awake;   // [n] latch (bool), read and written
  int32_t* hang;    // [n] hangover countdown
  int32_t* woken;   // [n] ticks the gate woke the classifier
  int32_t* ticks;   // [n] submitted ticks
  float w[C];       // linear detector weights
  float b;          // linear detector bias
  float wake;       // thresholds, rounded to float32 by the wrapper
  float release;
  float decay;      // score_decay
  int hangover;     // hangover_frames
  int detector;     // 0 energy, 1 linear
  int decay_on;     // score_decay != 1
  int on;
};

struct TickArgs {
  const float* inp;
  const uint8_t* mask;
  int n;
  float* s1;
  float* s2;
  GruState g;
  HwFrontend hw;
  Cascade casc;
  float* scores;
  int64_t* top;
  float* fv_out;
  const int8_t* w;
  const int32_t* b;
  const float* wf;
  const float* bf;
  const int32_t* theta;  // per layer (theta_x, theta_h), Q6.8 codes
  const float* coeffs;
  const float* mu;
  const float* sigma;
  const float* log_rom;
  const int32_t* sig_rom;
  const int32_t* tanh_rom;
  float q_max;
  float q_scale;
  float inv_frame;
  float smoothing;
  float one_minus;
  int raw;
  int backend;
};

__device__ __forceinline__ int clip_act(int v) {
  return min(max(v, ACT_MIN), ACT_MAX);
}

// int32 addition that wraps, as the plain version's int32 tensors do.
__device__ __forceinline__ int32_t wrap_add(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) + static_cast<uint32_t>(y));
}

// round(v / 2^shift), ties to even (arithmetic shift floors negatives).
__device__ __forceinline__ int round_shift_even(int v, int shift) {
  const int q = v >> shift;
  const int r = v - (q << shift);
  const int half = 1 << (shift - 1);
  return q + ((r > half || (r == half && (q & 1))) ? 1 : 0);
}

// fake_quant to Q6.8 as a code: round(v * 256) half to even, saturated.
__device__ __forceinline__ int q68_code(float v) {
  return clip_act(__float2int_rn(__fmul_rn(v, 256.0f)));
}

// The code of a float that lies on the Q6.8 grid (exact).
__device__ __forceinline__ int grid_code(float v) {
  return __float2int_rn(__fmul_rn(v, 256.0f));
}

__device__ __forceinline__ int rom_index(int code_sum) {
  return min(max(code_sum - LUT_MIN, 0), LUT_SIZE - 1);
}

// The VTC's distortion, rounded as the reference's compiled graph: the
// cubic term is one fused multiply-add; the quadratic one too unless
// hd2 == hd3, where XLA shares the product hd2*x*x between the two terms.
__device__ __forceinline__ float vtc(const HwFrontend& hw, float x) {
  if (hw.shared_hd) {
    const float p = __fmul_rn(__fmul_rn(x, hw.hd2), x);
    return __fmaf_rn(p, x, __fadd_rn(x, p));
  }
  return __fmaf_rn(__fmul_rn(__fmul_rn(x, hw.hd3), x), x,
                   __fmaf_rn(__fmul_rn(x, hw.hd2), x, x));
}

// The software frontend's frame: the rectified sum of one hop, left to
// right (the reference's in-scan accumulation).
__device__ __forceinline__ float software_frame(const float* hop, const Biquad& q,
                                                float& s1, float& s2) {
  float acc = 0.0f;
  float cur = hop[0];
  for (int i = 0; i < HOP; ++i) {
    const float nxt = (i + 1 < HOP) ? hop[i + 1] : cur;
    const float mid = __fmul_rn(__fadd_rn(cur, nxt), 0.5f);
    acc = __fadd_rn(acc, fabsf(biquad_y(q, cur, s1, s2)));
    acc = __fadd_rn(acc, fabsf(biquad_y(q, mid, s1, s2)));
    cur = nxt;
  }
  return acc;
}

// The hardware frontends' frame: the SRO frequency summed over one hop, in
// blocks of 32 internal samples (the reference's compiled frame sum).
__device__ __forceinline__ float hardware_frame(const float* hop, const Biquad& q,
                                                const HwFrontend& hw, float gain,
                                                float& s1, float& s2) {
  float total = 0.0f, part = 0.0f;
  float cur = hop[0];
  for (int i = 0; i < HOP; ++i) {
    const float nxt = (i + 1 < HOP) ? hop[i + 1] : cur;
    const float mid = __fmul_rn(__fadd_rn(cur, nxt), 0.5f);
    const float xs[2] = {cur, mid};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float y = biquad_y(q, vtc(hw, xs[h]), s1, s2);
      const float f = fmaxf(__fmul_rn(__fmaf_rn(fabsf(y), hw.k_sro, hw.f_free), gain), 0.0f);
      part = __fadd_rn(part, f);
    }
    if ((2 * i + 2) % 32 == 0) {
      total = __fadd_rn(total, part);
      part = 0.0f;
    }
    cur = nxt;
  }
  return total;
}

// The dense classifier phase runs on register tiles of NS streams x 4
// columns of one product x . W (+ b): x stream-major in shared memory (row
// stride H, from the tile's first stream), W's tile columns from w (row
// stride ldw). Per 4 k a thread loads the NS streams' 4 activations as NS
// 16-byte vectors and the 4 rows of 4 weights as four 32-bit words (int8
// codes) or 16-byte vectors (float32): at NS = 4, 0.125 loads a term.
// Every accumulator sums its terms in ascending k from 0, as before the
// tiling.
constexpr int TILES_PER_PRODUCT = (SB / 4) * (G / 4);
constexpr int FC_TILES = SB * (K / 4);
static_assert(SB % 4 == 0 && G % 4 == 0 && K % 4 == 0 && C % 4 == 0 && H % 4 == 0,
              "4 x 4 tiles and 4-deep k steps");

__device__ __forceinline__ float float4_lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Byte I of a word of int8 codes as the float32 code * 2^-7, exact, in two
// instructions in place of an I2F and a multiply: the code + 128 (the word
// is XORed with 0x80808080 first) becomes the low mantissa byte of
// 0x47800000 = 2^16, whose last mantissa bit weighs 2^-7, so the float is
// 65537 + code * 2^-7, and subtracting 65537 is exact (Sterbenz).
template <int I>
__device__ __forceinline__ float w_lsb(uint32_t biased) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x47800000u, 0x7640 + I)), 65537.0f);
}

// qat: float32 sums of Q6.8 activations times code * 2^-7 weights. A
// product of a Q6.8-grid activation (14-bit code) and a weight is exact in
// float32 (at most 2^20 units of 2^-15), so a fused multiply-add rounds as
// multiply-then-add does; FUSED is false where x may lie off the grid
// (layer 1's input: the caller's FV_Norm on an FV tick).
template <int NS, bool FUSED>
__device__ __forceinline__ void tile_qat(const int32_t* x, int depth, const int8_t* w,
                                         int ldw, float acc[NS][4]) {
  for (int k0 = 0; k0 < depth; k0 += 4) {
    float4 xv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) xv[s] = *reinterpret_cast<const float4*>(x + s * H + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t biased =
          *reinterpret_cast<const uint32_t*>(w + (k0 + kk) * ldw) ^ 0x80808080u;
      const float wk[4] = {w_lsb<0>(biased), w_lsb<1>(biased), w_lsb<2>(biased),
                           w_lsb<3>(biased)};
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float xs = float4_lane(xv[s], kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[s][c] = FUSED ? __fmaf_rn(xs, wk[c], acc[s][c])
                            : __fadd_rn(acc[s][c], __fmul_rn(xs, wk[c]));
        }
      }
    }
  }
}

// float: multiply, then add (the products are not exact); float32 weights
// read through the read-only cache.
template <int NS>
__device__ __forceinline__ void tile_float(const int32_t* x, int depth, const float* w,
                                           int ldw, float acc[NS][4]) {
  for (int k0 = 0; k0 < depth; k0 += 4) {
    float4 xv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) xv[s] = *reinterpret_cast<const float4*>(x + s * H + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(w + (k0 + kk) * ldw));
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float xs = float4_lane(xv[s], kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[s][c] = __fadd_rn(acc[s][c], __fmul_rn(xs, float4_lane(wv, c)));
        }
      }
    }
  }
}

// One NS-stream x 4-column tile of x (depth) . W + b, finished as a gate
// preactivation: Q6.8 codes (qat and delta on float sums, integer and
// delta-int on int32 sums) or float32 bits (float). w_off / b_off: the
// tile's first column in the packed weights / biases, W's row stride ldw.
template <int NS>
__device__ __forceinline__ void dense_tile(const TickArgs& a, int bk, const int32_t* x,
                                           int depth, const int8_t* w_s, const int32_t* b_s,
                                           int w_off, int b_off, int ldw, bool fused,
                                           int32_t out[NS][4]) {
  if (bk == BK_FLOAT) {
    float acc[NS][4] = {};
    tile_float<NS>(x, depth, a.wf + w_off, ldw, acc);
    const float4 b = __ldg(reinterpret_cast<const float4*>(a.bf + b_off));
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        out[s][c] = __float_as_int(__fadd_rn(acc[s][c], float4_lane(b, c)));
      }
    }
  } else if (bk == BK_INTEGER || bk == BK_DELTA_INT) {
    int32_t acc[NS][4] = {};
    intgemm_tile<NS>(x, H, w_s + w_off, ldw, depth, acc);
    const int4 b = *reinterpret_cast<const int4*>(b_s + b_off);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        out[s][c] = clip_act(round_shift_even(intgemm_clip(acc[s][c]) + int4_lane(b, c), 7));
      }
    }
  } else {
    float acc[NS][4] = {};
    if (fused) {
      tile_qat<NS, true>(x, depth, w_s + w_off, ldw, acc);
    } else {
      tile_qat<NS, false>(x, depth, w_s + w_off, ldw, acc);
    }
    const int4 b = *reinterpret_cast<const int4*>(b_s + b_off);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        out[s][c] = q68_code(
            __fadd_rn(acc[s][c], __fmul_rn(static_cast<float>(int4_lane(b, c)), ACC_LSB)));
      }
    }
  }
}

// K4's rank-1 terms for one (stream, gate column): sum over the listed
// columns i, in list order, of d[i] * w[i, col]. Code domain: exact int32
// sum, clipped once to int24. Float domain: each product is exact
// (code * code * 2^-15) and the float sum runs in the plain version's order.
__device__ __forceinline__ int32_t sparse_dot_int(const int32_t* d,
                                                  const int32_t* list, int n,
                                                  const int8_t* w, int col) {
  int32_t acc = 0;
  for (int k = 0; k < n; ++k) {
    const int i = list[k];
    acc += d[i] * static_cast<int32_t>(w[i * G + col]);
  }
  return min(max(acc, INTGEMM_ACC_MIN), INTGEMM_ACC_MAX);
}

__device__ __forceinline__ float sparse_dot_float(const int32_t* d,
                                                  const int32_t* list, int n,
                                                  const int8_t* w, int col) {
  float acc = 0.0f;
  for (int k = 0; k < n; ++k) {
    const int i = list[k];
    const int32_t p = d[i] * static_cast<int32_t>(w[i * G + col]);
    acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(p), ACC_LSB));
  }
  return acc;
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

// jax.nn.sigmoid as the reference's compiled CPU code computes it:
// 1 / (1 + exp(-z)) with XLA's Cephes exp (its clamp, ln 2 split in two and
// polynomial, fused multiply-adds where the compiled code has them), the
// result flushed to zero below the smallest normal (XLA runs with FTZ).
// The plain version is repro_torch/serving/cascade.py xla_sigmoid.
__device__ __forceinline__ float xla_sigmoid(float z) {
  float x = -z;
  x = x >= -87.80000305175781f ? x : -87.80000305175781f;
  x = x <= 88.80000305175781f ? x : 88.80000305175781f;
  float fx = floorf(__fmaf_rn(x, 1.4426950216293335f, 0.5f));
  fx = fminf(fmaxf(fx, -127.0f), 127.0f);
  float r = __fmaf_rn(-0.693359375f, fx, x);
  r = __fmaf_rn(0.00021219444170128554f, fx, r);
  float y = __fmaf_rn(r, 0.00019875691214110702f, 0.001398199936375022f);
  y = __fmaf_rn(y, r, 0.008333452045917511f);
  y = __fmaf_rn(y, r, 0.04166579619050026f);
  y = __fmaf_rn(y, r, 0.1666666567325592f);
  y = __fmaf_rn(y, r, 0.5f);
  y = __fadd_rn(__fmaf_rn(y, __fmul_rn(r, r), r), 1.0f);
  const float pow2n = __int_as_float((static_cast<int>(fx) + 127) << 23);
  const float s = __fdiv_rn(1.0f, __fmaf_rn(y, pow2n, 1.0f));
  return fabsf(s) < 1.17549435e-38f ? 0.0f : s;
}

// The stage-1 wake score of one FV_Norm frame (repro_torch/serving/cascade.py
// detector_scores, in the reference's compiled order).
__device__ __forceinline__ float detector_score(const Cascade& cs, const float* fv) {
  float acc = 0.0f;
  if (cs.detector == 0) {
    for (int c = 0; c < C; ++c) acc = __fadd_rn(acc, fmaxf(fv[c], 0.0f));
    return __fmul_rn(acc, 0.0625f);  // jnp.mean's folded 1/C
  }
  for (int c = 0; c < C; ++c) acc = __fmaf_rn(fv[c], cs.w[c], acc);
  return xla_sigmoid(__fadd_rn(acc, cs.b));
}

__global__ void __launch_bounds__(THREADS) tick_kernel(TickArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);
  int32_t* b_s = reinterpret_cast<int32_t*>(smem + W_TOTAL);
  int32_t* act_s = b_s + B_TOTAL;          // [3][SB][H]
  int32_t* gate_s = act_s + 3 * SB * H;    // [SB][2][G]
  float* logit_s = reinterpret_cast<float*>(gate_s + SB * 2 * G);  // [SB][K]
  float* fv_s = logit_s + SB * K;                                  // [SB][C]
  int* active_s = reinterpret_cast<int*>(fv_s + SB * C);           // [SB] submitted
  int* wake_s = active_s + SB;             // [SB] submitted and woken
  int32_t* dx_s = wake_s + SB;             // ΔGRU only: [SB][H]
  int32_t* dh_s = dx_s + SB * H;           // [SB][H]
  int32_t* list_s = dh_s + SB * H;         // [2][H] input, state columns
  int* nlist_s = list_s + 2 * H;           // [2]

  const int tid = threadIdx.x;
  const int base = blockIdx.x * SB;
  const int bk = a.backend;
  const bool codes = bk == BK_INTEGER || bk == BK_DELTA_INT;
  const bool flt = bk == BK_FLOAT;
  const bool delta = bk == BK_DELTA || bk == BK_DELTA_INT;

  // ---- stage weights, biases, flags and hidden state ----
  if (!flt) {
    const int4* w_src = reinterpret_cast<const int4*>(a.w);
    int4* w_dst = reinterpret_cast<int4*>(w_s);
    for (int i = tid; i < W_TOTAL / 16; i += THREADS) w_dst[i] = w_src[i];
    for (int i = tid; i < B_TOTAL; i += THREADS) b_s[i] = a.b[i];
  }
  if (tid < SB) {
    const int stream = base + tid;
    active_s[tid] = (stream < a.n && a.mask[stream]) ? 1 : 0;
    wake_s[tid] = active_s[tid];
  }
  for (int i = tid; i < 2 * SB * H; i += THREADS) {
    const int layer = i / (SB * H);
    const int s = (i / H) % SB;
    const int u = i % H;
    const int stream = base + s;
    if (stream < a.n) {
      act_s[(1 + layer) * SB * H + s * H + u] = static_cast<const int32_t*>(
          a.g.h[layer])[static_cast<int64_t>(stream) * H + u];
    }
  }
  __syncthreads();

  // ---- frontend: one thread per (stream, channel) ----
  {
    const int s = tid / C;
    const int c = tid % C;
    const int stream = base + s;
    if (active_s[s]) {
      const int64_t sc = static_cast<int64_t>(stream) * C + c;
      float fv;
      if (a.raw) {
        const Biquad q = load_biquad(a.coeffs, c, C);
        float s1 = a.s1[sc], s2 = a.s2[sc];
        const float* hop = a.inp + static_cast<int64_t>(stream) * HOP;
        float raw_code;
        if (a.hw.on) {
          const HwFrontend& hw = a.hw;
          const float total = hardware_frame(hop, q, hw, hw.gain[c], s1, s2);
          const float j = hw.j[sc];
          const float tot = __fadd_rn(__fmaf_rn(total, hw.tdc_scale, hw.r[sc]), __fsub_rn(j, j));
          const float counts = floorf(tot);
          hw.r[sc] = __fsub_rn(tot, counts);
          const float sig = __fmul_rn(hw.alpha[c], __fsub_rn(counts, hw.beta[c]));
          raw_code = fminf(fmaxf(rintf(__fmul_rn(sig, hw.fv_scale)), 0.0f),
                           static_cast<float>(LOG_SIZE - 1));
        } else {
          const float frame = __fmul_rn(software_frame(hop, q, s1, s2), a.inv_frame);
          raw_code = rintf(__fmul_rn(fminf(fmaxf(frame, 0.0f), a.q_max), a.q_scale));
        }
        a.s1[sc] = s1;
        a.s2[sc] = s2;
        const int idx = min(max(static_cast<int>(raw_code), 0), LOG_SIZE - 1);
        const float norm =
            __fdiv_rn(__fsub_rn(a.log_rom[idx], a.mu[c]), a.sigma[c]);
        fv = __fmul_rn(static_cast<float>(q68_code(norm)), Q68_LSB);
      } else {
        fv = a.inp[sc];
      }
      if (a.fv_out != nullptr) a.fv_out[sc] = fv;
      fv_s[s * C + c] = fv;
      if (codes) {
        act_s[s * H + c] = q68_code(fv);
      } else if (bk == BK_DELTA) {  // the ΔGRU snaps its input to the grid
        act_s[s * H + c] =
            __float_as_int(__fmul_rn(static_cast<float>(q68_code(fv)), Q68_LSB));
      } else {
        act_s[s * H + c] = __float_as_int(fv);
      }
    }
  }
  __syncthreads();

  // ---- cascade: detector and gate, one thread per submitting stream ----
  if (a.casc.on) {
    if (tid < SB && active_s[tid]) {
      const Cascade& cs = a.casc;
      const int64_t stream = base + tid;
      const float score = detector_score(cs, fv_s + tid * C);
      const bool awake = score >= cs.wake || (cs.awake[stream] && !(score < cs.release));
      const int hang_in = cs.hang[stream];
      const bool gate = awake || hang_in > 0;
      cs.awake[stream] = awake ? 1 : 0;
      cs.hang[stream] = awake ? cs.hangover : max(hang_in - 1, 0);
      cs.woken[stream] = wrap_add(cs.woken[stream], gate ? 1 : 0);
      cs.ticks[stream] = wrap_add(cs.ticks[stream], 1);
      wake_s[tid] = gate ? 1 : 0;
    }
    __syncthreads();
  }

  // ---- classifier: two GRU layers (woken streams) ----
  for (int layer = 0; layer < 2; ++layer) {
    const int in_dim = layer == 0 ? C : H;
    const int32_t* x_s = act_s + layer * SB * H;  // input frame, then new h1
    int32_t* h_s = act_s + (layer + 1) * SB * H;
    const int w_i_off = layer == 0 ? W_L1I : W_L2I;
    const int w_h_off = layer == 0 ? W_L1H : W_L2H;
    const int b_i_off = layer == 0 ? B_L1I : B_L2I;
    const int b_h_off = layer == 0 ? B_L1H : B_L2H;
    const int8_t* wi = w_s + w_i_off;
    const int8_t* wh = w_s + w_h_off;
    const int32_t* bi = b_s + b_i_off;
    const int32_t* bh = b_s + b_h_off;
    if (delta) {
      // (1-4) thresholded deltas; the memories advance where one fires
      const int cols = in_dim + H;
      const int tx = a.theta[2 * layer];
      const int th = a.theta[2 * layer + 1];
      for (int item = tid; item < SB * cols; item += THREADS) {
        const int s = item / cols;
        const int col = item % cols;
        const bool is_x = col < in_dim;
        const int i = is_x ? col : col - in_dim;
        int d = 0;
        if (wake_s[s]) {
          const int64_t off =
              static_cast<int64_t>(base + s) * (is_x ? in_dim : H) + i;
          void* ref_p = is_x ? a.g.x_ref[layer] : a.g.h_ref[layer];
          const int32_t cur_bits = (is_x ? x_s : h_s)[s * H + i];
          const int cur = codes ? cur_bits : grid_code(__int_as_float(cur_bits));
          const int ref = codes ? static_cast<int32_t*>(ref_p)[off]
                                : grid_code(static_cast<float*>(ref_p)[off]);
          const int diff = cur - ref;
          if (abs(diff) > (is_x ? tx : th)) {
            d = diff;
            if (codes) {
              static_cast<int32_t*>(ref_p)[off] = ref + diff;
            } else {
              float* rf = static_cast<float*>(ref_p) + off;
              *rf = __fadd_rn(*rf, __fmul_rn(static_cast<float>(diff), Q68_LSB));
            }
          }
        }
        (is_x ? dx_s : dh_s)[s * H + i] = d;
      }
      __syncthreads();
      // (5-6) fired-column lists (warp 0: input, warp 1: state) and the
      // skipped / total counters (one thread per stream)
      const int warp = tid / 32;
      const int lane = tid % 32;
      if (warp < 2) {
        const int32_t* d_s = warp == 0 ? dx_s : dh_s;
        const int ncols = warp == 0 ? in_dim : H;
        int32_t* list = list_s + warp * H;
        int count = 0;
        for (int c0 = 0; c0 < ncols; c0 += 32) {
          const int col = c0 + lane;
          bool fired = false;
          if (col < ncols) {
            for (int s = 0; s < SB; ++s) fired |= d_s[s * H + col] != 0;
          }
          const unsigned ballot = __ballot_sync(0xffffffffu, fired);
          if (fired) list[count + __popc(ballot & ((1u << lane) - 1u))] = col;
          count += __popc(ballot);
        }
        if (lane == 0) nlist_s[warp] = count;
      } else if (tid >= 64 && tid < 64 + SB) {
        const int s = tid - 64;
        if (wake_s[s]) {
          int fired = 0;
          for (int i = 0; i < in_dim; ++i) fired += dx_s[s * H + i] != 0;
          for (int u = 0; u < H; ++u) fired += dh_s[s * H + u] != 0;
          const int64_t stream = base + s;
          a.g.skipped[layer][stream] += cols - fired;
          a.g.total[layer][stream] += cols;
        }
      }
      __syncthreads();
      // (7-8) rank-1 terms into the accumulators, then acc + b
      const int nx = nlist_s[0];
      const int nh = nlist_s[1];
      for (int item = tid; item < SB * G; item += THREADS) {
        const int s = item / G;
        const int j = item % G;
        if (!wake_s[s]) continue;
        const int64_t off = static_cast<int64_t>(base + s) * G + j;
        int32_t* g = gate_s + s * 2 * G;
        if (codes) {
          int32_t* ax = static_cast<int32_t*>(a.g.acc_x[layer]) + off;
          int32_t* ah = static_cast<int32_t*>(a.g.acc_h[layer]) + off;
          const int32_t nax = wrap_add(*ax, sparse_dot_int(dx_s + s * H, list_s, nx, wi, j));
          const int32_t nah = wrap_add(*ah, sparse_dot_int(dh_s + s * H, list_s + H, nh, wh, j));
          *ax = nax;
          *ah = nah;
          g[j] = clip_act(round_shift_even(wrap_add(nax, bi[j]), 7));
          g[G + j] = clip_act(round_shift_even(wrap_add(nah, bh[j]), 7));
        } else {
          float* ax = static_cast<float*>(a.g.acc_x[layer]) + off;
          float* ah = static_cast<float*>(a.g.acc_h[layer]) + off;
          const float nax = __fadd_rn(*ax, sparse_dot_float(dx_s + s * H, list_s, nx, wi, j));
          const float nah = __fadd_rn(*ah, sparse_dot_float(dh_s + s * H, list_s + H, nh, wh, j));
          *ax = nax;
          *ah = nah;
          g[j] = q68_code(__fadd_rn(nax, __fmul_rn(static_cast<float>(bi[j]), ACC_LSB)));
          g[G + j] = q68_code(__fadd_rn(nah, __fmul_rn(static_cast<float>(bh[j]), ACC_LSB)));
        }
      }
    } else {
      // 2 products x 4 stream tiles x 36 column tiles over 256 threads: the
      // state product first (in layer 1 the deeper one), so the 32 tiles of
      // the second round are input tiles; a tile with no woken stream idles
      for (int t = tid; t < 2 * TILES_PER_PRODUCT; t += THREADS) {
        const bool hp = t < TILES_PER_PRODUCT;
        const int rem = hp ? t : t - TILES_PER_PRODUCT;
        const int s0 = 4 * (rem / (G / 4));
        const int c0 = 4 * (rem % (G / 4));
        if (!(wake_s[s0] | wake_s[s0 + 1] | wake_s[s0 + 2] | wake_s[s0 + 3])) continue;
        int32_t out[4][4];
        dense_tile<4>(a, bk, (hp ? h_s : x_s) + s0 * H, hp ? H : in_dim, w_s, b_s,
                   (hp ? w_h_off : w_i_off) + c0, (hp ? b_h_off : b_i_off) + c0, G,
                   hp || layer > 0, out);
        int32_t* g = gate_s + s0 * 2 * G + (hp ? G : 0) + c0;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          *reinterpret_cast<int4*>(g + s * 2 * G) =
              make_int4(out[s][0], out[s][1], out[s][2], out[s][3]);
        }
      }
    }
    __syncthreads();
    for (int item = tid; item < SB * H; item += THREADS) {
      const int s = item / H;
      const int u = item % H;
      if (!wake_s[s]) continue;
      const int32_t* gi = gate_s + s * 2 * G;
      const int32_t* gh = gi + G;
      int32_t* hp = h_s + s * H + u;
      if (flt) {
        const float r = sigmoid_f(__fadd_rn(__int_as_float(gi[u]), __int_as_float(gh[u])));
        const float z =
            sigmoid_f(__fadd_rn(__int_as_float(gi[H + u]), __int_as_float(gh[H + u])));
        const float nn = tanhf(__fadd_rn(__int_as_float(gi[2 * H + u]),
                                         __fmul_rn(r, __int_as_float(gh[2 * H + u]))));
        const float h_new = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), nn),
                                      __fmul_rn(z, __int_as_float(*hp)));
        *hp = __float_as_int(h_new);
        continue;
      }
      const int r = a.sig_rom[rom_index(gi[u] + gh[u])];
      const int z = a.sig_rom[rom_index(gi[H + u] + gh[H + u])];
      const int rn = clip_act(round_shift_even(r * gh[2 * H + u], 8));
      const int nn = a.tanh_rom[rom_index(gi[2 * H + u] + rn)];
      const int h_old = codes ? *hp : grid_code(__int_as_float(*hp));
      const int h_new =
          clip_act(round_shift_even((256 - z) * nn + z * h_old, 8));
      *hp = codes ? h_new
                  : __float_as_int(__fmul_rn(static_cast<float>(h_new), Q68_LSB));
    }
    __syncthreads();
  }

  // ---- FC head: 16 streams x 3 class tiles of 1 x 4 (48 threads; the
  // head is 1/16 of the MACs, so its critical path, not its loads, counts) ----
  for (int t = tid; t < FC_TILES; t += THREADS) {
    const int s = t / (K / 4);
    const int c0 = 4 * (t % (K / 4));
    if (!wake_s[s]) continue;
    int32_t out[1][4];
    dense_tile<1>(a, bk, act_s + 2 * SB * H + s * H, H, w_s, b_s, W_FC + c0, B_FC + c0, K,
                  true, out);
    float l[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      l[c] = flt ? __int_as_float(out[0][c]) : __fmul_rn(static_cast<float>(out[0][c]), Q68_LSB);
    }
    *reinterpret_cast<float4*>(logit_s + s * K + c0) = make_float4(l[0], l[1], l[2], l[3]);
  }
  __syncthreads();

  // ---- masked state write-back ----
  for (int i = tid; i < 2 * SB * H; i += THREADS) {
    const int layer = i / (SB * H);
    const int s = (i / H) % SB;
    const int u = i % H;
    if (wake_s[s]) {
      static_cast<int32_t*>(a.g.h[layer])[static_cast<int64_t>(base + s) * H + u] =
          act_s[(1 + layer) * SB * H + s * H + u];
    }
  }

  // ---- tail: softmax, smoothing, argmax (one thread per stream) ----
  if (tid < SB && base + tid < a.n) {
    const int stream = base + tid;
    float* sc = a.scores + static_cast<int64_t>(stream) * K;
    if (wake_s[tid]) {
      const float* l = logit_s + tid * K;
      float m = l[0];
      for (int k = 1; k < K; ++k) m = fmaxf(m, l[k]);
      float e[K];
      for (int k = 0; k < K; ++k) e[k] = expf(__fsub_rn(l[k], m));
      float sum = e[0];
      for (int k = 1; k < K; ++k) sum = __fadd_rn(sum, e[k]);
      for (int k = 0; k < K; ++k) {
        sc[k] = __fadd_rn(__fmul_rn(a.smoothing, sc[k]),
                          __fmul_rn(a.one_minus, __fdiv_rn(e[k], sum)));
      }
    } else if (active_s[tid] && a.casc.decay_on) {  // submitted but gated
      for (int k = 0; k < K; ++k) sc[k] = __fmul_rn(a.casc.decay, sc[k]);
    }
    int best = 0;
    float best_v = sc[0];
    for (int k = 1; k < K; ++k) {
      if (sc[k] > best_v) {
        best_v = sc[k];
        best = k;
      }
    }
    a.top[stream] = best;
  }
}

}  // namespace

extern "C" int tick_fused_launch(
    const void* inp, const void* mask, int n, void* s1, void* s2,
    const void* gru, const void* hw, const void* casc, void* scores, void* top, void* fv_out, const void* w,
    const void* b, const void* wf, const void* bf, const void* theta,
    const void* coeffs, const void* mu, const void* sigma,
    const void* log_rom, const void* sig_rom, const void* tanh_rom,
    float q_max, float q_scale, float inv_frame, float smoothing,
    float one_minus, int raw, int backend, void* stream) {
  if (backend < BK_QAT || backend > BK_DELTA_INT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TickArgs a;
  a.inp = static_cast<const float*>(inp);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n = n;
  a.s1 = static_cast<float*>(s1);
  a.s2 = static_cast<float*>(s2);
  a.g = *static_cast<const GruState*>(gru);  // host structs, copied by value
  a.hw = *static_cast<const HwFrontend*>(hw);
  a.casc = *static_cast<const Cascade*>(casc);
  a.scores = static_cast<float*>(scores);
  a.top = static_cast<int64_t*>(top);
  a.fv_out = static_cast<float*>(fv_out);
  a.w = static_cast<const int8_t*>(w);
  a.b = static_cast<const int32_t*>(b);
  a.wf = static_cast<const float*>(wf);
  a.bf = static_cast<const float*>(bf);
  a.theta = static_cast<const int32_t*>(theta);
  a.coeffs = static_cast<const float*>(coeffs);
  a.mu = static_cast<const float*>(mu);
  a.sigma = static_cast<const float*>(sigma);
  a.log_rom = static_cast<const float*>(log_rom);
  a.sig_rom = static_cast<const int32_t*>(sig_rom);
  a.tanh_rom = static_cast<const int32_t*>(tanh_rom);
  a.q_max = q_max;
  a.q_scale = q_scale;
  a.inv_frame = inv_frame;
  a.smoothing = smoothing;
  a.one_minus = one_minus;
  a.raw = raw;
  a.backend = backend;
  const int smem =
      SMEM_BASE + ((backend == BK_DELTA || backend == BK_DELTA_INT) ? SMEM_DELTA : 0);
  const cudaError_t e = cudaFuncSetAttribute(
      tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BASE + SMEM_DELTA);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (n + SB - 1) / SB;
  tick_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tick_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
