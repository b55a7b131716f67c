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
// input and state); bytes for the ΔGRU backends, whose state is ~3.3 kB a
// stream read each tick (and written where it changed).
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
//   * ΔGRU (K4; its own kernel instantiation, `tick_delta_kernel`, so
//     its registers do not weigh on the dense backends' code): its state
//     (x_ref, h_ref, acc_x, acc_h of both layers, 2 944 B a stream,
//     47 104 B a block) and the skipped / total counters are read once a
//     tick, so the block issues them at the top as eight bulk copies on
//     one mbarrier (cp.async words where the wrapper's `delta_staging`
//     found a base off 16 bytes, and for the counters) and they land
//     while the weights stage and the frontend runs; behind a cascade
//     only after the gate, and only for a block where a stream woke (a
//     block that wakes none has no ΔGRU work). Per layer: threads over (stream, column) form the thresholded
//     deltas against the staged memories (|Δ| > θ on the Q6.8 grid),
//     advance a memory in device memory only where it fires, store the
//     deltas column-major ([column][stream], so 4 streams are one 16-byte
//     load) and ballot each stream's 32-column fire masks; warp 0 takes the
//     skipped / total counters from their popcounts and ORs them into the
//     block-union masks. Then the rank-1 terms run on the dense phase's
//     4 streams x 4 gate columns register tiles: per fired column
//     (ascending, walked with __ffsll) one 16-byte load of deltas and one
//     32-bit load of int8 weights feed 16 multiply-adds. Each accumulator
//     sums from 0 and is added once to its staged state (the contribution
//     clipped to int24 once in the code domain, as intgemm clips); the
//     gate preactivation is acc + bias; an accumulator row is written back
//     only where its stream fired a column of its product.
//   * Cascade (the reference's gated branch, ref.py:89-112): after the
//     frontend, one thread per stream scores the block's 16 FV_Norm values
//     ("energy": relu summed left to right, times 1/16; "linear": a chain
//     of fused multiply-adds from 0, + b, then XLA's CPU sigmoid with its
//     Cephes exp, flushed below the smallest normal), advances the
//     detector state {awake, hang, woken, ticks} of a submitting stream
//     and sets the stream's wake flag (submitted and gated open). The
//     classifier, K4's fire masks, the state write-back and the
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

#include "async_copy.cuh"
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
// flags. The ΔGRU branch (K4) adds its staged state (below), the input and
// state deltas column-major, [H][SBP] each (float bits d * 2^-8 for delta,
// codes for delta-int), [SB][3] fire-mask words, [2][SB] row-fired flags,
// the [2] block-union fire masks, the staging barrier and the staged
// skipped / total counters, [2 layers][2][SB].
constexpr int SMEM_BASE = W_TOTAL + 4 * B_TOTAL + 4 * 3 * SB * H +
                          4 * SB * 2 * G + 4 * SB * K + 4 * SB * C + 4 * 2 * SB;
// A delta column's SB streams padded to SBP words: the threshold pass
// writes a warp's 32 consecutive columns of one stream, which at a row of
// 16 words would hit 2 banks; at 20 it hits 8 (and a row stays whole
// 16-byte vectors for the tiles' loads).
constexpr int SBP = SB + 4;
constexpr int MASK_WORDS = 3;  // 32-column words of a stream's [x | h] fire mask (<= 96 columns)
// The staged ΔGRU state, per layer: x_ref [SB][in], h_ref [SB][H], acc_x
// [SB][G], acc_h [SB][G]; array k of layer l is staged array 4 l + k.
constexpr int ST_L0 = SB * C + SB * H + 2 * SB * G;
constexpr int ST_WORDS = ST_L0 + 2 * SB * H + 2 * SB * G;
constexpr int SMEM_DELTA = 4 * ST_WORDS + 4 * 2 * H * SBP + 4 * SB * MASK_WORDS + 4 * 2 * SB +
                           8 * 2 + 8 + 4 * 4 * SB;
static_assert(SMEM_BASE % 16 == 0 && (4 * ST_WORDS) % 16 == 0 && (4 * SBP) % 16 == 0,
              "bulk copies and 16-byte vectors land on 16-byte boundaries");
static_assert(C + H == 64 && 2 * H == 96 && C <= 32, "a stream's fire mask: 2 or 3 words");

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
  int delta_bulk;        // bit 4 l + k: staged array k of layer l by bulk copy, else by words
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

// K4's staged state: offset (words) and row length of staged array k
// (x_ref, h_ref, acc_x, acc_h) of layer l, in the order of struct GruState.
__device__ __forceinline__ int st_offset(int l, int k) {
  const int in_dim = l == 0 ? C : H;
  const int off[4] = {0, SB * in_dim, SB * (in_dim + H), SB * (in_dim + H + G)};
  return (l == 0 ? 0 : ST_L0) + off[k];
}

__device__ __forceinline__ int st_row(int l, int k) {
  return k == 0 ? (l == 0 ? C : H) : k == 1 ? H : G;
}

__device__ __forceinline__ void* st_source(const GruState& g, int l, int k) {
  return k == 0 ? g.x_ref[l] : k == 1 ? g.h_ref[l] : k == 2 ? g.acc_x[l] : g.acc_h[l];
}

// K4's rank-1 terms on a register tile of 4 streams x 4 gate columns: for
// each fired column i of the block-union mask, in ascending order, one
// 16-byte load of the 4 streams' deltas (column-major dT) and one 32-bit
// load of the 4 columns' int8 weights feed 16 multiply-adds. Every
// accumulator sums its terms from 0 in ascending column order, as the
// plain version (gather.py) does. A stream that did not fire column i adds
// a zero term there, as in the plain version: in the float domain the
// term is +-0.0, and a sum started at +0.0 is never -0.0 (round to nearest
// gives -0.0 only for -0.0 + -0.0), so adding it leaves the sum unchanged.
// Float domain (delta): d * 2^-8 times code * 2^-7 is exact in float32
// (|d| < 2^14, |code| <= 2^7), so the fused multiply-add rounds as
// multiply-then-add does.
// The next fired column's operands are loaded before the current
// column's 16 multiply-adds, so their shared-memory latency hides behind
// them.
__device__ __forceinline__ void delta_terms_float(uint64_t m, const int32_t* dT, const int8_t* w,
                                                  float acc[4][4]) {
  if (!m) return;
  int i = __ffsll(static_cast<long long>(m)) - 1;
  m &= m - 1;
  float4 dv = *reinterpret_cast<const float4*>(dT + i * SBP);
  uint32_t wv = *reinterpret_cast<const uint32_t*>(w + i * G);
  for (;;) {
    const bool more = m != 0;
    float4 dn = dv;
    uint32_t wn = wv;
    if (more) {
      i = __ffsll(static_cast<long long>(m)) - 1;
      m &= m - 1;
      dn = *reinterpret_cast<const float4*>(dT + i * SBP);
      wn = *reinterpret_cast<const uint32_t*>(w + i * G);
    }
    const uint32_t biased = wv ^ 0x80808080u;
    const float wk[4] = {w_lsb<0>(biased), w_lsb<1>(biased), w_lsb<2>(biased), w_lsb<3>(biased)};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float ds = float4_lane(dv, s);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[s][c] = __fmaf_rn(ds, wk[c], acc[s][c]);
    }
    if (!more) break;
    dv = dn;
    wv = wn;
  }
}

// Code domain (delta-int): exact int32 sums (products < 2^21, at most 48
// terms), clipped once to int24 by the caller.
__device__ __forceinline__ void delta_terms_int(uint64_t m, const int32_t* dT, const int8_t* w,
                                                int32_t acc[4][4]) {
  if (!m) return;
  int i = __ffsll(static_cast<long long>(m)) - 1;
  m &= m - 1;
  int4 dv = *reinterpret_cast<const int4*>(dT + i * SBP);
  uint32_t wv = *reinterpret_cast<const uint32_t*>(w + i * G);
  for (;;) {
    const bool more = m != 0;
    int4 dn = dv;
    uint32_t wn = wv;
    if (more) {
      i = __ffsll(static_cast<long long>(m)) - 1;
      m &= m - 1;
      dn = *reinterpret_cast<const int4*>(dT + i * SBP);
      wn = *reinterpret_cast<const uint32_t*>(w + i * G);
    }
    const int32_t wc[4] = {int8_lane<0>(wv), int8_lane<1>(wv), int8_lane<2>(wv),
                           int8_lane<3>(wv)};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int32_t ds = int4_lane(dv, s);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[s][c] += ds * wc[c];
    }
    if (!more) break;
    dv = dn;
    wv = wn;
  }
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

// The tick's body, compiled twice: without the ΔGRU branch for the dense
// backends (qat, integer, float) and with it for delta / delta-int, so the
// ΔGRU's register tiles and staging add no register pressure to the dense
// backends' code.
template <bool DELTA>
__device__ __forceinline__ void tick_body(const TickArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);
  int32_t* b_s = reinterpret_cast<int32_t*>(smem + W_TOTAL);
  int32_t* act_s = b_s + B_TOTAL;          // [3][SB][H]
  int32_t* gate_s = act_s + 3 * SB * H;    // [SB][2][G]
  float* logit_s = reinterpret_cast<float*>(gate_s + SB * 2 * G);  // [SB][K]
  float* fv_s = logit_s + SB * K;                                  // [SB][C]
  int* active_s = reinterpret_cast<int*>(fv_s + SB * C);           // [SB] submitted
  int* wake_s = active_s + SB;             // [SB] submitted and woken
  // ΔGRU only (K4), from SMEM_BASE:
  int32_t* st_s = reinterpret_cast<int32_t*>(smem + SMEM_BASE);  // staged state
  int32_t* dx_s = st_s + ST_WORDS;         // [H][SBP] input deltas (columns < in_dim)
  int32_t* dh_s = dx_s + H * SBP;          // [H][SBP] state deltas
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(dh_s + H * SBP);  // [SB][MASK_WORDS]
  int* rowf_s = reinterpret_cast<int*>(mask_s + SB * MASK_WORDS);  // [2][SB] x, h fired
  uint64_t* fire_s = reinterpret_cast<uint64_t*>(rowf_s + 2 * SB);  // [2] block-union masks
  uint64_t* bar = fire_s + 2;              // the staging barrier
  int32_t* cnt_s = reinterpret_cast<int32_t*>(bar + 1);  // [2][2][SB] skipped, total

  const int tid = threadIdx.x;
  const int base = blockIdx.x * SB;
  const int bk = a.backend;
  const bool codes = bk == BK_INTEGER || bk == BK_DELTA_INT;
  const bool flt = bk == BK_FLOAT;
  constexpr bool delta = DELTA;

  // ---- K4: stage the block's ΔGRU state (x_ref, h_ref, acc_x, acc_h of
  // both layers, 2 944 B a stream, and the skipped / total counters):
  // one bulk copy an array (its SB rows are one contiguous run of whole
  // 16-byte words), or cp.async words where the wrapper found its base
  // not 16-byte aligned (and for the counters); all complete on one
  // barrier (one expect-tx arrival and every thread's cp.async arrival).
  // Without a cascade it is issued here, to land while the weights stage
  // and the frontend runs; behind a cascade only after the gate, and only
  // where a stream of the block woke (a block that wakes none has no ΔGRU
  // work: every delta is zero and no counter advances). ----
  auto stage_delta = [&]() {
    const int rows = min(SB, a.n - base);
    if (tid == 0) {
      unsigned bytes = 0;
      for (int k = 0; k < 8; ++k) {
        if ((a.delta_bulk >> k) & 1) bytes += rows * st_row(k / 4, k % 4) * 4;
      }
      mbar_arrive_tx(bar, bytes);
      for (int k = 0; k < 8; ++k) {
        if (!((a.delta_bulk >> k) & 1)) continue;
        const int row = st_row(k / 4, k % 4);
        bulk_copy(st_s + st_offset(k / 4, k % 4),
                  static_cast<const int32_t*>(st_source(a.g, k / 4, k % 4)) +
                      static_cast<int64_t>(base) * row,
                  rows * row * 4, bar);
      }
    }
    for (int k = 0; k < 8; ++k) {
      if ((a.delta_bulk >> k) & 1) continue;
      const int row = st_row(k / 4, k % 4);
      float* dst = reinterpret_cast<float*>(st_s + st_offset(k / 4, k % 4));
      const float* src = static_cast<const float*>(st_source(a.g, k / 4, k % 4)) +
                         static_cast<int64_t>(base) * row;
      for (int e = tid; e < rows * row; e += THREADS) cp_async4(dst + e, src + e);
    }
    if (tid < 4 * SB && tid % SB < rows) {  // skipped[0], total[0], skipped[1], total[1]
      const int k = tid / SB;
      const int32_t* src = (k % 2 == 0 ? a.g.skipped : a.g.total)[k / 2];
      cp_async4(reinterpret_cast<float*>(cnt_s + tid),
                reinterpret_cast<const float*>(src + base + tid % SB));
    }
    cp_async_mbar_arrive(bar);
  };
  if (delta) {
    if (tid == 0) {
      mbar_init(bar, THREADS + 1);
      mbar_fence_init();
    }
    __syncthreads();
    if (!a.casc.on) stage_delta();
  }

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
  // the ΔGRU's state is staged (block-uniform): always without a cascade
  bool staged = true;
  if (delta && a.casc.on) {
    staged = __syncthreads_or(tid < SB && wake_s[tid]);
    if (staged) stage_delta();
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
    if (delta) {
      if (!staged) continue;  // no stream of the block woke: nothing to update
      // (1) thresholded deltas, one thread a (stream, column) over the
      // [x | h] columns of a stream (a warp: 32 consecutive columns of one
      // stream), from the staged memories; a memory that fires advances in
      // device memory (only there: it is not read again this tick); each
      // warp's fire mask by ballot
      if (layer == 0) mbar_wait(bar, 0);
      const int cols = in_dim + H;
      const int tx = a.theta[2 * layer];
      const int th = a.theta[2 * layer + 1];
      const int32_t* xr_s = st_s + st_offset(layer, 0);
      const int32_t* hr_s = st_s + st_offset(layer, 1);
      for (int item = tid; item < SB * cols; item += THREADS) {  // whole warps: cols % 32 == 0
        const int s = item / cols;
        const int col = item % cols;
        const bool is_x = col < in_dim;
        const int i = is_x ? col : col - in_dim;
        int d = 0;
        if (wake_s[s]) {
          const int32_t cur_bits = (is_x ? x_s : h_s)[s * H + i];
          const int32_t ref_bits = is_x ? xr_s[s * in_dim + i] : hr_s[s * H + i];
          const int cur = codes ? cur_bits : grid_code(__int_as_float(cur_bits));
          const int ref = codes ? ref_bits : grid_code(__int_as_float(ref_bits));
          const int diff = cur - ref;
          if (abs(diff) > (is_x ? tx : th)) {
            d = diff;
            const int64_t off = static_cast<int64_t>(base + s) * (is_x ? in_dim : H) + i;
            void* ref_p = is_x ? a.g.x_ref[layer] : a.g.h_ref[layer];
            if (codes) {
              static_cast<int32_t*>(ref_p)[off] = ref + diff;
            } else {
              static_cast<float*>(ref_p)[off] =
                  __fadd_rn(__int_as_float(ref_bits), __fmul_rn(static_cast<float>(diff), Q68_LSB));
            }
          }
        }
        (is_x ? dx_s : dh_s)[i * SBP + s] =
            codes ? d : __float_as_int(__fmul_rn(static_cast<float>(d), Q68_LSB));
        const unsigned fired = __ballot_sync(0xffffffffu, d != 0);
        if ((tid & 31) == 0) mask_s[s * MASK_WORDS + col / 32] = fired;
      }
      __syncthreads();
      // (2) warp 0: a stream's input and state fire masks from its words,
      // the skipped / total counters from their popcounts, the row-fired
      // flags, and the block-union masks (OR over the streams)
      if (tid < 32) {
        uint64_t fx = 0, fh = 0;
        if (tid < SB) {
          const uint32_t* mw = mask_s + tid * MASK_WORDS;
          const uint64_t lo = mw[0] | (static_cast<uint64_t>(mw[1]) << 32);
          if (layer == 0) {  // [16 x | 48 h]
            fx = lo & ((1ull << C) - 1);
            fh = lo >> C;
          } else {           // [48 x | 48 h]
            fx = lo & ((1ull << H) - 1);
            fh = (lo >> H) | (static_cast<uint64_t>(mw[2]) << (64 - H));
          }
          if (wake_s[tid]) {  // from the staged counters: stores only
            const int64_t stream = base + tid;
            a.g.skipped[layer][stream] =
                wrap_add(cnt_s[2 * layer * SB + tid], cols - __popcll(fx) - __popcll(fh));
            a.g.total[layer][stream] = wrap_add(cnt_s[(2 * layer + 1) * SB + tid], cols);
          }
          rowf_s[tid] = fx != 0;
          rowf_s[SB + tid] = fh != 0;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          fx |= __shfl_xor_sync(0xffffffffu, fx, o);
          fh |= __shfl_xor_sync(0xffffffffu, fh, o);
        }
        if (tid == 0) {
          fire_s[0] = fx;
          fire_s[1] = fh;
        }
      }
      __syncthreads();
      // (3) rank-1 terms on 4 x 4 register tiles (the dense phase's tile
      // layout: state product first), summed from 0, added once to the
      // staged accumulator, then acc + b. An accumulator row goes back to
      // device memory only where its stream fired a column of its product:
      // elsewhere every term was zero and the row is unchanged.
      for (int t = tid; t < 2 * TILES_PER_PRODUCT; t += THREADS) {
        const bool hp = t < TILES_PER_PRODUCT;
        const int rem = hp ? t : t - TILES_PER_PRODUCT;
        const int s0 = 4 * (rem / (G / 4));
        const int c0 = 4 * (rem % (G / 4));
        if (!(wake_s[s0] | wake_s[s0 + 1] | wake_s[s0 + 2] | wake_s[s0 + 3])) continue;
        const uint64_t m = fire_s[hp ? 1 : 0];
        const int32_t* dT = (hp ? dh_s : dx_s) + s0;
        const int8_t* w = w_s + (hp ? w_h_off : w_i_off) + c0;
        const int4 bias = *reinterpret_cast<const int4*>(b_s + (hp ? b_h_off : b_i_off) + c0);
        const int k = hp ? 3 : 2;
        const int32_t* acc_s = st_s + st_offset(layer, k) + s0 * G + c0;
        int32_t* acc_g = static_cast<int32_t*>(st_source(a.g, layer, k)) +
                         static_cast<int64_t>(base + s0) * G + c0;
        const bool vec = (a.delta_bulk >> (4 * layer + k)) & 1;  // 16-byte aligned rows
        int32_t* g = gate_s + s0 * 2 * G + (hp ? G : 0) + c0;
        // per stream: the new accumulators (written back where the stream
        // fired a column of this product) and the gate preactivations
        auto finish = [&](int s, const int32_t nacc[4], const int32_t gate[4]) {
          *reinterpret_cast<int4*>(g + s * 2 * G) = make_int4(gate[0], gate[1], gate[2], gate[3]);
          if (!rowf_s[(hp ? SB : 0) + s0 + s]) return;
          int32_t* dst = acc_g + static_cast<int64_t>(s) * G;
          if (vec) {
            *reinterpret_cast<int4*>(dst) = make_int4(nacc[0], nacc[1], nacc[2], nacc[3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) dst[c] = nacc[c];
          }
        };
        if (codes) {
          int32_t acc[4][4] = {};
          delta_terms_int(m, dT, w, acc);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            int32_t nacc[4], gate[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              nacc[c] = wrap_add(acc_s[s * G + c], intgemm_clip(acc[s][c]));
              gate[c] = clip_act(round_shift_even(wrap_add(nacc[c], int4_lane(bias, c)), 7));
            }
            finish(s, nacc, gate);
          }
        } else {
          float acc[4][4] = {};
          delta_terms_float(m, dT, w, acc);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            int32_t nacc[4], gate[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float v = __fadd_rn(__int_as_float(acc_s[s * G + c]), acc[s][c]);
              nacc[c] = __float_as_int(v);
              gate[c] = q68_code(__fadd_rn(
                  v, __fmul_rn(static_cast<float>(int4_lane(bias, c)), ACC_LSB)));
            }
            finish(s, nacc, gate);
          }
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

__global__ void __launch_bounds__(THREADS) tick_kernel(TickArgs a) { tick_body<false>(a); }

// 256 blocks of 4096 streams need 2 blocks an SM (132 SMs), and 2 blocks
// of the ΔGRU's 110 920 B of shared memory fit one: up to 128 registers a
// thread, which its tiles use without spilling.
__global__ void __launch_bounds__(THREADS, 2) tick_delta_kernel(TickArgs a) {
  tick_body<true>(a);
}

bool is_delta(int backend) { return backend == BK_DELTA || backend == BK_DELTA_INT; }

// Dynamic shared memory of a launch of ``backend``.
int smem_bytes(int backend) { return SMEM_BASE + (is_delta(backend) ? SMEM_DELTA : 0); }

// The backend's kernel, its dynamic shared memory limit raised once a
// device.
cudaError_t kernel_for(int backend, void (**kernel)(TickArgs)) {
  static bool raised[2][64] = {};
  const int k = is_delta(backend) ? 1 : 0;
  *kernel = k ? tick_delta_kernel : tick_kernel;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && raised[k][dev])) return e;
  e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(backend));
  if (e == cudaSuccess && dev < 64) raised[k][dev] = true;
  return e;
}

}  // namespace

extern "C" int tick_fused_launch(
    const void* inp, const void* mask, int n, void* s1, void* s2,
    const void* gru, const void* hw, const void* casc, void* scores, void* top, void* fv_out, const void* w,
    const void* b, const void* wf, const void* bf, const void* theta,
    const void* coeffs, const void* mu, const void* sigma,
    const void* log_rom, const void* sig_rom, const void* tanh_rom,
    float q_max, float q_scale, float inv_frame, float smoothing,
    float one_minus, int raw, int backend, int delta_bulk, void* stream) {
  if (backend < BK_QAT || backend > BK_DELTA_INT || delta_bulk < 0 || delta_bulk > 0xff) {
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
  a.delta_bulk = delta_bulk;
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
  void (*kernel)(TickArgs);
  const cudaError_t e = kernel_for(backend, &kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (n + SB - 1) / SB;
  kernel<<<grid, THREADS, smem_bytes(backend), static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch's dynamic shared memory and the blocks an SM can hold
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for ``backend``.
extern "C" int tick_fused_occupancy(int backend, int* smem, int* blocks) {
  if (backend < BK_QAT || backend > BK_DELTA_INT) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(TickArgs);
  cudaError_t e = kernel_for(backend, &kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *smem = smem_bytes(backend);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, *smem);
  return static_cast<int>(e);
}

extern "C" const char* tick_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
