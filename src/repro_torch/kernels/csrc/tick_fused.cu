// The whole 16 ms serving tick as one launch, for the qat and integer
// classifiers, on raw audio hops or FV_Norm frames (no cascade).
//
// Replaces src/repro/kernels/tick_fused/kernel.py:256 tick_fused_pallas
// (pallas_call at :368); the math is src/repro/kernels/tick_fused/ref.py:48
// tick_reference, whose PyTorch twin is repro_torch/kernels/tick_fused/ref.py.
//
// Bound: operations. Per stream and tick the frontend runs 512 dependent
// biquad steps for each of 16 channels (~6 k flops a channel) and the
// classifier ~47 k operations, against ~1.1 kB of input and state.
// Design: one block of 256 threads owns 16 streams.
//   * Frontend: one thread per (stream, channel) oversamples the hop
//     inline (edge-replicated, as _chunk_to_internal), runs the TDF-II
//     chain with its (s1, s2) carry in registers, and turns the rectified
//     frame mean into FV_Norm (12-bit quantizer, log ROM, normalizer,
//     Q6.8).
//   * Classifier: the int8 weight codes (23.6 kB) and int32 bias codes sit
//     in shared memory; threads stride over (stream, gate column) for the
//     gate accumulators, then over (stream, unit) for the gates, which are
//     Q6.8 ROM lookups with round-half-even rescales, layer by layer, and
//     over (stream, class) for the FC head.
//   * Tail: one thread per stream: softmax, smoothing, the masked state
//     advance and first-index argmax.
// Streams that did not submit are skipped and keep every state byte; the
// ragged last block is bounds-checked. State is updated in place (the
// counterpart of the reference's buffer donation).
//
// Rounding: the IIR uses __fmaf_rn exactly where the reference's compiled
// scan fuses (b0*x + s1, b1*x - a1*y, b2*x - a2*y); everything else is
// compiled with -fmad=false so it rounds as the plain version does. QAT
// accumulates the gate dot products in float32 on the exact
// code * 2^-7 weights; integer runs the shared int24 dot of intgemm.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

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

// Packed weight codes (int8) and bias codes (int32), layer by layer.
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
// h1, h2; float bits for qat, codes for integer), [SB][2][G] gate codes,
// [SB][K] logits, [SB] active flags.
constexpr int SMEM_BYTES = W_TOTAL + 4 * B_TOTAL + 4 * 3 * SB * H +
                           4 * SB * 2 * G + 4 * SB * K + 4 * SB;

struct TickArgs {
  const float* inp;
  const uint8_t* mask;
  int n;
  float* s1;
  float* s2;
  int32_t* h[2];
  float* scores;
  int64_t* top;
  float* fv_out;
  const int8_t* w;
  const int32_t* b;
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
  int integer;
};

__device__ __forceinline__ int clip_act(int v) {
  return min(max(v, ACT_MIN), ACT_MAX);
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

__device__ __forceinline__ int rom_index(int code_sum) {
  return min(max(code_sum - LUT_MIN, 0), LUT_SIZE - 1);
}

__device__ __forceinline__ void biquad_step(float x, float b0, float b1,
                                            float b2, float a1, float a2,
                                            float& s1, float& s2,
                                            float& acc) {
  const float y = __fmaf_rn(b0, x, s1);
  const float s1n = __fadd_rn(__fmaf_rn(b1, x, -__fmul_rn(a1, y)), s2);
  s2 = __fmaf_rn(b2, x, -__fmul_rn(a2, y));
  s1 = s1n;
  acc = __fadd_rn(acc, fabsf(y));
}

// One gate / logit accumulator as a Q6.8 code: x (in_dim) . w[:, col] + b.
__device__ __forceinline__ int accum(const int32_t* x, int in_dim,
                                     const int8_t* w, int ldw,
                                     const int32_t* b, int col,
                                     bool integer) {
  if (integer) {
    return clip_act(
        round_shift_even(intgemm_dot(x, w, in_dim, ldw, col) + b[col], 7));
  }
  const float* xf = reinterpret_cast<const float*>(x);
  float acc = 0.0f;
  for (int k = 0; k < in_dim; ++k) {
    const float wk = __fmul_rn(static_cast<float>(w[k * ldw + col]), 0.0078125f);
    acc = __fadd_rn(acc, __fmul_rn(xf[k], wk));
  }
  acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(b[col]), 3.0517578125e-05f));
  return q68_code(acc);
}

__global__ void __launch_bounds__(THREADS) tick_kernel(TickArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);
  int32_t* b_s = reinterpret_cast<int32_t*>(smem + W_TOTAL);
  int32_t* act_s = b_s + B_TOTAL;          // [3][SB][H]
  int32_t* gate_s = act_s + 3 * SB * H;    // [SB][2][G]
  float* logit_s = reinterpret_cast<float*>(gate_s + SB * 2 * G);  // [SB][K]
  int* active_s = reinterpret_cast<int*>(logit_s + SB * K);        // [SB]

  const int tid = threadIdx.x;
  const int base = blockIdx.x * SB;
  const bool integer = a.integer != 0;

  // ---- stage weights, biases, flags and hidden state ----
  const int4* w_src = reinterpret_cast<const int4*>(a.w);
  int4* w_dst = reinterpret_cast<int4*>(w_s);
  for (int i = tid; i < W_TOTAL / 16; i += THREADS) w_dst[i] = w_src[i];
  for (int i = tid; i < B_TOTAL; i += THREADS) b_s[i] = a.b[i];
  if (tid < SB) {
    const int stream = base + tid;
    active_s[tid] = (stream < a.n && a.mask[stream]) ? 1 : 0;
  }
  for (int i = tid; i < 2 * SB * H; i += THREADS) {
    const int layer = i / (SB * H);
    const int s = (i / H) % SB;
    const int u = i % H;
    const int stream = base + s;
    if (stream < a.n) {
      act_s[(1 + layer) * SB * H + s * H + u] =
          a.h[layer][static_cast<int64_t>(stream) * H + u];
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
        const float b0 = a.coeffs[0 * C + c], b1 = a.coeffs[1 * C + c],
                    b2 = a.coeffs[2 * C + c], a1 = a.coeffs[3 * C + c],
                    a2 = a.coeffs[4 * C + c];
        float s1 = a.s1[sc], s2 = a.s2[sc], acc = 0.0f;
        const float* hop = a.inp + static_cast<int64_t>(stream) * HOP;
        float cur = hop[0];
        for (int i = 0; i < HOP; ++i) {
          const float nxt = (i + 1 < HOP) ? hop[i + 1] : cur;
          const float mid = __fmul_rn(__fadd_rn(cur, nxt), 0.5f);
          biquad_step(cur, b0, b1, b2, a1, a2, s1, s2, acc);
          biquad_step(mid, b0, b1, b2, a1, a2, s1, s2, acc);
          cur = nxt;
        }
        a.s1[sc] = s1;
        a.s2[sc] = s2;
        const float frame = __fmul_rn(acc, a.inv_frame);
        const float raw_code =
            rintf(__fmul_rn(fminf(fmaxf(frame, 0.0f), a.q_max), a.q_scale));
        const int idx = min(max(static_cast<int>(raw_code), 0), LOG_SIZE - 1);
        const float norm =
            __fdiv_rn(__fsub_rn(a.log_rom[idx], a.mu[c]), a.sigma[c]);
        fv = __fmul_rn(static_cast<float>(q68_code(norm)), 0.00390625f);
      } else {
        fv = a.inp[sc];
      }
      if (a.fv_out != nullptr) a.fv_out[sc] = fv;
      if (integer) {
        act_s[s * H + c] = q68_code(fv);
      } else {
        reinterpret_cast<float*>(act_s)[s * H + c] = fv;
      }
    }
  }
  __syncthreads();

  // ---- classifier: two GRU layers ----
  for (int layer = 0; layer < 2; ++layer) {
    const int in_dim = layer == 0 ? C : H;
    const int32_t* x_s = act_s + layer * SB * H;  // input frame, then new h1
    int32_t* h_s = act_s + (layer + 1) * SB * H;
    const int8_t* wi = w_s + (layer == 0 ? W_L1I : W_L2I);
    const int8_t* wh = w_s + (layer == 0 ? W_L1H : W_L2H);
    const int32_t* bi = b_s + (layer == 0 ? B_L1I : B_L2I);
    const int32_t* bh = b_s + (layer == 0 ? B_L1H : B_L2H);
    for (int item = tid; item < SB * G; item += THREADS) {
      const int s = item / G;
      const int j = item % G;
      if (!active_s[s]) continue;
      int32_t* g = gate_s + s * 2 * G;
      g[j] = accum(x_s + s * H, in_dim, wi, G, bi, j, integer);
      g[G + j] = accum(h_s + s * H, H, wh, G, bh, j, integer);
    }
    __syncthreads();
    for (int item = tid; item < SB * H; item += THREADS) {
      const int s = item / H;
      const int u = item % H;
      if (!active_s[s]) continue;
      const int32_t* gi = gate_s + s * 2 * G;
      const int32_t* gh = gi + G;
      const int r = a.sig_rom[rom_index(gi[u] + gh[u])];
      const int z = a.sig_rom[rom_index(gi[H + u] + gh[H + u])];
      const int rn = clip_act(round_shift_even(r * gh[2 * H + u], 8));
      const int nn = a.tanh_rom[rom_index(gi[2 * H + u] + rn)];
      int32_t* hp = h_s + s * H + u;
      const int h_old =
          integer ? *hp : __float2int_rn(__fmul_rn(__int_as_float(*hp), 256.0f));
      const int h_new =
          clip_act(round_shift_even((256 - z) * nn + z * h_old, 8));
      *hp = integer ? h_new
                    : __float_as_int(
                          __fmul_rn(static_cast<float>(h_new), 0.00390625f));
    }
    __syncthreads();
  }

  // ---- FC head ----
  for (int item = tid; item < SB * K; item += THREADS) {
    const int s = item / K;
    const int k = item % K;
    if (!active_s[s]) continue;
    const int code = accum(act_s + 2 * SB * H + s * H, H, w_s + W_FC, K,
                           b_s + B_FC, k, integer);
    logit_s[s * K + k] = __fmul_rn(static_cast<float>(code), 0.00390625f);
  }
  __syncthreads();

  // ---- masked state write-back ----
  for (int i = tid; i < 2 * SB * H; i += THREADS) {
    const int layer = i / (SB * H);
    const int s = (i / H) % SB;
    const int u = i % H;
    if (active_s[s]) {
      a.h[layer][static_cast<int64_t>(base + s) * H + u] =
          act_s[(1 + layer) * SB * H + s * H + u];
    }
  }

  // ---- tail: softmax, smoothing, argmax (one thread per stream) ----
  if (tid < SB && base + tid < a.n) {
    const int stream = base + tid;
    float* sc = a.scores + static_cast<int64_t>(stream) * K;
    if (active_s[tid]) {
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
    void* h1, void* h2, void* scores, void* top, void* fv_out, const void* w,
    const void* b, const void* coeffs, const void* mu, const void* sigma,
    const void* log_rom, const void* sig_rom, const void* tanh_rom,
    float q_max, float q_scale, float inv_frame, float smoothing,
    float one_minus, int raw, int integer, void* stream) {
  TickArgs a;
  a.inp = static_cast<const float*>(inp);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n = n;
  a.s1 = static_cast<float*>(s1);
  a.s2 = static_cast<float*>(s2);
  a.h[0] = static_cast<int32_t*>(h1);
  a.h[1] = static_cast<int32_t*>(h2);
  a.scores = static_cast<float*>(scores);
  a.top = static_cast<int64_t*>(top);
  a.fv_out = static_cast<float*>(fv_out);
  a.w = static_cast<const int8_t*>(w);
  a.b = static_cast<const int32_t*>(b);
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
  a.integer = integer;
  const cudaError_t e = cudaFuncSetAttribute(
      tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (n + SB - 1) / SB;
  tick_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tick_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
