// K1 and K5: per row of t feature tokens,
//   out = LN(x + W_out · attn(W_q x, W_k x, W_v x)) over the row's tokens,
// h heads of width d, affine-free LN (eps 1e-5). Keys at or past
// `token_valid` (<= t) get no weight, as the Pallas kernel's static key mask.
//
// K1, item-major x (b, t, s, e), a row per (member, sample): replaces
// multimodalpfn_tpu/ops/pallas_fused.py:_feat_attn_kernel_im (body
// _feat_attn_fwd_core :335; pallas_call in _attn_fwd_call_im, :472/:531).
// K5, sample-major x (m, t, e), rows flattened over every leading axis:
// replaces _feat_attn_kernel (pallas_call in _attn_fwd_call, :388/:454).
// One body serves both: a compile-time layout flag, SM (sample-major), says
// where token `tok` of a row lies. (Runtime strides cost K1's tensor-core
// body 11 % in an A/B; with the flag K1 keeps its item-major address arithmetic.)
//
// K6a and K6b are K1 and K5 with a per-member key mask, for members of
// different feature widths zero-padded into one group: K6a replaces
// _feat_attn_kernel_im_masked (pallas_fused.py:303, pallas_call :500), K6b
// _feat_attn_kernel_masked (:280, pallas_call :427). A second compile-time
// flag, MASKED, swaps the key test `j < token_valid` for bit j of the row's
// member's 64-bit mask word (t <= 64, so a row's keys fit one word): one
// word per member, K6a taking the member from the block, K6b from
// row / rows_per_member. K1's and K5's instantiations keep their code. The
// wrapper refuses a word without the target token's bit, so no softmax row is
// empty; the rows of padded tokens are computed and never read.
//
// What bounds it on the H100: arithmetic. A row at t = 31, e = h·d = 192
// costs 4.6 M FMAs (QKV and out projections; the t×t attention is 8% of it)
// against 2·t·e·sizeof(T) bytes of activations; the 590 KB (f32) of weights
// are re-read from L1/L2 by every block. Two kernels: float32 operands run on
// the CUDA cores (the parity mode needs full float32 products); bf16 operands
// at the published widths run on the tensor cores (feat_attn_ln_tc_kernel
// below). wgmma and TMA pipelining are later work.
//
// CUDA-core design: one block per row, reading the row's tokens straight from
// their layout (strided item-major for K1: no transpose through device
// memory). The t×e tile, the concatenated head outputs, one head's q/k/v and its t×t weights
// live in dynamic shared memory (64 KB at t = 31; opt-in above 48 KB). Per
// head: the projection assigns each thread two adjacent q/k/v columns and 8
// tokens (one 2-wide weight load feeds 16 FMAs; float4 reads of the token
// rows), a warp per query token does scores and softmax with shuffles, then
// P·V. q/k/v, the scaled q, the softmax weights and the head outputs are
// rounded to T where the Pallas kernel casts. The out-projection (two output
// columns per thread) accumulates in registers and writes the residual sum
// over the x tile; a warp per token then normalizes
// and stores. There are exactly t tokens, so no padded token can leak into a
// softmax (the Pallas kernel had to zero its sublane-padding tail); keys at
// or past token_valid score -inf, one compare.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int TT = 8;        // tokens per projection work item
constexpr int MAX_TOKENS = 64;

// Token `tok` of row `si` of member `bi` starts at element
// bi * t * s * e + tok * s * e + si * e of an item-major x (b, t, s, e), and at
// (si * t + tok) * e of a sample-major x (s, t, e) (b = 1).
template <bool SM>
__device__ __forceinline__ long long token_offset(int bi, int si, int tok, int t, int s, int e) {
  if constexpr (SM) return ((long long)si * t + tok) * e;
  return ((long long)bi * t + tok) * s * e + (long long)si * e;
}

// Whether key j takes part in the softmax: j < tv, or (MASKED) bit j of the
// row's mask word.
template <bool MASKED>
__device__ __forceinline__ bool key_valid(int j, int tv, unsigned long long word) {
  if constexpr (MASKED) return (word >> j) & 1ull;
  return j < tv;
}

// The mask word of row `si` of member `bi`: one per member, item-major (K6a)
// by the member index, sample-major (K6b) by rows_per_member consecutive rows.
template <bool SM>
__device__ __forceinline__ unsigned long long mask_word(const unsigned long long* masks, int bi,
                                                        int si, int rpm) {
  return masks[SM ? si / rpm : bi];
}

template <typename T, bool SM, bool MASKED>
__global__ void __launch_bounds__(THREADS)
feat_attn_ln_kernel(const T* __restrict__ x, const T* __restrict__ wqkv_t,
                    const T* __restrict__ wout, T* __restrict__ out, int t, int s, int e, int h,
                    int d, int tv, const unsigned long long* __restrict__ masks, int rpm,
                    float scale) {
  extern __shared__ float sm[];
  const int hd = h * d, dp = d + 1, ld = 3 * hd;
  float* xs = sm;           // [t][e]  x, then x + out-projection
  float* os = xs + t * e;   // [t][hd] head outputs
  float* qs = os + t * hd;  // [t][dp] (padded stride: conflict-free key reads)
  float* ks = qs + t * dp;
  float* vs = ks + t * dp;
  float* ps = vs + t * dp;  // [t][t] softmax weights
  const int si = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NWARPS = THREADS / 32;
  const long long tok_stride = SM ? e : (long long)s * e;
  const long long base = token_offset<SM>(bi, si, 0, t, s, e);  // token 0 of this row
  unsigned long long kmask = 0;
  if constexpr (MASKED) kmask = mask_word<SM>(masks, bi, si, rpm);

  for (int i = tid; i < t * e; i += THREADS) {
    const int tok = i / e, c = i - tok * e;
    xs[i] = to_f<T>(x[base + tok * tok_stride + c]);
  }
  __syncthreads();

  const int ntile = (t + TT - 1) / TT;
  for (int hh = 0; hh < h; ++hh) {
    const int npair = 3 * d / 2;  // d is even: a column pair never straddles q/k/v
    for (int item = tid; item < npair * ntile; item += THREADS) {
      const int col = 2 * (item % npair), tok0 = (item / npair) * TT;
      const int which = col / d, c = col - which * d;
      const T* w = wqkv_t + which * hd + hh * d + c;  // two columns of (e, 3hd)
      float acc[TT][2];
#pragma unroll
      for (int i = 0; i < TT; ++i) acc[i][0] = acc[i][1] = 0.f;
      for (int k = 0; k < e; k += 4) {
        float w0[2], w1[2], w2[2], w3[2];
        load2(w + (long long)k * ld, w0);
        load2(w + (long long)(k + 1) * ld, w1);
        load2(w + (long long)(k + 2) * ld, w2);
        load2(w + (long long)(k + 3) * ld, w3);
#pragma unroll
        for (int i = 0; i < TT; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + min(tok0 + i, t - 1) * e + k);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            acc[i][u] = fmaf(xv.x, w0[u], fmaf(xv.y, w1[u], fmaf(xv.z, w2[u], fmaf(xv.w, w3[u], acc[i][u]))));
        }
      }
      float* dst = which == 0 ? qs : (which == 1 ? ks : vs);
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const int tok = tok0 + i;
        if (tok < t) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float v = round_t<T>(acc[i][u]);
            if (which == 0) v = round_t<T>(v * scale);
            dst[tok * dp + c + u] = v;
          }
        }
      }
    }
    __syncthreads();

    for (int i = warp; i < t; i += NWARPS) {
      float sc[2], p[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        float a = -INFINITY;
        if (key_valid<MASKED>(j, tv, kmask)) {
          a = 0.f;
          for (int c = 0; c < d; ++c) a = fmaf(qs[i * dp + c], ks[j * dp + c], a);
        }
        sc[jj] = a;
      }
      const float mx = warp_max(fmaxf(sc[0], sc[1]));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) p[jj] = lane + 32 * jj < t ? expf(sc[jj] - mx) : 0.f;
      const float sum = warp_sum(p[0] + p[1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        if (j < t) ps[i * t + j] = round_t<T>(p[jj] / sum);
      }
    }
    __syncthreads();

    for (int item = tid; item < t * d; item += THREADS) {
      const int i = item / d, c = item - i * d;
      float a = 0.f;
      for (int j = 0; j < t; ++j) a = fmaf(ps[i * t + j], vs[j * dp + c], a);
      os[i * hd + hh * d + c] = round_t<T>(a);
    }
    __syncthreads();
  }

  const int epair = e / 2;
  for (int item = tid; item < epair * ntile; item += THREADS) {
    const int j = 2 * (item % epair), tok0 = (item / epair) * TT;
    float acc[TT][2];
#pragma unroll
    for (int i = 0; i < TT; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int m = 0; m < hd; m += 4) {
      float w0[2], w1[2], w2[2], w3[2];
      load2(wout + (long long)m * e + j, w0);
      load2(wout + (long long)(m + 1) * e + j, w1);
      load2(wout + (long long)(m + 2) * e + j, w2);
      load2(wout + (long long)(m + 3) * e + j, w3);
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const float4 ov =
            *reinterpret_cast<const float4*>(os + min(tok0 + i, t - 1) * hd + m);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          acc[i][u] = fmaf(ov.x, w0[u], fmaf(ov.y, w1[u], fmaf(ov.z, w2[u], fmaf(ov.w, w3[u], acc[i][u]))));
      }
    }
#pragma unroll
    for (int i = 0; i < TT; ++i)
      if (tok0 + i < t) {
        xs[(tok0 + i) * e + j] += acc[i][0];
        xs[(tok0 + i) * e + j + 1] += acc[i][1];
      }
  }
  __syncthreads();

  for (int tok = warp; tok < t; tok += NWARPS) {
    const float* u = xs + tok * e;
    float sum = 0.f;
    for (int j = lane; j < e; j += 32) sum += u[j];
    const float mean = warp_sum(sum) / e;
    float q = 0.f;
    for (int j = lane; j < e; j += 32) q += (u[j] - mean) * (u[j] - mean);
    const float rstd = 1.f / sqrtf(warp_sum(q) / e + 1e-5f);
    for (int j = lane; j < e; j += 32)
      out[base + tok * tok_stride + j] = from_f<T>((u[j] - mean) * rstd);
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------
// The same function for bf16 operands with h·d = e and the widths
// instantiated in `launch`, for every t the wrapper takes: a block holds
// TROWS = 128 token rows, TS = TROWS / TTOK rows (samples) of one member as TTOK = 32
// (t <= 32) or 64 (t <= 64) token rows each (rows past t zero), a warp per 16
// rows. Per head it stages
// that head's q/k/v columns of W_qkv^T in shared memory and projects all rows
// with mma.sync (bf16 in, float32 accumulated), rounding q, the scaled q, k
// and v to bf16 as the Pallas kernel does. Each warp's 16 rows lie in one
// sample: their scores against the sample's 32 token rows and P·V are mma
// products, and the softmax (keys >= token_valid masked) runs on the score fragments,
// each row in one quad of lanes; the normalized weights and the head outputs
// are rounded to bf16. The concatenated head outputs stay in shared memory
// for the out-projection, which streams W_out in chunks of OC rows; residual
// and LN run on the fragments. Rows padded by 8 elements so fragment reads
// hit distinct banks.
constexpr int TROWS = 128;              // token rows per block
constexpr int TTHREADS = 2 * TROWS;     // a warp per 16 rows
constexpr int OC = 64;                  // rows of W_out per chunk

template <int E, int D>
constexpr int tc_smem_elems() {
  constexpr int w = E * (3 * D + 8) > OC * (E + 8) ? E * (3 * D + 8) : OC * (E + 8);
  return 2 * TROWS * (E + 8) + w + 3 * TROWS * (D + 8);
}

template <int E, int D, int TTOK, bool SM, bool MASKED>
__global__ void __launch_bounds__(TTHREADS)
feat_attn_ln_tc_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wqkv_t,
                       const __nv_bfloat16* __restrict__ wout, __nv_bfloat16* __restrict__ out,
                       int t, int s, int tv, const unsigned long long* __restrict__ masks,
                       int rpm, float scale) {
  constexpr int TS = TROWS / TTOK;  // samples per block
  constexpr int H = E / D, XP = E + 8, WP = 3 * D + 8, QP = D + 8;
  constexpr int NW = E * WP > OC * XP ? E * WP : OC * XP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TROWS][XP]
  __nv_bfloat16* ws = xs + TROWS * XP;  // [E][WP] a head's q|k|v columns; later [OC][XP] of W_out
  __nv_bfloat16* qs = ws + NW;          // [TROWS][QP] each: q (scaled), k, v of one head
  __nv_bfloat16* ks = qs + TROWS * QP;
  __nv_bfloat16* vs = ks + TROWS * QP;
  __nv_bfloat16* os = vs + TROWS * QP;  // [TROWS][XP] head outputs, concatenated
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int wr = 16 * (tid >> 5);        // this warp's first row
  const int kr0 = wr / TTOK * TTOK;      // first token row of its sample
  const int s0 = blockIdx.x * TS;
  const long long tok_stride = SM ? E : (long long)s * E;
  const long long row_stride = SM ? (long long)t * E : E;
  const long long base = SM ? 0 : (long long)blockIdx.y * t * tok_stride;  // member, row 0, token 0
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // the mask word of this warp's sample (a ragged block's samples past s
  // take the last one's: their rows are never stored)
  unsigned long long kmask = 0;
  if constexpr (MASKED) kmask = mask_word<SM>(masks, blockIdx.y, min(s0 + wr / TTOK, s - 1), rpm);

  // tile row r is token r % TTOK of sample s0 + r / TTOK
  for (int i = tid; i < TROWS * E / 8; i += TTHREADS) {
    const int r = i / (E / 8), c = (i - r * (E / 8)) * 8;
    const int si = s0 + r / TTOK, tok = r % TTOK;
    *reinterpret_cast<uint4*>(xs + r * XP + c) =
        tok < t && si < s
            ? *reinterpret_cast<const uint4*>(x + base + tok * tok_stride + si * row_stride + c)
            : zero;
  }

  for (int hh = 0; hh < H; ++hh) {
    __syncthreads();  // the previous head's weights, q, k and v are consumed
    for (int i = tid; i < E * 3 * D / 8; i += TTHREADS) {
      const int k = i / (3 * D / 8), c = (i - k * (3 * D / 8)) * 8;
      const int which = c / D;  // 0 q, 1 k, 2 v
      *reinterpret_cast<uint4*>(ws + k * WP + c) = *reinterpret_cast<const uint4*>(
          wqkv_t + (long long)k * 3 * E + which * E + hh * D + (c - which * D));
    }
    __syncthreads();
    {
      float acc[3 * D / 8][4];
#pragma unroll
      for (int n = 0; n < 3 * D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < E / 16; ++kk) {
        uint32_t a[4];
        lds_a(a, xs + wr * XP + kk * 16, XP);
#pragma unroll
        for (int n = 0; n < 3 * D / 8; ++n) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, ws + (kk * 16 + (lane & 15)) * WP + n * 8);
          mma_bf16_16816(acc[n], a, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < 3 * D / 8; ++n) {
        const int which = n * 8 / D, c = n * 8 - which * D + 2 * q4;
        __nv_bfloat16* dst = which == 0 ? qs : (which == 1 ? ks : vs);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v0 = acc[n][2 * r], v1 = acc[n][2 * r + 1];
          if (which == 0) {  // q is rounded, then scaled and rounded again
            v0 = round_t<__nv_bfloat16>(v0) * scale;
            v1 = round_t<__nv_bfloat16>(v1) * scale;
          }
          *reinterpret_cast<uint32_t*>(dst + (wr + g + 8 * r) * QP + c) = pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();
    {
      uint32_t qa[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) lds_a(qa[kk], qs + wr * QP + kk * 16, QP);
      float sc[TTOK / 8][4];
#pragma unroll
      for (int nb = 0; nb < TTOK / 8; ++nb) {
        sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const __nv_bfloat16* kr = ks + (kr0 + nb * 8 + g) * QP + kk * 16 + 2 * q4;
          mma_bf16_16816(sc[nb], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                         *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
      uint32_t pa[TTOK / 16][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < TTOK / 8; ++nb)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!key_valid<MASKED>(nb * 8 + 2 * q4 + i, tv, kmask)) sc[nb][2 * r + i] = -INFINITY;
            m = fmaxf(m, sc[nb][2 * r + i]);
          }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float l = 0.f;
#pragma unroll
        for (int nb = 0; nb < TTOK / 8; ++nb)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            sc[nb][2 * r + i] = expf(sc[nb][2 * r + i] - m);
            l += sc[nb][2 * r + i];
          }
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        // score tiles 2j and 2j+1 are the a fragment of keys 16j..16j+15
#pragma unroll
        for (int nb = 0; nb < TTOK / 8; ++nb)
          pa[nb >> 1][r + 2 * (nb & 1)] = pack_bf16(sc[nb][2 * r] / l, sc[nb][2 * r + 1] / l);
      }
      float oacc[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < TTOK / 16; ++j)
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, vs + (kr0 + j * 16 + (lane & 15)) * QP + n * 8);
          mma_bf16_16816(oacc[n], pa[j], b0, b1);
        }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(os + (wr + g + 8 * r) * XP + hh * D + n * 8 + 2 * q4) =
              pack_bf16(oacc[n][2 * r], oacc[n][2 * r + 1]);
    }
  }

  float acc[E / 8][4];
#pragma unroll
  for (int n = 0; n < E / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int c0 = 0; c0 < E; c0 += OC) {
    __syncthreads();  // every head output is written; the previous chunk is consumed
    for (int i = tid; i < OC * E / 8; i += TTHREADS) {
      const int k = i / (E / 8), c = (i - k * (E / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + k * XP + c) =
          *reinterpret_cast<const uint4*>(wout + (long long)(c0 + k) * E + c);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < OC / 16; ++j) {
      uint32_t a[4];
      lds_a(a, os + wr * XP + c0 + j * 16, XP);
#pragma unroll
      for (int n = 0; n < E / 8; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, ws + (j * 16 + (lane & 15)) * XP + n * 8);
        mma_bf16_16816(acc[n], a, b0, b1);
      }
    }
  }
  const int si = s0 + wr / TTOK;  // a warp's 16 rows lie in one sample
  residual_ln_store<E>(acc, xs + wr * XP, XP, [=](int r) -> __nv_bfloat16* {
    const int tok = wr % TTOK + r;
    return tok < t && si < s ? out + base + tok * tok_stride + si * row_stride : nullptr;
  });
}

template <int E, int D, int TTOK, bool SM, bool MASKED>
int launch_tc_rows(const void* x, const void* wqkv_t, const void* wout, void* out, int b, int t,
                   int s, int tv, const unsigned long long* masks, int rpm, cudaStream_t stream) {
  static_assert(E % OC == 0 && D % 16 == 0 && E % D == 0, "widths the tile layout takes");
  static_assert(TROWS % TTOK == 0 && TTOK % 16 == 0, "a warp's rows lie in one sample");
  constexpr int TS = TROWS / TTOK;
  const size_t smem = sizeof(__nv_bfloat16) * tc_smem_elems<E, D>();
  static_assert(sizeof(__nv_bfloat16) * tc_smem_elems<E, D>() <= MMPFN_MAX_SMEM, "tiles fit");
  int rc = mmpfn_allow_smem(feat_attn_ln_tc_kernel<E, D, TTOK, SM, MASKED>, smem);
  if (rc) return rc;
  feat_attn_ln_tc_kernel<E, D, TTOK, SM, MASKED>
      <<<dim3((s + TS - 1) / TS, b), TTHREADS, smem, stream>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)wqkv_t, (const __nv_bfloat16*)wout,
          (__nv_bfloat16*)out, t, s, tv, masks, rpm, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int E, int D, bool SM, bool MASKED>
int launch_tc(const void* x, const void* wqkv_t, const void* wout, void* out, int b, int t, int s,
              int tv, const unsigned long long* masks, int rpm, cudaStream_t stream) {
  return t <= 32 ? launch_tc_rows<E, D, 32, SM, MASKED>(x, wqkv_t, wout, out, b, t, s, tv, masks,
                                                        rpm, stream)
                 : launch_tc_rows<E, D, MAX_TOKENS, SM, MASKED>(x, wqkv_t, wout, out, b, t, s, tv,
                                                                masks, rpm, stream);
}

template <typename T, bool SM, bool MASKED>
int launch(const void* x, const void* wqkv_t, const void* wout, void* out, int b, int t, int s,
           int e, int h, int d, int tv, const unsigned long long* masks, int rpm,
           cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // the published width, and a small one the tests reach
    if (h * d == e && e == 192 && d == 32)
      return launch_tc<192, 32, SM, MASKED>(x, wqkv_t, wout, out, b, t, s, tv, masks, rpm, stream);
    if (h * d == e && e == 64 && d == 16)
      return launch_tc<64, 16, SM, MASKED>(x, wqkv_t, wout, out, b, t, s, tv, masks, rpm, stream);
  }
  const size_t smem =
      sizeof(float) * ((size_t)t * e + (size_t)t * h * d + 3 * (size_t)t * (d + 1) + (size_t)t * t);
  if (smem > MMPFN_MAX_SMEM) return MMPFN_BAD_ARGS;
  int rc = mmpfn_allow_smem(feat_attn_ln_kernel<T, SM, MASKED>, smem);
  if (rc) return rc;
  feat_attn_ln_kernel<T, SM, MASKED><<<dim3(s, b), THREADS, smem, stream>>>(
      (const T*)x, (const T*)wqkv_t, (const T*)wout, (T*)out, t, s, e, h, d, tv, masks, rpm,
      1.f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

// b members of s rows each, item-major or (SM, b = 1) sample-major; MASKED:
// a mask word per member (item-major) or per rpm rows (sample-major)
template <bool SM, bool MASKED>
int run(const void* x, const void* wqkv_t, const void* wout, void* out, const void* masks,
        int rpm, int b, int t, int s, int e, int h, int d, int tv, int dtype, int device,
        void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (b <= 0 || s <= 0) return 0;
  if (t < 1 || t > MAX_TOKENS || tv < 1 || tv > t || e % 4 || d % 2 || (h * d) % 4 || b > 65535)
    return MMPFN_BAD_ARGS;
  if (MASKED && (masks == nullptr || rpm < 1)) return MMPFN_BAD_ARGS;
  const unsigned long long* mw = (const unsigned long long*)masks;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == MMPFN_F32)
    return launch<float, SM, MASKED>(x, wqkv_t, wout, out, b, t, s, e, h, d, tv, mw, rpm, st);
  if (dtype == MMPFN_BF16)
    return launch<__nv_bfloat16, SM, MASKED>(x, wqkv_t, wout, out, b, t, s, e, h, d, tv, mw, rpm,
                                             st);
  return MMPFN_BAD_ARGS;
}

}  // namespace

// K1: x (b, t, s, e), item-major
extern "C" int mmpfn_feat_attn_ln_im(const void* x, const void* wqkv_t, const void* wout,
                                     void* out, int b, int t, int s, int e, int h, int d,
                                     int dtype, int device, void* stream) {
  return run<false, false>(x, wqkv_t, wout, out, nullptr, 1, b, t, s, e, h, d, t, dtype, device,
                           stream);
}

// K5: x (rows, t, e), sample-major; keys at or past token_valid masked
extern "C" int mmpfn_feat_attn_ln(const void* x, const void* wqkv_t, const void* wout, void* out,
                                  int rows, int t, int e, int h, int d, int token_valid, int dtype,
                                  int device, void* stream) {
  return run<true, false>(x, wqkv_t, wout, out, nullptr, 1, 1, t, rows, e, h, d, token_valid,
                          dtype, device, stream);
}

// K6a: x (b, t, s, e), item-major; masks: b words, bit j of word i set when
// token j of member i is a key
extern "C" int mmpfn_feat_attn_ln_im_masked(const void* x, const void* wqkv_t, const void* wout,
                                            void* out, const void* masks, int b, int t, int s,
                                            int e, int h, int d, int dtype, int device,
                                            void* stream) {
  return run<false, true>(x, wqkv_t, wout, out, masks, 1, b, t, s, e, h, d, t, dtype, device,
                          stream);
}

// K6b: x (rows, t, e), sample-major; masks: a word per rows_per_member
// consecutive rows
extern "C" int mmpfn_feat_attn_ln_masked(const void* x, const void* wqkv_t, const void* wout,
                                         void* out, const void* masks, int rows, int t, int e,
                                         int h, int d, int rows_per_member, int dtype, int device,
                                         void* stream) {
  return run<true, true>(x, wqkv_t, wout, out, masks, rows_per_member, 1, t, rows, e, h, d, t,
                         dtype, device, stream);
}
