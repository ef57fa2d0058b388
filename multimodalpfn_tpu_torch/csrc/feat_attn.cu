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
// against 2·t·e·sizeof(T) bytes of activations; the weights (295 KB in
// bf16) stay in L2. Two bodies, each with its own C entry; the Python
// wrapper (ops/fused.py:feat_attn_body) picks one:
//  * feat_attn_ln_kernel (mmpfn_feat_attn_ln, _im, _masked, _im_masked):
//    float32 operands on the CUDA cores (the parity mode needs full float32
//    products), and bf16 at the widths the wgmma body does not take;
//  * wg::feat_attn_wg_kernel (mmpfn_feat_attn_ln_wg): bf16 at e = 192, d =
//    32 and e = 64, d = 16 on Hopper's wgmma, fed by TMA, with tiles of
//    whole samples packed 64 token rows to a warpgroup (below). Its products
//    are 92 % of the work; at 48 tokens one sample fills 48 of a tile's 64
//    rows. On an H100 SXM at 700 W it takes 0.28 ms for K1 at (4, 31, 2350,
//    192), 3.0× its operations bound (0.094 ms) and about as long as
//    torch.matmul on the QKV and out projections alone (0.27 ms).
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
#include "ln_tile.cuh"

#include <algorithm>

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

// ---- bf16 on Hopper's wgmma ------------------------------------------------
// wg::feat_attn_wg_kernel, the same function for bf16 operands with h·d = e
// at e = 192, d = 32 (the published width) and e = 64, d = 16: a persistent
// block per SM, two consumer warpgroups and a producer thread, as K3's wgmma
// body (mlp_ln.cu):
//  * a warpgroup's tile is 64 token rows holding ns = 64 / t whole samples,
//    packed: row j·t + tok is token tok of sample j (ns·t rows; the rest
//    are computed and never stored). TMA loads it in 64-column boxes (64,
//    t, ns) of a 3-D map of x over (e, token, sample): item-major (b, t, s,
//    e) as (e, b·t, s), the token stride s·e and the sample stride e, at
//    (c, member·t, s0); sample-major (rows, t, e) as (e, t, rows) at (c, 0,
//    s0). A box never crosses members; samples past the last read as zero
//    and are not stored; the next pair's boxes are prefetched into L2;
//  * the producer streams each head's weights through a ring of stages: its
//    q|k|v rows of W_qkv stored head-major ((h, 3, d) rows of e, K-major)
//    and its d rows of W_out as stored (MN-major), in 64-column boxes; the
//    two warpgroups' tiles share each stage;
//  * per head, q|k|v of the tile's rows is one wgmma m64n(3d)k16 chain, x
//    and the head's rows both from shared memory (x held in registers
//    beside the two accumulators spilled: ptxas gives a consumer thread 168
//    registers). q (rounded, scaled and
//    rounded again), k and v (rounded) go to shared memory, swizzled as TMA
//    would have written them;
//  * attention on wgmma: the warpgroup's 64 query rows against its 64 rows
//    as keys (scores m64n64k16 from shared memory), a (query, key) pair
//    kept when the key row is a valid token of the query's sample: a 64-bit
//    mask a query row, from token_valid or the member's mask word. The
//    softmax runs on the accumulator (a row's keys in one quad of lanes),
//    one ex2 a score with log2 e folded into the subtraction of the row's
//    max; its bf16 weights are the A fragments of o = p·v (m64ndk16, v
//    MN-major);
//  * the head's outputs, rounded to bf16, are the A fragments of the
//    out-projection, a wgmma m64nek16 chain from registers into one float32
//    accumulator over the heads: the concatenated head outputs never reach
//    shared memory;
//  * the two warpgroups take turns (named barriers); a turn holds all of a
//    head's chain that needs the tensor cores, which run a warpgroup's
//    products in the order they were issued: head h - 1's p·v and
//    out-projection, head h's q|k|v, its staging and its scores. The
//    softmax runs beside the other warpgroup's turn (issuing the scores
//    after the turn had passed left them queued behind the other's
//    products: 4-6 % slower). No wgmma is issued under a condition (ptxas
//    serializes every wgmma of a kernel that does);
//  * the epilogue adds the residual and normalises on the accumulator
//    (ln_tile.cuh), writes the bf16 rows over the x rows, and a TMA store
//    writes the tile's samples out.
namespace wg {

constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int BOX = 64 * 64 * 2;  // 64 rows of 64 bf16 columns
constexpr int TURN_BAR = 3;       // named barriers 3, 4: each warpgroup's turn (1, 2: its own)

// Shared memory of a block at width E, head width D: the two warpgroups' x
// rows (E / 64 boxes of 64 rows each), the ring of ST stages (a head's
// 3·D rows of W_qkv as E / 64 boxes of 64 columns, then its D rows of W_out
// as E / 64 boxes of 64 columns), each warpgroup's q, k and v rows (64
// rows of D, swizzled as TMA would write them), then the barriers. At E =
// 192 a stage is 48 KB: a turn's two products keep two stages busy, so
// three is the least that leaves one loading, and one x buffer a
// warpgroup is what room is left for (two x buffers with two stages were
// no faster).
template <int E, int D>
struct Geo {
  static constexpr int H = E / D, NB = E / 64, N3 = 3 * D;
  static constexpr int XWG = NB * BOX;   // a warpgroup's x rows
  static constexpr int QBOX = N3 * 128;  // 64 columns of a head's q|k|v rows
  static constexpr int OBOX = D * 128;   // 64 columns of a head's W_out rows
  static constexpr int WQ = NB * QBOX;
  static constexpr int STAGE = WQ + NB * OBOX;
  static constexpr int ST = E == 192 ? 3 : 4;
  static constexpr int QT = 64 * D * 2;  // a warpgroup's q, k or v rows
  static constexpr int RING = 2 * XWG;
  static constexpr int QKV = RING + ST * STAGE;
  static constexpr int BARS = QKV + 2 * 3 * QT;  // full[ST], empty[ST], xfull[2], xempty[2]
  static constexpr int SMEM = BARS + (2 * ST + 4) * 8 + 1024;  // + alignment slack
  static_assert(E % 64 == 0 && D % 16 == 0 && E % D == 0 && D <= 32, "widths the tile takes");
  static_assert(SMEM <= MMPFN_MAX_SMEM, "shared memory");
};

// the tensor maps of x, out, W_qkv (head-major) and W_out, passed as a
// __grid_constant__
struct Maps {
  CUtensorMap x, out, wq, wo;
};

// A launch: ns samples of t tokens a tile, `tiles` tiles (item-major: tpm
// a member), `rows` samples (item-major: a member's); keys below tv are
// valid, or (MASKED) those of a mask word per member (item-major) or per
// rpm rows (sample-major)
struct Shape {
  int t, ns, tpm, tiles, rows, tv, rpm;
  float scale;
};

__device__ __forceinline__ uint64_t low_bits(int n) { return n >= 64 ? ~0ull : (1ull << n) - 1; }

// the coordinates (c1, c2) of a tile's boxes in the layout's map
template <bool SM>
__device__ __forceinline__ void tile_at(const Shape& p, int tile, int& c1, int& c2) {
  if constexpr (SM) {
    c1 = 0;
    c2 = tile * p.ns;
  } else {
    const int m = tile / p.tpm;
    c1 = m * p.t;
    c2 = (tile - m * p.tpm) * p.ns;
  }
}

// Block b takes the tile pairs b, b + gridDim.x, ...; warpgroup w the tile
// 2·pair + w of each (the last pair of an odd count computes its last tile
// again and does not store it)
template <int E, int D, bool SM, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
    feat_attn_wg_kernel(const __grid_constant__ Maps maps, const Shape p,
                        const unsigned long long* __restrict__ masks) {
  using namespace hopper;
  using G = Geo<E, D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sm + G::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::BARS);
  uint64_t* empty = full + G::ST;
  uint64_t* xfull = empty + G::ST;  // [2], a warpgroup's x rows arrived
  uint64_t* xempty = xfull + 2;     // [2], ... and stored
  const int tid = threadIdx.x, wg = tid >> 7;
  const int pairs = (p.tiles + 1) / 2;
  if (tid == 0) {
    for (int s = 0; s < G::ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // every consumer warp
    }
    for (int i = 0; i < 4; ++i) mbar_init(xfull + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the rows past a tile's samples are never loaded: zeroed once, they stay
  // finite (their LN outputs are written over them), and so do their k and v
  for (int i = tid; i < G::RING / 16; i += THREADS) reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (wg == 2) {  // producer
    producer_registers();
    if (tid == 256) {
      const uint32_t xbytes = G::NB * p.ns * p.t * 128;
      int it = 0, xt = 0;
      auto load_x = [&](int pair) {
        for (int w = 0; w < 2; ++w) {
          int c1, c2;
          tile_at<SM>(p, min(2 * pair + w, p.tiles - 1), c1, c2);
          if (xt > 0) mbar_wait(xempty + w, (xt - 1) & 1);
          mbar_arrive_tx(xfull + w, xbytes);
          for (int b = 0; b < G::NB; ++b)
            tma_load(sm + w * G::XWG + b * BOX, &maps.x, xfull + w, 64 * b, c1, c2);
        }
        ++xt;
      };
      // one x buffer a warpgroup: the next pair's first stages are issued
      // before its x rows, which wait for this pair's epilogue
      constexpr int x_at = G::ST < G::H ? G::ST : G::H;
      for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
        if (pair + (int)gridDim.x < pairs)
          for (int w = 0; w < 2; ++w) {
            int c1, c2;
            tile_at<SM>(p, min(2 * (pair + (int)gridDim.x) + w, p.tiles - 1), c1, c2);
            for (int b = 0; b < G::NB; ++b) tma_prefetch(&maps.x, 64 * b, c1, c2);
          }
        for (int c = 0; c < G::H; ++c, ++it) {
          if (c == x_at) load_x(pair);
          const int s = it % G::ST;
          if (it >= G::ST) mbar_wait(empty + s, ((it / G::ST) - 1) & 1);
          mbar_arrive_tx(full + s, G::STAGE);
          uint8_t* st = ring + s * G::STAGE;
          // head c's rows of W_qkv (head-major) and of W_out, 64 columns a box
          for (int b = 0; b < G::NB; ++b) {
            tma_load(st + b * G::QBOX, &maps.wq, full + s, 64 * b, G::N3 * c, 0);
            tma_load(st + G::WQ + b * G::OBOX, &maps.wo, full + s, 64 * b, D * c, 0);
          }
        }
        if (x_at == G::H) load_x(pair);
      }
    }
  } else {  // consumers: warpgroup wg owns tile 2·pair + wg
    consumer_registers();
    const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, q4 = lane & 3;
    uint8_t* xs = sm + wg * G::XWG;
    uint8_t* qs = sm + G::QKV + wg * 3 * G::QT;  // q (scaled), k, v of a head
    uint8_t* ks = qs + G::QT;
    uint8_t* vs = ks + G::QT;
    auto wait_full = [&](int i) { mbar_wait(full + i % G::ST, (i / G::ST) & 1); };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + i % G::ST);
    };
    float acc[E / 2], qkv[G::N3 / 2];
    uint32_t oa[D / 16][4] = {};

    // This thread's query rows are 16·warp + g + 8r of the tile (r = 0, 1):
    // their samples, and (keys) the tile rows of their samples' valid tokens
    // as 64-bit masks, shifted by 2·(lane % 4) so that the key of score
    // register 4i + 2r + c (column 8i + 2·(lane % 4) + c) is bit 8i + c.
    const int nrows = p.ns * p.t;
    int rj[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      live[r] = row < nrows;
      rj[r] = row / p.t;
    }
    uint64_t keys[2];
    auto set_keys = [&](int tile) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint64_t bits = low_bits(p.tv);
        if constexpr (MASKED)
          bits = masks[SM ? min(tile * p.ns + rj[r], p.rows - 1) / p.rpm : tile / p.tpm] & low_bits(p.t);
        const uint64_t k = bits << (rj[r] * p.t);
        keys[r] = live[r] ? k >> (2 * q4) : 0;
      }
    };

    // q|k|v = x·W_qkv[head]ᵀ: x and the head's rows K-major, in 64-column
    // boxes BOX and QBOX apart
    const uint64_t xd = tile_desc<64>(xs);  // this warpgroup's x rows, K-major
    auto p_qkv = [&](int i) {
      const uint64_t bd = tile_desc<64>(ring + (i % G::ST) * G::STAGE);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < E / 16; ++j)
        wgmma_ss<G::N3>(qkv, xd + (j / 4) * (BOX >> 4) + 2 * (j % 4),
                        bd + (j / 4) * (G::QBOX >> 4) + 2 * (j % 4), j);
    };
    // acc += o·W_out[head rows]: MN-major, 64-column boxes OBOX apart
    auto p_out = [&](int i) {
      const uint64_t bd = tile_desc<64>(ring + (i % G::ST) * G::STAGE + G::WQ, G::OBOX);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wgmma_rs<E>(acc, oa[j], bd + 128 * j);
    };
    // q (rounded, scaled, rounded), k and v (rounded) into shared memory,
    // swizzled for the attention's products
    auto stage_qkv = [&]() {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r, col = 8 * i + 2 * q4;
          const float* kq = qkv + 4 * (i + D / 8) + 2 * r;
          const float* vq = qkv + 4 * (i + D / 4) + 2 * r;
          *swizzled<D>(qs, row, col) = pack_bf16(round_t<__nv_bfloat16>(qkv[4 * i + 2 * r]) * p.scale,
                                                 round_t<__nv_bfloat16>(qkv[4 * i + 2 * r + 1]) * p.scale);
          *swizzled<D>(ks, row, col) = pack_bf16(kq[0], kq[1]);
          *swizzled<D>(vs, row, col) = pack_bf16(vq[0], vq[1]);
        }
      fence_proxy_async();
      bar_sync(1 + wg, 128);
    };
    const uint64_t qd = tile_desc<D>(qs), kd = tile_desc<D>(ks), vd = tile_desc<D>(vs);
    float sc[32];
    uint32_t pa[4][4];
    // this warpgroup's products, waited for
    auto products = [&](auto issue) {
      issue();
      wgmma_commit();
      wgmma_wait<0>();
      keep(qkv);
      keep(acc);
      keep(oa);
    };
    // the head's q, k, v staged, and its scores (the tile's 64 query rows
    // against its 64 rows as keys, both K-major) issued; then the turn
    // passes to the other warpgroup while they run
    auto scores_then_pass = [&]() {
      stage_qkv();
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(sc, qd + 2 * j, kd + 2 * j, j);
      wgmma_commit();
      bar_arrive(TURN_BAR + (wg ^ 1), 256);
      wgmma_wait<0>();
      keep(sc);
    };
    // the softmax on the score accumulator, into the A fragments of p·v
    auto softmax = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (!((keys[r] >> (8 * i + c)) & 1)) sc[4 * i + 2 * r + c] = -INFINITY;
            m = fmaxf(m, sc[4 * i + 2 * r + c]);
          }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        // exp(s - m) = 2^(s·log2 e - m·log2 e); a row with no key (past the
        // tile's samples) gets no weight
        const float mb = m == -INFINITY ? 0.f : m * LOG2E;
        float l = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            sc[4 * i + 2 * r + c] = ex2(fmaf(sc[4 * i + 2 * r + c], LOG2E, -mb));
            l += sc[4 * i + 2 * r + c];
          }
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = l > 0.f ? 1.f / l : 0.f;
        // score columns 16j..16j + 15 are the A fragment of k step j
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pa[i >> 1][r + 2 * (i & 1)] = pack_bf16(sc[4 * i + 2 * r] * inv, sc[4 * i + 2 * r + 1] * inv);
      }
    };
    // o = p·v (v MN-major), waited for; the head's bf16 outputs into oa
    auto weigh_values = [&]() {
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs<D>(o, pa[j], vd + 2 * D * j);
      wgmma_commit();
      wgmma_wait<0>();
      keep(o);
      keep(pa);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) oa[n / 2][r + 2 * (n & 1)] = pack_bf16(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
    };

    if constexpr (!MASKED) set_keys(0);
    if (wg == 1) bar_arrive(TURN_BAR, 256);  // warpgroup 0 takes the first turn
    int it = 0, xt = 0;
    for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x, ++xt, it += G::H) {
      const int tile = 2 * pair + wg;
      if constexpr (MASKED) set_keys(min(tile, p.tiles - 1));
      mbar_wait(xfull + wg, xt & 1);
#pragma unroll
      for (int i = 0; i < E / 2; ++i) acc[i] = 0.f;
      // A turn (between bar_sync and bar_arrive of the turn barriers) holds
      // everything of the head's chain that needs the tensor cores: head h -
      // 1's p·v and out-projection, head h's q|k|v, staged, and its scores;
      // the softmax runs while the other warpgroup takes its turn. Turn 0
      // has no head - 1, turn H no head H.
      wait_full(it);
      bar_sync(TURN_BAR + wg, 256);
      products([&] { p_qkv(it); });
      scores_then_pass();
      softmax();
      for (int h = 1; h < G::H; ++h) {
        wait_full(it + h);
        bar_sync(TURN_BAR + wg, 256);
        weigh_values();
        products([&] {
          p_out(it + h - 1);
          p_qkv(it + h);
        });
        release(it + h - 1);
        scores_then_pass();
        softmax();
      }
      bar_sync(TURN_BAR + wg, 256);
      weigh_values();
      p_out(it + G::H - 1);
      wgmma_commit();
      bar_arrive(TURN_BAR + (wg ^ 1), 256);
      wgmma_wait<0>();
      keep(acc);
      keep(oa);
      release(it + G::H - 1);
      uint32_t xa[E / 16][4];
      x_frags<E>(xa, xs);
      residual_ln_tile<E>(acc, xa, xs);
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if ((tid & 127) == 0) {
        if (tile < p.tiles) {
          int c1, c2;
          tile_at<SM>(p, tile, c1, c2);
          for (int b = 0; b < G::NB; ++b) tma_store(&maps.out, xs + b * BOX, 64 * b, c1, c2);
          bulk_commit();
          bulk_wait_read();
        }
        mbar_arrive(xempty + wg);
      }
    }
    if (wg == 0) bar_sync(TURN_BAR, 256);  // warpgroup 1's last turn
    if ((tid & 127) == 0) bulk_wait();
  }
}

// the 3-D map of x or out over (e, token, sample), box (64, t, ns):
// item-major (e, b·t, s), token stride s·e, sample stride e; sample-major
// (e, t, rows)
template <int E, bool SM>
int x_map(CUtensorMap* map, const void* base, int b, int t, int s, int ns) {
  const cuuint64_t row = 2ull * E;
  if constexpr (SM)
    return hopper::make_map_box(map, base, {(cuuint64_t)E, (cuuint64_t)t, (cuuint64_t)s},
                                {row, row * t}, {64u, (cuuint32_t)t, (cuuint32_t)ns});
  return hopper::make_map_box(map, base, {(cuuint64_t)E, (cuuint64_t)b * t, (cuuint64_t)s},
                              {row * s, row}, {64u, (cuuint32_t)t, (cuuint32_t)ns});
}

template <int E, int D, bool SM, bool MASKED>
int launch_wg(const void* x, const void* wqkv, const void* wout, void* out,
              const unsigned long long* masks, int rpm, int b, int t, int s, int tv,
              cudaStream_t stream) {
  using G = Geo<E, D>;
  // TMA: 16-byte aligned bases (rows of 2·E bytes are)
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wqkv) |
       reinterpret_cast<uintptr_t>(wout) | reinterpret_cast<uintptr_t>(out)) & 15)
    return MMPFN_BAD_ARGS;
  Shape p;
  p.t = t;
  p.ns = 64 / t;
  p.rows = s;
  p.tv = tv;
  p.rpm = rpm;
  p.scale = 1.f / sqrtf((float)D);
  const long long per = (s + p.ns - 1) / p.ns, tiles = per * b;
  if (tiles > 0x7ffffff0LL) return MMPFN_BAD_ARGS;
  p.tpm = (int)per;
  p.tiles = (int)tiles;
  Maps maps;
  const cuuint64_t row = 2ull * E;
  int rc = x_map<E, SM>(&maps.x, x, b, t, s, p.ns);
  if (!rc) rc = x_map<E, SM>(&maps.out, out, b, t, s, p.ns);
  if (!rc)
    rc = hopper::make_map_box(&maps.wq, wqkv, {(cuuint64_t)E, 3ull * E, 1ull}, {row, row * 3 * E},
                              {64u, (cuuint32_t)G::N3, 1u});
  if (!rc)
    rc = hopper::make_map_box(&maps.wo, wout, {(cuuint64_t)E, (cuuint64_t)E, 1ull}, {row, row * E},
                              {64u, (cuuint32_t)D, 1u});
  if (!rc) rc = mmpfn_allow_smem(feat_attn_wg_kernel<E, D, SM, MASKED>, G::SMEM);
  static int sms = 0;
  if (!rc && !sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    rc = (int)err;
  }
  if (rc) return rc;
  const int pairs = (p.tiles + 1) / 2;
  feat_attn_wg_kernel<E, D, SM, MASKED>
      <<<std::min(pairs, sms), THREADS, G::SMEM, stream>>>(maps, p, masks);
  return (int)cudaGetLastError();
}

template <int E, int D>
int launch_wg_as(bool sm, const void* x, const void* wqkv, const void* wout, void* out,
                 const unsigned long long* masks, int rpm, int b, int t, int s, int tv,
                 cudaStream_t st) {
  if (sm)
    return masks ? launch_wg<E, D, true, true>(x, wqkv, wout, out, masks, rpm, b, t, s, tv, st)
                 : launch_wg<E, D, true, false>(x, wqkv, wout, out, masks, rpm, b, t, s, tv, st);
  return masks ? launch_wg<E, D, false, true>(x, wqkv, wout, out, masks, rpm, b, t, s, tv, st)
               : launch_wg<E, D, false, false>(x, wqkv, wout, out, masks, rpm, b, t, s, tv, st);
}

}  // namespace wg

template <typename T, bool SM, bool MASKED>
int launch(const void* x, const void* wqkv_t, const void* wout, void* out, int b, int t, int s,
           int e, int h, int d, int tv, const unsigned long long* masks, int rpm,
           cudaStream_t stream) {
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

// K1, K5, K6a and K6b in bf16 on wgmma (wg::feat_attn_wg_kernel): x (b, t, s,
// e) item-major, or (sample_major, b = 1) (s, t, e); wqkv the (h, 3, d) rows
// of W_qkv head-major, (3·e, e); wout W_out as stored, (e, e); masks null
// (keys below token_valid) or a word per member (item-major) or per
// rows_per_member rows (sample-major). e = 192, d = 32 or e = 64, d = 16.
extern "C" int mmpfn_feat_attn_ln_wg(const void* x, const void* wqkv, const void* wout, void* out,
                                     const void* masks, int rows_per_member, int b, int t, int s,
                                     int e, int h, int d, int token_valid, int sample_major,
                                     int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (b <= 0 || s <= 0) return 0;
  if (t < 1 || t > MAX_TOKENS || token_valid < 1 || token_valid > t || h * d != e ||
      (sample_major && b != 1) || (masks && rows_per_member < 1))
    return MMPFN_BAD_ARGS;
  const auto* mw = (const unsigned long long*)masks;
  cudaStream_t st = (cudaStream_t)stream;
  if (e == 192 && d == 32)
    return wg::launch_wg_as<192, 32>(sample_major, x, wqkv, wout, out, mw, rows_per_member, b, t,
                                     s, token_valid, st);
  if (e == 64 && d == 16)
    return wg::launch_wg_as<64, 16>(sample_major, x, wqkv, wout, out, mw, rows_per_member, b, t,
                                    s, token_valid, st);
  return MMPFN_BAD_ARGS;
}
