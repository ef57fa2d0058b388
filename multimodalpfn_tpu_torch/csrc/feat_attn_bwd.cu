// K7: the backward of K1 (item-major) and of K5 (sample-major, "K7s"),
// out = LN(x + W_out·attn(x)) over the t feature tokens of every row of x,
// (member, sample) rows of an item-major x (b, t, s, e) or the rows of a
// sample-major x (rows, t, e):
//   given g = dL/dout, returns dx (x's layout and type), dW_qkv (3·h·d, e)
//   and dW_out (h·d, e) in float32, each summed over all tokens.
//
// Replaces multimodalpfn_tpu/ops/pallas_fused.py:_attn_bwd_kernel_im
// (pallas_call in _attn_bwd_call_im, :1070/:1082) and _attn_bwd_kernel
// (pallas_call in _attn_bwd_call, :1024/:1040); body _feat_attn_bwd_core
// :898 for both.
//
// What bounds it on the H100: the bytes of its launches. Its 12 products of
// 2·e·h·d FLOPs per token (the QKV recompute, the out-projection recompute,
// do, dx, and the weight gradients: 49 GFLOP at the flagship fine-tune
// shape, 1 × 30 × 1838 tokens, e = 192; 0.05 ms at the bf16 peak) and the
// per-row attention move about 0.86 GB through device memory with the
// intermediates below (0.26 ms at 3.35 TB/s). The per-row attention itself
// does little arithmetic (at that shape about 1.3 GFLOP forward, 3.2
// backward): steps 2 and 6 are bound by their bytes, 0.025 and 0.044 ms.
//
// Design: the Pallas kernel recomputes a block of rows in VMEM and carries
// dW over a sequential grid. Here the sublayer is a sequence of launches,
// each a kernel of this file or a product of gemm_tile.cuh (bf16: wgmma
// from a TMA ring, transposed operands named MN-major by descriptor, the
// epilogue staged through shared memory into vector loads and stores;
// float32: the CUDA cores), with the intermediates in device memory:
//   1. qkv = x·W_qkv^T, rounded to T (the forward's projection);
//   2. o: per (row, head) the softmax weights recomputed (q scaled and
//      rounded as in K1) and o = rnd(rnd(p)·v);
//   3. u = x + o·W_out (float32), 4. du = LN'(u)·g (float32 and rounded),
//   5. do = rnd(du·W_out^T);
//   6. per (row, head): p, dp = do·v^T, ds = rnd(p·(dp − Σ p·dp)),
//      dq = rnd(ds·k·scale), dk = rnd(ds^T·q), dv = rnd(rnd(p)^T·do);
//   7. dx = du + [dq dk dv]·W_qkv, rounded to T;
//   8. dW_qkv = [dq dk dv]^T·x and dW_out = o^T·du, split over rows into
//      float32 slabs summed in order (no atomics: the same bits every run).
// The products of steps 1, 3-5, 7 and 8 see only the flattened tokens and
// are the same launches in both layouts. Steps 2 and 6 have two bodies:
//  * bf16 at d = 16, 32, 64 (hopper::on_wgmma): row_wg::attn_wg_kernel, one
//    head of a 64-row tile of whole samples a work item, loaded by TMA and
//    computed on wgmma (below);
//  * float32 (the parity mode) and bf16 at d = 8: attn_o_kernel and
//    attn_bwd_kernel, a warp per (row, head) on the CUDA cores, which
//    gathers the head's q, k, v (and do) rows into shared memory once
//    (scores and weights [t][t|1] floats there).
// A row's t tokens lie s·3·h·d elements apart (item-major) or 3·h·d apart
// (sample-major): a compile-time flag (SM) of both bodies, as K5 is K1's
// body with a flag (a runtime stride cost K1 11 % in an A/B). Tokens are
// never padded: the warp kernels need no mask, the wgmma body masks the
// pairs of different samples in a tile.
#include "gemm_tile.cuh"

namespace {

// Shared memory of one (row, head) warp: Q, K, V, dO rows [t][D+1] and the
// scores / weights [t][t|1], floats.
template <int D>
size_t attn_smem(int t) {
  return sizeof(float) * (4 * (size_t)t * (D + 1) + 2 * (size_t)t * (t | 1));
}

// Gather the head's rows of token j of row (bi, s) from a (b, t, s, ncol)
// array at column `col`: n rows of D values, scaled by `mul` and rounded to T
// when `mul` != 1. A sample-major caller passes bi = its row, si = 0, s = 1.
template <typename T, int D>
__device__ __forceinline__ void gather(float* dst, const T* src, int t, int s, int bi, int si,
                                       int ncol, int col, float mul) {
  const int lane = threadIdx.x;
  for (int i = lane; i < t * D; i += 32) {
    const int j = i / D, c = i - j * D;
    const float v = to_f<T>(src[((long long)(bi * t + j) * s + si) * ncol + col + c]);
    dst[j * (D + 1) + c] = mul == 1.f ? v : round_t<T>(v * mul);
  }
}

// 2. o = rnd(rnd(softmax(q·k^T))·v) for one (row, head): grid (rows, h), one warp.
template <typename T, int D, bool SM>
__global__ void __launch_bounds__(32)
attn_o_kernel(const T* __restrict__ qkv, T* __restrict__ o, int t, int s_im, int h, float scale) {
  extern __shared__ __align__(16) float sm[];
  // item-major rows are (member, sample) pairs; a sample-major row is whole
  // (s = 1 at compile time)
  const int s = SM ? 1 : s_im;
  const int row = blockIdx.x, hh = blockIdx.y;
  const int bi = SM ? row : row / s, si = SM ? 0 : row - bi * s;
  const int hd = h * D, lane = threadIdx.x;
  float* Q = sm;
  float* K = Q + t * (D + 1);
  float* V = K + t * (D + 1);
  gather<T, D>(Q, qkv, t, s, bi, si, 3 * hd, hh * D, scale);
  gather<T, D>(K, qkv, t, s, bi, si, 3 * hd, hd + hh * D, 1.f);
  gather<T, D>(V, qkv, t, s, bi, si, 3 * hd, 2 * hd + hh * D, 1.f);
  __syncwarp();
  for (int i = lane; i < t; i += 32) {
    float q[D];
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = Q[i * (D + 1) + c];
    float m = -INFINITY;
    for (int j = 0; j < t; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) a = fmaf(q[c], K[j * (D + 1) + c], a);
      m = fmaxf(m, a);
    }
    float l = 0.f;
    for (int j = 0; j < t; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) a = fmaf(q[c], K[j * (D + 1) + c], a);
      l += expf(a - m);
    }
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    for (int j = 0; j < t; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) a = fmaf(q[c], K[j * (D + 1) + c], a);
      const float p = round_t<T>(expf(a - m) / l);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, V[j * (D + 1) + c], acc[c]);
    }
    T* dst = o + ((long long)(bi * t + i) * s + si) * hd + hh * D;
#pragma unroll
    for (int c = 0; c < D; ++c) dst[c] = from_f<T>(acc[c]);
  }
}

// 6. the attention backward of one (row, head): grid (rows, h), one warp.
// Phase 1, lane = query i: scores, weights p (float32), dp, delta_i = Σ_j p·dp,
// ds = rnd(p·(dp − delta_i)) parked in shared memory, dq_i = rnd(scale·ds·k).
// Phase 2, lane = key j: dk_j = rnd(Σ_i ds_ij·q_i), dv_j = rnd(Σ_i rnd(p_ij)·do_i).
template <typename T, int D, bool SM>
__global__ void __launch_bounds__(32)
attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
                int t, int s_im, int h, float scale) {
  extern __shared__ __align__(16) float sm[];
  // item-major rows are (member, sample) pairs; a sample-major row is whole
  // (s = 1 at compile time)
  const int s = SM ? 1 : s_im;
  const int row = blockIdx.x, hh = blockIdx.y;
  const int bi = SM ? row : row / s, si = SM ? 0 : row - bi * s;
  const int hd = h * D, lane = threadIdx.x, tp = t | 1;
  float* Q = sm;
  float* K = Q + t * (D + 1);
  float* V = K + t * (D + 1);
  float* dO = V + t * (D + 1);
  float* P = dO + t * (D + 1);  // [t][tp] weights
  float* DS = P + t * tp;       // [t][tp] dp, then ds
  gather<T, D>(Q, qkv, t, s, bi, si, 3 * hd, hh * D, scale);
  gather<T, D>(K, qkv, t, s, bi, si, 3 * hd, hd + hh * D, 1.f);
  gather<T, D>(V, qkv, t, s, bi, si, 3 * hd, 2 * hd + hh * D, 1.f);
  gather<T, D>(dO, dout, t, s, bi, si, hd, hh * D, 1.f);
  __syncwarp();
  for (int i = lane; i < t; i += 32) {
    float q[D], g[D];
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = Q[i * (D + 1) + c], g[c] = dO[i * (D + 1) + c];
    float m = -INFINITY;
    for (int j = 0; j < t; ++j) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        a = fmaf(q[c], K[j * (D + 1) + c], a);
        b = fmaf(g[c], V[j * (D + 1) + c], b);
      }
      P[i * tp + j] = a;
      DS[i * tp + j] = b;
      m = fmaxf(m, a);
    }
    float l = 0.f;
    for (int j = 0; j < t; ++j) l += expf(P[i * tp + j] - m);
    float delta = 0.f;
    for (int j = 0; j < t; ++j) {
      const float p = expf(P[i * tp + j] - m) / l;
      P[i * tp + j] = p;
      delta = fmaf(p, DS[i * tp + j], delta);
    }
    float dq[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dq[c] = 0.f;
    for (int j = 0; j < t; ++j) {
      const float ds = round_t<T>(P[i * tp + j] * (DS[i * tp + j] - delta));
      DS[i * tp + j] = ds;
#pragma unroll
      for (int c = 0; c < D; ++c) dq[c] = fmaf(ds, K[j * (D + 1) + c], dq[c]);
    }
    T* dst = dqkv + ((long long)(bi * t + i) * s + si) * 3 * hd + hh * D;
#pragma unroll
    for (int c = 0; c < D; ++c) dst[c] = from_f<T>(dq[c] * scale);
  }
  __syncwarp();
  for (int j = lane; j < t; j += 32) {
    float dk[D], dv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dk[c] = dv[c] = 0.f;
    for (int i = 0; i < t; ++i) {
      const float ds = DS[i * tp + j], p = round_t<T>(P[i * tp + j]);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dk[c] = fmaf(ds, Q[i * (D + 1) + c], dk[c]);
        dv[c] = fmaf(p, dO[i * (D + 1) + c], dv[c]);
      }
    }
    T* dst = dqkv + ((long long)(bi * t + j) * s + si) * 3 * hd + hd + hh * D;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dst[c] = from_f<T>(dk[c]);
      dst[hd + c] = from_f<T>(dv[c]);
    }
  }
}

// ---- bf16 on Hopper's wgmma: steps 2 and 6 ---------------------------------
// row_wg::attn_wg_kernel<D, SM, BWD>, the per-row attention of bf16 operands
// at d = 16, 32, 64 (hopper::on_wgmma): a persistent block of one consumer
// warpgroup and a producer warp, several blocks an SM.
//  * A work item is one head of a tile: 64 token rows holding ns = 64 / t
//    whole (member, sample) rows, row j·t + tok token tok of sample j, the
//    packing of K1's wgmma body (feat_attn.cu). Rows past ns·t, and samples
//    past the last, get no weight and are not stored. Items are dealt round
//    the grid, a tile's heads one after another.
//  * The producer thread loads an item's q, k, v (and do) boxes by TMA into a
//    ring of ST stages, from 3-D maps over (column, token, sample) of qkv (3·h·d
//    columns) and do (h·d): item-major tokens s·3hd elements apart, at (col,
//    member·t, s0), so a box never crosses members; sample-major at (col, 0,
//    s0). Boxes are d columns by t tokens by ns samples, swizzled as
//    hopper::tile_desc<D> names them.
//  * The consumers scale q in place, rnd(rnd(q)·scale) (at d = 32 the scale
//    is no power of two, so it cannot be folded into the scores), then issue
//    the scores S = q·kᵀ (m64n64k16, both K-major from shared memory). A
//    (query, key) pair counts only within a sample: a 64-bit mask word a
//    query row, shifted to the thread's columns, as in K1.
//  * Forward (step 2): the softmax on the accumulator with one ex2 a score;
//    the bf16 p are the A fragments of o = rnd(p)·v (v MN-major).
//  * Backward (step 6): S and dp = do·vᵀ (m64n64k16); p in float32, delta =
//    Σ_j p·dp (from p and dp, not rowsum(do∘o)), ds = rnd(p·(dp − delta)) on
//    the accumulators; dq = ds·k with ds as A fragments; rnd(p) and ds go to
//    shared memory as 64 × 64 bf16 tiles (rows = queries), the A of dk = dsᵀ·q
//    and dv = rnd(p)ᵀ·do read M-major (transpose bit), q and do N-major.
//  * The outputs, rounded to bf16, are written swizzled into output tiles and
//    stored by TMA through the mirrored maps of o (h·d columns) or dqkv
//    (3·h·d), which clip the samples past the last.
//  * Every wgmma is issued unconditionally (ptxas serializes all the wgmma
//    of a kernel that issues one under a runtime condition).
namespace row_wg {

using namespace hopper;

constexpr int THREADS = 160;  // a consumer warpgroup, then the producer warp
constexpr int ST = 2;         // ring stages
constexpr int PTILE = 64 * 64 * 2;  // a 64 × 64 bf16 tile of rnd(p) or ds

// Shared memory of a block at head width D: the ring of ST stages (q, k, v
// and, backward, do: 64 rows of D bf16 each), the output tiles (o; or dq,
// dk, dv), backward the rnd(p) and ds tiles, then the barriers. Every tile
// starts on a 1024-byte boundary (the swizzle's repeat).
template <int D, bool BWD>
struct Geo {
  static constexpr int TILE = 64 * D * 2;
  static constexpr int NT = BWD ? 4 : 3;
  static constexpr int STAGE = NT * TILE;
  static constexpr int OUT = ST * STAGE;
  static constexpr int PDS = OUT + (BWD ? 3 : 1) * TILE;
  static constexpr int BARS = PDS + (BWD ? 2 * PTILE : 0);
  static constexpr int SMEM = BARS + 2 * ST * 8 + 1024;  // + alignment slack
  // blocks an SM the registers are budgeted for (160 threads each)
  static constexpr int MIN_BLOCKS = BWD && D == 64 ? 2 : 3;
  static_assert(D % 16 == 0 && D <= 64, "widths the tile takes");
};

// the tensor maps of qkv, do (backward) and the output (o or dqkv), passed
// as a __grid_constant__
struct Maps {
  CUtensorMap qkv, dout, out;
};

// A launch: ns samples of t tokens a tile (item-major: tpm tiles a member),
// `items` = tiles × h work items, hd = h·d
struct Shape {
  int t, ns, h, hd, tpm, items;
  float scale;
};

// the coordinates (c1, c2) of a tile's boxes in the layout's maps
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

// a pair of bf16 scaled by `mul` and rounded again
__device__ __forceinline__ uint32_t scale2(uint32_t v, float mul) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * mul, f.y * mul);
}

template <int D, bool SM, bool BWD>
__global__ void __launch_bounds__(THREADS, Geo<D, BWD>::MIN_BLOCKS)
    attn_wg_kernel(const __grid_constant__ Maps maps, const Shape p) {
  using G = Geo<D, BWD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::BARS);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the rows past a tile's samples are never loaded: zeroed once, they stay
  // zero (the scaled q too), so no stale or uninitialised value meets a zero
  // weight
  for (int i = tid; i < G::OUT / 16; i += THREADS) reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (tid >= 128) {  // producer warp
    if (tid == 128) {
      const uint32_t bytes = G::NT * p.ns * p.t * D * 2;
      int it = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++it) {
        const int s = it % ST, tile = item / p.h, hh = item - tile * p.h;
        int c1, c2;
        tile_at<SM>(p, tile, c1, c2);
        if (it >= ST) mbar_wait(empty + s, ((it / ST) - 1) & 1);
        uint8_t* st = sm + s * G::STAGE;
        mbar_arrive_tx(full + s, bytes);
        for (int w = 0; w < 3; ++w) tma_load(st + w * G::TILE, &maps.qkv, full + s, w * p.hd + hh * D, c1, c2);
        if constexpr (BWD) tma_load(st + 3 * G::TILE, &maps.dout, full + s, hh * D, c1, c2);
      }
    }
    return;
  }

  // consumers: this thread's query rows are 16·warp + g + 8r (r = 0, 1);
  // the keys of each, the tile rows of its sample, as a 64-bit mask shifted
  // by 2·(lane % 4) so that the key of score register 4i + 2r + c (column
  // 8i + 2·(lane % 4) + c) is bit 8i + c
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, q4 = lane & 3;
  uint64_t keys[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r, j = row / p.t;
    const uint64_t bits = p.t >= 64 ? ~0ull : (1ull << p.t) - 1;
    keys[r] = row < p.ns * p.t ? (bits << (j * p.t)) >> (2 * q4) : 0;
  }
  uint8_t* out = sm + G::OUT;
  int it = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++it) {
    const int s = it % ST, tile = item / p.h, hh = item - tile * p.h;
    uint8_t* st = sm + s * G::STAGE;
    mbar_wait(full + s, (it / ST) & 1);
    // q scaled in place: every element of the tile (16 bytes a turn)
#pragma unroll
    for (int k = 0; k < G::TILE / 16 / 128; ++k) {
      uint4* v = reinterpret_cast<uint4*>(st) + tid + 128 * k;
      *v = make_uint4(scale2(v->x, p.scale), scale2(v->y, p.scale), scale2(v->z, p.scale), scale2(v->w, p.scale));
    }
    if (tid == 0) bulk_wait_read();  // the last item's output tiles have been read by its stores
    fence_proxy_async();
    bar_sync(1, 128);
    const uint64_t qd = tile_desc<D>(st), kd = tile_desc<D>(st + G::TILE), vd = tile_desc<D>(st + 2 * G::TILE);
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(sc, qd + 2 * j, kd + 2 * j, j);
    if constexpr (!BWD) {
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);
      // the softmax on the score accumulator, into the A fragments of p·v
      uint32_t pa[4][4];
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
        // exp(s - m) = 2^(s·log2 e - m·log2 e); a row with no key gets no weight
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
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pa[i >> 1][r + 2 * (i & 1)] = pack_bf16(sc[4 * i + 2 * r] * inv, sc[4 * i + 2 * r + 1] * inv);
      }
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
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *swizzled<D>(out, 16 * warp + g + 8 * r, 8 * n + 2 * q4) = pack_bf16(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
    } else {
      const uint64_t dod = tile_desc<D>(st + 3 * G::TILE);
      float dp[32];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(dp, dod + 2 * j, vd + 2 * j, j);
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);
      keep(dp);
      // p (float32, in sc), delta = Σ_j p·dp, ds = rnd(p·(dp − delta)) (in
      // dp); rnd(p) and ds into their tiles (rows = queries), ds also into
      // the A fragments of dq = ds·k
      uint8_t* ptile = sm + G::PDS;
      uint8_t* dstile = ptile + PTILE;
      uint32_t dsa[4][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
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
        float delta = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            sc[4 * i + 2 * r + c] *= inv;
            delta = fmaf(sc[4 * i + 2 * r + c], dp[4 * i + 2 * r + c], delta);
          }
        delta += __shfl_xor_sync(0xffffffffu, delta, 1);
        delta += __shfl_xor_sync(0xffffffffu, delta, 2);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float* pp = sc + 4 * i + 2 * r;
          const float* dd = dp + 4 * i + 2 * r;
          const uint32_t ds = pack_bf16(pp[0] * (dd[0] - delta), pp[1] * (dd[1] - delta));
          dsa[i >> 1][r + 2 * (i & 1)] = ds;
          *swizzled<64>(dstile, row, 8 * i + 2 * q4) = ds;
          *swizzled<64>(ptile, row, 8 * i + 2 * q4) = pack_bf16(pp[0], pp[1]);
        }
      }
      // dq = ds·k (k MN-major) while the tiles become visible
      float dq[D / 2], dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs<D>(dq, dsa[j], kd + 2 * D * j);
      wgmma_commit();
      fence_proxy_async();
      bar_sync(1, 128);
      // dk = dsᵀ·q and dv = rnd(p)ᵀ·do: the tiles M-major, q and do N-major
      const uint64_t dsd = tile_desc<64>(dstile), pd = tile_desc<64>(ptile);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_ss<D, 1, 1>(dk, dsd + 128 * j, qd + 2 * D * j, j);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_ss<D, 1, 1>(dv, pd + 128 * j, dod + 2 * D * j, j);
      wgmma_commit();
      wgmma_wait<0>();
      keep(dq);
      keep(dk);
      keep(dv);
      keep(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r, col = 8 * n + 2 * q4, k = 4 * n + 2 * r;
          *swizzled<D>(out, row, col) = pack_bf16(dq[k] * p.scale, dq[k + 1] * p.scale);
          *swizzled<D>(out + G::TILE, row, col) = pack_bf16(dk[k], dk[k + 1]);
          *swizzled<D>(out + 2 * G::TILE, row, col) = pack_bf16(dv[k], dv[k + 1]);
        }
    }
    fence_proxy_async();
    bar_sync(1, 128);
    if (tid == 0) {
      int c1, c2;
      tile_at<SM>(p, tile, c1, c2);
      if constexpr (BWD) {
        for (int w = 0; w < 3; ++w) tma_store(&maps.out, out + w * G::TILE, w * p.hd + hh * D, c1, c2);
      } else {
        tma_store(&maps.out, out, hh * D, c1, c2);
      }
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

// the 3-D map of a (tokens, ld) bf16 array over (column, token, sample), box
// (D, t, ns): item-major tokens (b, t, s) as (ld, b·t, s), the token stride
// s·ld, the sample stride ld; sample-major (rows, t) as (ld, t, rows)
template <int D, bool SM>
int rows_map(CUtensorMap* map, const void* base, int ld, int b, int t, int s, int ns) {
  const cuuint64_t row = 2ull * ld;
  if constexpr (SM)
    return make_map_box(map, base, {(cuuint64_t)ld, (cuuint64_t)t, (cuuint64_t)s}, {row, row * t},
                        {(cuuint32_t)D, (cuuint32_t)t, (cuuint32_t)ns});
  return make_map_box(map, base, {(cuuint64_t)ld, (cuuint64_t)b * t, (cuuint64_t)s}, {row * s, row},
                      {(cuuint32_t)D, (cuuint32_t)t, (cuuint32_t)ns});
}

// b members of s samples (item-major), or (SM) s rows with b = 1
template <int D, bool SM, bool BWD>
int launch(const void* qkv, const void* dout, void* out, int b, int t, int s, int h,
           cudaStream_t stream) {
  using G = Geo<D, BWD>;
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return MMPFN_BAD_ARGS;
  Shape p;
  p.t = t;
  p.ns = 64 / t;
  p.h = h;
  p.hd = h * D;
  p.scale = 1.f / sqrtf((float)D);
  const long long per = (s + p.ns - 1) / p.ns, tiles = per * b, items = tiles * h;
  if (items > 0x7ffffff0LL) return MMPFN_BAD_ARGS;
  p.tpm = (int)per;
  p.items = (int)items;
  Maps maps = {};
  int rc = rows_map<D, SM>(&maps.qkv, qkv, 3 * p.hd, b, t, s, p.ns);
  if (!rc && BWD) rc = rows_map<D, SM>(&maps.dout, dout, p.hd, b, t, s, p.ns);
  if (!rc) rc = rows_map<D, SM>(&maps.out, out, (BWD ? 3 : 1) * p.hd, b, t, s, p.ns);
  auto kernel = attn_wg_kernel<D, SM, BWD>;
  if (!rc) rc = mmpfn_allow_smem(kernel, G::SMEM);
  static int blocks = 0;  // resident blocks on the card, for this instantiation
  if (!rc && !blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, G::SMEM);
    if (!err && per_sm < 1) return MMPFN_BAD_ARGS;
    rc = (int)err;
    if (!rc) blocks = sms * per_sm;
  }
  if (rc) return rc;
  kernel<<<(int)std::min<long long>(items, blocks), THREADS, G::SMEM, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace row_wg

// Steps 2 (forward: o from qkv) and 6 (backward: dqkv from qkv and do) over
// b members of s samples (item-major; sample-major: b rows, s = 1): bf16 at
// d = 16, 32, 64 on the wgmma body, everything else on the warp kernels.
// `wgmma` is the body the caller chose (ops/fused.py:feat_attn_bwd_body); a
// choice this build does not make is refused.
template <typename T, int D, bool SM>
int attn_launches(const T* qkv, T* o, const T* dout, T* dqkv, int b, int t, int s, int h,
                  bool wgmma, bool backward, cudaStream_t st) {
  if (wgmma != hopper::on_wgmma<T, D>) return MMPFN_BAD_ARGS;
  if constexpr (hopper::on_wgmma<T, D>) {
    if (SM) s = b, b = 1;
    return backward ? row_wg::launch<D, SM, true>(qkv, dout, dqkv, b, t, s, h, st)
                    : row_wg::launch<D, SM, false>(qkv, nullptr, o, b, t, s, h, st);
  } else {
    const float scale = 1.f / sqrtf((float)D);
    const dim3 grid(b * s, h);
    const size_t smem = attn_smem<D>(t);
    if (smem > MMPFN_MAX_SMEM) return MMPFN_BAD_ARGS;
    if (!backward) {
      int rc = mmpfn_allow_smem(attn_o_kernel<T, D, SM>, smem);
      if (rc) return rc;
      attn_o_kernel<T, D, SM><<<grid, 32, smem, st>>>(qkv, o, t, s, h, scale);
    } else {
      int rc = mmpfn_allow_smem(attn_bwd_kernel<T, D, SM>, smem);
      if (rc) return rc;
      attn_bwd_kernel<T, D, SM><<<grid, 32, smem, st>>>(qkv, dout, dqkv, t, s, h, scale);
    }
    return (int)cudaGetLastError();
  }
}

template <typename T, bool SM>
int attn(const T* qkv, T* o, const T* dout, T* dqkv, int b, int t, int s, int h, int d,
         bool wgmma, bool backward, cudaStream_t st) {
  switch (d) {
    case 8: return attn_launches<T, 8, SM>(qkv, o, dout, dqkv, b, t, s, h, wgmma, backward, st);
    case 16: return attn_launches<T, 16, SM>(qkv, o, dout, dqkv, b, t, s, h, wgmma, backward, st);
    case 32: return attn_launches<T, 32, SM>(qkv, o, dout, dqkv, b, t, s, h, wgmma, backward, st);
    case 64: return attn_launches<T, 64, SM>(qkv, o, dout, dqkv, b, t, s, h, wgmma, backward, st);
    default: return MMPFN_BAD_ARGS;
  }
}

// The whole backward over b rows of t tokens (item-major: b members of s
// samples each; sample-major: s = 1).
template <bool SM>
int backward(const void* x, const void* wqkv, const void* wout, const void* g, void* qkv,
             void* o, float* u, float* du, void* du_c, void* dout, void* dqkv, void* dx,
             float* dwqkv, float* dwout, float* work, int b, int t, int s, int e, int h, int d,
             int wgrad_rows, bool wgmma, int dtype, cudaStream_t st) {
  const long long rows = (long long)b * t * s;
  const int hd = h * d;
  return mmpfn_dispatch(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    const T *X = (const T*)x, *Wqkv = (const T*)wqkv, *Wout = (const T*)wout, *G = (const T*)g;
    T *QKV = (T*)qkv, *O = (T*)o, *DUc = (T*)du_c, *DO = (T*)dout, *DQKV = (T*)dqkv, *DX = (T*)dx;
    int rc;
    if ((rc = gemm::run<T>(X, Wqkv, rows, 3 * hd, e, false, true, 0, gemm::Store<T>{QKV, 3 * hd}, st))) return rc;
    if ((rc = attn<T, SM>(QKV, O, nullptr, nullptr, b, t, s, h, d, wgmma, false, st))) return rc;
    if ((rc = gemm::run<T>(O, Wout, rows, e, hd, false, false, 0, gemm::AddStore<float, T>{u, X, e}, st))) return rc;
    if ((rc = gemm::ln_bwd<T>(u, G, du, DUc, rows, e, st))) return rc;
    if ((rc = gemm::run<T>(DUc, Wout, rows, hd, e, false, true, 0, gemm::Store<T>{DO, hd}, st))) return rc;
    if ((rc = attn<T, SM>(QKV, nullptr, DO, DQKV, b, t, s, h, d, wgmma, true, st))) return rc;
    if ((rc = gemm::run<T>(DQKV, Wqkv, rows, e, 3 * hd, false, false, 0, gemm::AddStore<T, float>{DX, du, e}, st))) return rc;
    if ((rc = gemm::wgrad<T>(DQKV, X, dwqkv, work, rows, 3 * hd, e, wgrad_rows, st))) return rc;
    return gemm::wgrad<T>(O, DUc, dwout, work, rows, hd, e, wgrad_rows, st);
  });
}

}  // namespace

// K7: x and g (b, t, s, e), item-major; wgmma: the per-row attention's body
// (1: the wgmma body, bf16 at d = 16, 32, 64; 0: the warp kernels)
extern "C" int mmpfn_feat_attn_bwd_im(const void* x, const void* wqkv, const void* wout,
                                      const void* g, void* qkv, void* o, float* u, float* du,
                                      void* du_c, void* dout, void* dqkv, void* dx, float* dwqkv,
                                      float* dwout, float* work, int b, int t, int s, int e,
                                      int h, int d, int wgrad_rows, int wgmma, int dtype,
                                      int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (b <= 0 || s <= 0) return 0;
  if (t < 1 || t > 64 || e < 1 || h < 1) return MMPFN_BAD_ARGS;
  return backward<false>(x, wqkv, wout, g, qkv, o, u, du, du_c, dout, dqkv, dx, dwqkv, dwout,
                         work, b, t, s, e, h, d, wgrad_rows, wgmma != 0, dtype,
                         (cudaStream_t)stream);
}

// K7s: x and g (rows, t, e), the tokens of a row contiguous.
extern "C" int mmpfn_feat_attn_bwd(const void* x, const void* wqkv, const void* wout,
                                   const void* g, void* qkv, void* o, float* u, float* du,
                                   void* du_c, void* dout, void* dqkv, void* dx, float* dwqkv,
                                   float* dwout, float* work, int rows, int t, int e, int h, int d,
                                   int wgrad_rows, int wgmma, int dtype, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (t < 1 || t > 64 || e < 1 || h < 1) return MMPFN_BAD_ARGS;
  return backward<true>(x, wqkv, wout, g, qkv, o, u, du, du_c, dout, dqkv, dx, dwqkv, dwout,
                        work, rows, t, 1, e, h, d, wgrad_rows, wgmma != 0, dtype,
                        (cudaStream_t)stream);
}
