// The two passes of a flash attention backward from a saved lse, shared by
// K9 (item_attn_bwd.cu: both regions of the item attention, q, k, v read
// from a packed qkv) and K11 (flash_bwd.cu: separate q, k, v, do of G
// groups). Given, per query row, q, do = dL/do, lse and delta = Σ_d do·o:
//
//   p  = exp(q·k·scale − lse)                  (float32)
//   ds = rnd(p·(dp − delta)·scale),  dp = do·v  (the scale folded in once)
//   dq = Σ_keys ds·k,  dk = Σ_queries ds·q,  dv = Σ_queries rnd(p)·do
//
// with every product accumulated in float32 and dq, dk, dv rounded once to T
// at the end: the rounding points of the Pallas kernels
// (pallas_attention.py:_bwd_kernel, pallas_item_fused.py:_bwd_kernel).
//
// Two passes, no atomics (flash-attention-2's backward): the dq pass gives a
// block its own query rows and streams every key in tiles; the dk/dv pass
// gives a block its own key rows and streams its query segments (several for
// a key head that serves several query heads: the GQA reduction). No two
// blocks write one output, so the results are the same bits on every run.
//
// Where the rows are is the caller's: a geometry type `Geo` tells each
// block, from blockIdx and its number of own rows bm, its rows both as
// pointers with row strides (the CUDA-core bodies) and as coordinates of the
// caller's 3-D tensor maps (group z, row, column; the tensor-core bodies):
//   QRows<T>  dq_rows(bm) const;    the block's query rows (dq pass)
//   KVRows<T> dq_keys(bm) const;    the keys they attend to
//   OutRows<T> dq_out(bm) const;    where their dq goes
//   KVRows<T> dkv_keys(bm) const;   the block's key rows (dk/dv pass)
//   int dkv_segments() const;       how many query segments attend to them
//   QRows<T>  dkv_segment(int) const;
//   OutRows<T> dk_out(bm) const, dv_out(bm) const;
//   dim3 dq_grid(bm) const, dkv_grid(bm) const;   (host) the two grids
// Rows past a count have their weights forced to 0 (lse = +inf, delta = 0),
// so no out-of-range value reaches a sum.
//
// float32 operands (and d = 8) run on the CUDA cores, a thread per row, the
// parity mode. bf16 operands with d = 16, 32, 64 run on Hopper's tensor
// cores, warp-specialised:
//  * a block owns 128 rows, 64 per consumer warpgroup (query rows in the dq
//    pass, key rows in the dk/dv pass), so every streamed tile serves 128;
//  * one producer warp fills a ring of STAGES tiles through TMA (3-D tensor
//    maps, groups × rows × columns, whose bounds zero-fill a group's ragged
//    tail) and mbarriers; in the dk/dv pass its lanes stage each query
//    tile's lse (times log2 e) and delta beside it. The producer warpgroup
//    gives up its registers (setmaxnreg) to the consumers;
//  * the scores and dp are wgmma.m64n64k16 with the own tile (A) and the
//    streamed tile (B, K-major) from shared memory; dq += ds·k,
//    dk += dsᵀ·q and dv += rnd(p)ᵀ·do take p and ds from registers as the A
//    operand (the accumulator layout of the scores is the operand layout of
//    the next product, FlashAttention-3's reuse) and the streamed tile as B
//    with the transpose bit set. The dk/dv pass computes Sᵀ = k·qᵀ directly,
//    so pᵀ and dsᵀ are already in that layout;
//  * tiles lie in shared memory as TMA writes them, each row 2·d bytes under
//    the swizzle of the same span (32, 64 or 128 bytes), which the wgmma
//    descriptors name;
//  * p = exp2(s·scale·log2 e − lse·log2 e): the constant is folded into the
//    scale and into each lse once, and ex2 is one MUFU instruction.
#pragma once

#include "hopper.cuh"

namespace attn_bwd {

using namespace hopper;

constexpr int BR = 64;  // CUDA cores: rows of a block's own tile and of a streamed tile

// n rows from row 0: q of row r at q + r·ldq, do at dout + r·lddo, lse and
// delta at lse[r] and delta[r]; in the tensor maps, rows [row, row + n) of
// group z, q from column qcol, do from column docol
template <typename T>
struct QRows {
  const T* q;
  const T* dout;
  long long ldq, lddo;
  const float* lse;
  const float* delta;
  int n;
  int row, z, qcol, docol;
};

// n rows from row 0: k of row r at k + r·ld, v at v + r·ld; in the tensor
// maps, rows [row, row + n) of group z, k from column kcol, v from vcol
template <typename T>
struct KVRows {
  const T* k;
  const T* v;
  long long ld;
  int n;
  int row, z, kcol, vcol;
};

// D values of output row r at p + r·ld
template <typename T>
struct OutRows {
  T* p;
  long long ld;
};

// ---- CUDA cores (any T, d in 8..64) -----------------------------------------

template <typename T, int D, typename Geo>
__global__ void __launch_bounds__(BR) dq_cc_kernel(Geo geo, float scale) {
  __shared__ __align__(16) float Ks[BR][D];
  __shared__ __align__(16) float Vs[BR][D];
  const int tid = threadIdx.x;
  const QRows<T> qr = geo.dq_rows(BR);
  const KVRows<T> kv = geo.dq_keys(BR);
  const bool active = tid < qr.n;
  float q[D], g[D], dq[D];
  float lse_i = 0.f, delta_i = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) q[c] = g[c] = dq[c] = 0.f;
  if (active) {
    const T* qrow = qr.q + tid * qr.ldq;
    const T* grow = qr.dout + tid * qr.lddo;
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = to_f<T>(qrow[c]), g[c] = to_f<T>(grow[c]);
    lse_i = qr.lse[tid];
    delta_i = qr.delta[tid];
  }
  for (int k0 = 0; k0 < kv.n; k0 += BR) {
    for (int i = tid; i < BR * D; i += BR) {
      const int r = i / D, c = i - r * D, kr = k0 + r;
      const bool ok = kr < kv.n;
      Ks[r][c] = ok ? to_f<T>(kv.k[kr * kv.ld + c]) : 0.f;
      Vs[r][c] = ok ? to_f<T>(kv.v[kr * kv.ld + c]) : 0.f;
    }
    __syncthreads();
    if (active) {
      const int nk = min(BR, kv.n - k0);
      for (int j = 0; j < nk; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 kq = *reinterpret_cast<const float4*>(&Ks[j][c]);
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][c]);
          s = fmaf(q[c], kq.x, fmaf(q[c + 1], kq.y, fmaf(q[c + 2], kq.z, fmaf(q[c + 3], kq.w, s))));
          dp = fmaf(g[c], vv.x, fmaf(g[c + 1], vv.y, fmaf(g[c + 2], vv.z, fmaf(g[c + 3], vv.w, dp))));
        }
        const float p = expf(s * scale - lse_i);
        const float ds = round_t<T>(p * (dp - delta_i) * scale);
#pragma unroll
        for (int c = 0; c < D; ++c) dq[c] = fmaf(ds, Ks[j][c], dq[c]);
      }
    }
    __syncthreads();
  }
  if (active) {
    const OutRows<T> out = geo.dq_out(BR);
    T* dst = out.p + tid * out.ld;
#pragma unroll
    for (int c = 0; c < D; ++c) dst[c] = from_f<T>(dq[c]);
  }
}

template <typename T, int D, typename Geo>
__global__ void __launch_bounds__(BR) dkv_cc_kernel(Geo geo, float scale) {
  __shared__ __align__(16) float Qs[BR][D];
  __shared__ __align__(16) float Gs[BR][D];
  __shared__ float LSE[BR], DL[BR];
  const int tid = threadIdx.x;
  const KVRows<T> own = geo.dkv_keys(BR);
  const bool active = tid < own.n;
  float k[D], v[D], dk[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) k[c] = v[c] = dk[c] = dv[c] = 0.f;
  if (active) {
#pragma unroll
    for (int c = 0; c < D; ++c)
      k[c] = to_f<T>(own.k[tid * own.ld + c]), v[c] = to_f<T>(own.v[tid * own.ld + c]);
  }
  const int nseg = geo.dkv_segments();
  for (int sg = 0; sg < nseg; ++sg) {
    const QRows<T> qs = geo.dkv_segment(sg);
    for (int q0 = 0; q0 < qs.n; q0 += BR) {
      for (int i = tid; i < BR * D; i += BR) {
        const int r = i / D, c = i - r * D, qr = q0 + r;
        const bool ok = qr < qs.n;
        Qs[r][c] = ok ? to_f<T>(qs.q[qr * qs.ldq + c]) : 0.f;
        Gs[r][c] = ok ? to_f<T>(qs.dout[qr * qs.lddo + c]) : 0.f;
      }
      {
        const int qr = q0 + tid;
        LSE[tid] = qr < qs.n ? qs.lse[qr] : INFINITY;  // weight 0 past the segment
        DL[tid] = qr < qs.n ? qs.delta[qr] : 0.f;
      }
      __syncthreads();
      const int nq = min(BR, qs.n - q0);
      for (int i = 0; i < nq; ++i) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(&Qs[i][c]);
          const float4 gv = *reinterpret_cast<const float4*>(&Gs[i][c]);
          s = fmaf(k[c], qv.x, fmaf(k[c + 1], qv.y, fmaf(k[c + 2], qv.z, fmaf(k[c + 3], qv.w, s))));
          dp = fmaf(v[c], gv.x, fmaf(v[c + 1], gv.y, fmaf(v[c + 2], gv.z, fmaf(v[c + 3], gv.w, dp))));
        }
        const float p = expf(s * scale - LSE[i]);
        const float pr = round_t<T>(p);
        const float ds = round_t<T>(p * (dp - DL[i]) * scale);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          dv[c] = fmaf(pr, Gs[i][c], dv[c]);
          dk[c] = fmaf(ds, Qs[i][c], dk[c]);
        }
      }
      __syncthreads();
    }
  }
  if (active) {
    const OutRows<T> ko = geo.dk_out(BR), vo = geo.dv_out(BR);
    T* dkr = ko.p + tid * ko.ld;
    T* dvr = vo.p + tid * vo.ld;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dkr[c] = from_f<T>(dk[c]);
      dvr[c] = from_f<T>(dv[c]);
    }
  }
}

// ---- tensor cores (bf16, d = 16, 32, 64): TMA ring and wgmma ---------------

constexpr int BM = 128;           // own rows of a block, 64 per consumer warpgroup
constexpr int STAGES = 3;         // depth of the tile ring
constexpr int WG_THREADS = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMER_WARPS = 8;

// The caller's tensor maps of q, k, v and do (K9: q, k, v are one map of the
// packed qkv), passed to the kernels as a __grid_constant__ parameter.
struct Maps {
  CUtensorMap q, k, v, dout;
};

// Dynamic shared memory of both passes, from a 1024-byte aligned base: the
// own tiles A (q or k) and B (do or v), 128 rows each; the ring of STAGES
// stages, each a tile X (k or q) and a tile Y (v or do); per stage the
// streamed rows' lse·log2 e and delta (dk/dv pass); the mbarriers.
template <int D>
struct SmemPlan {
  static constexpr int TILE = BN * D * 2;  // bytes of a 64-row tile
  static constexpr int OWN_A = 0, OWN_B = 2 * TILE, RING = 4 * TILE, STAGE = 2 * TILE;
  static constexpr int VEC = RING + STAGES * STAGE;       // float [STAGES][2][BN]
  static constexpr int BARS = VEC + STAGES * 2 * BN * 4;  // full[STAGES], empty[STAGES], own
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// dq pass: a block owns 128 query rows; the ring streams the keys' k (X) and
// v (Y) tiles.
template <int D, typename Geo>
__global__ void __launch_bounds__(WG_THREADS, 1)
    dq_wg_kernel(const __grid_constant__ Maps maps, Geo geo, float scale) {
  using P = SmemPlan<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = ring_smem(smem_raw, P::BARS, STAGES, 1, CONSUMER_WARPS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const QRows<__nv_bfloat16> qr = geo.dq_rows(BM);
  const KVRows<__nv_bfloat16> kv = geo.dq_keys(BM);
  const int ntiles = (kv.n + BN - 1) / BN;

  if (wg == 2) {  // producer
    producer_registers();
    if (tid == 256) {
      mbar_arrive_tx(own, 4 * P::TILE);
      for (int h = 0; h < 2; ++h) {
        tma_load(sm + P::OWN_A + h * P::TILE, &maps.q, own, qr.qcol, qr.row + h * BN, qr.z);
        tma_load(sm + P::OWN_B + h * P::TILE, &maps.dout, own, qr.docol, qr.row + h * BN, qr.z);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, round = t / STAGES;
        if (round) mbar_wait(empty + s, (round - 1) & 1);
        uint8_t* st = sm + P::RING + s * P::STAGE;
        mbar_arrive_tx(full + s, 2 * P::TILE);
        tma_load(st, &maps.k, full + s, kv.kcol, kv.row + t * BN, kv.z);
        tma_load(st + P::TILE, &maps.v, full + s, kv.vcol, kv.row + t * BN, kv.z);
      }
    }
  } else {  // consumers: warpgroup wg owns rows [64·wg, 64·wg + 64) of the block
    consumer_registers();
    const int lane = tid & 31, g = lane >> 2, q4 = lane & 3;
    const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // and row0 + 8
    const bool busy = wg * 64 < qr.n;
    const float sl2 = scale * LOG2E;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < qr.n ? qr.lse[row] * LOG2E : INFINITY;  // weight 0 past the rows
      dl[r] = row < qr.n ? qr.delta[row] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(own, 0);
    const uint64_t qd = tile_desc<D>(sm + P::OWN_A + wg * P::TILE);
    const uint64_t gd = tile_desc<D>(sm + P::OWN_B + wg * P::TILE);
    // Each tile waits for its scores, then for its dq product; issuing tile
    // t's product with tile t + 1's scores measured slower on the H100.
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(full + s, (t / STAGES) & 1);
      if (busy) {
        const uint8_t* st = sm + P::RING + s * P::STAGE;
        const uint64_t kd = tile_desc<D>(st), vd = tile_desc<D>(st + P::TILE);
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(sc, qd + 2 * j, kd + 2 * j, j);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(dp, gd + 2 * j, vd + 2 * j, j);
        wgmma_commit();
        wgmma_wait_all();
        keep(sc);
        keep(dp);
        const int lim = kv.n - t * BN;  // keys of this tile
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float ds[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float p = 8 * i + 2 * q4 + c < lim ? ex2(sc[4 * i + 2 * r + c] * sl2 - lse2[r]) : 0.f;
              ds[c] = p * (dp[4 * i + 2 * r + c] - dl[r]) * scale;
            }
            a[i >> 1][r + 2 * (i & 1)] = pack_bf16(ds[0], ds[1]);
          }
        wgmma_fence();
        keep(dq);
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_rs<D>(dq, a[j], kd + 2 * D * j);
        wgmma_commit();
        wgmma_wait_all();
        keep(dq);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    if (busy) {
      const OutRows<__nv_bfloat16> out = geo.dq_out(BM);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= qr.n) continue;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          store2(out.p + row * out.ld + 8 * i + 2 * q4, dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
      }
    }
  }
}

// dk/dv pass: a block owns 128 key rows; the ring streams the query
// segments' q (X) and do (Y) tiles with their lse·log2 e and delta.
template <int D, typename Geo>
__global__ void __launch_bounds__(WG_THREADS, 1)
    dkv_wg_kernel(const __grid_constant__ Maps maps, Geo geo, float scale) {
  using P = SmemPlan<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = ring_smem(smem_raw, P::BARS, STAGES, 32, CONSUMER_WARPS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;
  float* vec = reinterpret_cast<float*>(sm + P::VEC);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const KVRows<__nv_bfloat16> kr = geo.dkv_keys(BM);
  const int nseg = geo.dkv_segments();

  if (wg == 2) {  // producer: warp 8 stages every query tile of every segment
    producer_registers();
    if (tid < 256 + 32) {
      if (lane == 0) {
        mbar_arrive_tx(own, 4 * P::TILE);
        for (int h = 0; h < 2; ++h) {
          tma_load(sm + P::OWN_A + h * P::TILE, &maps.k, own, kr.kcol, kr.row + h * BN, kr.z);
          tma_load(sm + P::OWN_B + h * P::TILE, &maps.v, own, kr.vcol, kr.row + h * BN, kr.z);
        }
      }
      int t = 0;
      for (int sg = 0; sg < nseg; ++sg) {
        const QRows<__nv_bfloat16> qs = geo.dkv_segment(sg);
        for (int q0 = 0; q0 < qs.n; q0 += BN, ++t) {
          const int s = t % STAGES, round = t / STAGES;
          if (round) mbar_wait(empty + s, (round - 1) & 1);
          float* L = vec + s * 2 * BN;
          for (int i = lane; i < BN; i += 32) {
            const bool ok = q0 + i < qs.n;
            L[i] = ok ? qs.lse[q0 + i] * LOG2E : INFINITY;  // weight 0 past the segment
            L[BN + i] = ok ? qs.delta[q0 + i] : 0.f;
          }
          if (lane == 0) {
            uint8_t* st = sm + P::RING + s * P::STAGE;
            mbar_arrive_tx(full + s, 2 * P::TILE);
            tma_load(st, &maps.q, full + s, qs.qcol, qs.row + q0, qs.z);
            tma_load(st + P::TILE, &maps.dout, full + s, qs.docol, qs.row + q0, qs.z);
          } else {
            mbar_arrive(full + s);
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns key rows [64·wg, 64·wg + 64) of the block
    consumer_registers();
    const int g = lane >> 2, q4 = lane & 3;
    const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // and row0 + 8
    const bool busy = wg * 64 < kr.n;
    const float sl2 = scale * LOG2E;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(own, 0);
    const uint64_t kd = tile_desc<D>(sm + P::OWN_A + wg * P::TILE);
    const uint64_t vd = tile_desc<D>(sm + P::OWN_B + wg * P::TILE);
    int t = 0;
    for (int sg = 0; sg < nseg; ++sg) {
      const int nq = geo.dkv_segment(sg).n;
      for (int q0 = 0; q0 < nq; q0 += BN, ++t) {
        const int s = t % STAGES;
        mbar_wait(full + s, (t / STAGES) & 1);
        if (busy) {
          const uint8_t* st = sm + P::RING + s * P::STAGE;
          const uint64_t qd = tile_desc<D>(st), gd = tile_desc<D>(st + P::TILE);
          const float* L = vec + s * 2 * BN;
          float lse2[16], dl[16];  // of this thread's query columns 8i + 2·q4 + c
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float2 a = *reinterpret_cast<const float2*>(L + 8 * i + 2 * q4);
            const float2 b = *reinterpret_cast<const float2*>(L + BN + 8 * i + 2 * q4);
            lse2[2 * i] = a.x, lse2[2 * i + 1] = a.y, dl[2 * i] = b.x, dl[2 * i + 1] = b.y;
          }
          float sc[32], dp[32];  // keys × queries
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(sc, kd + 2 * j, qd + 2 * j, j);
#pragma unroll
          for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(dp, vd + 2 * j, gd + 2 * j, j);
          wgmma_commit();
          wgmma_wait_all();
          keep(sc);
          keep(dp);
          uint32_t pa[4][4], da[4][4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float p[2], ds[2];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                p[c] = ex2(sc[4 * i + 2 * r + c] * sl2 - lse2[2 * i + c]);
                ds[c] = p[c] * (dp[4 * i + 2 * r + c] - dl[2 * i + c]) * scale;
              }
              pa[i >> 1][r + 2 * (i & 1)] = pack_bf16(p[0], p[1]);
              da[i >> 1][r + 2 * (i & 1)] = pack_bf16(ds[0], ds[1]);
            }
          wgmma_fence();
          keep(dk);
          keep(dv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wgmma_rs<D>(dv, pa[j], gd + 2 * D * j);
            wgmma_rs<D>(dk, da[j], qd + 2 * D * j);
          }
          wgmma_commit();
          wgmma_wait_all();
          keep(dk);
          keep(dv);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
    }
    if (busy) {
      const OutRows<__nv_bfloat16> ko = geo.dk_out(BM), vo = geo.dv_out(BM);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= kr.n) continue;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          store2(ko.p + row * ko.ld + 8 * i + 2 * q4, dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
          store2(vo.p + row * vo.ld + 8 * i + 2 * q4, dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
        }
      }
    }
  }
}

// Both passes on `st`, returning the CUDA error code of the launches. `maps`
// is read only on the tensor-core path (on_wgmma<T, D>).
template <typename T, int D, typename Geo>
int passes(const Geo& geo, const Maps& maps, float scale, cudaStream_t st) {
  if constexpr (on_wgmma<T, D>) {
    constexpr int bytes = SmemPlan<D>::BYTES;
    int rc = mmpfn_allow_smem(dq_wg_kernel<D, Geo>, bytes);
    if (!rc) rc = mmpfn_allow_smem(dkv_wg_kernel<D, Geo>, bytes);
    if (rc) return rc;
    dq_wg_kernel<D, Geo><<<geo.dq_grid(BM), WG_THREADS, bytes, st>>>(maps, geo, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
    dkv_wg_kernel<D, Geo><<<geo.dkv_grid(BM), WG_THREADS, bytes, st>>>(maps, geo, scale);
  } else {
    dq_cc_kernel<T, D, Geo><<<geo.dq_grid(BR), BR, 0, st>>>(geo, scale);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    dkv_cc_kernel<T, D, Geo><<<geo.dkv_grid(BR), BR, 0, st>>>(geo, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd
