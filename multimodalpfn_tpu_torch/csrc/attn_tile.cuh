// Online-softmax attention of query rows against a stream of K/V rows, the
// tile loop shared by K2a (item_attn.cu) and K4 (flash_fwd.cu).
//
// The rounding is the Pallas kernels': scores q·k accumulate in float32 and
// are scaled in float32; the unnormalized weights exp(s - m) are rounded to
// the operand type before the P·V product; their sum and the output stay
// float32. Keys at or past the key count are masked by index, so no
// out-of-range value reaches a sum. K/V stream from device memory through
// shared memory, so the key count has no shared-memory ceiling.
//
// Two bodies:
//  * cc_rows, float32 operands (or bf16 at d = 8) on the CUDA cores, the
//    parity mode: each caller loads its query rows, calls it with pointers
//    to the first K and V row and the row stride, and normalizes and stores;
//  * fwd_wg_kernel, bf16 operands at d = 16, 32, 64 on Hopper's tensor
//    cores: a warp-specialised kernel fed by TMA, with a geometry type per
//    caller (below).
#pragma once

#include "hopper.cuh"

namespace attn {

// ---- float32 operands (or any T) on the CUDA cores -------------------------
// A thread owns one query row: its q and its float32 output accumulator live
// in registers, K/V tiles of BKV rows are staged in shared memory (as float)
// and read as broadcasts, and the softmax updates once per SUB keys.
constexpr int BQ = 64;   // query rows per block (one per thread)
constexpr int BKV = 64;  // K/V rows per shared-memory tile
constexpr int SUB = 16;  // keys per online-softmax update

// All BQ threads of the block call this (they stage the tiles together). q is
// the thread's query row (zero for a row past the end), K row j is
// k[j * ld, j * ld + D), V row j likewise from v. On return acc is the
// unnormalized output, m the row maximum of the scores and l the sum of the
// weights exp(s - m).
template <typename T, int D>
__device__ __forceinline__ void cc_rows(const float (&q)[D], const T* __restrict__ k,
                                        const T* __restrict__ v, long long ld, int nkv,
                                        float scale, float (&Ks)[BKV][D], float (&Vs)[BKV][D],
                                        float (&acc)[D], float& m, float& l) {
  const int tid = threadIdx.x;
  m = -INFINITY;
  l = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < nkv; k0 += BKV) {
    for (int i = tid; i < BKV * D; i += BQ) {
      const int r = i / D, c = i - r * D;
      const int kr = k0 + r;
      const bool ok = kr < nkv;
      Ks[r][c] = ok ? to_f<T>(k[(long long)kr * ld + c]) : 0.f;
      Vs[r][c] = ok ? to_f<T>(v[(long long)kr * ld + c]) : 0.f;
    }
    __syncthreads();
    const int nk = min(BKV, nkv - k0);
    for (int j0 = 0; j0 < nk; j0 += SUB) {
      float sc[SUB];
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float* kr = Ks[j0 + jj];
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + c);
          a = fmaf(q[c], kv.x, fmaf(q[c + 1], kv.y, fmaf(q[c + 2], kv.z, fmaf(q[c + 3], kv.w, a))));
        }
        sc[jj] = j0 + jj < nk ? a * scale : -1e30f;
        mt = fmaxf(mt, sc[jj]);
      }
      const float m_new = fmaxf(m, mt);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = expf(sc[jj] - m_new);
        l += p;
        const float pr = round_t<T>(p);
        const float* vr = Vs[j0 + jj];
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + c);
          acc[c] = fmaf(pr, vv.x, acc[c]);
          acc[c + 1] = fmaf(pr, vv.y, acc[c + 1]);
          acc[c + 2] = fmaf(pr, vv.z, acc[c + 2]);
          acc[c + 3] = fmaf(pr, vv.w, acc[c + 3]);
        }
      }
      m = m_new;
    }
    __syncthreads();
  }
}

// ---- bf16 operands on Hopper's tensor cores (d = 16, 32, 64) ---------------
// What bounds it: at d = 32 each (query, key) pair costs 4·d = 128
// tensor-core FLOPs and one exponential, and the SFU's 16 ex2 a clock per SM
// take twice as long as the products. So the design keeps the SFU busy:
//  * a block owns 64 query rows per consumer warpgroup, three of them at
//    d <= 32 (192 rows; registers allow it) and two at d = 64, so that
//    every streamed K/V tile serves them all and three warps share each
//    SM sub-partition's SFU;
//  * one producer warp fills a ring of STAGES K/V tiles of KB = 128 keys
//    through TMA (3-D tensor maps, groups × rows × columns, swizzled for
//    wgmma; a tile is two boxes of 64 rows back to back) and mbarriers; the
//    producer warpgroup gives its registers to the consumers (setmaxnreg);
//  * scores S = q·kᵀ are wgmma.m64n64k16 with q (A) and the K tile (B,
//    K-major) from shared memory; O += rnd(P)·V takes P from registers as
//    the A operand (the score accumulator layout is the A-fragment layout)
//    and the V tile as B with the transpose bit set;
//  * the softmax runs on the accumulator fragments, in log2 units: each
//    score costs one FFMA (s·scale·log2 e − m) and one ex2.approx (one MUFU
//    instruction), the rescale factor one ex2 per row and tile; lse =
//    (m + log2 l)·ln 2 in float32; only the last, partial tile pays for the
//    key mask;
//  * the warpgroups issue their score products in turn (ordered ping-pong
//    on named barriers, FlashAttention-3's schedule), so that one
//    warpgroup's products run under the others' softmax; each warpgroup
//    waits for its scores, exponentiates, then waits for its P·V. Issuing
//    tile t + 1's scores with tile t's P·V (intra-warpgroup overlap), 64-key
//    tiles, two consumer warpgroups at d = 32, and part of the
//    exponentials on the FMA pipe (FlashAttention-4's polynomial) each
//    measured slower on the H100.
// Rows: a geometry type `Geo` of the caller tells each block, from blockIdx
// and its number of rows bm, where its rows lie:
//   QTile<O> q_tile(bm) const;   the block's query rows and their outputs
//   KeyRows keys(bm) const;      the keys they attend to
//   dim3 grid(bm) const;         (host) the grid
constexpr int KB = 128;    // keys of a streamed tile
constexpr int STAGES = 4;  // depth of the K/V ring

// A block: CW consumer warpgroups of 64 query rows each, then one producer
// warpgroup; the registers a thread keeps after setmaxnreg, the producer's
// and the consumers' (the split fills the SM's 64K registers: one block an
// SM).
template <int D>
struct Cfg {
  static constexpr int CW = D <= 32 ? 3 : 2;
  static constexpr int WM = 64 * CW;  // query rows of a block
  static constexpr int THREADS = 128 * (CW + 1);
  static constexpr int PRODUCER_REGS = CW == 2 ? 40 : 24;
  static constexpr int CONSUMER_REGS = (65536 - 128 * PRODUCER_REGS) / (128 * CW) / 8 * 8;
};

// The caller's tensor maps of q, k and v (K2a: one map of the packed qkv),
// passed to the kernel as a __grid_constant__ parameter.
struct Maps {
  CUtensorMap q, k, v;
};

// The block's query rows: n rows (at most bm; the others are computed and
// never stored) from row `row` of group z of the q map, from column col;
// the output of row r at o + r·ldo (D values) and its lse at lse[r].
template <typename O>
struct QTile {
  O* o;
  long long ldo;
  float* lse;
  int n, row, z, col;
};

// The keys of a block's rows: n rows from row `row` of group z of the k and
// v maps, k from column kcol, v from vcol. A box past n reads zeros or real
// rows that are not keys; both are masked by index.
struct KeyRows {
  int n, row, z, kcol, vcol;
};

// Dynamic shared memory from a 1024-byte aligned base: the block's q tiles
// (64 rows each), the ring of STAGES stages (KB rows of K, then KB of V, as
// boxes of 64 rows back to back), the mbarriers.
template <int D>
struct FwdSmem {
  static constexpr int TILE = hopper::BN * D * 2;  // bytes of a 64-row box
  static constexpr int HALVES = KB / hopper::BN;   // boxes of a K (or V) tile
  static constexpr int Q = 0, RING = Cfg<D>::CW * TILE, STAGE = 2 * HALVES * TILE;
  static constexpr int BARS = RING + STAGES * STAGE;  // full[STAGES], empty[STAGES], own
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// v[0] = the maximum (tree_max) or the sum (tree_sum) of v[0, 2W), as a
// tree of depth log2 2W; recursion on W keeps every index a constant, so v
// stays in registers
template <int W, int N>
__device__ __forceinline__ void tree_max(float (&v)[N]) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = fmaxf(v[k], v[k + W]);
    tree_max<W / 2>(v);
  }
}
template <int W, int N>
__device__ __forceinline__ void tree_sum(float (&v)[N]) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] += v[k + W];
    tree_sum<W / 2>(v);
  }
}

// One tile's online-softmax step on the score accumulators sc (KB keys as
// H = KB / 64 products of 64 columns) of the thread's rows r = 0, 1 (layout:
// hopper.cuh), in log2 units: with MASK, keys at or past `lim` are masked;
// m[r] becomes the running maximum of s·scale·log2 e, alpha[r] =
// 2^(m_old − m_new) the factor that rescales what was summed before; the
// weights p = 2^(s·sl2 − m) are summed into l (float32, after l·alpha) and
// rounded to bf16 into pa, the A fragments of P·V. Maxima and sums are
// trees, for short dependency chains.
template <int H, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[H][32], int lim, float sl2, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             uint32_t (&pa)[4 * H][4]) {
  const int q4 = threadIdx.x & 3;
  if constexpr (MASK) {
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (64 * h + 8 * i + 2 * q4 + c >= lim) sc[h][4 * i + c] = sc[h][4 * i + 2 + c] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[8 * H];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i) v[8 * h + i] = fmaxf(sc[h][4 * i + 2 * r], sc[h][4 * i + 2 * r + 1]);
    tree_max<4 * H>(v);
    float mx = fmaxf(v[0], __shfl_xor_sync(0xffffffffu, v[0], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * sl2);  // sl2 > 0: the maximum commutes with the scale
    alpha[r] = hopper::ex2(m[r] - m_new);
    m[r] = m_new;
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p0 = hopper::ex2(fmaf(sc[h][4 * i + 2 * r], sl2, -m_new));
        const float p1 = hopper::ex2(fmaf(sc[h][4 * i + 2 * r + 1], sl2, -m_new));
        v[8 * h + i] = p0 + p1;
        pa[4 * h + (i >> 1)][r + 2 * (i & 1)] = pack_bf16(p0, p1);
      }
    tree_sum<4 * H>(v);
    l[r] = fmaf(l[r], alpha[r], v[0]);
  }
}

template <int D, typename Geo>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    fwd_wg_kernel(const __grid_constant__ Maps maps, Geo geo, float scale) {
  using namespace hopper;
  using P = FwdSmem<D>;
  using C = Cfg<D>;
  constexpr int H = P::HALVES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = ring_smem(smem_raw, P::BARS, STAGES, 1, 4 * C::CW);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const auto qt = geo.q_tile(C::WM);
  const KeyRows kv = geo.keys(C::WM);
  const int ntiles = (kv.n + KB - 1) / KB;

  if (wg == C::CW) {  // producer
    producer_registers<C::PRODUCER_REGS>();
    if (tid == 128 * C::CW) {
      mbar_arrive_tx(own, C::CW * P::TILE);
      for (int w = 0; w < C::CW; ++w)
        tma_load(sm + P::Q + w * P::TILE, &maps.q, own, qt.col, qt.row + w * BN, qt.z);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, round = t / STAGES;
        if (round) mbar_wait(empty + s, (round - 1) & 1);
        uint8_t* st = sm + P::RING + s * P::STAGE;
        mbar_arrive_tx(full + s, P::STAGE);
        for (int h = 0; h < H; ++h) {
          tma_load(st + h * P::TILE, &maps.k, full + s, kv.kcol, kv.row + t * KB + h * BN, kv.z);
          tma_load(st + (H + h) * P::TILE, &maps.v, full + s, kv.vcol, kv.row + t * KB + h * BN, kv.z);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns query rows [64·wg, 64·wg + 64) of the block
    consumer_registers<C::CONSUMER_REGS>();
    const int lane = tid & 31, q4 = lane & 3;
    const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // and row0 + 8
    mbar_wait(own, 0);
    if (wg * 64 < qt.n) {
      const uint64_t qd = tile_desc<D>(sm + P::Q + wg * P::TILE);
      const float sl2 = scale * LOG2E;
      float sc[H][32], o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      uint32_t pa[4 * H][4];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      // the warpgroups issue their score products in turn (named barrier
      // 1 + w is warpgroup w's), where all of them have rows; the last
      // opens the first turn and leaves no turn open after its last tile
      const bool pingpong = qt.n > 64 * (C::CW - 1);
      if (pingpong && wg == C::CW - 1) bar_arrive(1, 256);
      for (int t = 0; t < ntiles; ++t) {
        uint8_t* st = sm + P::RING + (t % STAGES) * P::STAGE;
        mbar_wait(full + t % STAGES, (t / STAGES) & 1);
        if (pingpong) bar_sync(1 + wg, 256);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const uint64_t kd = tile_desc<D>(st + h * P::TILE);
#pragma unroll
          for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(sc[h], qd + 2 * j, kd + 2 * j, j);
        }
        wgmma_commit();
        if (pingpong && !(wg == C::CW - 1 && t == ntiles - 1)) bar_arrive(1 + (wg + 1) % C::CW, 256);
        wgmma_wait_all();
#pragma unroll
        for (int h = 0; h < H; ++h) keep(sc[h]);
        const int lim = kv.n - t * KB;  // keys of this tile
        if (lim < KB)
          softmax_tile<H, true>(sc, lim, sl2, m, l, alpha, pa);
        else
          softmax_tile<H, false>(sc, lim, sl2, m, l, alpha, pa);
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[4 * i + c] *= alpha[c >> 1];
        wgmma_fence();
        keep(o);
        const uint64_t vd = tile_desc<D>(st + H * P::TILE);
#pragma unroll
        for (int j = 0; j < 4 * H; ++j) wgmma_rs<D>(o, pa[j], vd + 2 * D * j);
        wgmma_commit();
        wgmma_wait_all();
        keep(o);
        keep(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + t % STAGES);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = row0 + 8 * r;
        if (row >= qt.n) continue;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          store2(qt.o + row * qt.ldo + 8 * i + 2 * q4, o[4 * i + 2 * r] / l[r],
                 o[4 * i + 2 * r + 1] / l[r]);
        if (q4 == 0) qt.lse[row] = (m[r] + log2f(l[r])) * LN2;
      }
    } else {  // no rows of this warpgroup: release each tile as it arrives
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(full + t % STAGES, (t / STAGES) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + t % STAGES);
      }
    }
  }
}

// The kernel on `st` over the caller's maps, returning the CUDA error code
// of the launch.
template <int D, typename Geo>
int fwd_wg(const Geo& geo, const Maps& maps, float scale, cudaStream_t st) {
  constexpr int bytes = FwdSmem<D>::BYTES;
  if (const int rc = mmpfn_allow_smem(fwd_wg_kernel<D, Geo>, bytes)) return rc;
  fwd_wg_kernel<D, Geo><<<geo.grid(Cfg<D>::WM), Cfg<D>::THREADS, bytes, st>>>(maps, geo, scale);
  return (int)cudaGetLastError();
}

}  // namespace attn
