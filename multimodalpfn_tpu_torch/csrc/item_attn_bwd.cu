// K9: the backward of K2a's item attention over x (G, S, e), whose first `sep`
// rows are train rows, given do = dL/do (G, S, h·d), the per-head delta =
// Σ_d do·o and the forward's lse (G, h, S), and dx_epi, the cotangent of x
// through the sublayer's residual (K10's du):
//   returns dx = dx_epi + the attention's cotangent of x, in x's type, and
//   the float32 dW of the extended weight rows [W_q; W_k; W_v; W_k0; W_v0]
//   ((3·h·d + 2·d) × e); the caller adds the last two blocks into head 0 of
//   W_k and W_v.
//
// Replaces multimodalpfn_tpu/ops/pallas_item_fused.py:_bwd_kernel
// (pallas_call in _bwd_region, :439/:465, called for both regions by
// _attn_bwd_impl :551).
//
// The two regions (the reference two-block attention, layer.py:341-395):
//  * self: train query rows against train keys, head by head;
//  * cross: test query rows against train keys through KV head 0 for every
//    query head, so a train row's dk, dv of head 0 sum over all six query
//    heads' test rows, and test rows, never keys, get no dk, dv.
// A train row's dx sums the self region's q side and kv side and the cross
// region's kv side: the three blocks of columns of dqkv below.
//
// What bounds it on the H100: the attention FLOPs, seven products of 2·d
// FLOPs per (query, key, head) (158 GFLOP in the self region at the flagship
// fine-tune shape, G = 30, S = 1838, sep = 1655, h = 6, d = 32, 17 in the
// cross region), then 37 GFLOP of projections.
//
// Design (flash-attention-2's backward, two passes, no atomics):
//  1. qkv = x·W^T, rounded to T (the forward's projection, recomputed);
//  2. dq pass: a block owns 64 query rows of one (group, head) and streams
//     the train K/V in tiles of 64: p = exp(q·k·scale − lse) from the saved
//     lse, dp = do·v, ds = rnd(p·(dp − delta)·scale), dq += ds·k; dq is
//     rounded once at the end. Query tiles never straddle `sep`; a test tile
//     reads KV head 0;
//  3. dk/dv pass: a block owns 64 train key rows of one (group, head), or of
//     KV head 0 for the cross region, and streams the query tiles (all six
//     heads' test rows for the cross region): dv += rnd(p)·do,
//     dk += ds·q, each rounded once at the end;
//  4. dx = dx_epi + dqkv·W_ext, rounded to T, with dqkv = [dq | dk, dv of the
//     self region | dk, dv of the cross region] (G·S, 3·h·d + 2·d);
//  5. dW_ext = dqkv^T·x over row chunks, float32 slabs summed in order.
// The rounding points are the Pallas kernel's: p, ds, dk/dv, dq
// (:327, :335, :382-386, :418). Keys past `sep` and queries past their
// region are zero-filled on load (and their weights forced to 0), so no
// out-of-range value reaches a sum. float32 operands (and d = 8) run both
// passes on the CUDA cores, a thread per row; bf16 operands with d a multiple
// of 16 run them on the tensor cores (mma.sync m16n8k16), a warp per 16 rows.
#include "gemm_tile.cuh"

namespace {

constexpr int BR = 64;  // rows of a block's own tile and of a streamed tile

// Region bookkeeping shared by both passes: the query tiles of the self
// region come first, then those of the test rows.
struct Layout {
  int S, sep, h, hd, ld_ext;  // ld_ext = 3·h·d + 2·d
  __device__ __forceinline__ int n_train_tiles() const { return (sep + BR - 1) / BR; }
};

// ---- CUDA cores (any T, d in 8..64) -----------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(BR)
dq_cc_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dqkv, Layout L, float scale) {
  __shared__ __align__(16) float Ks[BR][D];
  __shared__ __align__(16) float Vs[BR][D];
  const int tile = blockIdx.x, hh = blockIdx.y, gi = blockIdx.z, tid = threadIdx.x;
  const int ntr = L.n_train_tiles();
  const bool cross = tile >= ntr;
  const int q0 = cross ? L.sep + (tile - ntr) * BR : tile * BR;
  const int qend = cross ? L.S : L.sep;
  const int kvh = cross ? 0 : hh;
  const int qi = q0 + tid;
  const bool active = qi < qend;
  const long long base = (long long)gi * L.S;
  float q[D], g[D], dq[D];
  float lse_i = 0.f, delta_i = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) q[c] = g[c] = dq[c] = 0.f;
  if (active) {
    const T* qr = qkv + (base + qi) * 3 * L.hd + hh * D;
    const T* gr = dout + (base + qi) * L.hd + hh * D;
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = to_f<T>(qr[c]), g[c] = to_f<T>(gr[c]);
    lse_i = lse[((long long)gi * L.h + hh) * L.S + qi];
    delta_i = delta[((long long)gi * L.h + hh) * L.S + qi];
  }
  for (int k0 = 0; k0 < L.sep; k0 += BR) {
    for (int i = tid; i < BR * D; i += BR) {
      const int r = i / D, c = i - r * D, kr = k0 + r;
      const bool ok = kr < L.sep;
      const T* row = qkv + (base + kr) * 3 * L.hd + kvh * D + c;
      Ks[r][c] = ok ? to_f<T>(row[L.hd]) : 0.f;
      Vs[r][c] = ok ? to_f<T>(row[2 * L.hd]) : 0.f;
    }
    __syncthreads();
    if (active) {
      const int nk = min(BR, L.sep - k0);
      for (int j = 0; j < nk; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(&Ks[j][c]);
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][c]);
          s = fmaf(q[c], kv.x, fmaf(q[c + 1], kv.y, fmaf(q[c + 2], kv.z, fmaf(q[c + 3], kv.w, s))));
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
    T* dst = dqkv + (base + qi) * L.ld_ext + hh * D;
#pragma unroll
    for (int c = 0; c < D; ++c) dst[c] = from_f<T>(dq[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BR)
dkv_cc_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dqkv, Layout L, float scale) {
  __shared__ __align__(16) float Qs[BR][D];
  __shared__ __align__(16) float Gs[BR][D];
  __shared__ float LSE[BR], DL[BR];
  const int tile = blockIdx.x, gi = blockIdx.z, tid = threadIdx.x;
  const bool cross = (int)blockIdx.y == L.h;
  const int kvh = cross ? 0 : blockIdx.y;
  const int kj = tile * BR + tid;
  const bool active = kj < L.sep;
  const long long base = (long long)gi * L.S;
  float k[D], v[D], dk[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) k[c] = v[c] = dk[c] = dv[c] = 0.f;
  if (active) {
    const T* row = qkv + (base + kj) * 3 * L.hd + kvh * D;
#pragma unroll
    for (int c = 0; c < D; ++c) k[c] = to_f<T>(row[L.hd + c]), v[c] = to_f<T>(row[2 * L.hd + c]);
  }
  const int qbeg = cross ? L.sep : 0, qend = cross ? L.S : L.sep;
  const int h_lo = cross ? 0 : kvh, h_hi = cross ? L.h : kvh + 1;
  for (int hq = h_lo; hq < h_hi; ++hq) {
    const float* lse_h = lse + ((long long)gi * L.h + hq) * L.S;
    const float* dl_h = delta + ((long long)gi * L.h + hq) * L.S;
    for (int q0 = qbeg; q0 < qend; q0 += BR) {
      for (int i = tid; i < BR * D; i += BR) {
        const int r = i / D, c = i - r * D, qr = q0 + r;
        const bool ok = qr < qend;
        Qs[r][c] = ok ? to_f<T>(qkv[(base + qr) * 3 * L.hd + hq * D + c]) : 0.f;
        Gs[r][c] = ok ? to_f<T>(dout[(base + qr) * L.hd + hq * D + c]) : 0.f;
      }
      {
        const int qr = q0 + tid;
        LSE[tid] = qr < qend ? lse_h[qr] : INFINITY;  // weight 0 past the region
        DL[tid] = qr < qend ? dl_h[qr] : 0.f;
      }
      __syncthreads();
      const int nq = min(BR, qend - q0);
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
    T* dst = dqkv + (base + kj) * L.ld_ext + (cross ? 3 * L.hd : L.hd + kvh * D);
    const int vo = cross ? D : L.hd;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dst[c] = from_f<T>(dk[c]);
      dst[vo + c] = from_f<T>(dv[c]);
    }
  }
}

// ---- tensor cores (bf16, d a multiple of 16) ---------------------------------
// A warp owns 16 rows of the block's tile, whose operands it holds as mma a
// fragments; the streamed tile of 64 rows is staged row-major in shared
// memory (rows padded by 8 elements), where its rows serve directly as b
// fragments (B^T products) or through ldmatrix.trans (B products). Score and
// weight fragments never leave registers: each row lives in a quad of lanes.
constexpr int MTHREADS = 128;  // 4 warps x 16 rows = BR
constexpr int PAD = 8;

// Stage `rows` rows of D bf16 (16-byte loads, zero past `valid`) at `dst`.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, long long ld,
                                      int valid) {
  constexpr int KP = D + PAD;
  for (int i = threadIdx.x; i < BR * D / 8; i += MTHREADS) {
    const int r = i / (D / 8), c = 8 * (i - r * (D / 8));
    *reinterpret_cast<uint4*>(dst + r * KP + c) =
        r < valid ? *reinterpret_cast<const uint4*>(src + r * ld + c) : make_uint4(0, 0, 0, 0);
  }
}

// this warp's 16 rows of a staged tile as a fragments, one per 16 columns
template <int D>
__device__ __forceinline__ void frags(uint32_t (&a)[D / 16][4], const __nv_bfloat16* tile) {
  const int wr = 16 * (threadIdx.x >> 5);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) lds_a(a[ks], tile + wr * (D + PAD) + ks * 16, D + PAD);
}

// acc[nb] += A(16×D, fragments a) · Bt^T for the 64 staged rows of Bt (as the
// n axis, 8 per tile): scores against a staged tile.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[BR / 8][4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* bt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int nb = 0; nb < BR / 8; ++nb) {
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const __nv_bfloat16* br = bt + (nb * 8 + g) * (D + PAD) + ks * 16 + 2 * q4;
      mma_bf16_16816(acc[nb], a[ks], *reinterpret_cast<const uint32_t*>(br),
                     *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// acc[nd] += P(16×64, fragments pa) · B (the 64 staged rows, D columns)
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const uint32_t (&pa)[BR / 16][4],
                                       const __nv_bfloat16* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int j = 0; j < BR / 16; ++j) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, b + (j * 16 + (lane & 15)) * (D + PAD) + nd * 8);
      mma_bf16_16816(acc[nd], pa[j], b0, b1);
    }
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ld, int valid,
                                           const float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3, wr = 16 * (threadIdx.x >> 5);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    if (row >= valid) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store2(dst + row * ld + nd * 8 + 2 * q4, acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(MTHREADS)
dq_mma_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dqkv, Layout L, float scale) {
  constexpr int KP = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 Ks[BR * KP];
  __shared__ __align__(16) __nv_bfloat16 Vs[BR * KP];
  const int tile = blockIdx.x, hh = blockIdx.y, gi = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3, wr = 16 * (threadIdx.x >> 5);
  const int ntr = L.n_train_tiles();
  const bool cross = tile >= ntr;
  const int q0 = cross ? L.sep + (tile - ntr) * BR : tile * BR;
  const int nq = min(BR, (cross ? L.S : L.sep) - q0);
  const int kvh = cross ? 0 : hh;
  const long long base = (long long)gi * L.S;
  const long long ld = 3LL * L.hd;

  uint32_t qa[D / 16][4], ga[D / 16][4];
  stage<D>(Ks, qkv + (base + q0) * ld + hh * D, ld, nq);
  stage<D>(Vs, dout + (base + q0) * L.hd + hh * D, L.hd, nq);
  __syncthreads();
  frags<D>(qa, Ks);
  frags<D>(ga, Vs);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    const long long hi = ((long long)gi * L.h + hh) * L.S + q0 + row;
    lse_r[r] = row < nq ? lse[hi] : INFINITY;
    dl_r[r] = row < nq ? delta[hi] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  for (int k0 = 0; k0 < L.sep; k0 += BR) {
    __syncthreads();  // the previous tile (or the query staging) is consumed
    const int nk = min(BR, L.sep - k0);
    stage<D>(Ks, qkv + (base + k0) * ld + L.hd + kvh * D, ld, nk);
    stage<D>(Vs, qkv + (base + k0) * ld + 2 * L.hd + kvh * D, ld, nk);
    __syncthreads();
    float sc[BR / 8][4], dp[BR / 8][4];
    mma_abt<D>(sc, qa, Ks);
    mma_abt<D>(dp, ga, Vs);
    uint32_t dsa[BR / 16][4];
#pragma unroll
    for (int nb = 0; nb < BR / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = nb * 8 + 2 * q4 + c;
          const float p = key < nk ? expf(sc[nb][2 * r + c] * scale - lse_r[r]) : 0.f;
          ds[c] = p * (dp[nb][2 * r + c] - dl_r[r]) * scale;
        }
        dsa[nb >> 1][r + 2 * (nb & 1)] = pack_bf16(ds[0], ds[1]);
      }
    mma_pb<D>(dq, dsa, Ks);
  }
  store_rows<D>(dqkv + (base + q0) * L.ld_ext + hh * D, L.ld_ext, nq, dq);
}

template <int D>
__global__ void __launch_bounds__(MTHREADS)
dkv_mma_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dqkv, Layout L, float scale) {
  constexpr int KP = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 Qs[BR * KP];
  __shared__ __align__(16) __nv_bfloat16 Gs[BR * KP];
  __shared__ float LSE[BR], DL[BR];
  const int tile = blockIdx.x, gi = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, q4 = lane & 3;
  const bool cross = (int)blockIdx.y == L.h;
  const int kvh = cross ? 0 : blockIdx.y;
  const int k0 = tile * BR, nk = min(BR, L.sep - k0);
  const long long base = (long long)gi * L.S;
  const long long ld = 3LL * L.hd;

  uint32_t ka[D / 16][4], va[D / 16][4];
  stage<D>(Qs, qkv + (base + k0) * ld + L.hd + kvh * D, ld, nk);
  stage<D>(Gs, qkv + (base + k0) * ld + 2 * L.hd + kvh * D, ld, nk);
  __syncthreads();
  frags<D>(ka, Qs);
  frags<D>(va, Gs);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nd][i] = dv[nd][i] = 0.f;

  const int qbeg = cross ? L.sep : 0, qend = cross ? L.S : L.sep;
  const int h_lo = cross ? 0 : kvh, h_hi = cross ? L.h : kvh + 1;
  for (int hq = h_lo; hq < h_hi; ++hq) {
    const float* lse_h = lse + ((long long)gi * L.h + hq) * L.S;
    const float* dl_h = delta + ((long long)gi * L.h + hq) * L.S;
    for (int q0 = qbeg; q0 < qend; q0 += BR) {
      const int nq = min(BR, qend - q0);
      __syncthreads();  // the previous tile (or the key staging) is consumed
      stage<D>(Qs, qkv + (base + q0) * ld + hq * D, ld, nq);
      stage<D>(Gs, dout + (base + q0) * L.hd + hq * D, L.hd, nq);
      if (tid < BR) {
        LSE[tid] = tid < nq ? lse_h[q0 + tid] : INFINITY;  // weight 0 past the region
        DL[tid] = tid < nq ? dl_h[q0 + tid] : 0.f;
      }
      __syncthreads();
      float st[BR / 8][4], dpt[BR / 8][4];
      mma_abt<D>(st, ka, Qs);  // keys × queries
      mma_abt<D>(dpt, va, Gs);
      uint32_t pa[BR / 16][4], dsa[BR / 16][4];
#pragma unroll
      for (int nb = 0; nb < BR / 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p[2], ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qc = nb * 8 + 2 * q4 + c;
            p[c] = expf(st[nb][2 * r + c] * scale - LSE[qc]);
            ds[c] = p[c] * (dpt[nb][2 * r + c] - DL[qc]) * scale;
          }
          pa[nb >> 1][r + 2 * (nb & 1)] = pack_bf16(p[0], p[1]);
          dsa[nb >> 1][r + 2 * (nb & 1)] = pack_bf16(ds[0], ds[1]);
        }
      mma_pb<D>(dv, pa, Gs);
      mma_pb<D>(dk, dsa, Qs);
    }
  }
  const int col = cross ? 3 * L.hd : L.hd + kvh * D;
  const int vo = cross ? D : L.hd;
  store_rows<D>(dqkv + (base + k0) * L.ld_ext + col, L.ld_ext, nk, dk);
  store_rows<D>(dqkv + (base + k0) * L.ld_ext + col + vo, L.ld_ext, nk, dv);
}

template <typename T, int D>
int passes(const T* qkv, const T* dout, const float* lse, const float* delta, T* dqkv, int G,
           Layout L, cudaStream_t st) {
  const float scale = 1.f / sqrtf((float)D);
  const int n_q_tiles = (L.sep + BR - 1) / BR + (L.S - L.sep + BR - 1) / BR;
  const dim3 gq(n_q_tiles, L.h, G), gkv((L.sep + BR - 1) / BR, L.h + 1, G);
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D % 16 == 0) {
    dq_mma_kernel<D><<<gq, MTHREADS, 0, st>>>(qkv, dout, lse, delta, dqkv, L, scale);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    dkv_mma_kernel<D><<<gkv, MTHREADS, 0, st>>>(qkv, dout, lse, delta, dqkv, L, scale);
  } else {
    dq_cc_kernel<T, D><<<gq, BR, 0, st>>>(qkv, dout, lse, delta, dqkv, L, scale);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    dkv_cc_kernel<T, D><<<gkv, BR, 0, st>>>(qkv, dout, lse, delta, dqkv, L, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mmpfn_item_attn_bwd(const void* x, const void* wext, const void* dout,
                                   const float* lse, const float* delta, const void* dx_epi,
                                   void* qkv, void* dqkv, void* dx, float* dwext, float* work,
                                   int G, int S, int sep, int h, int d, int e, int wgrad_rows,
                                   int dtype, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (G <= 0 || S <= 0) return 0;
  if (sep < 1 || sep > S || G > 65535 || h < 1 || e < 1) return MMPFN_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)G * S;
  const int hd = h * d, n_ext = 3 * hd + 2 * d;
  const Layout L{S, sep, h, hd, n_ext};
  return mmpfn_dispatch(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    const T *X = (const T*)x, *W = (const T*)wext, *DO = (const T*)dout, *DXE = (const T*)dx_epi;
    T *QKV = (T*)qkv, *DQKV = (T*)dqkv, *DX = (T*)dx;
    int rc;
    if ((rc = gemm::run<T>(X, W, rows, 3 * hd, e, false, true, 0, gemm::Store<T>{QKV, 3 * hd}, st))) return rc;
    switch (d) {
      case 8: rc = passes<T, 8>(QKV, DO, lse, delta, DQKV, G, L, st); break;
      case 16: rc = passes<T, 16>(QKV, DO, lse, delta, DQKV, G, L, st); break;
      case 32: rc = passes<T, 32>(QKV, DO, lse, delta, DQKV, G, L, st); break;
      case 64: rc = passes<T, 64>(QKV, DO, lse, delta, DQKV, G, L, st); break;
      default: return MMPFN_BAD_ARGS;
    }
    if (rc) return rc;
    if ((rc = gemm::run<T>(DQKV, W, rows, e, n_ext, false, false, 0, gemm::AddStore<T, T>{DX, DXE, e}, st))) return rc;
    return gemm::wgrad<T>(DQKV, X, dwext, work, rows, n_ext, e, wgrad_rows, st);
  });
}
