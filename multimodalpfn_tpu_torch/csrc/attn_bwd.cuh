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
// block BR query rows and streams every key in tiles of BR; the dk/dv pass
// gives a block BR key rows and streams its query segments (several for a
// key head that serves several query heads: the GQA reduction). No two
// blocks write one output, so the results are the same bits on every run.
//
// Where the rows are is the caller's: a geometry type `Geo` tells each
// block, from blockIdx, its rows as pointers and row strides:
//   QRows<T>  dq_rows() const;      the block's query rows (dq pass)
//   KVRows<T> dq_keys() const;      the keys they attend to
//   OutRows<T> dq_out() const;      where their dq goes
//   KVRows<T> dkv_keys() const;     the block's key rows (dk/dv pass)
//   int dkv_segments() const;       how many query segments attend to them
//   QRows<T>  dkv_segment(int) const;
//   OutRows<T> dk_out() const, dv_out() const;
// Rows past a count are zero-filled on load and their weights forced to 0
// (lse = +inf, delta = 0), so no out-of-range value reaches a sum.
//
// float32 operands (and d = 8) run on the CUDA cores, a thread per row; bf16
// operands with d a multiple of 16 run on the tensor cores (mma.sync
// m16n8k16), a warp per 16 rows.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace attn_bwd {

constexpr int BR = 64;  // rows of a block's own tile and of a streamed tile

// n rows from row 0: q of row r at q + r·ldq, do at dout + r·lddo, lse and
// delta at lse[r] and delta[r]
template <typename T>
struct QRows {
  const T* q;
  const T* dout;
  long long ldq, lddo;
  const float* lse;
  const float* delta;
  int n;
};

// n rows from row 0: k of row r at k + r·ld, v at v + r·ld
template <typename T>
struct KVRows {
  const T* k;
  const T* v;
  long long ld;
  int n;
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
  const QRows<T> qr = geo.dq_rows();
  const KVRows<T> kv = geo.dq_keys();
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
    const OutRows<T> out = geo.dq_out();
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
  const KVRows<T> own = geo.dkv_keys();
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
    const OutRows<T> ko = geo.dk_out(), vo = geo.dv_out();
    T* dkr = ko.p + tid * ko.ld;
    T* dvr = vo.p + tid * vo.ld;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dkr[c] = from_f<T>(dk[c]);
      dvr[c] = from_f<T>(dv[c]);
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

template <int D, typename Geo>
__global__ void __launch_bounds__(MTHREADS) dq_mma_kernel(Geo geo, float scale) {
  constexpr int KP = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 Ks[BR * KP];
  __shared__ __align__(16) __nv_bfloat16 Vs[BR * KP];
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3, wr = 16 * (threadIdx.x >> 5);
  const QRows<__nv_bfloat16> qr = geo.dq_rows();
  const KVRows<__nv_bfloat16> kv = geo.dq_keys();
  const int nq = qr.n;

  uint32_t qa[D / 16][4], ga[D / 16][4];
  stage<D>(Ks, qr.q, qr.ldq, nq);
  stage<D>(Vs, qr.dout, qr.lddo, nq);
  __syncthreads();
  frags<D>(qa, Ks);
  frags<D>(ga, Vs);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    lse_r[r] = row < nq ? qr.lse[row] : INFINITY;
    dl_r[r] = row < nq ? qr.delta[row] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  for (int k0 = 0; k0 < kv.n; k0 += BR) {
    __syncthreads();  // the previous tile (or the query staging) is consumed
    const int nk = min(BR, kv.n - k0);
    stage<D>(Ks, kv.k + k0 * kv.ld, kv.ld, nk);
    stage<D>(Vs, kv.v + k0 * kv.ld, kv.ld, nk);
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
  const OutRows<__nv_bfloat16> out = geo.dq_out();
  store_rows<D>(out.p, out.ld, nq, dq);
}

template <int D, typename Geo>
__global__ void __launch_bounds__(MTHREADS) dkv_mma_kernel(Geo geo, float scale) {
  constexpr int KP = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 Qs[BR * KP];
  __shared__ __align__(16) __nv_bfloat16 Gs[BR * KP];
  __shared__ float LSE[BR], DL[BR];
  const int tid = threadIdx.x;
  const int lane = tid & 31, q4 = lane & 3;
  const KVRows<__nv_bfloat16> own = geo.dkv_keys();
  const int nk = own.n;

  uint32_t ka[D / 16][4], va[D / 16][4];
  stage<D>(Qs, own.k, own.ld, nk);
  stage<D>(Gs, own.v, own.ld, nk);
  __syncthreads();
  frags<D>(ka, Qs);
  frags<D>(va, Gs);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nd][i] = dv[nd][i] = 0.f;

  const int nseg = geo.dkv_segments();
  for (int sg = 0; sg < nseg; ++sg) {
    const QRows<__nv_bfloat16> qs = geo.dkv_segment(sg);
    for (int q0 = 0; q0 < qs.n; q0 += BR) {
      const int nq = min(BR, qs.n - q0);
      __syncthreads();  // the previous tile (or the key staging) is consumed
      stage<D>(Qs, qs.q + q0 * qs.ldq, qs.ldq, nq);
      stage<D>(Gs, qs.dout + q0 * qs.lddo, qs.lddo, nq);
      if (tid < BR) {
        LSE[tid] = tid < nq ? qs.lse[q0 + tid] : INFINITY;  // weight 0 past the segment
        DL[tid] = tid < nq ? qs.delta[q0 + tid] : 0.f;
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
  const OutRows<__nv_bfloat16> ko = geo.dk_out(), vo = geo.dv_out();
  store_rows<D>(ko.p, ko.ld, nk, dk);
  store_rows<D>(vo.p, vo.ld, nk, dv);
}

// Both passes on `st`: the dq pass over grid `gq`, the dk/dv pass over `gkv`.
// Returns the CUDA error code of the launches.
template <typename T, int D, typename Geo>
int passes(const Geo& geo, dim3 gq, dim3 gkv, float scale, cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D % 16 == 0) {
    dq_mma_kernel<D, Geo><<<gq, MTHREADS, 0, st>>>(geo, scale);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    dkv_mma_kernel<D, Geo><<<gkv, MTHREADS, 0, st>>>(geo, scale);
  } else {
    dq_cc_kernel<T, D, Geo><<<gq, BR, 0, st>>>(geo, scale);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    dkv_cc_kernel<T, D, Geo><<<gkv, BR, 0, st>>>(geo, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd
