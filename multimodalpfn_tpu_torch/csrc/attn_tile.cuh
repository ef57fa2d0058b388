// Online-softmax attention of query rows against a stream of K/V rows, the
// tile loop shared by K2a (item_attn.cu) and K4 (flash_fwd.cu). Each caller
// loads its query rows, calls one of the two bodies below with pointers to
// the first K and V row and the row stride, and normalizes and stores the
// result in its own layout.
//
// The rounding is the Pallas kernels': scores q·k accumulate in float32 and
// are scaled in float32; the unnormalized weights exp(s - m) are rounded to
// the operand type before the P·V product; their sum and the output stay
// float32. K/V rows at or past `nkv` are zero-filled on load (stale shared
// memory times zero can be NaN) and their scores masked with -1e30, so no
// out-of-range value reaches a sum. K/V stream from device memory through
// shared memory, so the key count has no shared-memory ceiling.
#pragma once

#include "common.cuh"

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

// ---- bf16 operands on the tensor cores --------------------------------------
// A warp owns 16 query rows, scores and P·V are mma.sync m16n8k16 products
// (bf16 in, float32 accumulated), and the online softmax runs on the score
// fragments: each row lives in the 4 lanes of a quad, which combine their
// maxima with shuffles and keep partial sums that are added once at the end.
// K and V tiles are staged row-major with 16-byte loads (ldmatrix.trans reads
// V as b fragments), rows padded so fragment reads hit distinct banks; the
// MQ query rows of a block share each staged tile.
constexpr int MQ = 128;       // query rows per block: 8 warps x 16
constexpr int MKV = 64;       // keys per shared-memory tile
constexpr int MTHREADS = 2 * MQ;
constexpr int MPAD = 8;       // padding of a K/V tile row (bf16 elements)

// All MTHREADS threads of the block call this. qa holds the warp's 16 query
// rows as a fragments, one per 16-wide slice of d (zero for rows past the
// end); K row j is k[j * ld, j * ld + D), 16-byte aligned, V likewise;
// Ks and Vs are MKV * (D + MPAD) elements of shared memory each. On return,
// for the lane's rows g and g + 8 (r = 0, 1): oacc[n][2r], oacc[n][2r+1] hold
// output columns 8n + 2(lane % 4) and the next, unnormalized; m[r] is the row
// maximum and l[r] the full sum of the weights.
template <int D>
__device__ __forceinline__ void mma_rows(const uint32_t (&qa)[D / 16][4],
                                         const __nv_bfloat16* __restrict__ k,
                                         const __nv_bfloat16* __restrict__ v, long long ld,
                                         int nkv, float scale, __nv_bfloat16* Ks,
                                         __nv_bfloat16* Vs, float (&oacc)[D / 8][4],
                                         float (&m)[2], float (&l)[2]) {
  constexpr int KP = D + MPAD;  // padded rows: fragment reads hit distinct banks
  constexpr int NB = MKV / 8;   // score tiles of 8 keys
  constexpr int ND = D / 8;     // output tiles of 8 columns
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) oacc[nd][0] = oacc[nd][1] = oacc[nd][2] = oacc[nd][3] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  for (int k0 = 0; k0 < nkv; k0 += MKV) {
    for (int i = tid; i < MKV * D / 8; i += MTHREADS) {
      const int r = i / (D / 8), c = 8 * (i - r * (D / 8));
      const int kr = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (kr < nkv) {
        kv = *reinterpret_cast<const uint4*>(k + (long long)kr * ld + c);
        vv = *reinterpret_cast<const uint4*>(v + (long long)kr * ld + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * KP + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * KP + c) = vv;
    }
    __syncthreads();

    float sc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const __nv_bfloat16* kr = Ks + (nb * 8 + g) * KP + ks * 16 + 2 * q4;
        mma_bf16_16816(sc[nb], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    const int nk = min(MKV, nkv - k0);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = nb * 8 + 2 * q4 + (i & 1);
        sc[nb][i] = key < nk ? sc[nb][i] * scale : -1e30f;
        mt[i >> 1] = fmaxf(mt[i >> 1], sc[nb][i]);
      }
    uint32_t pa[MKV / 16][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      const float alpha = expf(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        oacc[nd][2 * r] *= alpha;
        oacc[nd][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float p0 = expf(sc[nb][2 * r] - m_new), p1 = expf(sc[nb][2 * r + 1] - m_new);
        l[r] += p0 + p1;
        // score tiles 2j and 2j+1 are the A fragment of keys 16j..16j+15
        pa[nb >> 1][r + 2 * (nb & 1)] = pack_bf16(p0, p1);
      }
      m[r] = m_new;
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int j = 0; j < MKV / 16; ++j) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, Vs + (j * 16 + (lane & 15)) * KP + nd * 8);
        mma_bf16_16816(oacc[nd], pa[j], b0, b1);
      }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

}  // namespace attn
