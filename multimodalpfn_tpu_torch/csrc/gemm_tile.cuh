// Tiled matrix products and the row kernels shared by the backward kernels
// K7 (feat_attn_bwd.cu), K8 (mlp_ln_bwd.cu), K9 (item_attn_bwd.cu) and K10
// (item_epilogue_bwd.cu):
//
//   C[m, n] = sum_k A(m, k) · B(k, n),  m < M, n < N, k < K,
//
// with A stored (M, K) row-major, or (K, M) when `a_t` (the product reads
// A^T), and B stored (K, N) row-major, or (N, K) when `b_t`. Each output is
// handed to an epilogue functor (store, add a residual, gelu, ...), which
// rounds where the Pallas kernels round.
//
// Weight gradients contract over all rows (K = rows, tens of thousands):
// they are split into chunks of `k_chunk` rows, each chunk's float32 partial
// sums go to a slab of a workspace (blockIdx.z), and `sum_slabs` adds the
// slabs in order. No atomics: a kernel's outputs are the same bits on every
// run, and a fine-tune is reproducible on one card.
//
// Two bodies: float32 operands (the parity mode) run on the CUDA cores, 64×64
// outputs per block, 4×4 per thread; bf16 operands run on the tensor cores
// (mma.sync m16n8k16, float32 accumulation), 64×64 outputs per block, a warp
// per 16 rows, k-slabs of 32 staged with 16-byte loads. Every tile is
// zero-filled past M, N and the chunk's end (stale shared memory times zero
// can be NaN). wgmma and TMA pipelining are later work.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace gemm {

// ---- epilogues --------------------------------------------------------------
// operator()(m, n, v, z): output (m, n) of chunk z with float32 value v.

template <typename TO>
struct Store {  // out = v
  TO* out;
  int ld;
  __device__ __forceinline__ void operator()(long long m, int n, float v, int) const {
    out[m * ld + n] = from_f<TO>(v);
  }
};

template <typename TO, typename TR>
struct AddStore {  // out = v + r
  TO* out;
  const TR* r;
  int ld;
  __device__ __forceinline__ void operator()(long long m, int n, float v, int) const {
    out[m * ld + n] = from_f<TO>(v + to_f<TR>(r[m * ld + n]));
  }
};

struct Partial {  // slab z of a split contraction
  float* work;
  long long slab;
  int ld;
  __device__ __forceinline__ void operator()(long long m, int n, float v, int z) const {
    work[z * slab + m * ld + n] = v;
  }
};

// ---- CUDA cores: any operand type, any shape -------------------------------
constexpr int CM = 64, CN = 64, CK = 16, CTHREADS = 256;

template <typename T, class Epi>
__global__ void __launch_bounds__(CTHREADS)
cc_kernel(const T* __restrict__ A, const T* __restrict__ B, long long M, int N, int K, int a_t,
          int b_t, int k_chunk, Epi epi) {
  __shared__ __align__(16) float As[CK][CM + 4];
  __shared__ __align__(16) float Bs[CK][CN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.y * CM;
  const int n0 = blockIdx.x * CN, z = blockIdx.z;
  const int kb = z * k_chunk, ke = min(K, kb + k_chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += CK) {
    // consecutive threads read consecutive addresses of the stored layout
    for (int i = tid; i < CM * CK; i += CTHREADS) {
      const int r = a_t ? i % CM : i / CK, kk = a_t ? i / CM : i % CK;
      const long long gm = m0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gm < M && gk < ke) ? to_f<T>(a_t ? A[(long long)gk * M + gm] : A[gm * K + gk])
                                      : 0.f;
    }
    for (int i = tid; i < CN * CK; i += CTHREADS) {
      const int c = b_t ? i / CK : i % CN, kk = b_t ? i % CK : i / CN;
      const int gn = n0 + c, gk = k0 + kk;
      Bs[kk][c] = (gn < N && gk < ke)
                      ? to_f<T>(b_t ? B[(long long)gn * K + gk] : B[(long long)gk * N + gn])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) epi(gm, gn, acc[i][j], z);
    }
  }
}

// ---- tensor cores: bf16 operands whose contiguous dimensions are multiples of 8
constexpr int TM = 64, TN = 64, TK = 32, TTHREADS = 128;
constexpr int ALD = TK + 8;  // padded rows: fragment reads hit distinct banks

template <bool AT, bool BT, class Epi>
__global__ void __launch_bounds__(TTHREADS)
tc_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B, long long M,
          int N, int K, int k_chunk, Epi epi) {
  constexpr int BLD = BT ? TK + 8 : TN + 8;  // Bs is [TN][TK+8] (b_t) or [TK][TN+8]
  __shared__ __align__(16) __nv_bfloat16 As[TM * ALD];
  __shared__ __align__(16) __nv_bfloat16 Bs[(BT ? TN : TK) * BLD];
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int wr = 16 * (tid >> 5);
  const long long m0 = (long long)blockIdx.y * TM;
  const int n0 = blockIdx.x * TN, z = blockIdx.z;
  const int kb = z * k_chunk, ke = min(K, kb + k_chunk);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float acc[TN / 8][4];
#pragma unroll
  for (int n = 0; n < TN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += TK) {
    if (!AT) {  // A (M, K): 8 consecutive k of a row per load
      for (int i = tid; i < TM * TK / 8; i += TTHREADS) {
        const int r = i / (TK / 8), c = (i - r * (TK / 8)) * 8;
        const long long gm = m0 + r;
        const int gk = k0 + c;
        *reinterpret_cast<uint4*>(As + r * ALD + c) =
            (gm < M && gk < ke) ? *reinterpret_cast<const uint4*>(A + gm * K + gk) : zero;
      }
    } else {  // A stored (K, M): 8 consecutive m of a row per load, transposed into As
      for (int i = tid; i < TK * TM / 8; i += TTHREADS) {
        const int kk = i / (TM / 8), c = (i - kk * (TM / 8)) * 8;
        const int gk = k0 + kk;
        const long long gm = m0 + c;
        uint4 v = zero;
        if (gk < ke && gm < M) v = *reinterpret_cast<const uint4*>(A + (long long)gk * M + gm);
        const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) As[(c + j) * ALD + kk] = e8[j];
      }
    }
    if (BT) {  // B stored (N, K): rows of n, 8 consecutive k per load
      for (int i = tid; i < TN * TK / 8; i += TTHREADS) {
        const int r = i / (TK / 8), c = (i - r * (TK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + c;
        *reinterpret_cast<uint4*>(Bs + r * BLD + c) =
            (gn < N && gk < ke) ? *reinterpret_cast<const uint4*>(B + (long long)gn * K + gk)
                                : zero;
      }
    } else {  // B (K, N): rows of k, 8 consecutive n per load
      for (int i = tid; i < TK * TN / 8; i += TTHREADS) {
        const int kk = i / (TN / 8), c = (i - kk * (TN / 8)) * 8;
        const int gk = k0 + kk, gn = n0 + c;
        *reinterpret_cast<uint4*>(Bs + kk * BLD + c) =
            (gk < ke && gn < N) ? *reinterpret_cast<const uint4*>(B + (long long)gk * N + gn)
                                : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks) {
      uint32_t a[4];
      lds_a(a, As + wr * ALD + ks * 16, ALD);
#pragma unroll
      for (int nb = 0; nb < TN / 8; ++nb) {
        uint32_t b0, b1;
        if (BT) {
          const __nv_bfloat16* br = Bs + (nb * 8 + g) * BLD + ks * 16 + 2 * q4;
          b0 = *reinterpret_cast<const uint32_t*>(br);
          b1 = *reinterpret_cast<const uint32_t*>(br + 8);
        } else {
          ldsm_x2_trans(b0, b1, Bs + (ks * 16 + (lane & 15)) * BLD + nb * 8);
        }
        mma_bf16_16816(acc[nb], a, b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nb = 0; nb < TN / 8; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long gm = m0 + wr + g + 8 * r;
      if (gm >= M) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int gn = n0 + nb * 8 + 2 * q4 + c;
        if (gn < N) epi(gm, gn, acc[nb][2 * r + c], z);
      }
    }
}

// C = op(A)·op(B) through `epi`; `k_chunk` > 0 splits K into chunks
// (blockIdx.z), else one chunk. Returns the launch's error code.
template <typename T, class Epi>
int run(const T* A, const T* B, long long M, int N, int K, bool a_t, bool b_t, int k_chunk,
        Epi epi, cudaStream_t s) {
  if (M <= 0 || N <= 0) return 0;
  if (k_chunk <= 0 || k_chunk > K) k_chunk = K > 0 ? K : 1;
  const int splits = K > 0 ? (K + k_chunk - 1) / k_chunk : 1;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const bool a_ok = a_t ? M % 8 == 0 : (K % 8 == 0 && k_chunk % 8 == 0);
    const bool b_ok = b_t ? (K % 8 == 0 && k_chunk % 8 == 0) : N % 8 == 0;
    if (a_ok && b_ok) {
      const dim3 grid((N + TN - 1) / TN, (unsigned)((M + TM - 1) / TM), splits);
      if (a_t && b_t) tc_kernel<true, true><<<grid, TTHREADS, 0, s>>>(A, B, M, N, K, k_chunk, epi);
      else if (a_t) tc_kernel<true, false><<<grid, TTHREADS, 0, s>>>(A, B, M, N, K, k_chunk, epi);
      else if (b_t) tc_kernel<false, true><<<grid, TTHREADS, 0, s>>>(A, B, M, N, K, k_chunk, epi);
      else tc_kernel<false, false><<<grid, TTHREADS, 0, s>>>(A, B, M, N, K, k_chunk, epi);
      return (int)cudaGetLastError();
    }
  }
  const dim3 grid((N + CN - 1) / CN, (unsigned)((M + CM - 1) / CM), splits);
  cc_kernel<T, Epi><<<grid, CTHREADS, 0, s>>>(A, B, M, N, K, a_t, b_t, k_chunk, epi);
  return (int)cudaGetLastError();
}

// out[i] = sum over slabs z (in order) of work[z * len + i]
static __global__ void sum_slabs_kernel(const float* __restrict__ work, float* __restrict__ out,
                                 int slabs, long long len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int z = 0; z < slabs; ++z) s += work[z * len + i];
  out[i] = s;
}

// The weight gradient out (M, N) = A^T B summed over `rows` rows, A stored
// (rows, M) and B (rows, N): chunks of `k_chunk` rows into `work`
// (ceil(rows / k_chunk) slabs of M·N floats), then the slabs in order.
template <typename T>
int wgrad(const T* A, const T* B, float* out, float* work, long long rows, int M, int N,
          int k_chunk, cudaStream_t s) {
  if (rows > 0x7fffffffLL) return MMPFN_BAD_ARGS;
  const int K = (int)rows;
  if (k_chunk <= 0 || k_chunk >= K) return run<T>(A, B, M, N, K, true, false, 0, Store<float>{out, N}, s);
  const int slabs = (K + k_chunk - 1) / k_chunk;
  const long long len = (long long)M * N;
  int rc = run<T>(A, B, M, N, K, true, false, k_chunk, Partial{work, len, N}, s);
  if (rc) return rc;
  sum_slabs_kernel<<<(unsigned)((len + 255) / 256), 256, 0, s>>>(work, out, slabs, len);
  return (int)cudaGetLastError();
}

// ---- LayerNorm backward over rows (a warp per row) -------------------------
// du = r·(g − mean(g) − n·mean(g·n)) with n = (u − mean(u))·r and
// r = 1/sqrt(var(u) + 1e-5): the cotangent of the affine-free LN at its float32
// input u. Writes du in float32 (if du32) and rounded to T (if du_c).
template <typename T>
__global__ void ln_bwd_kernel(const float* __restrict__ u, const T* __restrict__ g,
                              float* __restrict__ du32, T* __restrict__ du_c, long long rows,
                              int e) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ur = u + row * e;
  const T* gr = g + row * e;
  float s = 0.f;
  for (int c = lane; c < e; c += 32) s += ur[c];
  const float mean = warp_sum(s) / e;
  float q = 0.f;
  for (int c = lane; c < e; c += 32) q += (ur[c] - mean) * (ur[c] - mean);
  const float r = 1.f / sqrtf(warp_sum(q) / e + 1e-5f);
  float gs = 0.f, gn = 0.f;
  for (int c = lane; c < e; c += 32) {
    const float gv = to_f<T>(gr[c]);
    gs += gv;
    gn += gv * (ur[c] - mean) * r;
  }
  const float gmean = warp_sum(gs) / e, gnmean = warp_sum(gn) / e;
  for (int c = lane; c < e; c += 32) {
    const float du = r * (to_f<T>(gr[c]) - gmean - (ur[c] - mean) * r * gnmean);
    if (du32) du32[row * e + c] = du;
    if (du_c) du_c[row * e + c] = from_f<T>(du);
  }
}

template <typename T>
int ln_bwd(const float* u, const T* g, float* du32, T* du_c, long long rows, int e,
           cudaStream_t s) {
  ln_bwd_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(u, g, du32, du_c, rows, e);
  return (int)cudaGetLastError();
}

}  // namespace gemm

// The C entry points' dtype switch: calls body(T{}) for the operand type T.
template <class Body>
int mmpfn_dispatch(int dtype, Body body) {
  if (dtype == MMPFN_F32) return body(float{});
  if (dtype == MMPFN_BF16) return body(__nv_bfloat16{});
  return MMPFN_BAD_ARGS;
}
