// K4: flash attention forward over G independent groups,
//   s = (q · k^T) · scale,  o = softmax(s) · v,  lse = logsumexp(s)
// with q (G, Sq, d), k and v (G, Skv, d) of one type T, and o (G, Sq, d) and
// lse (G, Sq) in float32. Multiquery attention (every query head against one
// shared KV head) is this function with the query heads folded into the
// query axis, head-major.
//
// Replaces multimodalpfn_tpu/ops/pallas_attention.py:_fwd_kernel (pallas_call
// in _fwd_impl, :198/:220). The Pallas kernel's (G, d, S) layout put S on the
// TPU's 128 lanes (pallas_attention.py:12-18); here every operand keeps the
// natural (G, S, d) layout, which row-major tiles read with 16-byte loads.
//
// What bounds it on the H100: the score and P·V products, 4·Sq·Skv·d FLOPs
// per group against (2·Sq + 2·Skv)·d operand elements: at the KV-cache prime
// shape (G = 744, Sq = Skv = 1838, d = 32) 322 GFLOP against 0.2 GB in bf16,
// about 1600 FLOPs per byte, far above the card's ~295 per byte. float32
// operands run on the CUDA cores (the parity mode needs full float32
// products), bf16 operands (d a multiple of 16) on the tensor cores with
// mma.sync; wgmma and TMA pipelines are later work.
//
// Design: the online-softmax tile loops of attn_tile.cuh, shared with K2a.
// A CUDA-core block owns 64 query rows of one group (a thread per row); a
// tensor-core block owns 128 (a warp per 16). K/V stream through shared
// memory in tiles of 64 rows, so Skv has no ceiling (the Pallas kernel held
// the whole K/V of a group in VMEM). Ragged query rows load as zero and are
// never stored; ragged K/V rows load as zero and are masked. The rounding is
// the Pallas kernel's: float32 scores scaled in float32, the unnormalized
// weights rounded to T before P·V, the sum and the output acc / l in
// float32.
#include "attn_tile.cuh"

#include <type_traits>

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(attn::BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, float scale) {
  __shared__ __align__(16) float Ks[attn::BKV][D];
  __shared__ __align__(16) float Vs[attn::BKV][D];
  const long long g = blockIdx.y;
  const int qi = blockIdx.x * attn::BQ + threadIdx.x;
  const bool valid = qi < Sq;
  const T* qrow = q + (g * Sq + qi) * D;

  float qr[D], acc[D], m, l;
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = valid ? to_f<T>(qrow[c]) : 0.f;
  attn::cc_rows<T, D>(qr, k + g * Skv * D, v + g * Skv * D, D, Skv, scale, Ks, Vs, acc, m, l);
  if (valid) {
    float* orow = o + (g * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = acc[c] / l;
    lse[g * Sq + qi] = m + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(attn::MTHREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, float scale) {
  constexpr int ND = D / 8;  // output tiles of 8 columns
  __shared__ __align__(16) __nv_bfloat16 Ks[attn::MKV * (D + attn::MPAD)];
  __shared__ __align__(16) __nv_bfloat16 Vs[attn::MKV * (D + attn::MPAD)];
  const long long g_i = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int q0 = blockIdx.x * attn::MQ + 16 * (threadIdx.x >> 5);  // this warp's first row
  const __nv_bfloat16* qg = q + g_i * Sq * D;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + 8 * (i & 1), col = ks * 16 + 2 * q4 + 8 * (i >> 1);
      qa[ks][i] = row < Sq ? *reinterpret_cast<const uint32_t*>(qg + (long long)row * D + col) : 0u;
    }
  float oacc[ND][4], m[2], l[2];  // rows g and g+8
  attn::mma_rows<D>(qa, k + g_i * Skv * D, v + g_i * Skv * D, D, Skv, scale, Ks, Vs, oacc, m, l);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + 8 * r;
    if (row < Sq) {
      float* orow = o + (g_i * Sq + row) * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<float2*>(orow + nd * 8 + 2 * q4) =
            make_float2(oacc[nd][2 * r] / l[r], oacc[nd][2 * r + 1] / l[r]);
      if (q4 == 0) lse[g_i * Sq + row] = m[r] + logf(l[r]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, float* o, float* lse, int G, int Sq,
           int Skv, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D % 16 == 0) {
    flash_fwd_mma_kernel<D><<<dim3((Sq + attn::MQ - 1) / attn::MQ, G), attn::MTHREADS, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, o, lse, Sq, Skv, scale);
  } else {
    flash_fwd_kernel<T, D><<<dim3((Sq + attn::BQ - 1) / attn::BQ, G), attn::BQ, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, o, lse, Sq, Skv, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, float* o, float* lse, int G, int Sq,
             int Skv, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(q, k, v, o, lse, G, Sq, Skv, scale, stream);
    case 16: return launch<T, 16>(q, k, v, o, lse, G, Sq, Skv, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, G, Sq, Skv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, G, Sq, Skv, scale, stream);
    default: return MMPFN_BAD_ARGS;
  }
}

}  // namespace

extern "C" int mmpfn_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int G, int Sq, int Skv, int d, float scale, int dtype, int device,
                               void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (G <= 0 || Sq <= 0) return 0;
  if (Skv < 1 || G > 65535) return MMPFN_BAD_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MMPFN_F32)
    return dispatch<float>(q, k, v, (float*)o, (float*)lse, G, Sq, Skv, d, scale, s);
  if (dtype == MMPFN_BF16)
    return dispatch<__nv_bfloat16>(q, k, v, (float*)o, (float*)lse, G, Sq, Skv, d, scale, s);
  return MMPFN_BAD_ARGS;
}
