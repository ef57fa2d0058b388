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
// What bounds it on the H100: at the KV-cache prime shape (G = 744, Sq =
// Skv = 1838, d = 32) 322 GFLOP of score and P·V products against 0.2 GB of
// bf16 operands, about 1600 FLOPs per byte, far above the card's ~295 per
// byte; and 2.5e9 exponentials, one per (query, key) pair, which at 16 ex2
// a clock per SM take longer than the products on the tensor cores. So at
// d = 32 the SFU, not the tensor cores, is the floor.
//
// Design: the two bodies of attn_tile.cuh, shared with K2a. float32 operands
// (the parity mode) and bf16 at d = 8 run on the CUDA cores: a block owns 64
// query rows of one group, a thread per row, K/V staged through shared
// memory in tiles of 64. bf16 at d = 16, 32, 64 runs fwd_wg_kernel: a block
// owns 192 query rows of one group (128 at d = 64), K/V tiles of 128 rows
// arrive through TMA from 3-D tensor maps of q, k, v (G, S, d) built here
// on the host, and one consumer warpgroup per 64 rows runs the products on
// wgmma and the softmax on one ex2 per score. Skv has no ceiling (the Pallas kernel held the whole K/V
// of a group in VMEM). Ragged query rows load as zero (the map's row bound)
// and are never stored; keys past Skv load as zero and are masked by index.
// The rounding is the Pallas kernel's: float32 scores scaled in float32,
// the unnormalized weights rounded to T before P·V, the sum and the output
// acc / l in float32.
#include "attn_tile.cuh"

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

// Rows of fwd_wg_kernel: block x of group z = blockIdx.z owns query rows
// [bm·x, bm·x + bm) and attends to all Skv keys of the group; in the tensor
// maps q, k and v are (G, S, d), column 0.
template <int D>
struct FlashFwdGeo {
  float* o;
  float* lse;
  int G, Sq, Skv;

  __host__ dim3 grid(int bm) const { return dim3((Sq + bm - 1) / bm, 1, G); }
  __device__ __forceinline__ attn::QTile<float> q_tile(int bm) const {
    const int row = blockIdx.x * bm;
    const long long r = (long long)blockIdx.z * Sq + row;
    return {o + r * D, D, lse + r, min(bm, Sq - row), row, (int)blockIdx.z, 0};
  }
  __device__ __forceinline__ attn::KeyRows keys(int) const { return {Skv, 0, (int)blockIdx.z, 0, 0}; }
};

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, float* o, float* lse, int G, int Sq,
           int Skv, float scale, cudaStream_t stream) {
  if constexpr (hopper::on_wgmma<T, D>) {
    attn::Maps maps;
    int rc;
    if ((rc = hopper::make_map<D>(&maps.q, q, Sq, G, D)) ||
        (rc = hopper::make_map<D>(&maps.k, k, Skv, G, D)) ||
        (rc = hopper::make_map<D>(&maps.v, v, Skv, G, D)))
      return rc;
    return attn::fwd_wg<D>(FlashFwdGeo<D>{o, lse, G, Sq, Skv}, maps, scale, stream);
  } else {
    flash_fwd_kernel<T, D><<<dim3((Sq + attn::BQ - 1) / attn::BQ, G), attn::BQ, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, o, lse, Sq, Skv, scale);
    return (int)cudaGetLastError();
  }
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
  if (Skv < 1 || G > 65535 || !(scale > 0.f)) return MMPFN_BAD_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MMPFN_F32)
    return dispatch<float>(q, k, v, (float*)o, (float*)lse, G, Sq, Skv, d, scale, s);
  if (dtype == MMPFN_BF16)
    return dispatch<__nv_bfloat16>(q, k, v, (float*)o, (float*)lse, G, Sq, Skv, d, scale, s);
  return MMPFN_BAD_ARGS;
}
