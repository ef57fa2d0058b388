// K11: the backward of K4 (flash attention over G independent groups) from
// the saved float32 o and lse: given q (G, Sq, d), k and v (G, Skv, d) of one
// type T, o (G, Sq, d) and lse (G, Sq) in float32 and the float32 cotangent
// do = dL/do (G, Sq, d), returns dq (G, Sq, d) and dk, dv (G, Skv, d) in T.
// Multiquery attention (the query heads folded into the query axis against
// one KV head) is this function with the folded axis: each key's dk and dv
// then sum over every query head, the GQA reduction.
//
// Replaces multimodalpfn_tpu/ops/pallas_attention.py:_bwd_kernel
// (pallas_call in _bwd_impl, :333/:347), with its XLA pre-step
// delta = Σ_d do·o (:346).
//
// What bounds it on the H100: five products of 2·d FLOPs per (query, key)
// pair (the scores, dp = do·v, dv, dk and dq): at the flagship fine-tune's
// train block (G = 180, Sq = Skv = 1655, d = 32, 4.93e8 pairs) 157.8 GFLOP
// against about 174 MB of operands, some 900 FLOPs per byte, above the
// card's ~295: the tensor cores bound the work (0.160 ms in bf16). Two
// passes without atomics recompute the scores and dp, seven products
// (0.224 ms), and exponentiate every pair twice: 9.9e8 ex2 at 16 per clock
// per SM, about 0.24 ms at 1.98 GHz. At d = 32 the exponentials, not the
// products, are the floor.
//
// Design: the Pallas kernel merges both passes and carries dq over a
// sequential kv grid axis; on the H100 blocks run in no order, and merging
// would need atomics for dq, whose sums would then change from run to run.
// So K11 runs the two passes of attn_bwd.cuh, shared with K9, with no
// atomics:
//  1. a pre-pass: delta = Σ_d do·o from the float32 do, and do rounded to T
//     (the Pallas kernel's operand type);
//  2. dq pass: a block owns 128 query rows of a group and streams its K/V in
//     tiles of 64;
//  3. dk/dv pass: a block owns 128 key rows of a group and streams every
//     query row of the group (for the folded multiquery block, all h·Sq).
// In bf16 (d = 16, 32, 64) the tiles arrive through TMA from 3-D tensor maps
// of q, k, v and the rounded do (G, S, d), built here on the host, into a
// ring that one producer warp keeps full while two consumer warpgroups run
// wgmma and exp2 (attn_bwd.cuh): the products run at the tensor cores' rate
// and overlap the copies, leaving the exponentials and the softmax
// arithmetic between the products as the limit. Ragged tails (Sq = 183,
// 1098 and 1655 are not multiples of 64) load as zero, with lse = +inf and
// delta = 0 past Sq (exp(−inf) = 0 weights, never 0·inf), and the weights
// of keys past Skv are forced to 0.
#include "attn_bwd.cuh"

namespace {

using attn_bwd::KVRows;
using attn_bwd::OutRows;
using attn_bwd::QRows;

// 1. delta[r] = Σ_c do[r, c]·o[r, c] and do_c[r] = rnd(do[r]): L = d / 4 lanes
// per row, four columns each, combined by shuffles in a fixed order.
template <typename T, int L>
__global__ void __launch_bounds__(256)
delta_kernel(const float* __restrict__ dout, const float* __restrict__ o, T* __restrict__ do_c,
             float* __restrict__ delta, long long rows) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / L;
  const int part = (int)(t - row * L);
  float s = 0.f;
  if (row < rows) {
    float a[4], b[4];
    const long long off = row * (4 * L) + 4 * part;
    load4(dout + off, a);
    load4(o + off, b);
    s = fmaf(a[3], b[3], fmaf(a[2], b[2], fmaf(a[1], b[1], a[0] * b[0])));
    store2(do_c + off, a[0], a[1]);
    store2(do_c + off + 2, a[2], a[3]);
  }
#pragma unroll
  for (int w = L / 2; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (row < rows && part == 0) delta[row] = s;
}

// Rows of the passes: group g = blockIdx.z; the dq pass's block x owns query
// rows [bm·x, bm·x + bm), the dk/dv pass's block x key rows [bm·x, bm·x + bm),
// with one query segment, all Sq rows of the group. In the tensor maps q, k,
// v and do_c are (G, S, d): group z = g, column 0.
template <typename T, int D>
struct FlashGeo {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  T* dq;
  T* dk;
  T* dv;
  int G, Sq, Skv;

  __host__ dim3 dq_grid(int bm) const { return dim3((Sq + bm - 1) / bm, 1, G); }
  __host__ dim3 dkv_grid(int bm) const { return dim3((Skv + bm - 1) / bm, 1, G); }
  __device__ __forceinline__ long long qrow0(int bm) const {
    return (long long)blockIdx.z * Sq + blockIdx.x * bm;
  }
  __device__ __forceinline__ long long krow0(int bm) const {
    return (long long)blockIdx.z * Skv + blockIdx.x * bm;
  }
  __device__ __forceinline__ QRows<T> dq_rows(int bm) const {
    const long long r = qrow0(bm);
    const int row = blockIdx.x * bm;
    return {q + r * D, dout + r * D, D, D, lse + r, delta + r, min(bm, Sq - row),
            row, (int)blockIdx.z, 0, 0};
  }
  __device__ __forceinline__ KVRows<T> dq_keys(int) const {
    const long long r = (long long)blockIdx.z * Skv;
    return {k + r * D, v + r * D, D, Skv, 0, (int)blockIdx.z, 0, 0};
  }
  __device__ __forceinline__ OutRows<T> dq_out(int bm) const { return {dq + qrow0(bm) * D, D}; }
  __device__ __forceinline__ KVRows<T> dkv_keys(int bm) const {
    const long long r = krow0(bm);
    const int row = blockIdx.x * bm;
    return {k + r * D, v + r * D, D, min(bm, Skv - row), row, (int)blockIdx.z, 0, 0};
  }
  __device__ __forceinline__ int dkv_segments() const { return 1; }
  __device__ __forceinline__ QRows<T> dkv_segment(int) const {
    const long long r = (long long)blockIdx.z * Sq;
    return {q + r * D, dout + r * D, D, D, lse + r, delta + r, Sq, 0, (int)blockIdx.z, 0, 0};
  }
  __device__ __forceinline__ OutRows<T> dk_out(int bm) const { return {dk + krow0(bm) * D, D}; }
  __device__ __forceinline__ OutRows<T> dv_out(int bm) const { return {dv + krow0(bm) * D, D}; }
};

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const float* o, const float* lse,
           const float* dout, T* do_c, float* delta, T* dq, T* dk, T* dv, int G, int Sq, int Skv,
           float scale, cudaStream_t st) {
  constexpr int L = D / 4;
  const long long rows = (long long)G * Sq;
  const long long threads = rows * L;
  delta_kernel<T, L><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(dout, o, do_c, delta, rows);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  attn_bwd::Maps maps{};
  if constexpr (hopper::on_wgmma<T, D>) {
    using hopper::make_map;
    if ((rc = make_map<D>(&maps.q, q, Sq, G, D)) || (rc = make_map<D>(&maps.k, k, Skv, G, D)) ||
        (rc = make_map<D>(&maps.v, v, Skv, G, D)) || (rc = make_map<D>(&maps.dout, do_c, Sq, G, D)))
      return rc;
  }
  const FlashGeo<T, D> geo{q, k, v, do_c, lse, delta, dq, dk, dv, G, Sq, Skv};
  return attn_bwd::passes<T, D>(geo, maps, scale, st);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* o, const float* lse,
             const float* dout, void* do_c, float* delta, void* dq, void* dk, void* dv, int G,
             int Sq, int Skv, int d, float scale, cudaStream_t st) {
  const T *Q = (const T*)q, *K = (const T*)k, *V = (const T*)v;
  T *DOC = (T*)do_c, *DQ = (T*)dq, *DK = (T*)dk, *DV = (T*)dv;
  switch (d) {
    case 8: return launch<T, 8>(Q, K, V, o, lse, dout, DOC, delta, DQ, DK, DV, G, Sq, Skv, scale, st);
    case 16: return launch<T, 16>(Q, K, V, o, lse, dout, DOC, delta, DQ, DK, DV, G, Sq, Skv, scale, st);
    case 32: return launch<T, 32>(Q, K, V, o, lse, dout, DOC, delta, DQ, DK, DV, G, Sq, Skv, scale, st);
    case 64: return launch<T, 64>(Q, K, V, o, lse, dout, DOC, delta, DQ, DK, DV, G, Sq, Skv, scale, st);
    default: return MMPFN_BAD_ARGS;
  }
}

}  // namespace

// do_c (G, Sq, d) in T and delta (G, Sq) float32 are the caller's scratch.
extern "C" int mmpfn_flash_bwd(const void* q, const void* k, const void* v, const float* o,
                               const float* lse, const float* dout, void* do_c, float* delta,
                               void* dq, void* dk, void* dv, int G, int Sq, int Skv, int d,
                               float scale, int dtype, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (G <= 0 || Sq <= 0) return 0;
  if (Skv < 1 || G > 65535) return MMPFN_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == MMPFN_F32)
    return dispatch<float>(q, k, v, o, lse, dout, do_c, delta, dq, dk, dv, G, Sq, Skv, d, scale, st);
  if (dtype == MMPFN_BF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, dout, do_c, delta, dq, dk, dv, G, Sq, Skv, d,
                                   scale, st);
  return MMPFN_BAD_ARGS;
}
