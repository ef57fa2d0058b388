// K2a: item attention with its QKV projection, over x3 (G, S, e) whose first
// `sep` rows are train rows:
//   qkv = x3 · W^T                                  (W = w_qkv as (3·h·d, e))
//   train rows:  o_h = softmax(q_h k_h^T / sqrt(d)) v_h   over train keys, head h
//   test rows:   o_h = softmax(q_h k_0^T / sqrt(d)) v_0   over train keys, KV head 0
// returning o (G, S, h·d) and lse (G, h, S) in float32.
//
// Replaces multimodalpfn_tpu/ops/pallas_item_fused.py:_fwd_kernel (pallas_call
// in _fwd_region, :200/:222, called for both regions from _fwd_call :246).
//
// What bounds it on the H100: the attention. At the flagship shape (G = 124,
// S = 2350, sep = 1838, h = 6, d = 32) the scores and P·V cost 411 GFLOP
// and 3.2e9 exponentials (one per (query, key, head)), against 64 GFLOP of
// projection and ~0.3 GB of traffic; at 16 ex2 a clock per SM the
// exponentials take longer than the products on the tensor cores, so the
// SFU is the floor of the attention.
//
// Design:
//  * the projection, qkv = x3 · W^T with outputs rounded to T as the Pallas
//    kernel casts its projections. Test rows' k/v columns are computed and
//    unused (13% of the projection at the flagship shape) to keep one plain
//    product. bf16 runs gemm_tile.cuh's product (the wgmma tile, 128 × 192
//    outputs a tile from a TMA ring; its CUDA-core kernel where the operands
//    are not 16-byte aligned), the same call by which K9 recomputes qkv,
//    so the forward and the backward see the same bits; its bound is the
//    bytes (x read, qkv written: 0.134 ms at the flagship shape). float32
//    (the parity mode) runs proj_nt_kernel: a classic shared-memory tiled
//    product, 64×64 outputs per block, 4×4 per thread, k-slabs of 16.
//  * item_attn_kernel (float32, and bf16 at d = 8): one block per (group,
//    head, 64-query tile); a thread owns one query row: its q and its float32
//    output accumulator live in registers, K/V tiles of 64 train rows are
//    staged in shared memory and read as broadcasts. Online softmax over
//    sub-tiles of 16 keys with the Pallas kernel's rounding (the
//    unnormalized weights are rounded to T before P·V; their sum stays
//    float32). K/V rows past `sep` are zero-filled on load and masked, so no
//    out-of-range value reaches a sum.
//  * bf16 at d = 16, 32, 64: fwd_wg_kernel of attn_tile.cuh, shared with
//    K4 (a block owns 192 query rows of one (group, head), 128 at d = 64;
//    K/V tiles arrive through TMA from a 3-D tensor map of the packed qkv
//    (G, S, 3·h·d), built here on the host; wgmma products, one ex2 per
//    score). `ItemFwdGeo` below tells it where the rows of each region lie:
//    a key tile that straddles `sep` holds real test rows, which are masked
//    by index; a train query tile's rows past `sep` belong to a test tile
//    and are computed but never stored.
// In both attention bodies the query tiles of the two regions are
// enumerated in one grid, so a tile never straddles `sep`, and a test tile
// reads KV head 0. K/V stream from device memory, so `sep` has no
// shared-memory ceiling (the Pallas kernel kept K/V resident in VMEM and was
// capped at 4096 rows).
#include "attn_tile.cuh"
#include "gemm_tile.cuh"

#include <type_traits>

namespace {

// ---- projection: C[M, N] = A[M, K] · B[N, K]^T -----------------------------
constexpr int PM = 64, PN = 64, PK = 16, PTHREADS = 256;

template <typename T>
__global__ void __launch_bounds__(PTHREADS)
proj_nt_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
               long long M, int N, int K) {
  __shared__ __align__(16) float As[PK][PM + 4];
  __shared__ __align__(16) float Bs[PK][PN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.y * PM;
  const int n0 = blockIdx.x * PN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += PK) {
    for (int i = tid; i < PM * PK; i += PTHREADS) {
      const int r = i / PK, kk = i - r * PK;
      const long long gm = m0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? to_f<T>(A[gm * K + gk]) : 0.f;
      const int gn = n0 + r;
      Bs[kk][r] = (gn < N && gk < K) ? to_f<T>(B[(long long)gn * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
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
      if (gn < N) C[gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

// ---- two-block online-softmax attention ------------------------------------
// A block owns one (group, head, query tile); the query tiles of the two
// regions are enumerated in one grid, so a tile never straddles `sep`, and a
// test tile reads KV head 0.
using attn::BKV;
using attn::BQ;

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
item_attn_kernel(const T* __restrict__ qkv, T* __restrict__ o, float* __restrict__ lse, int S,
                 int sep, int h, float scale) {
  __shared__ __align__(16) float Ks[BKV][D];
  __shared__ __align__(16) float Vs[BKV][D];
  const int g = blockIdx.z, hh = blockIdx.y, tid = threadIdx.x;
  const int n_qb_tr = (sep + BQ - 1) / BQ;
  const bool cross = (int)blockIdx.x >= n_qb_tr;
  const int q0 = cross ? sep + ((int)blockIdx.x - n_qb_tr) * BQ : (int)blockIdx.x * BQ;
  const int q_end = cross ? S : sep;
  const int kvh = cross ? 0 : hh;  // test rows share KV head 0
  const int hd = h * D, ld = 3 * hd;
  const T* grp = qkv + (long long)g * S * ld;
  const int qi = q0 + tid;
  const bool valid = qi < q_end;

  float q[D], acc[D], m, l;
#pragma unroll
  for (int c = 0; c < D; ++c) q[c] = valid ? to_f<T>(grp[(long long)qi * ld + hh * D + c]) : 0.f;
  attn::cc_rows<T, D>(q, grp + hd + kvh * D, grp + 2 * hd + kvh * D, ld, sep, scale, Ks, Vs, acc,
                      m, l);
  if (valid) {
    T* orow = o + ((long long)g * S + qi) * hd + hh * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = from_f<T>(acc[c] * inv);
    lse[((long long)g * h + hh) * S + qi] = m + logf(l);
  }
}

// Rows of fwd_wg_kernel in the packed qkv (G·S, 3·h·d), o (G·S, h·d) and lse
// (G, h, S); in the tensor map, qkv as (G, S, 3·h·d), group z = blockIdx.z.
// Grid (query tiles of both regions, h, G): a train tile (x < the train
// tiles) attends to the train keys of its own head y, a test tile to those
// of KV head 0.
template <int D>
struct ItemFwdGeo {
  __nv_bfloat16* o;
  float* lse;
  int G, S, sep, h;

  __host__ __device__ __forceinline__ int n_train(int bm) const { return (sep + bm - 1) / bm; }
  __host__ dim3 grid(int bm) const { return dim3(n_train(bm) + (S - sep + bm - 1) / bm, h, G); }
  __device__ __forceinline__ bool cross(int bm) const { return (int)blockIdx.x >= n_train(bm); }
  __device__ __forceinline__ attn::QTile<__nv_bfloat16> q_tile(int bm) const {
    const int x = blockIdx.x, ntr = n_train(bm), hh = blockIdx.y, z = blockIdx.z;
    const int q0 = x >= ntr ? sep + (x - ntr) * bm : x * bm, q_end = x >= ntr ? S : sep;
    const int hd = h * D;
    return {o + ((long long)z * S + q0) * hd + hh * D, hd, lse + ((long long)z * h + hh) * S + q0,
            min(bm, q_end - q0), q0, z, hh * D};
  }
  __device__ __forceinline__ attn::KeyRows keys(int bm) const {
    const int kvh = cross(bm) ? 0 : blockIdx.y;  // test rows share KV head 0
    return {sep, 0, (int)blockIdx.z, (h + kvh) * D, (2 * h + kvh) * D};
  }
};

// bf16: gemm_tile.cuh's product, the call K9 makes to recompute the same
// qkv (item_attn_bwd.cu), so the two give the same bits; float32: proj_nt_kernel
template <typename T>
int launch_proj(const void* a, const void* b, void* c, long long M, int N, int K,
                cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return gemm::run<T>((const T*)a, (const T*)b, M, N, K, false, true, 0, gemm::Store<T>{(T*)c, N},
                        stream);
  } else {
    const long long mblocks = (M + PM - 1) / PM;
    if (mblocks > 2147483647LL) return MMPFN_BAD_ARGS;
    dim3 grid((N + PN - 1) / PN, (unsigned)mblocks);
    proj_nt_kernel<T><<<grid, PTHREADS, 0, stream>>>((const T*)a, (const T*)b, (T*)c, M, N, K);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D>
int launch_attn(const void* qkv, void* o, float* lse, int G, int S, int sep, int h,
                cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  if constexpr (hopper::on_wgmma<T, D>) {
    attn::Maps maps;
    if (const int rc = hopper::make_map<D>(&maps.q, qkv, S, G, 3LL * h * D)) return rc;
    maps.k = maps.v = maps.q;
    return attn::fwd_wg<D>(ItemFwdGeo<D>{(__nv_bfloat16*)o, lse, G, S, sep, h}, maps, scale,
                           stream);
  } else {
    // query tiles of both regions in one grid: a tile never straddles sep
    const int nq = (sep + BQ - 1) / BQ + (S - sep + BQ - 1) / BQ;
    item_attn_kernel<T, D><<<dim3(nq, h, G), BQ, 0, stream>>>((const T*)qkv, (T*)o, lse, S, sep,
                                                              h, scale);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_attn(const void* qkv, void* o, float* lse, int G, int S, int sep, int h, int d,
                  cudaStream_t stream) {
  switch (d) {
    case 8: return launch_attn<T, 8>(qkv, o, lse, G, S, sep, h, stream);
    case 16: return launch_attn<T, 16>(qkv, o, lse, G, S, sep, h, stream);
    case 32: return launch_attn<T, 32>(qkv, o, lse, G, S, sep, h, stream);
    case 64: return launch_attn<T, 64>(qkv, o, lse, G, S, sep, h, stream);
    default: return MMPFN_BAD_ARGS;
  }
}

}  // namespace

extern "C" int mmpfn_proj_nt(const void* a, const void* b, void* c, long long M, int N, int K,
                             int dtype, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (M <= 0 || N <= 0) return 0;
  if (K < 1) return MMPFN_BAD_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MMPFN_F32) return launch_proj<float>(a, b, c, M, N, K, s);
  if (dtype == MMPFN_BF16) return launch_proj<__nv_bfloat16>(a, b, c, M, N, K, s);
  return MMPFN_BAD_ARGS;
}

extern "C" int mmpfn_item_attn(const void* qkv, void* o, void* lse, int G, int S, int sep, int h,
                               int d, int dtype, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (G <= 0 || S <= 0) return 0;
  if (sep < 1 || sep > S || h < 1 || h > 65535 || G > 65535) return MMPFN_BAD_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MMPFN_F32) return dispatch_attn<float>(qkv, o, (float*)lse, G, S, sep, h, d, s);
  if (dtype == MMPFN_BF16)
    return dispatch_attn<__nv_bfloat16>(qkv, o, (float*)lse, G, S, sep, h, d, s);
  return MMPFN_BAD_ARGS;
}
