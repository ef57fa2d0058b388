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
// cross region: 0.177 ms on the tensor cores), then 37 GFLOP of projections
// (0.037 ms). Beside them the exponentials: the two passes exponentiate
// each of the 5.48e8 (query, key, head) pairs once, 1.1e9 ex2 at 16 per
// clock per SM, about 0.26 ms at 1.98 GHz, the floor of the attention core
// at d = 32.
//
// Design (flash-attention-2's backward, two passes, no atomics):
//  1. qkv = x·W^T, rounded to T (the forward's projection, recomputed);
//  2. dq pass: a block owns 128 query rows of one (group, head) and streams
//     the train K/V in tiles of 64: p = exp(q·k·scale − lse) from the saved
//     lse, dp = do·v, ds = rnd(p·(dp − delta)·scale), dq += ds·k; dq is
//     rounded once at the end. A test tile reads KV head 0; a self-region
//     tile's rows past `sep` are real test rows with their weights forced to
//     0 (lse = +inf) and their dq not stored;
//  3. dk/dv pass: a block owns 128 train key rows of one (group, head), or of
//     KV head 0 for the cross region, and streams the query tiles (all six
//     heads' test rows for the cross region): dv += rnd(p)·do,
//     dk += ds·q, each rounded once at the end;
//  4. dx = dx_epi + dqkv·W_ext, rounded to T, with dqkv = [dq | dk, dv of the
//     self region | dk, dv of the cross region] (G·S, 3·h·d + 2·d);
//  5. dW_ext = dqkv^T·x over row chunks, float32 slabs summed in order.
// The rounding points are the Pallas kernel's: p, ds, dk/dv, dq
// (:327, :335, :382-386, :418). Keys past `sep` and queries past their
// region have their weights forced to 0, so no out-of-range value reaches a
// sum. float32 operands (and d = 8) run both passes on the CUDA cores, a
// thread per row; bf16 operands with d = 16, 32, 64 run them with wgmma on
// tiles that TMA brings from 3-D tensor maps of the packed qkv (G, S, 3·h·d)
// and of do (G, S, h·d), built here on the host: the products overlap the
// copies, and the exponentials and the softmax arithmetic between the
// products are left as the limit. Steps 2 and 3 are the passes of
// attn_bwd.cuh, shared with K11 (flash_bwd.cu); `ItemGeo` below tells them
// where the rows of each region lie in the packed qkv. Steps 1, 4 and 5 run
// on gemm_tile.cuh.
#include "attn_bwd.cuh"
#include "gemm_tile.cuh"

namespace {

using attn_bwd::KVRows;
using attn_bwd::OutRows;
using attn_bwd::QRows;

// Region bookkeeping shared by both passes: the query tiles of the self
// region come first, then those of the test rows (tiles of bm rows).
struct Layout {
  int S, sep, h, hd, ld_ext;  // ld_ext = 3·h·d + 2·d
  __host__ __device__ __forceinline__ int n_train_tiles(int bm) const { return (sep + bm - 1) / bm; }
  __host__ __device__ __forceinline__ int n_test_tiles(int bm) const { return (S - sep + bm - 1) / bm; }
};

// Where the rows of the passes of attn_bwd.cuh lie in the packed qkv
// (G·S, 3·h·d), do (G·S, h·d), lse and delta (G, h, S) and dqkv
// (G·S, 3·h·d + 2·d); in the tensor maps, qkv as (G, S, 3·h·d) and do as
// (G, S, h·d), group z = blockIdx.z, columns of the head.
//  dq pass, grid (query tiles of both regions, h, G): a self-region tile
//   attends to the train keys of its own head, a test tile to KV head 0;
//  dk/dv pass, grid (train key tiles, h + 1, G): y < h owns the keys of head
//   y against that head's train queries; y = h owns KV head 0 of the cross
//   region against all h heads' test queries, and writes the two extra
//   column blocks of dqkv.
template <typename T, int D>
struct ItemGeo {
  const T* qkv;
  const T* dout;
  const float* lse;
  const float* delta;
  T* dqkv;
  Layout L;
  int G;

  __host__ dim3 dq_grid(int bm) const {
    return dim3(L.n_train_tiles(bm) + L.n_test_tiles(bm), L.h, G);
  }
  __host__ dim3 dkv_grid(int bm) const { return dim3(L.n_train_tiles(bm), L.h + 1, G); }
  __device__ __forceinline__ long long base() const { return (long long)blockIdx.z * L.S; }
  __device__ __forceinline__ bool cross_q(int bm) const {
    return (int)blockIdx.x >= L.n_train_tiles(bm);
  }
  __device__ __forceinline__ int q0(int bm) const {
    const int tile = blockIdx.x, ntr = L.n_train_tiles(bm);
    return tile >= ntr ? L.sep + (tile - ntr) * bm : tile * bm;
  }
  __device__ __forceinline__ QRows<T> dq_rows(int bm) const {
    const int q0_ = q0(bm), hh = blockIdx.y, qend = cross_q(bm) ? L.S : L.sep;
    const long long hi = ((long long)blockIdx.z * L.h + hh) * L.S + q0_;
    return {qkv + (base() + q0_) * 3 * L.hd + hh * D, dout + (base() + q0_) * L.hd + hh * D,
            3LL * L.hd, (long long)L.hd, lse + hi, delta + hi, min(bm, qend - q0_),
            q0_, (int)blockIdx.z, hh * D, hh * D};
  }
  // the keys of a dq block: its own head's, or KV head 0 for a test tile
  __device__ __forceinline__ KVRows<T> dq_keys(int bm) const {
    const int kvh = cross_q(bm) ? 0 : blockIdx.y;
    const T* k = qkv + base() * 3 * L.hd + L.hd + kvh * D;
    return {k, k + L.hd, 3LL * L.hd, L.sep, 0, (int)blockIdx.z, L.hd + kvh * D, 2 * L.hd + kvh * D};
  }
  __device__ __forceinline__ OutRows<T> dq_out(int bm) const {
    return {dqkv + (base() + q0(bm)) * L.ld_ext + blockIdx.y * D, (long long)L.ld_ext};
  }

  __device__ __forceinline__ bool cross_kv() const { return (int)blockIdx.y == L.h; }
  __device__ __forceinline__ int kvh() const { return cross_kv() ? 0 : blockIdx.y; }
  __device__ __forceinline__ KVRows<T> dkv_keys(int bm) const {
    const int k0 = blockIdx.x * bm;
    const T* k = qkv + (base() + k0) * 3 * L.hd + L.hd + kvh() * D;
    return {k, k + L.hd, 3LL * L.hd, min(bm, L.sep - k0),
            k0, (int)blockIdx.z, L.hd + kvh() * D, 2 * L.hd + kvh() * D};
  }
  __device__ __forceinline__ int dkv_segments() const { return cross_kv() ? L.h : 1; }
  __device__ __forceinline__ QRows<T> dkv_segment(int i) const {
    const bool cross = cross_kv();
    const int hq = cross ? i : kvh(), qbeg = cross ? L.sep : 0, qend = cross ? L.S : L.sep;
    const long long hi = ((long long)blockIdx.z * L.h + hq) * L.S + qbeg;
    return {qkv + (base() + qbeg) * 3 * L.hd + hq * D, dout + (base() + qbeg) * L.hd + hq * D,
            3LL * L.hd, (long long)L.hd, lse + hi, delta + hi, qend - qbeg,
            qbeg, (int)blockIdx.z, hq * D, hq * D};
  }
  __device__ __forceinline__ OutRows<T> dk_out(int bm) const {
    const int col = cross_kv() ? 3 * L.hd : L.hd + kvh() * D;
    return {dqkv + (base() + blockIdx.x * bm) * L.ld_ext + col, (long long)L.ld_ext};
  }
  __device__ __forceinline__ OutRows<T> dv_out(int bm) const {
    const OutRows<T> k = dk_out(bm);
    return {k.p + (cross_kv() ? D : L.hd), k.ld};
  }
};

template <typename T, int D>
int passes(const T* qkv, const T* dout, const float* lse, const float* delta, T* dqkv, int G,
           Layout L, cudaStream_t st) {
  const float scale = 1.f / sqrtf((float)D);
  attn_bwd::Maps maps{};
  if constexpr (hopper::on_wgmma<T, D>) {
    using hopper::make_map;
    int rc;
    if ((rc = make_map<D>(&maps.q, qkv, L.S, G, 3LL * L.hd)) ||
        (rc = make_map<D>(&maps.dout, dout, L.S, G, L.hd)))
      return rc;
    maps.k = maps.v = maps.q;
  }
  return attn_bwd::passes<T, D>(ItemGeo<T, D>{qkv, dout, lse, delta, dqkv, L, G}, maps, scale, st);
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
