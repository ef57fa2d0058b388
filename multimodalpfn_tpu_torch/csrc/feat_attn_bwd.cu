// K7: the backward of K1 (item-major) and of K5 (sample-major, "K7s"),
// out = LN(x + W_out·attn(x)) over the t feature tokens of every row of x,
// (member, sample) rows of an item-major x (b, t, s, e) or the rows of a
// sample-major x (rows, t, e):
//   given g = dL/dout, returns dx (x's layout and type), dW_qkv (3·h·d, e)
//   and dW_out (h·d, e) in float32, each summed over all tokens.
//
// Replaces multimodalpfn_tpu/ops/pallas_fused.py:_attn_bwd_kernel_im
// (pallas_call in _attn_bwd_call_im, :1070/:1082) and _attn_bwd_kernel
// (pallas_call in _attn_bwd_call, :1024/:1040); body _feat_attn_bwd_core
// :898 for both.
//
// What bounds it on the H100: the products with the weights, 12 of 2·e·h·d
// FLOPs per token (the QKV recompute, the out-projection recompute, do, dx,
// and the weight gradients): 52 GFLOP at the flagship fine-tune shape
// (1 × 30 × 1838 tokens, e = 192). The per-row attention (t ≤ 64 tokens) is
// small beside them.
//
// Design: the Pallas kernel recomputes a block of rows in VMEM and carries
// dW over a sequential grid. Here the sublayer is a sequence of launches,
// each a kernel of this file or of gemm_tile.cuh, with the intermediates in
// device memory:
//   1. qkv = x·W_qkv^T, rounded to T (the forward's projection);
//   2. o: per (row, head) a warp recomputes the softmax weights (q scaled and
//      rounded as in K1) and o = rnd(rnd(p)·v);
//   3. u = x + o·W_out (float32), 4. du = LN'(u)·g (float32 and rounded),
//   5. do = rnd(du·W_out^T);
//   6. per (row, head) a warp forms p, dp = do·v^T, ds = rnd(p·(dp − Σ p·dp)),
//      dq = rnd(ds·k·scale), dk = rnd(ds^T·q), dv = rnd(rnd(p)^T·do);
//   7. dx = du + [dq dk dv]·W_qkv, rounded to T;
//   8. dW_qkv = [dq dk dv]^T·x and dW_out = o^T·du, split over rows into
//      float32 slabs summed in order (no atomics: the same bits every run).
// A row's t tokens lie s·3·h·d elements apart (item-major) or 3·h·d apart
// (sample-major); the warp gathers its head's q, k, v (and do) rows into
// shared memory once. The layout is a compile-time flag (SM) of the two
// per-row attention kernels, as K5 is K1's body with a flag (a runtime
// stride cost K1 11 % in an A/B); the products of steps 1, 3-5, 7 and 8 see
// only the flattened tokens and are the same launches in both layouts.
// Scores and weights of the row sit in shared memory ([t][t|1] floats).
// Tokens are never padded, so no mask is needed.
#include "gemm_tile.cuh"

namespace {

// Shared memory of one (row, head) warp: Q, K, V, dO rows [t][D+1] and the
// scores / weights [t][t|1], floats.
template <int D>
size_t attn_smem(int t) {
  return sizeof(float) * (4 * (size_t)t * (D + 1) + 2 * (size_t)t * (t | 1));
}

// Gather the head's rows of token j of row (bi, s) from a (b, t, s, ncol)
// array at column `col`: n rows of D values, scaled by `mul` and rounded to T
// when `mul` != 1. A sample-major caller passes bi = its row, si = 0, s = 1.
template <typename T, int D>
__device__ __forceinline__ void gather(float* dst, const T* src, int t, int s, int bi, int si,
                                       int ncol, int col, float mul) {
  const int lane = threadIdx.x;
  for (int i = lane; i < t * D; i += 32) {
    const int j = i / D, c = i - j * D;
    const float v = to_f<T>(src[((long long)(bi * t + j) * s + si) * ncol + col + c]);
    dst[j * (D + 1) + c] = mul == 1.f ? v : round_t<T>(v * mul);
  }
}

// 2. o = rnd(rnd(softmax(q·k^T))·v) for one (row, head): grid (rows, h), one warp.
template <typename T, int D, bool SM>
__global__ void __launch_bounds__(32)
attn_o_kernel(const T* __restrict__ qkv, T* __restrict__ o, int t, int s_im, int h, float scale) {
  extern __shared__ __align__(16) float sm[];
  // item-major rows are (member, sample) pairs; a sample-major row is whole
  // (s = 1 at compile time)
  const int s = SM ? 1 : s_im;
  const int row = blockIdx.x, hh = blockIdx.y;
  const int bi = SM ? row : row / s, si = SM ? 0 : row - bi * s;
  const int hd = h * D, lane = threadIdx.x;
  float* Q = sm;
  float* K = Q + t * (D + 1);
  float* V = K + t * (D + 1);
  gather<T, D>(Q, qkv, t, s, bi, si, 3 * hd, hh * D, scale);
  gather<T, D>(K, qkv, t, s, bi, si, 3 * hd, hd + hh * D, 1.f);
  gather<T, D>(V, qkv, t, s, bi, si, 3 * hd, 2 * hd + hh * D, 1.f);
  __syncwarp();
  for (int i = lane; i < t; i += 32) {
    float q[D];
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = Q[i * (D + 1) + c];
    float m = -INFINITY;
    for (int j = 0; j < t; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) a = fmaf(q[c], K[j * (D + 1) + c], a);
      m = fmaxf(m, a);
    }
    float l = 0.f;
    for (int j = 0; j < t; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) a = fmaf(q[c], K[j * (D + 1) + c], a);
      l += expf(a - m);
    }
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    for (int j = 0; j < t; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) a = fmaf(q[c], K[j * (D + 1) + c], a);
      const float p = round_t<T>(expf(a - m) / l);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, V[j * (D + 1) + c], acc[c]);
    }
    T* dst = o + ((long long)(bi * t + i) * s + si) * hd + hh * D;
#pragma unroll
    for (int c = 0; c < D; ++c) dst[c] = from_f<T>(acc[c]);
  }
}

// 6. the attention backward of one (row, head): grid (rows, h), one warp.
// Phase 1, lane = query i: scores, weights p (float32), dp, delta_i = Σ_j p·dp,
// ds = rnd(p·(dp − delta_i)) parked in shared memory, dq_i = rnd(scale·ds·k).
// Phase 2, lane = key j: dk_j = rnd(Σ_i ds_ij·q_i), dv_j = rnd(Σ_i rnd(p_ij)·do_i).
template <typename T, int D, bool SM>
__global__ void __launch_bounds__(32)
attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
                int t, int s_im, int h, float scale) {
  extern __shared__ __align__(16) float sm[];
  // item-major rows are (member, sample) pairs; a sample-major row is whole
  // (s = 1 at compile time)
  const int s = SM ? 1 : s_im;
  const int row = blockIdx.x, hh = blockIdx.y;
  const int bi = SM ? row : row / s, si = SM ? 0 : row - bi * s;
  const int hd = h * D, lane = threadIdx.x, tp = t | 1;
  float* Q = sm;
  float* K = Q + t * (D + 1);
  float* V = K + t * (D + 1);
  float* dO = V + t * (D + 1);
  float* P = dO + t * (D + 1);  // [t][tp] weights
  float* DS = P + t * tp;       // [t][tp] dp, then ds
  gather<T, D>(Q, qkv, t, s, bi, si, 3 * hd, hh * D, scale);
  gather<T, D>(K, qkv, t, s, bi, si, 3 * hd, hd + hh * D, 1.f);
  gather<T, D>(V, qkv, t, s, bi, si, 3 * hd, 2 * hd + hh * D, 1.f);
  gather<T, D>(dO, dout, t, s, bi, si, hd, hh * D, 1.f);
  __syncwarp();
  for (int i = lane; i < t; i += 32) {
    float q[D], g[D];
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = Q[i * (D + 1) + c], g[c] = dO[i * (D + 1) + c];
    float m = -INFINITY;
    for (int j = 0; j < t; ++j) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        a = fmaf(q[c], K[j * (D + 1) + c], a);
        b = fmaf(g[c], V[j * (D + 1) + c], b);
      }
      P[i * tp + j] = a;
      DS[i * tp + j] = b;
      m = fmaxf(m, a);
    }
    float l = 0.f;
    for (int j = 0; j < t; ++j) l += expf(P[i * tp + j] - m);
    float delta = 0.f;
    for (int j = 0; j < t; ++j) {
      const float p = expf(P[i * tp + j] - m) / l;
      P[i * tp + j] = p;
      delta = fmaf(p, DS[i * tp + j], delta);
    }
    float dq[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dq[c] = 0.f;
    for (int j = 0; j < t; ++j) {
      const float ds = round_t<T>(P[i * tp + j] * (DS[i * tp + j] - delta));
      DS[i * tp + j] = ds;
#pragma unroll
      for (int c = 0; c < D; ++c) dq[c] = fmaf(ds, K[j * (D + 1) + c], dq[c]);
    }
    T* dst = dqkv + ((long long)(bi * t + i) * s + si) * 3 * hd + hh * D;
#pragma unroll
    for (int c = 0; c < D; ++c) dst[c] = from_f<T>(dq[c] * scale);
  }
  __syncwarp();
  for (int j = lane; j < t; j += 32) {
    float dk[D], dv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dk[c] = dv[c] = 0.f;
    for (int i = 0; i < t; ++i) {
      const float ds = DS[i * tp + j], p = round_t<T>(P[i * tp + j]);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dk[c] = fmaf(ds, Q[i * (D + 1) + c], dk[c]);
        dv[c] = fmaf(p, dO[i * (D + 1) + c], dv[c]);
      }
    }
    T* dst = dqkv + ((long long)(bi * t + j) * s + si) * 3 * hd + hd + hh * D;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dst[c] = from_f<T>(dk[c]);
      dst[hd + c] = from_f<T>(dv[c]);
    }
  }
}

template <typename T, int D, bool SM>
int attn_launches(const T* qkv, T* o, const T* dout, T* dqkv, int rows, int t, int s, int h,
                  bool backward, cudaStream_t st) {
  const float scale = 1.f / sqrtf((float)D);
  const dim3 grid(rows, h);
  const size_t smem = attn_smem<D>(t);
  if (smem > MMPFN_MAX_SMEM) return MMPFN_BAD_ARGS;
  if (!backward) {
    int rc = mmpfn_allow_smem(attn_o_kernel<T, D, SM>, smem);
    if (rc) return rc;
    attn_o_kernel<T, D, SM><<<grid, 32, smem, st>>>(qkv, o, t, s, h, scale);
  } else {
    int rc = mmpfn_allow_smem(attn_bwd_kernel<T, D, SM>, smem);
    if (rc) return rc;
    attn_bwd_kernel<T, D, SM><<<grid, 32, smem, st>>>(qkv, dout, dqkv, t, s, h, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool SM>
int attn(const T* qkv, T* o, const T* dout, T* dqkv, int rows, int t, int s, int h, int d,
         bool backward, cudaStream_t st) {
  switch (d) {
    case 8: return attn_launches<T, 8, SM>(qkv, o, dout, dqkv, rows, t, s, h, backward, st);
    case 16: return attn_launches<T, 16, SM>(qkv, o, dout, dqkv, rows, t, s, h, backward, st);
    case 32: return attn_launches<T, 32, SM>(qkv, o, dout, dqkv, rows, t, s, h, backward, st);
    case 64: return attn_launches<T, 64, SM>(qkv, o, dout, dqkv, rows, t, s, h, backward, st);
    default: return MMPFN_BAD_ARGS;
  }
}

// The whole backward over b rows of t tokens (item-major: b members of s
// samples each; sample-major: s = 1).
template <bool SM>
int backward(const void* x, const void* wqkv, const void* wout, const void* g, void* qkv,
             void* o, float* u, float* du, void* du_c, void* dout, void* dqkv, void* dx,
             float* dwqkv, float* dwout, float* work, int b, int t, int s, int e, int h, int d,
             int wgrad_rows, int dtype, cudaStream_t st) {
  const long long rows = (long long)b * t * s;
  const int hd = h * d;
  return mmpfn_dispatch(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    const T *X = (const T*)x, *Wqkv = (const T*)wqkv, *Wout = (const T*)wout, *G = (const T*)g;
    T *QKV = (T*)qkv, *O = (T*)o, *DUc = (T*)du_c, *DO = (T*)dout, *DQKV = (T*)dqkv, *DX = (T*)dx;
    int rc;
    if ((rc = gemm::run<T>(X, Wqkv, rows, 3 * hd, e, false, true, 0, gemm::Store<T>{QKV, 3 * hd}, st))) return rc;
    if ((rc = attn<T, SM>(QKV, O, nullptr, nullptr, b * s, t, s, h, d, false, st))) return rc;
    if ((rc = gemm::run<T>(O, Wout, rows, e, hd, false, false, 0, gemm::AddStore<float, T>{u, X, e}, st))) return rc;
    if ((rc = gemm::ln_bwd<T>(u, G, du, DUc, rows, e, st))) return rc;
    if ((rc = gemm::run<T>(DUc, Wout, rows, hd, e, false, true, 0, gemm::Store<T>{DO, hd}, st))) return rc;
    if ((rc = attn<T, SM>(QKV, nullptr, DO, DQKV, b * s, t, s, h, d, true, st))) return rc;
    if ((rc = gemm::run<T>(DQKV, Wqkv, rows, e, 3 * hd, false, false, 0, gemm::AddStore<T, float>{DX, du, e}, st))) return rc;
    if ((rc = gemm::wgrad<T>(DQKV, X, dwqkv, work, rows, 3 * hd, e, wgrad_rows, st))) return rc;
    return gemm::wgrad<T>(O, DUc, dwout, work, rows, hd, e, wgrad_rows, st);
  });
}

}  // namespace

extern "C" int mmpfn_feat_attn_bwd_im(const void* x, const void* wqkv, const void* wout,
                                      const void* g, void* qkv, void* o, float* u, float* du,
                                      void* du_c, void* dout, void* dqkv, void* dx, float* dwqkv,
                                      float* dwout, float* work, int b, int t, int s, int e,
                                      int h, int d, int wgrad_rows, int dtype, int device,
                                      void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (b <= 0 || s <= 0) return 0;
  if (t < 1 || t > 64 || e < 1 || h < 1) return MMPFN_BAD_ARGS;
  return backward<false>(x, wqkv, wout, g, qkv, o, u, du, du_c, dout, dqkv, dx, dwqkv, dwout,
                         work, b, t, s, e, h, d, wgrad_rows, dtype, (cudaStream_t)stream);
}

// K7s: x and g (rows, t, e), the tokens of a row contiguous.
extern "C" int mmpfn_feat_attn_bwd(const void* x, const void* wqkv, const void* wout,
                                   const void* g, void* qkv, void* o, float* u, float* du,
                                   void* du_c, void* dout, void* dqkv, void* dx, float* dwqkv,
                                   float* dwout, float* work, int rows, int t, int e, int h, int d,
                                   int wgrad_rows, int dtype, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (t < 1 || t > 64 || e < 1 || h < 1) return MMPFN_BAD_ARGS;
  return backward<true>(x, wqkv, wout, g, qkv, o, u, du, du_c, dout, dqkv, dx, dwqkv, dwout,
                        work, rows, t, 1, e, h, d, wgrad_rows, dtype, (cudaStream_t)stream);
}
