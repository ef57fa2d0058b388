// K10: the backward of K2b, out = LN(x + o·W_out) over rows of x (G·S, e) with
// the attention output o (G·S, h·d):
//   given g = dL/dout, returns du = rnd(LN'(u)·g) (the cotangent of x through
//   the residual, in x's type), do = du·W_out^T rounded to T, the attention
//   backward's per-head delta = Σ_d do·o (G, h, S) float32, from do before it
//   is rounded (what K9 consumes), and dW_out = o^T·du (h·d, e) in float32,
//   summed over all rows.
//
// Replaces multimodalpfn_tpu/ops/pallas_item_fused.py:_epi_bwd_kernel
// (pallas_call in _epi_bwd_call, :696/:700).
//
// What bounds it on the H100: memory traffic. Per row it reads x, o, g and
// writes du, do (≈ 110 MB in bf16 at the flagship fine-tune shape, 30 × 1838
// rows of 192) against 3 small products of 2·e·h·d FLOPs.
//
// Design: launches of gemm_tile.cuh's tiled products plus one row kernel:
//   1. u = x + o·W_out (float32); 2. du = rnd(LN'(u)·g);
//   3. do32 = du·W_out^T (float32);
//   4. per row a warp writes do = rnd(do32) and, per head, delta = Σ_d do32·o;
//   5. dW_out = o^T·du over row chunks, float32 slabs summed in order (no
//      atomics: the same bits every run).
// The port keeps o as (G, S, h·d) and delta as (G, h, S): K2a's layouts, not
// the TPU's (G, h·d, S).
#include "gemm_tile.cuh"

namespace {

// 4. a warp per row of S: do = rnd(do32), delta[g, head, s] = Σ_d do32·o.
template <typename T>
__global__ void delta_kernel(const float* __restrict__ do32, const T* __restrict__ o,
                             T* __restrict__ dout, float* __restrict__ delta, long long rows,
                             int s, int h, int d) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int hd = h * d;
  const long long gi = row / s;
  const int si = (int)(row - gi * s);
  for (int hh = 0; hh < h; ++hh) {
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) {
      const long long i = row * hd + hh * d + c;
      const float v = do32[i];
      dout[i] = from_f<T>(v);
      acc = fmaf(v, to_f<T>(o[i]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) delta[(gi * h + hh) * s + si] = acc;
  }
}

}  // namespace

extern "C" int mmpfn_item_epilogue_bwd(const void* x, const void* o, const void* wout,
                                       const void* g, float* u, void* du_c, float* do32,
                                       void* dout, float* delta, float* dw, float* work,
                                       long long rows, int s, int e, int h, int d, int wgrad_rows,
                                       int dtype, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (e < 1 || h < 1 || d < 1 || s < 1 || rows % s) return MMPFN_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = h * d;
  return mmpfn_dispatch(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    const T *X = (const T*)x, *O = (const T*)o, *Wout = (const T*)wout, *G = (const T*)g;
    T *DUc = (T*)du_c, *DO = (T*)dout;
    int rc;
    if ((rc = gemm::run<T>(O, Wout, rows, e, hd, false, false, 0, gemm::AddStore<float, T>{u, X, e}, st))) return rc;
    if ((rc = gemm::ln_bwd<T>(u, G, nullptr, DUc, rows, e, st))) return rc;
    if ((rc = gemm::run<T>(DUc, Wout, rows, hd, e, false, true, 0, gemm::Store<float>{do32, hd}, st))) return rc;
    delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(do32, O, DO, delta, rows, s, h, d);
    if ((rc = (int)cudaGetLastError())) return rc;
    return gemm::wgrad<T>(O, DUc, dw, work, rows, hd, e, wgrad_rows, st);
  });
}
