// K8: the backward of K3, out = LN(x + gelu(x·W1)·W2) over rows of x (rows, e):
//   given g = dL/dout, returns dx (rows, e) in x's type and dW1 (e, nhid),
//   dW2 (nhid, e) in float32, summed over all rows.
//
// Replaces multimodalpfn_tpu/ops/pallas_fused.py:_mlp_bwd_kernel_g and
// _mlp_bwd_kernel (pallas_call in _mlp_bwd_call, :709/:720/:759).
//
// What bounds it on the H100: the bytes of its launches. Six products of
// 2·e·nhid FLOPs per row (98 GFLOP at the flagship fine-tune shape, 55 140
// rows × 192 × 768: 0.099 ms at the bf16 peak) move about 1.25 GB through
// device memory with the float32 intermediates below (0.37 ms at 3.35 TB/s).
//
// Design: the Pallas kernel recomputes a block of rows in VMEM and carries
// dW1, dW2 over a sequential grid. Here each product is a launch of
// gemm_tile.cuh (bf16: wgmma from a TMA ring, transposed operands named
// MN-major by descriptor, the epilogue staged through shared memory into
// vector loads and stores; float32: the CUDA cores) with its own epilogue,
// the intermediates in device memory:
//   1. z = x·W1, epilogue: gz = rnd(gelu(z)) and gelu'(z) (exact erf, as K3;
//      the Pallas kernel's Abramowitz-Stegun polynomial is not carried over);
//   2. u = x + gz·W2 (float32); 3. du = LN'(u)·g (float32 and rounded);
//   4. dz = rnd((du·W2^T) ∘ gelu'(z)); 5. dx = du + dz·W1^T, rounded to T;
//   6. dW1 = x^T·dz and dW2 = gz^T·du over row chunks, float32 slabs summed
//      in order (no atomics: the same bits every run).
// The rounding points are the Pallas kernel's: gz, du, dz (:621-642).
#include "gemm_tile.cuh"

namespace {

// gz = z·Φ(z) and gelu'(z) = Φ(z) + z·φ(z)
__device__ __forceinline__ void gelu_and_grad(float z, float& gz, float& grad) {
  const float cdf = 0.5f * (1.f + erff(z * 0.70710678118654752f));
  gz = z * cdf;
  grad = cdf + z * expf(-0.5f * z * z) * 0.39894228040143268f;
}

template <typename T>
struct GeluEpi {  // gz = rnd(gelu(v)), gzg = gelu'(v)
  T* gz;
  float* gzg;
  int ld;
  using Res = gemm::NoRes;
  bool aligned() const { return gemm::quad_aligned(gz, ld) && gemm::quad_aligned(gzg, ld); }
  __device__ __forceinline__ void operator()(long long m, int n, float z, int) const {
    float a, b;
    gelu_and_grad(z, a, b);
    gz[m * ld + n] = from_f<T>(a);
    gzg[m * ld + n] = b;
  }
  __device__ __forceinline__ Res load(long long, int) const { return {}; }
  __device__ __forceinline__ void quad(long long m, int n, const float (&z)[4], Res, int) const {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) gelu_and_grad(z[i], a[i], b[i]);
    store4(gz + m * ld + n, a);
    store4(gzg + m * ld + n, b);
  }
};

template <typename T>
struct MulEpi {  // out = rnd(v · r)
  T* out;
  const float* r;
  int ld;
  using Res = gemm::Res4;
  bool aligned() const { return gemm::quad_aligned(out, ld) && gemm::quad_aligned(r, ld); }
  __device__ __forceinline__ void operator()(long long m, int n, float v, int) const {
    out[m * ld + n] = from_f<T>(v * r[m * ld + n]);
  }
  __device__ __forceinline__ Res load(long long m, int n) const {
    Res res;
    load4(r + m * ld + n, res.v);
    return res;
  }
  __device__ __forceinline__ void quad(long long m, int n, const float (&v)[4], const Res& res,
                                       int) const {
    const float o[4] = {v[0] * res.v[0], v[1] * res.v[1], v[2] * res.v[2], v[3] * res.v[3]};
    store4(out + m * ld + n, o);
  }
};

}  // namespace

extern "C" int mmpfn_mlp_ln_bwd(const void* x, const void* w1, const void* w2, const void* g,
                                void* gz, float* gzg, float* u, float* du, void* du_c, void* dz,
                                void* dx, float* dw1, float* dw2, float* work, long long rows,
                                int e, int nhid, int wgrad_rows, int dtype, int device,
                                void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (e < 1 || nhid < 1) return MMPFN_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  return mmpfn_dispatch(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    const T *X = (const T*)x, *W1 = (const T*)w1, *W2 = (const T*)w2, *G = (const T*)g;
    T *GZ = (T*)gz, *DUc = (T*)du_c, *DZ = (T*)dz, *DX = (T*)dx;
    int rc;
    if ((rc = gemm::run<T>(X, W1, rows, nhid, e, false, false, 0, GeluEpi<T>{GZ, gzg, nhid}, st))) return rc;
    if ((rc = gemm::run<T>(GZ, W2, rows, e, nhid, false, false, 0, gemm::AddStore<float, T>{u, X, e}, st))) return rc;
    if ((rc = gemm::ln_bwd<T>(u, G, du, DUc, rows, e, st))) return rc;
    if ((rc = gemm::run<T>(DUc, W2, rows, nhid, e, false, true, 0, MulEpi<T>{DZ, gzg, nhid}, st))) return rc;
    if ((rc = gemm::run<T>(DZ, W1, rows, e, nhid, false, true, 0, gemm::AddStore<T, float>{DX, du, e}, st))) return rc;
    if ((rc = gemm::wgrad<T>(X, DZ, dw1, work, rows, e, nhid, wgrad_rows, st))) return rc;
    return gemm::wgrad<T>(GZ, DUc, dw2, work, rows, nhid, e, wgrad_rows, st);
  });
}
