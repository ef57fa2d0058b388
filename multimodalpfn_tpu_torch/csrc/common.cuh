// Shared helpers of the hand-written kernels: element types, rounding to the
// compute dtype, warp reductions, and the C-interface conventions.
//
// Every C entry point takes the CUDA device index of its operands and selects
// it first: this library links its own CUDA runtime, whose current device is
// not PyTorch's.
//
// Every kernel is a template on T (float or __nv_bfloat16): operands are read
// as T, all products are accumulated in float32, and values are rounded to T
// (round to nearest even, as XLA and torch convert) exactly where the Pallas
// kernels they replace cast to the compute dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MMPFN_F32 0
#define MMPFN_BF16 1

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value rounded to T and widened back (identity for float)
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

// Vector loads and stores of 2 or 4 consecutive elements (the pointer must be
// aligned to that many elements), widened to or narrowed from float.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load2(const float* p, float v[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float v[2]) {
  const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// Tensor-core product c += a·b for one 16×8 tile with a 16-deep contraction
// (mma.sync m16n8k16, bf16 inputs, float32 accumulation). Lane l holds, with
// g = l / 4 and q = l % 4:
//   a: rows g and g+8, columns 2q, 2q+1 and 2q+8, 2q+9 (as a[0..3]: (g, 2q),
//      (g+8, 2q), (g, 2q+8), (g+8, 2q+8), each a pair of adjacent columns);
//   b: column g, rows 2q, 2q+1 (b0) and 2q+8, 2q+9 (b1);
//   c: rows g (c[0], c[1]) and g+8 (c[2], c[3]), columns 2q and 2q+1.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The a operand of mma_bf16_16816: the 16×16 bf16 tile at `tile`, row-major
// with a row stride of `ld` elements, in shared memory.
__device__ __forceinline__ void lds_a(uint32_t a[4], const __nv_bfloat16* tile, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = *reinterpret_cast<const uint32_t*>(tile + (g + 8 * (i & 1)) * ld + 2 * q + 8 * (i >> 1));
}

// The b operand of mma_bf16_16816 from a 16×8 bf16 tile stored row-major
// (rows = the contraction) in shared memory: lane l passes the address of row
// l % 16 (16-byte aligned); ldmatrix transposes into the fragment layout.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1, const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
}

// two floats rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LN(res + acc) for the 16 rows of a warp whose products are the mma
// accumulators acc[E / 8][4] (tile n holds output columns 8n..8n+7), with the
// residual rows in shared memory at `res` (row stride `ld`). Row r (0..15) is
// stored to out_row(r), a pointer to E elements, unless that is null.
// Affine-free LayerNorm, eps 1e-5, in float32: each row lives in one quad of
// lanes, which combine their sums with two shuffles.
template <int E, typename OutRow>
__device__ __forceinline__ void residual_ln_store(const float (&acc)[E / 8][4],
                                                  const __nv_bfloat16* res, int ld,
                                                  OutRow out_row) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float u[E / 8][2];
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < E / 8; ++n) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(res + (g + 8 * r) * ld + n * 8 + 2 * q4));
      u[n][0] = xv.x + acc[n][2 * r];
      u[n][1] = xv.y + acc[n][2 * r + 1];
      s += u[n][0] + u[n][1];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mean = s / E;
    float q = 0.f;
#pragma unroll
    for (int n = 0; n < E / 8; ++n)
      q += (u[n][0] - mean) * (u[n][0] - mean) + (u[n][1] - mean) * (u[n][1] - mean);
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    const float rstd = 1.f / sqrtf(q / E + 1e-5f);
    if (__nv_bfloat16* dst = out_row(g + 8 * r)) {
#pragma unroll
      for (int n = 0; n < E / 8; ++n)
        store2(dst + n * 8 + 2 * q4, (u[n][0] - mean) * rstd, (u[n][1] - mean) * rstd);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Set a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB; returns the CUDA error code (0 on success).
template <typename K> static int mmpfn_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Hopper gives a block at most 227 KB of shared memory.
#define MMPFN_MAX_SMEM (227 * 1024)
// Returned by a launcher for arguments its kernel does not take.
#define MMPFN_BAD_ARGS 10001
// Returned where a TMA tensor map could not be encoded.
#define MMPFN_TMA_FAILED 10002
