// Residual + LayerNorm on the accumulator of a 64-row wgmma product, for the
// bf16 tensor-core kernels that end in out = LN(x + product) with the x rows
// in shared memory as TMA wrote them (K3's wgmma body, mlp_ln.cu), its
// backward on the accumulator (K8's row pass, mlp_ln_bwd.cu), and the gelu
// that both MLP bodies compute.
//
// The accumulator of a warpgroup's 64 × E product (E / 2 floats a thread,
// the layout of hopper.cuh: register 4i + 2r + c is row 16·warp + g + 8r,
// column 8i + 2·(lane % 4) + c, g = lane / 4) holds each row's E outputs in
// one quad of lanes, so the row sums reduce with two xor-shuffles. The x
// rows are E / 64 boxes of 64 rows × 64 columns (8 KB each) under the
// 128-byte swizzle: the 16-byte piece p of row m lies at piece p ^ (m % 8).
// Read as wgmma A fragments (x_frags), they sit in the accumulator's own
// layout, so the residual adds register to register. The LN output,
// rounded to bf16, is written over the x rows in their layout, so a TMA
// store of the same boxes writes it out.
#pragma once

#include "hopper.cuh"

namespace hopper {

// The address, in a warpgroup's 64 rows as E / 64 boxes under the 128-byte
// swizzle at `tile`, of the pair of columns 8i + 2·(lane % 4), + 1 of row
// 16·warp + g + 8r: the place of accumulator registers 4i + 2r, 4i + 2r + 1.
// (row % 8) == g, so the swizzle moves piece i % 8 of the row to (i % 8) ^ g.
__device__ __forceinline__ uint32_t* tile_pair(uint8_t* tile, int i, int r) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  return reinterpret_cast<uint32_t*>(tile + (16 * ((threadIdx.x >> 5) & 3) + g) * 128 + 4 * (lane & 3) +
                                     r * 1024 + (i / 8) * 8192 + (((i % 8) ^ g) << 4));
}

// The x rows of a warpgroup (64 rows as E / 64 boxes under the 128-byte
// swizzle at `tile`) as the A fragments of a wgmma product with k = E: xa[j]
// holds columns 16j..16j + 15 in hopper.cuh's register layout, so column
// 8i + 2·(lane % 4) + c of row 16·warp + g + 8r is half c of xa[i / 2][r +
// 2·(i % 2)], the place of accumulator register 4i + 2r + c.
template <int E>
__device__ __forceinline__ void x_frags(uint32_t (&xa)[E / 16][4], uint8_t* tile) {
  static_assert(E % 64 == 0, "rows of whole 64-column boxes");
#pragma unroll
  for (int i = 0; i < E / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) xa[i / 2][r + 2 * (i & 1)] = *tile_pair(tile, i, r);
}

// out = LN(x + acc), affine-free (eps 1e-5), in float32: the mean, then the
// mean of squared deviations, as the plain version computes them. The
// residual comes from x's A fragments (x_frags); the output, rounded to
// bf16, is written over the x rows at `tile` in their layout, each thread
// at the positions of its own outputs, for a TMA store of the same boxes.
template <int E>
__device__ __forceinline__ void residual_ln_tile(float (&acc)[E / 2], const uint32_t (&xa)[E / 16][4],
                                                 uint8_t* tile) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint32_t xv = xa[i / 2][r + 2 * (i & 1)];
      const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
      acc[4 * i + 2 * r] += xf.x;
      acc[4 * i + 2 * r + 1] += xf.y;
      s += acc[4 * i + 2 * r] + acc[4 * i + 2 * r + 1];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mean = s / E;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const float d0 = acc[4 * i + 2 * r] - mean, d1 = acc[4 * i + 2 * r + 1] - mean;
      q += d0 * d0 + d1 * d1;
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    const float rstd = 1.f / sqrtf(q / E + 1e-5f);
#pragma unroll
    for (int i = 0; i < E / 8; ++i)
      *tile_pair(tile, i, r) = pack_bf16((acc[4 * i + 2 * r] - mean) * rstd, (acc[4 * i + 2 * r + 1] - mean) * rstd);
  }
}

// The accumulator rounded to bf16 and written over the rows at `tile` in
// their layout, each thread at the positions of its own values, for a TMA
// store of the same boxes.
template <int E>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[E / 2], uint8_t* tile) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < E / 8; ++i) *tile_pair(tile, i, r) = pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
}

// The backward of residual_ln_tile: du = LN'(u)·g at u = x + acc, in
// float32 (eps 1e-5): with n = (u − mean(u))·r, r = 1/sqrt(var(u) + 1e-5),
// du = r·(g − mean(g) − n·mean(g·n)), the plain version's formula
// (ops/fused.py:ln_rows_bwd). The x rows come from `tile_x` (as x_frags
// reads them), the g rows from device memory (rows row0.. of a (rows, E)
// matrix, zero past the last), each thread reading the pairs it holds.
// du replaces acc, and rnd(du) is written over the rows at `tile_du` in the
// swizzled layout, as the K-major A operand of a later product and for a
// TMA store of the same boxes.
template <int E>
__device__ __forceinline__ void residual_ln_bwd_tile(float (&acc)[E / 2], uint8_t* tile_x,
                                                     const __nv_bfloat16* __restrict__ g, long long row0,
                                                     long long rows, uint8_t* tile_du) {
  const int lane = threadIdx.x & 31;
  const long long row = row0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // all of a row's g pairs are loaded before the first is used
    uint32_t gv[E / 8];
    const bool live = row + 8 * r < rows;
    const uint32_t* grow = reinterpret_cast<const uint32_t*>(g + (row + 8 * r) * E) + (lane & 3);
#pragma unroll
    for (int i = 0; i < E / 8; ++i) gv[i] = live ? grow[4 * i] : 0u;
    float s = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint32_t xv = *tile_pair(tile_x, i, r);
      const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
      const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv[i]));
      acc[4 * i + 2 * r] += xf.x;
      acc[4 * i + 2 * r + 1] += xf.y;
      s += acc[4 * i + 2 * r] + acc[4 * i + 2 * r + 1];
      sg += gf.x + gf.y;
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    sg += __shfl_xor_sync(0xffffffffu, sg, 1);
    sg += __shfl_xor_sync(0xffffffffu, sg, 2);
    const float mean = s / E, gmean = sg / E;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const float d0 = acc[4 * i + 2 * r] - mean, d1 = acc[4 * i + 2 * r + 1] - mean;
      q += d0 * d0 + d1 * d1;
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    const float rstd = 1.f / sqrtf(q / E + 1e-5f);
    float sgn = 0.f;
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv[i]));
      sgn += gf.x * (acc[4 * i + 2 * r] - mean) * rstd + gf.y * (acc[4 * i + 2 * r + 1] - mean) * rstd;
    }
    sgn += __shfl_xor_sync(0xffffffffu, sgn, 1);
    sgn += __shfl_xor_sync(0xffffffffu, sgn, 2);
    const float gnmean = sgn / E;
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv[i]));
      const float d0 = rstd * (gf.x - gmean - (acc[4 * i + 2 * r] - mean) * rstd * gnmean);
      const float d1 = rstd * (gf.y - gmean - (acc[4 * i + 2 * r + 1] - mean) * rstd * gnmean);
      acc[4 * i + 2 * r] = d0;
      acc[4 * i + 2 * r + 1] = d1;
      *tile_pair(tile_du, i, r) = pack_bf16(d0, d1);
    }
  }
}

// The gelu of the MLP bodies: 0.5·z·(1 + erf(z/√2)) by Abramowitz-Stegun
// 7.1.26, the Pallas kernels' erf (pallas_fused.py:_erf,
// _erf_gelu_and_grad): erf(|u|) = 1 - poly(t)·exp(-u²), t = 1/(1 + p|u|),
// u = z/√2, so that Φ(-|z|) = poly(t)·exp(-u²)/2; the 1/√2 and the 1/2 are
// folded into the constants, exp(-u²) is one ex2 and t one rcp (error
// 1.5e-7, far inside bf16's rounding). gelu(z) = max(z, 0) - |z|·Φ(-|z|);
// gelu'(z) = Φ(z) + z·φ(z), with φ(z) = exp(-u²)/√(2π) from the same ex2.
__device__ __forceinline__ float gelu_tail(float z, float& ex) {  // Φ(-|z|), and exp(-z²/2)
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(t) : "f"(fmaf(0.2316418882663604f, fabsf(z), 1.f)));
  const float half_poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 0.5307027145f, -0.7265760135f), 0.7107068705f), -0.142248368f),
               0.127414796f);
  const float zc = z * 0.8493218002880191f;  // zc² = u²·log2(e)
  ex = ex2(-zc * zc);
  return half_poly * ex;
}
__device__ __forceinline__ float gelu(float z) {
  float ex;
  const float tail = gelu_tail(z, ex);
  return fmaf(-fabsf(z), tail, fmaxf(z, 0.f));
}
__device__ __forceinline__ float gelu_grad(float z) {
  float ex;
  const float tail = gelu_tail(z, ex);
  return fmaf(z * ex, 0.3989422804014327f, z >= 0.f ? 1.f - tail : tail);
}

}  // namespace hopper
