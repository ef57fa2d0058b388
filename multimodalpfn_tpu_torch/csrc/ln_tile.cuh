// Residual + LayerNorm on the accumulator of a 64-row wgmma product, for the
// bf16 tensor-core kernels that end in out = LN(x + product) with the x rows
// in shared memory as TMA wrote them (K3's wgmma body, mlp_ln.cu).
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

// The x rows of a warpgroup (64 rows as E / 64 boxes under the 128-byte
// swizzle at `tile`) as the A fragments of a wgmma product with k = E: xa[j]
// holds columns 16j..16j + 15 in hopper.cuh's register layout, so column
// 8i + 2·(lane % 4) + c of row 16·warp + g + 8r is half c of xa[i / 2][r +
// 2·(i % 2)], the place of accumulator register 4i + 2r + c.
template <int E>
__device__ __forceinline__ void x_frags(uint32_t (&xa)[E / 16][4], const uint8_t* tile) {
  static_assert(E % 64 == 0, "rows of whole 64-column boxes");
  const int lane = threadIdx.x & 31, g = lane >> 2;
  // (row % 8) == g: the swizzle moves piece i % 8 of a row to (i % 8) ^ g
  const uint8_t* row = tile + (16 * ((threadIdx.x >> 5) & 3) + g) * 128 + 4 * (lane & 3);
#pragma unroll
  for (int i = 0; i < E / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      xa[i / 2][r + 2 * (i & 1)] =
          *reinterpret_cast<const uint32_t*>(row + r * 1024 + (i / 8) * 8192 + (((i % 8) ^ g) << 4));
}

// out = LN(x + acc), affine-free (eps 1e-5), in float32: the mean, then the
// mean of squared deviations, as the plain version computes them. The
// residual comes from x's A fragments (x_frags); the output, rounded to
// bf16, is written over the x rows at `tile` in their layout, each thread
// at the positions of its own outputs, for a TMA store of the same boxes.
template <int E>
__device__ __forceinline__ void residual_ln_tile(float (&acc)[E / 2], const uint32_t (&xa)[E / 16][4],
                                                 uint8_t* tile) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  uint8_t* row = tile + (16 * ((threadIdx.x >> 5) & 3) + g) * 128 + 4 * (lane & 3);
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
      *reinterpret_cast<uint32_t*>(row + r * 1024 + (i / 8) * 8192 + (((i % 8) ^ g) << 4)) =
          pack_bf16((acc[4 * i + 2 * r] - mean) * rstd, (acc[4 * i + 2 * r + 1] - mean) * rstd);
  }
}

}  // namespace hopper
