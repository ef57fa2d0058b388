// K3: out = LN(x + gelu(x·W1)·W2), rows independent, affine-free LN (eps 1e-5).
//
// Replaces multimodalpfn_tpu/ops/pallas_fused.py:_mlp_kernel_g (pallas_call in
// _mlp_fwd_call, :160/:184). Pallas approximated erf (Abramowitz-Stegun,
// :101) because Mosaic has none; this kernel uses CUDA's erff, the exact gelu.
//
// What bounds it on the H100: arithmetic. Each row costs 2·e·nhid FMAs
// (295 K at e = 192, nhid = 768) against 2·e·sizeof(T) bytes of activation
// traffic, and the 1.2 MB (f32) of weights stay in L2. Two kernels: float32
// operands run on the CUDA cores (the parity mode needs full float32
// products); bf16 operands at the usual widths run on the tensor cores
// (mlp_ln_tc_kernel below). wgmma and TMA pipelining are later work.
//
// CUDA-core design: a block owns 32 rows; the hidden layer is never written to device
// memory. The x tile and each chunk of 128 hidden values sit transposed in
// shared memory, so a warp's 4 rows come as one float4 broadcast. Per chunk,
// each lane computes 4 consecutive hidden units of its warp's 4 rows (one
// vector load of W1 feeds 16 FMAs), applies gelu, rounds to T as the Pallas
// kernel does, and parks them; then each lane folds them into its 4 rows ×
// pairs of output columns held in registers (one 2-wide W2 load feeds 8
// FMAs). A warp holds whole rows, so residual and LN reduce with shuffles
// only. Ragged tail rows are zeroed on load and never stored. Needs e even,
// e <= 256 and nhid a multiple of 4.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int ROWS = 32;       // rows per block
constexpr int THREADS = 256;   // 8 warps x 4 rows
constexpr int CHUNK = 128;     // hidden units per pass: 4 per lane
constexpr int NP = 4;          // output column pairs per lane: e <= 256
constexpr int RS = ROWS + 4;   // row stride of the transposed tiles (float4-aligned)

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_ln_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ w2,
              T* __restrict__ out, long long rows, int e, int nhid) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;          // [e][RS]: x transposed
  float* ht = xt + e * RS;   // [CHUNK][RS]: gelu(x·W1) chunk transposed
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 4;
  const long long row0 = (long long)blockIdx.x * ROWS;

  for (int i = tid; i < ROWS * e; i += THREADS) {
    const int r = i / e, c = i - r * e;
    const long long gr = row0 + r;
    xt[c * RS + r] = gr < rows ? to_f<T>(x[gr * e + c]) : 0.f;
  }
  __syncthreads();

  float acc[4][NP][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[r][p][0] = acc[r][p][1] = 0.f;

  for (int c0 = 0; c0 < nhid; c0 += CHUNK) {
    const int cl = c0 + 4 * lane;  // this lane's 4 hidden units (all or none < nhid)
    float ha[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) ha[r][j] = 0.f;
    if (cl < nhid) {
      for (int k = 0; k < e; ++k) {
        float xv[4], wv[4];
        load4(xt + k * RS + r0, xv);
        load4(w1 + (long long)k * nhid + cl, wv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) ha[r][j] = fmaf(xv[r], wv[j], ha[r][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float g[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float z = ha[r][j];
        g[r] = round_t<T>(0.5f * z * (1.f + erff(z * 0.70710678118654752f)));
      }
      *reinterpret_cast<float4*>(ht + (4 * lane + j) * RS + r0) = make_float4(g[0], g[1], g[2], g[3]);
    }
    __syncwarp();
    const int cmax = min(CHUNK, nhid - c0);
    for (int c = 0; c < cmax; ++c) {
      float hv[4];
      load4(ht + c * RS + r0, hv);
      const T* w2row = w2 + (long long)(c0 + c) * e;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int j = 2 * lane + 64 * p;
        if (j < e) {
          float w[2];
          load2(w2row + j, w);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][p][0] = fmaf(hv[r], w[0], acc[r][p][0]);
            acc[r][p][1] = fmaf(hv[r], w[1], acc[r][p][1]);
          }
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long gr = row0 + r0 + r;
    if (gr >= rows) continue;  // uniform across the warp
    float u[NP][2];
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int j = 2 * lane + 64 * p;
      const bool ok = j < e;
      u[p][0] = ok ? xt[j * RS + r0 + r] + acc[r][p][0] : 0.f;
      u[p][1] = ok ? xt[(j + 1) * RS + r0 + r] + acc[r][p][1] : 0.f;
      s += u[p][0] + u[p][1];
    }
    const float mean = warp_sum(s) / e;
    float q = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      if (2 * lane + 64 * p < e)
        q += (u[p][0] - mean) * (u[p][0] - mean) + (u[p][1] - mean) * (u[p][1] - mean);
    const float rstd = 1.f / sqrtf(warp_sum(q) / e + 1e-5f);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int j = 2 * lane + 64 * p;
      if (j < e) store2(out + gr * e + j, (u[p][0] - mean) * rstd, (u[p][1] - mean) * rstd);
    }
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------
// The same function for bf16 operands with e a multiple of 32 up to 192 and
// nhid a multiple of 64: a warp owns 16 rows; x·W1 and h·W2 are mma.sync
// m16n8k16 products (bf16 in, float32 accumulated). Per chunk of 64 hidden
// units the block stages W1[:, chunk] and W2[chunk, :] in shared memory
// (ldmatrix.trans reads them as b fragments), applies gelu to the float32
// hidden fragments, rounds them to bf16 as the Pallas kernel does, and feeds
// them straight back as the a fragments of the second product: the hidden
// layer never leaves registers. Each row's outputs live in one quad of lanes,
// which reduce the LN statistics with shuffles. Rows padded by 8 elements so
// fragment reads hit distinct banks.
constexpr int TR = 64;         // rows per block: 4 warps x 16
constexpr int TTHREADS = 128;
constexpr int HC = 64;         // hidden units per chunk

template <int E>
__global__ void __launch_bounds__(TTHREADS)
mlp_ln_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                 const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out,
                 long long rows, int nhid) {
  constexpr int XP = E + 8, W1P = HC + 8, W2P = E + 8, NE = E / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TR][XP]
  __nv_bfloat16* w1s = xs + TR * XP;                                // [E][W1P]: W1[:, chunk]
  __nv_bfloat16* w2s = w1s + E * W1P;                               // [HC][W2P]: W2[chunk, :]
  const int tid = threadIdx.x, lane = tid & 31;
  const int wr = 16 * (tid >> 5);  // this warp's first row in the tile
  const long long row0 = (long long)blockIdx.x * TR;

  for (int i = tid; i < TR * E / 8; i += TTHREADS) {
    const int r = i / (E / 8), c = (i - r * (E / 8)) * 8;
    const long long gr = row0 + r;
    *reinterpret_cast<uint4*>(xs + r * XP + c) =
        gr < rows ? *reinterpret_cast<const uint4*>(x + gr * E + c) : make_uint4(0, 0, 0, 0);
  }
  float acc[NE][4];
#pragma unroll
  for (int n = 0; n < NE; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int c0 = 0; c0 < nhid; c0 += HC) {
    __syncthreads();  // the previous chunk's weights are consumed
    for (int i = tid; i < E * HC / 8; i += TTHREADS) {
      const int k = i / (HC / 8), c = (i - k * (HC / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + k * W1P + c) =
          *reinterpret_cast<const uint4*>(w1 + (long long)k * nhid + c0 + c);
    }
    for (int i = tid; i < HC * E / 8; i += TTHREADS) {
      const int k = i / (E / 8), c = (i - k * (E / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + k * W2P + c) =
          *reinterpret_cast<const uint4*>(w2 + (long long)(c0 + k) * E + c);
    }
    __syncthreads();

    float hacc[HC / 8][4];
#pragma unroll
    for (int n = 0; n < HC / 8; ++n) hacc[n][0] = hacc[n][1] = hacc[n][2] = hacc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < E / 16; ++ks) {
      uint32_t a[4];
      lds_a(a, xs + wr * XP + ks * 16, XP);
#pragma unroll
      for (int n = 0; n < HC / 8; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, w1s + (ks * 16 + (lane & 15)) * W1P + n * 8);
        mma_bf16_16816(hacc[n], a, b0, b1);
      }
    }
    // gelu, rounded to bf16: hidden tiles 2j and 2j+1 are the a fragment of units 16j..16j+15
    uint32_t ha[HC / 16][4];
#pragma unroll
    for (int n = 0; n < HC / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float z0 = hacc[n][2 * r], z1 = hacc[n][2 * r + 1];
        ha[n >> 1][r + 2 * (n & 1)] =
            pack_bf16(0.5f * z0 * (1.f + erff(z0 * 0.70710678118654752f)),
                      0.5f * z1 * (1.f + erff(z1 * 0.70710678118654752f)));
      }
#pragma unroll
    for (int n = 0; n < NE; ++n)
#pragma unroll
      for (int j = 0; j < HC / 16; ++j) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, w2s + (j * 16 + (lane & 15)) * W2P + n * 8);
        mma_bf16_16816(acc[n], ha[j], b0, b1);
      }
  }
  residual_ln_store<E>(acc, xs + wr * XP, XP, [=](int r) -> __nv_bfloat16* {
    const long long gr = row0 + wr + r;
    return gr < rows ? out + gr * E : nullptr;
  });
}

template <int E>
int launch_tc(const void* x, const void* w1, const void* w2, void* out, long long rows, int nhid,
              cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * ((size_t)TR * (E + 8) + (size_t)E * (HC + 8) +
                                               (size_t)HC * (E + 8));
  int rc = mmpfn_allow_smem(mlp_ln_tc_kernel<E>, smem);
  if (rc) return rc;
  const long long blocks = (rows + TR - 1) / TR;
  mlp_ln_tc_kernel<E><<<(unsigned)blocks, TTHREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1, (const __nv_bfloat16*)w2,
      (__nv_bfloat16*)out, rows, nhid);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w1, const void* w2, void* out, long long rows, int e,
           int nhid, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (nhid % HC == 0) {
      switch (e) {
        case 32: return launch_tc<32>(x, w1, w2, out, rows, nhid, stream);
        case 64: return launch_tc<64>(x, w1, w2, out, rows, nhid, stream);
        case 96: return launch_tc<96>(x, w1, w2, out, rows, nhid, stream);
        case 128: return launch_tc<128>(x, w1, w2, out, rows, nhid, stream);
        case 160: return launch_tc<160>(x, w1, w2, out, rows, nhid, stream);
        case 192: return launch_tc<192>(x, w1, w2, out, rows, nhid, stream);
        default: break;
      }
    }
  }
  const size_t smem = sizeof(float) * (size_t)RS * (e + CHUNK);
  int rc = mmpfn_allow_smem(mlp_ln_kernel<T>, smem);
  if (rc) return rc;
  const long long blocks = (rows + ROWS - 1) / ROWS;
  mlp_ln_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)w2, (T*)out, rows, e, nhid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mmpfn_mlp_ln(const void* x, const void* w1, const void* w2, void* out,
                            long long rows, int e, int nhid, int dtype, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (e < 2 || e % 2 || e > 64 * NP || nhid < 4 || nhid % 4) return MMPFN_BAD_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MMPFN_F32) return launch<float>(x, w1, w2, out, rows, e, nhid, s);
  if (dtype == MMPFN_BF16) return launch<__nv_bfloat16>(x, w1, w2, out, rows, e, nhid, s);
  return MMPFN_BAD_ARGS;
}

extern "C" const char* mmpfn_error_string(int code) {
  if (code == MMPFN_BAD_ARGS) return "arguments not supported by the kernel";
  if (code == MMPFN_TMA_FAILED) return "a TMA tensor map could not be encoded";
  return cudaGetErrorString((cudaError_t)code);
}
