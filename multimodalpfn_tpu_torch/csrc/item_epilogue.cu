// K2b: out = LN(x + o·W_out), residual sum in float32, affine-free LN (eps 1e-5).
//
// Replaces multimodalpfn_tpu/ops/pallas_item_fused.py:_epi_fwd_kernel
// (pallas_call in _epi_fwd_call, :679/:682). As there, the residual sum is
// formed in float32 (never in the compute dtype), which is one bf16 rounding
// more precise than the unfused residual_ln path.
//
// What bounds it on the H100: at e = h·d = 192 a row costs 192² FMAs against
// 3·192·sizeof(T) bytes, so on the CUDA cores the FMAs bound it, not the
// memory; W_out (147 KB in f32) stays in L1/L2. Two kernels: float32 operands
// run on the CUDA cores (full float32 products for the parity mode); bf16
// operands at the usual widths run on the tensor cores (epilogue_ln_tc_kernel
// below), which leaves the ~0.34 GB of activation traffic as the bound.
//
// CUDA-core design: a block owns 32 rows; their attention outputs are staged in shared
// memory, each warp keeps its 4 rows' e output sums in registers (lanes over
// columns, coalesced W_out loads), then adds the residual and normalizes with
// warp shuffles. Ragged tail rows are zeroed on load and never stored.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int NC = 8;  // output columns per lane: e <= 256

template <typename T>
__global__ void __launch_bounds__(THREADS)
epilogue_ln_kernel(const T* __restrict__ x, const T* __restrict__ o, const T* __restrict__ wout,
                   T* __restrict__ out, long long rows, int e, int hd) {
  extern __shared__ float os[];  // [ROWS][hd]
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 4;
  const long long row0 = (long long)blockIdx.x * ROWS;
  for (int i = tid; i < ROWS * hd; i += THREADS) {
    const int r = i / hd, c = i - r * hd;
    const long long gr = row0 + r;
    os[i] = gr < rows ? to_f<T>(o[gr * hd + c]) : 0.f;
  }
  __syncthreads();

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  for (int m = 0; m < hd; ++m) {
    float ov[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ov[r] = os[(r0 + r) * hd + m];
    const T* wrow = wout + (long long)m * e;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int j = lane + 32 * i;
      if (j < e) {
        const float w = to_f<T>(wrow[j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][i] = fmaf(ov[r], w, acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long gr = row0 + r0 + r;
    if (gr >= rows) continue;  // uniform across the warp
    float u[NC];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int j = lane + 32 * i;
      u[i] = j < e ? to_f<T>(x[gr * e + j]) + acc[r][i] : 0.f;
      s += u[i];
    }
    const float mean = warp_sum(s) / e;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int j = lane + 32 * i;
      if (j < e) q += (u[i] - mean) * (u[i] - mean);
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) / e + 1e-5f);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int j = lane + 32 * i;
      if (j < e) out[gr * e + j] = from_f<T>((u[i] - mean) * rstd);
    }
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------
// The same function for bf16 operands with e a multiple of 32 up to 192 and
// h·d a multiple of 8: a warp owns 16 rows and o·W_out is an mma.sync
// m16n8k16 product (bf16 in, float32 accumulated). Per chunk of 64 columns
// of o the block stages o[:, chunk] and W_out[chunk, :] in shared memory
// (ldmatrix.trans reads W_out as b fragments); a ragged last chunk is zeroed
// in both, so no stale shared memory enters a sum. The x tile stays in shared
// memory for the residual. Rows padded by 8 elements so fragment reads hit
// distinct banks.
constexpr int TR = 64;  // rows per block: 4 warps x 16
constexpr int TTHREADS = 128;
constexpr int KC = 64;  // columns of o per chunk

template <int E>
__global__ void __launch_bounds__(TTHREADS)
epilogue_ln_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ wout, __nv_bfloat16* __restrict__ out,
                      long long rows, int hd) {
  constexpr int XP = E + 8, OP = KC + 8, WP = E + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TR][XP]
  __nv_bfloat16* os = xs + TR * XP;                                 // [TR][OP]: o[:, chunk]
  __nv_bfloat16* ws = os + TR * OP;                                 // [KC][WP]: W_out[chunk, :]
  const int tid = threadIdx.x, lane = tid & 31;
  const int wr = 16 * (tid >> 5);  // this warp's first row in the tile
  const long long row0 = (long long)blockIdx.x * TR;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < TR * E / 8; i += TTHREADS) {
    const int r = i / (E / 8), c = (i - r * (E / 8)) * 8;
    const long long gr = row0 + r;
    *reinterpret_cast<uint4*>(xs + r * XP + c) =
        gr < rows ? *reinterpret_cast<const uint4*>(x + gr * E + c) : zero;
  }
  float acc[E / 8][4];
#pragma unroll
  for (int n = 0; n < E / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int c0 = 0; c0 < hd; c0 += KC) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < TR * KC / 8; i += TTHREADS) {
      const int r = i / (KC / 8), c = (i - r * (KC / 8)) * 8;
      const long long gr = row0 + r;
      *reinterpret_cast<uint4*>(os + r * OP + c) =
          gr < rows && c0 + c < hd ? *reinterpret_cast<const uint4*>(o + gr * hd + c0 + c) : zero;
    }
    for (int i = tid; i < KC * E / 8; i += TTHREADS) {
      const int k = i / (E / 8), c = (i - k * (E / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + k * WP + c) =
          c0 + k < hd ? *reinterpret_cast<const uint4*>(wout + (long long)(c0 + k) * E + c) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      uint32_t a[4];
      lds_a(a, os + wr * OP + j * 16, OP);
#pragma unroll
      for (int n = 0; n < E / 8; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, ws + (j * 16 + (lane & 15)) * WP + n * 8);
        mma_bf16_16816(acc[n], a, b0, b1);
      }
    }
  }
  residual_ln_store<E>(acc, xs + wr * XP, XP, [=](int r) -> __nv_bfloat16* {
    const long long gr = row0 + wr + r;
    return gr < rows ? out + gr * E : nullptr;
  });
}

template <int E>
int launch_tc(const void* x, const void* o, const void* wout, void* out, long long rows, int hd,
              cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)TR * (E + 8) + (size_t)TR * (KC + 8) + (size_t)KC * (E + 8));
  int rc = mmpfn_allow_smem(epilogue_ln_tc_kernel<E>, smem);
  if (rc) return rc;
  const long long blocks = (rows + TR - 1) / TR;
  epilogue_ln_tc_kernel<E><<<(unsigned)blocks, TTHREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)o, (const __nv_bfloat16*)wout,
      (__nv_bfloat16*)out, rows, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* o, const void* wout, void* out, long long rows, int e,
           int hd, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (hd % 8 == 0) {
      switch (e) {
        case 32: return launch_tc<32>(x, o, wout, out, rows, hd, stream);
        case 64: return launch_tc<64>(x, o, wout, out, rows, hd, stream);
        case 96: return launch_tc<96>(x, o, wout, out, rows, hd, stream);
        case 128: return launch_tc<128>(x, o, wout, out, rows, hd, stream);
        case 160: return launch_tc<160>(x, o, wout, out, rows, hd, stream);
        case 192: return launch_tc<192>(x, o, wout, out, rows, hd, stream);
        default: break;
      }
    }
  }
  const size_t smem = sizeof(float) * (size_t)ROWS * hd;
  if (smem > MMPFN_MAX_SMEM) return MMPFN_BAD_ARGS;
  int rc = mmpfn_allow_smem(epilogue_ln_kernel<T>, smem);
  if (rc) return rc;
  const long long blocks = (rows + ROWS - 1) / ROWS;
  epilogue_ln_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)x, (const T*)o, (const T*)wout, (T*)out, rows, e, hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mmpfn_item_epilogue_ln(const void* x, const void* o, const void* wout, void* out,
                                      long long rows, int e, int hd, int dtype, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (e < 1 || e > 32 * NC || hd < 1) return MMPFN_BAD_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MMPFN_F32) return launch<float>(x, o, wout, out, rows, e, hd, s);
  if (dtype == MMPFN_BF16) return launch<__nv_bfloat16>(x, o, wout, out, rows, e, hd, s);
  return MMPFN_BAD_ARGS;
}
