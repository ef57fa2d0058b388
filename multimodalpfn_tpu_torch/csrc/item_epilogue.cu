// K2b: out = LN(x + o·W_out), residual sum in float32, affine-free LN (eps 1e-5).
//
// Replaces multimodalpfn_tpu/ops/pallas_item_fused.py:_epi_fwd_kernel
// (pallas_call in _epi_fwd_call, :679/:682). As there, the residual sum is
// formed in float32 (never in the compute dtype), which is one bf16 rounding
// more precise than the unfused residual_ln path.
//
// What bounds it on the H100: the bytes. At e = h·d = 192 a row costs 192²
// FMAs against 3·192·sizeof(T) bytes of activation traffic (o and x read,
// out written), 64 FLOPs a byte in bf16, far below the card's 295; W_out
// (72 KB in bf16) is read once per block. Three bodies, each with its own C
// entry; the Python wrapper (ops/item_fused.py:item_epilogue_body) picks one:
//  * epilogue_ln_kernel (mmpfn_item_epilogue_ln): float32 operands on the
//    CUDA cores (the parity mode needs full float32 products), and bf16 at
//    widths no tensor-core body takes;
//  * epilogue_ln_tc_kernel (mmpfn_item_epilogue_ln_mma): bf16 at e a
//    multiple of 32 up to 192 with h·d a multiple of 8, where the wgmma body
//    does not take them, on mma.sync;
//  * wg::epilogue_ln_wg_kernel (mmpfn_item_epilogue_ln_wg): bf16 at e = 64,
//    128, 192 with h·d a multiple of 64 up to 256, on Hopper's wgmma, fed
//    by TMA (below).
//
// CUDA-core design: a block owns 32 rows; their attention outputs are staged in shared
// memory, each warp keeps its 4 rows' e output sums in registers (lanes over
// columns, coalesced W_out loads), then adds the residual and normalizes with
// warp shuffles. Ragged tail rows are zeroed on load and never stored.
#include "ln_tile.cuh"

#include <algorithm>

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
  const size_t smem = sizeof(float) * (size_t)ROWS * hd;
  if (smem > MMPFN_MAX_SMEM) return MMPFN_BAD_ARGS;
  int rc = mmpfn_allow_smem(epilogue_ln_kernel<T>, smem);
  if (rc) return rc;
  const long long blocks = (rows + ROWS - 1) / ROWS;
  epilogue_ln_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)x, (const T*)o, (const T*)wout, (T*)out, rows, e, hd);
  return (int)cudaGetLastError();
}

// ---- bf16 on Hopper: wgmma with W_out resident -----------------------------
// The same function for bf16 operands at e = 64, 128, 192 with h·d a multiple
// of 64 up to 256, designed for the H100:
//  * a persistent, warp-specialised block per SM: one producer thread and
//    two consumer warpgroups; the rows are cut into units of 64, block b
//    takes units b, b + gridDim.x, ..., and its k-th unit goes to consumer
//    warpgroup k % 2 (units rather than 128-row tiles balance the grid:
//    291,400 rows are 4554 units, 34 or 35 a block on 132 SMs);
//  * W_out (h·d × e, 72 KB at 192 × 192) is loaded by TMA once per block, as
//    stored, in 64 × 64 boxes under the 128-byte swizzle, and stays in
//    shared memory for all of the block's units, as the Pallas kernel keeps
//    it resident in VMEM;
//  * the producer streams each unit's o rows (h·d / 64 boxes) and x rows
//    (e / 64 boxes) by TMA from 2-D maps whose bounds zero-fill past the
//    last row, through a ring of as many stages as fit beside W_out (3 at
//    e = h·d = 192; rings of more o than x stages, or fewer, timed the
//    same), so the next units' loads run under this unit's product and LN;
//    with an odd number of stages a stage serves both warpgroups in turn,
//    and a wait by parity cannot tell its phase from the one before, so
//    the two take turns (named barriers) to wait on the ring in unit order;
//  * the product is h·d / 16 wgmma m64nEk16 from shared memory, A = o
//    K-major, B = W_out named MN-major in its descriptor, one commit group
//    per 64 of the contraction, the float32 accumulator in registers; the x
//    fragments are read while it runs. No wgmma is issued under a
//    condition: ptxas serializes every wgmma of a kernel that does
//    (warnings C7514, C7515, C7520);
//  * the epilogue adds the residual and normalises on the accumulator
//    (ln_tile.cuh), writes the bf16 rows over the x rows, and a TMA store
//    writes them out (rows past the last are not written); then the stage
//    takes the next unit.
namespace wg {

constexpr int BOX = 64 * 64 * 2;  // bytes of a 64 × 64 box
constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int TURN_BAR = 3;       // named barriers 3, 4: each warpgroup's turn (1, 2: epilogues)
constexpr int MAX_HD = 256;
constexpr int MAX_ST = 4;                        // stages of the ring at most
constexpr int BAR_BYTES = (1 + 2 * MAX_ST) * 8;  // wfull, full[], empty[]

// the tensor maps of x, o, W_out and out, passed as a __grid_constant__
struct Maps {
  CUtensorMap x, o, w, out;
};

// Shared memory, from its 1024-byte aligned start: W_out (nc chunks of 64
// rows, each E / 64 boxes of 64 columns), the ring (st stages, each a
// unit's nc boxes of o, then its E / 64 boxes of x), then the barriers.
template <int E>
__global__ void __launch_bounds__(THREADS, 1)
    epilogue_ln_wg_kernel(const __grid_constant__ Maps maps, int rows, int nc, int st) {
  using namespace hopper;
  constexpr int NB = E / 64;
  const int units = (rows + 63) / 64, stage = (nc + NB) * BOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* w = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = w + nc * NB * BOX;
  uint64_t* wfull = reinterpret_cast<uint64_t*>(ring + st * stage);
  uint64_t* full = wfull + 1;
  uint64_t* empty = full + MAX_ST;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    mbar_init(wfull, 1);
    for (int s = 0; s < MAX_ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);  // once the unit's output is stored
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    producer_registers();
    if (tid == 256) {
      mbar_arrive_tx(wfull, nc * NB * BOX);
      for (int c = 0; c < nc; ++c)
        for (int b = 0; b < NB; ++b) tma_load(w + (c * NB + b) * BOX, &maps.w, wfull, 64 * b, 64 * c, 0);
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
        const int s = i % st;
        uint8_t* os = ring + s * stage;
        if (i >= st) mbar_wait(empty + s, (i / st - 1) & 1);
        mbar_arrive_tx(full + s, stage);
        for (int c = 0; c < nc; ++c) tma_load(os + c * BOX, &maps.o, full + s, 64 * c, 64 * u, 0);
        for (int b = 0; b < NB; ++b) tma_load(os + (nc + b) * BOX, &maps.x, full + s, 64 * b, 64 * u, 0);
      }
    }
  } else {  // consumers: warpgroup wg takes the block's units wg, wg + 2, ...
    consumer_registers();
    float acc[E / 2];
    uint32_t xa[E / 16][4];
    // W_out MN-major: its 64-column boxes BOX apart, k steps of 16 rows 2048 bytes apart
    const uint64_t wd = tile_desc<64>(w, BOX);
    mbar_wait(wfull, 0);
    if (wg == 1) bar_arrive(TURN_BAR, 256);  // warpgroup 0 takes the first turn
    int i = wg;
    for (int u = blockIdx.x + wg * gridDim.x; u < units; u += 2 * gridDim.x, i += 2) {
      const int s = i % st;
      uint8_t* os = ring + s * stage;
      uint8_t* xs = os + nc * BOX;
      const uint64_t od = tile_desc<64>(os);  // o K-major
#pragma unroll
      for (int k = 0; k < E / 2; ++k) acc[k] = 0.f;
      bar_sync(TURN_BAR + wg, 256);
      mbar_wait(full + s, (i / st) & 1);
      bar_arrive(TURN_BAR + (wg ^ 1), 256);
      for (int c = 0; c < nc; ++c) {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_ss<E, 0, 1>(acc, od + c * (BOX >> 4) + 2 * j, wd + c * (NB * BOX >> 4) + 128 * j, 1);
        wgmma_commit();
      }
      x_frags<E>(xa, xs);
      wgmma_wait<0>();
      keep(acc);
      residual_ln_tile<E>(acc, xa, xs);
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if ((tid & 127) == 0) {
        for (int b = 0; b < NB; ++b) tma_store(&maps.out, xs + b * BOX, 64 * b, 64 * u, 0);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(empty + s);
      }
    }
    // the turn passed on after the block's last unit
    const int n = (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    if (wg == n % 2) bar_sync(TURN_BAR + wg, 256);
    if ((tid & 127) == 0) bulk_wait();
  }
}

template <int E>
int launch_wg(const void* x, const void* o, const void* wout, void* out, long long rows, int hd,
              cudaStream_t stream) {
  constexpr int NB = E / 64;
  if (hd <= 0 || hd % 64 || hd > MAX_HD || rows > 0x7fffffffLL - 64) return MMPFN_BAD_ARGS;
  // TMA: 16-byte aligned bases (rows of 2·E and 2·h·d bytes are)
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(wout) | reinterpret_cast<uintptr_t>(out)) & 15)
    return MMPFN_BAD_ARGS;
  const int nc = hd / 64, w_bytes = nc * NB * BOX, stage = (nc + NB) * BOX;
  // as many stages as fit beside W_out: 3 at e = h·d = 192
  const int st = std::min(MAX_ST, (MMPFN_MAX_SMEM - 1024 - BAR_BYTES - w_bytes) / stage);
  if (st < 2) return MMPFN_BAD_ARGS;
  const int smem = w_bytes + st * stage + BAR_BYTES + 1024;
  Maps maps;
  int rc = hopper::make_map<64>(&maps.x, x, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.out, out, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.o, o, (int)rows, 1, hd);
  if (!rc) rc = hopper::make_map<64>(&maps.w, wout, hd, 1, E);
  if (!rc) rc = mmpfn_allow_smem(epilogue_ln_wg_kernel<E>, smem);
  static int sms = 0;
  if (!rc && !sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    rc = (int)err;
  }
  if (rc) return rc;
  const int units = (int)((rows + 63) / 64);
  epilogue_ln_wg_kernel<E><<<std::min((units + 1) / 2, sms), THREADS, smem, stream>>>(
      maps, (int)rows, nc, st);
  return (int)cudaGetLastError();
}

}  // namespace wg

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

// bf16 on mma.sync, e a multiple of 32 up to 192, h·d a multiple of 8
extern "C" int mmpfn_item_epilogue_ln_mma(const void* x, const void* o, const void* wout, void* out,
                                          long long rows, int e, int hd, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (hd <= 0 || hd % 8) return MMPFN_BAD_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  switch (e) {
    case 32: return launch_tc<32>(x, o, wout, out, rows, hd, s);
    case 64: return launch_tc<64>(x, o, wout, out, rows, hd, s);
    case 96: return launch_tc<96>(x, o, wout, out, rows, hd, s);
    case 128: return launch_tc<128>(x, o, wout, out, rows, hd, s);
    case 160: return launch_tc<160>(x, o, wout, out, rows, hd, s);
    case 192: return launch_tc<192>(x, o, wout, out, rows, hd, s);
    default: return MMPFN_BAD_ARGS;
  }
}

// bf16 on wgmma, e = 64, 128, 192, h·d a multiple of 64 up to 256
extern "C" int mmpfn_item_epilogue_ln_wg(const void* x, const void* o, const void* wout, void* out,
                                         long long rows, int e, int hd, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (e) {
    case 64: return wg::launch_wg<64>(x, o, wout, out, rows, hd, s);
    case 128: return wg::launch_wg<128>(x, o, wout, out, rows, hd, s);
    case 192: return wg::launch_wg<192>(x, o, wout, out, rows, hd, s);
    default: return MMPFN_BAD_ARGS;
  }
}
