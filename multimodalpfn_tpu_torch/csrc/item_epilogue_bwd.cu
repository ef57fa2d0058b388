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
// writes du, do (≈ 107 MB in bf16 at the flagship fine-tune shape, 30 × 1838
// rows of 192: 0.032 ms at 3.35 TB/s) against 3 small products of 2·e·h·d
// FLOPs (12.2 GFLOP, 0.012 ms at the bf16 peak). Two bodies, each with its
// own C entry; the Python wrapper (ops/item_fused.py:item_epilogue_bwd_body)
// picks one.
//
// mmpfn_item_epilogue_bwd, the sequence (float32 operands, the parity mode,
// and bf16 at widths the row pass does not take): launches of gemm_tile.cuh's
// tiled products plus row kernels, the intermediates u and do32 in float32 in
// device memory (≈ 369 MB of launch traffic in bf16 at the flagship shape):
//   1. u = x + o·W_out (float32); 2. du = rnd(LN'(u)·g);
//   3. do32 = du·W_out^T (float32);
//   4. per row a warp writes do = rnd(do32) and, per head, delta = Σ_d do32·o;
//   5. dW_out = o^T·du over row chunks, float32 slabs summed in order (no
//      atomics: the same bits every run).
//
// mmpfn_item_epilogue_bwd_wg, the row pass (bf16 at e = 64, 128, 192 with h·d
// a multiple of 64 up to 256 and d a multiple of 8, the widths of K2b's
// wgmma body): one persistent kernel, wg::epilogue_ln_bwd_wg_kernel (below),
// computes steps 1-4 for each unit of 64 rows on chip and writes only du, do
// and delta; then step 5 as above (≈ 158 MB of launch traffic in all).
//
// The port keeps o as (G, S, h·d) and delta as (G, h, S): K2a's layouts, not
// the TPU's (G, h·d, S).
#include "gemm_tile.cuh"
#include "ln_tile.cuh"

#include <algorithm>

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

// ---- bf16 on Hopper: the row pass ------------------------------------------
// Steps 1-4 of the sequence for bf16 at e = 64, 128, 192 with h·d a multiple
// of 64 up to 256 and d a multiple of 8, designed for the H100 on K2b's wgmma
// body (item_epilogue.cu), whose product it recomputes:
//  * a persistent, warp-specialised block per SM: one producer thread and
//    two consumer warpgroups; the rows are cut into units of 64, block b
//    takes units b, b + gridDim.x, ..., and its k-th unit goes to consumer
//    warpgroup k % 2;
//  * W_out (h·d × e, 72 KB at 192 × 192) is loaded by TMA once per block, as
//    stored, in 64 × 64 boxes under the 128-byte swizzle, and stays in
//    shared memory; it is named MN-major for u = o·W_out and K-major for
//    do32 = du_c·W_out^T, one copy for both;
//  * the producer streams each unit's o rows (h·d / 64 boxes) and x rows
//    (e / 64 boxes) by TMA from 2-D maps whose bounds zero-fill past the
//    last row, through a ring of as many stages as fit beside W_out (3 at
//    e = h·d = 192, 2 at h·d = 256), and asks TMA to fetch the unit's g rows
//    into L2, which the LN backward then reads straight from device memory;
//    as in K2b, the two consumer warpgroups take turns (named barriers) to
//    wait on the ring in unit order;
//  * per unit: (a) u = o·W_out on wgmma into the accumulator (K2b's
//    product); (b) the LN backward on the accumulator (ln_tile.cuh:
//    residual_ln_bwd_tile): u + x, du = LN'(u)·g, rnd(du) written over the x
//    rows in their swizzled layout, from where a TMA store writes du and
//    where it is the K-major A of the next product; (c) per chunk of 64
//    columns of h·d, do32 = du_c·W_out[chunk, :]^T (m64n64 from shared
//    memory); (d) delta from the accumulator: each do32 value times o, read
//    from o's boxes at the same position (ln_tile.cuh:tile_pair), summed
//    over a head's columns in the thread (a head owns whole 8-column
//    register groups, d a multiple of 8, and may span chunks), then over
//    the quad by two xor-shuffles, and written to delta[(row / S)·h + head,
//    row % S] (units cross group boundaries: the divmod is per row); (e)
//    rnd(do32) over o's boxes, which a TMA store writes out as do; the stage
//    is released once the stores have read it;
//  * ragged tails: TMA zero-fills loads past the last row and clips stores;
//    g and delta are masked by row;
//  * no wgmma is issued under a condition (ptxas serializes every wgmma of a
//    kernel that does); no atomics: the outputs are the same bits every run.
namespace wg {

constexpr int BOX = 64 * 64 * 2;  // bytes of a 64 × 64 box
constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int TURN_BAR = 3;       // named barriers 3, 4: each warpgroup's turn (1, 2: epilogues)
constexpr int MAX_HD = 256;
constexpr int MAX_ST = 4;                        // stages of the ring at most
constexpr int BAR_BYTES = (1 + 2 * MAX_ST) * 8;  // wfull, full[], empty[]

// the tensor maps of x, o, W_out, g (L2 prefetch only), du and do, passed
// as a __grid_constant__
struct Maps {
  CUtensorMap x, o, w, g, du, dout;
};

// Shared memory, from its 1024-byte aligned start: W_out (nc chunks of 64
// rows, each E / 64 boxes of 64 columns), the ring (st stages, each a
// unit's nc boxes of o, then its E / 64 boxes of x), then the barriers.
template <int E>
__global__ void __launch_bounds__(THREADS, 1)
    epilogue_ln_bwd_wg_kernel(const __grid_constant__ Maps maps, const __nv_bfloat16* __restrict__ g,
                              float* __restrict__ delta, int rows, int seq, int h, int d, int nc,
                              int st) {
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
      mbar_init(empty + s, 1);  // once the unit's du and do are stored
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
        for (int b = 0; b < NB; ++b) tma_prefetch(&maps.g, 64 * b, 64 * u, 0);
        if (i >= st) mbar_wait(empty + s, (i / st - 1) & 1);
        mbar_arrive_tx(full + s, stage);
        for (int c = 0; c < nc; ++c) tma_load(os + c * BOX, &maps.o, full + s, 64 * c, 64 * u, 0);
        for (int b = 0; b < NB; ++b) tma_load(os + (nc + b) * BOX, &maps.x, full + s, 64 * b, 64 * u, 0);
      }
    }
  } else {  // consumers: warpgroup wg takes the block's units wg, wg + 2, ...
    consumer_registers();
    const int lane = tid & 31, quad = lane & 3;
    float acc[E / 2], dacc[32];
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
      const uint64_t xd = tile_desc<64>(xs);  // du_c K-major, once it is written there
#pragma unroll
      for (int k = 0; k < E / 2; ++k) acc[k] = 0.f;
      bar_sync(TURN_BAR + wg, 256);
      mbar_wait(full + s, (i / st) & 1);
      bar_arrive(TURN_BAR + (wg ^ 1), 256);
      // (a) u = o·W_out
      for (int c = 0; c < nc; ++c) {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_ss<E, 0, 1>(acc, od + c * (BOX >> 4) + 2 * j, wd + c * (NB * BOX >> 4) + 128 * j, 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      keep(acc);
      // (b) du = LN'(x + u)·g; rnd(du) over the x rows, stored out
      residual_ln_bwd_tile<E>(acc, xs, g, 64LL * u, rows, xs);
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if ((tid & 127) == 0) {
        for (int b = 0; b < NB; ++b) tma_store(&maps.du, xs + b * BOX, 64 * b, 64 * u, 0);
        bulk_commit();
      }
      // this thread's two rows: where their delta goes, and whether they exist
      long long base[2];
      bool live[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 64 * u + 16 * ((tid >> 5) & 3) + (lane >> 2) + 8 * r;
        const int grp = row / seq;
        live[r] = row < rows;
        base[r] = (long long)grp * h * seq + (row - grp * seq);
      }
      float part[2] = {0.f, 0.f};
      int head = 0, head_end = d;
      for (int c = 0; c < nc; ++c) {
        // (c) do32[:, chunk] = du_c·W_out[chunk, :]^T: the chunk K-major, a box a 64 of the contraction
        const uint64_t bd = tile_desc<64>(w + c * NB * BOX);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < E / 16; ++j) {
          const int step = (j / 4) * (BOX >> 4) + 2 * (j % 4);
          wgmma_ss_n64<0, 0>(dacc, xd + step, bd + step, j);
        }
        wgmma_commit();
        wgmma_wait<0>();
        keep(dacc);
        // (d) delta over each head's columns; (e) rnd(do32) over o's box
        uint8_t* ob = os + c * BOX;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            uint32_t* at = tile_pair(ob, q, r);
            const uint32_t ov = *at;
            const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov));
            part[r] = fmaf(dacc[4 * q + 2 * r], of.x, part[r]);
            part[r] = fmaf(dacc[4 * q + 2 * r + 1], of.y, part[r]);
            *at = pack_bf16(dacc[4 * q + 2 * r], dacc[4 * q + 2 * r + 1]);
          }
          if (64 * c + 8 * q + 8 == head_end) {  // the head ends with this group: uniform
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float sum = part[r] + __shfl_xor_sync(0xffffffffu, part[r], 1);
              sum += __shfl_xor_sync(0xffffffffu, sum, 2);
              if (quad == 0 && live[r]) delta[base[r] + (long long)head * seq] = sum;
              part[r] = 0.f;
            }
            ++head;
            head_end += d;
          }
        }
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if ((tid & 127) == 0) {
        for (int c = 0; c < nc; ++c) tma_store(&maps.dout, os + c * BOX, 64 * c, 64 * u, 0);
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
int launch_wg(const void* x, const void* o, const void* wout, const void* g, void* du_c, void* dout,
              float* delta, long long rows, int seq, int h, int d, cudaStream_t stream) {
  constexpr int NB = E / 64;
  const int hd = h * d;
  if (hd <= 0 || hd % 64 || hd > MAX_HD || d % 8 || rows > 0x7fffffffLL - 64) return MMPFN_BAD_ARGS;
  // TMA: 16-byte aligned bases (rows of 2·E and 2·h·d bytes are); g's
  // direct loads: pairs of bf16
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(wout) |
       reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(du_c) | reinterpret_cast<uintptr_t>(dout)) &
      15)
    return MMPFN_BAD_ARGS;
  const int nc = hd / 64, w_bytes = nc * NB * BOX, stage = (nc + NB) * BOX;
  // as many stages as fit beside W_out: 3 at e = h·d = 192
  const int st = std::min(MAX_ST, (MMPFN_MAX_SMEM - 1024 - BAR_BYTES - w_bytes) / stage);
  if (st < 2) return MMPFN_BAD_ARGS;
  const int smem = w_bytes + st * stage + BAR_BYTES + 1024;
  Maps maps;
  int rc = hopper::make_map<64>(&maps.x, x, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.g, g, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.du, du_c, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.o, o, (int)rows, 1, hd);
  if (!rc) rc = hopper::make_map<64>(&maps.dout, dout, (int)rows, 1, hd);
  if (!rc) rc = hopper::make_map<64>(&maps.w, wout, hd, 1, E);
  if (!rc) rc = mmpfn_allow_smem(epilogue_ln_bwd_wg_kernel<E>, smem);
  static int sms = 0;
  if (!rc && !sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    rc = (int)err;
  }
  if (rc) return rc;
  const int units = (int)((rows + 63) / 64);
  epilogue_ln_bwd_wg_kernel<E><<<std::min((units + 1) / 2, sms), THREADS, smem, stream>>>(
      maps, (const __nv_bfloat16*)g, delta, (int)rows, seq, h, d, nc, st);
  return (int)cudaGetLastError();
}

}  // namespace wg

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

// The row pass (bf16 at e = 64, 128, 192, h·d a multiple of 64 up to 256, d a
// multiple of 8), then the weight gradient: du_c (rows, e) and do (rows, h·d)
// in bf16, delta (G, h, S) and dW_out (h·d, e) in float32, dW_out summed over
// chunks of wgrad_rows rows in `work`.
extern "C" int mmpfn_item_epilogue_bwd_wg(const void* x, const void* o, const void* wout, const void* g,
                                          void* du_c, void* dout, float* delta, float* dw, float* work,
                                          long long rows, int s, int e, int h, int d, int wgrad_rows,
                                          int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (h < 1 || d < 1 || s < 1 || rows % s) return MMPFN_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  switch (e) {
    case 64: rc = wg::launch_wg<64>(x, o, wout, g, du_c, dout, delta, rows, s, h, d, st); break;
    case 128: rc = wg::launch_wg<128>(x, o, wout, g, du_c, dout, delta, rows, s, h, d, st); break;
    case 192: rc = wg::launch_wg<192>(x, o, wout, g, du_c, dout, delta, rows, s, h, d, st); break;
    default: return MMPFN_BAD_ARGS;
  }
  if (rc) return rc;
  using T = __nv_bfloat16;
  return gemm::wgrad<T>((const T*)o, (const T*)du_c, dw, work, rows, h * d, e, wgrad_rows, st);
}
