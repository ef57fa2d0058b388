// K3: out = LN(x + gelu(x·W1)·W2), rows independent, affine-free LN (eps 1e-5).
//
// Replaces multimodalpfn_tpu/ops/pallas_fused.py:_mlp_kernel_g (pallas_call in
// _mlp_fwd_call, :160/:184). Pallas approximated erf (Abramowitz-Stegun,
// :101) because Mosaic has none. The hidden layer is rounded to the operand
// type after the gelu; the residual sum and the LN run in float32.
//
// What bounds it on the H100: arithmetic. Each row costs 2·e·nhid FMAs
// (295 K at e = 192, nhid = 768) against 2·e·sizeof(T) bytes of activation
// traffic, and the weights stay in L2. Three bodies, each with its own C
// entry; the Python wrapper (ops/fused.py:mlp_ln_body) picks one:
//  * mlp_ln_kernel (mmpfn_mlp_ln): float32 operands on the CUDA cores (the
//    parity mode needs full float32 products, and CUDA's exact erff), and
//    bf16 at widths no tensor-core body takes;
//  * mlp_ln_tc_kernel (mmpfn_mlp_ln_mma): bf16 at e = 32, 96, 160 on
//    mma.sync;
//  * wg::mlp_ln_wg_kernel (mmpfn_mlp_ln_wg): bf16 at e = 64, 128, 192 on
//    Hopper's wgmma, fed by TMA (below).
//
#include "ln_tile.cuh"

#include <algorithm>

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
  const size_t smem = sizeof(float) * (size_t)RS * (e + CHUNK);
  int rc = mmpfn_allow_smem(mlp_ln_kernel<T>, smem);
  if (rc) return rc;
  const long long blocks = (rows + ROWS - 1) / ROWS;
  mlp_ln_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)w2, (T*)out, rows, e, nhid);
  return (int)cudaGetLastError();
}

// ---- bf16 on Hopper: wgmma from a TMA ring of weight chunks ----------------
// The same function for bf16 operands at e = 64, 128, 192 with nhid a
// multiple of HC, designed for the H100 (PERF.md holds the A/B timings of
// the designs this one beat):
//  * a persistent, warp-specialised block per SM walks tiles of 128 rows:
//    one producer thread and two consumer warpgroups, 64 rows each;
//  * the producer loads each tile's x rows by TMA from a 2-D map over
//    (rows, e) (its bounds zero-fill past the last row) and streams the
//    weights through a ring of stages, each W1[:, c:c+64] and W2[c:c+64, :]
//    as stored, in 64 × 64 boxes under the 128-byte swizzle; the ring runs
//    on across tiles, so the next tile's weights arrive during this tile's
//    epilogue;
//  * per chunk, the first product h = x·W1[:, c:c+64] is e / 16 wgmma
//    m64n64k16 with x K-major and the W1 chunk named MN-major in its
//    descriptor; the gelu of h, rounded to bf16, is packed straight into
//    the A fragments of the second product, out += h·W2[c:c+64, :], a
//    wgmma m64nek16 with A from registers: the hidden layer never leaves
//    registers, and the 64 × e float32 output accumulates over all chunks;
//  * the two consumer warpgroups take turns (named barriers) to issue
//    their products, chunk c - 1's second with chunk c's first, so that
//    one's gelu runs beside the other's products;
//  * the gelu is the Pallas kernel's erf, Abramowitz-Stegun 7.1.26, on one
//    ex2 and one rcp (ln_tile.cuh, error 1.5e-7, far inside the hidden
//    layer's bf16 rounding; with CUDA's erff the kernel was 26-29 % slower
//    on the H100);
//  * no wgmma is issued under a condition: ptxas serializes every wgmma
//    of a kernel that does (warnings C7514, C7515, C7520);
//  * the epilogue adds the residual and normalises on the accumulator
//    (ln_tile.cuh), writes the bf16 rows over the x rows, and a TMA store
//    writes them out (rows past the last are not written); then the x
//    buffer takes the next tile's rows.
namespace wg {

constexpr int BOX = 64 * 64 * 2;  // bytes of a 64 × 64 box
constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int TM = 128;           // rows a tile, 64 a consumer warpgroup
constexpr int TURN_BAR = 3;       // named barriers 3, 4: each warpgroup's turn (1, 2: epilogues)

// Shared memory of a block at width E: XB buffers of x rows (two warpgroups'
// 64 rows each, E / 64 boxes a warpgroup), then the ring of ST stages (W1's
// chunk: E / 64 boxes of 64 rows of k; W2's: E / 64 boxes of 64 columns of
// n), then the barriers. At E = 192 one x buffer and three stages fill 192
// KB; a turn's two products keep two stages busy, so three is the least
// that leaves one loading.
template <int E>
struct Geo {
  static constexpr int NB = E / 64;
  static constexpr int XWG = NB * BOX;  // a warpgroup's x rows
  static constexpr int STAGE = 2 * NB * BOX;
  static constexpr int XB = E == 192 ? 1 : 2;
  static constexpr int ST = E == 192 ? 3 : 4;
  static constexpr int RING = XB * 2 * XWG;
  static constexpr int BARS = RING + ST * STAGE;  // full[ST], empty[ST], xfull[XB][2], xempty[XB][2]
  static constexpr int SMEM = BARS + (2 * ST + 4 * XB) * 8 + 1024;  // + alignment slack
  static_assert(SMEM <= MMPFN_MAX_SMEM, "shared memory");
};

// the tensor maps of x, W1, W2 and out, passed as a __grid_constant__
struct Maps {
  CUtensorMap x, w1, w2, out;
};

// Block b takes tiles b, b + gridDim.x, ...
template <int E>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_ln_wg_kernel(const __grid_constant__ Maps maps, int rows, int nc, int tiles) {
  using namespace hopper;
  using G = Geo<E>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sm + G::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::BARS);
  uint64_t* empty = full + G::ST;
  uint64_t* xfull = empty + G::ST;       // [XB][2]
  uint64_t* xempty = xfull + 2 * G::XB;  // [XB][2]
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < G::ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // every consumer warp
    }
    for (int i = 0; i < 2 * G::XB; ++i) {
      mbar_init(xfull + i, 1);
      mbar_init(xempty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    producer_registers();
    if (tid == 256) {
      int it = 0, xt = 0;
      auto load_x = [&](int tile) {
        const int xb = xt % G::XB;
        for (int h = 0; h < 2; ++h) {
          uint64_t* xf = xfull + 2 * xb + h;
          if (xt >= G::XB) mbar_wait(xempty + 2 * xb + h, ((xt / G::XB) - 1) & 1);
          mbar_arrive_tx(xf, G::XWG);
          uint8_t* dst = sm + (2 * xb + h) * G::XWG;
          for (int b = 0; b < G::NB; ++b) tma_load(dst + b * BOX, &maps.x, xf, 64 * b, TM * tile + 64 * h, 0);
        }
        ++xt;
      };
      // with one x buffer the next tile's first stages are issued before
      // its x rows, which wait for this tile's epilogue
      const int x_at = G::XB == 1 ? min(G::ST, nc) : 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int c = 0; c < nc; ++c, ++it) {
          if (c == x_at) load_x(tile);
          const int s = it % G::ST;
          if (it >= G::ST) mbar_wait(empty + s, ((it / G::ST) - 1) & 1);
          mbar_arrive_tx(full + s, G::STAGE);
          uint8_t* st = ring + s * G::STAGE;
          // W1 rows 64b.. of columns c·64..; W2 columns 64b.. of rows c·64..
          for (int b = 0; b < G::NB; ++b) {
            tma_load(st + b * BOX, &maps.w1, full + s, HC * c, 64 * b, 0);
            tma_load(st + (G::NB + b) * BOX, &maps.w2, full + s, 64 * b, HC * c, 0);
          }
        }
        if (x_at == nc) load_x(tile);
      }
    }
  } else {  // consumers: warpgroup wg owns rows [64·wg, 64·wg + 64) of each tile
    consumer_registers();
    const int lane = tid & 31;
    auto wait_full = [&](int i) { mbar_wait(full + i % G::ST, (i / G::ST) & 1); };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + i % G::ST);
    };
    float acc[E / 2], h[HC / 2];
    uint32_t a[HC / 16][4] = {}, xa[E / 16][4];
    uint64_t xd = 0;  // descriptor of this warpgroup's x rows, K-major
    // h = x·W1[:, chunk]: W1's chunk MN-major, its k steps of 16 rows 2048 bytes apart
    auto p1 = [&](int i) {
      const uint64_t bd = tile_desc<64>(ring + (i % G::ST) * G::STAGE);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < E / 16; ++j)
        wgmma_ss_n64<0, 1>(h, xd + (j / 4) * (BOX >> 4) + 2 * (j % 4), bd + 128 * j, j);
    };
    // acc += bf16(gelu(h))·W2[chunk, :]: W2's chunk MN-major, its 64-column boxes BOX apart
    auto p2 = [&](int i) {
      const uint64_t bd = tile_desc<64>(ring + (i % G::ST) * G::STAGE + G::NB * BOX, BOX);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < HC / 16; ++j) wgmma_rs<E>(acc, a[j], bd + 128 * j);
    };
    // the gelu of h rounded to bf16, as the A fragments of p2 (hopper.cuh's layout)
    auto hidden = [&]() {
#pragma unroll
      for (int i = 0; i < HC / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[i / 2][r + 2 * (i & 1)] = pack_bf16(gelu(h[4 * i + 2 * r]), gelu(h[4 * i + 2 * r + 1]));
    };
    // a turn: this warpgroup's products, issued after the other's and
    // waited for while the other issues its own
    auto turn = [&](auto issue) {
      bar_sync(TURN_BAR + wg, 256);
      issue();
      wgmma_commit();
      bar_arrive(TURN_BAR + (wg ^ 1), 256);
      wgmma_wait<0>();
      keep(h);
      keep(a);
      keep(acc);
    };
    if (wg == 1) bar_arrive(TURN_BAR, 256);  // warpgroup 0 takes the first turn
    int it = 0, xt = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++xt, it += nc) {
      const int xb = xt % G::XB;
      uint8_t* xs = sm + (2 * xb + wg) * G::XWG;
      mbar_wait(xfull + 2 * xb + wg, (xt / G::XB) & 1);
      xd = tile_desc<64>(xs);
#pragma unroll
      for (int i = 0; i < E / 2; ++i) acc[i] = 0.f;
      // turn 0: chunk 0's first product; turn c: chunk c - 1's second and
      // chunk c's first; turn nc: chunk nc - 1's second
      wait_full(it);
      turn([&] { p1(it); });
      hidden();
      for (int c = 1; c < nc; ++c) {
        wait_full(it + c);
        turn([&] {
          p2(it + c - 1);
          p1(it + c);
        });
        release(it + c - 1);
        hidden();
      }
      turn([&] { p2(it + nc - 1); });
      release(it + nc - 1);
      x_frags<E>(xa, xs);
      residual_ln_tile<E>(acc, xa, xs);
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if ((tid & 127) == 0) {
        const int row0 = TM * tile + 64 * wg;
        if (row0 < rows) {
          for (int b = 0; b < G::NB; ++b) tma_store(&maps.out, xs + b * BOX, 64 * b, row0, 0);
          bulk_commit();
          bulk_wait_read();
        }
        mbar_arrive(xempty + 2 * xb + wg);
      }
    }
    if (wg == 0) bar_sync(TURN_BAR, 256);  // warpgroup 1's last turn
    if ((tid & 127) == 0) bulk_wait();
  }
}

template <int E>
int launch_wg(const void* x, const void* w1, const void* w2, void* out, long long rows, int nhid,
              cudaStream_t stream) {
  using G = Geo<E>;
  if (rows > 0x7fffffffLL - TM) return MMPFN_BAD_ARGS;
  // TMA: 16-byte aligned bases (rows of 2·E and 2·nhid bytes are)
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out)) & 15)
    return MMPFN_BAD_ARGS;
  Maps maps;
  int rc = hopper::make_map<64>(&maps.x, x, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.out, out, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.w1, w1, E, 1, nhid);
  if (!rc) rc = hopper::make_map<64>(&maps.w2, w2, nhid, 1, E);
  if (!rc) rc = mmpfn_allow_smem(mlp_ln_wg_kernel<E>, G::SMEM);
  static int sms = 0;
  if (!rc && !sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    rc = (int)err;
  }
  if (rc) return rc;
  const int tiles = (int)((rows + TM - 1) / TM);
  mlp_ln_wg_kernel<E><<<std::min(tiles, sms), THREADS, G::SMEM, stream>>>(maps, (int)rows, nhid / HC,
                                                                            tiles);
  return (int)cudaGetLastError();
}

}  // namespace wg

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

// bf16 on mma.sync, e = 32, 96, 160, nhid a multiple of 64
extern "C" int mmpfn_mlp_ln_mma(const void* x, const void* w1, const void* w2, void* out,
                                long long rows, int e, int nhid, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (nhid <= 0 || nhid % HC) return MMPFN_BAD_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  switch (e) {
    case 32: return launch_tc<32>(x, w1, w2, out, rows, nhid, s);
    case 96: return launch_tc<96>(x, w1, w2, out, rows, nhid, s);
    case 160: return launch_tc<160>(x, w1, w2, out, rows, nhid, s);
    default: return MMPFN_BAD_ARGS;
  }
}

// bf16 on wgmma, e = 64, 128, 192, nhid a multiple of 64
extern "C" int mmpfn_mlp_ln_wg(const void* x, const void* w1, const void* w2, void* out,
                               long long rows, int e, int nhid, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (nhid <= 0 || nhid % HC) return MMPFN_BAD_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  switch (e) {
    case 64: return wg::launch_wg<64>(x, w1, w2, out, rows, nhid, s);
    case 128: return wg::launch_wg<128>(x, w1, w2, out, rows, nhid, s);
    case 192: return wg::launch_wg<192>(x, w1, w2, out, rows, nhid, s);
    default: return MMPFN_BAD_ARGS;
  }
}

extern "C" const char* mmpfn_error_string(int code) {
  if (code == MMPFN_BAD_ARGS) return "arguments not supported by the kernel";
  if (code == MMPFN_TMA_FAILED) return "a TMA tensor map could not be encoded";
  return cudaGetErrorString((cudaError_t)code);
}
