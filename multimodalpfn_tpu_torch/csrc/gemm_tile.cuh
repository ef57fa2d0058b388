// Tiled matrix products and the row kernels shared by the backward kernels
// K7 (feat_attn_bwd.cu), K8 (mlp_ln_bwd.cu), K9 (item_attn_bwd.cu) and K10
// (item_epilogue_bwd.cu), and the library's direct entry mmpfn_gemm_bf16
// (gemm.cu):
//
//   C[m, n] = sum_k A(m, k) · B(k, n),  m < M, n < N, k < K,
//
// with A stored (M, K) row-major, or (K, M) when `a_t` (the product reads
// A^T), and B stored (K, N) row-major, or (N, K) when `b_t`. Each output is
// handed to an epilogue functor (store, add a residual, gelu, ...), which
// rounds where the Pallas kernels round.
//
// Weight gradients contract over all rows (K = rows, tens of thousands):
// they are split into chunks of `k_chunk` rows, each chunk's float32 partial
// sums go to a slab of a workspace, and `sum_slabs` adds the slabs in order.
// No atomics: a kernel's outputs are the same bits on every run, and a
// fine-tune is reproducible on one card.
//
// What bounds them on the H100 at the fine-tune's shapes (55 140 rows against
// weights of 192 × 192 to 768): the bytes. A product reads its row operand
// and writes its outputs once, with 2·N·K or fewer FLOPs a row against
// 2·(N + K) bytes or more, below the card's 295 FLOPs a byte.
//
// Two bodies. float32 operands (the parity mode), and bf16 operands whose
// base or rows are not 16-byte aligned, run on the CUDA cores (cc_kernel):
// 64×64 outputs per block, 4×4 per thread, tiles zero-filled past M, N and
// the chunk's end. Every other bf16 product runs on Hopper's tensor cores
// (wgmma_kernel), warp-specialised as the attention kernels (hopper.cuh):
//  * a block owns output tiles of 128 × 192, 64 rows to each of two consumer
//    warpgroups, one wgmma.m64n192k16 per 16 of the contraction with float32
//    accumulators in registers; the grid is persistent (a block per SM walks
//    the tiles), so the ring fills with the next tile while the consumers
//    store the last;
//  * one producer thread fills a ring of 4 stages, each a 64-deep k-tile of
//    A (two 64 × 64 boxes) and B (three), by TMA from 2-D tensor maps of the
//    operands as they are stored, under the 128-byte swizzle; the maps'
//    bounds zero-fill past M, N and K, and a chunk is a whole number of
//    k-tiles, so no box straddles two chunks;
//  * transposes by descriptor: a transposed operand is loaded as stored and
//    named MN-major to wgmma (the transpose bit), never moved in memory or
//    registers;
//  * the epilogue stages each warpgroup's 64 × 192 float32 outputs through
//    shared memory, half the columns at a time, and hands them to the
//    functor four consecutive columns a thread (`quad`): a warp reads its
//    residuals and writes its outputs in 16- or 8-byte vectors over
//    contiguous rows, every load issued before the first store.
#pragma once

#include "hopper.cuh"

#include <algorithm>
#include <type_traits>

namespace gemm {

// ---- epilogues --------------------------------------------------------------
// operator()(m, n, v, z): output (m, n) of chunk z with float32 value v (the
// CUDA cores). The tensor cores take four columns at once: load(m, n) reads
// what the outputs (m, n..n+3) need besides the product (Res: NoRes, or
// four residuals), issued for a batch of a thread's outputs before any is
// stored; quad(m, n, v, res, z) stores them, n a multiple of 4. Both round
// as the Pallas kernels do. aligned(), on the host, says whether every
// pointer that quad and load touch is aligned to a vector of four elements
// on every row, as their vector accesses need; else the CUDA cores take the
// product.
struct NoRes {};

// p + m·ld is aligned to four elements for every row m
template <typename T>
inline bool quad_aligned(const T* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0 && ld % 4 == 0;
}

struct Res4 {  // four consecutive residuals
  float v[4];
};

template <typename TO>
struct Store {  // out = v
  TO* out;
  int ld;
  using Res = NoRes;
  bool aligned() const { return quad_aligned(out, ld); }
  __device__ __forceinline__ void operator()(long long m, int n, float v, int) const {
    out[m * ld + n] = from_f<TO>(v);
  }
  __device__ __forceinline__ Res load(long long, int) const { return {}; }
  __device__ __forceinline__ void quad(long long m, int n, const float (&v)[4], Res, int) const {
    store4(out + m * ld + n, v);
  }
};

template <typename TO, typename TR>
struct AddStore {  // out = v + r
  TO* out;
  const TR* r;
  int ld;
  using Res = Res4;
  bool aligned() const { return quad_aligned(out, ld) && quad_aligned(r, ld); }
  __device__ __forceinline__ void operator()(long long m, int n, float v, int) const {
    out[m * ld + n] = from_f<TO>(v + to_f<TR>(r[m * ld + n]));
  }
  __device__ __forceinline__ Res load(long long m, int n) const {
    Res res;
    load4(r + m * ld + n, res.v);
    return res;
  }
  __device__ __forceinline__ void quad(long long m, int n, const float (&v)[4], const Res& res,
                                       int) const {
    const float o[4] = {v[0] + res.v[0], v[1] + res.v[1], v[2] + res.v[2], v[3] + res.v[3]};
    store4(out + m * ld + n, o);
  }
};

struct Partial {  // slab z of a split contraction
  float* work;
  long long slab;
  int ld;
  using Res = NoRes;
  bool aligned() const { return quad_aligned(work, ld) && slab % 4 == 0; }
  __device__ __forceinline__ void operator()(long long m, int n, float v, int z) const {
    work[z * slab + m * ld + n] = v;
  }
  __device__ __forceinline__ Res load(long long, int) const { return {}; }
  __device__ __forceinline__ void quad(long long m, int n, const float (&v)[4], Res, int z) const {
    store4(work + z * slab + m * ld + n, v);
  }
};

// ---- CUDA cores: any operand type, any shape -------------------------------
constexpr int CM = 64, CN = 64, CK = 16, CTHREADS = 256;

template <typename T, class Epi>
__global__ void __launch_bounds__(CTHREADS)
cc_kernel(const T* __restrict__ A, const T* __restrict__ B, long long M, int N, int K, int a_t,
          int b_t, int k_chunk, Epi epi) {
  __shared__ __align__(16) float As[CK][CM + 4];
  __shared__ __align__(16) float Bs[CK][CN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.y * CM;
  const int n0 = blockIdx.x * CN, z = blockIdx.z;
  const int kb = z * k_chunk, ke = min(K, kb + k_chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += CK) {
    // consecutive threads read consecutive addresses of the stored layout
    for (int i = tid; i < CM * CK; i += CTHREADS) {
      const int r = a_t ? i % CM : i / CK, kk = a_t ? i / CM : i % CK;
      const long long gm = m0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gm < M && gk < ke) ? to_f<T>(a_t ? A[(long long)gk * M + gm] : A[gm * K + gk])
                                      : 0.f;
    }
    for (int i = tid; i < CN * CK; i += CTHREADS) {
      const int c = b_t ? i / CK : i % CN, kk = b_t ? i % CK : i / CN;
      const int gn = n0 + c, gk = k0 + kk;
      Bs[kk][c] = (gn < N && gk < ke)
                      ? to_f<T>(b_t ? B[(long long)gn * K + gk] : B[(long long)gk * N + gn])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) epi(gm, gn, acc[i][j], z);
    }
  }
}

// ---- tensor cores: bf16 on wgmma from a TMA ring ----------------------------
constexpr int WM = 128, WN = 192, WK = 64;  // output tile (64 rows a consumer warpgroup), k-tile
constexpr int WSTAGES = 4;                  // depth of the ring
constexpr int WTHREADS = 384;               // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int BOX = 64 * WK * 2;            // bytes of a 64 × 64 box
constexpr int A_BOXES = WM / 64, B_BOXES = WN / 64;
constexpr int STAGE = (A_BOXES + B_BOXES) * BOX;
// the epilogue stages a warpgroup's 64 rows, half a tile's columns at a time,
// as float32 rows of 96 padded to 104 (a half warp's fragment writes hit
// distinct banks)
constexpr int HALF = WN / 2, SLD = HALF + 8;
constexpr int STAGED = WSTAGES * STAGE;                      // [2][64][SLD] floats
constexpr int WBARS = STAGED + 2 * 64 * SLD * 4;             // full[], empty[], (unused) own
constexpr int WSMEM = WBARS + (2 * WSTAGES + 1) * 8 + 1024;  // + alignment slack
constexpr int QUADS = 64 * HALF / 4 / 128;  // a consumer thread's outputs of 4 in a half
constexpr int QBATCH = 6;                    // ... whose residuals are loaded together
static_assert(QUADS % QBATCH == 0, "a half splits into whole batches");

// the 2-D tensor maps of A and B as stored, passed as a __grid_constant__
struct Maps {
  CUtensorMap a, b;
};

// Tile `tile` of m_tiles × n_tiles output tiles in each of the chunks, n
// fastest (neighbouring blocks share A's rows in L2): its first row and
// column, its chunk, the chunk's first k and its number of k-tiles.
struct Tile {
  long long m0;
  int n0, z, kb, nk;
};

__device__ __forceinline__ Tile tile_at(int tile, int m_tiles, int n_tiles, int K, int k_chunk) {
  const int nt = tile % n_tiles, rest = tile / n_tiles;
  const int mt = rest % m_tiles, z = rest / m_tiles;
  const int kb = z * k_chunk, ke = min(K, kb + k_chunk);
  return {(long long)mt * WM, nt * WN, z, kb, (ke - kb + WK - 1) / WK};
}

// A persistent grid: block b takes tiles b, b + gridDim.x, ... The producer
// thread runs through every k-tile of them in turn, so the ring fills with
// the next tile's operands while the consumers store the last one's outputs.
template <bool AT, bool BT, class Epi>
__global__ void __launch_bounds__(WTHREADS, 1)
    wgmma_kernel(const __grid_constant__ Maps maps, long long M, int N, int K, int k_chunk,
                 int m_tiles, int n_tiles, int tiles, Epi epi) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = ring_smem(smem_raw, WBARS, WSTAGES, 1, 8);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + WBARS);
  uint64_t* empty = full + WSTAGES;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (wg == 2) {  // producer
    producer_registers();
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Tile tl = tile_at(tile, m_tiles, n_tiles, K, k_chunk);
        for (int kt = 0; kt < tl.nk; ++kt, ++it) {
          const int s = it % WSTAGES, round = it / WSTAGES;
          if (round) mbar_wait(empty + s, (round - 1) & 1);
          uint8_t* st = sm + s * STAGE;
          const int k = tl.kb + kt * WK;
          mbar_arrive_tx(full + s, STAGE);
          // each operand as stored: (column, row) of its map
          for (int h = 0; h < A_BOXES; ++h) {
            const int m = (int)tl.m0 + 64 * h;
            tma_load(st + h * BOX, &maps.a, full + s, AT ? m : k, AT ? k : m, 0);
          }
          for (int j = 0; j < B_BOXES; ++j) {
            const int n = tl.n0 + 64 * j;
            tma_load(st + (A_BOXES + j) * BOX, &maps.b, full + s, BT ? k : n, BT ? n : k, 0);
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows [64·wg, 64·wg + 64) of each tile
    consumer_registers();
    const int lane = tid & 31, g = lane >> 2, q4 = lane & 3;
    // descriptor steps (16-byte units) per 16 of the contraction: a K-major
    // operand moves 32 bytes along its rows, an MN-major one 16 rows of 128
    constexpr int A_STEP = AT ? 128 : 2, B_STEP = BT ? 2 : 128;
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + i % WSTAGES);
    };
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile tl = tile_at(tile, m_tiles, n_tiles, K, k_chunk);
      const long long row0 = tl.m0 + 64 * wg;
      const bool live = row0 < M;  // a warpgroup past M only keeps the ring's count
      float acc[WN / 2];
      for (int kt = 0; kt < tl.nk; ++kt, ++it) {
        const int s = it % WSTAGES;
        mbar_wait(full + s, (it / WSTAGES) & 1);
        if (live) {
          const uint8_t* st = sm + s * STAGE;
          const uint64_t ad = tile_desc<WK>(st + wg * BOX);
          const uint64_t bd = tile_desc<WK>(st + A_BOXES * BOX, BT ? 16 : BOX);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < WK / 16; ++j)
            wgmma_ss_n192<AT, !BT>(acc, ad + A_STEP * j, bd + B_STEP * j, kt | j);
          wgmma_commit();
          wgmma_wait<1>();  // the k-tile before this one is done: release its stage
        }
        if (kt) release(it - 1);
      }
      if (live) {
        wgmma_wait<0>();
        keep(acc);
      }
      release(it - 1);
      if (!live) continue;
      // Each half of the tile's columns goes through shared memory: the
      // fragments in (register 4i + 2r + c: row 16·warp + g + 8r, column
      // 8i + 2·q4 + c), then four consecutive columns a thread out, a warp's
      // lanes on 128 consecutive outputs of one or two rows.
      float* stg = reinterpret_cast<float*>(sm + STAGED) + wg * 64 * SLD;
      const int wt = tid & 127, frow = 16 * ((tid >> 5) & 3) + g;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        bar_sync(1 + wg, 128);  // the last half's reads are done
#pragma unroll
        for (int i = 0; i < HALF / 8; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            store2(stg + (frow + 8 * r) * SLD + 8 * i + 2 * q4, acc[4 * (i + hf * HALF / 8) + 2 * r],
                   acc[4 * (i + hf * HALF / 8) + 2 * r + 1]);
        bar_sync(1 + wg, 128);
#pragma unroll
        for (int j0 = 0; j0 < QUADS; j0 += QBATCH) {
          typename Epi::Res res[QBATCH];
#pragma unroll
          for (int j = 0; j < QBATCH; ++j) {
            const int q = wt + 128 * (j0 + j), row = q / (HALF / 4), col = 4 * (q % (HALF / 4));
            const long long m = row0 + row;
            const int n = tl.n0 + hf * HALF + col;
            if (m < M && n < N) res[j] = epi.load(m, n);
          }
#pragma unroll
          for (int j = 0; j < QBATCH; ++j) {
            const int q = wt + 128 * (j0 + j), row = q / (HALF / 4), col = 4 * (q % (HALF / 4));
            const long long m = row0 + row;
            const int n = tl.n0 + hf * HALF + col;
            if (m < M && n < N) {
              const float4 f = *reinterpret_cast<const float4*>(stg + row * SLD + col);
              const float v[4] = {f.x, f.y, f.z, f.w};
              epi.quad(m, n, v, res[j], tl.z);
            }
          }
        }
      }
    }
  }
}

template <bool AT, bool BT, class Epi>
int wgmma_launch(const Maps& maps, long long M, int N, int K, int k_chunk, int splits, Epi epi,
                 cudaStream_t s) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err) return (int)err;
  }
  const int m_tiles = (int)((M + WM - 1) / WM), n_tiles = (N + WN - 1) / WN;
  const long long tiles = (long long)m_tiles * n_tiles * splits;
  if (tiles > 0x7fffffffLL) return MMPFN_BAD_ARGS;
  int rc = mmpfn_allow_smem(wgmma_kernel<AT, BT, Epi>, WSMEM);
  if (rc) return rc;
  wgmma_kernel<AT, BT, Epi><<<(unsigned)std::min<long long>(tiles, sms), WTHREADS, WSMEM, s>>>(
      maps, M, N, K, k_chunk, m_tiles, n_tiles, (int)tiles, epi);
  return (int)cudaGetLastError();
}

// Whether a bf16 product runs on the wgmma body: TMA needs 16-byte aligned
// bases and rows, the epilogue's quads whole columns of 4 (N % 8 == 0) and
// aligned pointers (Epi::aligned); else the CUDA cores take it.
template <class Epi>
bool wgmma_ok(const void* A, const void* B, long long M, int N, int K, bool a_t, bool b_t,
              const Epi& epi) {
  return K > 0 && M <= 0x7fffffffLL && N % 8 == 0 && (a_t ? M % 8 : K % 8) == 0 &&
         (b_t ? K % 8 : N % 8) == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(B) & 15) == 0 && epi.aligned();
}

// C = op(A)·op(B) through `epi`; `k_chunk` > 0 splits K into chunks
// (blockIdx.z, or the tile's chunk), else one chunk. Returns the launch's
// error code; MMPFN_BAD_ARGS where a split wgmma product's chunk is not a
// whole number of k-tiles (a box would straddle two chunks).
template <typename T, class Epi>
int run(const T* A, const T* B, long long M, int N, int K, bool a_t, bool b_t, int k_chunk,
        Epi epi, cudaStream_t s) {
  if (M <= 0 || N <= 0) return 0;
  if (k_chunk <= 0 || k_chunk > K) k_chunk = K > 0 ? K : 1;
  const int splits = K > 0 ? (K + k_chunk - 1) / k_chunk : 1;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (wgmma_ok(A, B, M, N, K, a_t, b_t, epi)) {
      if (splits > 1 && k_chunk % WK) return MMPFN_BAD_ARGS;
      Maps maps;
      // A (M, K) or stored (K, M); B (K, N) or stored (N, K): 64 × 64 boxes
      int rc = a_t ? hopper::make_map<WK>(&maps.a, A, K, 1, M)
                   : hopper::make_map<WK>(&maps.a, A, (int)M, 1, K);
      if (!rc) rc = b_t ? hopper::make_map<WK>(&maps.b, B, N, 1, K)
                        : hopper::make_map<WK>(&maps.b, B, K, 1, N);
      if (rc) return rc;
      if (a_t && b_t) return wgmma_launch<true, true>(maps, M, N, K, k_chunk, splits, epi, s);
      if (a_t) return wgmma_launch<true, false>(maps, M, N, K, k_chunk, splits, epi, s);
      if (b_t) return wgmma_launch<false, true>(maps, M, N, K, k_chunk, splits, epi, s);
      return wgmma_launch<false, false>(maps, M, N, K, k_chunk, splits, epi, s);
    }
  }
  const dim3 grid((N + CN - 1) / CN, (unsigned)((M + CM - 1) / CM), splits);
  cc_kernel<T, Epi><<<grid, CTHREADS, 0, s>>>(A, B, M, N, K, a_t, b_t, k_chunk, epi);
  return (int)cudaGetLastError();
}

// out[i] = sum over slabs z (in order) of work[z * len + i]
static __global__ void sum_slabs_kernel(const float* __restrict__ work, float* __restrict__ out,
                                 int slabs, long long len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int z = 0; z < slabs; ++z) s += work[z * len + i];
  out[i] = s;
}

// out (M, N) = op(A)·op(B) in float32, summed over K in chunks of `k_chunk`
// into `work` (ceil(K / k_chunk) slabs of M·N floats), then the slabs in
// order; one chunk (no `work`) when k_chunk <= 0 or >= K.
template <typename T>
int summed(const T* A, const T* B, float* out, float* work, long long M, int N, int K, bool a_t,
           bool b_t, int k_chunk, cudaStream_t s) {
  if (k_chunk <= 0 || k_chunk >= K) return run<T>(A, B, M, N, K, a_t, b_t, 0, Store<float>{out, N}, s);
  const int slabs = (K + k_chunk - 1) / k_chunk;
  const long long len = M * N;
  int rc = run<T>(A, B, M, N, K, a_t, b_t, k_chunk, Partial{work, len, N}, s);
  if (rc) return rc;
  sum_slabs_kernel<<<(unsigned)((len + 255) / 256), 256, 0, s>>>(work, out, slabs, len);
  return (int)cudaGetLastError();
}

// The weight gradient out (M, N) = A^T B summed over `rows` rows, A stored
// (rows, M) and B (rows, N), in chunks of `k_chunk` rows.
template <typename T>
int wgrad(const T* A, const T* B, float* out, float* work, long long rows, int M, int N,
          int k_chunk, cudaStream_t s) {
  if (rows > 0x7fffffffLL) return MMPFN_BAD_ARGS;
  return summed<T>(A, B, out, work, M, N, (int)rows, true, false, k_chunk, s);
}

// ---- LayerNorm backward over rows (a warp per row) -------------------------
// du = r·(g − mean(g) − n·mean(g·n)) with n = (u − mean(u))·r and
// r = 1/sqrt(var(u) + 1e-5): the cotangent of the affine-free LN at its float32
// input u. Writes du in float32 (if du32) and rounded to T (if du_c).
template <typename T>
__global__ void ln_bwd_kernel(const float* __restrict__ u, const T* __restrict__ g,
                              float* __restrict__ du32, T* __restrict__ du_c, long long rows,
                              int e) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ur = u + row * e;
  const T* gr = g + row * e;
  float s = 0.f;
  for (int c = lane; c < e; c += 32) s += ur[c];
  const float mean = warp_sum(s) / e;
  float q = 0.f;
  for (int c = lane; c < e; c += 32) q += (ur[c] - mean) * (ur[c] - mean);
  const float r = 1.f / sqrtf(warp_sum(q) / e + 1e-5f);
  float gs = 0.f, gn = 0.f;
  for (int c = lane; c < e; c += 32) {
    const float gv = to_f<T>(gr[c]);
    gs += gv;
    gn += gv * (ur[c] - mean) * r;
  }
  const float gmean = warp_sum(gs) / e, gnmean = warp_sum(gn) / e;
  for (int c = lane; c < e; c += 32) {
    const float du = r * (to_f<T>(gr[c]) - gmean - (ur[c] - mean) * r * gnmean);
    if (du32) du32[row * e + c] = du;
    if (du_c) du_c[row * e + c] = from_f<T>(du);
  }
}

template <typename T>
int ln_bwd(const float* u, const T* g, float* du32, T* du_c, long long rows, int e,
           cudaStream_t s) {
  ln_bwd_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(u, g, du32, du_c, rows, e);
  return (int)cudaGetLastError();
}

}  // namespace gemm

// The C entry points' dtype switch: calls body(T{}) for the operand type T.
template <class Body>
int mmpfn_dispatch(int dtype, Body body) {
  if (dtype == MMPFN_F32) return body(float{});
  if (dtype == MMPFN_BF16) return body(__nv_bfloat16{});
  return MMPFN_BAD_ARGS;
}
