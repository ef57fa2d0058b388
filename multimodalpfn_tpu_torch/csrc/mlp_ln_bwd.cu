// K8: the backward of K3, out = LN(x + gelu(x·W1)·W2) over rows of x (rows, e):
//   given g = dL/dout, returns dx (rows, e) in x's type and dW1 (e, nhid),
//   dW2 (nhid, e) in float32, summed over all rows.
//
// Replaces multimodalpfn_tpu/ops/pallas_fused.py:_mlp_bwd_kernel_g and
// _mlp_bwd_kernel (pallas_call in _mlp_bwd_call, :709/:720/:759).
//
// What bounds it on the H100: the bytes of its launches. Six products of
// 2·e·nhid FLOPs per row (98 GFLOP at the flagship fine-tune shape, 55 140
// rows × 192 × 768: 0.099 ms at the bf16 peak) against the rows' traffic
// through device memory. The Pallas kernel recomputes a block of rows in
// VMEM and carries dW1, dW2 over a sequential grid. Two bodies here, each
// with its own C entry; the Python wrapper (ops/fused.py:mlp_bwd_body)
// picks one.
//
// mmpfn_mlp_ln_bwd, the sequence (float32 operands, the parity mode, and
// bf16 at widths the row pass does not take): each product is a launch of
// gemm_tile.cuh (bf16: wgmma from a TMA ring; float32: the CUDA cores) with
// its own epilogue, the intermediates in device memory (1.25 GB at the
// flagship shape in bf16, 0.37 ms at 3.35 TB/s):
//   1. z = x·W1, epilogue: gz = rnd(gelu(z)) and gelu'(z) (CUDA's exact
//      erf);
//   2. u = x + gz·W2 (float32); 3. du = LN'(u)·g (float32 and rounded);
//   4. dz = rnd((du·W2^T) ∘ gelu'(z)); 5. dx = du + dz·W1^T, rounded to T;
//   6. dW1 = x^T·dz and dW2 = gz^T·du over row chunks, float32 slabs summed
//      in order (no atomics: the same bits every run).
//
// mmpfn_mlp_ln_bwd_wg, the row pass (bf16 at e = 64, 128, 192 with nhid a
// multiple of 64, the widths of K3's wgmma body): one persistent kernel,
// wg::mlp_ln_bwd_wg_kernel (below), computes steps 1-5 for each tile of
// rows on chip and writes only what the weight gradients read (gz, du_c,
// dz) and dx, all bf16; then step 6 as above. At the flagship shape its
// launches move 0.53 GB (0.16 ms).
//
// The rounding points are the Pallas kernel's: gz, du, dz (:621-642).
#include "gemm_tile.cuh"
#include "ln_tile.cuh"

namespace {

// gz = z·Φ(z) and gelu'(z) = Φ(z) + z·φ(z), with CUDA's exact erf
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


// ---- bf16 on Hopper: the row pass -------------------------------------------
// Steps 1-5 of the sequence for bf16 at e = 64, 128, 192, designed for the
// H100 on K3's wgmma body (mlp_ln.cu), whose forward it recomputes:
//  * a persistent, warp-specialised block per SM walks tiles of 128 rows:
//    one producer thread and two consumer warpgroups, 64 rows each;
//  * the producer loads each tile's x rows by TMA from a 2-D map over
//    (rows, e) (its bounds zero-fill past the last row) and streams the
//    weights through a ring of half-stages, each W1[:, c:c+64] or
//    W2[c:c+64, :] as stored, in 64 × 64 boxes under the 128-byte swizzle,
//    twice a tile: pass A takes W1's chunk c, then W2's; pass B W2's, then
//    W1's;
//  * pass A is K3's forward: z = x·W1[:, c] on wgmma (W1's chunk named
//    MN-major), gz = rnd(gelu(z)) packed into A fragments and stored to
//    device memory (dW2 reads it), acc += gz·W2[c, :] (A from registers,
//    W2's chunk MN-major);
//  * the LN backward runs on the accumulator (ln_tile.cuh): u = x + acc,
//    du = LN'(u)·g stays in acc in float32, and rnd(du) is written into
//    shared memory in the x rows' layout, the A operand of pass B, from
//    where a TMA store writes du_c (dW2 reads it);
//  * pass B recomputes z = x·W1[:, c], takes dh = du_c·W2[c, :]^T (W2's
//    chunk, stored (64, e), is K-major for it), packs dz = rnd(dh ∘
//    gelu'(z)) into A fragments, stores it (dW1 reads it), and adds
//    dz·W1[:, c]^T to acc (W1's chunk, stored (e, 64), K-major), which so
//    ends as dx = du + dz·W1^T: rounded to bf16 over the x rows, it leaves
//    by a TMA store;
//  * the two consumer warpgroups take turns (named barriers) to issue their
//    products: in pass A chunk c - 1's second with chunk c's first, in pass
//    B chunk c - 1's dx product with chunk c's two; one warpgroup's gelu and
//    LN run beside the other's products;
//  * a turn holds two chunks of the ring (three in pass B) and the next
//    turn's two may be in flight: five half-stages at e = 192 (with the x
//    and du_c rows, 217 KB), eight below;
//  * gelu and gelu' are the Pallas kernel's Abramowitz-Stegun erf on one
//    ex2 and one rcp (ln_tile.cuh), as in K3's wgmma body, not the exact erf
//    of the sequence;
//  * the accumulator holds u, then du, then dx; no wgmma is issued under a
//    condition (ptxas serializes every wgmma of a kernel that does); no
//    atomics: the outputs are the same bits on every run.
namespace wg {

constexpr int BOX = 64 * 64 * 2;  // bytes of a 64 × 64 box
constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int TM = 128;           // rows a tile, 64 a consumer warpgroup
constexpr int HC = 64;            // hidden units a chunk
constexpr int TURN_BAR = 3;       // named barriers 3, 4: each warpgroup's turn (1, 2: epilogues)

// Shared memory of a block at width E: the x rows of the two warpgroups
// (E / 64 boxes each), their du_c rows, then the ring of ST half-stages
// (a weight chunk: E / 64 boxes), then the barriers.
template <int E>
struct Geo {
  static constexpr int NB = E / 64;
  static constexpr int XWG = NB * BOX;    // a warpgroup's 64 rows of x, or of du_c
  static constexpr int CHUNK = NB * BOX;  // W1[:, c:c+64] (E rows of k) or W2[c:c+64, :] (E columns)
  static constexpr int ST = E == 192 ? 5 : 8;
  static constexpr int RING = 4 * XWG;
  static constexpr int BARS = RING + ST * CHUNK;  // full[ST], empty[ST], xfull[2], xempty[2]
  static constexpr int SMEM = BARS + (2 * ST + 4) * 8 + 1024;  // + alignment slack
  static_assert(SMEM <= MMPFN_MAX_SMEM, "shared memory");
};

// the tensor maps of x, W1, W2, du_c and dx, passed as a __grid_constant__
struct Maps {
  CUtensorMap x, w1, w2, du_c, dx;
};

// Block b takes tiles b, b + gridDim.x, ...
template <int E>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_ln_bwd_wg_kernel(const __grid_constant__ Maps maps, const __nv_bfloat16* __restrict__ g,
                         __nv_bfloat16* __restrict__ gz, __nv_bfloat16* __restrict__ dz, int rows,
                         int nhid, int tiles) {
  using namespace hopper;
  using G = Geo<E>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sm + G::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::BARS);
  uint64_t* empty = full + G::ST;
  uint64_t* xfull = empty + G::ST;  // [2]: a warpgroup's x rows
  uint64_t* xempty = xfull + 2;     // [2]
  const int tid = threadIdx.x, wg = tid >> 7, nc = nhid / HC;
  if (tid == 0) {
    for (int s = 0; s < G::ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // every consumer warp
    }
    for (int i = 0; i < 4; ++i) mbar_init(xfull + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    producer_registers();
    if (tid == 256) {
      int it = 0, xt = 0;
      auto load_x = [&](int tile) {
        for (int h = 0; h < 2; ++h) {
          if (xt) mbar_wait(xempty + h, (xt - 1) & 1);
          mbar_arrive_tx(xfull + h, G::XWG);
          for (int b = 0; b < G::NB; ++b)
            tma_load(sm + h * G::XWG + b * BOX, &maps.x, xfull + h, 64 * b, TM * tile + 64 * h, 0);
        }
        ++xt;
      };
      // a tile's 4·nc loads; the x rows, which wait for the last tile's dx
      // store, go after the first ST of them
      const int per_tile = 4 * nc, x_at = min(G::ST, per_tile);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int k = 0; k < per_tile; ++k, ++it) {
          if (k == x_at) load_x(tile);
          // k = 2·nc·pass + 2c + half: pass A loads W1's chunk c, then
          // W2's; pass B W2's, then W1's
          const int c = (k / 2) % nc;
          const bool w1 = (k < 2 * nc) == (k % 2 == 0);
          const int s = it % G::ST;
          if (it >= G::ST) mbar_wait(empty + s, ((it / G::ST) - 1) & 1);
          mbar_arrive_tx(full + s, G::CHUNK);
          uint8_t* st = ring + s * G::CHUNK;
          // W1 rows 64b.. of columns c·64..; W2 columns 64b.. of rows c·64..
          for (int b = 0; b < G::NB; ++b) {
            if (w1) tma_load(st + b * BOX, &maps.w1, full + s, HC * c, 64 * b, 0);
            else tma_load(st + b * BOX, &maps.w2, full + s, 64 * b, HC * c, 0);
          }
        }
        if (x_at == per_tile) load_x(tile);
      }
    }
  } else {  // consumers: warpgroup wg owns rows [64·wg, 64·wg + 64) of each tile
    consumer_registers();
    const int lane = tid & 31, w = (tid >> 5) & 3;
    auto chunk = [&](int i) { return ring + (i % G::ST) * G::CHUNK; };
    auto wait_full = [&](int i) { mbar_wait(full + i % G::ST, (i / G::ST) & 1); };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + i % G::ST);
    };
    float acc[E / 2], z[HC / 2], dh[HC / 2];
    uint32_t a[HC / 16][4] = {};
    uint64_t xd = 0, dd = 0;  // descriptors of this warpgroup's x and du_c rows, K-major
    // z = x·W1[:, chunk]: W1's chunk MN-major, its k steps of 16 rows 2048 bytes apart
    auto z_prod = [&](int i) {
      const uint64_t bd = tile_desc<64>(chunk(i));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < E / 16; ++j)
        wgmma_ss_n64<0, 1>(z, xd + (j / 4) * (BOX >> 4) + 2 * (j % 4), bd + 128 * j, j);
    };
    // acc += gz·W2[chunk, :]: W2's chunk MN-major, its 64-column boxes BOX apart
    auto up_prod = [&](int i) {
      const uint64_t bd = tile_desc<64>(chunk(i), BOX);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < HC / 16; ++j) wgmma_rs<E>(acc, a[j], bd + 128 * j);
    };
    // dh = du_c·W2[chunk, :]^T: W2's chunk K-major, a box a 64 of the contraction
    auto dh_prod = [&](int i) {
      const uint64_t bd = tile_desc<64>(chunk(i));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < E / 16; ++j) {
        const int step = (j / 4) * (BOX >> 4) + 2 * (j % 4);
        wgmma_ss_n64<0, 0>(dh, dd + step, bd + step, j);
      }
    };
    // acc += dz·W1[:, chunk]^T: W1's chunk K-major (E rows of 128 bytes)
    auto dx_prod = [&](int i) {
      const uint64_t bd = tile_desc<64>(chunk(i));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < HC / 16; ++j) wgmma_rs<E, 0>(acc, a[j], bd + 2 * j);
    };
    // a turn: this warpgroup's products, issued after the other's and
    // waited for while the other issues its own
    auto turn = [&](auto issue) {
      bar_sync(TURN_BAR + wg, 256);
      issue();
      wgmma_commit();
      bar_arrive(TURN_BAR + (wg ^ 1), 256);
      wgmma_wait<0>();
      keep(z);
      keep(dh);
      keep(a);
      keep(acc);
    };
    // the A fragments of chunk c (hopper.cuh's layout) to columns c·64.. of
    // out (rows of nhid), rows past the last not written
    auto store_a = [&](__nv_bfloat16* out, int row0, int c) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = row0 + 16 * w + (lane >> 2) + 8 * r;
        if (m < rows) {
          uint32_t* p = reinterpret_cast<uint32_t*>(out + (long long)m * nhid + HC * c) + (lane & 3);
#pragma unroll
          for (int i = 0; i < HC / 8; ++i) p[4 * i] = a[i / 2][r + 2 * (i & 1)];
        }
      }
    };
    // gz = rnd(gelu(z)), the A fragments of up_prod
    auto hidden = [&](int row0, int c) {
#pragma unroll
      for (int i = 0; i < HC / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[i / 2][r + 2 * (i & 1)] = pack_bf16(gelu(z[4 * i + 2 * r]), gelu(z[4 * i + 2 * r + 1]));
      store_a(gz, row0, c);
    };
    // dz = rnd(dh ∘ gelu'(z)), the A fragments of dx_prod
    auto hidden_grad = [&](int row0, int c) {
#pragma unroll
      for (int i = 0; i < HC / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[i / 2][r + 2 * (i & 1)] = pack_bf16(dh[4 * i + 2 * r] * gelu_grad(z[4 * i + 2 * r]),
                                                dh[4 * i + 2 * r + 1] * gelu_grad(z[4 * i + 2 * r + 1]));
      store_a(dz, row0, c);
    };
    if (wg == 1) bar_arrive(TURN_BAR, 256);  // warpgroup 0 takes the first turn
    int it = 0, xt = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++xt) {
      uint8_t* xs = sm + wg * G::XWG;
      uint8_t* ds = sm + (2 + wg) * G::XWG;
      const int row0 = TM * tile + 64 * wg;
      mbar_wait(xfull + wg, xt & 1);
      xd = tile_desc<64>(xs);
      dd = tile_desc<64>(ds);
#pragma unroll
      for (int i = 0; i < E / 2; ++i) acc[i] = 0.f;
      // pass A, loads it + 2c (W1's chunk c) and it + 2c + 1 (W2's): turn 0
      // takes chunk 0's first product; turn c chunk c - 1's second and chunk
      // c's first; turn nc chunk nc - 1's second
      wait_full(it);
      turn([&] { z_prod(it); });
      release(it);
      hidden(row0, 0);
      for (int c = 1; c < nc; ++c) {
        wait_full(it + 2 * c - 1);
        wait_full(it + 2 * c);
        turn([&] {
          up_prod(it + 2 * c - 1);
          z_prod(it + 2 * c);
        });
        release(it + 2 * c - 1);
        release(it + 2 * c);
        hidden(row0, c);
      }
      wait_full(it + 2 * nc - 1);
      turn([&] { up_prod(it + 2 * nc - 1); });
      release(it + 2 * nc - 1);
      it += 2 * nc;
      // du = LN'(x + acc)·g in acc; rnd(du) into the du_c rows, stored out
      residual_ln_bwd_tile<E>(acc, xs, g, row0, rows, ds);
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if ((tid & 127) == 0 && row0 < rows) {
        for (int b = 0; b < G::NB; ++b) tma_store(&maps.du_c, ds + b * BOX, 64 * b, row0, 0);
        bulk_commit();
      }
      // pass B, loads it + 2c (W2's chunk c) and it + 2c + 1 (W1's): turn 0
      // takes chunk 0's z and dh; turn c chunk c - 1's dx product and chunk
      // c's z and dh; turn nc chunk nc - 1's dx product
      wait_full(it);
      wait_full(it + 1);
      turn([&] {
        z_prod(it + 1);
        dh_prod(it);
      });
      release(it);
      hidden_grad(row0, 0);
      for (int c = 1; c < nc; ++c) {
        wait_full(it + 2 * c);
        wait_full(it + 2 * c + 1);
        turn([&] {
          dx_prod(it + 2 * c - 1);
          z_prod(it + 2 * c + 1);
          dh_prod(it + 2 * c);
        });
        release(it + 2 * c - 1);
        release(it + 2 * c);
        hidden_grad(row0, c);
      }
      turn([&] { dx_prod(it + 2 * nc - 1); });
      release(it + 2 * nc - 1);
      it += 2 * nc;
      // dx over the x rows (pass B's last read of them is done), stored out;
      // then the x buffer takes the next tile's rows
      acc_to_tile<E>(acc, xs);
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if ((tid & 127) == 0) {
        if (row0 < rows) {
          for (int b = 0; b < G::NB; ++b) tma_store(&maps.dx, xs + b * BOX, 64 * b, row0, 0);
          bulk_commit();
        }
        bulk_wait_read();
        mbar_arrive(xempty + wg);
      }
    }
    if (wg == 0) bar_sync(TURN_BAR, 256);  // warpgroup 1's last turn
    if ((tid & 127) == 0) bulk_wait();
  }
}

template <int E>
int launch_wg(const void* x, const void* w1, const void* w2, const void* g, void* gz, void* du_c,
              void* dz, void* dx, long long rows, int nhid, cudaStream_t stream) {
  using G = Geo<E>;
  if (rows > 0x7fffffffLL - TM) return MMPFN_BAD_ARGS;
  // TMA: 16-byte aligned bases (rows of 2·E and 2·nhid bytes are); the
  // direct loads and stores of g, gz and dz: pairs of bf16
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2) |
       reinterpret_cast<uintptr_t>(du_c) | reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(gz) | reinterpret_cast<uintptr_t>(dz)) & 15)
    return MMPFN_BAD_ARGS;
  Maps maps;
  int rc = hopper::make_map<64>(&maps.x, x, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.du_c, du_c, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.dx, dx, (int)rows, 1, E);
  if (!rc) rc = hopper::make_map<64>(&maps.w1, w1, E, 1, nhid);
  if (!rc) rc = hopper::make_map<64>(&maps.w2, w2, nhid, 1, E);
  if (!rc) rc = mmpfn_allow_smem(mlp_ln_bwd_wg_kernel<E>, G::SMEM);
  static int sms = 0;
  if (!rc && !sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    rc = (int)err;
  }
  if (rc) return rc;
  const int tiles = (int)((rows + TM - 1) / TM);
  mlp_ln_bwd_wg_kernel<E><<<std::min(tiles, sms), THREADS, G::SMEM, stream>>>(
      maps, (const __nv_bfloat16*)g, (__nv_bfloat16*)gz, (__nv_bfloat16*)dz, (int)rows, nhid, tiles);
  return (int)cudaGetLastError();
}

}  // namespace wg

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

// The row pass (bf16 at e = 64, 128, 192, nhid a multiple of 64), then the
// weight gradients: gz, du_c, dz and dx (rows, ·) in bf16, dW1 and dW2 in
// float32 summed over chunks of wgrad_rows rows in `work`.
extern "C" int mmpfn_mlp_ln_bwd_wg(const void* x, const void* w1, const void* w2, const void* g,
                                   void* gz, void* du_c, void* dz, void* dx, float* dw1, float* dw2,
                                   float* work, long long rows, int e, int nhid, int wgrad_rows,
                                   int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (rows <= 0) return 0;
  if (nhid <= 0 || nhid % wg::HC) return MMPFN_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  switch (e) {
    case 64: rc = wg::launch_wg<64>(x, w1, w2, g, gz, du_c, dz, dx, rows, nhid, st); break;
    case 128: rc = wg::launch_wg<128>(x, w1, w2, g, gz, du_c, dz, dx, rows, nhid, st); break;
    case 192: rc = wg::launch_wg<192>(x, w1, w2, g, gz, du_c, dz, dx, rows, nhid, st); break;
    default: return MMPFN_BAD_ARGS;
  }
  if (rc) return rc;
  using T = __nv_bfloat16;
  if ((rc = gemm::wgrad<T>((const T*)x, (const T*)dz, dw1, work, rows, e, nhid, wgrad_rows, st))) return rc;
  return gemm::wgrad<T>((const T*)gz, (const T*)du_c, dw2, work, rows, nhid, e, wgrad_rows, st);
}
