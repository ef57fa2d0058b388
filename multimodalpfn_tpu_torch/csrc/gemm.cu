// The bf16 product tile of gemm_tile.cuh as a direct entry of the library:
// C (M × N, float32) = op(A)·op(B), A (M, K) or stored (K, M) when a_t, B
// (K, N) or stored (N, K) when b_t, through Store<float>, or through Partial
// and sum_slabs over chunks of k_chunk when 0 < k_chunk < K (work holds
// ceil(K / k_chunk) slabs of M·N floats). It serves the CUDA tests and
// tools/torch_kernel_ab.py --tile (the tile alone beside torch.matmul); no
// kernel of the main path calls it.
#include "gemm_tile.cuh"

extern "C" int mmpfn_gemm_bf16(const void* a, const void* b, float* c, float* work, long long M,
                               int N, int K, int a_t, int b_t, int k_chunk, int device,
                               void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return MMPFN_BAD_ARGS;
  return gemm::summed<__nv_bfloat16>((const __nv_bfloat16*)a, (const __nv_bfloat16*)b, c, work,
                                     M, N, K, a_t != 0, b_t != 0, k_chunk, (cudaStream_t)stream);
}
