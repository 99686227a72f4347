// The bf16 GEMM core of K1 and K2 (gemm_mma.cuh) alone, for its card tests
// and its timing beside torch.matmul: c (M, N) fp32 = a (M, K) @ b (K, N),
// bf16 row-major operands, fp32 accumulation, each sum stored unrounded.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm_mma.cuh"

extern "C" int vt_gemm_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)vt::launch_gemm_mma((const vt::bf16*)a, k, (const vt::bf16*)b, n, m, n, k,
                                  vt::StoreEpi<float>{(float*)c, n}, (cudaStream_t)stream);
}
