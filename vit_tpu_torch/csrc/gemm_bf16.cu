// The bf16 GEMM core of K1, K2, K8 and K12b (gemm_mma.cuh) alone, for its
// card tests and its timing beside torch.matmul: c (M, N) fp32 = op(a) @
// op(b), bf16 row-major operands, fp32 accumulation, each sum stored
// unrounded.  op(a) is a (M, K), or with trans_a a^T of a (K, M) (the core's
// MN-major A); op(b) is b (K, N), or with trans_b b^T of a (N, K) (its
// K-major B); not both, as no kernel reads them so.  splits 1 is one pass;
// 0 splits the depth as the weight gradients do (mma_wgrad_split), n > 1
// into n, each split's fp32 partial in `partials` (vt_gemm_bf16_workspace
// bytes) and summed in split order.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm_mma.cuh"

namespace {

template <bool kTransA, bool kKMajorB>
cudaError_t gemm_form(const vt::bf16* a, const vt::bf16* b, float* c, float* partials, int m,
                      int n, int k, int splits, cudaStream_t s) {
  const int lda = kTransA ? m : k, ldb = kKMajorB ? k : n;
  if (splits == 1)
    return vt::launch_gemm_mma<kTransA, kKMajorB>(a, lda, b, ldb, m, n, k,
                                                  vt::StoreEpi<float>{c, n}, s);
  return vt::launch_wgrad_mma<kTransA, kKMajorB>(a, lda, b, ldb, m, n, k, c, partials, s, splits);
}

}  // namespace

extern "C" {

size_t vt_gemm_bf16_workspace(int m, int n, int k, int splits) {
  return splits == 1 ? 0 : vt::mma_partial_floats(m, n, k, splits) * sizeof(float);
}

int vt_gemm_bf16(const void* a, const void* b, void* c, void* partials, int m, int n, int k,
                 int trans_a, int trans_b, int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vt::bf16 *pa = (const vt::bf16*)a, *pb = (const vt::bf16*)b;
  float *pc = (float*)c, *pp = (float*)partials;
  cudaStream_t s = (cudaStream_t)stream;
  if (trans_a && trans_b) return (int)cudaErrorInvalidValue;
  if (trans_a) return (int)gemm_form<true, false>(pa, pb, pc, pp, m, n, k, splits, s);
  if (trans_b) return (int)gemm_form<false, true>(pa, pb, pc, pp, m, n, k, splits, s);
  return (int)gemm_form<false, false>(pa, pb, pc, pp, m, n, k, splits, s);
}

}  // extern "C"
