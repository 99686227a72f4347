// K20: one in-place AdamW update of one parameter leaf.
// Replaces vit_tpu/ops/pallas/adamw_kernel.py:_leaf_update (_adamw_kernel),
// optax.adamw's math (scale_by_adam with eps_root = 0, decoupled weight
// decay, scale by -lr):
//   m = b1 m + (1 - b1) g            v = b2 v + (1 - b2) g^2
//   p = p - lr ((m bc1) / (sqrt(v bc2) + eps) + wd p)
// with bc = 1 / (1 - b^t) at the 1-based step t, computed on the host in
// fp32 like lr.  g and p are fp32 or bf16 and computed in fp32; m and v are
// fp32; p is written back in its own dtype.
//
// Bound on the H100 by device memory: each element reads g, p, m, v and
// writes p, m, v once (28 bytes per fp32 element; ViT-B/16's 86.6 M
// parameters move 2.42 GB a step, 0.724 ms at 3.35 TB/s), which is the
// floor the TPU kernel's input_output_aliases reach too.  One grid-stride
// pass per leaf, neighbouring threads on neighbouring elements (a version
// with 16-byte vectors of four elements measured no faster on the H100,
// PERF.md).  The TPU sends leaves under 2^15 elements or not divisible by
// its 128 lanes to jnp; here every leaf launches, and the loop bound masks
// the ragged edge.
#include "common.cuh"

#include <algorithm>

namespace vt {

struct AdamWArgs {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;  // omb = 1 - b, rounded from double
};

template <typename TP, typename TG>
__global__ void __launch_bounds__(256)
adamw_kernel(const TG* __restrict__ g, TP* __restrict__ p, float* __restrict__ m,
             float* __restrict__ v, long long n, AdamWArgs a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float gi = to_f(g[i]);
    const float mi = a.b1 * m[i] + a.omb1 * gi;
    const float vi = a.b2 * v[i] + a.omb2 * (gi * gi);
    const float pi = to_f(p[i]);
    const float upd = (mi * a.bc1) / (sqrtf(vi * a.bc2) + a.eps) + a.wd * pi;
    p[i] = from_f<TP>(pi - a.lr * upd);
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename TP, typename TG>
cudaError_t adamw(const void* g, void* p, float* m, float* v, long long n, AdamWArgs a,
                  cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 132 * 16);
  adamw_kernel<TP, TG><<<blocks, 256, 0, stream>>>((const TG*)g, (TP*)p, m, v, n, a);
  return cudaGetLastError();
}

}  // namespace vt

extern "C" int vt_adamw(const void* g, void* p, void* m, void* v, long long n, float lr,
                        float b1, float omb1, float b2, float omb2, float eps, float wd,
                        float bc1, float bc2, int p_dtype, int g_dtype, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vt::AdamWArgs a{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2};
  cudaStream_t s = (cudaStream_t)stream;
  float* mf = (float*)m;
  float* vf = (float*)v;
  using vt::bf16;
  if (p_dtype == vt::kFloat32 && g_dtype == vt::kFloat32)
    return (int)vt::adamw<float, float>(g, p, mf, vf, n, a, s);
  if (p_dtype == vt::kFloat32 && g_dtype == vt::kBFloat16)
    return (int)vt::adamw<float, bf16>(g, p, mf, vf, n, a, s);
  if (p_dtype == vt::kBFloat16 && g_dtype == vt::kFloat32)
    return (int)vt::adamw<bf16, float>(g, p, mf, vf, n, a, s);
  if (p_dtype == vt::kBFloat16 && g_dtype == vt::kBFloat16)
    return (int)vt::adamw<bf16, bf16>(g, p, mf, vf, n, a, s);
  return (int)cudaErrorInvalidValue;
}
