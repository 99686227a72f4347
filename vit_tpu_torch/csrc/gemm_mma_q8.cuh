// int8 tensor-core GEMM core for Hopper (sm_90a): C = A @ B with A (M, K)
// int8 row-major and B given K-major, as bt (N, K) int8 row-major, exact
// int32 accumulators, and an epilogue functor of gemm_q8.cuh that receives
// each int32 sum with its (row, col) — where the dequantization runs.  The
// bf16 K15 and K19 (ln_qkv_q8_mma.cuh: the QKV GEMM), the bf16 K16 and K17
// (out_ln_mlp_residual_q8.cu, ln_mlp_residual_q8.cu: FC1 and FC2, through
// mlp_q8_mma below), the bf16 K18a (ln_fc1_gelu_q8.cu: FC1 over a shard's
// columns) and K18b (fc2_q8_partial.cu: FC2 over a shard's rows, int32 out)
// run their int8 GEMMs on it; the fp32 K15-K17, K18a and K19 keep
// gemm_q8.cuh (WMMA 16x16x16), and this is a header of its own so that
// neither gemm_q8.cuh's nor gemm_mma.cuh's kernels compile differently.
//
// What bounds an int8 GEMM on the H100: operations (ViT-B/16 @224 batch
// 100: 19,700 rows against 768 x 3,072 either way, 93 G integer operations
// each, at a peak of 1,979 TOP/s).  The design is gemm_mma.cuh's with int8
// operands:
//  - block tile 128 x 128, k-steps 128 deep, two warpgroups (256 threads),
//    two blocks per SM;
//  - TMA loads (2-D tensor maps over bytes, 128-byte swizzle, zero fill
//    past M, N and K: zeros add nothing to an integer sum) into a ring of 3
//    stages with full and empty mbarriers, as gemm_mma.cuh's.  A k-step of
//    128 int8 values is one 128-byte swizzled row, as a bf16 k-step of 64
//    is, so the ring, the boxes and the descriptors are the bf16 core's
//    K-major ones in bytes;
//  - each warpgroup issues wgmma.mma_async m64n128k32 .s32.s8.s8 (4 per
//    k-step, each advancing both descriptors 32 bytes, as bf16 advances
//    them per k16) over its 64 rows, 64 int32 accumulators per thread.
//    wgmma transposes from shared memory only for 16-bit types, so both
//    operands lie K-major: the activation codes as they are, the [in, out]
//    weight as its transpose (launch_transpose_q8 makes that copy);
//  - the epilogue stages the int32 tile through the freed ring (its bits in
//    gemm_mma.cuh's fp32 staging tile) and hands each sum to the functor
//    through gemm_mma.cuh's epilogue_rows, a warp on 32 neighbouring
//    columns.  The functors convert the int32 sum to fp32 once, with
//    round-to-nearest, as the TPU kernels' astype(float32); the residual
//    an FC2 functor reads is prefetched into L2 during the last k-steps.
// K and N must be multiples of 16 (the tensor maps' 16-byte row pitches);
// the operands' bases 16-byte aligned (the wrappers check).  Below the
// core: the weight transpose that makes B's K-major copy, the bf16 K16's
// two row quantizers, and the bf16 W8A8 MLP that K16 and K17 share.
#pragma once

#include "common.cuh"
#include "gemm_mma.cuh"
#include "gemm_q8.cuh"
#include "quant_rows.cuh"

namespace vt {

// d += a b over 64 x 32 x 128 int8 -> int32, both K-major from shared
// memory; d laid out as wgmma_m64n128k16's fp32 accumulators
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

constexpr int kQmBK = 128;  // int8 values per k-step: one 128-byte row
constexpr int kQmA = kGmBM * kQmBK;  // bytes of a stage's A tile; B's is as large
static_assert(2 * kQmA == (int)kGmStageBytes, "the bf16 core's ring, in bytes");

// a gemm_q8.cuh functor fed the int32 sums' bits from gemm_mma.cuh's fp32
// staging tile
template <class Epi>
struct Q8BitsEpi {
  Epi epi;
  __device__ __forceinline__ void operator()(int r, int c, float bits) const {
    epi(r, c, __float_as_int(bits));
  }
};

// gemm_mma.cuh's prefetch_epilogue for the FC2 functor: the residual x1's
// rows of the tile, into L2 during the last k-steps
template <typename T, typename TRes>
__device__ __forceinline__ void prefetch_epilogue(const DequantBiasResidualEpi<T, TRes>& e,
                                                  int row0, int col0, int M, int N) {
  prefetch_tile_rows(e.x1, e.ld, row0, col0, M, N);
}

template <class Epi>
__global__ void __launch_bounds__(kGmThreads, 2)
gemm_mma_q8_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b, int M, int N, int K, Epi epi) {
  extern __shared__ __align__(1024) unsigned char gq_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gq_smem) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kGmStages * kGmStageBytes);
  uint64_t* empty = full + kGmStages;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = blockIdx.y * kGmBM, col0 = blockIdx.x * kGmBN;
  const int ktiles = cdiv(K, kQmBK);

  // k-step kt lives in stage kt % kGmStages, in phase (kt / kGmStages) & 1
  auto issue = [&](int kt) {
    const int s = kt % kGmStages, k0 = kt * kQmBK;
    unsigned char* As = base + s * kGmStageBytes;
    mbar_expect_tx(&full[s], kGmStageBytes);
    tma_load_2d(reinterpret_cast<bf16*>(As), &tma_a, k0, row0, &full[s]);
    tma_load_2d(reinterpret_cast<bf16*>(As + kQmA), &tma_b, k0, col0, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < kGmStages; ++s) {
      mbar_init(&full[s], 1);   // the expect_tx arrival
      mbar_init(&empty[s], 2);  // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < kGmStages - 1 && kt < ktiles; ++kt) issue(kt);
  }
  __syncthreads();

  int d[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) d[j] = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kGmStages, next = kt + kGmStages - 1;
    if (tid == 0 && next < ktiles) {
      if (next >= kGmStages)  // the stage's previous k-step, kt - 1, released
        mbar_wait(&empty[next % kGmStages], (next / kGmStages - 1) & 1);
      issue(next);
    }
    if (kt == (ktiles > kGmPrefetchSteps ? ktiles - kGmPrefetchSteps : 0))
      prefetch_epilogue(epi, row0, col0, M, N);
    mbar_wait(&full[s], (kt / kGmStages) & 1);
    const unsigned char* As = base + s * kGmStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQmBK / 32; ++kk) {  // 32 bytes along the rows of both tiles
      const uint64_t da =
          wgmma_desc(reinterpret_cast<const bf16*>(As + wg * 64 * kQmBK + 32 * kk), 16, 1024);
      const uint64_t db = wgmma_desc(reinterpret_cast<const bf16*>(As + kQmA + 32 * kk), 16, 1024);
      wgmma_m64n128k32_s8(d, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    if ((tid & 127) == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with the stage
  }
  fence_acc(d);

  // the int32 tile through the ring, then the functor
  __syncthreads();
  int* Cs = reinterpret_cast<int*>(base);
  const int g = lane >> 2, c = lane & 3, r_own = 64 * wg + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<int2*>(Cs + (r_own + 8 * hr) * kGmLdC + 8 * j + 2 * c) =
          make_int2(d[4 * j + 2 * hr], d[4 * j + 2 * hr + 1]);
  __syncthreads();
  epilogue_rows(Q8BitsEpi<Epi>{epi}, reinterpret_cast<const float*>(Cs), row0, col0, M, N);
}

// a (outer, inner) row-major int8 matrix of row pitch ld bytes, read in
// boxes of box_outer rows x 128 bytes (the swizzle's span)
inline cudaError_t tma_map_q8(CUtensorMap* map, const int8_t* p, int inner, int outer, int ld,
                              int box_outer) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)kQmBK, (cuuint32_t)box_outer}, steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)p, dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                 CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// C = A @ B over int8 (M, K) x (K, N) on `stream`, B given as bt (N, K)
// row-major; K and N multiples of 16
template <class Epi>
inline cudaError_t launch_gemm_mma_q8(const int8_t* a, const int8_t* bt, int M, int N, int K,
                                      Epi epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K % kQ8Vec || N % kQ8Vec) return cudaErrorInvalidValue;
  CUtensorMap tma_a, tma_b;
  VT_TRY(tma_map_q8(&tma_a, a, K, M, K, kGmBM));
  VT_TRY(tma_map_q8(&tma_b, bt, K, N, K, kGmBN));
  VT_TRY(cudaFuncSetAttribute(gemm_mma_q8_kernel<Epi>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGmSmemBytes));
  const dim3 grid(cdiv(N, kGmBN), cdiv(M, kGmBM));
  gemm_mma_q8_kernel<Epi><<<grid, kGmThreads, kGmSmemBytes, stream>>>(tma_a, tma_b, M, N, K, epi);
  return cudaGetLastError();
}

// ---- the K-major copy of an int8 [in, out] weight: dst (cols, rows) =
// src (rows, cols)^T, both row-major, rows and cols multiples of 16.  64 x 64
// tiles through shared memory: 16-byte loads along src's rows, 16-byte
// stores along dst's.
constexpr int kTrTile = 64, kTrThreads = 256;

static __global__ void __launch_bounds__(kTrThreads)
transpose_q8_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst, int rows,
                    int cols) {
  __shared__ int8_t tile[kTrTile][kTrTile + 4];  // rows of src; + 4 spreads the column reads
  const int r0 = blockIdx.y * kTrTile, c0 = blockIdx.x * kTrTile;
  const int tr = threadIdx.x / 4, tc = threadIdx.x % 4 * 16;  // a row, a 16-byte chunk
  if (r0 + tr < rows && c0 + tc < cols) {
    const int4 v = *reinterpret_cast<const int4*>(src + (size_t)(r0 + tr) * cols + c0 + tc);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) tile[tr][tc + i] = b[i];
  }
  __syncthreads();
  // dst row c0 + tr, its columns r0 + tc .. + 15
  if (c0 + tr < cols && r0 + tc < rows) {
    int4 v;
    int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = tile[tc + i][tr];
    *reinterpret_cast<int4*>(dst + (size_t)(c0 + tr) * rows + r0 + tc) = v;
  }
}

inline cudaError_t launch_transpose_q8(const int8_t* src, int8_t* dst, int rows, int cols,
                                       cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  if (rows % kQ8Vec || cols % kQ8Vec) return cudaErrorInvalidValue;
  const dim3 grid(cdiv(cols, kTrTile), cdiv(rows, kTrTile));
  transpose_q8_kernel<<<grid, kTrThreads, 0, stream>>>(src, dst, rows, cols);
  return cudaGetLastError();
}

// ---- K16's two row quantizers, each holding its rows in registers so
// that the fp32 input is read from device memory once, with 16-byte loads
// and 4-byte code stores.  Wider rows than the register tiles take
// quant_rows.cuh's passes, which read a row twice.

// codes and scale of LayerNorm(x1) per row, x1 fp32 (rows, d), d a
// multiple of 4: one warp per row, kVecs float4 per lane.  The statistics
// are warp_row_stats' formulas (mean, then the centred variance, eps
// inside the rsqrt), summed in another order, so a code on a rounding
// boundary may move by one against ln_quant_rows_kernel's (the stage
// checks' rule for a row quantizer behind a LayerNorm)
template <int kVecs>
__global__ void __launch_bounds__(kRowThreads)
ln_quant_rows_reg_kernel(const float* __restrict__ x, const bf16* __restrict__ gamma,
                         const bf16* __restrict__ beta, int8_t* __restrict__ q,
                         float* __restrict__ qs, int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * d);
  const int nv = d / 4;
  float v[kVecs][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + 32 * i;
    const float4 t = j < nv ? __ldcs(xr + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[i][0] = t.x, v[i][1] = t.y, v[i][2] = t.z, v[i][3] = t.w;
    sum += (t.x + t.y) + (t.z + t.w);
  }
  const float mean = warp_sum(sum) / (float)d;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    if (lane + 32 * i < nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = v[i][e] - mean;
        var += c * c;
      }
  const float rstd = rsqrtf(warp_sum(var) / (float)d + eps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + 32 * i;
    if (j < nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[i][e] = (v[i][e] - mean) * rstd * to_f(gamma[4 * j + e]) + to_f(beta[4 * j + e]);
        amax = fmaxf(amax, fabsf(v[i][e]));
      }
  }
  const float scale = quant_scale(warp_max(amax));
  char4* qr = reinterpret_cast<char4*>(q + (size_t)row * d);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + 32 * i;
    if (j < nv)
      qr[j] = make_char4(quant_code(v[i][0], scale), quant_code(v[i][1], scale),
                         quant_code(v[i][2], scale), quant_code(v[i][3], scale));
  }
  if (lane == 0) qs[row] = scale;
}

// d up to 1,024 or 2,048 in registers
inline cudaError_t launch_ln_quant_rows_reg(const float* x, const bf16* gamma, const bf16* beta,
                                            int8_t* q, float* qs, int rows, int d, float eps,
                                            cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (d % 4) return cudaErrorInvalidValue;
  const int blocks = cdiv(rows, kRowThreads / 32);
  if (d <= 128 * 8)
    ln_quant_rows_reg_kernel<8><<<blocks, kRowThreads, 0, stream>>>(x, gamma, beta, q, qs, rows,
                                                                    d, eps);
  else if (d <= 128 * 16)
    ln_quant_rows_reg_kernel<16><<<blocks, kRowThreads, 0, stream>>>(x, gamma, beta, q, qs,
                                                                     rows, d, eps);
  else
    return launch_ln_quant_rows(x, gamma, beta, q, qs, rows, d, eps, stream);
  return cudaGetLastError();
}

// codes and scale per row of an fp32 (rows, n) matrix (K16's GELU output
// mid), n a multiple of 4: the bits of quant_rows_kernel (a maximum does
// not depend on its order).  A block of kMidThreads per row, kVecs float4
// per thread, the four warps' maxima joined through shared memory: few
// registers, so many rows stay in flight.
constexpr int kMidThreads = 128;

template <int kVecs>
__global__ void __launch_bounds__(kMidThreads)
quant_rows_reg_kernel(const float* __restrict__ v, int8_t* __restrict__ q,
                      float* __restrict__ qs, int n) {
  __shared__ float warp_amax[kMidThreads / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float4* vr = reinterpret_cast<const float4*>(v + (size_t)row * n);
  const int nv = n / 4;
  float4 x[kVecs];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = tid + kMidThreads * i;
    x[i] = j < nv ? __ldcs(vr + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x[i].x), fabsf(x[i].y)),
                             fmaxf(fabsf(x[i].z), fabsf(x[i].w))));
  }
  amax = warp_max(amax);
  if ((tid & 31) == 0) warp_amax[tid >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kMidThreads / 32; ++w) amax = fmaxf(amax, warp_amax[w]);
  const float scale = quant_scale(amax);
  char4* qr = reinterpret_cast<char4*>(q + (size_t)row * n);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = tid + kMidThreads * i;
    if (j < nv)
      qr[j] = make_char4(quant_code(x[i].x, scale), quant_code(x[i].y, scale),
                         quant_code(x[i].z, scale), quant_code(x[i].w, scale));
  }
  if (tid == 0) qs[row] = scale;
}

// n up to 4,096 or 8,192 in registers
inline cudaError_t launch_quant_rows_reg(const float* v, int8_t* q, float* qs, int rows, int n,
                                         cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (n % 4) return cudaErrorInvalidValue;
  if (n <= 4 * kMidThreads * 8)
    quant_rows_reg_kernel<8><<<rows, kMidThreads, 0, stream>>>(v, q, qs, n);
  else if (n <= 4 * kMidThreads * 16)
    quant_rows_reg_kernel<16><<<rows, kMidThreads, 0, stream>>>(v, q, qs, n);
  else
    return launch_quant_rows(v, q, qs, rows, n, stream);
  return cudaGetLastError();
}

// ---- the bf16 W8A8 MLP from LN2 on, over the residual x1 (K16's tail on
// its fp32 x1, K17 on its bf16 x): W1q and W2q copied K-major into w1t
// (f, d) and w2t (d, f); LN2's codes hq, hs of x1; mid = GELU((hq @ W1q) hs
// w1s + b1) in fp32; mid's codes mq, ms (one read of mid); out = (mq @ W2q)
// ms w2s + b2 + x1, rounded to bf16.  LN2's pass: fp32 x1 through K16's
// register pass; bf16 x through quant_rows.cuh's ln_quant_rows_kernel,
// whose statistics are warp_row_stats' own, so K17's codes stay those of
// K18a's stage 1 bit for bit (the register pass sums in another order and
// may move a code by one).  Each instance compiles only its own pass.
template <typename TRes>
cudaError_t mlp_q8_mma(const TRes* x1, const bf16* ln_scale, const bf16* ln_bias,
                       const int8_t* w1q, const float* w1s, const bf16* b1, const int8_t* w2q,
                       const float* w2s, const bf16* b2, int8_t* w1t, int8_t* w2t, int8_t* hq,
                       float* hs, float* mid, int8_t* mq, float* ms, bf16* out, int rows, int d,
                       int f, float eps, int variant, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  VT_TRY(launch_transpose_q8(w1q, w1t, d, f, stream));
  VT_TRY(launch_transpose_q8(w2q, w2t, f, d, stream));
  if constexpr (std::is_same<TRes, float>::value)
    VT_TRY(launch_ln_quant_rows_reg(x1, ln_scale, ln_bias, hq, hs, rows, d, eps, stream));
  else
    VT_TRY(launch_ln_quant_rows(x1, ln_scale, ln_bias, hq, hs, rows, d, eps, stream));
  VT_TRY(launch_gemm_mma_q8(hq, w1t, rows, f, d,
                            DequantBiasGeluEpi<bf16>{hs, w1s, b1, mid, f, variant}, stream));
  VT_TRY(launch_quant_rows_reg(mid, mq, ms, rows, f, stream));
  return launch_gemm_mma_q8(mq, w2t, rows, d, f,
                            DequantBiasResidualEpi<bf16, TRes>{ms, w2s, b2, x1, out, d}, stream);
}

}  // namespace vt
