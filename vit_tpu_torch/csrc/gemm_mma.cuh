// Bf16 tensor-core GEMM core for Hopper (sm_90a): C = A @ B with A (M, K)
// and B (K, N) bf16 row-major in device memory (B is a weight in [in, out]
// layout), fp32 accumulators, and an epilogue functor (epilogue.cuh) that
// receives each accumulator with its (row, col).  K1 (ln_qkv_attn.cu) and
// K2 (out_ln_mlp_residual.cu) run their bf16 GEMMs on it, and so do the
// bf16 K8 and K12b (mlp_bwd_mma.cuh) in the operand forms a backward needs;
// every other kernel keeps gemm.cuh.
//
// Operand forms (template flags of launch_gemm_mma; the default form is
// gemm_mma_kernel, the others gemm_mma_form_kernel, one body):
//  - kTransA, A read MN-major: A(m, k) = a[k][m] with a (K, M) row-major,
//    an activation transposed (h^T of a weight gradient, K its rows): TMA
//    boxes of 64 k-rows x 64 m-columns, two atoms a stage as B's, and
//    wgmma's transposed-A form (bf16 may transpose from shared memory);
//  - kKMajorB, B read K-major: B(k, n) = b[n][k] with b (N, K) row-major,
//    an [in, out] weight transposed (dY W^T): TMA boxes of 128 n-rows x 64
//    k laid out as A's tiles, and wgmma's plain-B form;
//  - split-K (launch_wgrad_mma): gridDim.z takes a range of whole k-steps
//    of the depth (a weight gradient's rows) and writes its own fp32
//    partial tile; sum_partials_kernel (gemm.cuh) adds them in split
//    order, so a result never changes from run to run.
//
// What bounds a GEMM on the H100: operations (ViT-B/16 @224 batch 100: M =
// 19,700 rows against K and N of 768-3,072, hundreds of flops per byte).
// The design keeps the tensor cores fed from shared memory:
//  - block tile 128 x 128, k-steps 64 deep, two warpgroups (256 threads),
//    two blocks per SM;
//  - TMA loads (2-D tensor maps, 128-byte swizzle, zero fill past M, N and
//    K) of each k-step's A and B tiles into a ring of 3 shared-memory
//    stages, each with a "full" mbarrier (the copies' bytes) and an
//    "empty" one (one arrival per warpgroup done with the stage); thread 0
//    issues k-step kt + 2 into the stage k-step kt - 1 used, once both
//    warpgroups have released it: no block-wide barrier in the main loop;
//  - each warpgroup issues wgmma.mma_async m64n128k16 (4 per k-step) over
//    its 64 rows straight from shared memory through matrix descriptors,
//    64 fp32 accumulators per thread.  The tiles lie as the swizzle writes
//    them, 1,024-byte aligned: A K-major, 128-byte rows whose 16-byte
//    chunk j sits at j ^ (row % 8); B, the [in, out] weight, read MN-major
//    (wgmma's transposed-B form) as two 64-column atoms of 64 k-rows,
//    chunk j of k-row k at j ^ (k % 8);
//  - grid x over column tiles, y over row tiles: consecutive blocks share
//    one A row block, which comes from device memory about once and is
//    then served from L2 (B, a weight of at most a few MB, stays in L2);
//  - the epilogue stages the fp32 tile through the freed ring, then calls
//    the functor along rows, a warp on 32 neighbouring columns, so its
//    stores and its residual and bias loads coalesce; whole tiles run
//    unrolled with no bounds test.  A functor's loads each wait behind its
//    previous store, so a residual the epilogue will read (BiasResidualEpi)
//    is prefetched into L2 during the main loop's last k-steps.  The two
//    blocks of an SM overlap one's epilogue with the other's main loop.
// LayerNorm is not applied in the tile loads: launch_ln_rows normalises
// each row once into a bf16 scratch that the GEMM then copies as is.  A
// wait on an mbarrier that never completes traps (a launch failure the
// wrapper reports) instead of hanging the card.
#pragma once

#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "mma_bf16.cuh"

#include <cuda.h>

#include <algorithm>

namespace vt {

// ---- wgmma (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply").

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += a b over 64 x 16 x 128, both from shared memory: a K-major (or
// MN-major with kTransA), b MN-major (or K-major with kTransB = 0); d is
// this thread's 64 accumulators, laid out per n8 tile j as mma.sync's C
// fragment: d[4j .. 4j+1] at (16 warp + g, 8j + 2c .. + 1), d[4j+2 .. 4j+3]
// at row + 8 (lane = 4 g + c)
template <int kTransA = 0, int kTransB = 1>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// the accumulators are written by wgmma behind the compiler's back: pin
// every read after the wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- mbarriers and TMA (PTX ISA, "Parallel Synchronization and
// Communication Instructions: mbarrier", "cp.async.bulk.tensor").

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}

// the producer's arrival, with the bytes the stage's copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_addr(b);
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 24)) __trap();  // an arrival that never comes: fail, never hang
  }
}

// the box of a 2-D tensor map at element coordinates (c0 innermost, c1)
// into shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void tma_load_2d(bf16* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// ---- the core.

constexpr int kGmBM = 128, kGmBN = 128, kGmBK = 64, kGmStages = 3, kGmThreads = 256;
constexpr int kGmA = kGmBM * kGmBK, kGmB = kGmBK * kGmBN;  // elements of a stage's tiles
constexpr uint32_t kGmStageBytes = (kGmA + kGmB) * sizeof(bf16);
constexpr int kGmLdC = kGmBN + 8;  // fp32 pitch of the staged epilogue tile
// the ring (1,024-byte aligned: the swizzle is a function of the address),
// the full and empty mbarriers, and the alignment slack
constexpr size_t kGmSmemBytes =
    (size_t)kGmStages * kGmStageBytes + 2 * kGmStages * sizeof(uint64_t) + 1024;
static_assert((size_t)kGmBM * kGmLdC * sizeof(float) <= (size_t)kGmStages * kGmStageBytes,
              "the epilogue tile fits in the ring");

// epi(r, c, tile[r][c]) over the staged fp32 tile, a warp along 32
// neighbouring columns of one row; a whole tile runs unrolled with no
// bounds test
template <class Epi>
__device__ __forceinline__ void epilogue_rows(const Epi& epi, const float* Cs, int row0, int col0,
                                              int M, int N) {
  constexpr int kRows = kGmThreads / kGmBN;  // rows per pass
  const int rr = threadIdx.x / kGmBN, cc = threadIdx.x % kGmBN;
  if (row0 + kGmBM <= M && col0 + kGmBN <= N) {
#pragma unroll 16
    for (int r = rr; r < kGmBM; r += kRows) epi(row0 + r, col0 + cc, Cs[r * kGmLdC + cc]);
  } else if (col0 + cc < N) {
    for (int r = rr; r < kGmBM && row0 + r < M; r += kRows)
      epi(row0 + r, col0 + cc, Cs[r * kGmLdC + cc]);
  }
}

// What an epilogue functor will read one element at a time, behind its
// own store, into L2 during the main loop's last kGmPrefetchSteps k-steps
// (earlier, a long K lets it fall out again): nothing for most functors;
// BiasResidualEpi's residual rows of the tile (from device memory they
// would cost a full miss per element, one after the other).
constexpr int kGmPrefetchSteps = 6;
template <class Epi>
__device__ __forceinline__ void prefetch_epilogue(const Epi&, int, int, int, int) {}

// the tile's rows of a row-major (M, N) matrix p (pitch ld) into L2
template <typename X>
__device__ __forceinline__ void prefetch_tile_rows(const X* p, int ld, int row0, int col0, int M,
                                                   int N) {
  constexpr int kLine = 128 / sizeof(X), kLines = kGmBN / kLine;  // 128-byte lines per row
  for (int i = threadIdx.x; i < kGmBM * kLines; i += kGmThreads) {
    const int r = row0 + i / kLines, c = col0 + i % kLines * kLine;
    if (r < M && c < N) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + (size_t)r * ld + c));
  }
}

template <typename TB, typename TRes, typename TOut>
__device__ __forceinline__ void prefetch_epilogue(const BiasResidualEpi<TB, TRes, TOut>& e,
                                                  int row0, int col0, int M, int N) {
  prefetch_tile_rows(e.res, e.ld, row0, col0, M, N);
}

// The tile of output rows blockIdx.y, columns blockIdx.x in the operand
// forms the flags name (the header comment); with kSplit, over k-steps
// [blockIdx.z * k_chunk, + k_chunk) of the depth only (k_chunk a multiple of
// kGmBK, so a split's last box ends where the next split's first begins).
template <bool kTransA, bool kKMajorB, bool kSplit, class Epi>
__device__ __forceinline__ void gemm_mma_tile(const CUtensorMap& tma_a, const CUtensorMap& tma_b,
                                              int M, int N, int K, int k_chunk, const Epi& epi) {
  extern __shared__ __align__(1024) unsigned char gm_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gm_smem) + 1023) & ~(uintptr_t)1023);
  bf16* ring = reinterpret_cast<bf16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kGmStages * kGmStageBytes);
  uint64_t* empty = full + kGmStages;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = blockIdx.y * kGmBM, col0 = blockIdx.x * kGmBN;
  int k_begin = 0, ktiles;
  if constexpr (kSplit) {
    k_begin = blockIdx.z * k_chunk;
    ktiles = cdiv(min(K - k_begin, k_chunk), kGmBK);
  } else {
    ktiles = cdiv(K, kGmBK);
  }

  // k-step kt lives in stage kt % kGmStages, in phase (kt / kGmStages) & 1
  auto issue = [&](int kt) {
    const int s = kt % kGmStages;
    int k0 = kt * kGmBK;
    if constexpr (kSplit) k0 += k_begin;
    bf16* As = ring + s * (kGmA + kGmB);
    bf16* Bs = As + kGmA;
    mbar_expect_tx(&full[s], kGmStageBytes);
    if constexpr (kTransA) {  // two 64-column atoms of a (K, M)
      tma_load_2d(As, &tma_a, row0, k0, &full[s]);
      tma_load_2d(As + 64 * 64, &tma_a, row0 + 64, k0, &full[s]);
    } else {
      tma_load_2d(As, &tma_a, k0, row0, &full[s]);
    }
    if constexpr (kKMajorB) {  // 128 rows of b (N, K), as A's tile
      tma_load_2d(Bs, &tma_b, k0, col0, &full[s]);
    } else {  // two 64-column atoms
      tma_load_2d(Bs, &tma_b, col0, k0, &full[s]);
      tma_load_2d(Bs + 64 * 64, &tma_b, col0 + 64, k0, &full[s]);
    }
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

  float d[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) d[j] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kGmStages, next = kt + kGmStages - 1;
    if (tid == 0 && next < ktiles) {
      if (next >= kGmStages)  // the stage's previous k-step, next - kGmStages = kt - 1, released
        mbar_wait(&empty[next % kGmStages], (next / kGmStages - 1) & 1);
      issue(next);
    }
    if (kt == (ktiles > kGmPrefetchSteps ? ktiles - kGmPrefetchSteps : 0))
      prefetch_epilogue(epi, row0, col0, M, N);
    mbar_wait(&full[s], (kt / kGmStages) & 1);
    const bf16* As = ring + s * (kGmA + kGmB);
    const bf16* Bs = As + kGmA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGmBK / 16; ++kk) {
      // A: 32 bytes along its rows, or (MN-major) 16 k-rows of this
      // warpgroup's atom; B: 16 k-rows of both atoms, or (K-major) 32 bytes
      // along its 128 rows
      const uint64_t da = kTransA ? wgmma_desc(As + wg * 64 * 64 + kk * 16 * 64, 64 * 64 * 2, 1024)
                                  : wgmma_desc(As + wg * 64 * 64 + 16 * kk, 16, 1024);
      const uint64_t db = kKMajorB ? wgmma_desc(Bs + 16 * kk, 16, 1024)
                                   : wgmma_desc(Bs + kk * 16 * 64, 64 * 64 * 2, 1024);
      wgmma_m64n128k16<kTransA ? 1 : 0, kKMajorB ? 0 : 1>(d, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    if ((tid & 127) == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with the stage
  }
  fence_acc(d);

  // the fp32 tile through the ring (every copy has landed and been read
  // once both warpgroups are past their last wait), then the functor
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(base);
  const int g = lane >> 2, c = lane & 3, r_own = 64 * wg + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(Cs + (r_own + 8 * hr) * kGmLdC + 8 * j + 2 * c) =
          make_float2(d[4 * j + 2 * hr], d[4 * j + 2 * hr + 1]);
  __syncthreads();
  epilogue_rows(epi, Cs, row0, col0, M, N);
}

// the default form: A K-major, B the [in, out] weight read MN-major
template <class Epi>
__global__ void __launch_bounds__(kGmThreads, 2)
gemm_mma_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, int M, int N, int K, Epi epi) {
  gemm_mma_tile<false, false, false>(tma_a, tma_b, M, N, K, K, epi);
}

// the other forms, and split-K
template <bool kTransA, bool kKMajorB, bool kSplit, class Epi>
__global__ void __launch_bounds__(kGmThreads, 2)
gemm_mma_form_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b, int M, int N, int K, int k_chunk,
                     Epi epi) {
  gemm_mma_tile<kTransA, kKMajorB, kSplit>(tma_a, tma_b, M, N, K, k_chunk, epi);
}

// the driver's cuTensorMapEncodeTiled, reached through the runtime (no
// link against the driver library)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a (outer, inner) row-major bf16 matrix with row pitch ld, read in boxes
// of box_outer rows x 64 elements (128 bytes: the swizzle's span)
inline cudaError_t tma_map(CUtensorMap* map, const bf16* p, int inner, int outer, int ld,
                           int box_outer) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer}, steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)p, dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                 CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// A's and B's tensor maps in the forms the flags name: lda and ldb are the
// row pitches of the matrices as they lie in memory
template <bool kTransA, bool kKMajorB>
inline cudaError_t tma_maps(CUtensorMap* tma_a, CUtensorMap* tma_b, const bf16* A, int lda,
                            const bf16* B, int ldb, int M, int N, int K) {
  VT_TRY(kTransA ? tma_map(tma_a, A, M, K, lda, kGmBK) : tma_map(tma_a, A, K, M, lda, kGmBM));
  return kKMajorB ? tma_map(tma_b, B, K, N, ldb, kGmBN) : tma_map(tma_b, B, N, K, ldb, kGmBK);
}

// C = A @ B over (M, K) x (K, N) on `stream`, A as (M, K) or with kTransA
// (K, M), B as (K, N) or with kKMajorB (N, K) in memory; every width a
// multiple of 8 and every row 16-byte aligned (the wrappers check)
template <bool kTransA = false, bool kKMajorB = false, class Epi>
inline cudaError_t launch_gemm_mma(const bf16* A, int lda, const bf16* B, int ldb, int M, int N,
                                   int K, Epi epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  CUtensorMap tma_a, tma_b;
  VT_TRY((tma_maps<kTransA, kKMajorB>(&tma_a, &tma_b, A, lda, B, ldb, M, N, K)));
  const dim3 grid(cdiv(N, kGmBN), cdiv(M, kGmBM));
  if constexpr (!kTransA && !kKMajorB) {
    VT_TRY(cudaFuncSetAttribute(gemm_mma_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kGmSmemBytes));
    gemm_mma_kernel<Epi><<<grid, kGmThreads, kGmSmemBytes, stream>>>(tma_a, tma_b, M, N, K, epi);
  } else {
    auto kernel = gemm_mma_form_kernel<kTransA, kKMajorB, false, Epi>;
    VT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kGmSmemBytes));
    kernel<<<grid, kGmThreads, kGmSmemBytes, stream>>>(tma_a, tma_b, M, N, K, K, epi);
  }
  return cudaGetLastError();
}

// ---- split-K weight gradients: fp32 out (M, N) = A @ B, K the rows.
//
// A weight gradient of ViT-B/16 has 6 x 24 = 144 tiles (768 x 3,072 either
// way round), fewer than the 264 blocks the card holds at once (2 on each
// of 132 SMs), so the depth is split.  The split is a function of the
// shape only (a run's partition and its summation order never change): the
// count of whole-k-step chunks that minimises (waves of kGmSlots blocks) x
// (k-steps per block + kGmSplitCost, a block's fixed cost: pipeline fill,
// epilogue and its partial's share of the sum), the fewer splits on a tie.
constexpr int kGmSlots = 2 * 132, kGmMaxSplits = 32, kGmSplitCost = 8;

struct MmaSplit {
  int splits;   // gridDim.z
  int k_chunk;  // depth per split, a multiple of kGmBK
};

// `want` > 0 forces that many splits (as near as whole k-steps allow)
inline MmaSplit mma_wgrad_split(int M, int N, int K, int want = 0) {
  const int steps = std::max(1, cdiv(K, kGmBK)), tiles = cdiv(M, kGmBM) * cdiv(N, kGmBN);
  int per = cdiv(steps, std::max(1, want));  // k-steps per split
  if (want <= 0) {
    long best = -1;
    for (int s = 1; s <= std::min(steps, kGmMaxSplits); ++s) {
      const int p = cdiv(steps, s);
      const long cost = (long)cdiv(tiles * cdiv(steps, p), kGmSlots) * (p + kGmSplitCost);
      if (best < 0 || cost < best) best = cost, per = p;
    }
  }
  return {cdiv(steps, per), per * kGmBK};
}

// fp32 floats of partials launch_wgrad_mma needs (0 when it does not split)
inline size_t mma_partial_floats(int M, int N, int K, int want = 0) {
  const MmaSplit s = mma_wgrad_split(M, N, K, want);
  return s.splits > 1 ? (size_t)s.splits * M * N : 0;
}

// out = A @ B in fp32, A and B in the forms the flags name; `partials` as
// mma_partial_floats sizes it
template <bool kTransA, bool kKMajorB = false>
inline cudaError_t launch_wgrad_mma(const bf16* A, int lda, const bf16* B, int ldb, int M, int N,
                                    int K, float* out, float* partials, cudaStream_t stream,
                                    int want = 0) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0) return cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(float), stream);
  const MmaSplit sp = mma_wgrad_split(M, N, K, want);
  if (sp.splits == 1)
    return launch_gemm_mma<kTransA, kKMajorB>(A, lda, B, ldb, M, N, K, StoreEpi<float>{out, N},
                                              stream);
  CUtensorMap tma_a, tma_b;
  VT_TRY((tma_maps<kTransA, kKMajorB>(&tma_a, &tma_b, A, lda, B, ldb, M, N, K)));
  auto kernel = gemm_mma_form_kernel<kTransA, kKMajorB, true, StorePartialEpi>;
  VT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kGmSmemBytes));
  const dim3 grid(cdiv(N, kGmBN), cdiv(M, kGmBM), sp.splits);
  kernel<<<grid, kGmThreads, kGmSmemBytes, stream>>>(tma_a, tma_b, M, N, K, sp.k_chunk,
                                                     StorePartialEpi{partials, M, N});
  VT_TRY(cudaGetLastError());
  const size_t n = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  sum_partials_kernel<<<blocks, 256, 0, stream>>>(partials, sp.splits, n, out);
  return cudaGetLastError();
}

// LayerNorm once per row: h[r, k] = round(((x - mean) * rstd) * scale[k] +
// bias[k]) in fp32, the value gemm.cuh's LoadLn computes on every load and
// the TPU kernels' `_ln(...).astype(dtype)`; one warp per row, the
// statistics of launch_row_stats (warp_row_stats).
template <typename TIn>
__global__ void __launch_bounds__(kRowThreads)
ln_rows_kernel(const TIn* __restrict__ x, const bf16* __restrict__ scale,
               const bf16* __restrict__ bias, bf16* __restrict__ h, int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const TIn* xr = x + (size_t)row * d;
  float mean, rstd;
  warp_row_stats(xr, d, eps, lane, mean, rstd);
  bf16* o = h + (size_t)row * d;
  for (int k = lane; k < d; k += 32) {
    const float c = to_f(xr[k]) - mean;
    o[k] = from_f<bf16>(c * rstd * to_f(scale[k]) + to_f(bias[k]));
  }
}

template <typename TIn>
inline cudaError_t launch_ln_rows(const TIn* x, const bf16* scale, const bf16* bias, bf16* h,
                                  int rows, int d, float eps, cudaStream_t stream) {
  ln_rows_kernel<TIn><<<cdiv(rows, kRowThreads / 32), kRowThreads, 0, stream>>>(
      x, scale, bias, h, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace vt
