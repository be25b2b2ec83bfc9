// Matrix-unit cost probe for Hopper (sm_90a): tensor-core products in a loop.
//
// Replaces the Pallas TPU kernel make_bench.kernel of scripts/mxu_probe.py
// (the pl.pallas_call at scripts/mxu_probe.py:32).  What it computes is the
// same:
//
//     acc[M, N] (f32) = sum_{i < iters} a[(i % 8) * M : (i % 8 + 1) * M, :] @ b
//
// with a bf16 [8M, K], b bf16 [K, N], K = 128, products accumulated in f32.
// The 8 panels rotate, so no product can be hoisted out of the loop and no
// two products may be folded into one (sum_i a_(i%8) is algebra the probe
// must not use): every product is issued to the tensor cores.
//
// Bound: operations.  2 M K N iters flops over the card's 989 TFLOP/s of
// dense bf16 (3.3 us at M 256, 64 products); the operands are 0.4 MB.
//
// Design: wgmma across the whole card.
//   * The grid is (64-row tiles of M) x (128-column tiles of N) x G groups of
//     iterations.  Group g runs iterations [g*iters/G, (g+1)*iters/G) in
//     order; the launcher (the wrapper) picks G so that tiles x G is about the
//     card's SM count, and G <= iters.
//   * A CTA is two consumer warpgroups and one producer warp.  Warpgroup w
//     owns columns [64w, 64w + 64) of the tile and issues
//     wgmma.mma_async.m64n64k16.f32.bf16.bf16 with both operands read from
//     shared memory through matrix descriptors, 128-byte swizzle, K-major.
//   * b is staged once per CTA: it is [K, N] with N contiguous, so each
//     thread reads 8 columns of one k with a 16-byte load and writes them
//     transposed into the K-major, 128-byte-swizzled layout wgmma reads
//     (transpose flags are not used).
//   * Panels stream in through TMA (cp.async.bulk.tensor.3d over a map of a
//     as [8 panels, M rows, K]) into a ring of kStages shared-memory stages
//     on full/empty mbarriers, fed by one thread of the producer warp.  A
//     tile's rows >= M lie outside the map's M extent: TMA fills them with
//     zeros, and they are never stored.  So M 8..64 costs one 64-row tile,
//     the granularity the probe measures.
//   * Each product is formed in a fresh accumulator (scale-d 0 on its first
//     k-step) and then added to the group's running sum in f32: the tensor
//     core's accumulator does not round to nearest, and chaining all
//     products into it let its error grow with iters (~1e-5 of max|acc| at
//     64 products on an H100, against 3e-7 to 5e-7 with an f32 add a
//     product).
//   * The groups' partial sums [G, M, N] go to scratch and a second kernel
//     of the same C call sums them in group order, so the result does not
//     depend on the schedule (at G = 1 that pass is a copy).
//
// The time a probe reports is the whole card's, per product; divide by the
// CTAs for one SM's.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;                   // depth of every product
constexpr int kTileM = 64;                // rows of a wgmma tile
constexpr int kTileN = 128;               // columns of N per CTA
constexpr int kWgN = 64;                  // columns per consumer warpgroup
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = kConsumers + 32; // and the producer warp
constexpr int kStages = 4;                // TMA ring depth
constexpr int kBoxK = 64;                 // 128 bytes of bf16: one swizzle row
constexpr int kStageBytes = kTileM * kK * 2;       // 16 KB: one panel tile
constexpr int kBBytes = kTileN * kK * 2;           // 32 KB: b's tile
constexpr int kSmemBytes = kStages * kStageBytes + kBBytes + 1024;  // + alignment
constexpr int kMaxM = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA: a [64 rows, 64 k] box of panel p, 128-byte swizzled ----------------
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int k0, int row0, int panel) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0), "r"(panel)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------------
// Matrix descriptor of a K-major operand in 128-byte-swizzled shared memory:
// rows of 128 bytes (64 bf16 of K), 8-row atoms 1024 bytes apart (SBO), the
// atoms 1024-byte aligned (base offset 0); LBO is unused in this mode.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]; scale_d 0: d = A B
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the probe --------------------------------------------------------------
// grid (m_tiles * n_tiles, G); out: [G, M, N] partial sums
__global__ void __launch_bounds__(kThreads, 1)
probe_kernel(const __grid_constant__ CUtensorMap a_map, const __nv_bfloat16* __restrict__ b,
             float* __restrict__ out, int M, int N, int iters) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t b_tile = base + kStages * kStageBytes;
  unsigned char* b_ptr = smem_raw + (b_tile - smem_addr(smem_raw));

  const int n_tiles = N / kTileN;
  const int mt = blockIdx.x / n_tiles, nt = blockIdx.x % n_tiles;
  const int g = blockIdx.y, G = gridDim.y;
  const int first = (int)((long)g * iters / G), last = (int)((long)(g + 1) * iters / G);
  const int count = last - first;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // b's tile, K-major and swizzled: element (n, k) of K-block k / 64 at byte
  // n*128 + ((k%64 / 8) ^ (n % 8))*16 + (k % 8)*2; lanes run over k
  for (int q = tid; q < kK * (kTileN / 8); q += kThreads) {
    const int k = q % kK, n8 = q / kK;
    const uint4 v = *reinterpret_cast<const uint4*>(b + (long)k * N + nt * kTileN + n8 * 8);
    const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
    const int kk = k % kBoxK;
    unsigned char* blk = b_ptr + (k / kBoxK) * (kTileN * 128);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n8 * 8 + j;
      *reinterpret_cast<uint16_t*>(blk + n * 128 + (((kk >> 3) ^ (n & 7)) << 4) +
                                   (kk & 7) * 2) = e[j];
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // b: for wgmma
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int i = 0; i < count; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(smem_addr(&empty[s]), ((i / kStages) - 1) & 1);
        const uint32_t bar = smem_addr(&full[s]);
        mbar_expect_tx(bar, kStageBytes);
        const uint32_t dst = base + s * kStageBytes;
        const int panel = (first + i) % 8;
        tma_load_3d(dst, &a_map, bar, 0, mt * kTileM, panel);
        tma_load_3d(dst + kStageBytes / 2, &a_map, bar, kBoxK, mt * kTileM, panel);
      }
    }
    return;
  }

  // the consumers: warpgroup wg, columns [64 wg, 64 wg + 64) of the tile
  const int wg = tid / 128;
  const uint32_t b_wg = b_tile + wg * kWgN * 128;  // its 64 n-rows in each K-block
  float sum[32], prod[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) sum[r] = prod[r] = 0.f;
  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    mbar_wait(smem_addr(&full[s]), (i / kStages) & 1);
    __syncwarp();
    const uint32_t a_st = base + s * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      // K-block ks / 4; 16 k (32 bytes) further along the swizzled row each step
      const uint32_t off = (ks % 4) * 32;
      const uint64_t da = sw128_desc(a_st + (ks / 4) * (kStageBytes / 2) + off);
      const uint64_t db = sw128_desc(b_wg + (ks / 4) * (kTileN * 128) + off);
      wgmma_m64n64k16(prod, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(smem_addr(&empty[s]));
#pragma unroll
    for (int r = 0; r < 32; ++r) sum[r] += prod[r];
  }

  // accumulator fragment: register 4j + {0, 1} is (row, col + {0, 1}),
  // 4j + {2, 3} is (row + 8, ...), row = 16 * warp + lane / 4,
  // col = 8 j + 2 (lane % 4), within the warpgroup's 64 x 64 tile
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row = mt * kTileM + warp * 16 + lane / 4;
  float* dst = out + ((long)g * M) * N + nt * kTileN + wg * kWgN + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (row < M)
      *reinterpret_cast<float2*>(dst + (long)row * N + 8 * j) =
          make_float2(sum[4 * j], sum[4 * j + 1]);
    if (row + 8 < M)
      *reinterpret_cast<float2*>(dst + (long)(row + 8) * N + 8 * j) =
          make_float2(sum[4 * j + 2], sum[4 * j + 3]);
  }
}

// out[e] = sum_g part[g][e], g in order; four entries a thread
__global__ void __launch_bounds__(256)
reduce_groups(const float4* __restrict__ part, float4* __restrict__ out, int G, long n4) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g) {
    const float4 v = part[(long)g * n4 + e];
    acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
  }
  out[e] = acc;
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

constexpr int kMaxDevices = 64;

}  // namespace

extern "C" {

// a: bf16 [8M, 128]; b: bf16 [128, N]; out: f32 [M, N]; partial: f32
// [groups, M, N] scratch; N a multiple of 128,
// 1 <= M <= 256, 1 <= groups <= iters.  Returns 0 or a cudaError_t value.
int ns_mxu_probe(const void* a, const void* b, void* out, void* partial, int M, int N,
                 int iters, int groups, void* stream) {
  if (M < 1 || M > kMaxM || N < kTileN || N % kTileN != 0 || iters < 1 || groups < 1 ||
      groups > iters || (uintptr_t)a % 16 != 0 || (uintptr_t)b % 16 != 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // a as [8 panels][M rows][K]: a tile's rows past M are out of bounds (zeros)
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)kK, (cuuint64_t)M, 8};
  const cuuint64_t strides[2] = {(cuuint64_t)kK * 2, (cuuint64_t)M * kK * 2};
  const cuuint32_t box[3] = {kBoxK, kTileM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(a), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static bool allowed[kMaxDevices] = {};
  if (dev >= kMaxDevices || !allowed[dev]) {
    e = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(((M + kTileM - 1) / kTileM) * (N / kTileN), groups);
  probe_kernel<<<grid, kThreads, kSmemBytes, st>>>(map, (const __nv_bfloat16*)b,
                                                   (float*)partial, M, N, iters);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long n4 = (long)M * N / 4;
  reduce_groups<<<(int)((n4 + 255) / 256), 256, 0, st>>>((const float4*)partial, (float4*)out,
                                                          groups, n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
