// Matrix-unit cost probe for Hopper (sm_90a): tensor-core products in a loop.
//
// Replaces the Pallas TPU kernel make_bench.kernel of scripts/mxu_probe.py
// (the pl.pallas_call at scripts/mxu_probe.py:32).  What it computes is the
// same:
//
//     acc[M, N] (f32) = sum_{i < iters} a[(i % 8) * M : (i % 8 + 1) * M, :] @ b
//
// with a bf16 [8M, K], b bf16 [K, N], K = 128, products accumulated in f32.
// The 8 panels rotate, so no product can be hoisted out of the loop, and the
// loop runs inside the kernel, as the TPU kernel's fori_loop does: one
// launch per probe.
//
// Design.  bf16 mma.sync.aligned.m16n8k16 with f32 accumulators.  One CTA
// per 64-column tile of N (N = 768 gives 12 CTAs on 12 of the card's 132
// SMs), 8 warps a CTA, warp w owning the 8 columns [8w, 8w + 8) of the tile
// for all M rows.
//   * b is constant, so each warp holds its [K, 8] slice as mma B fragments
//     in registers for the whole run (16 registers a thread).
//   * Each iteration's a panel [M, K] is staged from L2 into shared memory
//     with cp.async, double-buffered (the panel of iteration i + 1 loads while
//     iteration i computes).  Rows are padded to 272 bytes, so the 32-bit
//     fragment loads of a warp hit 32 distinct banks.
//   * M is padded to whole 16-row mma tiles inside the kernel: the padding
//     rows of the panel buffers stay zero and are never stored.  M = 8 thus
//     costs a 16-row product; that granularity is what the probe measures.
//   * The accumulators of one warp are ceil(M/16) tiles of 4 floats a
//     thread: 64 registers at M = 256.
//   * Each iteration's product is formed in a fresh mma accumulator (8
//     chained k-steps) and then added to acc in f32, as the TPU kernel adds
//     each dot to acc.  The tensor core's accumulator does not round to
//     nearest: chaining all iters * 8 steps into acc let its error grow with
//     iters (on an H100 at iters = 64 and random operands: ~9e-6 of max|acc|
//     chained, 3e-7 to 5e-7 with a float32 add per iteration).
//
// Bound: at small M, the panel load and the two barriers of each iteration;
// at large M, shared-memory reads of the panel, since every warp reads the
// whole panel each iteration (8 panels' worth of reads for one panel of
// products), well before tensor-core issue.  The rate the probe reports is
// that of the 12 SMs the grid occupies; divide by 12 for one SM.
//
// wgmma (64-row tiles, asynchronous) is not used here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;                 // depth of every product
constexpr int kTileN = 64;              // columns of N per CTA
constexpr int kWarps = kTileN / 8;      // one warp per 8-column mma tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRowBytes = kK * 2 + 16;  // padded panel row (bank-conflict free)
constexpr int kMaxM = 256;
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// stage rows [p*M, p*M + M) of a into a panel buffer: M * K * 2 bytes in
// 16-byte pieces, K * 2 / 16 = 16 pieces a row
__device__ __forceinline__ void stage_panel(char* buf, const __nv_bfloat16* a, int p, int M) {
  const char* src = reinterpret_cast<const char*>(a + (long)p * M * kK);
  const int pieces = M * (kK * 2 / 16);
  for (int q = threadIdx.x; q < pieces; q += kThreads) {
    const int r = q >> 4, c = q & 15;
    cp_async16(buf + r * kRowBytes + c * 16, src + (long)r * kK * 2 + c * 16);
  }
}

// MT: 16-row mma tiles covering M (M <= 16 * MT)
template <int MT>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
             float* __restrict__ out, int M, int N, int iters) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kPanelBytes = 16 * MT * kRowBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int col = blockIdx.x * kTileN + warp * 8 + g;  // this thread's B column

  // zero both buffers once: the rows >= M are the padding of the last tile
  for (int i = threadIdx.x * 4; i < 2 * kPanelBytes; i += kThreads * 4)
    *reinterpret_cast<uint32_t*>(smem + i) = 0u;
  __syncthreads();

  // B fragments of this warp's 8 columns, all K: b0 = B[2t, 2t+1][col],
  // b1 = B[2t+8, 2t+9][col] for each 16-deep step
  uint32_t bf[kK / 16][2];
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks) {
    const int k0 = ks * 16 + 2 * t;
    bf[ks][0] = pack_bf16(b[(long)k0 * N + col], b[(long)(k0 + 1) * N + col]);
    bf[ks][1] = pack_bf16(b[(long)(k0 + 8) * N + col], b[(long)(k0 + 9) * N + col]);
  }

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  stage_panel(smem, a, 0, M);
  cp_async_commit();
  for (int i = 0; i < iters; ++i) {
    if (i + 1 < iters) {
      stage_panel(smem + ((i + 1) & 1) * kPanelBytes, a, (i + 1) & 7, M);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const char* panel = smem + (i & 1) * kPanelBytes;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const char* r0 = panel + (16 * m + g) * kRowBytes;
      const char* r8 = r0 + 8 * kRowBytes;
      float prod[4] = {0.f, 0.f, 0.f, 0.f};  // this iteration's product
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        const int c0 = (ks * 16 + 2 * t) * 2;  // byte offset of A[row][2t]
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(r0 + c0);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(r8 + c0);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(r0 + c0 + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(r8 + c0 + 16);
        mma_bf16(prod, a0, a1, a2, a3, bf[ks][0], bf[ks][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] += prod[e];
    }
    __syncthreads();  // the buffer just read is staged into next iteration
  }

  // C fragment: c0, c1 = C[g][2t, 2t+1]; c2, c3 = C[g+8][2t, 2t+1]
  const int c = blockIdx.x * kTileN + warp * 8 + 2 * t;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = 16 * m + g;
    if (r < M) {
      out[(long)r * N + c] = acc[m][0];
      out[(long)r * N + c + 1] = acc[m][1];
    }
    if (r + 8 < M) {
      out[(long)(r + 8) * N + c] = acc[m][2];
      out[(long)(r + 8) * N + c + 1] = acc[m][3];
    }
  }
}

template <int MT>
cudaError_t launch(const void* a, const void* b, void* out, int M, int N, int iters,
                   cudaStream_t stream) {
  auto kernel = probe_kernel<MT>;
  const int bytes = 2 * 16 * MT * kRowBytes;
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<N / kTileN, kThreads, bytes, stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)out, M, N, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: bf16 [8M, 128]; b: bf16 [128, N]; out: f32 [M, N]; N a multiple of 64,
// 1 <= M <= 256, iters >= 1.  Returns the launch's cudaError_t.
int ns_mxu_probe(const void* a, const void* b, void* out, int M, int N, int iters,
                 void* stream) {
  if (M < 1 || M > kMaxM || N < kTileN || N % kTileN != 0 || iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((M + 15) / 16) {
#define NS_MT(n) \
  case n:        \
    return (int)launch<n>(a, b, out, M, N, iters, st);
    NS_MT(1) NS_MT(2) NS_MT(3) NS_MT(4) NS_MT(5) NS_MT(6) NS_MT(7) NS_MT(8)
    NS_MT(9) NS_MT(10) NS_MT(11) NS_MT(12) NS_MT(13) NS_MT(14) NS_MT(15) NS_MT(16)
#undef NS_MT
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
