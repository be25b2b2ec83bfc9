// Windowed matrix-free operator kernels for Hopper (sm_90a).
//
// These replace the Pallas TPU kernels of navier_stokes_tpu/ops/windowed.py:
//
//   K1  ns_matvec, spaces vp->vp    <- _pallas_run(mode="matvec")   (windowed_matvec)
//   K2  ns_matvec, v->v, v->p, p->p <- _pallas_block                (windowed_matvec_block)
//   K3  ns_gather                   <- _pallas_run(mode="gather")   (windowed_gather,
//                                                                    windowed_gather_pair)
//   K4  ns_scatter                  <- _pallas_run(mode="scatter")  (windowed_scatter)
//
// What they compute (unchanged from the TPU kernels): the layout puts every
// cell in exactly one home block b of nb blocks, in slot s = b*Bmax + j,
// cells on the last (fastest) axis; a block's slots are cut into nchunks
// chunks of Bc.  Block b's WINDOW is the (2h+1)*OW range of a space's planar
// vector around the block's owned range [b*OW, (b+1)*OW): window position pos
// of block b is global index (b - h)*OW + pos of the space, zero outside the
// vector.  All of chunk c's positions lie in the SUBWINDOW of RV*128 entries
// that starts at offs[b, c]*128.
//
// Positions come from ONE packed table per space, pos[nb, k, Bmax]: the
// absolute window position of local dof l of slot (b, j), 16 bits wide where
// the windows allow it, with a sentinel for padded slots.  The wrapper derives
// it once per layout from the TPU-shaped (hi, lo, offs) tables, which no
// kernel reads.  cnt[b] is one past block b's last occupied slot; the layout
// sorts padded slots last, so slots j >= cnt[b] need no work and no bytes.
//
// Bound: bytes, for all four.  The matvec does 2 flops per value of A, far
// below the card's ~20 float32 flops per byte.  At the 102,400-cell channel
// (nb 229, Bmax 768, Bc 256, ncd 175,872, bf16 A, 3.35 TB/s), counting the
// occupied slots' columns of the used rows of A, the packed tables and the
// vectors, each once:
//   K1       15x15 values a cell: 46 MB in occupied slots (79 MB over all
//            slots)                                         ~15 us (~25 us)
//   K2 v->v  12x12: 29 MB (51 MB)                           ~10 us (~16 us)
//   K2 v->p  12x3: 7 MB (13 MB);  p->p 3x3: 1.8 MB (3.2 MB)  ~3 us, ~1 us
//   K3, K4   a [16, ncd] float32 array, the tables, a vector: ~4-5 us
//   K3 pair  two vectors and two arrays, the tables once: 30 MB, ~9 us
//
// What the matvec's design does about it:
//   * One CUDA block per (layout block, chunk), one thread per slot, chunks
//     of all blocks in one grid, the full chunks first: the grid does not
//     depend on nb and the light chunks fill the tail.  Chunks without an
//     occupied slot end at once and write nothing.
//   * A never passes through registers on its way in.  Every thread streams
//     its share of the chunk's part of A, one input column (n_out rows of Bc
//     values) a stage, through a ring of shared-memory stages with 16-byte
//     cp.async copies in commit groups; only the occupied slots' bytes and
//     only the used rows are copied.  (1-D cp.async.bulk row copies that
//     complete on an mbarrier were measured first and ran at the same speed:
//     the copy engine is not what holds the kernel back.)
//   * The chunk's subwindow of x is copied to shared memory once, with
//     cp.async too, so no thread waits on a load while the first columns of A
//     are on their way; the 15 gathers a slot hit shared memory; the same
//     buffer then becomes the chunk's output subwindow, summed in the fixed
//     colour order described below.
//   * A block's phases (tables and x in, the stream of A, the sums, the
//     subwindow out) run one after another, so what keeps the memory system
//     busy is the number of blocks resident on an SM and the columns each
//     has in flight.  Shared memory decides both, so the ring has two stages
//     of its own and, while A streams, runs on into the buffer that holds x
//     before and the output subwindow after (idle in between): 7 columns
//     deep at the channel's shapes with bf16 A, at 4 resident blocks.
//   * Each chunk writes its subwindow to scratch; a second kernel, launched
//     by the same C call, sums for every owned row the chunk subwindows of
//     the 2h+1 windows that cover it, chunks in order within a window and
//     windows in the order of _combine_windows, and writes the final vector.
//
// K3 (the gather) writes every entry of its output, padding included, so its
// bytes are the output's; what it can cut is work and latency.  It has the
// matvec's grid: one CUDA block per (layout block, chunk), a thread per
// slot.  A chunk with no occupied slot writes its zero columns as float4s
// and reads no table; a slot at or past cnt[b] writes zeros and reads
// nothing.  An occupied slot loads its 9 packed positions, then starts all
// of its x loads (15 a vector) through the read-only path, then stores its
// column, so each of the three phases is a set of independent memory
// operations instead of a table -> x -> store chain per value.  One launch
// gathers one vector or two (u and u_old of an assembly): the pair reads
// the tables once.  (A variant that first copied each chunk's spans of x
// into shared memory with cp.async, then gathered from there, was measured
// on the same build and was slower; PERF.md has the times.)
//
// K4 (the scatter) has the matvec's grid and its tail: one CUDA block per
// (layout block, chunk), a thread per slot, padded slots and empty chunks
// skipped; a thread loads all of its slot's rows of R (slot-contiguous, so
// the loads of a warp are coalesced) before its first sum into the
// chunk's subwindows in shared memory, and the same merge kernel sums the
// subwindows.  Its accumulators are the chunk's subwindows, not the block's
// window: ~40 KB at the channel, 5 resident blocks an SM, so all occupied
// chunks run in one wave.  A subwindow is as wide as the widest chunk needs,
// so K4 writes only the span its chunk's cells touch (~40 % of it at the
// channel) and tells the merge that span; the scratch, not R, is most of
// its bytes.
//
// Sums into a subwindow run in a fixed order, so two calls on the same
// inputs give the same bits.  The layout colours its occupied slots once, on
// the host (ops/windowed.py slot_colours): within a chunk no two slots of one
// colour touch the same window position of either space.  A chunk then sums
// in ncolors rounds: in round k the slots of colour k add their values with a
// plain += (no two of them share an address), and a barrier closes the round.
// Every entry is therefore the sum of its slots' values in colour order, the
// same on every run, and the merge sums across chunks and windows in a fixed
// order too.  Eight rounds at the 102,400-cell channel cost no measurable
// time against shared-memory atomicAdds (PERF.md).
//
// 3D (Taylor-Hood P2/P1 tetrahedra: 10 velocity and 4 pressure dofs a cell,
// 34 rows of A, nli 40).  A chunk's four component subwindows do not fit a
// block's shared memory at the sizes users run: at the 196,608-tet box
// (refine_uniform(box(8, 8, 8), 2), nb 220, Bmax 1280, Bc 256, hv = hp = 5,
// RVv 144, RVp 32) they take 3*144*128*4 + 32*128*4 = 237,568 bytes against
// the 232,448 a block may have.  So every 3D layout runs one other design
// (matvec3_kernel, scatter3_kernel; K3 is the 2D kernel instantiated for
// the tetrahedron):
//   * K1/K2 read x's values of a slot (34, 30 or 4) from device memory into
//     registers through the read-only path, as K3 does, with no subwindow of
//     x in shared memory; A streams through the same cp.async ring, which
//     has the block's shared memory to itself until the sums.
//   * K1, K2 and K4 sum their outputs one space-component at a time into
//     one component-sized buffer (RVv*128 floats, 73,728 bytes at the box):
//     dim + 1 passes (fewer for K2), each the ncolors rounds of the slot
//     colours (33-36 on tetrahedra), after which the span of the subwindow
//     that the chunk's cells touch goes to scratch, as K4 does in 2D, and
//     the merge reads the spans (merge_kernel<., true>).
//   * At most 512 threads a block (Bc <= 512), so a thread may hold 128
//     registers: x's and y's 34 values a slot live in registers.
// Bound: bytes, as in 2D.  At the box with bf16 A, counting the occupied
// slots' columns of the used rows once: K1 34x34 values a cell, 455 MB,
// ~136 us; K2 v->v 30x30, 354 MB; K3 a [40, ncd] float32 array, 45 MB.  The
// scratch the passes write and the merge reads (the spans of up to 261 MB
// of subwindows) is not in the bound.
// Everything computes in float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // the merge
constexpr int kMaxChunkThreads = 1024; // K1-K4: one thread per slot of a chunk
constexpr int kMax3dThreads = 512;     // the same in 3D: up to 128 registers a thread
constexpr int kMetaLen = 18;
constexpr int kBaseStages = 2;         // ring stages of A with shared memory of their own
constexpr int kMaxSmemBytes = 232448;  // 227 KB: a block's limit on Hopper

// error codes of the entry points besides cudaError_t values (all negative)
constexpr int kErrLayout = -1;  // not the element or the geometry built here
constexpr int kErrSmem = -2;    // a block would need more shared memory than it may use
constexpr int kErrAlign = -3;   // A (K1, K2) or X (K3) is not 16-byte aligned

struct Geo {
  int nb, Bmax, Bc, nchunks;
  int dim, k_v, k_p;
  int OWv, OWp, hv, hp, RVv, RVp;
  int n_vs, n_ps, ncd;
  int idx32;  // position tables: 0 = uint16 (sentinel 0xFFFF), 1 = int32 (sentinel -1)
  int ncolors;  // rounds of a chunk's sums: the slot colours are 0 .. ncolors - 1
};

struct Tables {
  const void* __restrict__ pos_v;  // [nb, k_v, Bmax] absolute window positions
  const void* __restrict__ pos_p;  // [nb, k_p, Bmax]
  const int* __restrict__ offs_v;  // [nb, nchunks] subwindow starts, rows of 128
  const int* __restrict__ offs_p;
  const int* __restrict__ cnt;     // [nb] one past the last occupied slot
  const uint8_t* __restrict__ colour;  // [nb, Bmax] the round of an occupied slot's sums
};

// window position of local dof l of slot (b, j), -1 for a sentinel
__device__ __forceinline__ int win_pos(const void* __restrict__ table, int k,
                                       const Geo& g, int b, int j, int l) {
  const long t = ((long)b * k + l) * g.Bmax + j;
  if (g.idx32) return ((const int*)table)[t];
  const uint16_t v = ((const uint16_t*)table)[t];
  return v == 0xFFFFu ? -1 : (int)v;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- K3: X[v, l, s] = x_v[dof_l(cell s)] for NVEC vectors; rows >= nl zero --
// X: [NVEC, nli, ncd].  The matvec's grid: blockIdx.x = c*nb + b, thread tid
// owns slot (b, c*Bc + tid) and writes its column of every row of every
// vector (a warp's stores of one row are one 128-byte line).

// the index into the space's vector of window position pos of block b, -1
// for a sentinel and for the window's zero ends
__device__ __forceinline__ int vec_index(int pos, int b, int h, int OW, int n) {
  if (pos < 0) return -1;
  const int gi = (b - h) * OW + pos;
  return (gi >= 0 && gi < n) ? gi : -1;
}

// Three phases a thread, each a set of independent memory operations: the
// slot's 9 packed positions, then every x value it copies (15 a vector)
// through the read-only path, then its stores.  Threads at or past cnt[b]
// read nothing and write zeros.
template <int DIM, int KV, int KP, int NVEC>
__global__ void __launch_bounds__(DIM == 2 ? kMaxChunkThreads : kMax3dThreads)
gather_kernel(Geo g, Tables t, const float* __restrict__ x0, const float* __restrict__ x1,
              float* __restrict__ X, int nli) {
  constexpr int NV = DIM * KV, NL = NV + KP;
  const int c = blockIdx.x / g.nb, b = blockIdx.x % g.nb;
  const int tid = threadIdx.x;
  const long s0 = (long)b * g.Bmax + (long)c * g.Bc;  // the chunk's first slot
  const int nv = min(max(t.cnt[b] - c * g.Bc, 0), g.Bc);  // occupied slots here
  if (nv == 0) {
    // no table read: the chunk's Bc columns of every row of every vector
    // (rows of X seen as [NVEC * nli, ncd]) are zero, written as float4s
    // (Bc, ncd and s0 are multiples of 32)
    const int q = g.Bc / 4;
    for (int i = tid; i < NVEC * nli * q; i += blockDim.x) {
      const int r = i / q;
      *(float4*)(X + (long)r * g.ncd + s0 + 4 * (i - r * q)) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const bool active = tid < nv;
  const int j = c * g.Bc + tid;
  int iv[KV], ip[KP];  // indices into the spaces' vectors, -1 for zero
#pragma unroll
  for (int l = 0; l < KV; ++l)
    iv[l] = vec_index(active ? win_pos(t.pos_v, KV, g, b, j, l) : -1, b, g.hv, g.OWv, g.n_vs);
#pragma unroll
  for (int l = 0; l < KP; ++l)
    ip[l] = vec_index(active ? win_pos(t.pos_p, KP, g, b, j, l) : -1, b, g.hp, g.OWp, g.n_ps);
  float val[NVEC][NL];
#pragma unroll
  for (int v = 0; v < NVEC; ++v) {
    const float* x = v == 0 ? x0 : x1;
#pragma unroll
    for (int cc = 0; cc < DIM; ++cc)
#pragma unroll
      for (int l = 0; l < KV; ++l)
        val[v][cc * KV + l] = iv[l] >= 0 ? __ldg(x + (long)cc * g.n_vs + iv[l]) : 0.f;
#pragma unroll
    for (int l = 0; l < KP; ++l)
      val[v][NV + l] = ip[l] >= 0 ? __ldg(x + (long)DIM * g.n_vs + ip[l]) : 0.f;
  }
#pragma unroll
  for (int v = 0; v < NVEC; ++v) {
    float* col = X + (long)v * nli * g.ncd + s0 + tid;
#pragma unroll
    for (int l = 0; l < NL; ++l) col[(long)l * g.ncd] = val[v][l];
    for (int l = NL; l < nli; ++l) col[(long)l * g.ncd] = 0.f;
  }
}

// ---- the ring of A: asynchronous 16-byte copies in commit groups ----------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[0, len) = src[g0, g0 + len), zero where the index falls outside
// [0, n), as asynchronous copies of the calling thread's share (no register
// waits on a load).  by4: src + g0 is 16-byte aligned and n, g0 are
// multiples of 4, so whole 16-byte pieces lie inside or outside.
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src,
                                            long g0, int len, int n, bool by4) {
  const uint32_t d = smem_addr(dst);
  if (by4) {
    for (int i = 4 * threadIdx.x; i < len; i += 4 * blockDim.x) {
      const long gi = g0 + i;
      if (gi >= 0 && gi < n) cp_async16(d + 4 * i, src + gi);
      else *(float4*)(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const long gi = g0 + i;
      if (gi >= 0 && gi < n) cp_async4(d + 4 * i, src + gi);
      else dst[i] = 0.f;
    }
  }
}

// ---- K1 / K2: y = sum_cells P_c^T A_c P_c x over the chosen spaces ---------
// A: [n_in, n_out_pad, ncd] (K1: [nl, nli, ncd]); x: the in-spaces' planar
// segment; sub_v: [DIM, nb, nchunks, RVv*128]; sub_p: [nb, nchunks, RVp*128]:
// each chunk's output subwindow, for the merge kernel.  One CUDA block per
// (chunk c, layout block b), blockIdx.x = c*nb + b; thread tid owns slot
// (b, c*Bc + tid).  Shared memory: [2 stages of N_OUT x Bc values of A | buf:
// the in-subwindows of x, at the end the out-subwindows].  Between those two
// uses buf is idle, so while A streams the ring runs on into it: STAGES
// stages in all, STAGES * stage <= 2 stages + buf.
//
// Every slot runs the loop over columns, so its body is kept short: the ring
// depth is a template argument (stage offsets and wait counts are constants)
// and every thread keeps the address of its own pieces of a column and steps
// it.
template <int DIM, int KV, int KP, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P,
          typename TA, int STAGES>
__global__ void __launch_bounds__(kMaxChunkThreads)
matvec_kernel(Geo g, Tables t, const TA* __restrict__ A, int n_out_pad,
              const float* __restrict__ x, float* __restrict__ sub_v,
              float* __restrict__ sub_p) {
  constexpr int NV = DIM * KV;
  constexpr int N_IN = (IN_V ? NV : 0) + (IN_P ? KP : 0);
  constexpr int N_OUT = (OUT_V ? NV : 0) + (OUT_P ? KP : 0);
  constexpr bool NEED_V = IN_V || OUT_V;
  constexpr bool NEED_P = IN_P || OUT_P;
  extern __shared__ __align__(128) unsigned char smem[];

  const int c = blockIdx.x / g.nb, b = blockIdx.x % g.nb;
  const int tid = threadIdx.x;
  const int nv = min(max(t.cnt[b] - c * g.Bc, 0), g.Bc);  // occupied slots here
  if (nv == 0) return;  // the merge kernel skips this chunk too
  const bool active = tid < nv;

  const uint32_t row_bytes = g.Bc * sizeof(TA);  // a stage's row
  const uint32_t stage_bytes = N_OUT * row_bytes;
  const TA* ring = (const TA*)smem;
  float* buf = (float*)(smem + kBaseStages * stage_bytes);
  const int Lv = g.RVv * 128, Lp = g.RVp * 128;
  const int in_p = IN_V ? DIM * Lv : 0;    // the p subwindow's place in buf
  const int out_p = OUT_V ? DIM * Lv : 0;

  // the stream of A: column q of this chunk (N_OUT rows of the occupied
  // slots' values) goes to ring stage q % STAGES as one commit group of
  // 16-byte copies; warp w copies rows w, w + nwarps, ..., a lane a piece
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int row_pieces = (nv * (int)sizeof(TA) + 15) / 16;
  const long row_stride = (long)g.ncd * sizeof(TA);
  const long col_stride = n_out_pad * row_stride, row_step = nwarps * row_stride;
  const uint32_t dst_step = nwarps * row_bytes;
  const uint32_t dst_first = smem_addr(smem) + warp * row_bytes + 16 * lane;
  const char* src_first = (const char*)(A + (long)b * g.Bmax + (long)c * g.Bc) +
                          warp * row_stride + 16 * lane;  // of the next column
  auto fetch = [&](int stage, bool any) {
    if (any) {
      const char* src = src_first;
      uint32_t dst = dst_first + stage * stage_bytes;
      for (int i = warp; i < N_OUT; i += nwarps, src += row_step, dst += dst_step)
        for (int k = lane, o = 0; k < row_pieces; k += 32, o += 512)
          cp_async16(dst + o, src + o);
      src_first += col_stride;
    }
    cp_commit();  // one group a column, empty past the last
  };

  // this slot's positions in the chunk's subwindows, the chunk's subwindows
  // of x -> buf (commit group 0) and the first columns of A (the ring is
  // STAGES - 1 columns ahead, two of them before buf is free): all on their
  // way at once
  const int base_v = NEED_V ? t.offs_v[b * g.nchunks + c] * 128 : 0;
  const int base_p = NEED_P ? t.offs_p[b * g.nchunks + c] * 128 : 0;
  int pv[KV], pp[KP];  // -1 for none
  const int j = c * g.Bc + tid;
  const int colour = active ? t.colour[(long)b * g.Bmax + j] : -1;
#pragma unroll
  for (int l = 0; l < KV; ++l)
    pv[l] = (NEED_V && active) ? win_pos(t.pos_v, KV, g, b, j, l) : -1;
#pragma unroll
  for (int l = 0; l < KP; ++l)
    pp[l] = (NEED_P && active) ? win_pos(t.pos_p, KP, g, b, j, l) : -1;
  if constexpr (IN_V) {
    const bool by4 = g.n_vs % 4 == 0 && (uintptr_t)x % 16 == 0;
    for (int cc = 0; cc < DIM; ++cc)
      stage_async(buf + cc * Lv, x + (long)cc * g.n_vs,
                  (long)(b - g.hv) * g.OWv + base_v, Lv, g.n_vs, by4);
  }
  if constexpr (IN_P) {
    const float* xp = x + (IN_V ? (long)DIM * g.n_vs : 0);
    const bool by4 = g.n_ps % 4 == 0 && (uintptr_t)xp % 16 == 0;
    stage_async(buf + in_p, xp, (long)(b - g.hp) * g.OWp + base_p, Lp, g.n_ps, by4);
  }
  cp_commit();
  constexpr int EARLY = STAGES - 1 < kBaseStages ? STAGES - 1 : kBaseStages;
#pragma unroll
  for (int q = 0; q < EARLY; ++q) fetch(q, q < N_IN);
  cp_wait<EARLY>();  // x has landed; the columns of A may still fly
#pragma unroll
  for (int l = 0; l < KV; ++l)
    pv[l] = (pv[l] >= base_v && pv[l] < base_v + Lv) ? pv[l] - base_v : -1;
#pragma unroll
  for (int l = 0; l < KP; ++l)
    pp[l] = (pp[l] >= base_p && pp[l] < base_p + Lp) ? pp[l] - base_p : -1;
  __syncthreads();
  float xin[N_IN];
  if constexpr (IN_V) {
#pragma unroll
    for (int cc = 0; cc < DIM; ++cc)
#pragma unroll
      for (int l = 0; l < KV; ++l)
        xin[cc * KV + l] = pv[l] >= 0 ? buf[cc * Lv + pv[l]] : 0.f;
  }
  if constexpr (IN_P) {
#pragma unroll
    for (int l = 0; l < KP; ++l)
      xin[(IN_V ? NV : 0) + l] = pp[l] >= 0 ? buf[in_p + pp[l]] : 0.f;
  }
  __syncthreads();
  // x is in registers: the ring takes buf over, STAGES - 1 columns ahead
#pragma unroll
  for (int q = EARLY; q < STAGES - 1; ++q) fetch(q, q < N_IN);

  // y_i = sum_q A[q, i, s] x_q, in f32, one column of A a ring stage
  float y[N_OUT];
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) y[i] = 0.f;
  const TA* mine = ring + tid;  // this slot's value in row 0 of stage 0
  const int stage_elems = N_OUT * g.Bc;
#pragma unroll
  for (int q = 0; q < N_IN; ++q) {
    cp_wait<STAGES - 2>();  // this thread's pieces of column q have landed
    __syncthreads();        // ... and everyone's; and column q - 1 is consumed
    fetch((q + STAGES - 1) % STAGES, q + STAGES - 1 < N_IN);
    if (active) {
      const TA* col = mine + (q % STAGES) * stage_elems;
#pragma unroll
      for (int i = 0; i < N_OUT; ++i, col += g.Bc) y[i] = fmaf(widen(*col), xin[q], y[i]);
    }
  }
  __syncthreads();  // every column is consumed: buf becomes the out-subwindows
  const int out_len = (OUT_V ? DIM * Lv : 0) + (OUT_P ? Lp : 0);
  for (int i = tid; i < out_len / 4; i += blockDim.x)
    ((float4*)buf)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // the sums in colour order: no two slots of one round share an entry
  for (int k = 0; k < g.ncolors; ++k) {
    if (colour == k) {
      if constexpr (OUT_V) {
#pragma unroll
        for (int cc = 0; cc < DIM; ++cc)
#pragma unroll
          for (int l = 0; l < KV; ++l)
            if (pv[l] >= 0) buf[cc * Lv + pv[l]] += y[cc * KV + l];
      }
      if constexpr (OUT_P) {
#pragma unroll
        for (int l = 0; l < KP; ++l)
          if (pp[l] >= 0) buf[out_p + pp[l]] += y[(OUT_V ? NV : 0) + l];
      }
    }
    __syncthreads();
  }
  // the chunk's subwindows -> scratch (Lv, Lp are multiples of 128 floats)
  if constexpr (OUT_V) {
    for (int cc = 0; cc < DIM; ++cc) {
      float4* dst = (float4*)(sub_v + (((long)cc * g.nb + b) * g.nchunks + c) * Lv);
      const float4* src = (const float4*)(buf + cc * Lv);
      for (int i = tid; i < Lv / 4; i += blockDim.x) dst[i] = src[i];
    }
  }
  if constexpr (OUT_P) {
    float4* dst = (float4*)(sub_p + ((long)b * g.nchunks + c) * Lp);
    const float4* src = (const float4*)(buf + out_p);
    for (int i = tid; i < Lp / 4; i += blockDim.x) dst[i] = src[i];
  }
}

// ---- K4: y = sum_cells P_c^T R_c for per-slot rows R [>= nl, ncd] ----------
// The matvec's grid (blockIdx.x = c*nb + b, thread tid owns slot (b, c*Bc +
// tid)) and its outputs: sub_v [DIM, nb, nchunks, RVv*128], sub_p [nb,
// nchunks, RVp*128], the chunk's subwindows, for the merge kernel.  Of each
// subwindow only the span the chunk's cells touch is written, in whole
// float4s (at the channel ~40 % of it), from the start of the chunk's piece
// of scratch; span_v / span_p [nb, nchunks, 2] get the window positions
// [start, end) it holds, and the merge reads those in place of offs.
template <int DIM, int KV, int KP>
__global__ void __launch_bounds__(kMaxChunkThreads)
scatter_kernel(Geo g, Tables t, const float* __restrict__ R,
               float* __restrict__ sub_v, float* __restrict__ sub_p,
               int* __restrict__ span_v, int* __restrict__ span_p) {
  constexpr int NV = DIM * KV;
  extern __shared__ __align__(16) float acc[];
  __shared__ int span[4];  // the chunk's least and largest positions: v, then p
  const int c = blockIdx.x / g.nb, b = blockIdx.x % g.nb;
  const int tid = threadIdx.x;
  const int nv = min(max(t.cnt[b] - c * g.Bc, 0), g.Bc);  // occupied slots here
  if (nv == 0) return;  // the merge kernel skips this chunk too
  const bool active = tid < nv;
  const int Lv = g.RVv * 128, Lp = g.RVp * 128;
  const int acc_p = DIM * Lv;
  if (tid == 0) span[0] = span[2] = 0x7FFFFFFF, span[1] = span[3] = -1;

  // this slot's rows of R and its positions in the chunk's subwindows, all
  // loads issued before the accumulators are zeroed and summed into
  float r[NV + KP];
  int pv[KV], pp[KP];  // -1 for none
  const int j = c * g.Bc + tid;
  const long s = (long)b * g.Bmax + j;
  const int colour = active ? t.colour[s] : -1;
  const int base_v = t.offs_v[b * g.nchunks + c] * 128;
  const int base_p = t.offs_p[b * g.nchunks + c] * 128;
#pragma unroll
  for (int l = 0; l < NV + KP; ++l) r[l] = active ? R[(long)l * g.ncd + s] : 0.f;
#pragma unroll
  for (int l = 0; l < KV; ++l) pv[l] = active ? win_pos(t.pos_v, KV, g, b, j, l) : -1;
#pragma unroll
  for (int l = 0; l < KP; ++l) pp[l] = active ? win_pos(t.pos_p, KP, g, b, j, l) : -1;
  for (int i = tid; i < (acc_p + Lp) / 4; i += blockDim.x)
    ((float4*)acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  int ext[4] = {0x7FFFFFFF, -1, 0x7FFFFFFF, -1};  // this slot's, as span
#pragma unroll
  for (int l = 0; l < KV; ++l) {
    pv[l] = (pv[l] >= base_v && pv[l] < base_v + Lv) ? pv[l] - base_v : -1;
    if (pv[l] >= 0) ext[0] = min(ext[0], pv[l]), ext[1] = max(ext[1], pv[l]);
  }
#pragma unroll
  for (int l = 0; l < KP; ++l) {
    pp[l] = (pp[l] >= base_p && pp[l] < base_p + Lp) ? pp[l] - base_p : -1;
    if (pp[l] >= 0) ext[2] = min(ext[2], pp[l]), ext[3] = max(ext[3], pp[l]);
  }
  __syncthreads();
  // the block's span: a warp's, then the warps' (Bc is a multiple of 32;
  // integer min and max give the same result in any order)
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    ext[k] = __reduce_min_sync(0xFFFFFFFFu, ext[k]);
    ext[k + 1] = __reduce_max_sync(0xFFFFFFFFu, ext[k + 1]);
    if (tid % 32 == 0) atomicMin(&span[k], ext[k]), atomicMax(&span[k + 1], ext[k + 1]);
  }
  // the sums in colour order: no two slots of one round share an entry
  for (int k = 0; k < g.ncolors; ++k) {
    if (colour == k) {
#pragma unroll
      for (int cc = 0; cc < DIM; ++cc)
#pragma unroll
        for (int l = 0; l < KV; ++l)
          if (pv[l] >= 0) acc[cc * Lv + pv[l]] += r[cc * KV + l];
#pragma unroll
      for (int l = 0; l < KP; ++l)
        if (pp[l] >= 0) acc[acc_p + pp[l]] += r[NV + l];
    }
    __syncthreads();
  }
  // the spans of the chunk's subwindows -> the start of its pieces of
  // scratch, in whole float4s (Lv, Lp are multiples of 128 floats); an
  // empty span is [0, 0)
  const int v0 = span[1] < 0 ? 0 : span[0] / 4, v1 = span[1] < 0 ? 0 : span[1] / 4 + 1;
  const int p0 = span[3] < 0 ? 0 : span[2] / 4, p1 = span[3] < 0 ? 0 : span[3] / 4 + 1;
  for (int cc = 0; cc < DIM; ++cc) {
    float4* dst = (float4*)(sub_v + (((long)cc * g.nb + b) * g.nchunks + c) * Lv) - v0;
    const float4* src = (const float4*)(acc + cc * Lv);
    for (int i = v0 + tid; i < v1; i += blockDim.x) dst[i] = src[i];
  }
  float4* dst = (float4*)(sub_p + ((long)b * g.nchunks + c) * Lp) - p0;
  const float4* src = (const float4*)(acc + acc_p);
  for (int i = p0 + tid; i < p1; i += blockDim.x) dst[i] = src[i];
  if (tid == 0) {
    const int k = 2 * (b * g.nchunks + c);
    span_v[k] = base_v + 4 * v0, span_v[k + 1] = base_v + 4 * v1;
    span_p[k] = base_p + 4 * p0, span_p[k + 1] = base_p + 4 * p1;
  }
}

// ---- 3D: one component's subwindow at a time (K1, K2, K4) -----------------
// One pass: zero the float4s [v0, v1) of buf, sum val[l] at pos[l] in the
// colour rounds, copy [v0, v1) to dst[v0, v1) (dst: the chunk's piece of
// scratch, moved back by v0 float4s so that its entry 0 holds float4 v0).
template <int K>
__device__ __forceinline__ void component_pass(float* buf, int v0, int v1, int ncolors,
                                               int colour, const int (&pos)[K],
                                               const float (&val)[K], float4* __restrict__ dst) {
  float4* b4 = (float4*)buf;
  for (int i = v0 + threadIdx.x; i < v1; i += blockDim.x) b4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // the sums in colour order: no two slots of one round share an entry
  for (int k = 0; k < ncolors; ++k) {
    if (colour == k) {
#pragma unroll
      for (int l = 0; l < K; ++l)
        if (pos[l] >= 0) buf[pos[l]] += val[l];
    }
    __syncthreads();
  }
  for (int i = v0 + threadIdx.x; i < v1; i += blockDim.x) dst[i] = b4[i];
  __syncthreads();  // buf is read out before the next pass zeroes it
}

// The chunk's sums of every slot's values val (the out-spaces' rows: v
// components, then p) into its subwindows, one component a pass, and the
// spans [start, end) of window positions written, for the merge.  pv, pp:
// positions in the chunk's subwindows (-1 for none).  span: shared, set to
// {INT_MAX, -1, INT_MAX, -1} by one thread before a barrier that every
// thread has passed.
template <int DIM, int KV, int KP, bool OUT_V, bool OUT_P, int N>
__device__ __forceinline__ void sum_components(
    const Geo& g, int b, int c, float* buf, int* span, int colour, const int (&pv)[KV],
    const int (&pp)[KP], const float (&val)[N], int base_v, int base_p,
    float* __restrict__ sub_v, float* __restrict__ sub_p, int* __restrict__ span_v,
    int* __restrict__ span_p) {
  constexpr int NV = DIM * KV;
  int ext[4] = {0x7FFFFFFF, -1, 0x7FFFFFFF, -1};  // this slot's, as span
  if constexpr (OUT_V) {
#pragma unroll
    for (int l = 0; l < KV; ++l)
      if (pv[l] >= 0) ext[0] = min(ext[0], pv[l]), ext[1] = max(ext[1], pv[l]);
  }
  if constexpr (OUT_P) {
#pragma unroll
    for (int l = 0; l < KP; ++l)
      if (pp[l] >= 0) ext[2] = min(ext[2], pp[l]), ext[3] = max(ext[3], pp[l]);
  }
  // the block's span: a warp's, then the warps' (integer min and max give
  // the same result in any order)
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    ext[k] = __reduce_min_sync(0xFFFFFFFFu, ext[k]);
    ext[k + 1] = __reduce_max_sync(0xFFFFFFFFu, ext[k + 1]);
    if (threadIdx.x % 32 == 0) atomicMin(&span[k], ext[k]), atomicMax(&span[k + 1], ext[k + 1]);
  }
  __syncthreads();
  const long piece = (long)b * g.nchunks + c, pieces = (long)g.nb * g.nchunks;
  if constexpr (OUT_V) {
    const int Lv = g.RVv * 128;
    const int v0 = span[1] < 0 ? 0 : span[0] / 4, v1 = span[1] < 0 ? 0 : span[1] / 4 + 1;
#pragma unroll
    for (int cc = 0; cc < DIM; ++cc) {
      float v[KV];
#pragma unroll
      for (int l = 0; l < KV; ++l) v[l] = val[cc * KV + l];
      component_pass<KV>(buf, v0, v1, g.ncolors, colour, pv, v,
                         (float4*)(sub_v + (cc * pieces + piece) * Lv) - v0);
    }
    if (threadIdx.x == 0) span_v[2 * piece] = base_v + 4 * v0, span_v[2 * piece + 1] = base_v + 4 * v1;
  }
  if constexpr (OUT_P) {
    const int Lp = g.RVp * 128;
    const int p0 = span[3] < 0 ? 0 : span[2] / 4, p1 = span[3] < 0 ? 0 : span[3] / 4 + 1;
    float v[KP];
#pragma unroll
    for (int l = 0; l < KP; ++l) v[l] = val[(OUT_V ? NV : 0) + l];
    component_pass<KP>(buf, p0, p1, g.ncolors, colour, pp, v, (float4*)(sub_p + piece * Lp) - p0);
    if (threadIdx.x == 0) span_p[2 * piece] = base_p + 4 * p0, span_p[2 * piece + 1] = base_p + 4 * p1;
  }
}

// ---- 3D K1 / K2: y = sum_cells P_c^T A_c P_c x over the chosen spaces ------
// The 2D kernel's grid, operands and ring of A; x is read into registers per
// slot (vec_index of each position), and the sums go through
// sum_components into sub_v [DIM, nb, nchunks, RVv*128] / sub_p [nb,
// nchunks, RVp*128] with span tables span_v / span_p [nb, nchunks, 2].
// Shared memory: the ring (STAGES stages of N_OUT x Bc values of A) while A
// streams, then one component's subwindow.
template <int DIM, int KV, int KP, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P,
          typename TA, int STAGES>
__global__ void __launch_bounds__(kMax3dThreads)
matvec3_kernel(Geo g, Tables t, const TA* __restrict__ A, int n_out_pad,
               const float* __restrict__ x, float* __restrict__ sub_v,
               float* __restrict__ sub_p, int* __restrict__ span_v, int* __restrict__ span_p) {
  constexpr int NV = DIM * KV;
  constexpr int N_IN = (IN_V ? NV : 0) + (IN_P ? KP : 0);
  constexpr int N_OUT = (OUT_V ? NV : 0) + (OUT_P ? KP : 0);
  constexpr bool NEED_V = IN_V || OUT_V;
  constexpr bool NEED_P = IN_P || OUT_P;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int span[4];

  const int c = blockIdx.x / g.nb, b = blockIdx.x % g.nb;
  const int tid = threadIdx.x;
  const int nv = min(max(t.cnt[b] - c * g.Bc, 0), g.Bc);  // occupied slots here
  if (nv == 0) return;  // the merge kernel skips this chunk too
  const bool active = tid < nv;
  if (tid == 0) span[0] = span[2] = 0x7FFFFFFF, span[1] = span[3] = -1;

  // the stream of A, as in matvec_kernel: column q (N_OUT rows of the
  // occupied slots' values) -> ring stage q % STAGES, one commit group
  const uint32_t row_bytes = g.Bc * sizeof(TA);
  const uint32_t stage_bytes = N_OUT * row_bytes;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int row_pieces = (nv * (int)sizeof(TA) + 15) / 16;
  const long row_stride = (long)g.ncd * sizeof(TA);
  const long col_stride = n_out_pad * row_stride, row_step = nwarps * row_stride;
  const uint32_t dst_step = nwarps * row_bytes;
  const uint32_t dst_first = smem_addr(smem) + warp * row_bytes + 16 * lane;
  const char* src_first = (const char*)(A + (long)b * g.Bmax + (long)c * g.Bc) +
                          warp * row_stride + 16 * lane;  // of the next column
  auto fetch = [&](int stage, bool any) {
    if (any) {
      const char* src = src_first;
      uint32_t dst = dst_first + stage * stage_bytes;
      for (int i = warp; i < N_OUT; i += nwarps, src += row_step, dst += dst_step)
        for (int k = lane, o = 0; k < row_pieces; k += 32, o += 512)
          cp_async16(dst + o, src + o);
      src_first += col_stride;
    }
    cp_commit();  // one group a column, empty past the last
  };
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) fetch(q, q < N_IN);

  // while the first columns fly: this slot's positions and its values of x
  const int j = c * g.Bc + tid;
  const int colour = active ? t.colour[(long)b * g.Bmax + j] : -1;
  int pv[KV], pp[KP];  // window positions, -1 for none
#pragma unroll
  for (int l = 0; l < KV; ++l)
    pv[l] = (NEED_V && active) ? win_pos(t.pos_v, KV, g, b, j, l) : -1;
#pragma unroll
  for (int l = 0; l < KP; ++l)
    pp[l] = (NEED_P && active) ? win_pos(t.pos_p, KP, g, b, j, l) : -1;
  float xin[N_IN];
  if constexpr (IN_V) {
#pragma unroll
    for (int l = 0; l < KV; ++l) {
      const int gi = vec_index(pv[l], b, g.hv, g.OWv, g.n_vs);
#pragma unroll
      for (int cc = 0; cc < DIM; ++cc)
        xin[cc * KV + l] = gi >= 0 ? __ldg(x + (long)cc * g.n_vs + gi) : 0.f;
    }
  }
  if constexpr (IN_P) {
    const float* xp = x + (IN_V ? (long)DIM * g.n_vs : 0);
#pragma unroll
    for (int l = 0; l < KP; ++l) {
      const int gi = vec_index(pp[l], b, g.hp, g.OWp, g.n_ps);
      xin[(IN_V ? NV : 0) + l] = gi >= 0 ? __ldg(xp + gi) : 0.f;
    }
  }
  // positions in the chunk's subwindows
  const int base_v = NEED_V ? t.offs_v[b * g.nchunks + c] * 128 : 0;
  const int base_p = NEED_P ? t.offs_p[b * g.nchunks + c] * 128 : 0;
#pragma unroll
  for (int l = 0; l < KV; ++l)
    pv[l] = (pv[l] >= base_v && pv[l] < base_v + g.RVv * 128) ? pv[l] - base_v : -1;
#pragma unroll
  for (int l = 0; l < KP; ++l)
    pp[l] = (pp[l] >= base_p && pp[l] < base_p + g.RVp * 128) ? pp[l] - base_p : -1;

  // y_i = sum_q A[q, i, s] x_q, in f32, one column of A a ring stage
  float y[N_OUT];
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) y[i] = 0.f;
  const TA* mine = (const TA*)smem + tid;  // this slot's value in row 0 of stage 0
  const int stage_elems = N_OUT * g.Bc;
#pragma unroll
  for (int q = 0; q < N_IN; ++q) {
    cp_wait<STAGES - 2>();  // this thread's pieces of column q have landed
    __syncthreads();        // ... and everyone's; and column q - 1 is consumed
    fetch((q + STAGES - 1) % STAGES, q + STAGES - 1 < N_IN);
    if (active) {
      const TA* col = mine + (q % STAGES) * stage_elems;
#pragma unroll
      for (int i = 0; i < N_OUT; ++i, col += g.Bc) y[i] = fmaf(widen(*col), xin[q], y[i]);
    }
  }
  __syncthreads();  // every column is consumed: the ring's memory becomes buf
  sum_components<DIM, KV, KP, OUT_V, OUT_P>(g, b, c, (float*)smem, span, colour, pv, pp, y,
                                            base_v, base_p, sub_v, sub_p, span_v, span_p);
}

// ---- 3D K4: y = sum_cells P_c^T R_c for per-slot rows R [>= nl, ncd] -------
// scatter_kernel's grid, loads and outputs (subwindow spans and their
// tables), summed through sum_components: dim + 1 passes over one
// component-sized buffer.
template <int DIM, int KV, int KP>
__global__ void __launch_bounds__(kMax3dThreads)
scatter3_kernel(Geo g, Tables t, const float* __restrict__ R,
                float* __restrict__ sub_v, float* __restrict__ sub_p,
                int* __restrict__ span_v, int* __restrict__ span_p) {
  constexpr int NV = DIM * KV;
  extern __shared__ __align__(16) float buf[];
  __shared__ int span[4];
  const int c = blockIdx.x / g.nb, b = blockIdx.x % g.nb;
  const int tid = threadIdx.x;
  const int nv = min(max(t.cnt[b] - c * g.Bc, 0), g.Bc);  // occupied slots here
  if (nv == 0) return;  // the merge kernel skips this chunk too
  const bool active = tid < nv;
  if (tid == 0) span[0] = span[2] = 0x7FFFFFFF, span[1] = span[3] = -1;

  float r[NV + KP];
  int pv[KV], pp[KP];  // -1 for none
  const int j = c * g.Bc + tid;
  const long s = (long)b * g.Bmax + j;
  const int colour = active ? t.colour[s] : -1;
  const int base_v = t.offs_v[b * g.nchunks + c] * 128;
  const int base_p = t.offs_p[b * g.nchunks + c] * 128;
#pragma unroll
  for (int l = 0; l < NV + KP; ++l) r[l] = active ? R[(long)l * g.ncd + s] : 0.f;
#pragma unroll
  for (int l = 0; l < KV; ++l) {
    const int p = active ? win_pos(t.pos_v, KV, g, b, j, l) : -1;
    pv[l] = (p >= base_v && p < base_v + g.RVv * 128) ? p - base_v : -1;
  }
#pragma unroll
  for (int l = 0; l < KP; ++l) {
    const int p = active ? win_pos(t.pos_p, KP, g, b, j, l) : -1;
    pp[l] = (p >= base_p && p < base_p + g.RVp * 128) ? p - base_p : -1;
  }
  __syncthreads();  // span is set
  sum_components<DIM, KV, KP, true, true>(g, b, c, buf, span, colour, pv, pp, r, base_v,
                                          base_p, sub_v, sub_p, span_v, span_p);
}

// ---- the merge: chunk subwindows -> the planar vector -----------------------
// One space's accumulators: sub[ncomp, nb, nsub, len].  Entry d of piece c of
// block b is window position offs[b, c]*128 + d; window position j*OW + o of
// block b is global row (b - h + j)*OW + o.  cnt/Bc: piece c of block b was
// written only if cnt[b] > c*Bc.  SPAN (K4): piece c of block b holds window
// positions [span[b, c, 0], span[b, c, 1]) from its entry 0, all others are
// zero, and offs is not read.
struct MergeSpace {
  const float* __restrict__ sub;
  const int* __restrict__ offs;
  const int* __restrict__ cnt;
  const int* __restrict__ span;
  int ncomp, nb, nsub, len, OW, h, n, Bc;
};

// the window positions [start, end) that piece c of block b holds from its
// entry 0
template <bool SPAN>
__device__ __forceinline__ int2 held(const MergeSpace& m, int b, int c) {
  if constexpr (SPAN) return *(const int2*)(m.span + 2 * (b * m.nsub + c));
  const int start = m.offs[b * m.nsub + c] * 128;
  return make_int2(start, start + m.len);
}

// row r of component comp: for j = 0..2h in turn (the order of
// _combine_windows), the entry of block b + h - j's window that covers the
// row, itself the sum of that window's pieces in order
template <bool SPAN>
__device__ __forceinline__ float merge_row(const MergeSpace& m, int comp, int r) {
  const int b = r / m.OW, o = r - b * m.OW;
  float acc = 0.f;
  for (int j = 0; j <= 2 * m.h; ++j) {
    const int bp = b + m.h - j;
    if (bp < 0 || bp >= m.nb) continue;
    const int pos = j * m.OW + o;
    const float* w = m.sub + ((long)comp * m.nb + bp) * m.nsub * m.len;
    float s = 0.f;
    const int filled = m.cnt[bp];
    for (int c = 0; c < m.nsub; ++c) {
      if (filled <= c * m.Bc) break;
      const int2 in = held<SPAN>(m, bp, c);
      if (pos >= in.x && pos < in.y) s += w[(long)c * m.len + pos - in.x];
    }
    acc += s;
  }
  return acc;
}

// The same sum for the 4 consecutive rows from r, where h <= 1, CMAX >= nsub
// and r, OW, len and n are multiples of 4, so the rows share every test.
// The loops above chain some twenty dependent loads a row; here every table
// entry is loaded without a branch from a clamped, always legal address,
// then every accumulator that counts under a predicate, so each round of
// loads is in flight together.  A term that does not count adds 0.f in its
// place; the order of the sum is unchanged.
template <int CMAX, bool SPAN>
__device__ __forceinline__ float4 merge_rows4(const MergeSpace& m, int comp, int r) {
  constexpr int JMAX = 3;
  const int b = r / m.OW, o = r - b * m.OW;
  long idx[JMAX][CMAX];
  bool ok[JMAX][CMAX];
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    const int bp = b + m.h - j;
    const bool win_ok = j <= 2 * m.h && bp >= 0 && bp < m.nb;
    const int bpc = min(max(bp, 0), m.nb - 1);
    const int filled = m.cnt[bpc];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      const int cc = min(c, m.nsub - 1);
      const int2 in = held<SPAN>(m, bpc, cc);
      const int pos = j * m.OW + o, d = pos - in.x;
      ok[j][c] = win_ok && c < m.nsub && filled > c * m.Bc && pos >= in.x && pos < in.y;
      idx[j][c] = (((long)comp * m.nb + bpc) * m.nsub + cc) * m.len + (ok[j][c] ? d : 0);
    }
  }
  float4 val[JMAX][CMAX];
#pragma unroll
  for (int j = 0; j < JMAX; ++j)
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      val[j][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok[j][c]) val[j][c] = *(const float4*)(m.sub + idx[j][c]);
    }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      s.x += val[j][c].x, s.y += val[j][c].y, s.z += val[j][c].z, s.w += val[j][c].w;
    acc.x += s.x, acc.y += s.y, acc.z += s.z, acc.w += s.w;
  }
  return acc;
}

// y = [v components (ncomp * n each), then p]; either space may be absent
// (ncomp 0).  CMAX 0: any halo, any number of pieces and any n, a row a
// thread; else 4 rows a thread.  Each space has its own call, so that it
// reads its record from the kernel's parameters (a record picked at run time
// would be copied to local memory).
template <int CMAX, bool SPAN>
__global__ void __launch_bounds__(kThreads)
merge_kernel(MergeSpace v, MergeSpace p, float* __restrict__ y) {
  constexpr int ROWS = CMAX == 0 ? 1 : 4;
  const long t = ((long)blockIdx.x * blockDim.x + threadIdx.x) * ROWS;
  const long nv = (long)v.ncomp * v.n;
  if constexpr (CMAX == 0) {
    if (t < nv)
      y[t] = merge_row<SPAN>(v, (int)(t / v.n), (int)(t % v.n));
    else if (t - nv < (long)p.ncomp * p.n)
      y[t] = merge_row<SPAN>(p, 0, (int)(t - nv));
  } else {
    if (t < nv)
      *(float4*)(y + t) = merge_rows4<CMAX, SPAN>(v, (int)(t / v.n), (int)(t % v.n));
    else if (t - nv < (long)p.ncomp * p.n)
      *(float4*)(y + t) = merge_rows4<CMAX, SPAN>(p, 0, (int)(t - nv));
  }
}

template <int CMAX, bool SPAN>
cudaError_t launch_merge_as(const MergeSpace& v, const MergeSpace& p, float* y,
                            long threads, cudaStream_t stream) {
  const int grid = (int)((threads + kThreads - 1) / kThreads);
  merge_kernel<CMAX, SPAN><<<grid, kThreads, 0, stream>>>(v, p, y);
  return cudaGetLastError();
}

// SPAN: both spaces carry their span tables (K4, and K1 / K2 in 3D), or
// neither does (K1, K2 in 2D)
template <bool SPAN>
cudaError_t launch_merge(const MergeSpace& v, const MergeSpace& p, float* y,
                         cudaStream_t stream) {
  const long total = (long)v.ncomp * v.n + (long)p.ncomp * p.n;
  const int h = max(v.ncomp ? v.h : 0, p.ncomp ? p.h : 0);
  const int nsub = max(v.ncomp ? v.nsub : 1, p.ncomp ? p.nsub : 1);
  const bool by4 = (v.ncomp == 0 || v.n % 4 == 0) && (p.ncomp == 0 || p.n % 4 == 0) &&
                   (uintptr_t)y % 16 == 0;
  if (by4 && h <= 1 && nsub == 1) return launch_merge_as<1, SPAN>(v, p, y, total / 4, stream);
  if (by4 && h <= 1 && nsub <= 4) return launch_merge_as<4, SPAN>(v, p, y, total / 4, stream);
  return launch_merge_as<0, SPAN>(v, p, y, total, stream);
}

bool load_geo(const int* meta, Geo* g) {
  if (meta[0] != kMetaLen) return false;
  const int* m = meta + 1;
  *g = Geo{m[0], m[1], m[2],  m[3],  m[4],  m[5],  m[6],  m[7], m[8],
           m[9], m[10], m[11], m[12], m[13], m[14], m[15], m[16], m[17]};
  // the instantiated elements: Taylor-Hood P2/P1 on triangles and on tetrahedra
  return (g->dim == 2 && g->k_v == 6 && g->k_p == 3) ||
         (g->dim == 3 && g->k_v == 10 && g->k_p == 4);
}

Tables make_tables(const void* pos_v, const void* pos_p, const void* offs_v,
                   const void* offs_p, const void* cnt, const void* colour) {
  return Tables{pos_v, pos_p, (const int*)offs_v, (const int*)offs_p, (const int*)cnt,
                (const uint8_t*)colour};
}

// allow `bytes` of dynamic shared memory for a kernel and prefer shared memory
// over L1 for it; asked of the CUDA runtime only when a launch needs more
// than any before it on this device (`allowed`: the caller's record for this
// kernel, one entry a device)
constexpr int kMaxDevices = 64;
template <typename K>
int set_smem(K kernel, int bytes, int* allowed) {
  if (bytes > kMaxSmemBytes) return kErrSmem;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && bytes <= allowed[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return (int)e;
}

// floats of scratch: the chunk subwindows of a matvec or of K4
long subwindow_floats(const Geo& g, bool v, bool p) {
  return (long)g.nb * g.nchunks * 128 * ((v ? g.dim * g.RVv : 0) + (p ? g.RVp : 0));
}
// and the span tables of K4 (and of K1 / K2 in 3D) after them
long span_ints(const Geo& g) { return 4L * g.nb * g.nchunks; }
int* span_tables(const Geo& g, float* scratch) {
  return (int*)(scratch + subwindow_floats(g, true, true));
}

// the ring depths the matvec kernel is compiled for
constexpr int kStageChoices[] = {2, 4, 7};

template <bool IN_V, bool IN_P, bool OUT_V, bool OUT_P, typename TA>
int launch_matvec(const Geo& g, const Tables& t, const void* A, int n_out_pad,
                  const void* x, float* scratch, float* y, cudaStream_t stream) {
  constexpr int N_OUT = (OUT_V ? 12 : 0) + (OUT_P ? 3 : 0);
  using Kernel = void (*)(Geo, Tables, const TA*, int, const float*, float*, float*);
  const Kernel kernels[] = {
      matvec_kernel<2, 6, 3, IN_V, IN_P, OUT_V, OUT_P, TA, kStageChoices[0]>,
      matvec_kernel<2, 6, 3, IN_V, IN_P, OUT_V, OUT_P, TA, kStageChoices[1]>,
      matvec_kernel<2, 6, 3, IN_V, IN_P, OUT_V, OUT_P, TA, kStageChoices[2]>};
  // A is copied in 16-byte pieces: every chunk's row of A must start on one
  if (g.Bc > kMaxChunkThreads || (g.Bc * sizeof(TA)) % 16 != 0) return kErrLayout;
  if ((uintptr_t)A % 16 != 0) return kErrAlign;
  const int Lv = g.RVv * 128, Lp = g.RVp * 128;
  const int in_len = (IN_V ? g.dim * Lv : 0) + (IN_P ? Lp : 0);
  const int out_len = (OUT_V ? g.dim * Lv : 0) + (OUT_P ? Lp : 0);
  const long buf_bytes = 4L * (in_len > out_len ? in_len : out_len);
  const long stage_bytes = (long)N_OUT * g.Bc * sizeof(TA);
  const long bytes = kBaseStages * stage_bytes + buf_bytes;
  const int threads = (g.Bc + 31) / 32 * 32;
  // the deepest ring that fits the two stages and the idle buffer
  int choice = 0;
  for (int k = 1; k < 3; ++k)
    if (kStageChoices[k] * stage_bytes <= bytes) choice = k;
  static int allowed[3][kMaxDevices] = {};  // per instantiation and depth
  int e = set_smem(kernels[choice], (int)bytes, allowed[choice]);
  if (e != 0) return e;
  float* sub_v = scratch;
  float* sub_p = scratch + subwindow_floats(g, OUT_V, false);
  kernels[choice]<<<g.nb * g.nchunks, threads, bytes, stream>>>(
      g, t, (const TA*)A, n_out_pad, (const float*)x, sub_v, sub_p);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  const MergeSpace mv{sub_v, t.offs_v, t.cnt, nullptr, OUT_V ? g.dim : 0, g.nb, g.nchunks,
                      Lv, g.OWv, g.hv, g.n_vs, g.Bc};
  const MergeSpace mp{sub_p, t.offs_p, t.cnt, nullptr, OUT_P ? 1 : 0, g.nb, g.nchunks,
                      Lp, g.OWp, g.hp, g.n_ps, g.Bc};
  return (int)launch_merge<false>(mv, mp, y, stream);
}

// 3D: tetrahedra, Taylor-Hood P2/P1 (matvec3_kernel, then the merge of spans)
template <bool IN_V, bool IN_P, bool OUT_V, bool OUT_P, typename TA>
int launch_matvec_3d(const Geo& g, const Tables& t, const void* A, int n_out_pad,
                     const void* x, float* scratch, float* y, cudaStream_t stream) {
  constexpr int KV = 10, KP = 4;
  constexpr int N_OUT = (OUT_V ? 3 * KV : 0) + (OUT_P ? KP : 0);
  using Kernel = void (*)(Geo, Tables, const TA*, int, const float*, float*, float*, int*, int*);
  const Kernel kernels[] = {
      matvec3_kernel<3, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA, kStageChoices[0]>,
      matvec3_kernel<3, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA, kStageChoices[1]>,
      matvec3_kernel<3, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA, kStageChoices[2]>};
  // A is copied in 16-byte pieces: every chunk's row of A must start on one
  if (g.Bc > kMax3dThreads || g.Bc % 32 != 0 || (g.Bc * sizeof(TA)) % 16 != 0) return kErrLayout;
  if ((uintptr_t)A % 16 != 0) return kErrAlign;
  const int Lv = g.RVv * 128, Lp = g.RVp * 128;
  const long buf_bytes = 4L * max(OUT_V ? Lv : 0, OUT_P ? Lp : 0);
  const long stage_bytes = (long)N_OUT * g.Bc * sizeof(TA);
  // the ring and the component buffer take turns in the same memory
  const long bytes = kBaseStages * stage_bytes > buf_bytes ? kBaseStages * stage_bytes : buf_bytes;
  int choice = 0;  // the deepest ring that fits
  for (int k = 1; k < 3; ++k)
    if (kStageChoices[k] * stage_bytes <= bytes) choice = k;
  static int allowed[3][kMaxDevices] = {};  // per instantiation and depth
  int e = set_smem(kernels[choice], (int)bytes, allowed[choice]);
  if (e != 0) return e;
  float* sub_v = scratch;
  float* sub_p = scratch + subwindow_floats(g, OUT_V, false);
  int* span_v = span_tables(g, scratch);
  int* span_p = span_v + 2L * g.nb * g.nchunks;
  kernels[choice]<<<g.nb * g.nchunks, g.Bc, bytes, stream>>>(
      g, t, (const TA*)A, n_out_pad, (const float*)x, sub_v, sub_p, span_v, span_p);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  const MergeSpace mv{sub_v, nullptr, t.cnt, span_v, OUT_V ? g.dim : 0, g.nb, g.nchunks,
                      Lv, g.OWv, g.hv, g.n_vs, g.Bc};
  const MergeSpace mp{sub_p, nullptr, t.cnt, span_p, OUT_P ? 1 : 0, g.nb, g.nchunks,
                      Lp, g.OWp, g.hp, g.n_ps, g.Bc};
  return (int)launch_merge<true>(mv, mp, y, stream);
}

template <bool IN_V, bool IN_P, bool OUT_V, bool OUT_P, typename TA>
int launch_matvec_any(const Geo& g, const Tables& t, const void* A, int n_out_pad,
                      const void* x, float* scratch, float* y, cudaStream_t st) {
  if (g.dim == 3)
    return launch_matvec_3d<IN_V, IN_P, OUT_V, OUT_P, TA>(g, t, A, n_out_pad, x, scratch, y, st);
  return launch_matvec<IN_V, IN_P, OUT_V, OUT_P, TA>(g, t, A, n_out_pad, x, scratch, y, st);
}

template <typename TA>
int dispatch_spaces(int in_sp, int out_sp, const Geo& g, const Tables& t,
                    const void* A, int n_out_pad, const void* x, float* scratch,
                    float* y, cudaStream_t st) {
  // spaces: 1 = velocity, 2 = pressure, 3 = both
  if (in_sp == 3 && out_sp == 3)
    return launch_matvec_any<true, true, true, true, TA>(g, t, A, n_out_pad, x, scratch, y, st);
  if (in_sp == 1 && out_sp == 1)
    return launch_matvec_any<true, false, true, false, TA>(g, t, A, n_out_pad, x, scratch, y, st);
  if (in_sp == 1 && out_sp == 2)
    return launch_matvec_any<true, false, false, true, TA>(g, t, A, n_out_pad, x, scratch, y, st);
  if (in_sp == 2 && out_sp == 2)
    return launch_matvec_any<false, true, false, true, TA>(g, t, A, n_out_pad, x, scratch, y, st);
  return (int)cudaErrorInvalidValue;
}

template <int NVEC>
int launch_gather(const Geo& g, const Tables& t, const float* x0, const float* x1, float* X,
                  int nli, cudaStream_t stream) {
  const int max_threads = g.dim == 2 ? kMaxChunkThreads : kMax3dThreads;
  if (g.Bc > max_threads || g.Bc % 32 != 0 || nli < g.dim * g.k_v + g.k_p)
    return kErrLayout;
  if ((uintptr_t)X % 16 != 0) return kErrAlign;
  if (g.dim == 3)
    gather_kernel<3, 10, 4, NVEC><<<g.nb * g.nchunks, g.Bc, 0, stream>>>(g, t, x0, x1, X, nli);
  else
    gather_kernel<2, 6, 3, NVEC><<<g.nb * g.nchunks, g.Bc, 0, stream>>>(g, t, x0, x1, X, nli);
  return (int)cudaGetLastError();
}

// K4: scatter_kernel (2D: all of a chunk's subwindows in shared memory) or
// scatter3_kernel (3D: one component's at a time), then the merge of the
// spans they wrote
int launch_scatter(const Geo& g, const Tables& t, const void* R, float* scratch,
                   float* y, cudaStream_t stream) {
  using Kernel = void (*)(Geo, Tables, const float*, float*, float*, int*, int*);
  const bool tets = g.dim == 3;
  const Kernel kernel = tets ? Kernel(scatter3_kernel<3, 10, 4>) : Kernel(scatter_kernel<2, 6, 3>);
  if (g.Bc > (tets ? kMax3dThreads : kMaxChunkThreads) || g.Bc % 32 != 0) return kErrLayout;
  const int Lv = g.RVv * 128, Lp = g.RVp * 128;
  const int bytes = 4 * (tets ? max(Lv, Lp) : g.dim * Lv + Lp);
  static int allowed[2][kMaxDevices] = {};  // per kernel
  int e = set_smem(kernel, bytes, allowed[tets]);
  if (e != 0) return e;
  float* sub_v = scratch;
  float* sub_p = scratch + subwindow_floats(g, true, false);
  int* span_v = span_tables(g, scratch);
  int* span_p = span_v + 2L * g.nb * g.nchunks;
  kernel<<<g.nb * g.nchunks, (g.Bc + 31) / 32 * 32, bytes, stream>>>(g, t, (const float*)R,
                                                                     sub_v, sub_p, span_v,
                                                                     span_p);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  const MergeSpace mv{sub_v, nullptr, t.cnt, span_v, g.dim, g.nb, g.nchunks, Lv, g.OWv, g.hv,
                      g.n_vs, g.Bc};
  const MergeSpace mp{sub_p, nullptr, t.cnt, span_p, 1, g.nb, g.nchunks, Lp, g.OWp, g.hp,
                      g.n_ps, g.Bc};
  return (int)launch_merge<true>(mv, mp, y, stream);
}

}  // namespace

extern "C" {

// Every entry point returns 0, a cudaError_t value, or one of the negative
// codes above.  The six table pointers are the packed position tables, the
// subwindow offsets, the occupied-slot counts and the slot colours of the
// layout.

// floats of scratch that ns_matvec and ns_scatter may use for this layout
long ns_scratch_floats(const int* meta) {
  Geo g;
  if (!load_geo(meta, &g)) return kErrLayout;
  return subwindow_floats(g, true, true) + span_ints(g);
}

// X [nvec, nli, ncd] = the gathers of x0 (and x1: nvec 2) in one launch: K3
int ns_gather(const int* meta, const void* pos_v, const void* pos_p,
              const void* offs_v, const void* offs_p, const void* cnt, const void* colour,
              const void* x0, const void* x1, void* X, int nvec, int nli, void* stream) {
  Geo g;
  if (!load_geo(meta, &g)) return kErrLayout;
  const Tables t = make_tables(pos_v, pos_p, offs_v, offs_p, cnt, colour);
  const cudaStream_t st = (cudaStream_t)stream;
  if (nvec == 1)
    return launch_gather<1>(g, t, (const float*)x0, (const float*)x0, (float*)X, nli, st);
  if (nvec == 2)
    return launch_gather<2>(g, t, (const float*)x0, (const float*)x1, (float*)X, nli, st);
  return (int)cudaErrorInvalidValue;
}

// y [n_u + n_ps] = sum_cells P_c^T R_c: K4, then the merge
int ns_scatter(const int* meta, const void* pos_v, const void* pos_p,
               const void* offs_v, const void* offs_p, const void* cnt, const void* colour,
               const void* R, void* scratch, void* y, void* stream) {
  Geo g;
  if (!load_geo(meta, &g)) return kErrLayout;
  return launch_scatter(g, make_tables(pos_v, pos_p, offs_v, offs_p, cnt, colour), R,
                        (float*)scratch, (float*)y, (cudaStream_t)stream);
}

// y [the out-spaces' planar segment] = A x: K1 / K2, then the merge
int ns_matvec(const int* meta, const void* pos_v, const void* pos_p,
              const void* offs_v, const void* offs_p, const void* cnt, const void* colour,
              const void* A, int a_bf16, int in_spaces, int out_spaces,
              int n_out_pad, const void* x, void* scratch, void* y, void* stream) {
  Geo g;
  if (!load_geo(meta, &g)) return kErrLayout;
  const Tables t = make_tables(pos_v, pos_p, offs_v, offs_p, cnt, colour);
  return a_bf16 ? dispatch_spaces<__nv_bfloat16>(in_spaces, out_spaces, g, t, A, n_out_pad,
                                                 x, (float*)scratch, (float*)y,
                                                 (cudaStream_t)stream)
                : dispatch_spaces<float>(in_spaces, out_spaces, g, t, A, n_out_pad, x,
                                         (float*)scratch, (float*)y, (cudaStream_t)stream);
}

}  // extern "C"
