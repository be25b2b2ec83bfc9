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
// K4 (the scatter; at P2/P1, see below for P3/P2) has the matvec's grid
// and its tail: one CUDA block per (layout block, chunk), a thread per
// slot, padded slots and empty chunks
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
// Sums into a subwindow (K1, K2 and K4 in 2D) run in a fixed order, so two
// calls on the same inputs give the same bits.  The layout colours its
// occupied slots once, on the host (ops/windowed.py slot_colours): within a
// chunk no two slots of one colour touch the same window position of either
// space.  A chunk then sums in ncolors rounds: in round k the slots of
// colour k add their values with a plain += (no two of them share an
// address), and a barrier closes the round.
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
// the 232,448 a block may have.  The chunk's cells touch far fewer of those
// positions (at most 1,392 velocity and 427 pressure ones there).  So every
// 3D layout runs other kernels (K3 is the 2D kernel instantiated for the
// tetrahedron):
//   * K1/K2 (matvec3_kernel, then merge3_kernel; replace _pallas_run(mode=
//     "matvec") and _pallas_block) work on the chunk's ENTRIES: the distinct
//     window positions its slots touch, listed on the host once per layout
//     (ops/windowed.py compact_tables).  The block copies x at its entries,
//     all components, to shared memory (18.4 KB at the box) while the first
//     columns of A fly in the 2D kernel's cp.async ring (whole, half or
//     several columns a stage, whichever lets the most blocks share an SM;
//     the copies of A ask L2 to evict them first, so that x, the tables and
//     the scratch stay there); each column reads a slot's x value through
//     the slot's 16-bit entry index.  After the last column every slot puts
//     its outputs into the ring's memory, the chunk's (slot, dof) pairs go
//     to shared memory in one coalesced copy, and after one barrier each
//     thread sums the entries it owns, each over its pairs in a host-made
//     order (slots ascending): one pass for every component, no colour
//     rounds (64 registers a thread, so 4 blocks of 256 share an SM).  Each
//     sum goes to its place in a
//     scratch vector ordered by row (8.1 MB at the box), and the merge sums
//     each row's places in order: on average 2.29 a velocity row there, the
//     row's entries by window (j = 0..2h, as _combine_windows) and chunk.
//   * K4 (scatter3_kernel, then merge3_kernel; replaces _pallas_run(mode=
//     "scatter")) is K1's output half without A: the block copies the
//     chunk's occupied columns of R's nl rows to shared memory (34.8 KB at
//     the box) with the chunk's (slot, dof) pairs after them (at most
//     10.8 KB there), and after one barrier the same per-entry sums write
//     the same row-ordered scratch, which the same merge reads.  No slot
//     colour and no subwindow: both spaces in one pass, and shared memory
//     lets 5 blocks of 256 share an SM at the box.
//   * The scratch of a 3D layout is that compact vector, dim*E_v + E_p
//     floats (8.1 MB at the box).
//   * At most 512 threads a block (Bc <= 512).
// Compact 2D P2/P1 layouts.  Along a Morton curve (renumber_blocked(order=
// "sfc")) a chunk's cells spread over most of their window, so its
// subwindows outgrow a block's shared memory (962,560 bytes at the
// 102,400-cell channel, 258,048 at the 25,600-cell one), though the chunk
// touches few distinct positions.  The host sees this from the layout alone
// (ops/windowed.py compact_layout: the span kernels' shared memory over a
// block's limit) and marks the layout (Geo.compact); its K1 and K2 then run
// matvec3_kernel<2, 6, 3> + merge3_kernel on the compact tables, and its
// K4 scatter_rows_kernel<2, 6>, as at P3/P2.  Every other triangle layout
// keeps the subwindow kernels and their bits.  K3 reads no shared memory and
// serves both.
//
// Bound: bytes, as in 2D.  At the box with bf16 A, counting the occupied
// slots' columns of the used rows once: K1 34x34 values a cell, 455 MB,
// ~136 us; K2 v->v 30x30, 354 MB; K3 a [40, ncd] float32 array, 45 MB; K4
// that array's nl rows and y, 37.5 MB.  The bound counts x and y once;
// K1/K2 also read x at every chunk's entries (8.1 MB at the box, where the
// vector is 5.1 MB) and their tables (the entry indices and lists and the
// row offsets, ~22 MB), and write and read the compact scratch (8.1 MB each
// way): 506 MB in all for K1 with bf16 A; K4 reads no entry index and no x
// (scripts/kernel_bench.py moved_bytes_compact).
//
// P3/P2 (cubic velocity, quadratic pressure): K3 and K2 v->v on
// tetrahedra are the same kernels, instantiated for 10 velocity and 6
// pressure dofs a triangle (nl 26, nli 32) and 20 and 10 a tetrahedron
// (nl 70, nli 72); each launcher picks the element's template from the
// layout (with_element).  What
// changes is the room a thread and a block need, so the element sets the
// most threads a block has (chunk_threads: 512 on P3/P2 triangles, 256 on
// P3/P2 tetrahedra, so that a thread's 26 or 70 sums stay in registers) and
// the launchers size shared memory from its widths.  The box's windows are
// wider than 16 bits can index (13 x 5,248 positions), so its packed
// position tables are int32 (Geo.idx32).
//
// K1 at P3/P2 on both elements, K2 v->v on P3/P2 triangles and K2 v->p and
// p->p on P3/P2 tetrahedra run a kernel of their own (stream_matvec_kernel,
// then merge3_kernel<true>), because the block-per-chunk kernels left half
// the card's memory rate unused there: a
// chunk's A is 26 x 26 or 70 x 70 values a slot (0.35 and 2.5 MB with bf16
// A), a column of A is 13-70 KB of shared memory, so one or two blocks fit
// an SM, each with one column in flight while it consumes another, and
// nothing in flight while it gathers x or sums; at 459 and 892 occupied
// chunks the grid ran in 1.74 and 6.8 waves.  So:
//   * compact tables on both elements (triangles too): a chunk sums its
//     slots at its entries, as in 3D.
//   * a persistent grid: the blocks that reside on the SMs at once walk the
//     host's list of occupied chunks (most occupied first), block k the
//     chunks k, k + grid, ...  A chunk's sums go to its own places in the
//     scratch, so the walk changes no bit.
//   * one producer thread streams every chunk's columns of A through a ring
//     of stages (a column, or half of one with float32 A on tetrahedra:
//     ~35 KB) with 2-D tensor copies (TMA) of tiles of NR rows by 32 slots
//     that complete on the stage's mbarrier (tiles of 64 slots, 128-byte
//     rows, gained 0.3 % and were not kept: PERF.md); the
//     consumers (a thread a slot) wait on that mbarrier and give the stage
//     back on another.  The ring runs on across chunks: the next chunk's
//     first columns fly while the consumers sum.  (1-D cp.async.bulk copies
//     of a row, 512 bytes, ran at ~14 GB/s an SM, the copy engine's cost a
//     request; 16-byte cp.asyncs from one producer warp at half that:
//     PERF.md.)
//   * the ring is as deep as shared memory allows; on triangles two blocks
//     share an SM (4 stages each with bf16 A), so that one streams while
//     the other sums a chunk; on tetrahedra one block (3 stages).
//   * a slot's x values (its nl dofs) are copied to its own column of
//     shared memory with 4-byte cp.asyncs while the previous chunk is
//     summed, so no barrier and no wait sits between chunks for them; the
//     chunk's pairs and entry offsets (uint16, tr_rel) are copied while its
//     columns stream.
//   * the slots' outputs go to shared memory a component at a time (20
//     rows on tetrahedra instead of 70), which leaves the ring its depth;
//     each entry's sum is written in entry order (coalesced, no place
//     looked up), and the merge reads a row's places through `at`.
//   * the order of every sum is matvec3_kernel's: columns q ascending
//     through fmaf, an entry's pairs with slots ascending, a row's places
//     in order.  On tetrahedra K1 and K2 give the block kernel's bits; on
//     triangles the bits of _compact_matvec_reference's order.
//   * a block product (K2) is the same kernel for its pair of spaces
//     (Streamed): x of the in-spaces only, copied once at each of the
//     chunk's entries as matvec3_kernel does, the sums and the scratch of
//     the out-spaces only, and A's used rows of a column (10 of a p->p
//     column's 16 on tetrahedra) through a 3-D tensor map.  Its columns
//     are narrow (5-10 KB), so a stage may hold two, and blocks are
//     small, so up to 4 may share an SM, each with a ring of 2 stages or
//     more (2 on the box: 3 stages of 10 KB for v->p, 7 for p->p): one
//     block's chunk streams while another gathers and sums.  K2 v->v on
//     tetrahedra keeps matvec3_kernel (see `streams`).
//
// K2 v->p and p->p on P3/P2 triangles run the narrow kernels
// (narrow_product_kernel, then narrow_merge_kernel).  Their chunks move
// only 15 and 18 KB of A (6 output rows against 20 or 6 input rows, bf16,
// Bc 256), so a chunk's serial phases took as long as A: matvec_kernel's
// x subwindows, 9 colour rounds behind barriers and whole subwindows read
// back by the span merge; the streaming kernel's records, ring and
// barriers over 1-2 chunks a block (PERF.md).  So:
//   * the product has no chunk phase: a flat grid over the slots, a thread
//     a slot from registers (positions, x through the read-only path, A
//     straight from device memory, 32 slots a warp's 64-byte piece), no
//     shared memory and no barrier, so that a slot's loads of A start at
//     once; its 6 sums go to Y [k_p, ncd] in the scratch, one coalesced
//     store a row.  Its launch bounds let 4 blocks of 256 share an SM.
//     What holds it back are its gathers of x (a warp's gather touches up
//     to 32 lines; 20 a slot for v->p).  One block a chunk that copies x
//     once at the chunk's entries into shared memory and sums the chunk's
//     entries there, with a contiguous merge, was slower in every variant
//     measured: its first barrier holds the loads of A back (PERF.md).
//   * the merge sums each pressure row's places in order, each place its
//     (slot, dof) pairs in order (slots ascending): the order of
//     _compact_matvec_reference, through a per-row list of Y indices that
//     the host flattens once from the compact tables (ops/windowed.py
//     row_list), so that a row's sum is one load of its offsets, then
//     its pairs, then Y (not row_ptr -> at -> tr_off -> tr -> Y).
//   * the merge is launched with programmatic stream serialization: its
//     blocks load their offsets and first pairs before they wait
//     (griddepcontrol.wait) for the product's stores.
// K4 on the P3/P2 elements is one kernel of its own, scatter_rows_kernel:
// no chunk, no shared memory, no barrier and no scratch.  R is laid out
// slot by slot, as the narrow products' Y is, so a thread a row of a space
// sums the row's (slot, dof) values of R through a row list that the host
// flattens once a layout from the compact tables (ops/windowed.py
// row_list; the pressure's is the narrow merge's list), a velocity row all
// its components in one walk: the order of _compact_scatter_reference, so
// tetrahedra keep scatter3_kernel's bits and triangles leave the colour
// rounds' order.  It replaced, on triangles, scatter_kernel (a chunk's
// subwindows zeroed, 9 colour rounds behind barriers, the touched spans
// written) and the span merge that read them back; on tetrahedra
// scatter3_kernel (a chunk's 70 rows of R copied to shared memory, then
// summed, then written to the scratch) and merge3_kernel.  It moves R's
// occupied values, both row lists and y: 26.0 MB at the channel, 100.3 MB
// at the box (kernel_bench moved_bytes_compact).
// Bound at P3/P2 with bf16 A (scripts/kernel_bench.py bound_bytes_of): K1
// at the channel 152.9 MB, 45.6 us, at the box 1,981.2 MB, 591.4 us; K2
// v->v / v->p / p->p at the channel 93.0 / 33.5 / 10.8 MB (27.8 / 10.0 /
// 3.2 us), v->p / p->p at the box 275.0 / 50.3 MB (82.1 / 15.0 us).
// Everything computes in float32.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;          // the merge
constexpr int kMetaLen = 19;
constexpr int kBaseStages = 2;         // ring stages of A with shared memory of their own
constexpr int kMaxSmemBytes = 232448;  // 227 KB: a block's limit on Hopper

// error codes of the entry points besides cudaError_t values (all negative)
constexpr int kErrLayout = -1;  // not the element or the geometry built here
constexpr int kErrSmem = -2;    // a block would need more shared memory than it may use
constexpr int kErrAlign = -3;   // A (K1, K2), X (K3) or 3D R (K4) is not 16-byte aligned

struct Geo {
  int nb, Bmax, Bc, nchunks;
  int dim, k_v, k_p;
  int OWv, OWp, hv, hp, RVv, RVp;
  int n_vs, n_ps, ncd;
  int idx32;  // position tables: 0 = uint16 (sentinel 0xFFFF), 1 = int32 (sentinel -1)
  int ncolors;  // rounds of a chunk's sums: the slot colours are 0 .. ncolors - 1
  int compact;  // a 2D P2/P1 layout whose chunk subwindows exceed a block's shared
                // memory: K1, K2 and K4 on the compact tables (0 on every other layout)
};

struct Tables {
  const void* __restrict__ pos_v;  // [nb, k_v, Bmax] absolute window positions
  const void* __restrict__ pos_p;  // [nb, k_p, Bmax]
  const int* __restrict__ offs_v;  // [nb, nchunks] subwindow starts, rows of 128
  const int* __restrict__ offs_p;
  const int* __restrict__ cnt;     // [nb] one past the last occupied slot
  const uint8_t* __restrict__ colour;  // [nb, Bmax] the round of an occupied slot's sums
};

// The elements the kernels are instantiated for: Taylor-Hood P2/P1 and P3/P2
// on triangles and on tetrahedra.  A launcher takes one as a template
// argument; with_element calls f(Element<...>{}) for a layout's element, and
// returns kErrLayout for an element not built here.
template <int DIM_, int KV_, int KP_>
struct Element {
  static constexpr int DIM = DIM_, KV = KV_, KP = KP_;
};

template <typename F>
int with_element(const Geo& g, F&& f) {
  if (g.dim == 2 && g.k_v == 6 && g.k_p == 3) return f(Element<2, 6, 3>{});
  if (g.dim == 2 && g.k_v == 10 && g.k_p == 6) return f(Element<2, 10, 6>{});
  if (g.dim == 3 && g.k_v == 10 && g.k_p == 4) return f(Element<3, 10, 4>{});
  if (g.dim == 3 && g.k_v == 20 && g.k_p == 10) return f(Element<3, 20, 10>{});
  return kErrLayout;
}

// The most threads a block of an element's K1-K4 may have (one thread a slot,
// so the widest chunk, Bc).  A thread keeps its slot's KV + KP positions, and
// up to dim*KV + KP inputs and as many sums, in registers; a narrower block
// leaves it more of them (65,536 an SM): 64 registers a thread for P2/P1
// triangles, 128 for P3/P2 triangles and P2/P1 tetrahedra, 255 for P3/P2
// tetrahedra (70 sums, 30 entry indices and the gather's 2 x 70 values).
__host__ __device__ constexpr int chunk_threads(int dim, int kv) {
  return dim == 2 ? (kv <= 6 ? 1024 : 512) : (kv <= 10 ? 512 : 256);
}

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
__global__ void __launch_bounds__(chunk_threads(DIM, KV))
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

// cp_async16 for data read once (the 3D matvec's A), marked to be evicted
// first from L2, so that what is read again (x, the tables, the scratch that
// the merge reads back) stays there
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async16_once(uint32_t dst, const void* src, uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "l"(policy)
               : "memory");
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
__global__ void __launch_bounds__(chunk_threads(DIM, KV))
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
__global__ void __launch_bounds__(chunk_threads(DIM, KV))
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

// ---- 3D K1 / K2: y = sum_cells P_c^T A_c P_c x over the chosen spaces ------
// One space's compact tables (ops/windowed.py compact_tables), made once per
// layout on the host.  A chunk's ENTRIES are the distinct window positions
// its slots touch; the chunks' lists lie one after another, and so do their
// entries' (slot, dof) pairs.
struct Compact {
  const int* __restrict__ off;       // [nb * nchunks + 1] a chunk's first entry
  const int* __restrict__ row;       // [E] the space's vector row of each entry
  const int* __restrict__ dst;       // [E] its place in the row-ordered scratch
  const uint16_t* __restrict__ idx;  // [nb, k, Bmax] a slot's dof's entry in its chunk
  const int* __restrict__ tr_off;    // [E + 1] an entry's first (slot, dof) pair
  const uint16_t* __restrict__ tr;   // the pairs l * Bc + j, slots j ascending
  const int* __restrict__ row_ptr;   // [n + 1] a row's first place in the scratch
  const uint16_t* __restrict__ tr_rel;  // [E] an entry's first pair counted from its chunk's
  const int* __restrict__ at;        // [E] the entry at each place of the scratch (dst's inverse)
  int E, max_e, max_pairs;           // entries in all; the most entries, pairs of a chunk
};

// entry (in its chunk's list) of local dof l of slot (b, j), -1 for none
__device__ __forceinline__ int chunk_entry(const uint16_t* __restrict__ idx, int k,
                                           const Geo& g, int b, int j, int l) {
  const uint16_t v = idx[((long)b * k + l) * g.Bmax + j];
  return v == 0xFFFFu ? -1 : (int)v;
}

// The (slot, dof) pairs of the chunk's entries [e0, e0 + ne) of one space,
// and each entry's first pair counted from the chunk's first, -> shared
// memory in coalesced copies: pairs at sh, the ne + 1 offsets after them.
// Returns the offsets' address.
__device__ __forceinline__ uint16_t* stage_pairs(const Compact& t, int e0, int ne, uint16_t* sh) {
  const int t0 = t.tr_off[e0], np = t.tr_off[e0 + ne] - t0;
  for (int i = threadIdx.x; i < np; i += blockDim.x) sh[i] = t.tr[t0 + i];
  for (int i = threadIdx.x; i <= ne; i += blockDim.x) sh[np + i] = (uint16_t)(t.tr_off[e0 + i] - t0);
  return sh + np;
}

// A chunk's sums at its ne entries, NC components of a space of K dofs: ys
// [NC * K][Bc] holds every slot's values (row cc*K + l, column j), and an
// entry's sum adds its pairs' values in order (pairs, first: stage_pairs).
// A thread takes entries tid, tid + blockDim.x, ... and writes each sum to
// its place dst[e] in the scratch out [NC][E].
template <int NC, int K>
__device__ __forceinline__ void chunk_sums(const int* __restrict__ dst, int ne,
                                           const uint16_t* pairs, const uint16_t* first,
                                           const float* ys, int Bc, float* __restrict__ out,
                                           int E) {
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const long d = dst[e];
    float s[NC];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) s[cc] = 0.f;
    const int k1 = first[e + 1];
    for (int k = first[e]; k < k1; ++k) {
      const int code = pairs[k];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) s[cc] += ys[cc * K * Bc + code];
    }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) out[cc * (long)E + d] = s[cc];
  }
}

// The 2D kernel's grid, operands and ring of A: one CUDA block per (chunk c,
// layout block b), blockIdx.x = c*nb + b, thread tid owns slot (b, c*Bc +
// tid).  A ring stage holds GROUP columns of A (SPLIT 1), or half of one
// (SPLIT 2, GROUP 1: half the shared memory a stage, so that more blocks
// fit an SM).
// Shared memory: [the ring, STAGES stages of ROWS x Bc values of A; later
// ys, N_OUT x Bc floats | the region].  While the first stages fly the block
// copies x at its entries of the in-spaces to the region (DIM rows of the
// velocity's, then the pressure's); every column then reads a slot's x
// value there through the slot's entry index.  After the last column the
// slots' outputs go to ys and the chunk's (slot, dof) pairs of the
// out-spaces to the region, and after one barrier each thread sums the
// entries it owns (chunk_sums) into the scratch: sub [DIM][cv.E] (OUT_V),
// then [cp.E] (OUT_P), in row order, for merge3_kernel.
template <int DIM, int KV, int KP, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P,
          typename TA, int STAGES, int SPLIT, int GROUP>
__global__ void __launch_bounds__(chunk_threads(DIM, KV))
matvec3_kernel(Geo g, const int* __restrict__ cnt, Compact cv, Compact cp,
               const TA* __restrict__ A, int n_out_pad, const float* __restrict__ x,
               float* __restrict__ sub) {
  static_assert((SPLIT == 1 && GROUP >= 1) || (SPLIT == 2 && GROUP == 1),
                "a stage holds whole columns or half of one");
  constexpr int NV = DIM * KV;
  constexpr int N_IN = (IN_V ? NV : 0) + (IN_P ? KP : 0);
  constexpr int N_OUT = (OUT_V ? NV : 0) + (OUT_P ? KP : 0);
  constexpr int NR = (N_OUT + SPLIT - 1) / SPLIT;  // rows of a column a stage
  constexpr int ROWS = GROUP * NR;                 // rows of A a stage
  constexpr int PIECES = SPLIT == 2 ? 2 * N_IN : (N_IN + GROUP - 1) / GROUP;  // stages a chunk
  extern __shared__ __align__(128) unsigned char smem[];

  const int c = blockIdx.x / g.nb, b = blockIdx.x % g.nb;
  const int tid = threadIdx.x;
  const int nv = min(max(cnt[b] - c * g.Bc, 0), g.Bc);  // occupied slots here
  if (nv == 0) return;  // a chunk without a cell has no entry
  const bool active = tid < nv;
  const int piece = b * g.nchunks + c;

  // the stream of A: stage p holds columns q0 = (p / SPLIT) * GROUP, ...
  // (rows [part*NR, ...) of them, part = p % SPLIT) of the occupied slots,
  // in ring stage p % STAGES, one commit group; warp w copies the stage's
  // rows w, w + nwarps, ..., a lane a piece
  const uint32_t row_bytes = g.Bc * sizeof(TA);
  const uint32_t stage_bytes = ROWS * row_bytes;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int row_pieces = (nv * (int)sizeof(TA) + 15) / 16;
  const long row_stride = (long)g.ncd * sizeof(TA);
  const long col_stride = n_out_pad * row_stride;
  const uint32_t dst_first = smem_addr(smem) + 16 * lane;
  const char* src_first = (const char*)(A + (long)b * g.Bmax + (long)c * g.Bc) + 16 * lane;
  const uint64_t once = evict_first_policy();
  auto fetch = [&](int stage, int p) {
    if (p < PIECES) {
      const int q0 = (p / SPLIT) * GROUP, part = p % SPLIT;
      const int rows = SPLIT == 2 ? (part == 1 ? N_OUT - NR : NR)
                                  : min(GROUP, N_IN - q0) * N_OUT;
      const char* src0 = src_first + q0 * col_stride + part * NR * row_stride;
      const uint32_t dst0 = dst_first + stage * stage_bytes;
      for (int i = warp; i < rows; i += nwarps) {
        const char* src = src0 + (i / NR) * col_stride + (i % NR) * row_stride;
        const uint32_t dst = dst0 + i * row_bytes;
        for (int k = lane, o = 0; k < row_pieces; k += 32, o += 512)
          cp_async16_once(dst + o, src + o, once);
      }
    }
    cp_commit();  // one group a stage, empty past the last
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) fetch(p, p);

  // while the first stages fly: the chunk's entries, this slot's entry
  // indices and x at the chunk's entries -> xs
  const int region = max((int)(STAGES * stage_bytes), N_OUT * g.Bc * 4);
  float* xs = (float*)(smem + region);
  int ev0 = 0, nev = 0, ep0 = 0, nep = 0;  // the chunk's entries [e0, e0 + ne)
  if constexpr (IN_V || OUT_V) ev0 = cv.off[piece], nev = cv.off[piece + 1] - ev0;
  if constexpr (IN_P || OUT_P) ep0 = cp.off[piece], nep = cp.off[piece + 1] - ep0;
  const int j = c * g.Bc + tid;
  int iv[KV], ip[KP];  // entries in the chunk's lists, -1 for none
#pragma unroll
  for (int l = 0; l < KV; ++l) iv[l] = (IN_V && active) ? chunk_entry(cv.idx, KV, g, b, j, l) : -1;
#pragma unroll
  for (int l = 0; l < KP; ++l) ip[l] = (IN_P && active) ? chunk_entry(cp.idx, KP, g, b, j, l) : -1;
  if constexpr (IN_V) {
    for (int e = tid; e < nev; e += blockDim.x) {
      const long r = cv.row[ev0 + e];
#pragma unroll
      for (int cc = 0; cc < DIM; ++cc) xs[cc * nev + e] = __ldg(x + cc * (long)g.n_vs + r);
    }
  }
  const int xs_p = IN_V ? DIM * nev : 0;  // the pressure's row of xs
  if constexpr (IN_P) {
    const float* xp = x + (IN_V ? DIM * (long)g.n_vs : 0);
    for (int e = tid; e < nep; e += blockDim.x) xs[xs_p + e] = __ldg(xp + cp.row[ep0 + e]);
  }
  __syncthreads();  // xs is complete

  // y_i = sum_q A[q, i, s] x_q, in f32, one stage at a time
  float y[N_OUT];
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) y[i] = 0.f;
  const TA* mine = (const TA*)smem + tid;  // this slot's value in row 0 of stage 0
  const int stage_elems = ROWS * g.Bc;
  for (int p = 0; p < PIECES; ++p) {
    cp_wait<STAGES - 2>();  // this thread's pieces of stage p have landed
    __syncthreads();        // ... and everyone's; and stage p - 1 is consumed
    fetch((p + STAGES - 1) % STAGES, p + STAGES - 1);
    if (!active) continue;
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int q = (p / SPLIT) * GROUP + u;
      if (GROUP > 1 && q >= N_IN) break;
      float xq = 0.f;
      if (IN_V && q < NV) {
        const int e = iv[q % KV];
        if (e >= 0) xq = xs[(q / KV) * nev + e];
      } else if (IN_P) {
        const int e = ip[max(q - (IN_V ? NV : 0), 0)];
        if (e >= 0) xq = xs[xs_p + e];
      }
      const TA* col = mine + (p % STAGES) * stage_elems + u * NR * g.Bc;
      if (p % SPLIT == 0) {
#pragma unroll
        for (int i = 0; i < NR; ++i, col += g.Bc) y[i] = fmaf(widen(*col), xq, y[i]);
      } else {
#pragma unroll
        for (int i = NR; i < N_OUT; ++i, col += g.Bc) y[i] = fmaf(widen(*col), xq, y[i]);
      }
    }
  }
  __syncthreads();  // the ring and xs are consumed
  float* ys = (float*)smem;
  if (active) {
#pragma unroll
    for (int i = 0; i < N_OUT; ++i) ys[i * g.Bc + tid] = y[i];
  }
  uint16_t* pairs_v = (uint16_t*)(smem + region);
  uint16_t* first_v = pairs_v;
  if constexpr (OUT_V) first_v = stage_pairs(cv, ev0, nev, pairs_v);
  uint16_t* pairs_p = OUT_V ? first_v + nev + 1 : pairs_v;
  uint16_t* first_p = pairs_p;
  if constexpr (OUT_P) first_p = stage_pairs(cp, ep0, nep, pairs_p);
  __syncthreads();
  if constexpr (OUT_V)
    chunk_sums<DIM, KV>(cv.dst + ev0, nev, pairs_v, first_v, ys, g.Bc, sub, cv.E);
  if constexpr (OUT_P)
    chunk_sums<1, KP>(cp.dst + ep0, nep, pairs_p, first_p, ys + (OUT_V ? NV : 0) * g.Bc, g.Bc,
                      sub + (OUT_V ? DIM * (long)cv.E : 0), cp.E);
}

// ---- the 3D merge: the row-ordered scratch -> the planar vector ------------
// One space: sub [ncomp][E] in row order; row r of component cc is the sum
// of sub[cc][row_ptr[r] .. row_ptr[r + 1]) in order (0 for a row no cell
// touches).
// AT: the scratch is in entry order (the streaming K1's), and place k of a
// row holds the entry at[k]
struct RowMerge {
  const float* __restrict__ sub;
  const int* __restrict__ row_ptr;
  const int* __restrict__ at;
  int ncomp, n, E;
};

template <bool AT>
__device__ __forceinline__ void merge_row3(const RowMerge& m, int r, float* __restrict__ y) {
  const int k0 = m.row_ptr[r], k1 = m.row_ptr[r + 1];
  for (int cc = 0; cc < m.ncomp; ++cc) {
    const float* s = m.sub + cc * (long)m.E;
    float acc = 0.f;
    for (int k = k0; k < k1; ++k) acc += s[AT ? m.at[k] : k];
    y[cc * (long)m.n + r] = acc;
  }
}

// y = [v components (ncomp * n each), then p]; either space may be absent
// (ncomp 0).  A thread a row of a space, all its components.  Each space
// has its own call, so that it reads its record from the kernel's
// parameters (a record picked at run time would be copied to local memory).
template <bool AT>
__global__ void __launch_bounds__(kThreads)
merge3_kernel(RowMerge v, RowMerge p, float* __restrict__ y) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long rows_v = v.ncomp ? v.n : 0;
  if (t < rows_v)
    merge_row3<AT>(v, (int)t, y);
  else if (t - rows_v < (p.ncomp ? p.n : 0))
    merge_row3<AT>(p, (int)(t - rows_v), y + (long)v.ncomp * v.n);
}

// ---- 3D K4: y = sum_cells P_c^T R_c for per-slot rows R [>= nl, ncd] -------
// matvec3_kernel's grid and its output half, R's rows in place of the
// slots' products: one CUDA block per (chunk c, layout block b), blockIdx.x =
// c*nb + b.  Shared memory: [ys, the chunk's occupied columns of R's NL rows,
// NL x Bc floats (R's row order: velocity rows cc*KV + l, then pressure rows
// NV + l, as chunk_sums reads them) | the chunk's (slot, dof) pairs and
// offsets of both spaces].  R is copied with asynchronous copies while the
// pairs are staged; after one barrier each thread sums the entries it owns
// into the scratch sub [DIM][cv.E], then [cp.E], for merge3_kernel.  R is
// 16-byte aligned (launch_scatter_3d refuses it otherwise), so its rows go in
// 16-byte pieces (a chunk's row starts on one: ncd and the chunk's first slot
// are multiples of 32).
template <int DIM, int KV, int KP>
__global__ void __launch_bounds__(chunk_threads(DIM, KV))
scatter3_kernel(Geo g, const int* __restrict__ cnt, Compact cv, Compact cp,
                const float* __restrict__ R, float* __restrict__ sub) {
  constexpr int NV = DIM * KV, NL = NV + KP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x / g.nb, b = blockIdx.x % g.nb;
  const int nv = min(max(cnt[b] - c * g.Bc, 0), g.Bc);  // occupied slots here
  if (nv == 0) return;  // a chunk without a cell has no entry
  const int piece = b * g.nchunks + c;

  // R -> ys: warp w copies rows w, w + nwarps, ..., a lane a piece; R is
  // read once, so its copies ask L2 to evict them first
  float* ys = (float*)smem;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const float* src = R + (long)b * g.Bmax + (long)c * g.Bc;
  const uint64_t once = evict_first_policy();
  const int pieces = (nv + 3) / 4;  // the last one's padded slots lie in the chunk
  for (int l = warp; l < NL; l += nwarps)
    for (int k = lane; k < pieces; k += 32)
      cp_async16_once(smem_addr(ys + l * g.Bc + 4 * k), src + (long)l * g.ncd + 4 * k, once);
  cp_commit();
  const int ev0 = cv.off[piece], nev = cv.off[piece + 1] - ev0;
  const int ep0 = cp.off[piece], nep = cp.off[piece + 1] - ep0;
  uint16_t* pairs_v = (uint16_t*)(smem + 4 * NL * g.Bc);
  uint16_t* first_v = stage_pairs(cv, ev0, nev, pairs_v);
  uint16_t* pairs_p = first_v + nev + 1;
  uint16_t* first_p = stage_pairs(cp, ep0, nep, pairs_p);
  cp_wait<0>();
  __syncthreads();  // ys and the pairs are complete
  chunk_sums<DIM, KV>(cv.dst + ev0, nev, pairs_v, first_v, ys, g.Bc, sub, cv.E);
  chunk_sums<1, KP>(cp.dst + ep0, nep, pairs_p, first_p, ys + NV * g.Bc, g.Bc,
                    sub + DIM * (long)cv.E, cp.E);
}

// ---- P3/P2 K1: the streaming compact matvec ---------------------------------
// mbarriers (shared::cta) and the tensor copies (TMA) that complete on them
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// the box of a 3-D tensor map at (x0, y0, z0) -> shared memory, completing
// on bar; read once, so evicted first from L2
__device__ __forceinline__ void tma_load_3d_once(uint32_t dst, const CUtensorMap* map,
                                                 uint32_t bar, int x0, int y0, int z0,
                                                 uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x0), "r"(y0), "r"(z0), "l"(policy)
      : "memory");
}

// a barrier of the consumer threads alone (the producer warp never joins)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// a 4-byte cp.async that reads src_bytes (2 or 4) and zero-fills the rest
__device__ __forceinline__ void cp_async4_part(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// src[start, start + count) of a uint16 table of `total` values -> shared
// memory at dst + (start & 1), in 4-byte cp.asyncs of the calling consumer
// thread's share (the table's last word, if it runs past the end, reads 2
// bytes).  Returns where the copy begins.
__device__ __forceinline__ const uint16_t* stage_u16_async(uint16_t* dst,
                                                           const uint16_t* __restrict__ src,
                                                           long start, int count, long total,
                                                           int threads) {
  const long w0 = start >> 1, w1 = (start + count + 1) >> 1;  // words [w0, w1)
  const uint32_t d = smem_addr(dst);
  for (long w = w0 + threadIdx.x; w < w1; w += threads)
    cp_async4_part(d + 4 * (uint32_t)(w - w0), src + 2 * w, 2 * w + 1 < total ? 4 : 2);
  return dst + (start & 1);
}

// A product of the streaming kernel: K1 (spaces vp->vp) or a block product
// (K2: v->v, v->p, p->p), and what its spaces fix.  A stage of the ring
// holds ROWS = G * NR rows of Bc slots: NR rows (the N_OUT used rows of a
// column, or half of them) of G columns.  K1 takes one column a stage, or
// (float32 A on tetrahedra, 70 rows of 1 KB) half of one (SPLIT 2), so
// that a stage is ~35 KB on tetrahedra and 13-26 KB on triangles.  A block
// product's column is narrow (10 or 20 rows, 5-10 KB with bf16 A at Bc
// 256), so a stage may take G columns, the most that divide N_IN and keep
// a slot's part of a stage within kStageRowBytes: with bf16 A, v->v on
// triangles one column (40 bytes a slot, 10 KB a stage), v->p and p->p on
// tetrahedra two (40 bytes, 10 KB); with float32 A one.  (Stages of 3-5
// columns, 104 bytes a slot, took as long or longer: PERF.md.)
constexpr int kStageRowBytes = 52;
__host__ __device__ constexpr int stream_group(int n_in, int n_out, int elt) {
  int best = 1;
  for (int cols = 1; cols <= n_in; ++cols)
    if (n_in % cols == 0 && cols * n_out * elt <= kStageRowBytes) best = cols;
  return best;
}

template <int DIM_, int KV_, int KP_, bool IN_V_, bool IN_P_, bool OUT_V_, bool OUT_P_,
          typename TA>
struct Streamed {
  static constexpr int DIM = DIM_, KV = KV_, KP = KP_;
  static constexpr bool IN_V = IN_V_, IN_P = IN_P_, OUT_V = OUT_V_, OUT_P = OUT_P_;
  static constexpr int NV = DIM * KV;
  static constexpr int N_IN = (IN_V ? NV : 0) + (IN_P ? KP : 0);
  static constexpr int N_OUT = (OUT_V ? NV : 0) + (OUT_P ? KP : 0);
  static constexpr bool K1 = IN_V && IN_P && OUT_V && OUT_P;
  static constexpr int SPLIT = K1 && DIM == 3 && sizeof(TA) == 4 ? 2 : 1;
  static constexpr int NR = N_OUT / SPLIT;  // rows of a column a stage
  static constexpr int G = K1 ? 1 : stream_group(N_IN, N_OUT, (int)sizeof(TA));
  static constexpr int ROWS = G * NR;                 // rows of A a stage
  static constexpr int PIECES = N_IN / G * SPLIT;     // stages a chunk
  static constexpr int KY = OUT_V ? KV : KP;          // rows of one output component
  // a block product copies x at the chunk's entries (ENTRIES) and stages
  // the next chunk's pairs while it sums this one's (two buffers of them)
  static constexpr bool ENTRIES = !K1;
  static constexpr int NBUF = ENTRIES ? 2 : 1;
  // the blocks an SM the registers must allow: 2 for the narrow products
  // on tetrahedra (at most 112 registers a thread), so that shared memory
  // sets how many share an SM; else 1 (K1, and the products on triangles,
  // whose chunks of up to 512 slots make blocks of up to 544 threads)
  static constexpr int MIN_BLOCKS = DIM == 3 && !OUT_V ? 2 : 1;
  static_assert(N_OUT % SPLIT == 0 && N_IN % G == 0, "a stage holds whole columns or half of one");
  static_assert(32 * ROWS * sizeof(TA) % 128 == 0, "a tile's shared memory starts on 128 bytes");
};

// How a block of the streaming kernel lays out its shared memory: the
// ring's mbarriers (full, then empty, kMaxStreamStages each); x: K1's
// slots' x values xsl [NL][Bc], a block product's x at the chunk's entries
// of the in-spaces xs [DIM][nev] (velocity), then [nep] (pressure), with
// the entries' rows after it (int32); one output component's values ys
// [KY][Bc]; NBUF buffers of the chunk's (slot, dof) pairs and entry
// offsets of the velocity and of the pressure where they are out-spaces
// (uint16, one spare each for the staging's alignment; pairs_v .. first_p
// are buffer 0's, buffer i lies pair_bytes * i after it); then the ring of
// `stages` stages of ROWS rows of Bc values of A.  Every offset is a
// multiple of 128 bytes.
constexpr int kMaxStreamStages = 16;
struct StreamSmem {
  int x, rows, ys, pairs_v, first_v, pairs_p, first_p, pair_bytes, ring;
};
__host__ __device__ constexpr int round128(long v) { return (int)((v + 127) / 128 * 128); }
template <typename S>
__host__ __device__ inline StreamSmem stream_smem(int Bc, const Compact& cv, const Compact& cp) {
  const long ents = (S::IN_V ? cv.max_e : 0) + (S::IN_P ? cp.max_e : 0);  // in-entries
  StreamSmem s{};
  s.x = round128(2 * 8 * kMaxStreamStages);
  s.rows = s.x + round128(S::ENTRIES ? 4L * ((S::IN_V ? S::DIM * cv.max_e : 0) +
                                             (S::IN_P ? cp.max_e : 0))
                                     : 4L * S::N_IN * Bc);
  s.ys = s.rows + (S::ENTRIES ? round128(4L * ents) : 0);
  s.pairs_v = s.ys + round128(4L * S::KY * Bc);
  s.first_v = s.pairs_v + (S::OUT_V ? round128(2L * (cv.max_pairs + 2)) : 0);
  s.pairs_p = s.first_v + (S::OUT_V ? round128(2L * (cv.max_e + 2)) : 0);
  s.first_p = s.pairs_p + (S::OUT_P ? round128(2L * (cp.max_pairs + 2)) : 0);
  s.pair_bytes = s.first_p + (S::OUT_P ? round128(2L * (cp.max_e + 2)) : 0) - s.pairs_v;
  s.ring = s.pairs_v + S::NBUF * s.pair_bytes;
  return s;
}

// A chunk of the streaming kernel's work list as the host recorded it
// (ops/windowed.py stream_records: 12 int32, read as three int4), so that
// a block reads a chunk's table offsets in one round and not through
// cnt, off and tr_off in turn.
struct WorkRec {
  int piece, nv;           // the chunk (b * nchunks + c), its occupied slots
  int ev0, nev, tv0, npv;  // velocity: first entry, entries, first (slot, dof) pair, pairs
  int ep0, nep, tp0, npp;  // pressure: the same
  int Tv, Tp;              // (slot, dof) pairs in all of each space
};
__device__ __forceinline__ WorkRec load_rec(const int4* __restrict__ recs, int w) {
  const int4 a = recs[3 * w], b = recs[3 * w + 1], c = recs[3 * w + 2];
  return WorkRec{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
}

// The chunk's (slot, dof) pairs and entry offsets of the out-spaces ->
// pairs buffer `pb` (its offset in shared memory, as L.pairs_v), in 4-byte
// cp.asyncs of the consumers (no commit)
template <bool OUT_V, bool OUT_P>
__device__ __forceinline__ void stage_chunk_pairs(unsigned char* smem, const StreamSmem& L,
                                                  int pb, const Compact& cv, const Compact& cp,
                                                  const WorkRec& r, int threads) {
  unsigned char* at = smem + pb - L.pairs_v;
  if constexpr (OUT_V) {
    stage_u16_async((uint16_t*)(at + L.pairs_v), cv.tr, r.tv0, r.npv, r.Tv, threads);
    stage_u16_async((uint16_t*)(at + L.first_v), cv.tr_rel, r.ev0, r.nev, cv.E, threads);
  }
  if constexpr (OUT_P) {
    stage_u16_async((uint16_t*)(at + L.pairs_p), cp.tr, r.tp0, r.npp, r.Tp, threads);
    stage_u16_async((uint16_t*)(at + L.first_p), cp.tr_rel, r.ep0, r.nep, cp.E, threads);
  }
}

// A block product's x at the chunk's entries of the in-spaces, in two
// rounds of 4-byte cp.asyncs of the consumers (each without a commit):
// first the entries' rows (cv.row, cp.row: one run of the tables a
// chunk, so the copies coalesce) -> `rows`; then, once every consumer's
// rows have landed, x at those rows -> xs [DIM][nev], then [nep] (the
// entries of a chunk are its sorted window positions, so neighbouring
// threads read neighbouring rows).  The pressure's x starts at 0 of the
// in-spaces' segment where it is the only in-space.
template <bool IN_V, bool IN_P>
__device__ __forceinline__ void stage_rows(int* rows, const Compact& cv, const Compact& cp,
                                           const WorkRec& r, int threads) {
  const uint32_t d = smem_addr(rows);
  if constexpr (IN_V) {
    for (int e = threadIdx.x; e < r.nev; e += threads) cp_async4(d + 4 * e, cv.row + r.ev0 + e);
  }
  if constexpr (IN_P) {
    const uint32_t dp = d + 4 * (IN_V ? r.nev : 0);
    for (int e = threadIdx.x; e < r.nep; e += threads) cp_async4(dp + 4 * e, cp.row + r.ep0 + e);
  }
}

template <int DIM, bool IN_V, bool IN_P>
__device__ __forceinline__ void stage_x(float* xs, const int* rows, const float* __restrict__ x,
                                        const Geo& g, const WorkRec& r, int threads) {
  const uint32_t d = smem_addr(xs);
  if constexpr (IN_V) {
    for (int e = threadIdx.x; e < r.nev; e += threads) {
      const long row = rows[e];
#pragma unroll
      for (int cc = 0; cc < DIM; ++cc)
        cp_async4(d + 4 * (cc * r.nev + e), x + cc * (long)g.n_vs + row);
    }
  }
  if constexpr (IN_P) {
    const float* xp = x + (IN_V ? DIM * (long)g.n_vs : 0);
    const int* rp = rows + (IN_V ? r.nev : 0);
    const uint32_t dp = d + 4 * (IN_V ? DIM * r.nev : 0);
    for (int e = threadIdx.x; e < r.nep; e += threads) cp_async4(dp + 4 * e, xp + rp[e]);
  }
}

// this slot's entries (in its chunk's lists) of the in-spaces' local dofs,
// -1 for none (a slot past the chunk's occupied ones, or no such dof)
template <int KV, int KP, bool IN_V, bool IN_P>
__device__ __forceinline__ void slot_entries(int* iv, int* ip, const Geo& g, const Compact& cv,
                                             const Compact& cp, const WorkRec& r) {
  const int b = r.piece / g.nchunks, c = r.piece - b * g.nchunks;
  const int j = c * g.Bc + threadIdx.x;
  const bool active = (int)threadIdx.x < r.nv;
  if constexpr (IN_V) {
#pragma unroll
    for (int l = 0; l < KV; ++l) iv[l] = active ? chunk_entry(cv.idx, KV, g, b, j, l) : -1;
  }
  if constexpr (IN_P) {
#pragma unroll
    for (int l = 0; l < KP; ++l) ip[l] = active ? chunk_entry(cp.idx, KP, g, b, j, l) : -1;
  }
}

// K1: this slot's x values -> its column of xsl (row q: local dof q of the
// element, velocity components then pressure), as 4-byte cp.asyncs in one
// commit group; 0 for a position off the vector.  K3's reads: the slot's
// packed positions, then every value, no register waiting on one.
template <int DIM, int KV, int KP>
__device__ __forceinline__ void gather_slot(const Geo& g, const Tables& t,
                                            const float* __restrict__ x, const WorkRec& r,
                                            float* xsl) {
  const int tid = threadIdx.x;
  const int b = r.piece / g.nchunks, c = r.piece - b * g.nchunks;
  if (tid < r.nv) {
    const int j = c * g.Bc + tid;
    int iv[KV], ip[KP];
#pragma unroll
    for (int l = 0; l < KV; ++l)
      iv[l] = vec_index(win_pos(t.pos_v, KV, g, b, j, l), b, g.hv, g.OWv, g.n_vs);
#pragma unroll
    for (int l = 0; l < KP; ++l)
      ip[l] = vec_index(win_pos(t.pos_p, KP, g, b, j, l), b, g.hp, g.OWp, g.n_ps);
    const uint32_t col = smem_addr(xsl + tid), row = 4 * g.Bc;
#pragma unroll
    for (int cc = 0; cc < DIM; ++cc)
#pragma unroll
      for (int l = 0; l < KV; ++l) {
        const int q = cc * KV + l;
        if (iv[l] >= 0) cp_async4(col + q * row, x + (long)cc * g.n_vs + iv[l]);
        else xsl[q * g.Bc + tid] = 0.f;
      }
#pragma unroll
    for (int l = 0; l < KP; ++l) {
      const int q = DIM * KV + l;
      if (ip[l] >= 0) cp_async4(col + q * row, x + (long)DIM * g.n_vs + ip[l]);
      else xsl[q * g.Bc + tid] = 0.f;
    }
  }
  cp_commit();
}

// One component's sums at a chunk's ne entries: ys [K][Bc] holds every
// slot's values of the component; entry e adds the values of its pairs
// [first[e], first[e + 1]) (the last entry's end: np) in order, from 0, and
// writes the sum to out[e] (the chunk's entries, in order).
__device__ __forceinline__ void entry_sums(int ne, const uint16_t* pairs, const uint16_t* first,
                                           int np, const float* ys, float* __restrict__ out,
                                           int threads) {
  for (int e = threadIdx.x; e < ne; e += threads) {
    const int k1 = e + 1 < ne ? first[e + 1] : np;
    float s = 0.f;
    for (int k = first[e]; k < k1; ++k) s += ys[pairs[k]];
    out[e] = s;
  }
}

// The streaming kernel on the P3/P2 elements: y = sum_cells P_c^T A_c P_c x
// over a pair of spaces (K1: vp->vp; K2: v->v, v->p, p->p) on the compact
// tables, with the sums of matvec3_kernel (and, on tetrahedra, its bits).
// A persistent grid: block k takes the chunks of records[k], records[k +
// gridDim.x], ... of the host's list of occupied chunks (ops/windowed.py
// stream_work, stream_records).  A block is Bc consumer threads, one a
// slot, and a producer warp of which one thread works.  The producer
// streams every chunk's stages of A (Streamed: ROWS rows, NR used rows of
// G columns) through a ring of `stages` stages in tensor copies of tiles
// (32 slots by NR rows by G columns, [G][NR][32] in shared memory, one
// after another) that complete on the stage's `full` mbarrier; the pad
// rows of A (n_out_pad past N_OUT) are never read.  The consumers give a
// stage back on its `empty` mbarrier (one arrival a warp).  The ring does
// not stop at a chunk's end: while the consumers sum one chunk, the next
// chunk's first stages fly.
// A consumer, per chunk: it takes the stages in turn, y_i = fmaf(A[q, i],
// x_q, y_i), q ascending; then, a component at a time, the slots' outputs
// go to ys and each consumer sums the entries it owns (entry_sums) into
// the scratch sub [DIM][cv.E] (OUT_V), then [cp.E] (OUT_P), in entry order
// (coalesced, no place to look up; sums written at their row-ordered
// places instead, as matvec3_kernel does, took longer: PERF.md),
// which merge3_kernel<true> reads a row's places at a time through the
// tables' `at`.  The next chunk's x and tables come to shared memory in
// the background:
//   * K1 (26-70 columns a chunk, whose stream hides the rest): its slot's
//     x values, gathered into its own column of xsl after the stream; the
//     pairs and entry offsets at the chunk's start.
//   * a block product (1-12 stages a chunk, which hide little): x as
//     matvec3_kernel reads it, once at each of the chunk's entries of the
//     in-spaces (xs, coalesced along the sorted entries, 2-4 times fewer
//     loads than a slot's gather: at the box 12 % off v->p's time, PERF.md)
//     and through the slot's entry indices (iv, ip: registers, the stages
//     unrolled); the next chunk's pairs (a
//     second buffer) and its entries' rows copied after the stream, its x
//     at those rows after the sums, its entry indices loaded then.
template <int DIM, int KV, int KP, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P, typename TA>
__global__ void __launch_bounds__(chunk_threads(DIM, KV) + 32,
                                  (Streamed<DIM, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA>::MIN_BLOCKS))
stream_matvec_kernel(Geo g, Tables t, Compact cv, Compact cp, const int4* __restrict__ recs,
                     int n_work, int stages, const __grid_constant__ CUtensorMap a_map,
                     const float* __restrict__ x, float* __restrict__ sub) {
  using S = Streamed<DIM, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA>;
  constexpr int NV = S::NV, N_OUT = S::N_OUT, NR = S::NR, G = S::G, ROWS = S::ROWS;
  constexpr int SPLIT = S::SPLIT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, nct = g.Bc;  // nct consumer threads, then the producer warp
  const StreamSmem L = stream_smem<S>(g.Bc, cv, cp);
  const uint32_t bars = smem_addr(smem);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kMaxStreamStages + s); };
  // this block's chunks: records[blockIdx.x + i * gridDim.x], i < mine
  const int mine = n_work > (int)blockIdx.x ? (n_work - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  auto rec_of = [&](int i) { return load_rec(recs, blockIdx.x + i * gridDim.x); };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full(s), 1), mbar_init(empty(s), nct / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t tile_bytes = 32 * ROWS * sizeof(TA), stage_bytes = (g.Bc / 32) * tile_bytes;
  const uint32_t ring = smem_addr(smem + L.ring);

  if (tid >= nct) {  // the producer: one thread streams A, chunk after chunk
    if (tid > nct) return;
    const uint64_t once = evict_first_policy();
    int stage = 0;
    uint32_t phase = 0;
    for (int ci = 0; ci < mine; ++ci) {
      const WorkRec r = rec_of(ci);  // the chunk b * nchunks + c, its occupied slots
      const int b = r.piece / g.nchunks, c = r.piece - b * g.nchunks;
      const int tiles = (r.nv + 31) / 32;
      const int x0 = b * g.Bmax + c * g.Bc;
      for (int p = 0; p < S::PIECES; ++p) {
        mbar_wait(empty(stage), phase ^ 1);  // the consumers gave the stage back
        mbar_expect_tx(full(stage), tiles * tile_bytes);
        const int y0 = (p % SPLIT) * NR, z0 = (p / SPLIT) * G;
        const uint32_t dst = ring + stage * stage_bytes;
        for (int k = 0; k < tiles; ++k)
          tma_load_3d_once(dst + k * tile_bytes, &a_map, full(stage), x0 + 32 * k, y0, z0, once);
        if (++stage == stages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  float* xsl = (float*)(smem + L.x);  // K1: the slots' x values
  float* xs = (float*)(smem + L.x);   // a block product: x at the chunk's entries
  int* rows = (int*)(smem + L.rows);  // ... and the entries' rows
  float* ys = (float*)(smem + L.ys);
  const int lane = tid % 32;
  int stage = 0, buf = 0;
  uint32_t phase = 0;
  int iv[S::ENTRIES && IN_V ? KV : 1], ip[S::ENTRIES && IN_P ? KP : 1];  // this slot's entries
  WorkRec r{};
  if (mine > 0) {
    r = rec_of(0);
    if constexpr (S::ENTRIES) {  // the first chunk's pairs and x
      stage_chunk_pairs<OUT_V, OUT_P>(smem, L, L.pairs_v, cv, cp, r, nct);
      stage_rows<IN_V, IN_P>(rows, cv, cp, r, nct);
      cp_commit();
      cp_wait<0>();
      consumers_sync(nct);
      stage_x<DIM, IN_V, IN_P>(xs, rows, x, g, r, nct);
      cp_commit();
      slot_entries<KV, KP, IN_V, IN_P>(iv, ip, g, cv, cp, r);
    } else {
      gather_slot<DIM, KV, KP>(g, t, x, r, xsl);
    }
  }
  for (int ci = 0; ci < mine; ++ci) {
    const bool more = ci + 1 < mine;
    const WorkRec rn = more ? rec_of(ci + 1) : WorkRec{};
    const bool active = tid < r.nv;
    const int pb = L.pairs_v + buf * L.pair_bytes;  // this chunk's pairs buffer
    if constexpr (S::ENTRIES) {
      cp_wait<0>();         // this thread's copies of x and of the pairs have landed
      consumers_sync(nct);  // ... and everyone's
    } else {
      // the chunk's pairs and entry offsets -> shared memory, in the background
      // (the previous chunk's sums are over: the last barrier below)
      stage_chunk_pairs<OUT_V, OUT_P>(smem, L, pb, cv, cp, r, nct);
      cp_commit();
      cp_wait<1>();  // this slot's x values have landed (the group before the pairs')
    }

    // y_i = sum_q A[q, i, s] x_q, in f32, a stage at a time
    float y[N_OUT];
#pragma unroll
    for (int i = 0; i < N_OUT; ++i) y[i] = 0.f;
    // this slot's value in row 0 of stage 0: its warp's tile, its lane
    const TA* mine_a = (const TA*)(smem + L.ring) + (tid / 32) * (32 * ROWS) + lane;
    if constexpr (S::ENTRIES) {
      // a few stages (1-12): unrolled, so that column q's entry index is a register
#pragma unroll
      for (int p = 0; p < S::PIECES; ++p) {
        mbar_wait(full(stage), phase);
        if (active) {
          const TA* col = mine_a + stage * (ROWS * g.Bc);
#pragma unroll
          for (int u = 0; u < G; ++u) {
            const int q = p * G + u;  // velocity components' dofs, then pressure's
            int e = -1, at = 0;
            if constexpr (IN_V) {
              if (q < NV) e = iv[q % KV], at = (q / KV) * r.nev;
            }
            if constexpr (IN_P) {
              if (q >= (IN_V ? NV : 0)) e = ip[q - (IN_V ? NV : 0)], at = IN_V ? DIM * r.nev : 0;
            }
            const float xq = e >= 0 ? xs[at + e] : 0.f;
#pragma unroll
            for (int i = 0; i < NR; ++i, col += 32) y[i] = fmaf(widen(*col), xq, y[i]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));
        if (++stage == stages) stage = 0, phase ^= 1;
      }
      // the next chunk's pairs (into the other buffer, which the previous
      // chunk's sums are done with) and its entries' rows, while this
      // chunk sums
      if (more) {
        stage_chunk_pairs<OUT_V, OUT_P>(smem, L, L.pairs_v + (buf ^ 1) * L.pair_bytes, cv, cp, rn,
                                        nct);
        stage_rows<IN_V, IN_P>(rows, cv, cp, rn, nct);
      }
      cp_commit();
      consumers_sync(nct);
    } else {
      for (int p = 0; p < S::PIECES; ++p) {
        mbar_wait(full(stage), phase);
        if (active) {
          const float xq = xsl[(p / SPLIT) * g.Bc + tid];
          const TA* col = mine_a + stage * (ROWS * g.Bc);
          if (p % SPLIT == 0) {
#pragma unroll
            for (int i = 0; i < NR; ++i, col += 32) y[i] = fmaf(widen(*col), xq, y[i]);
          } else {
#pragma unroll
            for (int i = NR; i < N_OUT; ++i, col += 32) y[i] = fmaf(widen(*col), xq, y[i]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));
        if (++stage == stages) stage = 0, phase ^= 1;
      }
      // the next chunk's x values -> this slot's column of xsl, in the background
      if (more) gather_slot<DIM, KV, KP>(g, t, x, rn, xsl);
      else cp_commit();  // an empty group: the wait counts stay as they are
      cp_wait<1>();      // this thread's copies of the pairs have landed
      consumers_sync(nct);
    }
    // the sums, a component at a time: velocity components, then pressure
    const uint16_t* pairs_v = (const uint16_t*)(smem + pb) + (r.tv0 & 1);
    const uint16_t* first_v = (const uint16_t*)(smem + pb + L.first_v - L.pairs_v) + (r.ev0 & 1);
    const uint16_t* pairs_p = (const uint16_t*)(smem + pb + L.pairs_p - L.pairs_v) + (r.tp0 & 1);
    const uint16_t* first_p = (const uint16_t*)(smem + pb + L.first_p - L.pairs_v) + (r.ep0 & 1);
    if constexpr (OUT_V) {
#pragma unroll
      for (int cc = 0; cc < DIM; ++cc) {
        if (active) {
#pragma unroll
          for (int l = 0; l < KV; ++l) ys[l * g.Bc + tid] = y[cc * KV + l];
        }
        consumers_sync(nct);
        entry_sums(r.nev, pairs_v, first_v, r.npv, ys, sub + cc * (long)cv.E + r.ev0, nct);
        consumers_sync(nct);
      }
    }
    if constexpr (OUT_P) {
      if (active) {
#pragma unroll
        for (int l = 0; l < KP; ++l) ys[l * g.Bc + tid] = y[(OUT_V ? NV : 0) + l];
      }
      consumers_sync(nct);
      entry_sums(r.nep, pairs_p, first_p, r.npp, ys,
                 sub + (OUT_V ? DIM * (long)cv.E : 0) + r.ep0, nct);
      consumers_sync(nct);
    }
    if constexpr (S::ENTRIES) {  // the next chunk's x at its entries, and this slot's entries
      if (more) {
        cp_wait<0>();         // this thread's copies of the rows have landed
        consumers_sync(nct);  // ... and everyone's
        stage_x<DIM, IN_V, IN_P>(xs, rows, x, g, rn, nct);
        cp_commit();
        slot_entries<KV, KP, IN_V, IN_P>(iv, ip, g, cv, cp, rn);
      }
      buf ^= 1;
    }
    r = rn;
  }
}

// ---- P3/P2 K2 v->p and p->p on triangles: the narrow product and merge ------
// Programmatic dependent launch (sm_90): the product lets the merge's blocks
// start once all of its blocks have issued their stores; the merge loads
// its row offsets, then waits until the product has finished and its stores
// are visible.  Where the merge is launched without the attribute, the
// wait returns at once.
__device__ __forceinline__ void let_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The product: Y[i, s] = sum_q A[q, i, s] x_q(s) for the KP pressure rows i
// of every occupied slot s, in float32, q ascending through fmaf.  A flat
// grid over the slots [nb, Bmax], one thread a slot and no shared memory:
// a thread at or past cnt[b] returns at once; an occupied one reads its KV
// (v->p) or KP (p->p) packed positions, its N_IN values of x through the
// read-only path (x, under 2 MB, lies in L2), its N_IN x KP values of A
// (a warp's read of one (q, i) is 32 neighbouring slots, one 64-byte piece
// with bf16 A) and writes its KP sums to Y [KP, ncd] (a row's store of a
// warp: one 128-byte line).  No barrier, so that a slot's loads of A start
// at once, beside its positions' and x's.  (One block a chunk that copies
// x once at the chunk's entries and sums the chunk's entries in shared
// memory was slower: its barrier holds the loads of A back; PERF.md.)
constexpr int kNarrowThreads = 256;
constexpr int kNarrowBlocks = 4;  // resident blocks an SM the registers must allow
template <int DIM, int KV, int KP, bool IN_V, typename TA>
__global__ void __launch_bounds__(kNarrowThreads, kNarrowBlocks)
narrow_product_kernel(Geo g, Tables t, const TA* __restrict__ A, int n_out_pad,
                      const float* __restrict__ x, float* __restrict__ Y) {
  constexpr int N_IN = IN_V ? DIM * KV : KP;
  const long s = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < g.ncd) {
    const int b = (int)(s / g.Bmax), j = (int)(s - (long)b * g.Bmax);
    if (j < t.cnt[b]) {
      float xin[N_IN];
      if constexpr (IN_V) {
        int iv[KV];
#pragma unroll
        for (int l = 0; l < KV; ++l)
          iv[l] = vec_index(win_pos(t.pos_v, KV, g, b, j, l), b, g.hv, g.OWv, g.n_vs);
#pragma unroll
        for (int cc = 0; cc < DIM; ++cc)
#pragma unroll
          for (int l = 0; l < KV; ++l)
            xin[cc * KV + l] = iv[l] >= 0 ? __ldg(x + (long)cc * g.n_vs + iv[l]) : 0.f;
      } else {
#pragma unroll
        for (int l = 0; l < KP; ++l) {
          const int ip = vec_index(win_pos(t.pos_p, KP, g, b, j, l), b, g.hp, g.OWp, g.n_ps);
          xin[l] = ip >= 0 ? __ldg(x + ip) : 0.f;
        }
      }
      float y[KP];
#pragma unroll
      for (int i = 0; i < KP; ++i) y[i] = 0.f;
      const TA* a = A + s;
#pragma unroll
      for (int q = 0; q < N_IN; ++q)
#pragma unroll
        for (int i = 0; i < KP; ++i)
          y[i] = fmaf(widen(__ldg(a + ((long)q * n_out_pad + i) * g.ncd)), xin[q], y[i]);
#pragma unroll
      for (int i = 0; i < KP; ++i) Y[(long)i * g.ncd + s] = y[i];
    }
  }
  let_dependents_launch();
}

// The merge: row r of the pressure = its places in order (a place: one
// chunk's entry at the row, the order of compact_tables), each place the sum
// of its (slot, dof) pairs in order (slots ascending), as
// _compact_scatter_reference sums them.  The host flattens the chain
// row_ptr -> at -> tr_off -> tr into one list a row (ops/windowed.py
// row_list): list[ptr[r] .. ptr[r + 1]) holds the row's pairs as their
// index l*ncd + s into Y, a place's first pair with bit 31 set.  A thread a
// row loads its offsets and first kNarrowAhead pairs, then waits for the
// product.
constexpr int kNarrowAhead = 8;
__global__ void __launch_bounds__(kThreads)
narrow_merge_kernel(const int* __restrict__ ptr, const int* __restrict__ list,
                    const float* __restrict__ Y, float* __restrict__ y, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  int k0 = 0, k1 = 0;
  if (r < n) k0 = ptr[r], k1 = ptr[r + 1];
  int ahead[kNarrowAhead];
#pragma unroll
  for (int i = 0; i < kNarrowAhead; ++i) ahead[i] = k0 + i < k1 ? list[k0 + i] : 0;
  wait_for_prerequisites();
  if (r >= n) return;
  float acc = 0.f, sum = 0.f;
  auto add = [&](int code, bool first) {
    if (code < 0 && !first) acc += sum, sum = 0.f;  // the next place
    sum += Y[code & 0x7FFFFFFF];
  };
#pragma unroll
  for (int i = 0; i < kNarrowAhead; ++i)
    if (k0 + i < k1) add(ahead[i], i == 0);
  for (int k = k0 + kNarrowAhead; k < k1; ++k) add(list[k], false);
  y[r] = acc + sum;
}

// ---- P3/P2 K4: the row-ordered sum over R ----------------------------------
// y = sum_cells P_c^T R_c with no chunk phase, no shared memory and no
// scratch: R [>= nl, ncd] is laid out slot by slot, so a thread a row of a
// space walks that row's (slot, dof) pairs of R through the space's row
// list (ops/windowed.py row_list: list[ptr[r] .. ptr[r + 1]) holds the
// row's pairs as their index l*ncd + s into the component's KV (velocity)
// or KP (pressure) rows of R, a place's first pair with bit 31 set) and
// sums them as _compact_scatter_reference does: a place's pairs in order
// (slots ascending), then the row's places in order.  A velocity row reads
// every component from one walk of its list (component cc's rows start
// cc*KV*ncd further on).  A thread walks its list kRowsAhead pairs at a
// time: their list entries, then their values of R, all in flight together,
// then their sums in order (a tetrahedron's vertex row takes ~24 pairs, a
// face row 2).  What holds it back are R's scattered 4-byte reads (a 32-byte
// sector for each value).  Tried on the card and slower or no faster
// (PERF.md): 2, 4, 8 or 16 pairs ahead; 128- or 512-thread blocks; a warp
// that stages its 32 rows' pairs in shared memory before its lanes sum; the
// list read evict-first, R evict-last; on tetrahedra scatter3_kernel made
// persistent, R streamed through a TMA ring (0.105 against 0.080 ms).
struct RowList {
  const int* __restrict__ ptr;   // [n + 1] a row's first pair
  const int* __restrict__ list;  // the pairs, bit 31 on a place's first
  const float* __restrict__ R;   // the space's component 0 rows of R
  int n;                         // the space's rows
};

constexpr int kRowsAhead = 6;
constexpr int kRowsThreads = 256;

template <int NC>
__device__ __forceinline__ void sum_row(const RowList& m, long comp_stride, int r,
                                        float* __restrict__ y) {
  const int k0 = m.ptr[r], k1 = m.ptr[r + 1];
  float acc[NC], sum[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) acc[cc] = 0.f, sum[cc] = 0.f;
  for (int k = k0; k < k1; k += kRowsAhead) {
    int code[kRowsAhead];
#pragma unroll
    for (int i = 0; i < kRowsAhead; ++i) code[i] = k + i < k1 ? m.list[k + i] : 0;
    float val[kRowsAhead][NC];
#pragma unroll
    for (int i = 0; i < kRowsAhead; ++i)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        val[i][cc] = k + i < k1 ? __ldg(m.R + (code[i] & 0x7FFFFFFF) + cc * comp_stride) : 0.f;
#pragma unroll
    for (int i = 0; i < kRowsAhead; ++i) {
      if (k + i < k1) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          if (k + i > k0 && code[i] < 0) acc[cc] += sum[cc], sum[cc] = 0.f;  // the next place
          sum[cc] += val[i][cc];
        }
      }
    }
  }
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) y[cc * (long)m.n + r] = acc[cc] + sum[cc];
}

// y = [velocity components (DIM * n_vs), then pressure (n_ps)]: a thread a
// velocity row (all DIM components), then a thread a pressure row
template <int DIM, int KV>
__global__ void __launch_bounds__(kRowsThreads)
scatter_rows_kernel(RowList v, RowList p, long ncd, float* __restrict__ y) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < v.n)
    sum_row<DIM>(v, KV * ncd, (int)t, y);
  else if (t - v.n < p.n)
    sum_row<1>(p, 0, (int)(t - v.n), y + DIM * (long)v.n);
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

// SPAN: both spaces carry their span tables (K4), or
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
  *g = Geo{m[0],  m[1],  m[2],  m[3],  m[4],  m[5],  m[6],  m[7],  m[8], m[9],
           m[10], m[11], m[12], m[13], m[14], m[15], m[16], m[17], m[18]};
  return with_element(*g, [](auto) { return 0; }) == 0;  // an element built here
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

// floats of 2D scratch: the chunk subwindows of a matvec or of K4
long subwindow_floats(const Geo& g, bool v, bool p) {
  return (long)g.nb * g.nchunks * 128 * ((v ? g.dim * g.RVv : 0) + (p ? g.RVp : 0));
}
// and the span tables of K4 after them
long span_ints(const Geo& g) { return 4L * g.nb * g.nchunks; }
int* span_tables(const Geo& g, float* scratch) {
  return (int*)(scratch + subwindow_floats(g, true, true));
}

// the ring depths the matvec kernel is compiled for
constexpr int kStageChoices[] = {2, 4, 7};

// launch_matvec's shared memory a block: the ring's kBaseStages stages of
// A (n_out rows of Bc values of a_bytes each) and the chunk's subwindows
// of the larger of its in- and out-spaces (rows of 128 floats)
inline long span_smem_bytes(const Geo& g, int n_out, int a_bytes, bool in_v, bool in_p,
                            bool out_v, bool out_p) {
  const long Lv = g.RVv * 128L, Lp = g.RVp * 128L;
  const long in_len = (in_v ? g.dim * Lv : 0) + (in_p ? Lp : 0);
  const long out_len = (out_v ? g.dim * Lv : 0) + (out_p ? Lp : 0);
  return kBaseStages * (long)n_out * g.Bc * a_bytes + 4L * (in_len > out_len ? in_len : out_len);
}

// 2D: matvec_kernel on triangles of element (KV, KP), then the merge
template <int KV, int KP, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P, typename TA>
int launch_matvec(const Geo& g, const Tables& t, const void* A, int n_out_pad,
                  const void* x, float* scratch, float* y, cudaStream_t stream) {
  constexpr int N_OUT = (OUT_V ? 2 * KV : 0) + (OUT_P ? KP : 0);
  using Kernel = void (*)(Geo, Tables, const TA*, int, const float*, float*, float*);
  const Kernel kernels[] = {
      matvec_kernel<2, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA, kStageChoices[0]>,
      matvec_kernel<2, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA, kStageChoices[1]>,
      matvec_kernel<2, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA, kStageChoices[2]>};
  // A is copied in 16-byte pieces: every chunk's row of A must start on one
  if (g.Bc > chunk_threads(2, KV) || (g.Bc * sizeof(TA)) % 16 != 0) return kErrLayout;
  if ((uintptr_t)A % 16 != 0) return kErrAlign;
  const int Lv = g.RVv * 128, Lp = g.RVp * 128;
  const long stage_bytes = (long)N_OUT * g.Bc * sizeof(TA);
  const long bytes = span_smem_bytes(g, N_OUT, sizeof(TA), IN_V, IN_P, OUT_V, OUT_P);
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

// the 3D merge of the out-spaces' row-ordered scratch (sub [dim][cv.E], then
// [cp.E]) into y, launched after a 3D chunk kernel on its stream
// (entry_order: the streaming K1's scratch, read through the tables' `at`)
int launch_merge3(const Geo& g, const Compact& cv, const Compact& cp, bool out_v, bool out_p,
                  const float* scratch, float* y, cudaStream_t stream, bool entry_order = false) {
  const RowMerge mv{scratch, cv.row_ptr, cv.at, out_v ? g.dim : 0, g.n_vs, cv.E};
  const RowMerge mp{scratch + (out_v ? (long)g.dim * cv.E : 0), cp.row_ptr, cp.at,
                    out_p ? 1 : 0, g.n_ps, cp.E};
  const long rows = (out_v ? g.n_vs : 0) + (out_p ? g.n_ps : 0);
  const int grid = (int)((rows + kThreads - 1) / kThreads);
  if (entry_order) merge3_kernel<true><<<grid, kThreads, 0, stream>>>(mv, mp, y);
  else merge3_kernel<false><<<grid, kThreads, 0, stream>>>(mv, mp, y);
  return (int)cudaGetLastError();
}

// the rings the 3D matvec kernel is compiled for: (stages, split, group).
// Products with wide columns (K1, K2 v->v: 30-34 rows at P2/P1, 60-70 at
// P3/P2) stream a column or half of one a stage; narrow ones (4 rows at
// P2/P1, 10 at P3/P2) several columns a stage.  A ring whose shared memory
// exceeds a block's limit at a layout is not chosen (at P3/P2 with float32
// A: the 3- and 4-stage whole-column rings).
struct Ring3d {
  int stages, split, group;
};
constexpr int kNumRings3d = 6;
constexpr Ring3d kRings3dWide[kNumRings3d] = {{2, 1, 1}, {3, 1, 1}, {4, 1, 1},
                                              {2, 2, 1}, {3, 2, 1}, {4, 2, 1}};
constexpr Ring3d kRings3dNarrow[kNumRings3d] = {{2, 1, 4}, {3, 1, 4}, {4, 1, 4},
                                                {2, 1, 1}, {4, 1, 1}, {8, 1, 1}};

// The compact block kernel (matvec3_kernel, then merge3_kernel) for element
// (DIM, KV, KP): every product on P2/P1 tetrahedra and K2 v->v on P3/P2
// tetrahedra, and on a compact 2D P2/P1 layout (Geo.compact) K1 and every
// K2.  The ring, from the occupancy calculator's count of resident blocks (asked
// once a device, chunk width and region size; measured in PERF.md): for wide
// columns the ring that lets the most blocks reside on an SM, since more
// blocks overlap more of one another's x copies and sums with the stream
// of A; for narrow ones (2-5 KB a column) the one with the most bytes of A
// in flight on an SM.  Ties go to the fewest barriers a chunk, then the
// shallowest ring.
template <int DIM, int KV, int KP, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P, typename TA>
int launch_matvec_compact(const Geo& g, const int* cnt, const Compact& cv, const Compact& cp,
                          const void* A, int n_out_pad, const void* x, float* scratch, float* y,
                          cudaStream_t stream) {
  constexpr int N_IN = (IN_V ? DIM * KV : 0) + (IN_P ? KP : 0);
  constexpr int N_OUT = (OUT_V ? DIM * KV : 0) + (OUT_P ? KP : 0);
  constexpr bool WIDE = N_OUT > 16;
  constexpr const Ring3d* rings = WIDE ? kRings3dWide : kRings3dNarrow;
  using Kernel = void (*)(Geo, const int*, Compact, Compact, const TA*, int, const float*, float*);
#define NS_MATVEC3(r) matvec3_kernel<DIM, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA, rings[r].stages, \
                                     rings[r].split, rings[r].group>
  const Kernel kernels[kNumRings3d] = {NS_MATVEC3(0), NS_MATVEC3(1), NS_MATVEC3(2),
                                       NS_MATVEC3(3), NS_MATVEC3(4), NS_MATVEC3(5)};
#undef NS_MATVEC3
  // A is copied in 16-byte pieces: every chunk's row of A must start on one
  if (g.Bc > chunk_threads(DIM, KV) || g.Bc % 32 != 0 || (g.Bc * sizeof(TA)) % 16 != 0)
    return kErrLayout;
  if ((uintptr_t)A % 16 != 0) return kErrAlign;
  // the region: x at the entries of the in-spaces, then the pairs and
  // offsets of the out-spaces
  const long xs_bytes = 4L * ((IN_V ? g.dim * cv.max_e : 0) + (IN_P ? cp.max_e : 0));
  const long pair_bytes = 2L * ((OUT_V ? cv.max_pairs + cv.max_e + 1 : 0) +
                                (OUT_P ? cp.max_pairs + cp.max_e + 1 : 0));
  const long region_bytes = (std::max(xs_bytes, pair_bytes) + 15) / 16 * 16;
  const long ys_bytes = 4L * N_OUT * g.Bc;
  auto stage_bytes = [&](int r) {
    return (long)rings[r].group * ((N_OUT + rings[r].split - 1) / rings[r].split) * g.Bc *
           (long)sizeof(TA);
  };
  auto smem_bytes = [&](int r) {
    return std::max(rings[r].stages * stage_bytes(r), ys_bytes) + region_bytes;
  };
  auto barriers = [&](int r) {  // a chunk's stages
    return rings[r].split == 2 ? 2 * N_IN : (N_IN + rings[r].group - 1) / rings[r].group;
  };
  static int allowed[kNumRings3d][kMaxDevices] = {};  // per instantiation and ring
  static long chosen_for = -1;                       // (device, Bc, region) of the choice
  static int chosen = 0;
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  const long key = ((long)dev * 1024 + g.Bc) * (1L << 32) + region_bytes;
  if (key != chosen_for) {
    int best = -1, best_blocks = 0;
    long best_score = 0;
    for (int r = 0; r < kNumRings3d; ++r) {
      const long bytes = smem_bytes(r);
      if (bytes > kMaxSmemBytes) continue;
      int e = set_smem(kernels[r], (int)bytes, allowed[r]);
      if (e != 0) return e;
      int blocks = 0;
      ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernels[r], g.Bc, bytes);
      if (ce != cudaSuccess) return (int)ce;
      // wide: resident blocks; narrow: stages of A in flight on an SM
      const long score = WIDE ? blocks
                              : blocks * std::min(rings[r].stages - 1, barriers(r)) *
                                    stage_bytes(r);
      if (best < 0 || score > best_score ||
          (score == best_score && (barriers(r) < barriers(best) ||
                                   (barriers(r) == barriers(best) &&
                                    rings[r].stages < rings[best].stages))))
        best = r, best_blocks = blocks, best_score = score;
    }
    if (best < 0 || best_blocks == 0) return kErrSmem;
    chosen_for = key, chosen = best;
  }
  const long bytes = smem_bytes(chosen);
  int e = set_smem(kernels[chosen], (int)bytes, allowed[chosen]);
  if (e != 0) return e;
  kernels[chosen]<<<g.nb * g.nchunks, g.Bc, bytes, stream>>>(g, cnt, cv, cp, (const TA*)A,
                                                             n_out_pad, (const float*)x, scratch);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  return launch_merge3(g, cv, cp, OUT_V, OUT_P, scratch, y, stream);
}

// one space's Compact record from the host's pack of kCompactLen values a
// space (ns_matvec's `compact`): 9 table addresses, E, the most entries and
// the most pairs of a chunk.  After both spaces' records the pack holds the
// streaming kernel's work records (WorkRec): their address and number; then
// the row lists (ops/windowed.py row_list) of the pressure (the narrow
// merge's and the row-ordered K4's) and of the velocity (the row-ordered
// K4's): their offsets' and their pairs' addresses each, 0 where the layout
// has no such list.
constexpr int kCompactLen = 12;
Compact unpack_compact(const int64_t* c) {
  return Compact{(const int*)c[0], (const int*)c[1], (const int*)c[2], (const uint16_t*)c[3],
                 (const int*)c[4], (const uint16_t*)c[5], (const int*)c[6],
                 (const uint16_t*)c[7], (const int*)c[8], (int)c[9], (int)c[10], (int)c[11]};
}

// The streaming kernel's launch at a layout for one product: its ring and
// grid.  K1 takes two blocks an SM where each keeps a ring of at least
// kTwoBlockStages stages beside its fixed part (triangles), so that one
// streams while the other sums a chunk; else one block with as many stages
// as fit (tetrahedra).  A block product's fixed part and stages are
// smaller: it takes the most blocks an SM, up to kMaxStreamBlocks, at
// which each keeps a ring of kMinBlockStages stages (and the occupancy
// calculator lets them reside), so that while some blocks gather x and
// sum, the others' stages stream; else one block with as many stages as
// fit.  At most kMaxStreamStages.  The grid: the blocks that reside on
// every SM at once, at most one a chunk.
struct StreamLaunch {
  int stages, stage_bytes, smem_bytes, blocks_per_sm, grid;
};
constexpr int kSmemPerSm = 233472;           // an SM's shared memory on Hopper
constexpr int kSmemReservedPerBlock = 1024;  // what the runtime keeps of it a block
constexpr int kTwoBlockStages = 4;
constexpr int kMaxStreamBlocks = 4;
constexpr int kMinBlockStages = 2;

template <int DIM, int KV, int KP, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P, typename TA>
int stream_launch(const Geo& g, const Compact& cv, const Compact& cp, int n_work,
                  StreamLaunch* out) {
  using S = Streamed<DIM, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA>;
  if (g.Bc > chunk_threads(DIM, KV) || g.Bc % 32 != 0) return kErrLayout;
  const StreamSmem L = stream_smem<S>(g.Bc, cv, cp);
  const long stage_bytes = (long)S::ROWS * g.Bc * sizeof(TA);
  auto ring_of = [&](long room) {
    return std::min<long>(kMaxStreamStages, (room - L.ring) / stage_bytes);
  };
  auto kernel = stream_matvec_kernel<DIM, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA>;
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  // the last choice a device, for its (fixed shared memory, stage, Bc)
  static long chosen_for[kMaxDevices] = {};
  static int chosen_stages[kMaxDevices] = {}, chosen_blocks[kMaxDevices] = {},
             sms[kMaxDevices] = {};
  const long key = ((long)L.ring * 4096 + stage_bytes) * 1024 + g.Bc + 1;
  const bool cached = dev < kMaxDevices && chosen_for[dev] == key;
  long stages = cached ? chosen_stages[dev] : 0;
  int blocks = cached ? chosen_blocks[dev] : 0, n_sm = cached ? sms[dev] : 0;
  if (!cached) {
    ce = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (ce != cudaSuccess) return (int)ce;
    // (blocks an SM, the least ring they take): the shared rings, most
    // blocks first, then the one-block ring
    const int most = S::K1 ? 2 : kMaxStreamBlocks;
    const long least = S::K1 ? kTwoBlockStages : kMinBlockStages;
    for (int want = most; want >= 1; --want) {
      const long s = want == 1 ? ring_of(kMaxSmemBytes)
                               : ring_of(kSmemPerSm / want - kSmemReservedPerBlock);
      if (s < (want == 1 ? 2 : least)) continue;
      const int bytes = (int)(L.ring + s * stage_bytes);
      int e = set_smem(kernel, bytes, allowed);
      if (e != 0) return e;
      ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, g.Bc + 32, bytes);
      if (ce != cudaSuccess) return (int)ce;
      stages = s;
      if (blocks >= want) break;  // they reside, or the one-block ring
    }
    if (stages < 2 || blocks == 0) return kErrSmem;
    if (dev < kMaxDevices)
      chosen_for[dev] = key, chosen_stages[dev] = (int)stages, chosen_blocks[dev] = blocks,
      sms[dev] = n_sm;
  }
  const int bytes = (int)(L.ring + stages * stage_bytes);
  int e = set_smem(kernel, bytes, allowed);
  if (e != 0) return e;
  *out = StreamLaunch{(int)stages, (int)stage_bytes, bytes, blocks,
                      std::min(n_work, blocks * n_sm)};
  return 0;
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library needs no link against libcuda (as in mxu_probe.cu)
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

// The streaming kernel on the compact tables (with the work records:
// `compact`'s last two values), then merge3_kernel over the out-spaces.
// A [N_IN, n_out_pad, ncd] is read through a 3-D tensor map (slots, rows,
// columns) in boxes of 32 slots by NR rows by G columns, encoded at every
// call (A may move between calls); the map is a kernel parameter, so a
// CUDA graph captures it.
template <int DIM, int KV, int KP, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P, typename TA>
int launch_stream_matvec(const Geo& g, const Tables& t, const int64_t* compact, const void* A,
                         int n_out_pad, const void* x, float* scratch, float* y,
                         cudaStream_t stream) {
  using S = Streamed<DIM, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA>;
  if (compact == nullptr) return kErrLayout;
  const Compact cv = unpack_compact(compact), cp = unpack_compact(compact + kCompactLen);
  const int4* recs = (const int4*)compact[2 * kCompactLen];
  const int n_work = (int)compact[2 * kCompactLen + 1];
  if ((uintptr_t)A % 16 != 0) return kErrAlign;
  StreamLaunch sl;
  int e = stream_launch<DIM, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA>(g, cv, cp, n_work, &sl);
  if (e != 0) return e;
  if (n_work > 0) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
    CUtensorMap map;
    const cuuint64_t dims[3] = {(cuuint64_t)g.ncd, (cuuint64_t)n_out_pad, (cuuint64_t)S::N_IN};
    const cuuint64_t strides[2] = {(cuuint64_t)g.ncd * sizeof(TA),
                                   (cuuint64_t)n_out_pad * g.ncd * sizeof(TA)};
    const cuuint32_t box[3] = {32, S::NR, S::G}, unit[3] = {1, 1, 1};
    if (encode(&map,
               sizeof(TA) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               3, const_cast<void*>(A), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    stream_matvec_kernel<DIM, KV, KP, IN_V, IN_P, OUT_V, OUT_P, TA>
        <<<sl.grid, g.Bc + 32, sl.smem_bytes, stream>>>(g, t, cv, cp, recs, n_work, sl.stages,
                                                          map, (const float*)x, scratch);
    cudaError_t ce = cudaGetLastError();
    if (ce != cudaSuccess) return (int)ce;
  }
  return launch_merge3(g, cv, cp, OUT_V, OUT_P, scratch, y, stream, true);
}

// The narrow products (K2 v->p and p->p on P3/P2 triangles):
// narrow_product_kernel writes Y [KP, ncd] to the scratch, then
// narrow_merge_kernel sums it through the pressure's row list, whose two
// addresses (offsets, pairs) follow the work records in `compact`.  The
// merge is launched with programmatic stream serialization, so that its
// blocks start while the product's last blocks run (a plain launch after
// the product was 1.6 us slower a call at the channel; letting them start
// at the product's start instead of after its stores was slower too:
// PERF.md).
constexpr int kNarrowArgs = 2 * kCompactLen + 2;  // the pressure's row list
constexpr int kRowListV = kNarrowArgs + 2;          // the velocity's
template <int KV, int KP, bool IN_V, typename TA>
int launch_narrow(const Geo& g, const Tables& t, const int64_t* compact, const void* A,
                  int n_out_pad, const void* x, float* scratch, float* y, cudaStream_t stream) {
  if (compact == nullptr || compact[kNarrowArgs] == 0) return kErrLayout;
  const long grid = (g.ncd + kNarrowThreads - 1) / kNarrowThreads;
  narrow_product_kernel<2, KV, KP, IN_V, TA><<<(int)grid, kNarrowThreads, 0, stream>>>(
      g, t, (const TA*)A, n_out_pad, (const float*)x, scratch);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((g.n_ps + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, narrow_merge_kernel, (const int*)compact[kNarrowArgs],
                                 (const int*)compact[kNarrowArgs + 1], (const float*)scratch, y,
                                 g.n_ps);
}

// Which kernels serve a product.  The narrow kernels: K2 v->p and p->p on
// P3/P2 triangles, whose chunks move only 15 and 18 KB of A (6 output rows
// against 20 or 6 input rows), so that a chunk's serial phases (the
// streaming kernel's records, rings and barriers across 1-2 chunks a block;
// matvec_kernel's subwindows and 9 colour rounds) took as long as A's
// bytes (PERF.md).
template <typename E, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P>
constexpr bool narrow() {
  return E::DIM == 2 && E::KV == 10 && !OUT_V && OUT_P && IN_V != IN_P;
}

// The streaming kernel: on the P3/P2 elements K1; on triangles K2 v->v; on
// tetrahedra K2 v->p and p->p.  The others keep the block-per-chunk
// kernels: 3D v->v (60 x 60 values a cell, which matvec3_kernel streams at
// 0.59 of its bound) and every P2/P1 product.
template <typename E, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P>
constexpr bool streams() {
  constexpr bool k1 = IN_V && IN_P && OUT_V && OUT_P;
  constexpr bool vv = IN_V && !IN_P && OUT_V && !OUT_P;
  if constexpr (E::DIM == 2 && E::KV == 10) return k1 || vv;
  if constexpr (E::DIM == 3 && E::KV == 20) return !vv;
  return false;
}

template <typename E, bool IN_V, bool IN_P, bool OUT_V, bool OUT_P, typename TA>
int launch_matvec_any(const Geo& g, const Tables& t, const int64_t* compact, const void* A,
                      int n_out_pad, const void* x, float* scratch, float* y, cudaStream_t st) {
  if constexpr (narrow<E, IN_V, IN_P, OUT_V, OUT_P>()) {
    return launch_narrow<E::KV, E::KP, IN_V, TA>(g, t, compact, A, n_out_pad, x, scratch, y, st);
  } else if constexpr (streams<E, IN_V, IN_P, OUT_V, OUT_P>()) {
    return launch_stream_matvec<E::DIM, E::KV, E::KP, IN_V, IN_P, OUT_V, OUT_P, TA>(
        g, t, compact, A, n_out_pad, x, scratch, y, st);
  } else {
    // tetrahedra and compact 2D P2/P1 layouts on the compact tables, other
    // triangle layouts on their chunk subwindows
    if (E::DIM == 3 || g.compact) {
      if (compact == nullptr) return kErrLayout;
      return launch_matvec_compact<E::DIM, E::KV, E::KP, IN_V, IN_P, OUT_V, OUT_P, TA>(
          g, t.cnt, unpack_compact(compact), unpack_compact(compact + kCompactLen), A, n_out_pad,
          x, scratch, y, st);
    }
    if constexpr (E::DIM == 2)
      return launch_matvec<E::KV, E::KP, IN_V, IN_P, OUT_V, OUT_P, TA>(g, t, A, n_out_pad, x,
                                                                       scratch, y, st);
    return kErrLayout;
  }
}

// f(Spaces<...>{}) for a product's spaces, given as codes (1 = velocity,
// 2 = pressure, 3 = both): vp->vp, v->v, v->p or p->p
template <bool IN_V_, bool IN_P_, bool OUT_V_, bool OUT_P_>
struct Spaces {
  static constexpr bool IN_V = IN_V_, IN_P = IN_P_, OUT_V = OUT_V_, OUT_P = OUT_P_;
};

template <typename F>
int with_spaces(int in_sp, int out_sp, F&& f) {
  if (in_sp == 3 && out_sp == 3) return f(Spaces<true, true, true, true>{});
  if (in_sp == 1 && out_sp == 1) return f(Spaces<true, false, true, false>{});
  if (in_sp == 1 && out_sp == 2) return f(Spaces<true, false, false, true>{});
  if (in_sp == 2 && out_sp == 2) return f(Spaces<false, true, false, true>{});
  return (int)cudaErrorInvalidValue;
}

template <typename E, typename TA>
int dispatch_spaces(int in_sp, int out_sp, const Geo& g, const Tables& t, const int64_t* compact,
                    const void* A, int n_out_pad, const void* x, float* scratch,
                    float* y, cudaStream_t st) {
  return with_spaces(in_sp, out_sp, [&](auto sp) {
    using P = decltype(sp);
    return launch_matvec_any<E, P::IN_V, P::IN_P, P::OUT_V, P::OUT_P, TA>(
        g, t, compact, A, n_out_pad, x, scratch, y, st);
  });
}

template <typename E, int NVEC>
int launch_gather(const Geo& g, const Tables& t, const float* x0, const float* x1, float* X,
                  int nli, cudaStream_t stream) {
  if (g.Bc > chunk_threads(E::DIM, E::KV) || g.Bc % 32 != 0 ||
      nli < E::DIM * E::KV + E::KP)
    return kErrLayout;
  if ((uintptr_t)X % 16 != 0) return kErrAlign;
  gather_kernel<E::DIM, E::KV, E::KP, NVEC><<<g.nb * g.nchunks, g.Bc, 0, stream>>>(
      g, t, x0, x1, X, nli);
  return (int)cudaGetLastError();
}

// 2D K4: scatter_kernel (all of a chunk's subwindows in shared memory), then
// the merge of the spans it wrote
template <int KV, int KP>
int launch_scatter(const Geo& g, const Tables& t, const void* R, float* scratch,
                   float* y, cudaStream_t stream) {
  if (g.Bc > chunk_threads(2, KV) || g.Bc % 32 != 0) return kErrLayout;
  const int Lv = g.RVv * 128, Lp = g.RVp * 128;
  const int bytes = 4 * (g.dim * Lv + Lp);
  static int allowed[kMaxDevices] = {};
  int e = set_smem(scatter_kernel<2, KV, KP>, bytes, allowed);
  if (e != 0) return e;
  float* sub_v = scratch;
  float* sub_p = scratch + subwindow_floats(g, true, false);
  int* span_v = span_tables(g, scratch);
  int* span_p = span_v + 2L * g.nb * g.nchunks;
  scatter_kernel<2, KV, KP><<<g.nb * g.nchunks, (g.Bc + 31) / 32 * 32, bytes, stream>>>(
      g, t, (const float*)R, sub_v, sub_p, span_v, span_p);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  const MergeSpace mv{sub_v, nullptr, t.cnt, span_v, g.dim, g.nb, g.nchunks, Lv, g.OWv, g.hv,
                      g.n_vs, g.Bc};
  const MergeSpace mp{sub_p, nullptr, t.cnt, span_p, 1, g.nb, g.nchunks, Lp, g.OWp, g.hp,
                      g.n_ps, g.Bc};
  return (int)launch_merge<true>(mv, mp, y, stream);
}

// K4's design by element (ops/windowed.py _SCATTER_ROWS): the row-ordered
// sum over R (scatter_rows_kernel) on the P3/P2 elements, whose chunks the
// chunk kernels served in series of fixed phases (on triangles a chunk's
// subwindows zeroed, 9 colour rounds behind barriers and the touched spans
// read back by a second kernel; on tetrahedra a chunk's 70 rows of R
// copied to shared memory, then summed, then written to a scratch that
// merge3_kernel read back: PERF.md); at P2/P1 scatter_kernel and
// scatter3_kernel with their merges.
template <typename E>
constexpr bool scatter_rows() {
  return (E::DIM == 2 && E::KV == 10) || (E::DIM == 3 && E::KV == 20);
}
// The row-ordered K4: one launch over the velocity's rows, then the
// pressure's, through the row lists that follow the work records in
// `compact`; no scratch.
template <int DIM, int KV>
int launch_scatter_rows(const Geo& g, const int64_t* compact, const void* R, float* y,
                        cudaStream_t stream) {
  if (compact == nullptr || compact[kNarrowArgs] == 0 || compact[kRowListV] == 0)
    return kErrLayout;
  const float* r = (const float*)R;
  const RowList v{(const int*)compact[kRowListV], (const int*)compact[kRowListV + 1], r, g.n_vs};
  const RowList p{(const int*)compact[kNarrowArgs], (const int*)compact[kNarrowArgs + 1],
                  r + (long)DIM * KV * g.ncd, g.n_ps};
  const long rows = (long)g.n_vs + g.n_ps;
  scatter_rows_kernel<DIM, KV>
      <<<(int)((rows + kRowsThreads - 1) / kRowsThreads), kRowsThreads, 0, stream>>>(v, p, g.ncd,
                                                                                    y);
  return (int)cudaGetLastError();
}

// 3D K4: scatter3_kernel on the compact tables, then merge3_kernel.  Shared
// memory: R's nl rows of a chunk and the most (slot, dof) pairs and entry
// offsets of a chunk of both spaces (within compact_smem_bytes, which
// compact_tables holds to a block's limit).
template <int KV, int KP>
int launch_scatter_3d(const Geo& g, const int* cnt, const Compact& cv, const Compact& cp,
                      const void* R, float* scratch, float* y, cudaStream_t stream) {
  constexpr int NL = 3 * KV + KP;
  if (g.Bc > chunk_threads(3, KV) || g.Bc % 32 != 0) return kErrLayout;
  if ((uintptr_t)R % 16 != 0) return kErrAlign;
  const long bytes = 4L * NL * g.Bc +
                     2L * (cv.max_pairs + cv.max_e + 1 + cp.max_pairs + cp.max_e + 1);
  static int allowed[kMaxDevices] = {};
  int e = set_smem(scatter3_kernel<3, KV, KP>, (int)bytes, allowed);
  if (e != 0) return e;
  scatter3_kernel<3, KV, KP><<<g.nb * g.nchunks, g.Bc, bytes, stream>>>(
      g, cnt, cv, cp, (const float*)R, scratch);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  return launch_merge3(g, cv, cp, true, true, scratch, y, stream);
}

// The entry points' bodies for the layout's element (with_element), here
// rather than in the extern "C" functions, whose generic lambdas some host
// compilers refuse as templates with C linkage.
int gather_any(const Geo& g, const Tables& t, const float* x0, const float* x1, float* X,
               int nvec, int nli, cudaStream_t st) {
  return with_element(g, [&](auto e) {
    using E = decltype(e);
    if (nvec == 1) return launch_gather<E, 1>(g, t, x0, x0, X, nli, st);
    if (nvec == 2) return launch_gather<E, 2>(g, t, x0, x1, X, nli, st);
    return (int)cudaErrorInvalidValue;
  });
}

int scatter_any(const Geo& g, const Tables& t, const int64_t* compact, const void* R,
                float* scratch, float* y, cudaStream_t st) {
  return with_element(g, [&](auto e) {
    using E = decltype(e);
    if constexpr (scatter_rows<E>()) {
      return launch_scatter_rows<E::DIM, E::KV>(g, compact, R, y, st);
    } else if constexpr (E::DIM == 3) {
      if (compact == nullptr) return kErrLayout;
      return launch_scatter_3d<E::KV, E::KP>(g, t.cnt, unpack_compact(compact),
                                             unpack_compact(compact + kCompactLen), R, scratch,
                                             y, st);
    } else {
      // a compact 2D P2/P1 layout: the row-ordered sum, as at P3/P2
      if (g.compact) return launch_scatter_rows<E::DIM, E::KV>(g, compact, R, y, st);
      return launch_scatter<E::KV, E::KP>(g, t, R, scratch, y, st);
    }
  });
}

int matvec_any(const Geo& g, const Tables& t, const int64_t* compact, const void* A, int a_bf16,
               int in_sp, int out_sp, int n_out_pad, const void* x, float* scratch, float* y,
               cudaStream_t st) {
  return with_element(g, [&](auto e) {
    using E = decltype(e);
    return a_bf16 ? dispatch_spaces<E, __nv_bfloat16>(in_sp, out_sp, g, t, compact, A,
                                                      n_out_pad, x, scratch, y, st)
                  : dispatch_spaces<E, float>(in_sp, out_sp, g, t, compact, A, n_out_pad, x,
                                              scratch, y, st);
  });
}

int stream_config_any(const Geo& g, const int64_t* compact, int a_bf16, int in_sp, int out_sp,
                      int* out) {
  const Compact cv = unpack_compact(compact), cp = unpack_compact(compact + kCompactLen);
  const int n_work = (int)compact[2 * kCompactLen + 1];
  StreamLaunch sl;
  const int e = with_element(g, [&](auto el) {
    using E = decltype(el);
    return with_spaces(in_sp, out_sp, [&](auto sp) {
      using P = decltype(sp);
      if constexpr (streams<E, P::IN_V, P::IN_P, P::OUT_V, P::OUT_P>()) {
        return a_bf16 ? stream_launch<E::DIM, E::KV, E::KP, P::IN_V, P::IN_P, P::OUT_V,
                                      P::OUT_P, __nv_bfloat16>(g, cv, cp, n_work, &sl)
                      : stream_launch<E::DIM, E::KV, E::KP, P::IN_V, P::IN_P, P::OUT_V,
                                      P::OUT_P, float>(g, cv, cp, n_work, &sl);
      } else {
        return kErrLayout;
      }
    });
  });
  if (e != 0) return e;
  out[0] = sl.stages, out[1] = sl.stage_bytes, out[2] = sl.smem_bytes;
  out[3] = sl.blocks_per_sm, out[4] = sl.grid;
  return 0;
}

}  // namespace

extern "C" {

// Every entry point returns 0, a cudaError_t value, or one of the negative
// codes above.  The six table pointers are the packed position tables, the
// subwindow offsets, the occupied-slot counts and the slot colours of the
// layout (null in 3D: no 3D kernel reads them).

// floats of scratch that ns_matvec and ns_scatter may use for this layout:
// in 2D the chunk subwindows and K4's span tables, where a kernel of the
// layout writes them; in 3D and on a compact 2D P2/P1 layout the
// row-ordered compact vector of compact (as ns_matvec's), dim*E_v + E_p
long ns_scratch_floats(const int* meta, const int64_t* compact) {
  Geo g;
  if (!load_geo(meta, &g)) return kErrLayout;
  const long packed = compact == nullptr ? 0
                      : g.dim * unpack_compact(compact).E +
                            (long)unpack_compact(compact + kCompactLen).E;
  if (g.dim == 3 || g.compact) return compact == nullptr ? kErrLayout : packed;
  // 2D: matvec_kernel and scatter_kernel write subwindows; at P3/P2 K1
  // and K2 v->v write the compact vector, K2 v->p and p->p the slots' sums
  // Y [k_p, ncd], and K4 (the row-ordered sum) nothing
  const bool narrow_y = with_element(g, [](auto e) {
    return narrow<decltype(e), true, false, false, true>() ? 1 : 0;
  });
  const bool subwindows = with_element(g, [](auto e) {
    using E = decltype(e);
    constexpr bool all_compact = streams<E, true, true, true, true>() &&
                                 streams<E, true, false, true, false>() &&
                                 narrow<E, true, false, false, true>() &&
                                 narrow<E, false, true, false, true>();
    return all_compact && scatter_rows<E>() ? 0 : 1;
  });
  return std::max({subwindows ? subwindow_floats(g, true, true) + span_ints(g) : 0L, packed,
                   narrow_y ? (long)g.k_p * g.ncd : 0L});
}

// The shared memory a block of the 2D subwindow matvec (launch_matvec)
// asks for at this layout in its largest call, K1 with float32 A: the
// figure from which ops/windowed.py span_smem_bytes chooses the route
long ns_span_smem_bytes(const int* meta) {
  Geo g;
  if (!load_geo(meta, &g) || g.dim != 2) return kErrLayout;
  return span_smem_bytes(g, 2 * g.k_v + g.k_p, sizeof(float), true, true, true, true);
}

// The streaming kernel's launch at this layout (P3/P2 only) for a product
// (in_spaces, out_spaces: ns_matvec's codes) with bfloat16 (a_bf16 1) or
// float32 A: out = [ring stages, bytes a stage, shared memory bytes a
// block, resident blocks an SM, grid].
int ns_stream_config(const int* meta, const int64_t* compact, int a_bf16, int in_spaces,
                     int out_spaces, int* out) {
  Geo g;
  if (!load_geo(meta, &g) || compact == nullptr) return kErrLayout;
  return stream_config_any(g, compact, a_bf16, in_spaces, out_spaces, out);
}

// X [nvec, nli, ncd] = the gathers of x0 (and x1: nvec 2) in one launch: K3
int ns_gather(const int* meta, const void* pos_v, const void* pos_p,
              const void* offs_v, const void* offs_p, const void* cnt, const void* colour,
              const void* x0, const void* x1, void* X, int nvec, int nli, void* stream) {
  Geo g;
  if (!load_geo(meta, &g)) return kErrLayout;
  return gather_any(g, make_tables(pos_v, pos_p, offs_v, offs_p, cnt, colour),
                    (const float*)x0, (const float*)x1, (float*)X, nvec, nli,
                    (cudaStream_t)stream);
}

// y [n_u + n_ps] = sum_cells P_c^T R_c: K4, then the merge.  compact: as
// ns_matvec's, null on a layout of the 2D subwindow kernels.
int ns_scatter(const int* meta, const void* pos_v, const void* pos_p,
               const void* offs_v, const void* offs_p, const void* cnt, const void* colour,
               const int64_t* compact, const void* R, void* scratch, void* y, void* stream) {
  Geo g;
  if (!load_geo(meta, &g)) return kErrLayout;
  return scatter_any(g, make_tables(pos_v, pos_p, offs_v, offs_p, cnt, colour), compact, R,
                     (float*)scratch, (float*)y, (cudaStream_t)stream);
}

// y [the out-spaces' planar segment] = A x: K1 / K2, then the merge.
// compact: the compact kernels' tables (ops/windowed.py _Packed.compact_args:
// velocity's, then pressure's, then the work records and row lists), null on
// a layout of the 2D subwindow kernels.
int ns_matvec(const int* meta, const void* pos_v, const void* pos_p,
              const void* offs_v, const void* offs_p, const void* cnt, const void* colour,
              const int64_t* compact, const void* A, int a_bf16, int in_spaces, int out_spaces,
              int n_out_pad, const void* x, void* scratch, void* y, void* stream) {
  Geo g;
  if (!load_geo(meta, &g)) return kErrLayout;
  return matvec_any(g, make_tables(pos_v, pos_p, offs_v, offs_p, cnt, colour), compact, A,
                    a_bf16, in_spaces, out_spaces, n_out_pad, x, (float*)scratch, (float*)y,
                    (cudaStream_t)stream);
}

}  // extern "C"
