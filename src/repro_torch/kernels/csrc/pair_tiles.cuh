// pair_tiles.cuh: the launch that stratified_moments.cu and
// sample_extremes.cu share. Both compute, for every (query, stratum) pair,
// one reduction of the stratum's samples that fall inside the query box,
// from the synopsis's leaf-major layout: sample_c (k, s, d), sample_a
// (k, s), sample_valid (k, s) bool, q_lo / q_hi (Q, d). A slot is relevant
// iff valid and lo_j <= c_j <= hi_j for every column j (inclusive bounds).
// They differ only in the reduction and the output, which a policy class
// `Acc` supplies (below).
//
// The order contract depends on s alone. The slot axis is cut into chunks
// of SLOT_CHUNK = 2048 consecutive slots. For s <= SLOT_CHUNK (one chunk)
// a pair's reduction runs over its slots in slot order from init(). For
// s > SLOT_CHUNK each chunk gives a partial, in slot order from init() over
// the chunk's slots, and the pair's result folds the partials in chunk
// order from init() (merge()). So a pair's bits depend on its slots, s and
// SLOT_CHUNK only: never on Q, k, the pair's place in the batch or the grid.
//
// Classes: a (query, stratum) pair (or, above one chunk, a (query,
// stratum, chunk) triple) is empty (no valid slot inside the box), covered
// (every valid slot inside) or mixed. A covered one's reduction is the
// stratum's (chunk's) own over its slots, the same for every query; an
// empty one's is the reduction of no relevant slot; only mixed ones walk
// their slots. Both paths classify from the box around the valid samples
// (fminf / fmaxf, so NaN coordinates skipped) with the slot test's own
// compares: covered iff the query box holds the box and no valid slot has
// a NaN coordinate (the slot test rejects NaN, so a flagged box is never
// covered), empty iff they are apart in some column. NT = 256 threads a
// block, QT = 128-query tiles.
//
// s <= SLOT_CHUNK, one pass (pair_tile_kernel): a block owns a tile of
// LT = 16 leaves and a group of query tiles (group, group + groups, ...;
// groups is the most that keeps every block resident at once, by the
// occupancy calculator, so the grid runs in one wave):
//  1. It stages its leaves' slots in shared memory (one 16-byte cp.async
//     run per array when they fit in STAGE_BYTES and the arrays are
//     aligned, else chunks of loads with BATCH in flight per thread).
//  2. Thread l reduces leaf l's slots in slot order; the other threads
//     take a (leaf, column) pair each for the box and the NaN flag. Once
//     per block, so `groups` times per leaf tile, from L2.
//  3. For each of its query tiles (the next tile's queries arrive by
//     cp.async while one is served) every pair is classified; the tile in
//     shared memory takes the leaf's result or the empty one, and the
//     mixed pairs go to a list.
//  4. The tile goes out as rows of LT * WIDTH contiguous floats a plane:
//     16-byte stores when k is a multiple of 4 and `out` is aligned,
//     4-byte ones otherwise.
//  5. The listed pairs are walked one thread each, all of the block's at
//     once (the list is flushed only when a tile's pairs might not fit):
//     the slots from shared memory when they are one staged chunk, else
//     from global memory (L2), and the result overwrites the tile's empty
//     one in `out`.
//
// s > SLOT_CHUNK, chunk tiles (pair_chunk_kernel), one cooperative launch
// whose grid is at most the resident blocks. A work item is (leaf, chunk,
// query group): a group is a run of gq consecutive queries, groups =
// resident blocks / (k * chunks), at least 1 and at most one per GQ_MIN =
// 64 queries; at d = 1 the kernel is held to 48 registers a thread, so
// that five blocks share a multiprocessor. The blocks take the items in a
// grid-stride loop. Phase 1, for an item:
//  1. The block stages the leaf's chunk (c, a, valid) in shared memory
//     with cp.async (16-byte units where the source is 16-byte aligned,
//     4-byte units where it is 4-byte aligned, bytes otherwise): at most
//     SLOT_CHUNK * (4d + 5) bytes, one leaf. Every query of the group then
//     reads the chunk from there: the reuse across queries that a batched
//     product has.
//  2. The chunk's box and NaN flag: P = a power of two <= NT / d threads a
//     column, each over slots part, part + P, ..., then a tree (fminf,
//     fmaxf and OR are order-free up to the sign of a zero, which no
//     compare sees). Then an invalid slot's column 0 becomes NaN, which no
//     bound holds, so that a walk tests coordinates only.
//  3. The group-0 item writes the box and the flag to the scratch and
//     lists the chunk's own partial as a walk of the box (-inf, +inf):
//     every valid slot but one with a NaN coordinate, so exact wherever
//     it is read (a flagged chunk is never covered).
//  4. Each thread classifies queries of the group (their bounds from
//     global memory) and lists the mixed ones; the list holds a group's
//     queries (up to LIST_MAX a pass), so an item's walks take
//     ceil(walks / NT) rounds. A walk is one thread's, in slot order from
//     shared memory, four slots a step, every thread of a warp reading the
//     same slots (a broadcast); its partial goes to the scratch. Covered
//     and empty triples write nothing.
// A grid-wide sync. Phase 2, thread per pair (grid-stride over Q * k):
// init(), then for each chunk in order the class again from the scratch's
// box and flag (the same compares on the same bits, so the same class):
// covered merges the chunk's partial, empty the empty reduction (none()),
// mixed the walk's partial; write(). The (leaf, chunk) boxes, flags and
// partials are read from shared memory when they fit in the chunk's room
// (k * chunks * (2d + STATS + 1) floats). No float atomics, no second
// launch, no memset.
//
// The policy `Acc` (one object is one running reduction):
//   STATS   floats a reduction keeps (shared memory, the scratch);
//   PLANES  output planes (1 or 2), Q * k * WIDTH floats each;
//   WIDTH   floats a pair takes in a plane;
//   init()              the start of every fold;
//   none()              the reduction of a chunk (s >= 1 slots) with no
//                       relevant slot;
//   add(a, in)          one slot, `in` iff relevant;
//   merge(p)            fold a later chunk's partial p in;
//   save(t) / load(t)   to and from STATS floats;
//   fill(tile, q, l, inside)  the tile's entries of a covered (`inside`:
//                       this reduction) or an empty pair, at tile_at();
//   write(out, pair, plane)   a pair's result, pair = q * k + leaf,
//                       plane = Q * k * WIDTH.
//
// Shared memory (dynamic). One pass: the tile PLANES * WIDTH * QT * LT * 4
// bytes, the staged chunk LT * sc * (4d + 5) bytes <= STAGE_BYTES, two
// query buffers QT * 16d, boxes, the leaves' reductions, flags and the walk
// list of LIST_CAP entries. Chunk tiles: the chunk SLOT_CHUNK * (4d + 5)
// bytes, the box, the tree's 12 * NT bytes and the list of min(Q,
// LIST_MAX) + 1 entries (~30 KB at d = 1, ~46 KB at d = 3, ~150 KB at
// d = 16, Q = 2048). Scratch (the wrapper's, pair_scratch_floats): the
// walks' partials (chunks, Q, k, STATS), then per (leaf, chunk) the box
// (2d), the partial (STATS) and the flag.
//
// Any d. The kernels above take d <= MAX_D = 16 columns (compile-time d
// of 1..3, a runtime d up to 16), whose bounds and boxes sit in register
// arrays and whose chunks are staged whole. Above 16 columns the launch
// runs wide instantiations of the same two kernels (pair_tile_wide_kernel,
// pair_chunk_wide_kernel), whose registers do not grow with d: the columns
// go in blocks of WIDE_COLS = 16 (wide_cols.cuh). While they classify,
// they note the columns that cut each pair, and their walks test only
// those (wide_cols.cuh: a column whose extent the query holds changes no
// valid slot's bit).
//  * One pass: a leaf's reduction reads its slots from L2 in slot order;
//    for each query tile and column block the block's query bounds go to
//    shared memory (over the tile, free until the tile is filled) by
//    cp.async, and the leaves' box columns of the block are
//    formed, a thread a (leaf, column), once a block up to BOX_D = 32
//    columns (kept for every tile), else for each tile (at d = 24 forming
//    them for each tile takes 12 % longer on an H100: tools/
//    wide_walk_split.py, variant no_box_once); each thread ANDs /
//    ORs its 8 pairs' inside / apart bits over the blocks, and a query's
//    cut word takes the columns that cut any of its pairs with the tile's
//    leaves (the 16 lanes of those pairs OR their masks). The mixed pairs
//    are listed in a bucket per leaf, CUT_TILES query tiles at most, and
//    walked in rounds of NT (walk_wide), in the buckets' order, so that a
//    round's pairs share few leaves: the round's leaves' values, valid
//    bits and the columns its pairs need are staged for as many windows
//    of WALK_WIN = 32 slots as WALK_X_BYTES holds, then each pair tests
//    its query's cut columns, the held slots one by one once few are
//    left, and adds the window's relevant slots in slot order. Four blocks
//    share a multiprocessor (64 registers a thread, ~54 KB of shared
//    memory at every d).
//  * Chunk tiles: an item stages only the chunk's valid bytes; its
//    box is formed block by block (16 threads a column, the same tree),
//    written to the scratch by the group-0 item, and the group's queries
//    (at most LIST_MAX a pass: 16 a thread) AND / OR their flags and note
//    their own cut columns over the blocks; the walks as the one pass's,
//    one leaf's chunk a round, its own partial cutting its NaN columns.
//    Phase 2 reads the boxes a column at a time, from shared memory when
//    every (leaf, chunk)'s fits in the block's, else through L2.
// The reductions, the folds and their orders are the d <= 16 kernels':
// only which columns a compare sees, and when, differs, and the compares
// are exact, so every class, every `in` and every bit is the same as if
// the d columns were tested at once.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_cols.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256;            // threads per block
constexpr int QT = 128;            // queries per tile
constexpr int LT = 16;             // leaves per tile
constexpr int MAX_D = 16;          // predicate columns
constexpr int SLOT_CHUNK = 2048;   // slots of a chunk (the order contract)
constexpr int STAGE_BYTES = 24576; // staged slot chunk, at most (one pass)
constexpr int BATCH = 8;           // loads in flight per thread (staging)
constexpr int LIST_CAP = 2 * QT * LT;  // pairs listed for walks, at most
constexpr int GQ_MIN = 64;         // queries a group, chunk tiles, at least
constexpr int LIST_MAX = 4096;     // walks listed a pass, chunk tiles (+ 1)
constexpr int MAX_DEVICES = 64;
constexpr int VARIANTS = 10;  // VW x (d = 0, 1, 2, 3), then the wide two
constexpr int WALK_WIN = 32;   // slots a window of the wide walks
constexpr int WALK_ROW = 36;   // floats a staged row of a window (16-byte)
constexpr int NEED_WORDS = CUT_COLS / 32;  // a round's needed columns
constexpr int BOX_D = 2 * WIDE_COLS;  // box columns a wide one pass keeps
constexpr int CUT_TILES = 4;  // query tiles a wide walk list holds
constexpr int SPARSE_MAX = 8;  // held slots a window tests one by one
constexpr int WALK_ROWS = LT;  // (leaf, window) rows of a wide walk stage
constexpr int WALK_X_BYTES = 32768;  // a wide walk's staged rows, at least
static_assert(WIDE_COLS == MAX_D, "the wide kernels' blocks are MAX_D");
static_assert(LT * WIDE_COLS == NT, "a thread a (leaf, column) of a block");
static_assert(NEED_WORDS == 32, "one warp lane a word of needed columns");
static_assert(CUT_COLS < 0xfffe, "a column fits a cut word's field");

// The tile's entry of plane m, query q, leaf l: [plane][q][leaf][WIDTH].
template <class Acc>
__device__ __forceinline__ float* tile_at(float* s_tile, int m, int q,
                                          int l) {
  return s_tile + ((m * QT + q) * LT + l) * Acc::WIDTH;
}

// dst[l * dst_stride + i] = src[l * src_stride + i] for l < nl, i < row;
// BATCH independent loads in flight per thread.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int nl, int row, size_t src_stride,
                                      int dst_stride) {
  const int total = nl * row;
  for (int base = threadIdx.x; base < total; base += NT * BATCH) {
    T r[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        const int l = i / row;
        r[u] = src[(size_t)l * src_stride + (i - l * row)];
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        const int l = i / row;
        dst[l * dst_stride + (i - l * row)] = r[u];
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Copy nbytes from src (global) to dst (shared), both 16-byte aligned:
// 16-byte cp.async for the body, byte loads for the tail. The caller
// commits, waits and syncs.
__device__ __forceinline__ void copy_run(void* dst, const void* src,
                                         int nbytes) {
  const int n16 = nbytes >> 4;
  for (int i = threadIdx.x; i < n16; i += NT)
    cp_async16((char*)dst + 16 * i, (const char*)src + 16 * i);
  for (int i = (n16 << 4) + threadIdx.x; i < nbytes; i += NT)
    ((uint8_t*)dst)[i] = ((const uint8_t*)src)[i];
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Copy nbytes from src (global) to dst (shared, 16-byte aligned): 16-byte
// cp.async where src is 16-byte aligned too, 4-byte cp.async where it is
// 4-byte aligned, byte loads otherwise and for the tail. The caller
// commits, waits and syncs.
__device__ __forceinline__ void copy_any(void* dst, const void* src,
                                         int nbytes) {
  const uintptr_t at = (uintptr_t)src;
  if ((at & 15) == 0) {
    copy_run(dst, src, nbytes);
    return;
  }
  const int body = (at & 3) == 0 ? nbytes & ~3 : 0;
  for (int i = 4 * threadIdx.x; i < body; i += 4 * NT)
    cp_async4((char*)dst + i, (const char*)src + i);
  for (int i = body + threadIdx.x; i < nbytes; i += NT)
    ((uint8_t*)dst)[i] = ((const uint8_t*)src)[i];
}

// A query box (ql, qh) against a box (blo, bhi) of the valid samples, by
// the slot test's own compares: covered iff it holds the box and no valid
// slot has a NaN coordinate (`no_nan`), apart iff they are apart in some
// column; mixed iff neither. Both chunk phases call it on the same bits.
__device__ __forceinline__ void classify(const float* ql, const float* qh,
                                         const float* blo, const float* bhi,
                                         bool no_nan, int d, bool* inside,
                                         bool* apart) {
  bool in = no_nan, ap = false;
#pragma unroll
  for (int j = 0; j < MAX_D; ++j) {
    if (j < d) {
      in &= (ql[j] <= blo[j]) & (bhi[j] <= qh[j]);
      ap |= (qh[j] < blo[j]) | (bhi[j] < ql[j]);
    }
  }
  *inside = in;
  *apart = ap;
}

// Fold n slots of a staged chunk into w in slot order: slot i is relevant
// iff inside (ql, qh) in every column (an invalid slot carries NaN in
// column 0, which no bound holds). Four slots a step by vector loads, the
// next step's loaded while one is folded.
template <class Acc, int D>
__device__ __forceinline__ void walk_chunk(Acc& w, const float* av,
                                           const float* cl, int n, int d,
                                           const float* ql,
                                           const float* qh) {
  int i = 0;
  if (D > 0) {
    constexpr int W = D > 0 ? D : 1;
    const int n4 = n & ~3;
    float4 a4, c4[W];
    if (n4 > 0) {
      a4 = *reinterpret_cast<const float4*>(av);
#pragma unroll
      for (int t = 0; t < W; ++t)
        c4[t] = reinterpret_cast<const float4*>(cl)[t];
    }
    for (; i < n4; i += 4) {
      float4 na4, nc4[W];
      const int nx = i + 4 < n4 ? i + 4 : i;
      na4 = *reinterpret_cast<const float4*>(av + nx);
#pragma unroll
      for (int t = 0; t < W; ++t)
        nc4[t] = reinterpret_cast<const float4*>(cl + nx * W)[t];
      float x[4 * W];
#pragma unroll
      for (int t = 0; t < W; ++t) {
        x[4 * t] = c4[t].x;
        x[4 * t + 1] = c4[t].y;
        x[4 * t + 2] = c4[t].z;
        x[4 * t + 3] = c4[t].w;
      }
      bool in[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        in[u] = true;
#pragma unroll
        for (int j = 0; j < W; ++j)
          in[u] &= (ql[j] <= x[u * W + j]) & (x[u * W + j] <= qh[j]);
      }
      w.add(a4.x, in[0]);
      w.add(a4.y, in[1]);
      w.add(a4.z, in[2]);
      w.add(a4.w, in[3]);
      a4 = na4;
#pragma unroll
      for (int t = 0; t < W; ++t) c4[t] = nc4[t];
    }
  }
  for (; i < n; ++i) {
    bool in = true;
#pragma unroll
    for (int j = 0; j < MAX_D; ++j) {
      if (j < d) {
        const float x = cl[i * d + j];
        in &= (ql[j] <= x) & (x <= qh[j]);
      }
    }
    w.add(av[i], in);
  }
}

// The tile's rows out of shared memory, every plane: nq rows of nur store
// units of VW floats (NUR > 0 fixes nur at compile time), row_pitch
// floats apart, each plane `plane` floats after the one before.
template <class Acc, int VW, int NUR>
__device__ __forceinline__ void store_tile(const float* s_tile, float* ob,
                                           int nq, int nur_rt,
                                           size_t row_pitch, size_t plane) {
  static_assert(Acc::PLANES == 1 || Acc::PLANES == 2, "one or two planes");
  const int nur = NUR > 0 ? NUR : nur_rt;
  for (int u = threadIdx.x; u < Acc::PLANES * nq * nur; u += NT) {
    const int m = Acc::PLANES == 1 ? 0 : u >= nq * nur;
    const int r = u - m * nq * nur;
    const int q = r / nur, col = (r - q * nur) * VW;
    const float* src = s_tile + (m * QT + q) * LT * Acc::WIDTH + col;
    float* dst = ob + m * plane + q * row_pitch + col;
    if (VW == 4)
      *reinterpret_cast<float4*>(dst) =
          *reinterpret_cast<const float4*>(src);
    else
      *dst = *src;
  }
}

// One launch's grid and shared-memory carve-up (bytes).
struct Plan {
  int sc;    // slots per staged chunk
  int runs;  // one chunk and 16-byte aligned inputs: each staged array is
             // one contiguous run, copied with 16-byte cp.async
  int n_qt;  // query tiles
  int groups;  // query groups: the blocks of one leaf tile
  int n_blocks;
  int off_c, off_a, off_v, off_q, off_box, off_stat, off_nan, off_list,
      off_count, bytes;
};

int align16(long long x) { return (int)((x + 15) & ~15LL); }

template <class Acc>
bool make_plan(int Q, int k, int s, int d, bool aligned, Plan* plan) {
  Plan p;
  const long long per_slot = (long long)LT * (4 * d + 5);
  p.sc = (long long)s * per_slot <= STAGE_BYTES
             ? (s > 0 ? s : 1)
             : (int)(STAGE_BYTES / per_slot);
  p.runs = aligned && s > 0 && p.sc == s;
  long long off = 0;
  off = align16(off + 4LL * Acc::PLANES * Acc::WIDTH * QT * LT);
  p.off_c = (int)off;     off = align16(off + 4LL * LT * p.sc * d);
  p.off_a = (int)off;     off = align16(off + 4LL * LT * p.sc);
  p.off_v = (int)off;     off = align16(off + (long long)LT * p.sc);
  p.off_q = (int)off;     off = align16(off + 2 * 8LL * QT * d);
  p.off_box = (int)off;   off = align16(off + 8LL * LT * d);
  p.off_stat = (int)off;  off = align16(off + 4LL * Acc::STATS * LT);
  p.off_nan = (int)off;   off = align16(off + 4LL * LT);
  p.off_list = (int)off;  off = align16(off + 2LL * LIST_CAP);
  p.off_count = (int)off; off = align16(off + 4);
  p.bytes = (int)off;
  const long long n_qt = (Q + QT - 1) / QT, n_lt = (k + LT - 1) / LT;
  if (n_qt * n_lt > 0x7fffffffLL) return false;
  p.n_qt = (int)n_qt;
  p.groups = 1;
  p.n_blocks = (int)n_lt;
  *plan = p;
  return true;
}

// The query groups: as many as keep every block resident at once
// (`resident` blocks on the card) so that the grid runs in one wave, at
// least one and at most one per query tile; each leaf tile's reductions
// are computed once per group.
void set_groups(int k, long long resident, Plan* p) {
  const long long n_lt = (k + LT - 1) / LT;
  long long groups = resident / n_lt;
  groups = groups < 1 ? 1 : groups > p->n_qt ? p->n_qt : groups;
  p->groups = (int)groups;
  p->n_blocks = (int)(n_lt * groups);  // <= n_lt * n_qt < 2**31
}

// One block per (leaf tile of LT leaves, query group): the leaves'
// reductions and boxes once, then every QT-query tile qt = group,
// group + groups, ... of the group. VW floats per store (4 when k is a
// multiple of 4, else 1); D > 0 fixes d at compile time.
template <class Acc, int VW, int D>
__global__ void __launch_bounds__(NT)
pair_tile_kernel(const float* __restrict__ c, const float* __restrict__ a,
                 const uint8_t* __restrict__ valid,
                 const float* __restrict__ q_lo,
                 const float* __restrict__ q_hi, float* __restrict__ out,
                 int Q, int k, int s, int d, Plan p) {
  if (D > 0) d = D;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tile = (float*)smem;                    // tile_at()
  float* s_c = (float*)(smem + p.off_c);           // [leaf][slot][d]
  float* s_a = (float*)(smem + p.off_a);           // [leaf][slot]
  uint8_t* s_v = smem + p.off_v;                   // [leaf][slot]
  float* s_q = (float*)(smem + p.off_q);  // [buffer][lo, hi][q][d]
  float* s_box = (float*)(smem + p.off_box);       // [leaf][lo, hi][d]
  float* s_stat = (float*)(smem + p.off_stat);     // [leaf][STATS]
  int* s_nan = (int*)(smem + p.off_nan);           // [leaf]
  uint16_t* s_list = (uint16_t*)(smem + p.off_list);  // pairs to walk
  int* s_count = (int*)(smem + p.off_count);

  const int tid = threadIdx.x;
  const int group = blockIdx.x % p.groups;
  const int leaf0 = (blockIdx.x / p.groups) * LT;
  const int nl = min(LT, k - leaf0);
  const int sc = p.sc;
  const size_t plane = (size_t)Q * k * Acc::WIDTH;

  // The queries of tile qt into buffer buf: cp.async when the arrays are
  // runs (the caller commits and waits), else loads.
  auto load_queries = [&](int qt, int buf) {
    const int q0 = qt * QT, n = min(QT, Q - q0) * d;
    float* dst = s_q + buf * 2 * QT * d;
    if (p.runs) {
      copy_run(dst, q_lo + (size_t)q0 * d, n * 4);
      copy_run(dst + QT * d, q_hi + (size_t)q0 * d, n * 4);
    } else {
      stage(dst, q_lo + (size_t)q0 * d, 1, n, 0, 0);
      stage(dst + QT * d, q_hi + (size_t)q0 * d, 1, n, 0, 0);
    }
  };
  if (tid < LT) s_nan[tid] = 0;
  if (tid == 0) *s_count = 0;

  // 1-2. Reductions (thread l < nl: leaf l) and boxes (thread (tid + 32) %
  // NT: pair (leaf, column) = divmod(that, d)) over the chunks in slot
  // order.
  Acc acc;
  acc.init();
  const int bp = (tid + 32) % NT;
  const bool box_owner = bp < nl * d;
  const int bl = box_owner ? bp / d : 0, bj = box_owner ? bp - bl * d : 0;
  const float inf = __int_as_float(0x7f800000);
  float lo = inf, hi = -inf;
  bool nan = false;
  auto reduce_and_box = [&](int n) {
    if (tid < nl) {
      const uint8_t* v = s_v + tid * sc;
      const float* av = s_a + tid * sc;
#pragma unroll 8
      for (int i = 0; i < n; ++i) acc.add(av[i], v[i] != 0);
    }
    if (box_owner) {
      const uint8_t* v = s_v + bl * sc;
      const float* cl = s_c + bl * sc * d + bj;
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const bool on = v[i] != 0;
        const float x = cl[i * d];
        nan |= on & (x != x);
        lo = fminf(lo, on ? x : inf);
        hi = fmaxf(hi, on ? x : -inf);
      }
    }
  };
  const int n_ch = (s + sc - 1) / sc;
  auto stage_chunk = [&](int s0, int n) {
    stage(s_c, c + ((size_t)leaf0 * s + s0) * d, nl, n * d, (size_t)s * d,
          sc * d);
    stage(s_a, a + (size_t)leaf0 * s + s0, nl, n, (size_t)s, sc);
    stage(s_v, valid + (size_t)leaf0 * s + s0, nl, n, (size_t)s, sc);
  };
  if (p.runs) {
    copy_run(s_c, c + (size_t)leaf0 * s * d, nl * s * d * 4);
    copy_run(s_a, a + (size_t)leaf0 * s, nl * s * 4);
    copy_run(s_v, valid + (size_t)leaf0 * s, nl * s);
    load_queries(group, 0);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    reduce_and_box(s);
  } else {
    for (int ch = 0; ch < n_ch; ++ch) {
      const int s0 = ch * sc, n = min(sc, s - s0);
      __syncthreads();  // the previous chunk is no longer read
      stage_chunk(s0, n);
      __syncthreads();
      reduce_and_box(n);
    }
  }
  if (tid < nl) acc.save(s_stat + tid * Acc::STATS);
  if (box_owner) {
    s_box[bl * 2 * d + bj] = lo;
    s_box[bl * 2 * d + d + bj] = hi;
    if (nan) s_nan[bl] = 1;
  }

  // 5. The walks of the listed pairs, one thread each, all at once: in
  // slot order from init() over the leaf's slots, staged in shared memory
  // when they are one chunk, else read from global memory (L2), written
  // straight to `out` over the empty result the tile store left there. An
  // entry is (tile since it_base << 11 | query in the tile << 4 | leaf).
  int it_base = 0;
  const bool staged = n_ch == 1;
  auto walk_all = [&](int n_walk) {
    for (int e = tid; e < n_walk; e += NT) {
      const int ent = s_list[e];
      const int l = ent & (LT - 1);
      const int qt = (it_base + (ent >> 11)) * p.groups + group;
      const int q = qt * QT + ((ent >> 4) & (QT - 1));
      float ql[MAX_D], qh[MAX_D];
#pragma unroll
      for (int j = 0; j < MAX_D; ++j) {
        ql[j] = j < d ? q_lo[(size_t)q * d + j] : 0.f;
        qh[j] = j < d ? q_hi[(size_t)q * d + j] : 0.f;
      }
      const size_t o = (size_t)(leaf0 + l) * s;
      const uint8_t* v = staged ? s_v + l * sc : valid + o;
      const float* av = staged ? s_a + l * sc : a + o;
      const float* cl = staged ? s_c + l * sc * d : c + o * d;
      Acc w;
      w.init();
#pragma unroll 8
      for (int i = 0; i < s; ++i) {
        bool in = v[i] != 0;
#pragma unroll
        for (int j = 0; j < MAX_D; ++j) {
          if (j < d) {
            const float x = cl[i * d + j];
            in &= (ql[j] <= x) & (x <= qh[j]);
          }
        }
        w.add(av[i], in);
      }
      w.write(out, (size_t)q * k + leaf0 + l, plane);
    }
  };

  for (int it = 0, qt = group; qt < p.n_qt; ++it, qt += p.groups) {
    const int q0 = qt * QT, nq = min(QT, Q - q0);
    const int buf = it & 1;
    const float* sq_lo = s_q + buf * 2 * QT * d;
    const float* sq_hi = sq_lo + QT * d;
    if (p.runs) {
      // The next tile's queries arrive while this one is served.
      if (qt + p.groups < p.n_qt) load_queries(qt + p.groups, buf ^ 1);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      load_queries(qt, buf);
    }
    __syncthreads();

    // 3. Classes: covered pairs take the leaf's reduction, the rest the
    // empty one, and the ones not apart from the box go to the walk list.
    // Thread tid takes leaf tid % LT for queries tid / LT, + NT / LT, ...
    {
      const int l = tid % LT;
      if (l < nl) {
        float blo[MAX_D], bhi[MAX_D];
#pragma unroll
        for (int j = 0; j < MAX_D; ++j) {
          blo[j] = j < d ? s_box[l * 2 * d + j] : 0.f;
          bhi[j] = j < d ? s_box[l * 2 * d + d + j] : 0.f;
        }
        const bool no_nan = s_nan[l] == 0;
        Acc leaf;
        leaf.load(s_stat + l * Acc::STATS);
        for (int q = tid / LT; q < nq; q += NT / LT) {
          bool inside = no_nan, apart = false;
#pragma unroll
          for (int j = 0; j < MAX_D; ++j) {
            if (j < d) {
              const float ql = sq_lo[q * d + j], qh = sq_hi[q * d + j];
              inside &= (ql <= blo[j]) & (bhi[j] <= qh);
              apart |= (qh < blo[j]) | (bhi[j] < ql);
            }
          }
          leaf.fill(s_tile, q, l, inside);
          if (!inside && !apart)
            s_list[atomicAdd(s_count, 1)] =
                (uint16_t)((it - it_base) << 11 | q << 4 | l);
        }
      }
    }
    __syncthreads();

    // 4. The tile goes out as rows of nl * WIDTH contiguous floats a plane.
    constexpr int W = Acc::WIDTH;
    float* ob = out + ((size_t)q0 * k + leaf0) * W;
    if (nl == LT)
      store_tile<Acc, VW, LT * W / VW>(s_tile, ob, nq, 0, (size_t)k * W,
                                       plane);
    else
      store_tile<Acc, VW, 0>(s_tile, ob, nq, nl * W / VW, (size_t)k * W,
                             plane);
    __syncthreads();  // the tile is free again; its stores precede walks

    // The list is walked when the next tile's pairs might not fit, when
    // its tile field would overflow, and after the last tile.
    const int n_walk = *s_count;
    if (n_walk > LIST_CAP - QT * LT || it + 1 - it_base == 32 ||
        qt + p.groups >= p.n_qt) {
      walk_all(n_walk);
      __syncthreads();
      if (tid == 0) *s_count = 0;
      it_base = it + 1;
    }
  }
}

__host__ __device__ constexpr int al16(int x) { return (x + 15) & ~15; }

// The wide walks' shared memory besides the staged rows: the window's
// values and valid bits of each leaf, the round's needed columns (by
// round parity: a round clears the other buffer for the next), the set
// bits before each word of them, the needed columns in order, the flags.
struct WalkRoom {
  float* x;        // the staged rows: [leaf][column][WALK_ROW]
  int x_floats;    // their room
  float* a;        // [leaf][window][WALK_WIN] the stage's values
  uint32_t* v;     // [leaf][window] their valid bits
  uint32_t* need;  // [parity][NEED_WORDS] the round's cut columns
  int* pre;        // [NEED_WORDS] columns needed before each word
  uint16_t* col;   // [CUT_COLS] the needed columns in order
  int* misc;       // [parity]: a pair tests every column; [2]: columns
};

__host__ __device__ constexpr int walk_room_bytes() {
  return al16(4 * WALK_ROWS * WALK_WIN) + al16(4 * WALK_ROWS) +
         al16(8 * NEED_WORDS) + al16(4 * NEED_WORDS) + al16(2 * CUT_COLS) +
         16;
}

__device__ __forceinline__ WalkRoom walk_room(unsigned char* at, float* x,
                                              int x_floats) {
  WalkRoom r;
  r.x = x;
  r.x_floats = x_floats;
  r.a = (float*)at;       at += al16(4 * WALK_ROWS * WALK_WIN);
  r.v = (uint32_t*)at;    at += al16(4 * WALK_ROWS);
  r.need = (uint32_t*)at; at += al16(8 * NEED_WORDS);
  r.pre = (int*)at;       at += al16(4 * NEED_WORDS);
  r.col = (uint16_t*)at;  at += al16(2 * CUT_COLS);
  r.misc = (int*)at;
  return r;
}

// No column needed, before the first round (a __syncthreads follows).
__device__ __forceinline__ void clear_walk_room(const WalkRoom& r) {
  for (int i = threadIdx.x; i < 2 * NEED_WORDS; i += NT) r.need[i] = 0u;
  if (threadIdx.x < 3) r.misc[threadIdx.x] = 0;
}

// One round of the wide walks, every thread of the block (on: it holds a
// pair): the pair of leaf row lr of the round's nlr leaves, whose slots i
// < ns sit at rows lr * ls + i of c0 (d floats a row), a0 and v0 (global
// memory), with cut word cw and query bounds ql / qh (nullptr: the
// unbounded box), folded into w in slot order. For each window of
// WALK_WIN slots the block stages the leaves' values and valid bits and
// the columns the round's pairs need (the union of their cut columns, or
// every column if one pair tests every column) column-major, as many a
// stage as the room holds, every copy of a stage in flight at once
// (cp.async); a pair ANDs its valid bits with the row bits of its own cut
// columns (wide_cols.cuh: the others change no bit), then adds the
// window's slots in order. par: the round's parity.
template <class Acc>
__device__ void walk_wide(Acc& w, bool on, int lr, uint64_t cw,
                          const float* __restrict__ ql,
                          const float* __restrict__ qh,
                          const float* __restrict__ c0,
                          const float* __restrict__ a0,
                          const uint8_t* __restrict__ v0, size_t ls, int nlr,
                          int ns, int d, const WalkRoom& r, int par) {
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  const bool every = on && cw == CUT_ALL;
  uint32_t* need = r.need + par * NEED_WORDS;
  // 1. The round's columns: a word of them at a time, ORed over the warp
  // first, so that one lane a warp sets them.
  if (every) r.misc[par] = 1;
  const int n_words = min(NEED_WORDS, (d + 31) / 32);
  for (int wd = 0; wd < n_words; ++wd) {
    uint32_t bits = 0u;
#pragma unroll
    for (int t = 0; t < CUT_MAX; ++t) {
      const int j = cut_col(cw, t);
      if (on && !every && j < CUT_COLS && j >> 5 == wd)
        bits |= 1u << (j & 31);
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (bits != 0u && tid % 32 == 0) atomicOr(&need[wd], bits);
  }
  __syncthreads();
  const bool all = r.misc[par] != 0;
  if (tid < 32) {
    const uint32_t word = all ? 0u : need[tid];
    const int cnt = __popc(word);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += y;
    }
    int at = incl - cnt;
    r.pre[tid] = at;
    for (uint32_t b = word; b != 0u; b &= b - 1u)
      r.col[at++] = (uint16_t)(tid * 32 + __ffs(b) - 1);
    if (tid == 31) r.misc[2] = all ? d : incl;
    r.need[(par ^ 1) * NEED_WORDS + tid] = 0u;
    if (tid == 0) r.misc[par ^ 1] = 0;
  }
  __syncthreads();
  const int nu = r.misc[2];
  // 2. The staged position and the bounds of each of the pair's columns.
  int pos[CUT_MAX];
  float lo[CUT_MAX], hi[CUT_MAX];
#pragma unroll
  for (int t = 0; t < CUT_MAX; ++t) {
    const int j = cut_col(cw, t);
    const bool use = on && !every && j < CUT_COLS;
    pos[t] = !use ? -1
             : all ? j
                   : r.pre[j >> 5] +
                         __popc(need[j >> 5] & ((1u << (j & 31)) - 1u));
    lo[t] = use && ql != nullptr ? ql[j] : -inf;
    hi[t] = use && qh != nullptr ? qh[j] : inf;
  }
  // 3. The windows, nw at once when the room holds every needed column of
  // the round's leaves for them (a stage), else one at a time with the
  // columns in stages of `room`.
  const int cap = r.x_floats / WALK_ROW;  // staged rows the room holds
  int room = min(NT, cap / nlr), wps = 1;
  if (nu <= room) {
    room = max(nu, 1);
    wps = max(1, min(WALK_ROWS / nlr, cap / (nlr * room)));
  }
  for (int i0 = 0; i0 < ns; i0 += wps * WALK_WIN) {
    const int nw = min(wps, (ns - i0 + WALK_WIN - 1) / WALK_WIN);
    const int rows = nlr * nw * WALK_WIN;  // (leaf, window, slot) <= 2 NT
    __syncthreads();  // the previous windows' values and rows are read
    // The leaves' values (cp.async) and valid bits (a warp a leaf's
    // window), whose loads go out with the first stage's.
    bool vv[2];
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int t = tid + z * NT;
      const int i = i0 + t % (nw * WALK_WIN);
      const size_t at = t / (nw * WALK_WIN) * ls + i;
      const bool in = t < rows && i < ns;
      if (in) cp_async4(r.a + t, a0 + at);
      vv[z] = in && v0[at] != 0;
    }
    uint32_t m = 0u;  // one window's bits across stages of columns
    for (int u0 = 0;; u0 += room) {
      const int nuc = min(room, nu - u0);  // columns of this stage
      if (u0 > 0) __syncthreads();  // the previous stage's rows are read
      if (nuc > 0) {
        // [leaf][column][window][slot] by cp.async, every copy in flight
        // at once: a thread one column, slots step apart.
        const int step = NT / nuc, u = tid % nuc;
        if (tid < step * nuc) {
          const float* src = c0 + (all ? u0 + u : r.col[u0 + u]);
          for (int l = 0; l < nlr; ++l)
            for (int k = tid / nuc; k < nw * WALK_WIN && i0 + k < ns;
                 k += step)
              cp_async4(r.x + ((l * nuc + u) * nw + k / WALK_WIN) * WALK_ROW +
                            k % WALK_WIN,
                        src + (l * ls + i0 + k) * (size_t)d);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      if (u0 == 0) {
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          const int t = tid + z * NT;
          if (t < rows) {
            const uint32_t bits = __ballot_sync(0xffffffffu, vv[z]);
            if (t % WALK_WIN == 0) r.v[t / WALK_WIN] = bits;
          }
        }
      }
      __syncthreads();
      const bool last = u0 + room >= nu;
      for (int wi = 0; wi < nw; ++wi) {
        uint32_t mw = u0 > 0 ? m : on ? r.v[lr * nw + wi] : 0u;
        if (nuc > 0) {
          const float* xl = r.x + (lr * nuc * nw + wi) * WALK_ROW;
          if (every && mw != 0u) {
            for (int u = 0; u < nuc && mw != 0u; ++u) {
              const int j = u0 + u;
              mw &= row_bits(xl + u * nw * WALK_ROW,
                             ql != nullptr ? ql[j] : -inf,
                             qh != nullptr ? qh[j] : inf);
            }
          }
          // A pair's own columns (pos is -1 past them and for every-column
          // pairs): the whole row while a lane of the warp holds more than
          // SPARSE_MAX slots, else only the slots still held.
#pragma unroll
          for (int t = 0; t < CUT_MAX; ++t) {
            const int u = pos[t] - u0;
            const bool use = mw != 0u && pos[t] >= 0 && u >= 0 && u < nuc;
            const bool dense =
                __any_sync(0xffffffffu, use && __popc(mw) > SPARSE_MAX);
            const float* row = xl + u * nw * WALK_ROW;
            if (use)
              mw = dense ? mw & row_bits(row, lo[t], hi[t])
                         : held_bits(row, mw, lo[t], hi[t]);
          }
        }
        m = mw;
        // The window's relevant slots in slot order, then one irrelevant
        // slot for all the others: one adds +0.0 to row 2's sums, which
        // changes no bit (a sum from +0.0 never holds -0.0), and the empty
        // terms to row 8's fold, which is order-free and takes a term once
        // or n times alike.
        if (last && on) {
          const float* ar = r.a + (lr * nw + wi) * WALK_WIN;
          for (uint32_t b = mw; b != 0u; b &= b - 1u)
            w.add(ar[__ffs(b) - 1], true);
          if (__popc(mw) < min(WALK_WIN, ns - i0 - wi * WALK_WIN))
            w.add(0.f, false);
        }
      }
      if (last) break;
    }
  }
}

// The wide one pass's shared-memory carve-up (bytes), the same at every
// d: the tile, over which lie a column block's query bounds (two planes of
// QT x WIDE_COLS) and the walks' staged rows; the leaves' box columns
// (all of them up to BOX_D columns, else a block's) and their NaN flags,
// the leaves' reductions and flags; the walk list in LT buckets of a
// leaf's pairs (tags) and their counts; the cut words of the listed
// tiles' queries (CUT_TILES x QT); the tile's box (its leaves' boxes
// folded) and each query's columns that hold it; the walk's room.
template <class Acc>
struct WideTile {
  static constexpr int tile = 4 * Acc::PLANES * Acc::WIDTH * QT * LT;
  static constexpr int room = tile > 8 * QT * WIDE_COLS ? tile
                                                        : 8 * QT * WIDE_COLS;
  static constexpr int box =
      al16(room > WALK_X_BYTES ? room : WALK_X_BYTES);
  static constexpr int cnan = al16(box + 8 * LT * BOX_D);
  static constexpr int stat = al16(cnan + LT * BOX_D);
  static constexpr int nan = al16(stat + 4 * Acc::STATS * LT);
  static constexpr int list = al16(nan + 4 * LT);
  static constexpr int count = al16(list + 2 * LIST_CAP);
  static constexpr int cut = al16(count + 4 * LT);
  static constexpr int tbox = al16(cut + 8 * CUT_TILES * QT);
  static constexpr int hold = al16(tbox + 8 * BOX_D);
  static constexpr int walk = al16(hold + 4 * QT);
  static constexpr int bytes = walk + walk_room_bytes();
};

template <class Acc>
bool make_wide_plan(int Q, int k, Plan* plan) {
  Plan p = {};
  p.bytes = WideTile<Acc>::bytes;
  const long long n_qt = (Q + QT - 1) / QT, n_lt = (k + LT - 1) / LT;
  if (n_qt * n_lt > 0x7fffffffLL) return false;
  p.n_qt = (int)n_qt;
  p.groups = 1;
  p.n_blocks = (int)n_lt;
  *plan = p;
  return true;
}

// The one pass at d > MAX_D (s <= SLOT_CHUNK): pair_tile_kernel's blocks,
// classes, tiles and stores, with the columns in blocks of WIDE_COLS and
// the walks of walk_wide (design above, "Any d"). Held to 64 registers a
// thread, so that four blocks share a multiprocessor (shared memory
// allows it).
template <class Acc, int VW>
__global__ void __launch_bounds__(NT, 4)
pair_tile_wide_kernel(const float* __restrict__ c,
                      const float* __restrict__ a,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ q_lo,
                      const float* __restrict__ q_hi,
                      float* __restrict__ out, int Q, int k, int s, int d,
                      Plan p) {
  using L = WideTile<Acc>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tile = (float*)smem;            // tile_at()
  float* s_q = (float*)smem;               // [lo, hi][q][WIDE_COLS]
  float* s_box = (float*)(smem + L::box);  // [leaf][lo, hi][BOX_D]
  uint8_t* s_cnan = smem + L::cnan;        // [leaf][BOX_D]
  float* s_stat = (float*)(smem + L::stat);        // [leaf][STATS]
  int* s_nan = (int*)(smem + L::nan);              // [leaf]
  uint16_t* s_list = (uint16_t*)(smem + L::list);  // [leaf][BUCKET] tags
  int* s_count = (int*)(smem + L::count);          // [leaf]
  uint64_t* s_cut = (uint64_t*)(smem + L::cut);    // [tile][QT] cut words
  float* s_tbox = (float*)(smem + L::tbox);        // [lo, hi][BOX_D]
  unsigned* s_hold = (unsigned*)(smem + L::hold);  // [QT]
  const WalkRoom room = walk_room(smem + L::walk, (float*)smem, L::box / 4);
  constexpr int PQ = QT * LT / NT;  // pairs a thread classifies
  constexpr int BUCKET = LIST_CAP / LT;  // a leaf's listed pairs, at most

  const int tid = threadIdx.x;
  const int group = blockIdx.x % p.groups;
  const int leaf0 = (blockIdx.x / p.groups) * LT;
  const int nl = min(LT, k - leaf0);
  const size_t plane = (size_t)Q * k * Acc::WIDTH;
  const float inf = __int_as_float(0x7f800000);
  if (tid < LT) {
    s_nan[tid] = 0;
    s_count[tid] = 0;
  }
  clear_walk_room(room);

  // 1. The leaves' reductions, thread l < nl over leaf l's slots in slot
  // order, from L2.
  if (tid < nl) {
    const size_t o = (size_t)(leaf0 + tid) * s;
    Acc acc;
    acc.init();
#pragma unroll 8
    for (int i = 0; i < s; ++i) acc.add(a[o + i], valid[o + i] != 0);
    acc.save(s_stat + tid * Acc::STATS);
  }

  // 5. The walks of the listed pairs in rounds of NT, a thread a pair, in
  // the buckets' order (leaf by leaf), so that a round's pairs share few
  // leaves: walk_wide over those leaves' slots, with the cut word of the
  // pair's query.
  int it_base = 0, rounds = 0;
  auto locate = [&](int e, int* l) {
    int at = 0, ll = 0;
    while (ll < LT - 1 && e >= at + s_count[ll]) at += s_count[ll++];
    *l = ll;
    return e - at;
  };
  auto walk_all = [&](int n_walk) {
    for (int r0 = 0; r0 < n_walk; r0 += NT, ++rounds) {
      const int e = r0 + tid;
      const bool on = e < n_walk;
      int la, lb, l = 0, q = 0;
      uint64_t cw = CUT_ALL;
      locate(r0, &la);
      locate(min(r0 + NT, n_walk) - 1, &lb);
      if (on) {
        const int at = locate(e, &l);
        const int ent = s_list[l * BUCKET + at];
        cw = s_cut[(ent >> 11) * QT + ((ent >> 4) & (QT - 1))];
        const int qt = (it_base + (ent >> 11)) * p.groups + group;
        q = qt * QT + ((ent >> 4) & (QT - 1));
      }
      const size_t o = (size_t)(leaf0 + la) * s;
      Acc w;
      w.init();
      walk_wide<Acc>(w, on, on ? l - la : 0, cw, q_lo + (size_t)q * d,
                     q_hi + (size_t)q * d, c + o * d, a + o, valid + o,
                     (size_t)s, lb - la + 1, s, d, room, rounds & 1);
      if (on) w.write(out, (size_t)q * k + leaf0 + l, plane);
    }
  };

  // The box thread's (leaf, column) of a block; the classes' leaf.
  const int bl = tid / WIDE_COLS, bj = tid - bl * WIDE_COLS;
  const int pl = tid % LT;
  const bool keep_cuts = d <= CUT_COLS, box_once = d <= BOX_D;
  for (int it = 0, qt = group; qt < p.n_qt; ++it, qt += p.groups) {
    const int q0 = qt * QT, nq = min(QT, Q - q0);
    uint64_t* cut = s_cut + (it - it_base) * QT;  // this tile's queries'
    if (tid < QT) cut[tid] = keep_cuts ? CUT_NONE : CUT_ALL;
    // 3. Classes, a column block at a time: bit i of in_b / ap_b is the
    // pair (query tid / LT + i * NT / LT, leaf tid % LT) inside in every
    // block so far / apart in some block. A query's cut word takes the
    // columns that cut any of its pairs with the tile's leaves (wide_cols.
    // cuh), ORed over the 16 lanes of its pairs.
    unsigned in_b = (1u << PQ) - 1u, ap_b = 0u;
    for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
      const int nj = min(WIDE_COLS, d - j0);
      const int jb = box_once ? j0 : 0;  // the block's place in the boxes
      __syncthreads();  // the previous block's bounds (or the tile) read
      for (int i = tid; i < nq * WIDE_COLS; i += NT) {
        const size_t at = (size_t)(q0 + i / WIDE_COLS) * d + j0 +
                          i % WIDE_COLS;
        if (i % WIDE_COLS < nj) {
          cp_async4(s_q + i, q_lo + at);
          cp_async4(s_q + QT * WIDE_COLS + i, q_hi + at);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
      // The boxes: every column's once a block up to BOX_D columns (a
      // thread two columns), else the block's for each tile.
      const bool box_now = box_once ? it == 0 && j0 == 0 : true;
      const int n_box = box_once ? d : nj;  // box columns, from jb on
      if (box_now && bl < nl && bj < n_box) {
        const size_t o = (size_t)(leaf0 + bl) * s;
        const int j2 = bj + WIDE_COLS < n_box ? bj + WIDE_COLS : bj;
        float lo = inf, hi = -inf, lo2 = inf, hi2 = -inf;
        bool nan = false, nan2 = false;
#pragma unroll 8
        for (int i = 0; i < s; ++i) {
          const bool on = valid[o + i] != 0;
          const float x = c[(o + i) * d + j0 + bj];
          const float x2 = c[(o + i) * d + j0 + j2];
          nan |= on & (x != x);
          lo = fminf(lo, on ? x : inf);
          hi = fmaxf(hi, on ? x : -inf);
          nan2 |= on & (x2 != x2);
          lo2 = fminf(lo2, on ? x2 : inf);
          hi2 = fmaxf(hi2, on ? x2 : -inf);
        }
        s_box[bl * 2 * BOX_D + jb + bj] = lo;
        s_box[(bl * 2 + 1) * BOX_D + jb + bj] = hi;
        s_cnan[bl * BOX_D + jb + bj] = nan;
        s_box[bl * 2 * BOX_D + jb + j2] = lo2;
        s_box[(bl * 2 + 1) * BOX_D + jb + j2] = hi2;
        s_cnan[bl * BOX_D + jb + j2] = nan2;
        if (nan || nan2) s_nan[bl] = 1;
      }
      asm volatile("cp.async.wait_group 0;\n" ::);
      if (box_now) {
        // The tile's box: the leaves' boxes folded (fminf / fmaxf; an
        // empty leaf's (+inf, -inf) changes nothing), a thread a (column,
        // side).
        __syncthreads();
        if (tid < 2 * BOX_D && tid % BOX_D < n_box) {
          const int j = tid % BOX_D, side = tid / BOX_D;
          float x = side ? -inf : inf;
          for (int l = 0; l < nl; ++l) {
            const float y = s_box[(l * 2 + side) * BOX_D + jb + j];
            x = side ? fmaxf(x, y) : fminf(x, y);
          }
          s_tbox[side * BOX_D + jb + j] = x;
        }
      }
      __syncthreads();
      // The block's columns where a query holds the tile's box: there it
      // holds every leaf's box and is apart from none (an empty leaf's
      // pairs are inside in every column whatever apart says), so the
      // pairs' compares skip them.
      if (tid < nq) {
        unsigned h = 0u;
        for (int j = 0; j < nj; ++j)
          h |= (unsigned)((s_q[tid * WIDE_COLS + j] <= s_tbox[jb + j]) &
                          (s_tbox[BOX_D + jb + j] <=
                           s_q[(QT + tid) * WIDE_COLS + j])) << j;
        s_hold[tid] = h;
      }
      __syncthreads();
      const bool act = pl < nl;
      const float* blo = s_box + pl * 2 * BOX_D + jb;
      const float* bhi = blo + BOX_D;
      unsigned cn = 0u;  // the block's columns with a NaN on a valid slot
#pragma unroll
      for (int j = 0; j < WIDE_COLS; ++j)
        if (act && j < nj && s_cnan[pl * BOX_D + jb + j]) cn |= 1u << j;
#pragma unroll
      for (int i = 0; i < PQ; ++i) {
        const int q = tid / LT + i * (NT / LT);
        unsigned cm = 0u;  // the block's columns that cut the pair
        if (act && q < nq) {
          bool inside = true, apart = false;
          for (unsigned todo = ~s_hold[q] & ((1u << nj) - 1u); todo != 0u;
               todo &= todo - 1u) {
            const int j = __ffs(todo) - 1;
            const float ql = s_q[q * WIDE_COLS + j];
            const float qh = s_q[(QT + q) * WIDE_COLS + j];
            const bool holds = (ql <= blo[j]) & (bhi[j] <= qh);
            inside &= holds;
            apart |= (qh < blo[j]) | (bhi[j] < ql);
            cm |= (unsigned)!holds << j;
          }
          if (!inside) in_b &= ~(1u << i);
          if (apart) ap_b |= 1u << i;
          cm |= cn;
        }
#pragma unroll
        for (int o = 1; o < LT; o <<= 1)
          cm |= __shfl_xor_sync(0xffffffffu, cm, o);
        if (keep_cuts && pl == 0 && q < nq && cm != 0u) {
          uint64_t w = cut[q];
          for (; cm != 0u && w != CUT_ALL; cm &= cm - 1u)
            w = add_cut(w, j0 + __ffs(cm) - 1);
          cut[q] = w;
        }
      }
    }
    __syncthreads();  // every block's NaN flags are in, the bounds read
    if (pl < nl) {
      const bool no_nan = s_nan[pl] == 0;
      Acc leaf;
      leaf.load(s_stat + pl * Acc::STATS);
#pragma unroll
      for (int i = 0; i < PQ; ++i) {
        const int q = tid / LT + i * (NT / LT);
        if (q < nq) {
          const bool inside = no_nan && ((in_b >> i) & 1u);
          const bool apart = (ap_b >> i) & 1u;
          leaf.fill(s_tile, q, pl, inside);
          if (!inside && !apart)
            s_list[pl * BUCKET + atomicAdd(&s_count[pl], 1)] =
                (uint16_t)((it - it_base) << 11 | q << 4 | pl);
        }
      }
    }
    __syncthreads();

    // 4. The tile goes out as rows of nl * WIDTH contiguous floats a plane.
    constexpr int W = Acc::WIDTH;
    float* ob = out + ((size_t)q0 * k + leaf0) * W;
    if (nl == LT)
      store_tile<Acc, VW, LT * W / VW>(s_tile, ob, nq, 0, (size_t)k * W,
                                       plane);
    else
      store_tile<Acc, VW, 0>(s_tile, ob, nq, nl * W / VW, (size_t)k * W,
                             plane);
    __syncthreads();  // the tile is free again; its stores precede walks

    // The list is walked when a leaf's next pairs might not fit its
    // bucket, when CUT_TILES tiles are listed, and after the last tile.
    int n_walk = 0, most = 0;
    for (int l = 0; l < LT; ++l) {
      n_walk += s_count[l];
      most = max(most, s_count[l]);
    }
    if (most > BUCKET - QT || it + 1 - it_base == CUT_TILES ||
        qt + p.groups >= p.n_qt) {
      walk_all(n_walk);
      __syncthreads();
      if (tid < LT) s_count[tid] = 0;
      it_base = it + 1;
    }
  }
}

// The one-pass launch (s <= SLOT_CHUNK) on device dev with sms
// multiprocessors. Returns a cudaError_t.
template <class Acc>
int launch_one_pass(const float* c, const float* a, const uint8_t* valid,
                    const float* q_lo, const float* q_hi, float* out, int Q,
                    int k, int s, int d, void* stream, int dev, int sms) {
  cudaError_t err;
  // Leaf and query tiles start at multiples of 16 elements, so the staged
  // runs are 16-byte aligned when the arrays are.
  const bool aligned =
      (((uintptr_t)c | (uintptr_t)a | (uintptr_t)valid | (uintptr_t)q_lo |
        (uintptr_t)q_hi) & 15) == 0;
  const bool wide = d > MAX_D;
  Plan p;
  if (!(wide ? make_wide_plan<Acc>(Q, k, &p)
             : make_plan<Acc>(Q, k, s, d, aligned, &p)))
    return (int)cudaErrorInvalidConfiguration;
  // 16-byte stores need every row start 16-byte aligned: k a multiple of
  // 4 and an aligned buffer.
  const bool vec = k % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const int variant =
      wide ? 8 + vec : (vec ? 4 : 0) + (d <= 3 ? d : 0);
  using Kernel = void (*)(const float*, const float*, const uint8_t*,
                          const float*, const float*, float*, int, int, int,
                          int, Plan);
  Kernel kernel;
  switch (variant) {
    case 1: kernel = pair_tile_kernel<Acc, 1, 1>; break;
    case 2: kernel = pair_tile_kernel<Acc, 1, 2>; break;
    case 3: kernel = pair_tile_kernel<Acc, 1, 3>; break;
    case 4: kernel = pair_tile_kernel<Acc, 4, 0>; break;
    case 5: kernel = pair_tile_kernel<Acc, 4, 1>; break;
    case 6: kernel = pair_tile_kernel<Acc, 4, 2>; break;
    case 7: kernel = pair_tile_kernel<Acc, 4, 3>; break;
    case 8: kernel = pair_tile_wide_kernel<Acc, 1>; break;
    case 9: kernel = pair_tile_wide_kernel<Acc, 4>; break;
    default: kernel = pair_tile_kernel<Acc, 1, 0>; break;
  }
  // Once per device and variant: prefer the largest shared-memory
  // carveout, so that shared memory limits the blocks a multiprocessor
  // holds as little as it can; above 48 KB of dynamic shared memory opt
  // in, for the largest size asked so far.
  static int granted[MAX_DEVICES][VARIANTS];
  if (granted[dev][variant] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    granted[dev][variant] = 48 * 1024;
  }
  if (p.bytes > granted[dev][variant]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
    if (err != cudaSuccess) return (int)err;
    granted[dev][variant] = p.bytes;
  }
  // Blocks a multiprocessor holds at these shared-memory bytes (registers
  // decide at the serving shapes), cached per device and variant.
  static int occ_bytes[MAX_DEVICES][VARIANTS], occ[MAX_DEVICES][VARIANTS];
  if (occ_bytes[dev][variant] != p.bytes) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        p.bytes);
    if (err != cudaSuccess) return (int)err;
    occ[dev][variant] = per_sm > 0 ? per_sm : 1;
    occ_bytes[dev][variant] = p.bytes;
  }
  set_groups(k, (long long)occ[dev][variant] * sms, &p);
  kernel<<<p.n_blocks, NT, p.bytes, (cudaStream_t)stream>>>(
      c, a, valid, q_lo, q_hi, out, Q, k, s, d, p);
  return (int)cudaGetLastError();
}

// The chunk tiles' plan (s > SLOT_CHUNK): shared-memory carve-up (bytes),
// list capacity, scratch carve-up (floats); the launch fills in the grid.
struct ChunkPlan {
  int n_ch;           // chunks of SLOT_CHUNK slots
  int groups;         // query groups: the items of one (leaf, chunk)
  int gq;             // queries a group: group g has [g * gq, (g + 1) * gq)
  long long n_items;  // k * n_ch * groups
  int list;           // walk list entries: a group's queries and one more
  int off_a, off_v, off_box, off_red, off_list, off_count, bytes;
  size_t box, stat, nan, floats;  // the walks' partials start at 0
};

// The wide chunk tiles' room after the walk list (byte offsets): the
// listed pairs' cut words, the staged rows (WALK_X_BYTES) and the walk's
// room.
struct WideChunkTail {
  int cut, x, walk, bytes;
};

__host__ __device__ inline WideChunkTail wide_chunk_tail(int off_count,
                                                         int list) {
  WideChunkTail t;
  t.cut = al16(off_count + 4);
  t.x = al16(t.cut + 8 * list);
  t.walk = al16(t.x + WALK_X_BYTES);
  t.bytes = t.walk + walk_room_bytes();
  return t;
}

template <class Acc>
ChunkPlan make_chunk_plan(int Q, int k, int s, int d) {
  ChunkPlan p;
  p.n_ch = (int)(((long long)s + SLOT_CHUNK - 1) / SLOT_CHUNK);
  p.groups = 1;
  p.gq = Q;
  p.n_items = (long long)k * p.n_ch;
  p.list = (Q < LIST_MAX ? Q : LIST_MAX) + 1;
  // At d > MAX_D only the valid bytes are staged (the walks stage their
  // own windows) and the box holds a column block.
  const bool wide = d > MAX_D;
  long long off = wide ? 0 : align16(4LL * SLOT_CHUNK * d);  // c at 0
  p.off_a = (int)off;
  if (!wide) off = align16(off + 4LL * SLOT_CHUNK);
  p.off_v = (int)off;     off = align16(off + SLOT_CHUNK);
  p.off_box = (int)off;
  off = align16(off + 8LL * (wide ? WIDE_COLS : d) + 4);
  p.off_red = (int)off;   off = align16(off + 12LL * NT);
  p.off_list = (int)off;  off = align16(off + 4LL * p.list);
  p.off_count = (int)off; off = align16(off + 4);
  p.bytes = wide ? wide_chunk_tail(p.off_count, p.list).bytes : (int)off;
  const size_t strata = (size_t)k * p.n_ch;
  p.box = (size_t)p.n_ch * Q * k * Acc::STATS;
  p.stat = p.box + strata * 2 * d;
  p.nan = p.stat + strata * Acc::STATS;
  p.floats = p.nan + strata;
  return p;
}

// Chunk tiles: phase 1 over the items (leaf, chunk, query group) in a
// grid-stride loop, a grid sync, phase 2 over the pairs (design above).
// D > 0 fixes d at compile time.
template <class Acc, int D>
__global__ void __launch_bounds__(NT, D == 1 ? 5 : 1)
pair_chunk_kernel(const float* __restrict__ c, const float* __restrict__ a,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ q_lo,
                  const float* __restrict__ q_hi, float* __restrict__ out,
                  float* scratch, int Q, int k, int s, int d, ChunkPlan p) {
  if (D > 0) d = D;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_c = (float*)smem;                       // [slot][d]
  float* s_a = (float*)(smem + p.off_a);           // [slot]
  uint8_t* s_v = smem + p.off_v;                   // [slot]
  float* s_box = (float*)(smem + p.off_box);       // [lo, hi][d], flag
  int* s_nan = (int*)(s_box + 2 * d);
  float* s_rlo = (float*)(smem + p.off_red);       // the tree, [NT] each
  float* s_rhi = s_rlo + NT;
  int* s_rnan = (int*)(s_rhi + NT);
  int* s_list = (int*)(smem + p.off_list);  // queries to walk; -1: own
  int* s_count = (int*)(smem + p.off_count);
  float* g_part = scratch;                 // [chunk][q][leaf][STATS]
  float* g_box = scratch + p.box;          // [leaf][chunk][lo, hi][d]
  float* g_stat = scratch + p.stat;        // [leaf][chunk][STATS]
  int* g_nan = (int*)(scratch + p.nan);    // [leaf][chunk]

  const int tid = threadIdx.x;
  const int n_ch = p.n_ch;
  const float inf = __int_as_float(0x7f800000);
  int P = NT / d;  // box threads a column: a power of two
  while (P & (P - 1)) P &= P - 1;
  const int bj = tid / P, bpart = tid - bj * P;

  for (long long item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int group = (int)(item % p.groups);
    const long long lc = item / p.groups;
    const int ch = (int)(lc % n_ch), leaf = (int)(lc / n_ch);
    const int s0 = ch * SLOT_CHUNK, n = min(SLOT_CHUNK, s - s0);
    const size_t o = (size_t)leaf * s + s0;
    const size_t gl = (size_t)leaf * n_ch + ch;
    __syncthreads();  // the previous item's chunk and list are read
    // 1. The chunk.
    copy_any(s_c, c + o * d, n * d * 4);
    copy_any(s_a, a + o, n * 4);
    copy_any(s_v, valid + o, n);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    // 2. Its box and NaN flag.
    {
      float lo = inf, hi = -inf;
      int nan = 0;
      if (bj < d) {
        for (int i = bpart; i < n; i += P) {
          const bool on = s_v[i] != 0;
          const float x = s_c[i * d + bj];
          nan |= on & (x != x);
          lo = fminf(lo, on ? x : inf);
          hi = fmaxf(hi, on ? x : -inf);
        }
      }
      s_rlo[tid] = lo;
      s_rhi[tid] = hi;
      s_rnan[tid] = nan;
      __syncthreads();
      // The box is read: an invalid slot now carries NaN in column 0, so
      // that the walks test no valid byte.
      for (int i = tid; i < n; i += NT)
        if (s_v[i] == 0) s_c[i * d] = __int_as_float(0x7fc00000);
      for (int w = P / 2; w > 0; w >>= 1) {
        if (bj < d && bpart < w) {
          s_rlo[tid] = fminf(s_rlo[tid], s_rlo[tid + w]);
          s_rhi[tid] = fmaxf(s_rhi[tid], s_rhi[tid + w]);
          s_rnan[tid] |= s_rnan[tid + w];
        }
        __syncthreads();
      }
    }
    if (tid < d) {
      s_box[tid] = s_rlo[tid * P];
      s_box[d + tid] = s_rhi[tid * P];
    }
    if (tid == 0) {
      int f = 0;
      for (int j = 0; j < d; ++j) f |= s_rnan[j * P];
      *s_nan = f;
      // 3. The chunk's own partial, walked with the group-0 item's pairs.
      s_list[0] = -1;
      *s_count = group == 0 ? 1 : 0;
    }
    __syncthreads();
    if (group == 0) {
      if (tid < 2 * d) g_box[gl * 2 * d + tid] = s_box[tid];
      if (tid == 2 * d) g_nan[gl] = *s_nan;
    }
    // 4. The group's queries: classes (bounds from global memory), the
    // mixed ones listed, then the list walked; one pass unless the group
    // holds more queries than the list.
    const bool no_nan = *s_nan == 0;
    const int q1 = (int)min((long long)Q, (long long)(group + 1) * p.gq);
    for (long long base = (long long)group * p.gq; base < q1;
         base += p.list - 1) {
      const int stop = (int)min((long long)q1, base + p.list - 1);
      for (long long qq = base + tid; qq < stop; qq += NT) {
        const int q = (int)qq;
        float ql[MAX_D], qh[MAX_D];
#pragma unroll
        for (int j = 0; j < MAX_D; ++j) {
          ql[j] = j < d ? q_lo[(size_t)q * d + j] : 0.f;
          qh[j] = j < d ? q_hi[(size_t)q * d + j] : 0.f;
        }
        bool inside, apart;
        classify(ql, qh, s_box, s_box + d, no_nan, d, &inside, &apart);
        if (!inside && !apart) s_list[atomicAdd(s_count, 1)] = q;
      }
      __syncthreads();
      const int n_walk = *s_count;
      for (int e = tid; e < n_walk; e += NT) {
        // The chunk's own partial walks the box (-inf, +inf), which holds
        // every valid slot but one with a NaN coordinate: the same loop as
        // the pairs' (no divergence), and exact wherever it is read, since
        // a chunk with such a slot is never covered.
        const int q = s_list[e];
        float ql[MAX_D], qh[MAX_D];
#pragma unroll
        for (int j = 0; j < MAX_D; ++j) {
          ql[j] = j >= d ? 0.f : q >= 0 ? q_lo[(size_t)q * d + j] : -inf;
          qh[j] = j >= d ? 0.f : q >= 0 ? q_hi[(size_t)q * d + j] : inf;
        }
        Acc w;
        w.init();
        walk_chunk<Acc, D>(w, s_a, s_c, n, d, ql, qh);
        w.save(q < 0 ? g_stat + gl * Acc::STATS
                     : g_part + (((size_t)ch * Q + q) * k + leaf) *
                                    Acc::STATS);
      }
      if (stop < q1) {
        __syncthreads();
        if (tid == 0) *s_count = 0;
        __syncthreads();
      }
    }
  }

  cg::this_grid().sync();

  // Phase 2: each pair folds its chunks' partials in chunk order. The
  // (leaf, chunk) boxes, flags and partials come from shared memory when
  // they fit in the chunk's room (every shape with few strata), else
  // through L2.
  const size_t n_lc = p.floats - p.box;
  const bool local = n_lc * 4 <= (size_t)p.off_box;
  float* s_lc = (float*)smem;
  if (local) {
    for (size_t i = tid; i < n_lc; i += NT) s_lc[i] = __ldcg(g_box + i);
    __syncthreads();
  }
  auto lcd = [&](size_t i) { return local ? s_lc[i] : __ldcg(g_box + i); };
  const size_t o_stat = p.stat - p.box, o_nan = p.nan - p.box;
  const size_t pairs = (size_t)Q * k, plane = pairs * Acc::WIDTH;
  for (size_t pair = (size_t)blockIdx.x * NT + tid; pair < pairs;
       pair += (size_t)gridDim.x * NT) {
    const int q = (int)(pair / k), leaf = (int)(pair - (size_t)q * k);
    float ql[MAX_D], qh[MAX_D];
#pragma unroll
    for (int j = 0; j < MAX_D; ++j) {
      ql[j] = j < d ? q_lo[(size_t)q * d + j] : 0.f;
      qh[j] = j < d ? q_hi[(size_t)q * d + j] : 0.f;
    }
    Acc acc;
    acc.init();
    for (int ch = 0; ch < n_ch; ++ch) {
      const size_t gl = (size_t)leaf * n_ch + ch;
      float blo[MAX_D], bhi[MAX_D];
#pragma unroll
      for (int j = 0; j < MAX_D; ++j) {
        blo[j] = j < d ? lcd(gl * 2 * d + j) : 0.f;
        bhi[j] = j < d ? lcd(gl * 2 * d + d + j) : 0.f;
      }
      bool inside, apart;
      classify(ql, qh, blo, bhi, __float_as_int(lcd(o_nan + gl)) == 0, d,
               &inside, &apart);
      float x[Acc::STATS];
#pragma unroll
      for (int i = 0; i < Acc::STATS; ++i)
        x[i] = inside ? lcd(o_stat + gl * Acc::STATS + i)
               : apart ? 0.f
                       : __ldcg(g_part + ((size_t)ch * pairs + pair) *
                                             Acc::STATS + i);
      Acc part;
      if (apart && !inside)
        part.none();
      else
        part.load(x);
      acc.merge(part);
    }
    acc.write(out, pair, plane);
  }
}

// Chunk tiles at d > MAX_D: pair_chunk_kernel's items, phases and order,
// with the columns in blocks of WIDE_COLS (design above, "Any d").
template <class Acc>
__global__ void __launch_bounds__(NT)
pair_chunk_wide_kernel(const float* __restrict__ c,
                       const float* __restrict__ a,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ q_lo,
                       const float* __restrict__ q_hi,
                       float* __restrict__ out, float* scratch, int Q, int k,
                       int s, int d, ChunkPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* s_v = smem + p.off_v;                   // [slot]
  float* s_rlo = (float*)(smem + p.off_red);       // the tree, [NT] each
  float* s_rhi = s_rlo + NT;
  int* s_rnan = (int*)(s_rhi + NT);
  int* s_list = (int*)(smem + p.off_list);  // queries to walk; -1: own
  int* s_count = (int*)(smem + p.off_count);
  const WideChunkTail tail = wide_chunk_tail(p.off_count, p.list);
  uint64_t* s_cut = (uint64_t*)(smem + tail.cut);  // the list's cut words
  const WalkRoom room =
      walk_room(smem + tail.walk, (float*)(smem + tail.x), WALK_X_BYTES / 4);
  float* g_part = scratch;                 // [chunk][q][leaf][STATS]
  float* g_box = scratch + p.box;          // [leaf][chunk][lo, hi][d]
  float* g_stat = scratch + p.stat;        // [leaf][chunk][STATS]
  int* g_nan = (int*)(scratch + p.nan);    // [leaf][chunk]
  constexpr int P = NT / WIDE_COLS;        // box threads a column
  constexpr int PQ = LIST_MAX / NT;        // queries a thread a pass
  static_assert(PQ <= 32, "a thread's queries' flags in one word");

  const int tid = threadIdx.x;
  const int n_ch = p.n_ch;
  const float inf = __int_as_float(0x7f800000);
  const int bj = tid / P, bpart = tid - bj * P;
  const bool keep_cuts = d <= CUT_COLS;
  int rounds = 0;
  clear_walk_room(room);

  for (long long item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int group = (int)(item % p.groups);
    const long long lc = item / p.groups;
    const int ch = (int)(lc % n_ch), leaf = (int)(lc / n_ch);
    const int s0 = ch * SLOT_CHUNK, n = min(SLOT_CHUNK, s - s0);
    const size_t o = (size_t)leaf * s + s0;
    const size_t gl = (size_t)leaf * n_ch + ch;
    __syncthreads();  // the previous item's chunk and list are read
    // 1. The chunk's valid bytes (the box reads them).
    copy_any(s_v, valid + o, n);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    if (tid == 0) {
      // 3. The chunk's own partial, walked with the group-0 item's pairs.
      s_list[0] = -1;
      *s_count = group == 0 ? 1 : 0;
    }
    __syncthreads();
    const long long q_first = (long long)group * p.gq;
    const int q1 = (int)min((long long)Q, q_first + p.gq);
    for (long long base = q_first; base < q1; base += p.list - 1) {
      const int stop = (int)min((long long)q1, base + p.list - 1);
      // 2 and 4. The box and NaN flag a column block at a time (P threads
      // a column, then the tree), the group-0 item's first pass writing
      // them to the scratch; bit i of in_b / ap_b: query base + tid + i *
      // NT inside the box in every block so far / apart in some block;
      // cw[i] its cut columns (wide_cols.cuh), own the chunk's own
      // partial's (its columns with a NaN on a valid slot).
      unsigned in_b = 0xffffffffu, ap_b = 0u;
      const uint64_t none = keep_cuts ? CUT_NONE : CUT_ALL;
      uint64_t cw[PQ], own = none;
#pragma unroll
      for (int i = 0; i < PQ; ++i) cw[i] = none;
      int nan = 0;
      for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
        const int nj = min(WIDE_COLS, d - j0);
        float lo = inf, hi = -inf;
        int fl = 0;
        if (bj < nj) {
#pragma unroll 8
          for (int i = bpart; i < n; i += P) {
            const bool on = s_v[i] != 0;
            const float x = c[(o + i) * d + j0 + bj];
            fl |= on & (x != x);
            lo = fminf(lo, on ? x : inf);
            hi = fmaxf(hi, on ? x : -inf);
          }
        }
        s_rlo[tid] = lo;
        s_rhi[tid] = hi;
        s_rnan[tid] = fl;
        __syncthreads();
        for (int w = P / 2; w > 0; w >>= 1) {
          if (bj < nj && bpart < w) {
            s_rlo[tid] = fminf(s_rlo[tid], s_rlo[tid + w]);
            s_rhi[tid] = fmaxf(s_rhi[tid], s_rhi[tid + w]);
            s_rnan[tid] |= s_rnan[tid + w];
          }
          __syncthreads();
        }
        if (group == 0 && base == q_first && tid < nj) {
          g_box[gl * 2 * d + j0 + tid] = s_rlo[tid * P];
          g_box[gl * 2 * d + d + j0 + tid] = s_rhi[tid * P];
        }
        unsigned cn = 0u;  // the block's columns with a NaN on a valid slot
        for (int j = 0; j < nj; ++j) {
          nan |= s_rnan[j * P];
          if (s_rnan[j * P]) cn |= 1u << j;
        }
        if (tid == 0)
          for (unsigned b = cn; b != 0u && own != CUT_ALL; b &= b - 1u)
            own = add_cut(own, j0 + __ffs(b) - 1);
#pragma unroll
        for (int i = 0; i < PQ; ++i) {
          const long long q = base + tid + (long long)i * NT;
          if (q < stop) {
            bool inside = true, apart = false;
            unsigned cm = 0u;  // the block's columns that cut the pair
            for (int j = 0; j < nj; ++j) {
              const float blo = s_rlo[j * P], bhi = s_rhi[j * P];
              const float ql = q_lo[(size_t)q * d + j0 + j];
              const float qh = q_hi[(size_t)q * d + j0 + j];
              const bool holds = (ql <= blo) & (bhi <= qh);
              inside &= holds;
              apart |= (qh < blo) | (bhi < ql);
              cm |= (unsigned)!holds << j;
            }
            if (!inside) in_b &= ~(1u << i);
            if (apart) ap_b |= 1u << i;
            for (cm |= cn; cm != 0u && cw[i] != CUT_ALL; cm &= cm - 1u)
              cw[i] = add_cut(cw[i], j0 + __ffs(cm) - 1);
          }
        }
        __syncthreads();  // before the next block's tree
      }
      if (group == 0 && base == q_first && tid == 0) g_nan[gl] = nan;
#pragma unroll
      for (int i = 0; i < PQ; ++i) {
        const long long q = base + tid + (long long)i * NT;
        const bool inside = nan == 0 && ((in_b >> i) & 1u);
        if (q < stop && !inside && !((ap_b >> i) & 1u)) {
          const int at = atomicAdd(s_count, 1);
          s_list[at] = (int)q;
          s_cut[at] = cw[i];
        }
      }
      if (tid == 0 && group == 0 && base == q_first) s_cut[0] = own;
      __syncthreads();
      // The walks in rounds of NT, a thread a listed query (walk_wide over
      // the chunk's slots, its values and valid bytes from shared memory);
      // the chunk's own partial walks the unbounded box, as in
      // pair_chunk_kernel.
      const int n_walk = *s_count;
      for (int r0 = 0; r0 < n_walk; r0 += NT, ++rounds) {
        const bool on = r0 + tid < n_walk;
        const int q = on ? s_list[r0 + tid] : 0;
        Acc w;
        w.init();
        walk_wide<Acc>(w, on, 0, on ? s_cut[r0 + tid] : CUT_ALL,
                       q >= 0 ? q_lo + (size_t)q * d : nullptr,
                       q >= 0 ? q_hi + (size_t)q * d : nullptr, c + o * d,
                       a + o, valid + o, 0, 1, n, d, room, rounds & 1);
        if (on)
          w.save(q < 0 ? g_stat + gl * Acc::STATS
                       : g_part + (((size_t)ch * Q + q) * k + leaf) *
                                      Acc::STATS);
      }
      if (stop < q1) {
        __syncthreads();
        if (tid == 0) *s_count = 0;
        __syncthreads();
      }
    }
  }

  cg::this_grid().sync();

  // Phase 2: each pair folds its chunks' partials in chunk order, the
  // classes again from the scratch's boxes and flags, a column at a time:
  // from shared memory when every (leaf, chunk)'s box, partial and flag
  // fit in the block's (few strata of many slots), else through L2.
  const size_t n_lc = p.floats - p.box;
  const bool local = n_lc * 4 <= (size_t)p.bytes;
  float* s_lc = (float*)smem;
  if (local) {
    for (size_t i = tid; i < n_lc; i += NT) s_lc[i] = __ldcg(g_box + i);
    __syncthreads();
  }
  auto lcd = [&](size_t i) { return local ? s_lc[i] : __ldcg(g_box + i); };
  const size_t o_stat = p.stat - p.box, o_nan = p.nan - p.box;
  const size_t pairs = (size_t)Q * k, plane = pairs * Acc::WIDTH;
  for (size_t pair = (size_t)blockIdx.x * NT + tid; pair < pairs;
       pair += (size_t)gridDim.x * NT) {
    const int q = (int)(pair / k), leaf = (int)(pair - (size_t)q * k);
    const float* ql = q_lo + (size_t)q * d;
    const float* qh = q_hi + (size_t)q * d;
    Acc acc;
    acc.init();
    for (int ch = 0; ch < n_ch; ++ch) {
      const size_t gl = (size_t)leaf * n_ch + ch;
      bool inside = __float_as_int(lcd(o_nan + gl)) == 0, apart = false;
      for (int j = 0; j < d; ++j) {
        const float blo = lcd(gl * 2 * d + j), bhi = lcd(gl * 2 * d + d + j);
        inside &= (ql[j] <= blo) & (bhi <= qh[j]);
        apart |= (qh[j] < blo) | (bhi < ql[j]);
      }
      float x[Acc::STATS];
#pragma unroll
      for (int i = 0; i < Acc::STATS; ++i)
        x[i] = inside ? lcd(o_stat + gl * Acc::STATS + i)
               : apart ? 0.f
                       : __ldcg(g_part + ((size_t)ch * pairs + pair) *
                                             Acc::STATS + i);
      Acc part;
      if (apart && !inside)
        part.none();
      else
        part.load(x);
      acc.merge(part);
    }
    acc.write(out, pair, plane);
  }
}

// The chunked launch (s > SLOT_CHUNK), one cooperative launch on device
// dev with sms multiprocessors; scratch holds scratch_floats floats, at
// least pair_scratch_floats(). Returns a cudaError_t.
template <class Acc>
int launch_pair_chunks(const float* c, const float* a, const uint8_t* valid,
                       const float* q_lo, const float* q_hi, float* out,
                       float* scratch, long long scratch_floats, int Q,
                       int k, int s, int d, void* stream, int dev, int sms) {
  ChunkPlan p = make_chunk_plan<Acc>(Q, k, s, d);
  if (scratch == nullptr || scratch_floats < 0 ||
      (size_t)scratch_floats < p.floats)
    return (int)cudaErrorInvalidValue;
  const int variant = d > MAX_D ? 4 : d <= 3 ? d : 0;
  using Kernel = void (*)(const float*, const float*, const uint8_t*,
                          const float*, const float*, float*, float*, int,
                          int, int, int, ChunkPlan);
  Kernel kernel;
  switch (variant) {
    case 1: kernel = pair_chunk_kernel<Acc, 1>; break;
    case 2: kernel = pair_chunk_kernel<Acc, 2>; break;
    case 3: kernel = pair_chunk_kernel<Acc, 3>; break;
    case 4: kernel = pair_chunk_wide_kernel<Acc>; break;
    default: kernel = pair_chunk_kernel<Acc, 0>; break;
  }
  // Once per device and variant: the largest carveout; above 48 KB (d > 4)
  // opt in for the largest size asked so far; the resident blocks at these
  // bytes, which cap the cooperative grid.
  static int granted[MAX_DEVICES][5], occ_bytes[MAX_DEVICES][5],
      occ[MAX_DEVICES][5];
  cudaError_t err;
  if (granted[dev][variant] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    granted[dev][variant] = 48 * 1024;
  }
  if (p.bytes > granted[dev][variant]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
    if (err != cudaSuccess) return (int)err;
    granted[dev][variant] = p.bytes;
  }
  if (occ_bytes[dev][variant] != p.bytes) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        p.bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    occ[dev][variant] = per_sm;
    occ_bytes[dev][variant] = p.bytes;
  }
  // Query groups: as many as keep the items within the resident blocks,
  // at least one and at most one per GQ_MIN queries.
  const long long resident = (long long)occ[dev][variant] * sms;
  const long long per_group = (long long)k * p.n_ch;
  const long long most = ((long long)Q + GQ_MIN - 1) / GQ_MIN;
  long long groups = resident / per_group;
  groups = groups < 1 ? 1 : groups > most ? most : groups;
  p.gq = (int)(((long long)Q + groups - 1) / groups);
  p.groups = (int)(((long long)Q + p.gq - 1) / p.gq);
  p.n_items = per_group * p.groups;
  const int grid = (int)(p.n_items < resident ? p.n_items : resident);
  void* args[] = {(void*)&c,     (void*)&a,    (void*)&valid, (void*)&q_lo,
                  (void*)&q_hi,  (void*)&out,  (void*)&scratch, (void*)&Q,
                  (void*)&k,     (void*)&s,    (void*)&d,     (void*)&p};
  return (int)cudaLaunchCooperativeKernel((void*)kernel, dim3(grid),
                                          dim3(NT), args, p.bytes,
                                          (cudaStream_t)stream);
}

// Floats of the scratch that a launch at these sizes needs: 0 for
// s <= SLOT_CHUNK (the wrapper's pair_scratch_floats mirrors it).
template <class Acc>
long long pair_scratch_floats(int Q, int k, int s, int d) {
  if (s <= SLOT_CHUNK) return 0;
  return (long long)make_chunk_plan<Acc>(Q, k, s, d).floats;
}

// Launch the kernels for policy Acc on `stream` (the caller has checked
// the arguments): one pass for s <= SLOT_CHUNK, chunk tiles above it.
// Returns a cudaError_t.
template <class Acc>
int launch_pair_tiles(const float* c, const float* a, const uint8_t* valid,
                      const float* q_lo, const float* q_hi, float* out,
                      float* scratch, long long scratch_floats, int Q, int k,
                      int s, int d, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static int sms[MAX_DEVICES];
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (s > SLOT_CHUNK)
    return launch_pair_chunks<Acc>(c, a, valid, q_lo, q_hi, out, scratch,
                                   scratch_floats, Q, k, s, d, stream, dev,
                                   sms[dev]);
  return launch_one_pass<Acc>(c, a, valid, q_lo, q_hi, out, Q, k, s, d,
                              stream, dev, sms[dev]);
}

}  // namespace
