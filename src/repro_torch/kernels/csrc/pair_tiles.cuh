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
// pair_chunk_wide_kernel), whose shared memory and registers do not grow
// with d: the columns go in blocks of WIDE_COLS = 16 (wide_cols.cuh).
//  * One pass: a leaf's reduction reads its slots from L2 in slot order;
//    for each query tile and column block the block's query bounds go to
//    shared memory and the leaves' box columns of the block are formed
//    there, a thread a (leaf, column); each thread ANDs / ORs its 8 pairs'
//    inside / apart bits over the blocks. The walks go in rounds of NT
//    pairs: for each 32 slots and column block the leaf tile's
//    coordinates are staged in shared memory, a walk ANDs its pair's 32
//    slot bits over the blocks, then adds the 32 slots in slot order.
//  * Chunk tiles: an item stages only the chunk's a and valid bytes; its
//    box is formed block by block (16 threads a column, the same tree),
//    written to the scratch by the group-0 item, and the group's queries
//    (at most LIST_MAX a pass: 16 a thread) AND / OR their flags over the
//    blocks; walks as the one pass's, in slot order over the chunk. Phase 2
//    reads the boxes through L2, a column at a time.
// The reductions, the folds and their orders are the d <= 16 kernels':
// only which columns a compare sees at once differs, and the compares are
// exact, so every class, every `in` and every bit is the same as if the d
// columns were tested at once.
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
static_assert(WIDE_COLS == MAX_D, "the wide kernels' blocks are MAX_D");
static_assert(LT * WIDE_COLS == NT, "a thread a (leaf, column) of a block");

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

// The wide one pass's shared-memory carve-up (bytes), the same at every
// d: the tile, a column block's query bounds (two planes of QT x
// WIDE_COLS) and leaf boxes, the leaves' reductions, flags and the list.
template <class Acc>
bool make_wide_plan(int Q, int k, Plan* plan) {
  Plan p;
  p.sc = 0;
  p.runs = 0;
  long long off = 0;
  off = align16(off + 4LL * Acc::PLANES * Acc::WIDTH * QT * LT);
  p.off_c = p.off_a = p.off_v = (int)off;  // nothing of the slots staged
  p.off_q = (int)off;     off = align16(off + 2 * 4LL * QT * WIDE_COLS);
  // The walks stage LT x 32 slots x WIDE_COLS floats over the tile and
  // the query buffers.
  if (off < 4LL * LT * 32 * WIDE_COLS) off = 4LL * LT * 32 * WIDE_COLS;
  p.off_box = (int)off;   off = align16(off + 8LL * LT * WIDE_COLS);
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

// The one pass at d > MAX_D (s <= SLOT_CHUNK): pair_tile_kernel's blocks,
// classes, tiles, stores and walk list, with the columns in blocks of
// WIDE_COLS (design above, "Any d").
template <class Acc, int VW>
__global__ void __launch_bounds__(NT)
pair_tile_wide_kernel(const float* __restrict__ c,
                      const float* __restrict__ a,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ q_lo,
                      const float* __restrict__ q_hi,
                      float* __restrict__ out, int Q, int k, int s, int d,
                      Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tile = (float*)smem;                    // tile_at()
  float* s_q = (float*)(smem + p.off_q);   // [lo, hi][q][WIDE_COLS]
  float* s_box = (float*)(smem + p.off_box);  // [leaf][lo, hi][WIDE_COLS]
  float* s_stat = (float*)(smem + p.off_stat);     // [leaf][STATS]
  int* s_nan = (int*)(smem + p.off_nan);           // [leaf]
  uint16_t* s_list = (uint16_t*)(smem + p.off_list);  // pairs to walk
  int* s_count = (int*)(smem + p.off_count);
  constexpr int PQ = QT * LT / NT;  // pairs a thread classifies

  const int tid = threadIdx.x;
  const int group = blockIdx.x % p.groups;
  const int leaf0 = (blockIdx.x / p.groups) * LT;
  const int nl = min(LT, k - leaf0);
  const size_t plane = (size_t)Q * k * Acc::WIDTH;
  const float inf = __int_as_float(0x7f800000);
  if (tid < LT) s_nan[tid] = 0;
  if (tid == 0) *s_count = 0;

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

  // 5. The walks of the listed pairs, one thread each, in rounds of NT
  // pairs: for each 32 slots and column block the leaf tile's coordinates
  // are staged over the tile and the query buffers (both free during the
  // walks), [leaf][slot][column ^ leaf] so that the 16 leaves' columns
  // fall on distinct banks; each thread tests its pair's 32 slots there,
  // then adds them in slot order.
  float* s_x = (float*)smem;  // [LT][32][WIDE_COLS]
  int it_base = 0;
  auto walk_all = [&](int n_walk) {
    for (int r0 = 0; r0 < n_walk; r0 += NT) {
      const int e = r0 + tid;
      const bool on = e < n_walk;
      int l = 0, q = 0;
      if (on) {
        const int ent = s_list[e];
        l = ent & (LT - 1);
        const int qt = (it_base + (ent >> 11)) * p.groups + group;
        q = qt * QT + ((ent >> 4) & (QT - 1));
      }
      const size_t o = (size_t)(leaf0 + l) * s;
      const float* xl = s_x + l * 32 * WIDE_COLS;
      Acc w;
      w.init();
      for (int i0 = 0; i0 < s; i0 += 32) {
        const int n = min(32, s - i0);
        uint32_t m = on ? (n >= 32 ? 0xffffffffu : (1u << n) - 1u) : 0u;
        for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
          const int nj = min(WIDE_COLS, d - j0);
          __syncthreads();  // the previous coordinates are read
          for (int i = tid; i < nl * n * nj; i += NT) {
            const int lb = i / nj, j = i - lb * nj;
            const int ll = lb / n, b = lb - ll * n;
            s_x[(ll * 32 + b) * WIDE_COLS + (j ^ ll)] =
                c[((size_t)(leaf0 + ll) * s + i0 + b) * d + j0 + j];
          }
          __syncthreads();
          if (m != 0u) {
            float ql[WIDE_COLS], qh[WIDE_COLS];
#pragma unroll
            for (int j = 0; j < WIDE_COLS; ++j) {
              ql[j] = j < nj ? q_lo[(size_t)q * d + j0 + j] : 0.f;
              qh[j] = j < nj ? q_hi[(size_t)q * d + j0 + j] : 0.f;
            }
            for (int b = 0; b < n; ++b) {
              const float* xb = xl + b * WIDE_COLS;
              bool in = true;
#pragma unroll
              for (int j = 0; j < WIDE_COLS; ++j) {
                if (j < nj) {
                  const float x = xb[j ^ l];
                  in &= (ql[j] <= x) & (x <= qh[j]);
                }
              }
              if (!in) m &= ~(1u << b);
            }
          }
        }
        if (on) {
          for (int b = 0; b < n; ++b)
            w.add(a[o + i0 + b],
                  ((m >> b) & 1u) && valid[o + i0 + b] != 0);
        }
      }
      if (on) w.write(out, (size_t)q * k + leaf0 + l, plane);
    }
  };

  // The box thread's (leaf, column) of a block; the classes' leaf.
  const int bl = tid / WIDE_COLS, bj = tid - bl * WIDE_COLS;
  const int pl = tid % LT;
  for (int it = 0, qt = group; qt < p.n_qt; ++it, qt += p.groups) {
    const int q0 = qt * QT, nq = min(QT, Q - q0);
    // 3. Classes, a column block at a time: bit i of in_b / ap_b is the
    // pair (query tid / LT + i * NT / LT, leaf tid % LT) inside in every
    // block so far / apart in some block.
    unsigned in_b = (1u << PQ) - 1u, ap_b = 0u;
    for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
      const int nj = min(WIDE_COLS, d - j0);
      __syncthreads();  // the previous block's bounds and boxes are read
      for (int i = tid; i < nq * nj; i += NT) {
        const int q = i / nj, j = i - q * nj;
        const size_t at = (size_t)(q0 + q) * d + j0 + j;
        s_q[q * WIDE_COLS + j] = q_lo[at];
        s_q[(QT + q) * WIDE_COLS + j] = q_hi[at];
      }
      if (bl < nl && bj < nj) {
        const size_t o = (size_t)(leaf0 + bl) * s;
        float lo = inf, hi = -inf;
        bool nan = false;
#pragma unroll 8
        for (int i = 0; i < s; ++i) {
          const bool on = valid[o + i] != 0;
          const float x = c[(o + i) * d + j0 + bj];
          nan |= on & (x != x);
          lo = fminf(lo, on ? x : inf);
          hi = fmaxf(hi, on ? x : -inf);
        }
        s_box[bl * 2 * WIDE_COLS + bj] = lo;
        s_box[(bl * 2 + 1) * WIDE_COLS + bj] = hi;
        if (nan) s_nan[bl] = 1;
      }
      __syncthreads();
      if (pl < nl) {
        const float* blo = s_box + pl * 2 * WIDE_COLS;
        const float* bhi = blo + WIDE_COLS;
#pragma unroll
        for (int i = 0; i < PQ; ++i) {
          const int q = tid / LT + i * (NT / LT);
          if (q < nq) {
            bool inside = true, apart = false;
#pragma unroll
            for (int j = 0; j < WIDE_COLS; ++j) {
              if (j < nj) {
                const float ql = s_q[q * WIDE_COLS + j];
                const float qh = s_q[(QT + q) * WIDE_COLS + j];
                inside &= (ql <= blo[j]) & (bhi[j] <= qh);
                apart |= (qh < blo[j]) | (bhi[j] < ql);
              }
            }
            if (!inside) in_b &= ~(1u << i);
            if (apart) ap_b |= 1u << i;
          }
        }
      }
    }
    __syncthreads();  // every block's NaN flags are in
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
            s_list[atomicAdd(s_count, 1)] =
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

template <class Acc>
ChunkPlan make_chunk_plan(int Q, int k, int s, int d) {
  ChunkPlan p;
  p.n_ch = (int)(((long long)s + SLOT_CHUNK - 1) / SLOT_CHUNK);
  p.groups = 1;
  p.gq = Q;
  p.n_items = (long long)k * p.n_ch;
  p.list = (Q < LIST_MAX ? Q : LIST_MAX) + 1;
  // At d > MAX_D nothing of c is staged and the box holds a column block.
  const bool wide = d > MAX_D;
  long long off = wide ? 0 : align16(4LL * SLOT_CHUNK * d);  // c at 0
  p.off_a = (int)off;     off = align16(off + 4LL * SLOT_CHUNK);
  p.off_v = (int)off;     off = align16(off + SLOT_CHUNK);
  p.off_box = (int)off;
  off = align16(off + 8LL * (wide ? WIDE_COLS : d) + 4);
  p.off_red = (int)off;   off = align16(off + 12LL * NT);
  p.off_list = (int)off;  off = align16(off + 4LL * p.list);
  p.off_count = (int)off; off = align16(off + 4);
  p.bytes = (int)off;
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
  float* s_a = (float*)(smem + p.off_a);           // [slot]
  uint8_t* s_v = smem + p.off_v;                   // [slot]
  float* s_rlo = (float*)(smem + p.off_red);       // the tree, [NT] each
  float* s_rhi = s_rlo + NT;
  int* s_rnan = (int*)(s_rhi + NT);
  int* s_list = (int*)(smem + p.off_list);  // queries to walk; -1: own
  int* s_count = (int*)(smem + p.off_count);
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

  for (long long item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int group = (int)(item % p.groups);
    const long long lc = item / p.groups;
    const int ch = (int)(lc % n_ch), leaf = (int)(lc / n_ch);
    const int s0 = ch * SLOT_CHUNK, n = min(SLOT_CHUNK, s - s0);
    const size_t o = (size_t)leaf * s + s0;
    const size_t gl = (size_t)leaf * n_ch + ch;
    __syncthreads();  // the previous item's chunk and list are read
    // 1. The chunk's values and valid bytes.
    copy_any(s_a, a + o, n * 4);
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
      // NT inside the box in every block so far / apart in some block.
      unsigned in_b = 0xffffffffu, ap_b = 0u;
      int nan = 0;
      for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
        const int nj = min(WIDE_COLS, d - j0);
        float lo = inf, hi = -inf;
        int fl = 0;
        if (bj < nj) {
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
        for (int j = 0; j < nj; ++j) nan |= s_rnan[j * P];
#pragma unroll
        for (int i = 0; i < PQ; ++i) {
          const long long q = base + tid + (long long)i * NT;
          if (q < stop) {
            bool inside = true, apart = false;
            for (int j = 0; j < nj; ++j) {
              const float blo = s_rlo[j * P], bhi = s_rhi[j * P];
              const float ql = q_lo[(size_t)q * d + j0 + j];
              const float qh = q_hi[(size_t)q * d + j0 + j];
              inside &= (ql <= blo) & (bhi <= qh);
              apart |= (qh < blo) | (bhi < ql);
            }
            if (!inside) in_b &= ~(1u << i);
            if (apart) ap_b |= 1u << i;
          }
        }
        __syncthreads();  // before the next block's tree
      }
      if (group == 0 && base == q_first && tid == 0) g_nan[gl] = nan;
#pragma unroll
      for (int i = 0; i < PQ; ++i) {
        const long long q = base + tid + (long long)i * NT;
        const bool inside = nan == 0 && ((in_b >> i) & 1u);
        if (q < stop && !inside && !((ap_b >> i) & 1u))
          s_list[atomicAdd(s_count, 1)] = (int)q;
      }
      __syncthreads();
      const int n_walk = *s_count;
      for (int e = tid; e < n_walk; e += NT) {
        // The chunk's own partial walks the unbounded box, as in
        // pair_chunk_kernel.
        const int q = s_list[e];
        const float* ql = q >= 0 ? q_lo + (size_t)q * d : nullptr;
        const float* qh = q >= 0 ? q_hi + (size_t)q * d : nullptr;
        Acc w;
        w.init();
        for (int i0 = 0; i0 < n; i0 += 32) {
          const int nb = min(32, n - i0);
          const uint32_t m =
              slots_inside_wide(c + (o + i0) * d, nb, d, ql, qh);
          for (int b = 0; b < nb; ++b)
            w.add(s_a[i0 + b], ((m >> b) & 1u) && s_v[i0 + b] != 0);
        }
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
  // classes again from the scratch's boxes and flags (through L2), a column
  // at a time.
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
      const float* bx = g_box + gl * 2 * d;
      bool inside = __ldcg(g_nan + gl) == 0, apart = false;
      for (int j = 0; j < d; ++j) {
        const float blo = __ldcg(bx + j), bhi = __ldcg(bx + d + j);
        inside &= (ql[j] <= blo) & (bhi <= qh[j]);
        apart |= (qh[j] < blo) | (bhi < ql[j]);
      }
      float x[Acc::STATS];
#pragma unroll
      for (int i = 0; i < Acc::STATS; ++i)
        x[i] = inside ? __ldcg(g_stat + gl * Acc::STATS + i)
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
