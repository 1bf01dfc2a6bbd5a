// Weighted relevant-sample moments for the Poisson bootstrap: per (query,
// stratum) [sum w, sum w*a, sum w*a^2] over the stratum's valid samples
// that fall inside the query box. Two entry points share one source and
// one code path, so that one digest covers both and the twin contract
// below rests on the same device code:
//
//  * stratified_weighted_moments: one weight row w (k, s) -> (Q, k, 3).
//    Replaces the Pallas kernel
//    src/repro/kernels/stratified_estimate.py::stratified_weighted_moments
//    (body `_kernel_weighted`), which scales the predicate mask by w and
//    contracts it with a one-hot (S, k) stratum matrix on the MXU. The scan
//    bootstrap launches it once per replicate.
//  * bootstrap_moments: R weight rows W (R, k, s) -> (R, Q, k, 3) in one
//    pass. Replaces the Pallas megakernel
//    src/repro/kernels/bootstrap.py::bootstrap_moments (body `_kernel`),
//    which reuses one predicate tile for an unrolled block of BR
//    replicates. The fused bootstrap (the default) launches it once per
//    answer. stratified_weighted_moments is this launch with R = 1.
//
// Contract (DESIGN.md §10): for every r, bootstrap_moments(W)[r] is bit
// for bit stratified_weighted_moments(W[r]). A slot counts iff valid and
// lo_j <= c_j <= hi_j for every column j; an invalid slot adds nothing
// whatever its weight. Every sum starts at +0.0 and adds its slots in slot
// order through `weighted_terms` / `weighted_add`, whose products and sums
// are explicit round-to-nearest intrinsics, so nvcc's FMA contraction
// cannot round two paths differently. No float atomics; the result is the
// same bits on every launch.
//
// Order contract (rows 3 and 4): the slot axis of a stratum is cut into
// chunks of CHUNK = 2048 consecutive slots (WEIGHTED_CHUNK in
// stratified_estimate.py; rows 2 and 8's SLOT_CHUNK). Up to one chunk a
// stratum, a pair's moments are one slot-order fold from +0.0, written as
// they are (PR 14's bits). Above it, every chunk gives a partial, the
// slot-order fold from +0.0 of its own slots, and a pair's moments are the
// left fold of its partials in chunk order, from chunk 0's, through
// __fadd_rn. So a pair's bits depend on its slots and s alone: never on
// Q, R, the pair's place in the batch, the replicate block or the grid.
// (One serial fold of 32,768 mixed-sign slots lies up to 1.25x the
// reference's rtol 3e-5 / atol 1e-3 bar away from the plain pairwise sum;
// chunks of 2048 keep it within 0.21x: tools/weighted_chunk_error.py.)
//
// What bounds it on an H100: at the bootstrap's serving shapes (Q = 2048,
// k = 1024, s = 75, R = 200) the bytes of the (R, Q, k, 3) output, 5.03
// GB, ~1.5 ms at 3.35 TB/s; the operations come under that. At few strata
// with many slots (Table 1's US arm: k = 1, s = 38,500, every pair mixed)
// the operations of the mixed pairs' walks: 5 a relevant (replicate,
// query, slot) triple, ~2.3 G triples at R = 200 (0.18 ms at 67 TFLOP/s).
// There a (replicate, slot) weight is wanted by every mixed query that
// holds the slot, so a walk that loads it once a (query, replicate) moves
// ~75 GB through L2 (PR 26: 15 ms); the staged walk loads it once a (query
// tile, segment) item into shared memory, and issue bounds it: ~31
// instructions a relevant (pair, slot) for RL = 4 replicates a lane.
//
// Design: the kernels below work on "segments", a stratum's chunk each:
// segment g = leaf * n_ch + ch, n_ch = ceil(s / CHUNK) (one segment a
// leaf up to one chunk). A (query, segment) pair is empty (no valid slot
// inside the box), covered (every valid slot inside) or mixed. A covered
// pair's moments are the segment's totals T[r, g]: its relevant slots are
// exactly the segment's valid slots, in the same order, through the same
// update, so the bits are those of a walk. An empty pair's are +0.0: its
// accumulators would never leave +0.0. Only a mixed pair walks its slots.
// In 1-D a query box cuts at most 2 of the leaves, so almost every pair is
// covered or empty and the work is the output's store. Five kernels per
// launch, a sixth above one chunk:
//
//  1. weighted_totals_kernel: T[r, g] over the segment's valid slots in
//     slot order. One warp per (replicate, 32 segments) stages 32 slots of
//     each at a time with coalesced loads; lane l walks segment l. Above
//     one chunk (few strata, long segments: 19 segments at the US shape,
//     so 200 warps of 19 lanes waited for their loads one round a stratum,
//     0.60 ms on an H100) weighted_totals_rep_kernel instead: a warp a
//     (segment, 32 replicates), lane = replicate, each lane reading 32
//     slots of its weight row at once.
//  2. weighted_box_kernel: one warp per segment writes the box around its
//     valid samples (+inf / -inf without one), its valid bits and a flag
//     for a NaN coordinate on a valid slot: fminf / fmaxf skip a NaN that
//     the slot test rejects, so a flagged segment is never covered. It
//     zeroes the staged walk's counters too.
//  3. weighted_tile_kernel: one block of NT = 256 threads per tile of
//     QT = 32 queries x LT segments (LT = 32 unless s is large), tiles
//     along blockIdx.x. The block
//     a. classifies every pair from the segment's box (lane = query, warp
//        = segment): covered iff the query box holds the box and the
//        segment is not flagged, empty iff they are apart in some column.
//        Exact: the box is the min / max of the valid non-NaN samples, a
//        NaN sample is inside no query, and the test is the slot test's
//        compares;
//     b. tests the slots of the remaining pairs once per (query, slot)
//        into a bitmask in shared memory, ANDed with the valid bits; a pair
//        with no bit set is empty, else mixed (never covered: the sample
//        at an edge of the box lies outside). The coordinates of the
//        segments with such pairs arrive in chunks of 32 slots x SL
//        segments by cp.async, double-buffered, so the next chunk loads
//        while the current one is tested;
//     c. lists the mixed pairs with their masks in the scratch, by
//        segment and in query order within one, each at a prefix sum of
//        step b's counts: those of segments with fewer than N_STAGE of
//        them first (their count per tile), then the others, each such
//        segment appended to the staged walk's items (tile, segment, first
//        entry, pairs);
//     d. loops over all R replicates in batches of RB_MAX, reusing the
//        classes: it stages the batch's totals tile with cp.async (the next
//        batch's load while this one is stored) and writes each
//        replicate's (QT, LT, 3) tile as rows of LT * 12 contiguous bytes,
//        T for covered pairs and +0.0 elsewhere: 16-byte streaming stores
//        when the segment count and LT are multiples of 4 (every row then
//        starts 16-byte aligned), 4-byte ones otherwise; neighbouring
//        threads write neighbouring addresses. A tile whose pairs are all
//        mixed (every tile at the US shape) stores nothing: its walks
//        write every float of it.
//  4. The walks of the mixed pairs, each overwriting its pair's floats.
//     Every (pair, replicate) is the slot-order fold from +0.0 of its
//     relevant slots of the segment through weighted_terms / weighted_add,
//     in every walk; only which thread does it differs, so the bits are
//     PR 14's.
//     A segment's mixed pairs of one tile take one of two walks:
//     a. fewer than N_STAGE of them: weighted_mixed_kernel (PR 14's walk),
//        one thread per (pair, replicate) loading the pair's relevant
//        weights from device memory, WALK loads in flight. At the serving
//        shapes a tile holds one or two mixed pairs of a segment (0.2 % of
//        the pairs in 1-D, 2.5 % in 3-D), and a staged walk there would
//        stage a segment's weights for 128 replicates to walk one pair:
//        it cost the 3-D row 4 +45 % (1.83 ms against ~0.7) on an H100.
//     b. N_STAGE or more (an item of the staged walks: at the US shape all
//        32 queries of a tile in every segment): blocks take units (an
//        item and a block of replicates) from a counter until none is
//        left, so the grid is the resident blocks whatever the share of
//        mixed pairs. The lane layout follows R:
//        - weighted_walk_reps_kernel (R > PAIR_R): lane = RL = 4
//          replicates (RB = 128 a unit), warp = up to PPW = 4 of the
//          item's pairs, their RL x 3 accumulators in registers. The
//          segment's slots arrive in sub-chunks of SUB slots by cp.async,
//          double-buffered: the RB weight rows transposed to
//          [slot][replicate] (a pitch of RB + 1 floats: no bank conflict
//          on either side; neighbouring threads read neighbouring slots of
//          a row) and a once. A pair's mask word is the same across its
//          warp, so the walk of its set bits does not diverge; a lane
//          reads its replicates' weights from shared memory, a[slot] is a
//          broadcast. So a (replicate, slot) weight comes from device
//          memory once an item instead of once a (query, replicate).
//        - weighted_walk_pairs_kernel (R <= PAIR_R: row 3's scan and flat
//          op, R = 1): lane = pair, warp = (item, replicate). With a lane
//          a replicate, all but R of RB lanes would idle. Lane b computes
//          the terms of slot 32 w + b into shared memory; then every lane
//          tests its own pair's bit for each of those 32 slots in order
//          and adds the terms where it is set (no multiply by a 0/1 mask:
//          0 x inf is NaN).
//     N_STAGE = 8: one pair a warp of a staged block; below it warps idle
//     while a whole segment is staged for the few pairs. PAIR_R = 8: a
//     unit of the pair layout costs ~6 instructions a (slot, replicate)
//     for up to 32 pairs, the replicate layout ~31 a relevant (pair, slot)
//     for RB replicates; with every pair of an item mixed and ~15 % of its
//     slots relevant (the US shape) the pair layout is the cheaper up to R
//     ~ 8. Up to R = PAIR_R and one chunk a stratum (row 3 at the serving
//     shapes) the direct walk takes every mixed pair and the staged walk
//     is not launched: its empty launch cost 1.2 us, ~2 % of row 3 there.
//  5. weighted_fold_kernel (above one chunk only): kernels 3 and 4 write
//     the (R, Q, k * n_ch, 3) partials to the scratch, and one thread per
//     (replicate, query, leaf) folds its n_ch partials in chunk order into
//     the output.
//
// Shared memory of the tile kernel (dynamic, chosen by make_plan): two
// totals tiles 2 * RB_MAX * LT * 12 bytes, the segments' boxes, two
// coordinate chunks of at most 2 KB, the mask QT * LT * ceil(min(s,
// CHUNK) / 32) * 4 bytes, the classes and a little bookkeeping: ~24 KB at
// s = 75, LT = 32, d = 1; ~136 KB at one full chunk, LT = 16. When the
// mask would not fit, LT halves. The replicate walk holds two staged
// sub-chunks, 2 * SUB * (RB + 2) * 4 bytes (~66 KB, dynamic).
// Registers are capped at 64 in the tile kernel (4 blocks an SM); nvcc
// -Xptxas=-v prints the counts at build.
//
// Any d. Up to MAX_D = 16 columns the box kernel keeps a segment's box in
// registers, the tile kernel its queries' bounds in registers and its
// segments' boxes and staged coordinate chunks in shared memory, all d
// columns at once. Above 16 the wide instantiations (weighted_box_wide_
// kernel, weighted_tile_kernel with D = -1) take the columns in blocks of
// WIDE_COLS = 16 (wide_cols.cuh), so that shared memory and registers do
// not grow with d: the box a block at a time (the valid bits with the
// first); step 1's classes with the block's boxes in shared memory and
// its bounds in registers, each pair's covered / apart bit ANDed / ORed
// over the blocks; step 2 tests a pair's 32 slots of a word block by block
// from L2 (nothing staged), then ANDs the valid bits as before. (Staging
// the words' coordinates a column block at a time was 15 % slower for row
// 3 at the 24-column serving shape on an H100: the walks, which never see
// a coordinate, take its time there.) The masks,
// classes and lists are the d <= 16 ones (the compares are exact), so the
// walks, tiles and folds, which never see a coordinate, are unchanged and
// fused = scan holds at every d. No float atomics, no tensor cores
// (no TF32): after the cover/empty split no large contraction is left to
// feed them. The walk's unit counter and item list are integer atomics
// that only order the work; no output depends on the order.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "wide_cols.cuh"

namespace {

constexpr int NT = 256;          // threads per tile block: 8 warps
constexpr int TILE_BLOCKS = 4;   // tile blocks an SM: caps registers at 64
constexpr int RB_MAX = 8;        // replicates per batch of the tile loop
constexpr int QT = 32;           // queries per tile: one per lane
constexpr int LT_MAX = 32;       // segments per tile
constexpr int MAX_D = 16;        // predicate columns whole; above, blocks
constexpr int CHUNK = 2048;      // slots a segment: the order contract
constexpr int LEAF_T = 128;      // threads per totals and box block
constexpr int MIX_T = 128;       // threads per direct-walk block
constexpr int MIX_R = 16;        // replicates per direct-walk block
constexpr int WALK = 8;          // slot loads in flight per direct walk
constexpr int N_STAGE = 8;       // a tile's pairs of a segment to stage it
constexpr int WALK_T = 256;      // threads per staged-walk block: 8 warps
constexpr int WALK_WARPS = WALK_T / 32;
constexpr int RL = 4;            // replicates a lane of the replicate walk
constexpr int RB = 32 * RL;      // replicates a unit of the replicate walk
constexpr int SUB = 64;          // slots a staged sub-chunk: two words
constexpr int PPW = QT / WALK_WARPS;  // pairs a warp of that walk, at most
constexpr int PAIR_R = 8;        // up to R = PAIR_R lanes take pairs
// Dynamic shared memory of the replicate walk: two sub-chunks of weights
// [slot][RB + 1] and of a.
constexpr int WALK_SMEM = (2 * SUB * (RB + 1) + 2 * SUB) * 4;
constexpr int MAX_DEVICES = 64;
constexpr int FOLD_T = 256;      // threads per fold block
constexpr int MAX_SMEM = 232448;
constexpr int MAX_GRID_Y = 65535;
// Pair classes; MAYBE until the pair's slots are tested.
constexpr uint8_t EMPTY = 0, COVERED = 1, MAYBE = 2, MIXED = 3;

// The per-slot update of every path: m += [w, w*a, (w*a)*a].
struct Terms {
  float w, wa, waa;
};

__device__ __forceinline__ Terms weighted_terms(float w, float a) {
  const float wa = __fmul_rn(w, a);
  return {w, wa, __fmul_rn(wa, a)};
}

__device__ __forceinline__ void weighted_add(float* m, const Terms& t) {
  m[0] = __fadd_rn(m[0], t.w);
  m[1] = __fadd_rn(m[1], t.wa);
  m[2] = __fadd_rn(m[2], t.waa);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The slot segments: segment g = leaf * n_ch + ch holds slots [ch * CHUNK,
// min(s, ch * CHUNK + CHUNK)) of its leaf; one segment a leaf (g = leaf,
// all s slots) when s <= CHUNK.
// CH: the launch has more than one segment a leaf; without it (s <=
// CHUNK) a segment is a leaf and the kernels compile to PR 14's indexing.
struct Segs {
  int s, n_ch;
  // Offset of the segment's first slot in the (k, s) slot arrays.
  template <bool CH>
  __device__ __forceinline__ size_t base(int g) const {
    if (!CH) return (size_t)g * s;
    const int l = g / n_ch;
    return (size_t)l * s + (size_t)(g - l * n_ch) * CHUNK;
  }
  template <bool CH>
  __device__ __forceinline__ int len(int g) const {
    if (!CH) return s;
    const int rest = s - (g - (g / n_ch) * n_ch) * CHUNK;
    return rest < CHUNK ? rest : CHUNK;
  }
};

// One launch's segments, tiles, scratch layout (in 4-byte words) and
// shared-memory carve-up (bytes).
struct Plan {
  Segs seg;
  int K;        // segments: k * n_ch
  int lt;       // segments per tile
  int nw;       // mask words per (query, segment): ceil(min(s, CHUNK) / 32)
  int sl;       // segments per staged coordinate chunk
  int n_qt, n_tiles;
  int stage_min;  // a tile's mixed pairs of a segment the staged walk takes
  size_t box, vbits, nan, counts, ctr, items, pairs, part, floats;
  int off_t, off_box, off_c, off_mask, off_cls, off_meta, bytes;
};

long long align16(long long x) { return (x + 15) & ~15LL; }

bool make_plan(int R, int Q, int k, int s, int d, Plan* plan) {
  if (R < 1 || Q < 1 || k < 1 || s < 0 || d < 1) return false;
  // Above MAX_D columns: boxes a column block, no staged coordinates.
  const bool wide = d > MAX_D;
  const long long n_ch = s > CHUNK ? (s + (long long)CHUNK - 1) / CHUNK : 1;
  const long long K = (long long)k * n_ch;
  if (K > (long long)MAX_GRID_Y * LEAF_T) return false;
  const int cs = s < CHUNK ? s : CHUNK;
  const int nw = (cs + 31) / 32;
  // Coordinate chunks of at most 2 KB, at least one segment a warp.
  int sl = 32;
  while (!wide && sl > 8 && sl * 32 * d * 4 > 2048) sl /= 2;
  for (int lt = LT_MAX; lt >= 1; lt /= 2) {
    Plan p;
    p.seg = Segs{s, (int)n_ch};
    p.K = (int)K;
    p.lt = lt;
    p.nw = nw;
    // Up to R = PAIR_R and one chunk a stratum the direct walk takes every
    // mixed pair (the launch has no staged walk).
    p.stage_min = R > PAIR_R || n_ch > 1 ? N_STAGE : QT + 1;
    p.sl = sl < lt ? sl : lt;
    long long off = 0;
    p.off_t = (int)off;    off = align16(off + 2LL * RB_MAX * lt * 12);
    p.off_box = (int)off;
    off = align16(off + 8LL * lt * (wide ? WIDE_COLS : d));
    p.off_c = (int)off;    off = align16(off + (wide ? 0 : 8LL * p.sl * 32 * d));
    p.off_mask = (int)off; off = align16(off + 4LL * nw * lt * QT);
    p.off_cls = (int)off;  off = align16(off + (long long)QT * lt);
    p.off_meta = (int)off; off = align16(off + 4LL * (3 * LT_MAX + 1));
    p.bytes = (int)off;
    if (off > MAX_SMEM) continue;
    const long long n_qt = (Q + QT - 1) / QT, n_lt = (K + lt - 1) / lt;
    if (n_qt * n_lt > INT_MAX) return false;
    p.n_qt = (int)n_qt;
    p.n_tiles = (int)(n_qt * n_lt);
    p.box = (size_t)R * K * 3;
    p.vbits = p.box + (size_t)K * 2 * d;
    p.nan = p.vbits + (size_t)K * nw;
    p.counts = p.nan + K;
    // 16 bytes from a multiple of 4 floats: the staged walk's next unit
    // (64-bit) and item count; then an item (int2) per (tile, segment) at
    // most.
    p.ctr = (p.counts + p.n_tiles + 3) & ~(size_t)3;
    p.items = p.ctr + 4;
    p.pairs = p.items + 2 * (size_t)p.n_tiles * lt;
    // The partials start 16-byte aligned: the tiles store 4 floats at once.
    const size_t end = p.pairs + (size_t)p.n_tiles * QT * lt * (1 + nw);
    p.part = (end + 3) & ~(size_t)3;
    p.floats = n_ch > 1 ? p.part + (size_t)R * Q * K * 3 : end;
    *plan = p;
    return true;
  }
  return false;
}

// Per (replicate, leaf), one segment a leaf (s <= CHUNK): T = the moments
// of the leaf's valid slots in slot order. One warp per (replicate, 32
// leaves) stages 32 slots of each at a time with coalesced loads; lane l
// then walks leaf l's.
__global__ void __launch_bounds__(LEAF_T)
weighted_totals_kernel(const float* __restrict__ a,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ W, float* __restrict__ T,
                       int k, Segs seg, int K) {
  __shared__ float s_w[LEAF_T / 32][32][33];
  __shared__ float s_a[LEAF_T / 32][32][33];
  __shared__ uint8_t s_v[LEAF_T / 32][32][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x;
  const int g0 = (blockIdx.y * (LEAF_T / 32) + warp) * 32;
  if (g0 >= K) return;
  const int nl = min(32, K - g0);
  const float* w = W + (size_t)r * k * seg.s;
  float m[3] = {0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < seg.s; s0 += 32) {
    if (lane < min(32, seg.s - s0)) {
      // One bound for the warp's leaves: their loads issue together.
      for (int li = 0; li < nl; ++li) {
        const size_t o = (size_t)(g0 + li) * seg.s + s0 + lane;
        s_w[warp][li][lane] = w[o];
        s_a[warp][li][lane] = a[o];
        s_v[warp][li][lane] = valid[o];
      }
    }
    __syncwarp();
    if (lane < nl) {
      const int n = min(32, seg.s - s0);
      for (int j = 0; j < n; ++j)
        if (s_v[warp][lane][j])
          weighted_add(m, weighted_terms(s_w[warp][lane][j],
                                         s_a[warp][lane][j]));
    }
    __syncwarp();
  }
  if (lane < nl) {
    float* o = T + ((size_t)r * K + g0 + lane) * 3;
    o[0] = m[0];
    o[1] = m[1];
    o[2] = m[2];
  }
}

// Above one chunk (few strata with long segments): one warp per (segment,
// 32 replicates), lane = replicate. Each 32 slots, the warp reads the
// segment's a into shared memory and its valid bytes into a ballot, both
// coalesced, and each lane its own weight row's 32 slots, all in flight
// together; then every lane folds the valid ones in slot order, the same
// fold as weighted_totals_kernel's.
__global__ void __launch_bounds__(LEAF_T)
weighted_totals_rep_kernel(const float* __restrict__ a,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ W,
                           float* __restrict__ T, int R, int k, Segs seg,
                           int K) {
  __shared__ float s_a[LEAF_T / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wid = (long long)blockIdx.x * (LEAF_T / 32) + warp;
  const int n_rb = (R + 31) / 32;
  if (wid >= (long long)K * n_rb) return;
  const int g = (int)(wid / n_rb), r = (int)(wid % n_rb) * 32 + lane;
  const size_t o = seg.base<true>(g);
  const int len = seg.len<true>(g);
  const float* wr = W + (size_t)(r < R ? r : R - 1) * k * seg.s + o;
  float m[3] = {0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < len; j0 += 32) {
    const int j = j0 + lane;
    s_a[warp][lane] = j < len ? a[o + j] : 0.f;
    const uint32_t bits = __ballot_sync(0xffffffffu,
                                        j < len && valid[o + j] != 0);
    float wv[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) wv[b] = j0 + b < len ? wr[j0 + b] : 0.f;
    __syncwarp();
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (bits & (1u << b))
        weighted_add(m, weighted_terms(wv[b], s_a[warp][b]));
    __syncwarp();  // before the next 32 slots' a overwrite these
  }
  if (r < R) {
    float* dst = T + ((size_t)r * K + g) * 3;
    dst[0] = m[0];
    dst[1] = m[1];
    dst[2] = m[2];
  }
}

// Per segment (one warp): its box around its valid samples (lo = +inf, hi
// = -inf without one), its valid bits, 32 slots a word (nw words, zero
// past its slots), and its NaN flag (1 iff a valid slot holds a NaN
// coordinate, x != x). Block 0 also zeroes the staged walk's counters.
template <bool CH>
__global__ void __launch_bounds__(LEAF_T)
weighted_box_kernel(const float* __restrict__ c,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ box, uint32_t* __restrict__ vbits,
                    int* __restrict__ nan_flag, int* __restrict__ ctr,
                    Segs seg, int K, int nw, int d) {
  const int g = blockIdx.x * (LEAF_T / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // The staged walk's two counters start at 0 (the tile kernel, next in
  // the stream, appends its items).
  if (blockIdx.x == 0 && threadIdx.x < 4) ctr[threadIdx.x] = 0;
  if (g >= K) return;
  const size_t base = seg.base<CH>(g);
  const int len = seg.len<CH>(g);
  float lo[MAX_D], hi[MAX_D];
#pragma unroll
  for (int j = 0; j < MAX_D; ++j) {
    lo[j] = __int_as_float(0x7f800000);
    hi[j] = -lo[j];
  }
  bool nan = false;
  for (int w = 0; w < nw; ++w) {
    const int i = w * 32 + lane;
    const bool v = i < len && valid[base + i] != 0;
    const unsigned bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) vbits[(size_t)g * nw + w] = bits;
    if (v) {
#pragma unroll
      for (int j = 0; j < MAX_D; ++j) {
        if (j < d) {
          const float x = c[(base + i) * d + j];
          nan |= x != x;
          lo[j] = fminf(lo[j], x);
          hi[j] = fmaxf(hi[j], x);
        }
      }
    }
  }
  nan = __any_sync(0xffffffffu, nan);
  if (lane == 0) nan_flag[g] = nan;
#pragma unroll
  for (int j = 0; j < MAX_D; ++j) {
    if (j < d) {
      for (int off = 16; off > 0; off >>= 1) {
        lo[j] = fminf(lo[j], __shfl_xor_sync(0xffffffffu, lo[j], off));
        hi[j] = fmaxf(hi[j], __shfl_xor_sync(0xffffffffu, hi[j], off));
      }
      if (lane == 0) {
        box[(size_t)g * 2 * d + j] = lo[j];
        box[(size_t)g * 2 * d + d + j] = hi[j];
      }
    }
  }
}

// weighted_box_kernel at d > MAX_D: the same box, bits and flag, the
// columns a block of WIDE_COLS at a time (the valid bits with the first).
template <bool CH>
__global__ void __launch_bounds__(LEAF_T)
weighted_box_wide_kernel(const float* __restrict__ c,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ box, uint32_t* __restrict__ vbits,
                         int* __restrict__ nan_flag, int* __restrict__ ctr,
                         Segs seg, int K, int nw, int d) {
  const int g = blockIdx.x * (LEAF_T / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x < 4) ctr[threadIdx.x] = 0;
  if (g >= K) return;
  const size_t base = seg.base<CH>(g);
  const int len = seg.len<CH>(g);
  bool nan = false;
  for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
    const int nj = min(WIDE_COLS, d - j0);
    float lo[WIDE_COLS], hi[WIDE_COLS];
#pragma unroll
    for (int j = 0; j < WIDE_COLS; ++j) {
      lo[j] = __int_as_float(0x7f800000);
      hi[j] = -lo[j];
    }
    for (int w = 0; w < nw; ++w) {
      const int i = w * 32 + lane;
      const bool v = i < len && valid[base + i] != 0;
      if (j0 == 0) {
        const unsigned bits = __ballot_sync(0xffffffffu, v);
        if (lane == 0) vbits[(size_t)g * nw + w] = bits;
      }
      if (v) {
#pragma unroll
        for (int j = 0; j < WIDE_COLS; ++j) {
          if (j < nj) {
            const float x = c[(base + i) * d + j0 + j];
            nan |= x != x;
            lo[j] = fminf(lo[j], x);
            hi[j] = fmaxf(hi[j], x);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < WIDE_COLS; ++j) {
      if (j < nj) {
        for (int off = 16; off > 0; off >>= 1) {
          lo[j] = fminf(lo[j], __shfl_xor_sync(0xffffffffu, lo[j], off));
          hi[j] = fmaxf(hi[j], __shfl_xor_sync(0xffffffffu, hi[j], off));
        }
        if (lane == 0) {
          box[(size_t)g * 2 * d + j0 + j] = lo[j];
          box[(size_t)g * 2 * d + d + j0 + j] = hi[j];
        }
      }
    }
  }
  nan = __any_sync(0xffffffffu, nan);
  if (lane == 0) nan_flag[g] = nan;
}

// One block per tile of QT queries x LT segments: classes, the mixed
// pairs' masks into the scratch, and every replicate's tile with T for
// covered pairs and +0.0 elsewhere, into `out` (R, Q, K, 3): the output
// itself at one segment a leaf, the partials above. VW floats per store (4
// when K and LT are multiples of 4, else 1); D > 0 fixes d at compile
// time, D = 0 takes d up to MAX_D, D = -1 any d in column blocks.
template <int VW, int D, bool CH>
__global__ void __launch_bounds__(NT, TILE_BLOCKS)
weighted_tile_kernel(const float* __restrict__ c,
                     const float* __restrict__ q_lo,
                     const float* __restrict__ q_hi, float* __restrict__ out,
                     float* __restrict__ scratch, int R, int Q, int d,
                     Plan p) {
  if (D > 0) d = D;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_t = (float*)(smem + p.off_t);       // [2][RB_MAX][LT * 3]
  float* s_box = (float*)(smem + p.off_box);   // [segment][lo, hi][d]
  float* s_c = (float*)(smem + p.off_c);       // [2][SL][32 * d]
  uint32_t* s_mask = (uint32_t*)(smem + p.off_mask);  // [word][rank][q]
  uint8_t* s_cls = smem + p.off_cls;                  // [q][segment]
  // Segment has a MAYBE pair; from step 2 on, its mixed pairs.
  int* s_flag = (int*)(smem + p.off_meta);
  int* s_rank = s_flag + LT_MAX;            // its rank among those
  int* s_list = s_rank + LT_MAX;            // those segments in order
  int* s_count = s_list + LT_MAX;  // such segments
  const float* T = scratch;
  const float* box = scratch + p.box;
  const uint32_t* vbits = (const uint32_t*)(scratch + p.vbits);
  const int* nan_flag = (const int*)(scratch + p.nan);
  const Segs seg = p.seg;
  const int K = p.K;

  const int LT = p.lt, NW = p.nw;
  const int tile = blockIdx.x;
  const int q0 = (tile % p.n_qt) * QT;
  const int g0 = (tile / p.n_qt) * LT;
  const int nq = min(QT, Q - q0), nl = min(LT, K - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if constexpr (D >= 0) {
    for (int i = tid; i < nl * 2 * d; i += NT)
      s_box[i] = box[(size_t)g0 * 2 * d + i];
  }
  for (int i = tid; i < LT_MAX; i += NT) s_flag[i] = 0;
  const bool q_active = lane < nq;
  float ql[MAX_D], qh[MAX_D];
#pragma unroll
  for (int j = 0; j < MAX_D; ++j) {
    const bool on = q_active && j < d;
    ql[j] = on ? q_lo[(size_t)(q0 + lane) * d + j] : 0.f;
    qh[j] = on ? q_hi[(size_t)(q0 + lane) * d + j] : 0.f;
  }
  // Totals of replicates [r0, r0 + nr) into half `buf` of s_t. The first
  // batch's load while the tile is classified.
  const int row = nl * 3, pitch = LT * 3;
  auto fetch = [&](int buf, int r0, int nr) {
    float* dst = s_t + buf * RB_MAX * pitch;
    for (int i = tid; i < nr * row; i += NT) {
      const int rb = i / row, j = i - rb * row;
      cp_async4(dst + rb * pitch + j,
                T + ((size_t)(r0 + rb) * K + g0) * 3 + j);
    }
    cp_async_commit();
  };
  fetch(0, 0, min(RB_MAX, R));
  __syncthreads();

  // 1. Classes from the segment boxes (lane = query, warp = segment):
  // covered iff the box holds every valid sample and none is NaN, empty
  // iff it is apart from them in some column, else MAYBE until the slots
  // are tested.
  if constexpr (D < 0) {
    // The columns in blocks of WIDE_COLS: the block's boxes in s_box, its
    // bounds in ql / qh; bit l of in_m / ap_m: segment l inside the
    // query's box in every block so far / apart in some block.
    uint32_t in_m = 0u, ap_m = 0u;
    for (int l = warp; l < LT; l += NT / 32)
      if (l < nl && q_active && nan_flag[g0 + l] == 0) in_m |= 1u << l;
    for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
      const int nj = min(WIDE_COLS, d - j0);
      __syncthreads();  // the previous block's boxes are read
      for (int i = tid; i < nl * 2 * nj; i += NT) {
        const int l = i / (2 * nj), r = i - l * 2 * nj;
        const int side = r / nj, j = r - side * nj;
        s_box[(l * 2 + side) * WIDE_COLS + j] =
            box[(size_t)(g0 + l) * 2 * d + (size_t)side * d + j0 + j];
      }
#pragma unroll
      for (int j = 0; j < MAX_D; ++j) {
        const bool on = q_active && j < nj;
        ql[j] = on ? q_lo[(size_t)(q0 + lane) * d + j0 + j] : 0.f;
        qh[j] = on ? q_hi[(size_t)(q0 + lane) * d + j0 + j] : 0.f;
      }
      __syncthreads();
      for (int l = warp; l < LT; l += NT / 32) {
        if (l < nl && q_active) {
          const float* bl = s_box + l * 2 * WIDE_COLS;
          bool inside = true, apart = false;
#pragma unroll
          for (int j = 0; j < MAX_D; ++j) {
            if (j < nj) {
              const float lo = bl[j], hi = bl[WIDE_COLS + j];
              inside &= (ql[j] <= lo) & (hi <= qh[j]);
              apart |= (qh[j] < lo) | (hi < ql[j]);
            }
          }
          if (!inside) in_m &= ~(1u << l);
          if (apart) ap_m |= 1u << l;
        }
      }
    }
    for (int l = warp; l < LT; l += NT / 32) {
      uint8_t cls = EMPTY;
      if (l < nl && q_active)
        cls = (in_m >> l) & 1u ? COVERED : (ap_m >> l) & 1u ? EMPTY : MAYBE;
      s_cls[lane * LT + l] = cls;
      const bool any = __any_sync(0xffffffffu, cls == MAYBE);
      if (any && lane == 0) s_flag[l] = 1;
    }
  } else {
    for (int l = warp; l < LT; l += NT / 32) {
      uint8_t cls = EMPTY;
      if (l < nl && q_active) {
        const float* bl = s_box + l * 2 * d;
        bool inside = nan_flag[g0 + l] == 0, apart = false;
#pragma unroll
        for (int j = 0; j < MAX_D; ++j) {
          if (j < d) {
            const float lo = bl[j], hi = bl[d + j];
            inside &= (ql[j] <= lo) & (hi <= qh[j]);
            apart |= (qh[j] < lo) | (hi < ql[j]);
          }
        }
        cls = inside ? COVERED : apart ? EMPTY : MAYBE;
      }
      s_cls[lane * LT + l] = cls;
      const bool any = __any_sync(0xffffffffu, cls == MAYBE);
      if (any && lane == 0) s_flag[l] = 1;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const bool f = s_flag[lane] != 0;
    s_flag[lane] = 0;  // step 2 counts the segment's mixed pairs here
    const unsigned b = __ballot_sync(0xffffffffu, f);
    if (f) {
      const int m = __popc(b & ((1u << lane) - 1u));
      s_rank[lane] = m;
      s_list[m] = lane;
    }
    if (lane == 0) s_count[0] = __popc(b);
  }
  __syncthreads();
  const int n_maybe = s_count[0];

  // 2. Slot tests of the MAYBE pairs, once per (query, slot), into the
  // mask; stage t holds segments [gr * SL, gr * SL + SL) of the list x
  // slots [ch * 32, ch * 32 + 32), gr = t / NW, ch = t % NW,
  // double-buffered. A segment shorter than the tile's longest has no
  // slots in its last words: nothing is loaded or tested there.
  const int SL = p.sl;
  const int row_f = D < 0 ? 0 : 32 * d;  // the wide kernel stages nothing
  const int n_stage = (n_maybe + SL - 1) / SL * NW;
  auto stage = [&](int t) {
    if (D >= 0 && t < n_stage) {
      const int gr = t / NW, ch = t - gr * NW;
      const int gl = min(SL, n_maybe - gr * SL);
      float* dst = s_c + (t & 1) * SL * row_f;
      for (int i = tid; i < gl * row_f; i += NT) {
        const int li = i / row_f, j = i - li * row_f;
        const int g = g0 + s_list[gr * SL + li];
        if (j < min(32, seg.len<CH>(g) - ch * 32) * d)
          cp_async4(dst + i, c + (seg.base<CH>(g) + ch * 32) * d + j);
      }
    }
    cp_async_commit();
  };
  int cnt[LT_MAX / 8];
#pragma unroll
  for (int i = 0; i < LT_MAX / 8; ++i) cnt[i] = 0;
  stage(0);
  for (int t = 0; t < n_stage; ++t) {
    stage(t + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int gr = t / NW, ch = t - gr * NW;
    const float* cs = s_c + (t & 1) * SL * row_f;
#pragma unroll
    for (int i = 0; i < LT_MAX / 8; ++i) {
      const int gl = warp + 8 * i;
      const int mi = gr * SL + gl;
      if (gl < SL && mi < n_maybe) {
        const int l = s_list[mi];
        const int n = min(32, seg.len<CH>(g0 + l) - ch * 32);
        const bool test = s_cls[lane * LT + l] == MAYBE;
        uint32_t bits = 0;
        if (test) {
          const uint32_t vb = vbits[(size_t)(g0 + l) * NW + ch];
          if constexpr (D < 0) {
            const size_t qr = (size_t)(q0 + lane) * d;
            bits = slots_inside_wide(
                c + (seg.base<CH>(g0 + l) + ch * 32) * d, n, d, q_lo + qr,
                q_hi + qr);
          } else {
            const float* cl = cs + gl * row_f;
            for (int b = 0; b < n; ++b) {
              bool in = true;
#pragma unroll
              for (int j = 0; j < MAX_D; ++j) {
                if (j < d) {
                  const float x = cl[b * d + j];
                  in &= (ql[j] <= x) & (x <= qh[j]);
                }
              }
              bits |= (uint32_t)in << b;
            }
          }
          bits &= vb;
        }
        s_mask[(ch * LT + mi) * QT + lane] = bits;
        if (ch == 0) cnt[i] = 0;
        cnt[i] += __popc(bits);
        // A MAYBE pair is never covered: some valid sample lies outside.
        if (ch == NW - 1) {
          if (test) s_cls[lane * LT + l] = cnt[i] == 0 ? EMPTY : MIXED;
          const unsigned mb = __ballot_sync(0xffffffffu, test && cnt[i] != 0);
          if (lane == 0) s_flag[l] = __popc(mb);
        }
      }
    }
    __syncthreads();  // before stage(t + 2) overwrites this buffer
  }
  __syncthreads();

  // 3. The mixed pairs and their masks go to the scratch for the walks:
  // entry = (q << 16 | segment, NW mask words). A segment with fewer than
  // stage_min mixed pairs in the tile is walked directly
  // (weighted_mixed_kernel: its entries first, their count in the tile's
  // count); each other one becomes a staged walk's item (tile, segment |
  // first entry << 5 | pairs << 15) at the end of the launch's list, its
  // entries after the direct ones. Each kind of entries is listed by
  // segment, each segment's in query order, from inclusive prefixes over
  // the segments; the integer atomic only orders the items. Every warp
  // reads step 2's counts (lane = segment) and forms the same sums and
  // prefixes.
  const int n_l = s_flag[lane];
  const bool staged = n_l >= p.stage_min;
  const unsigned staged_l = __ballot_sync(0xffffffffu, staged);
  const int n_mixed = __reduce_add_sync(0xffffffffu, n_l);
  // Every pair of the tile mixed: the walks write all of it.
  const bool all_mixed = n_mixed == nq * nl;
  uint32_t* pairs = (uint32_t*)(scratch + p.pairs) +
                    (size_t)tile * QT * LT * (1 + NW);
  int xd = staged ? 0 : n_l, xs = staged ? n_l : 0;
  for (int off = 1; off < 32; off <<= 1) {
    const int yd = __shfl_up_sync(0xffffffffu, xd, off);
    const int ys = __shfl_up_sync(0xffffffffu, xs, off);
    if (lane >= off) {
      xd += yd;
      xs += ys;
    }
  }
  const int n_direct = __shfl_sync(0xffffffffu, xd, 31);
  const int first = staged ? n_direct + xs - n_l : xd - n_l;
  if (warp == 0) {
    int item = 0;
    if (lane == 0 && staged_l != 0)
      item = atomicAdd((int*)(scratch + p.ctr) + 2, __popc(staged_l));
    item = __shfl_sync(0xffffffffu, item, 0);
    if (staged)
      ((int2*)(scratch + p.items))[item + __popc(staged_l &
                                                 ((1u << lane) - 1u))] =
          make_int2(tile, lane | first << 5 | n_l << 15);
    if (lane == 0) ((int*)(scratch + p.counts))[tile] = n_direct;
  }
  for (int l = warp; l < LT; l += NT / 32) {
    const int first_l = __shfl_sync(0xffffffffu, first, l);
    const bool mixed = s_cls[lane * LT + l] == MIXED;
    const unsigned b = __ballot_sync(0xffffffffu, mixed);
    if (mixed) {
      uint32_t* ent = pairs + (size_t)(first_l + __popc(
                                           b & ((1u << lane) - 1u))) *
                                  (1 + NW);
      ent[0] = ((uint32_t)lane << 16) | (uint32_t)l;
      for (int wd = 0; wd < NW; ++wd)
        ent[1 + wd] = s_mask[(wd * LT + s_rank[l]) * QT + lane];
    }
  }

  // 4. The store units this thread owns (VW floats each) and which of
  // their floats are covered; the same for every replicate. A tile whose
  // pairs are all mixed (the US shape) stores nothing: the walks write
  // every float of it.
  constexpr int UPT = QT * LT_MAX * 3 / VW / NT;
  const int nur = nl * 3 / VW;  // units per output row of the tile
  const int n_units = nq * nur;
  uint32_t cov = 0;
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int id = tid + u * NT;
    if (id < n_units) {
      const int q = id / nur, col = (id - q * nur) * VW;
#pragma unroll
      for (int e = 0; e < VW; ++e)
        if (s_cls[q * LT + (col + e) / 3] == COVERED)
          cov |= 1u << (u * VW + e);
    }
  }

  // 5. Replicates in batches of RB_MAX: the next batch's totals arrive by
  // cp.async while this one is stored, as rows of LT * 12 bytes.
  const int n_batch = (R + RB_MAX - 1) / RB_MAX;
  const size_t out_pitch = (size_t)K * 3;
  for (int b = 0; b < n_batch; ++b) {
    cp_async_wait<0>();
    if (all_mixed) return;  // the same in every thread
    // Batch b's totals are in; batch b - 1's stores no longer read the
    // other half of s_t.
    __syncthreads();
    const int r0 = b * RB_MAX, nr = min(RB_MAX, R - r0);
    if (b + 1 < n_batch)
      fetch((b + 1) & 1, r0 + RB_MAX, min(RB_MAX, R - r0 - RB_MAX));
    const float* tb = s_t + (b & 1) * RB_MAX * pitch;
    for (int rb = 0; rb < nr; ++rb) {
      const float* tr = tb + rb * pitch;
      float* ob = out + (((size_t)(r0 + rb) * Q + q0) * K + g0) * 3;
#pragma unroll
      for (int u = 0; u < UPT; ++u) {
        const int id = tid + u * NT;
        if (id < n_units) {
          const int q = id / nur, col = (id - q * nur) * VW;
          const uint32_t sel = cov >> (u * VW);
          float* dst = ob + q * out_pitch + col;
          if (VW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(tr + col);
            __stcs(reinterpret_cast<float4*>(dst),
                   make_float4(sel & 1u ? x.x : 0.f, sel & 2u ? x.y : 0.f,
                               sel & 4u ? x.z : 0.f, sel & 8u ? x.w : 0.f));
          } else {
            __stcs(dst, sel & 1u ? tr[col] : 0.f);
          }
        }
      }
    }
  }
}

// The direct walk: the mixed pairs of tile blockIdx.x's segments with
// fewer than N_STAGE of them (its first counts[tile] entries), replicates
// [blockIdx.y * MIX_R, + MIX_R): one thread per (pair, replicate) walks
// the set bits of the pair's mask in ascending slot order and writes the
// pair's moments over the tile kernel's +0.0. The loads of up to WALK
// slots are in flight together; the updates run in slot order. PR 14's
// walk.
template <bool CH>
__global__ void __launch_bounds__(MIX_T)
weighted_mixed_kernel(const float* __restrict__ a,
                      const float* __restrict__ W,
                      const float* __restrict__ scratch,
                      float* __restrict__ out, int R, int Q, int k,
                      Plan p) {
  const int tile = blockIdx.x;
  const int n_mixed = ((const int*)(scratch + p.counts))[tile];
  const int r0 = blockIdx.y * MIX_R, nr = min(MIX_R, R - r0);
  if (n_mixed == 0) return;
  const int NW = p.nw, K = p.K;
  const int q0 = (tile % p.n_qt) * QT;
  const int g0 = (tile / p.n_qt) * p.lt;
  const uint32_t* pairs = (const uint32_t*)(scratch + p.pairs) +
                          (size_t)tile * QT * p.lt * (1 + NW);
  const size_t ks = (size_t)k * p.seg.s;
  for (int it = threadIdx.x; it < n_mixed * nr; it += MIX_T) {
    const int rb = it / n_mixed, e = it - rb * n_mixed;
    const uint32_t* ent = pairs + (size_t)e * (1 + NW);
    const int q = q0 + (int)(ent[0] >> 16);
    const int g = g0 + (int)(ent[0] & 0xffffu);
    const int r = r0 + rb;
    const size_t o = p.seg.base<CH>(g);
    const float* wr = W + (size_t)r * ks + o;
    float m[3] = {0.f, 0.f, 0.f};
    for (int wd = 0; wd < NW; ++wd) {
      uint32_t bits = ent[1 + wd];
      while (bits) {
        int js[WALK];
        float wv[WALK], av[WALK];
#pragma unroll
        for (int u = 0; u < WALK; ++u) {
          js[u] = bits ? wd * 32 + __ffs(bits) - 1 : -1;
          bits &= bits - 1;
        }
#pragma unroll
        for (int u = 0; u < WALK; ++u) {
          if (js[u] >= 0) {
            wv[u] = wr[js[u]];
            av[u] = a[o + js[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < WALK; ++u)
          if (js[u] >= 0) weighted_add(m, weighted_terms(wv[u], av[u]));
      }
    }
    float* dst = out + (((size_t)r * Q + q) * K + g) * 3;
    dst[0] = m[0];
    dst[1] = m[1];
    dst[2] = m[2];
  }
}

// A staged walk's item: segment l of tile `tile` and its n >= N_STAGE
// mixed pairs, entries [first, first + n) of the tile's list.
struct Item {
  int tile, l, first, n;
};

// What a staged walk's unit needs of its item: where the segment's slots
// start and how many it has, the item's first query and segment, and its
// first entry.
struct Unit {
  Item it;
  int q0, g, len;
  size_t o;
  const uint32_t* ent;
};

template <bool CH>
__device__ __forceinline__ Unit unit_of(const float* scratch, const Plan& p,
                                        unsigned long long item) {
  const int2 v = ((const int2*)(scratch + p.items))[item];
  Unit u;
  u.it = {v.x, v.y & 31, (v.y >> 5) & 1023, v.y >> 15};
  u.q0 = (u.it.tile % p.n_qt) * QT;
  u.g = (u.it.tile / p.n_qt) * p.lt + u.it.l;
  u.o = p.seg.base<CH>(u.g);
  u.len = p.seg.len<CH>(u.g);
  u.ent = (const uint32_t*)(scratch + p.pairs) +
          ((size_t)u.it.tile * QT * p.lt + u.it.first) * (1 + p.nw);
  return u;
}

// The staged replicate walk (R > PAIR_R): blocks of WALK_WARPS warps take
// units (item, block of RB replicates) from the counter until none is
// left, replicate-block major (the units running together share their
// block's weights in L2). Lane l holds replicates l, l + 32, ... (RL of
// them); warp w walks the item's pairs w, w + WALK_WARPS, ... (PPW at
// most), each with RL x 3 accumulators in registers across the
// sub-chunks. The segment's weights, a and the pairs' mask words arrive
// in sub-chunks of SUB slots, double-buffered: thread t stages slot t %
// SUB of replicates t / SUB, t / SUB + WALK_T / SUB, ... (neighbouring
// threads read neighbouring slots of a row; the pitch RB + 1 spreads the
// stores and the lanes' reads over the banks). A pair's set bits, the
// same across its warp, are added in ascending slot order.
template <bool CH>
__global__ void __launch_bounds__(WALK_T, 2)
weighted_walk_reps_kernel(const float* __restrict__ a,
                          const float* __restrict__ W,
                          float* __restrict__ scratch,
                          float* __restrict__ out, int R, int Q, int k,
                          Plan p) {
  extern __shared__ __align__(16) float s_walk[];
  float* s_w = s_walk;                          // [2][SUB][RB + 1]
  float* s_a = s_walk + 2 * SUB * (RB + 1);     // [2][SUB]
  __shared__ uint32_t s_m[2][QT][SUB / 32];     // the pairs' mask words
  __shared__ unsigned long long s_unit;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned long long* next = (unsigned long long*)(scratch + p.ctr);
  const int n_rb = (R + RB - 1) / RB;
  const int n_items = ((const int*)(scratch + p.ctr))[2];
  const unsigned long long n_units = (unsigned long long)n_items * n_rb;
  if (n_units == 0) return;
  const int NW = p.nw, K = p.K;
  const size_t ks = (size_t)k * p.seg.s;
  const int jj = tid % SUB, rr0 = tid / SUB;
  for (;;) {
    if (tid == 0) s_unit = atomicAdd(next, 1ULL);
    __syncthreads();
    const unsigned long long id = s_unit;
    if (id >= n_units) return;
    const Unit u = unit_of<CH>(scratch, p, id % n_items);
    const int r0 = (int)(id / n_items) * RB, nr = min(RB, R - r0);
    const float* wsrc = W + (size_t)(r0 + rr0) * ks + u.o + jj;
    auto stage = [&](int t) {
      const int j0 = t * SUB, buf = t & 1;
      if (j0 + jj < u.len) {
        float* dw = s_w + (buf * SUB + jj) * (RB + 1);
        for (int rr = rr0; rr < nr; rr += WALK_T / SUB)
          cp_async4(dw + rr, wsrc + (size_t)(rr - rr0) * ks + j0);
        if (rr0 == 0) cp_async4(s_a + buf * SUB + jj, a + u.o + j0 + jj);
      }
      // The item's mask words of these slots: pair tid / (SUB / 32).
      const int e = tid / (SUB / 32), wd = t * (SUB / 32) + tid % (SUB / 32);
      if (j0 < u.len && e < u.it.n && wd < NW)
        cp_async4((float*)&s_m[buf][e][wd - t * (SUB / 32)],
                  (const float*)(u.ent + (size_t)e * (1 + NW) + 1 + wd));
      cp_async_commit();
    };
    const int np = (u.it.n - warp + WALK_WARPS - 1) / WALK_WARPS;
    float m[PPW][RL][3];
#pragma unroll
    for (int i = 0; i < PPW; ++i)
#pragma unroll
      for (int v = 0; v < RL; ++v) m[i][v][0] = m[i][v][1] = m[i][v][2] = 0.f;
    const int n_sub = (u.len + SUB - 1) / SUB;
    stage(0);
    for (int t = 0; t < n_sub; ++t) {
      cp_async_wait<0>();
      // Sub-chunk t is in for every thread, and every warp has left
      // sub-chunk t - 1, whose buffer stage(t + 1) refills.
      __syncthreads();
      stage(t + 1);
      const int buf = t & 1;
      const float* sw = s_w + buf * SUB * (RB + 1) + lane;
      const float* sa = s_a + buf * SUB;
      const int wd0 = t * (SUB / 32);
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        if (i < np) {
          const uint32_t* ent = s_m[buf][warp + i * WALK_WARPS];
#pragma unroll
          for (int wd = 0; wd < SUB / 32; ++wd) {
            uint32_t bits = wd0 + wd < NW ? ent[wd] : 0u;
            while (bits) {
              const int j = wd * 32 + __ffs(bits) - 1;
              bits &= bits - 1;
              const float av = sa[j];
              const float* wj = sw + j * (RB + 1);
              float wv[RL];
#pragma unroll
              for (int v = 0; v < RL; ++v) wv[v] = wj[32 * v];
#pragma unroll
              for (int v = 0; v < RL; ++v)
                weighted_add(m[i][v], weighted_terms(wv[v], av));
            }
          }
        }
      }
    }
    // Before the next unit's stages and counter read overwrite the
    // buffers and s_unit.
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (i < np) {
        const int q = u.q0 + (int)(u.ent[(size_t)(warp + i * WALK_WARPS) *
                                         (1 + NW)] >> 16);
#pragma unroll
        for (int v = 0; v < RL; ++v) {
          if (lane + 32 * v < nr) {
            float* dst = out + (((size_t)(r0 + lane + 32 * v) * Q + q) * K +
                                u.g) * 3;
            dst[0] = m[i][v][0];
            dst[1] = m[i][v][1];
            dst[2] = m[i][v][2];
          }
        }
      }
    }
  }
}

// The replicate walk's launch: its dynamic shared memory opted in and its
// resident blocks counted once per device; its grid the fewer of those and
// the units it could have.
template <bool CH>
int launch_reps(const float* a, const float* W, float* scratch, float* dst,
                int R, int Q, int k, const Plan& p, cudaStream_t stream) {
  static int resident[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(weighted_walk_reps_kernel<CH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WALK_SMEM);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, weighted_walk_reps_kernel<CH>, WALK_T, WALK_SMEM);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const long long want = (long long)p.n_tiles * p.lt * ((R + RB - 1) / RB);
  const int grid = (int)(want < resident[dev] ? want : resident[dev]);
  weighted_walk_reps_kernel<CH><<<grid, WALK_T, WALK_SMEM, stream>>>(
      a, W, scratch, dst, R, Q, k, p);
  return (int)cudaGetLastError();
}

// The staged pair walk (R <= PAIR_R): each warp takes units (item,
// replicate) from the counter; lane = pair. Per word of 32 slots, lane b
// computes slot b's terms into shared memory; then every lane adds, slot
// by slot in order, the terms of the slots its pair's mask word holds.
template <bool CH>
__global__ void __launch_bounds__(WALK_T)
weighted_walk_pairs_kernel(const float* __restrict__ a,
                           const float* __restrict__ W,
                           float* __restrict__ scratch,
                           float* __restrict__ out, int R, int Q, int k,
                           Plan p) {
  __shared__ float4 s_t[WALK_WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long* next = (unsigned long long*)(scratch + p.ctr);
  const int n_items = ((const int*)(scratch + p.ctr))[2];
  const unsigned long long n_units = (unsigned long long)n_items * R;
  if (n_units == 0) return;
  const int NW = p.nw, K = p.K;
  const size_t ks = (size_t)k * p.seg.s;
  float4* st = s_t[warp];
  for (;;) {
    unsigned long long id = 0;
    if (lane == 0) id = atomicAdd(next, 1ULL);
    id = __shfl_sync(0xffffffffu, id, 0);
    if (id >= n_units) return;
    // Replicate major, as the replicate walk.
    const Unit u = unit_of<CH>(scratch, p, id % n_items);
    const int r = (int)(id / n_items);
    const bool has = lane < u.it.n;
    const uint32_t* ent = u.ent + (size_t)(has ? lane : 0) * (1 + NW);
    const float* wr = W + (size_t)r * ks + u.o;
    const float* ar = a + u.o;
    float m[3] = {0.f, 0.f, 0.f};
    const int nwd = (u.len + 31) / 32;
    // Word wd + 1's weight, a and mask bits load while word wd is walked.
    float wn = 0.f, an = 0.f;
    uint32_t bn = 0u;
    auto fetch = [&](int wd) {
      const int j = wd * 32 + lane;
      wn = j < u.len ? wr[j] : 0.f;
      an = j < u.len ? ar[j] : 0.f;
      bn = has ? ent[1 + wd] : 0u;
    };
    fetch(0);
    for (int wd = 0; wd < nwd; ++wd) {
      const float wv = wn, av = an;
      const uint32_t bits = bn;
      if (wd + 1 < nwd) fetch(wd + 1);
      // Past the segment's slots wv = av = 0: terms +0.0, never added.
      const Terms t = weighted_terms(wv, av);
      st[lane] = make_float4(t.w, t.wa, t.waa, 0.f);
      __syncwarp();
      if (__any_sync(0xffffffffu, bits != 0)) {
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const float4 x = st[b];
          if (bits & (1u << b)) weighted_add(m, Terms{x.x, x.y, x.z});
        }
      }
      __syncwarp();  // before the next word's terms overwrite these
    }
    if (has) {
      const int q = u.q0 + (int)(ent[0] >> 16);
      float* dst = out + (((size_t)r * Q + q) * K + u.g) * 3;
      dst[0] = m[0];
      dst[1] = m[1];
      dst[2] = m[2];
    }
  }
}

// The blocks of the pair walk the card holds at once, per device, once:
// its grid.
template <bool CH>
int pairs_grid(int* grid) {
  static int resident[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, weighted_walk_pairs_kernel<CH>, WALK_T, 0);
    if (err != cudaSuccess) return (int)err;
    // Two blocks an SM at most: a launch whose items are all walked
    // directly (the serving shapes) then costs little more than the launch.
    resident[dev] = (per_sm > 2 ? 2 : per_sm > 0 ? per_sm : 1) * sms;
  }
  *grid = resident[dev];
  return 0;
}

// Above one chunk: out[r, q, leaf] = the left fold of the pair's n_ch
// partials part[r, q, leaf * n_ch + ch] in chunk order, from chunk 0's.
__global__ void __launch_bounds__(FOLD_T)
weighted_fold_kernel(const float* __restrict__ part, float* __restrict__ out,
                     size_t n_pairs, int n_ch) {
  for (size_t i = (size_t)blockIdx.x * FOLD_T + threadIdx.x; i < n_pairs;
       i += (size_t)gridDim.x * FOLD_T) {
    const float* pp = part + i * n_ch * 3;
    float m0 = pp[0], m1 = pp[1], m2 = pp[2];
    for (int ch = 1; ch < n_ch; ++ch) {
      m0 = __fadd_rn(m0, pp[ch * 3]);
      m1 = __fadd_rn(m1, pp[ch * 3 + 1]);
      m2 = __fadd_rn(m2, pp[ch * 3 + 2]);
    }
    out[i * 3] = m0;
    out[i * 3 + 1] = m1;
    out[i * 3 + 2] = m2;
  }
}

template <bool CH>
int launch_kernels(const float* c, const float* a, const uint8_t* valid,
                   const float* W, const float* q_lo, const float* q_hi,
                   float* out, float* scratch, int R, int Q, int k, int d,
                   const Plan& p, cudaStream_t stream) {
  const long long leaf_y = (p.K + LEAF_T - 1) / LEAF_T;
  const long long mix_y = (R + MIX_R - 1) / MIX_R;
  if (leaf_y > MAX_GRID_Y || mix_y > MAX_GRID_Y)
    return (int)cudaErrorInvalidConfiguration;
  if (CH) {
    const long long warps = (long long)p.K * ((R + 31) / 32);
    weighted_totals_rep_kernel<<<(unsigned)((warps + LEAF_T / 32 - 1) /
                                            (LEAF_T / 32)),
                                 LEAF_T, 0, stream>>>(a, valid, W, scratch,
                                                      R, k, p.seg, p.K);
  } else {
    weighted_totals_kernel<<<dim3(R, (unsigned)leaf_y), LEAF_T, 0,
                             stream>>>(a, valid, W, scratch, k, p.seg, p.K);
  }
  auto box_kernel = d > MAX_D ? weighted_box_wide_kernel<CH>
                              : weighted_box_kernel<CH>;
  box_kernel<<<(p.K + LEAF_T / 32 - 1) / (LEAF_T / 32), LEAF_T, 0,
               stream>>>(c, valid, scratch + p.box,
                         (uint32_t*)(scratch + p.vbits),
                         (int*)(scratch + p.nan), (int*)(scratch + p.ctr),
                         p.seg, p.K, p.nw, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Above one chunk the tiles and walks write the partials.
  float* dst = CH ? scratch + p.part : out;
  const bool vec = p.K % 4 == 0 && p.lt % 4 == 0;
  auto kernel = vec ? weighted_tile_kernel<4, 0, CH>
                    : weighted_tile_kernel<1, 0, CH>;
  if (d == 1)
    kernel = vec ? weighted_tile_kernel<4, 1, CH>
                 : weighted_tile_kernel<1, 1, CH>;
  if (d == 2)
    kernel = vec ? weighted_tile_kernel<4, 2, CH>
                 : weighted_tile_kernel<1, 2, CH>;
  if (d == 3)
    kernel = vec ? weighted_tile_kernel<4, 3, CH>
                 : weighted_tile_kernel<1, 3, CH>;
  if (d > MAX_D)
    kernel = vec ? weighted_tile_kernel<4, -1, CH>
                 : weighted_tile_kernel<1, -1, CH>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_tiles, NT, p.bytes, stream>>>(c, q_lo, q_hi, dst, scratch, R,
                                             Q, d, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // The staged walk, then the direct one: at most one item a (tile,
  // segment), R units an item in the pair layout (a warp each), ceil(R /
  // RB) in the replicate layout (a block each); never more blocks than
  // the card holds at once.
  if (R <= PAIR_R && !CH) {
    // The direct walk takes every mixed pair (plan.stage_min).
  } else if (R <= PAIR_R) {
    int grid = 0;
    const int gerr = pairs_grid<CH>(&grid);
    if (gerr != 0) return gerr;
    const long long want =
        ((long long)p.n_tiles * p.lt * R + WALK_WARPS - 1) / WALK_WARPS;
    if (want < grid) grid = (int)want;
    weighted_walk_pairs_kernel<CH><<<grid, WALK_T, 0, stream>>>(
        a, W, scratch, dst, R, Q, k, p);
  } else {
    const int rerr = launch_reps<CH>(a, W, scratch, dst, R, Q, k, p,
                                     stream);
    if (rerr != 0) return rerr;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  weighted_mixed_kernel<CH><<<dim3(p.n_tiles, (unsigned)mix_y), MIX_T, 0,
                              stream>>>(a, W, scratch, dst, R, Q, k, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !CH) return (int)err;
  const size_t n_pairs = (size_t)R * Q * k;
  const size_t blocks = (n_pairs + FOLD_T - 1) / FOLD_T;
  weighted_fold_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), FOLD_T,
                         0, stream>>>(scratch + p.part, out, n_pairs,
                                      p.seg.n_ch);
  return (int)cudaGetLastError();
}

int launch(const float* c, const float* a, const uint8_t* valid,
           const float* W, const float* q_lo, const float* q_hi, float* out,
           float* scratch, long long scratch_floats, int R, int Q, int k,
           int s, int d, cudaStream_t stream) {
  Plan p;
  if (!make_plan(R, Q, k, s, d, &p)) return (int)cudaErrorInvalidValue;
  if (scratch_floats < (long long)p.floats)
    return (int)cudaErrorInvalidValue;
  return p.seg.n_ch > 1
      ? launch_kernels<true>(c, a, valid, W, q_lo, q_hi, out, scratch, R, Q,
                             k, d, p, stream)
      : launch_kernels<false>(c, a, valid, W, q_lo, q_hi, out, scratch, R,
                              Q, k, d, p, stream);
}

}  // namespace

// `scratch` holds `scratch_floats` floats, at least repro_weighted_scratch
// of the launch (weighted_scratch in stratified_estimate.py allocates it;
// R = 1 here); out is (Q, k, 3).
extern "C" int repro_stratified_weighted_moments(
    const float* c, const float* a, const uint8_t* valid, const float* w,
    const float* q_lo, const float* q_hi, float* out, float* scratch,
    long long scratch_floats, int Q, int k, int s, int d, void* stream) {
  return launch(c, a, valid, w, q_lo, q_hi, out, scratch, scratch_floats, 1,
                Q, k, s, d, (cudaStream_t)stream);
}

extern "C" int repro_bootstrap_moments(const float* c, const float* a,
                                       const uint8_t* valid, const float* W,
                                       const float* q_lo, const float* q_hi,
                                       float* out, float* scratch,
                                       long long scratch_floats, int R,
                                       int Q, int k, int s, int d,
                                       void* stream) {
  return launch(c, a, valid, W, q_lo, q_hi, out, scratch, scratch_floats, R,
                Q, k, s, d, (cudaStream_t)stream);
}

// The segments per tile and dynamic shared memory of a launch at (Q, k, s,
// d), for the record: returns 0 and fills lt / bytes, or a cudaError_t.
extern "C" int repro_weighted_plan(int Q, int k, int s, int d, int* lt,
                                   int* bytes) {
  Plan p;
  if (!make_plan(1, Q, k, s, d, &p)) return (int)cudaErrorInvalidValue;
  *lt = p.lt;
  *bytes = p.bytes;
  return 0;
}

// The floats of a launch's scratch, or -1 where no plan exists.
extern "C" long long repro_weighted_scratch(int R, int Q, int k, int s,
                                            int d) {
  Plan p;
  return make_plan(R, Q, k, s, d, &p) ? (long long)p.floats : -1;
}

// Slots a segment: the order contract's chunk.
extern "C" int repro_weighted_chunk() { return CHUNK; }

// The walks: a tile's pairs of a segment are staged from N_STAGE of them;
// the staged walk's lanes take pairs up to R = PAIR_R, replicates above.
extern "C" int repro_weighted_stage() { return N_STAGE; }
extern "C" int repro_weighted_pair_r() { return PAIR_R; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
