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
// columns at once. Above 16 a launch runs its own kernels (launch_wide),
// whose registers and shared memory do not grow with d, and writes every
// output float once, whole rows at a time:
//  a. the totals kernel as above;
//  b. weighted_box_wide_kernel: the box a column block of WIDE_COLS = 16
//     at a time (wide_cols.cuh), the valid bits, the NaN flag and the NaN
//     columns (a valid slot holds a NaN there);
//  c. weighted_class_wide_kernel: each (query, segment) pair's class from
//     the boxes a column block at a time, and a MAYBE pair's cut word: the
//     columns that cut it (the query does not hold the box there, or a NaN
//     column), CUT_ALL past CUT_MAX of them (wide_cols.cuh);
//  d. weighted_test_wide_kernel: a MAYBE pair's slots tested on its cut
//     columns only, a segment's run of TQ queries a block, the run's
//     needed column blocks staged once for all its queries (a column whose
//     extent the query holds changes no valid slot's bit: the masks are
//     the all-column test's);
//  e. a group walk over groups of up to GROUP segments and all Q queries,
//     writing every float of the group's (replicate, query) rows: T for a
//     covered pair, +0.0 for an empty one, the slot-order fold from +0.0
//     of a MAYBE pair's mask (the MAYBE pairs with no slot inside give
//     +0.0 too). With a lane a replicate (R > PAIR_R), a unit stages the
//     weights of two neighbouring groups for WRB replicates once for every
//     query; with a lane a query, the group's terms for one replicate. A
//     group's 96-byte piece of a row goes out whole, and the replicate
//     walk writes the two groups' pieces of a row back to back.
// Design from a measured split (tools/wide_walk_split.py --target
// weighted, PERF.md, PR 30): at the 24-column serving shape (26.6 % of
// the pairs mixed) the previous wide path tested every MAYBE pair's slots
// on all 24 columns from L2 (~2.3 ms of row 3's 2.5) and, at R = 200,
// wrote its walks' 111 M results as 12-byte pieces, each a read-modify-
// write of a DRAM sector (~7.1 ms of row 4's 12.8). Every (pair,
// replicate) stays the slot-order fold of its relevant slots through
// weighted_terms / weighted_add, so the bits are the d <= 16 launches' and
// fused = scan holds at every d. No float atomics, no tensor cores
// (no TF32): after the cover/empty split no large contraction is left to
// feed them. The walks' unit counters and the test kernel's needed-block
// OR are integer atomics that only order or size the work; no output
// depends on them.
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
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
  if (R < 1 || Q < 1 || k < 1 || s < 0 || d < 1 || d > MAX_D) return false;
  const long long n_ch = s > CHUNK ? (s + (long long)CHUNK - 1) / CHUNK : 1;
  const long long K = (long long)k * n_ch;
  if (K > (long long)MAX_GRID_Y * LEAF_T) return false;
  const int cs = s < CHUNK ? s : CHUNK;
  const int nw = (cs + 31) / 32;
  // Coordinate chunks of at most 2 KB, at least one segment a warp.
  int sl = 32;
  while (sl > 8 && sl * 32 * d * 4 > 2048) sl /= 2;
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
    p.off_box = (int)off;  off = align16(off + 8LL * lt * d);
    p.off_c = (int)off;    off = align16(off + 8LL * p.sl * 32 * d);
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
// columns a block of WIDE_COLS at a time (the valid bits with the first),
// and the segment's NaN columns, bit j % 32 of word j / 32 of nanw (ncw
// words a segment) set iff a valid slot holds a NaN in column j: the
// columns that cut every pair of the segment (wide_cols.cuh).
template <bool CH>
__global__ void __launch_bounds__(LEAF_T)
weighted_box_wide_kernel(const float* __restrict__ c,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ box, uint32_t* __restrict__ vbits,
                         int* __restrict__ nan_flag,
                         uint32_t* __restrict__ nanw, int* __restrict__ ctr,
                         Segs seg, int K, int nw, int ncw, int d) {
  const int g = blockIdx.x * (LEAF_T / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x < 4) ctr[threadIdx.x] = 0;
  if (g >= K) return;
  const size_t base = seg.base<CH>(g);
  const int len = seg.len<CH>(g);
  uint32_t word = 0u, flag = 0u;  // NaN columns of the current 32, of all
  for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
    const int nj = min(WIDE_COLS, d - j0);
    float lo[WIDE_COLS], hi[WIDE_COLS];
#pragma unroll
    for (int j = 0; j < WIDE_COLS; ++j) {
      lo[j] = __int_as_float(0x7f800000);
      hi[j] = -lo[j];
    }
    uint32_t nan = 0u;  // this lane's NaN columns of the block
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
            nan |= (uint32_t)(x != x) << j;
            lo[j] = fminf(lo[j], x);
            hi[j] = fmaxf(hi[j], x);
          }
        }
      }
    }
    word |= __reduce_or_sync(0xffffffffu, nan) << (j0 & 31);
    if ((j0 & 31) != 0 || j0 + WIDE_COLS >= d) {
      if (lane == 0) nanw[(size_t)g * ncw + (j0 >> 5)] = word;
      flag |= word;
      word = 0u;
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
  if (lane == 0) nan_flag[g] = flag != 0u;
}

// One block per tile of QT queries x LT segments: classes, the mixed
// pairs' masks into the scratch, and every replicate's tile with T for
// covered pairs and +0.0 elsewhere, into `out` (R, Q, K, 3): the output
// itself at one segment a leaf, the partials above. VW floats per store (4
// when K and LT are multiples of 4, else 1); D > 0 fixes d at compile
// time, D = 0 takes d up to MAX_D (above it launch_wide).
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

  for (int i = tid; i < nl * 2 * d; i += NT)
    s_box[i] = box[(size_t)g0 * 2 * d + i];
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
  const int row_f = 32 * d;
  const int n_stage = (n_maybe + SL - 1) / SL * NW;
  auto stage = [&](int t) {
    if (t < n_stage) {
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

// ---------------------------------------------------------------------------
// Any d above MAX_D (design in the header, "Any d"): weighted_box_wide_
// kernel, weighted_class_wide_kernel, weighted_test_wide_kernel and a group
// walk that writes every float of the output.

constexpr int GROUP = 8;         // segments a walk group, at most
constexpr int WRB = 32;          // replicates a unit of the replicate walk
constexpr int REPS_STAGE = 81920;  // bytes of a group's staged weights, most
constexpr int QRY_STAGE = 98304;   // bytes of a group's staged terms, most
constexpr int GW_T = 256;        // threads a group-walk block: 8 warps
constexpr int QRY_UNITS = 1024;  // query-walk units a launch, at least
constexpr int GW_WARPS = GW_T / 32;
constexpr int REPS_T = 512;      // threads of the replicate walk's one block
constexpr int REPS_WARPS = REPS_T / 32;  // an SM
// Floats a row of the store buffer: 16-byte rows, so that a group's 3 *
// GROUP floats go in and out as float4s.
constexpr int ROW_PITCH = 3 * GROUP + 4;
constexpr int TQ = 512;          // queries (threads) a test-kernel block
constexpr int TB = 32;           // columns a staged block of the test kernel
constexpr int XP = TB + 1;       // floats a staged slot row: no conflict
constexpr int WG = 4;            // words a stage of the test kernel
constexpr int NP = 2;            // pairs a round of the test kernel's tests
static_assert(ROW_PITCH % 4 == 0 && (3 * GROUP) % 4 == 0,
              "a group's row is whole float4s");

// A launch at d > MAX_D: its segments, class tiles of QT queries x LT_MAX
// segments, walk groups, scratch layout (4-byte words) and the walk's
// dynamic shared memory.
struct WPlan {
  Segs seg;
  int K, nw, ncw;        // segments; mask words of a segment; NaN words
  int n_qt, n_tiles;
  int gs, n_groups, reps;  // segments a group; groups; 1: a lane a replicate
  int parts;               // query walk: a (group, replicate)'s query parts
  size_t box, vbits, nan, nanw, ctr, cls, mask, cut, part, floats;
  int walk_bytes;
};

bool make_wide_plan(int R, int Q, int k, int s, int d, WPlan* plan) {
  if (R < 1 || Q < 1 || k < 1 || s < 0 || d <= MAX_D) return false;
  const long long n_ch = s > CHUNK ? (s + (long long)CHUNK - 1) / CHUNK : 1;
  const long long K = (long long)k * n_ch;
  if (K > (long long)MAX_GRID_Y * LEAF_T) return false;
  WPlan p;
  p.seg = Segs{s, (int)n_ch};
  p.K = (int)K;
  const int len = s < CHUNK ? s : CHUNK;  // slots of the longest segment
  p.nw = (len + 31) / 32;
  p.ncw = (d + 31) / 32;
  const long long n_qt = (Q + QT - 1) / QT, n_lt = (K + LT_MAX - 1) / LT_MAX;
  if (n_qt * n_lt > INT_MAX) return false;
  p.n_qt = (int)n_qt;
  p.n_tiles = (int)(n_qt * n_lt);
  // The replicate walk (R > PAIR_R) while a group's weights fit, its mask
  // words in a warp's lanes; else the query walk, one replicate a unit.
  // A group fits only segments of at most 620 slots, so the query walk
  // serves every launch above one chunk (launch_wide<true>).
  const long long ls = len > 0 ? len : 1;
  int gs = GROUP;
  while (gs > 0 && (gs * ls * (WRB + 1) * 4 > REPS_STAGE || gs * p.nw > 32))
    gs /= 2;
  p.reps = R > PAIR_R && gs > 0;
  if (!p.reps)
    for (gs = GROUP; gs > 1 && gs * ls * 16 > QRY_STAGE;) gs /= 2;
  p.gs = gs;
  p.n_groups = (int)((K + gs - 1) / gs);
  // The query walk's units at least QRY_UNITS where the queries allow (a
  // part at least a batch of 32 queries a warp): at R = 1 the groups alone
  // would leave most of the card idle.
  const long long gr = (long long)p.n_groups * R;
  const long long want = (QRY_UNITS + gr - 1) / gr;
  const long long most = (Q + GW_T - 1) / GW_T;
  p.parts = (int)(gr >= QRY_UNITS ? 1 : want < most ? want : most);
  p.box = (size_t)R * K * 3;
  p.vbits = p.box + (size_t)K * 2 * d;
  p.nan = p.vbits + (size_t)K * p.nw;
  p.nanw = p.nan + K;
  // The walk's unit counter (64-bit) from a multiple of 4 floats.
  p.ctr = (p.nanw + (size_t)K * p.ncw + 3) & ~(size_t)3;
  p.cls = p.ctr + 4;
  p.mask = p.cls + ((size_t)K * Q + 3) / 4;
  // The MAYBE pairs' cut words (8 bytes each) from a multiple of 2 floats.
  p.cut = (p.mask + (size_t)K * p.nw * Q + 1) & ~(size_t)1;
  const size_t end = p.cut + 2 * (size_t)K * Q;
  p.part = (end + 3) & ~(size_t)3;
  p.floats = n_ch > 1 ? p.part + (size_t)R * Q * K * 3 : end;
  // The replicate walk stages two groups a unit, for REPS_WARPS warps.
  p.walk_bytes = p.reps
      ? 4 * (((2 * gs * (int)ls * (WRB + 2) + 2 * gs * WRB * 3 + 3) & ~3) +
             REPS_WARPS * 32 * ROW_PITCH)
      : 16 * gs * (int)ls + 4 * (GROUP * 3 + GW_WARPS * 32 * ROW_PITCH);
  *plan = p;
  return true;
}

// One block per tile of QT queries (lane) x LT_MAX segments (warp w: w,
// w + 8, ...): each pair's class into cls [segment][query] (EMPTY,
// COVERED, MAYBE) and a MAYBE pair's cut word into cut [segment][query].
// Classes a column block at a time (the block's bounds and boxes in shared
// memory), each pair's inside / apart bit ANDed / ORed over the blocks,
// and its cut columns (not held, or NaN on a valid slot) appended to its
// cut word in registers (wide_cols.cuh).
template <bool CH>
__global__ void __launch_bounds__(NT, TILE_BLOCKS)
weighted_class_wide_kernel(const float* __restrict__ q_lo,
                           const float* __restrict__ q_hi,
                           float* __restrict__ scratch, int Q, int d,
                           WPlan p) {
  // [lo, hi][QT][QP]: a query's row of the block's bounds, padded so that
  // the lanes' reads of one column hit 32 banks.
  constexpr int QP = WIDE_COLS + 1;
  __shared__ float s_q[2 * QT * QP];
  __shared__ float s_box[LT_MAX * 2 * WIDE_COLS];    // [segment][lo, hi][cols]
  __shared__ float s_tb[2 * WIDE_COLS];  // the tile's box: its boxes folded
  const float* box = scratch + p.box;
  const int* nan_flag = (const int*)(scratch + p.nan);
  const uint32_t* nanw = (const uint32_t*)(scratch + p.nanw);
  uint8_t* cls = (uint8_t*)(scratch + p.cls);
  uint64_t* cut_w = (uint64_t*)(scratch + p.cut);
  const int K = p.K;
  const int tile = blockIdx.x;
  const int q0 = (tile % p.n_qt) * QT;
  const int g0 = (tile / p.n_qt) * LT_MAX;
  const int nq = min(QT, Q - q0), nl = min(LT_MAX, K - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = q0 + lane;
  const bool q_on = lane < nq;
  const bool keep_cuts = d <= CUT_COLS;
  constexpr int PL = LT_MAX / (NT / 32);  // pairs a thread
  // Bit i: pair (lane, warp + 8 i) inside in every block so far / apart in
  // some block.
  uint32_t in_m = 0u, ap_m = 0u;
  uint64_t cw[PL];
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int l = warp + 8 * i;
    cw[i] = keep_cuts ? CUT_NONE : CUT_ALL;
    if (l < nl && q_on && nan_flag[g0 + l] == 0) in_m |= 1u << i;
  }
  for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
    const int nj = min(WIDE_COLS, d - j0);
    __syncthreads();  // the previous block's bounds and boxes are read
    for (int i = tid; i < 2 * QT * WIDE_COLS; i += NT) {
      const int side = i / (QT * WIDE_COLS), r = i - side * QT * WIDE_COLS;
      const int qq = r / WIDE_COLS, j = r - qq * WIDE_COLS;
      if (qq < nq && j < nj)
        s_q[(side * QT + qq) * QP + j] =
            (side ? q_hi : q_lo)[(size_t)(q0 + qq) * d + j0 + j];
    }
    for (int i = tid; i < nl * 2 * WIDE_COLS; i += NT) {
      const int l = i / (2 * WIDE_COLS), r = i - l * 2 * WIDE_COLS;
      const int side = r / WIDE_COLS, j = r - side * WIDE_COLS;
      if (j < nj)
        s_box[i] = box[(size_t)(g0 + l) * 2 * d + (size_t)side * d + j0 + j];
    }
    __syncthreads();
    // The tile's box (fminf / fmaxf of its segments' boxes; an empty
    // segment's +inf / -inf change nothing), a thread a (side, column).
    if (tid < 2 * WIDE_COLS) {
      const int side = tid / WIDE_COLS, j = tid % WIDE_COLS;
      const float inf = __int_as_float(0x7f800000);
      float x = side ? -inf : inf;
      for (int l = 0; l < nl; ++l) {
        const float y = s_box[l * 2 * WIDE_COLS + tid];
        x = side ? fmaxf(x, y) : fminf(x, y);
      }
      if (j < nj) s_tb[tid] = x;
    }
    __syncthreads();
    const float* ql = s_q + lane * QP;
    const float* qh = s_q + (QT + lane) * QP;
    // The block's columns where the query holds the tile's box: there it
    // holds every segment's box and is apart from none but empty ones
    // (which are covered whatever apart says), so the pairs' compares skip
    // them (as rows 2 and 8's one pass does, pair_tiles.cuh).
    uint32_t test = 0u;
    for (int j = 0; j < nj; ++j)
      test |= (uint32_t)!((ql[j] <= s_tb[j]) &
                          (s_tb[WIDE_COLS + j] <= qh[j])) << j;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int l = warp + 8 * i;
      if (l < nl && q_on) {
        const float* bl = s_box + l * 2 * WIDE_COLS;
        uint32_t cut = 0u;  // the block's columns the query does not hold
        bool apart = false;
        for (uint32_t todo = test; todo != 0u; todo &= todo - 1u) {
          const int j = __ffs(todo) - 1;
          const float lo = bl[j], hi = bl[WIDE_COLS + j];
          cut |= (uint32_t)!((ql[j] <= lo) & (hi <= qh[j])) << j;
          apart |= (qh[j] < lo) | (hi < ql[j]);
        }
        if (cut != 0u) in_m &= ~(1u << i);
        if (apart) ap_m |= 1u << i;
        if (keep_cuts) {
          cut |= (nanw[(size_t)(g0 + l) * p.ncw + (j0 >> 5)] >> (j0 & 31)) &
                 ((1u << nj) - 1u);
          for (; cut != 0u && cw[i] != CUT_ALL; cut &= cut - 1u)
            cw[i] = add_cut(cw[i], j0 + __ffs(cut) - 1);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int l = warp + 8 * i;
    if (l < nl && q_on) {
      const size_t at = (size_t)(g0 + l) * Q + q;
      const bool maybe = !((in_m | ap_m) >> i & 1u);
      cls[at] = (in_m >> i & 1u) ? COVERED : maybe ? MAYBE : EMPTY;
      if (maybe) cut_w[at] = cw[i];
    }
  }
}

// The slot tests of the MAYBE pairs: one block per (segment, run of TQ
// queries), a warp a run of 32 (lane = query), the runs along blockIdx.x
// within a segment. The column blocks of TB columns that the run's MAYBE
// pairs' cut words name (every block when one pair tests every column)
// are staged a (word, block) at a time by cp.async, 32 slots x TB columns
// row-major (rows of TB + 1 floats: a contiguous copy, and lane b's reads
// of slot b hit no common bank), once for all the run's queries; lane b
// then holds slot b, and for each (pair, cut column) of the block the warp
// compares its 32 slots with the pair's bounds at once, the pair's lane
// ANDing the ballot into its bits. A column whose extent the query holds
// changes no valid slot's bit, so the masks, written to mask [segment]
// [word][query], are the all-column test's ANDed with the valid bits.
template <bool CH>
__global__ void __launch_bounds__(TQ)
weighted_test_wide_kernel(const float* __restrict__ c,
                          const float* __restrict__ q_lo,
                          const float* __restrict__ q_hi,
                          float* __restrict__ scratch, int Q, int d,
                          WPlan p) {
  __shared__ float s_x[2][WG * 32 * XP];     // staged (words, block)s
  __shared__ unsigned long long s_need[2];   // blocks 0-63 / past 63: all
  __shared__ int s_any;
  const uint32_t* vbits = (const uint32_t*)(scratch + p.vbits);
  const uint8_t* cls = (const uint8_t*)(scratch + p.cls);
  const uint64_t* cut_w = (const uint64_t*)(scratch + p.cut);
  uint32_t* mask = (uint32_t*)(scratch + p.mask);
  const int NW = p.nw;
  const int n_run = (Q + TQ - 1) / TQ;
  const int g = (int)(blockIdx.x / n_run);
  const int tid = threadIdx.x, lane = tid & 31;
  const int q = (int)(blockIdx.x % n_run) * TQ + tid;
  if (tid < 2) s_need[tid] = 0ull;
  if (tid == 0) s_any = 0;
  __syncthreads();
  const size_t at = (size_t)g * Q + q;
  // Both loads in flight at once (a pair that is not MAYBE has no cut
  // word written: its load's value goes unused).
  const uint64_t cw_at = q < Q ? cut_w[at] : CUT_NONE;
  const bool maybe = q < Q && cls[at] == MAYBE;
  const uint64_t cw = maybe ? cw_at : CUT_NONE;
  const bool every = maybe && cw == CUT_ALL;
  const float inf = __int_as_float(0x7f800000);
  const int nblk = (d + TB - 1) / TB;
  int col[CUT_MAX];
  float lo[CUT_MAX], hi[CUT_MAX];
  uint64_t need = 0u;  // column blocks the pair needs
#pragma unroll
  for (int t = 0; t < CUT_MAX; ++t) {
    const int j = cut_col(cw, t);
    const bool use = maybe && !every && j < CUT_COLS;
    col[t] = use ? j : -1;
    lo[t] = use ? q_lo[(size_t)q * d + j] : inf;
    hi[t] = use ? q_hi[(size_t)q * d + j] : -inf;
    if (use) need |= 1ull << (j / TB);
  }
  // The run's needed blocks: a warp's OR, then one lane's atomic.
  const bool all_w = __any_sync(0xffffffffu, every);
  const bool any_w = __any_sync(0xffffffffu, maybe);
  need = (uint64_t)__reduce_or_sync(0xffffffffu, (unsigned)(need >> 32))
             << 32 |
         __reduce_or_sync(0xffffffffu, (unsigned)need);
  if (lane == 0) {
    if (need != 0u) atomicOr(&s_need[0], (unsigned long long)need);
    if (all_w) atomicOr(&s_need[1], 1ull);
    if (any_w) s_any = 1;
  }
  __syncthreads();
  if (s_any == 0) return;  // the same in every thread
  const bool all = s_need[1] != 0u || nblk > 64;
  const uint64_t need_run = s_need[0];
  const size_t base = p.seg.base<CH>(g);
  const int len = p.seg.len<CH>(g), nwd = (len + 31) / 32;
  const int nb = all ? nblk : __popcll(need_run);
  const int ngr = (nwd + WG - 1) / WG;  // groups of WG words
  const int n_st = nb * ngr;  // stages (word group, needed block)
  auto block_of = [&](int t) {
    const int b = t % nb;
    if (all) return b;
    uint64_t m = need_run;  // its b-th set bit
    for (int i = 0; i < b; ++i) m &= m - 1u;
    return __ffsll((long long)m) - 1;
  };
  // Stage t into buffer t & 1, slot-major rows of XP floats: every
  // thread's copies, then its commit.
  auto stage = [&](int t) {
    if (t < n_st) {
      const int w0 = t / nb * WG, jc = block_of(t) * TB;
      const int nj = min(TB, d - jc), n = min(WG * 32, len - w0 * 32);
      float* dst = s_x[t & 1];
      for (int i = tid; i < WG * 32 * TB; i += TQ) {
        const int r = i / TB, cc = i - r * TB;
        if (r < n && cc < nj)
          cp_async4(dst + r * XP + cc,
                    c + (base + w0 * 32 + r) * d + jc + cc);
      }
    }
    cp_async_commit();
  };
  // The pair's bits of the group's words; lane b holds slot b of each.
  uint32_t bits[WG];
  stage(0);
  for (int t = 0; t < n_st; ++t) {
    stage(t + 1);
    cp_async_wait<1>();
    __syncthreads();  // stage t is in for every thread
    const int w0 = t / nb * WG, jc = block_of(t) * TB, nj = min(TB, d - jc);
    const int nwg = min(WG, nwd - w0);
    if (t % nb == 0) {
#pragma unroll
      for (int k = 0; k < WG; ++k)
        bits[k] = maybe && k < nwg ? vbits[(size_t)g * NW + w0 + k] : 0u;
    }
    uint32_t live = 0u;  // any word of the pair still holds a slot
#pragma unroll
    for (int k = 0; k < WG; ++k) live |= bits[k];
    const float* x = s_x[t & 1] + lane * XP;  // this lane's slot, word 0
    // Each (pair, cut column) of the block: the pair's bounds to every
    // lane once, a ballot a word; NP pairs at a time (their chains
    // overlap; the last ones repeat a pair where fewer are left, which
    // ANDs the same ballot twice).
#pragma unroll
    for (int u = 0; u < CUT_MAX; ++u) {
      for (uint32_t todo = __ballot_sync(
               0xffffffffu, live != 0u && col[u] >= jc && col[u] < jc + nj);
           todo != 0u;) {
        int sr[NP], cr[NP];
        float lr[NP], hr[NP];
#pragma unroll
        for (int e = 0; e < NP; ++e) {
          sr[e] = todo != 0u ? __ffs(todo) - 1 : sr[0];
          todo &= todo - 1u;
          cr[e] = __shfl_sync(0xffffffffu, col[u], sr[e]) - jc;
          lr[e] = __shfl_sync(0xffffffffu, lo[u], sr[e]);
          hr[e] = __shfl_sync(0xffffffffu, hi[u], sr[e]);
        }
#pragma unroll
        for (int k = 0; k < WG; ++k) {
          if (k < nwg) {
#pragma unroll
            for (int e = 0; e < NP; ++e) {
              const float v = x[k * 32 * XP + cr[e]];
              const uint32_t in = __ballot_sync(
                  0xffffffffu, (lr[e] <= v) & (v <= hr[e]));
              if (lane == sr[e]) bits[k] &= in;
            }
          }
        }
      }
    }
    // Pairs that test every column, one at a time.
    for (uint32_t todo = __ballot_sync(0xffffffffu, every && live != 0u);
         todo != 0u; todo &= todo - 1u) {
      const int src = __ffs(todo) - 1;
      const size_t qr = (size_t)__shfl_sync(0xffffffffu, q, src) * d + jc;
      for (int cc = 0; cc < nj; ++cc) {
        const float l = q_lo[qr + cc], h = q_hi[qr + cc];
#pragma unroll
        for (int k = 0; k < WG; ++k) {
          if (k < nwg) {
            const float v = x[k * 32 * XP + cc];
            const uint32_t in = __ballot_sync(0xffffffffu,
                                              (l <= v) & (v <= h));
            if (lane == src) bits[k] &= in;
          }
        }
      }
    }
    // Past the segment's slots the valid bits are 0: stale rows there
    // changed no bit.
    if (maybe && t % nb == nb - 1) {
#pragma unroll
      for (int k = 0; k < WG; ++k)
        if (k < nwg) mask[((size_t)g * NW + w0 + k) * Q + q] = bits[k];
    }
    __syncthreads();  // before stage t + 2 overwrites this buffer
  }
}

// A lane's row of the store buffer: the group's gs x 3 floats of m, as
// float4s for a whole group.
__device__ __forceinline__ void put_row(float* row, const float (*m)[3],
                                        int gs) {
  if (gs == GROUP) {
#pragma unroll
    for (int f = 0; f < 3 * GROUP; f += 4)
      *reinterpret_cast<float4*>(row + f) =
          make_float4(m[f / 3][f % 3], m[(f + 1) / 3][(f + 1) % 3],
                      m[(f + 2) / 3][(f + 2) % 3], m[(f + 3) / 3][(f + 3) % 3]);
  } else {
#pragma unroll
    for (int gl = 0; gl < GROUP; ++gl)
      if (gl < gs) {
        row[gl * 3] = m[gl][0];
        row[gl * 3 + 1] = m[gl][1];
        row[gl * 3 + 2] = m[gl][2];
      }
  }
}

// The first n_rows rows of a warp's store buffer ([row][ROW_PITCH], nf
// floats each) to out, row i at out + row_at(i): each row's nf * 4
// contiguous bytes from neighbouring lanes, by float4 when ``vec`` (a whole
// group, rows 16-byte aligned in out).
template <class RowAt>
__device__ __forceinline__ void store_rows(const float* buf, float* out,
                                           int n_rows, int nf, bool vec,
                                           RowAt row_at, int lane) {
  if (vec) {
    constexpr int P = 3 * GROUP / 4;  // float4s a row
    for (int e = lane; e < n_rows * P; e += 32) {
      const int i = e / P, f = (e - i * P) * 4;
      __stcs(reinterpret_cast<float4*>(out + row_at(i) + f),
             *reinterpret_cast<const float4*>(buf + i * ROW_PITCH + f));
    }
  } else {
    for (int i = 0; i < n_rows; ++i)
      if (lane < nf) __stcs(out + row_at(i) + lane, buf[i * ROW_PITCH + lane]);
  }
}

// The group walk, a lane a replicate (R > PAIR_R, one chunk: a group's
// weights fit only segments of up to 620 slots): one block of REPS_T
// threads an SM takes units (two neighbouring groups of gs segments, block
// of WRB replicates) from the counter until none is left, replicate-block
// major. A unit stages the groups' weights [slot][replicate] (pitch WRB +
// 1), a and totals once, then its warps take the queries in batches of 32
// (a lane loads query i's classes, and each group's mask words of the next
// query while this one is walked): for each (query, segment) the lane's
// replicate gets T (covered), +0.0 (empty) or the slot-order fold from +0.0
// of the mask's slots (MAYBE); each group's gs x 3 floats of a (replicate,
// query) row go out whole, the two groups' back to back, so that a row's 2
// x 96 bytes reach memory as whole 64-byte pieces (one group's 96 bytes
// alone leave a half piece, which memory then reads to write: +0.7 ms at
// the 24-column shape, tools/wide_walk_split.py).
__global__ void __launch_bounds__(REPS_T, 1)
weighted_group_reps_kernel(const float* __restrict__ a,
                           const float* __restrict__ W,
                           float* __restrict__ scratch,
                           float* __restrict__ out, int R, int Q, int k,
                           WPlan p) {
  extern __shared__ __align__(16) float s_g[];
  const int L = p.seg.s < CHUNK ? p.seg.s : CHUNK;  // a segment's stride
  const int G2 = 2 * p.gs;                           // segments a unit
  float* s_w = s_g;                                  // [G2 * L][WRB + 1]
  float* s_a = s_w + G2 * L * (WRB + 1);             // [G2 * L]
  float* s_t = s_a + G2 * L;                         // [G2][WRB][3]
  // [warp][32][ROW_PITCH], from a multiple of 4 floats.
  float* s_row = s_g + ((G2 * L * (WRB + 2) + G2 * WRB * 3 + 3) & ~3);
  __shared__ unsigned long long s_unit;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned long long* next = (unsigned long long*)(scratch + p.ctr);
  const uint8_t* cls = (const uint8_t*)(scratch + p.cls);
  const uint32_t* mask = (const uint32_t*)(scratch + p.mask);
  const float* T = scratch;
  const int K = p.K, NW = p.nw;
  const size_t ks = (size_t)k * p.seg.s;
  const int n_rb = (R + WRB - 1) / WRB, n_pair = (p.n_groups + 1) / 2;
  const unsigned long long n_units = (unsigned long long)n_pair * n_rb;
  float* buf = s_row + warp * 32 * ROW_PITCH;
  // Rows of a whole group start 16-byte aligned in out.
  const bool vec_out = K % 4 == 0 && ((uintptr_t)out & 15) == 0;
  // Lane gl * NW + w holds mask word w of a group's segment gl of a query
  // (gs * NW <= 32: make_wide_plan).
  const int mg = lane / NW, mw = lane - mg * NW;
  for (;;) {
    __syncthreads();  // the last unit's staged rows are read
    if (tid == 0) s_unit = atomicAdd(next, 1ULL);
    __syncthreads();
    const unsigned long long id = s_unit;
    if (id >= n_units) return;
    const int g0 = (int)(id % n_pair) * G2;
    const int r0 = (int)(id / n_pair) * WRB, nr = min(WRB, R - r0);
    const int gs2 = min(G2, K - g0);  // the unit's segments
    for (int i = tid; i < gs2 * L * nr; i += REPS_T) {
      const int rr = i / (gs2 * L), e = i - rr * gs2 * L;
      const int gl = e / L, j = e - gl * L;
      if (j < p.seg.len<false>(g0 + gl)) {
        const size_t o = p.seg.base<false>(g0 + gl) + j;
        cp_async4(s_w + e * (WRB + 1) + rr, W + (size_t)(r0 + rr) * ks + o);
        if (rr == 0) cp_async4(s_a + e, a + o);
      }
    }
    for (int i = tid; i < gs2 * nr * 3; i += REPS_T) {
      const int gl = i / (nr * 3), e = i - gl * nr * 3;
      const int rr = e / 3, m = e - rr * 3;
      s_t[(gl * WRB + rr) * 3 + m] =
          T[((size_t)(r0 + rr) * K + g0 + gl) * 3 + m];
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int qb = warp; qb * 32 < Q; qb += REPS_WARPS) {
      const int qa = qb * 32, nq = min(32, Q - qa);
      // Byte gl of cl[h]: the class of (query qa + lane, segment g0 + h *
      // gs + gl).
      uint64_t cl[2] = {0u, 0u};
      if (lane < nq)
        for (int gl = 0; gl < gs2; ++gl) {
          const uint64_t x = cls[(size_t)(g0 + gl) * Q + qa + lane];
          if (gl < p.gs)
            cl[0] |= x << (8 * gl);
          else
            cl[1] |= x << (8 * (gl - p.gs));
        }
      auto words = [&](int h, int i) {
        const int gh = g0 + h * p.gs;
        return i < nq && mg < min(p.gs, gs2 - h * p.gs)
                   ? mask[((size_t)(gh + mg) * NW + mw) * Q + qa + i]
                   : 0u;
      };
      uint32_t mw_next[2] = {words(0, 0), words(1, 0)};
      for (int i = 0; i < nq; ++i) {
        const int q = qa + i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gh = g0 + h * p.gs, gs = min(p.gs, gs2 - h * p.gs);
          if (gs <= 0) break;  // the same in every lane
          const uint32_t mw_cur = mw_next[h];
          mw_next[h] = words(h, i + 1);
          const uint64_t ci = __shfl_sync(0xffffffffu, cl[h], i);
          // Bit gl * NW + w: word w of a MAYBE pair of segment gh + gl
          // holds a relevant slot (the words of other pairs are not
          // written).
          const uint32_t nz = __ballot_sync(
              0xffffffffu, mg < gs && ((ci >> (8 * mg)) & 0xff) == MAYBE &&
                               mw * 32 < p.seg.len<false>(gh + mg) &&
                               mw_cur != 0u);
          const float* tw = s_t + h * p.gs * WRB * 3;
          const int ow = h * p.gs * L;
          float m[GROUP][3];
#pragma unroll
          for (int gl = 0; gl < GROUP; ++gl) {
            const bool cov = gl < gs && ((ci >> (8 * gl)) & 0xff) == COVERED;
            const float* t3 = tw + (gl * WRB + lane) * 3;
            m[gl][0] = cov ? t3[0] : 0.f;
            m[gl][1] = cov ? t3[1] : 0.f;
            m[gl][2] = cov ? t3[2] : 0.f;
            for (uint32_t wm = gl < gs ? (nz >> (gl * NW)) & ((1u << NW) - 1u)
                                       : 0u;
                 wm != 0u; wm &= wm - 1u) {
              const int w = __ffs(wm) - 1;
              uint32_t bits = __shfl_sync(0xffffffffu, mw_cur, gl * NW + w);
              const int o = ow + gl * L + w * 32;
              while (bits) {
                const int j = o + __ffs(bits) - 1;
                bits &= bits - 1;
                weighted_add(m[gl],
                             weighted_terms(s_w[j * (WRB + 1) + lane], s_a[j]));
              }
            }
          }
          put_row(buf + lane * ROW_PITCH, m, gs);
          __syncwarp();
          store_rows(buf, out, nr, gs * 3, gs == GROUP && vec_out,
                     [&](int rr) {
                       return (((size_t)(r0 + rr) * Q + q) * K + gh) * 3;
                     },
                     lane);
          __syncwarp();  // before the next rows overwrite buf
        }
      }
    }
  }
}

// The group walk, a lane a query (R <= PAIR_R, or a group's weights too
// large for the replicate walk): blocks take units (group, replicate)
// from the counter, replicate major. A unit stages the terms [w, w*a,
// (w*a)*a] of the group's slots (weighted_terms) and its totals once; its
// warps take the queries 32 at a time, a lane a query, each (query,
// segment) T, +0.0 or the slot-order fold of its mask's terms; each
// query's gs x 3 floats go out whole.
template <bool CH>
__global__ void __launch_bounds__(GW_T)
weighted_group_queries_kernel(const float* __restrict__ a,
                              const float* __restrict__ W,
                              float* __restrict__ scratch,
                              float* __restrict__ out, int R, int Q, int k,
                              WPlan p) {
  extern __shared__ __align__(16) float s_g[];
  const int L = p.seg.s < CHUNK ? p.seg.s : CHUNK;
  float4* s_v = (float4*)s_g;                      // [gs * L] the terms
  float* s_t = s_g + 4 * p.gs * L;                 // [gs][3]
  float* s_row = s_t + GROUP * 3;                  // [warp][32][ROW_PITCH]
  __shared__ unsigned long long s_unit;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned long long* next = (unsigned long long*)(scratch + p.ctr);
  const uint8_t* cls = (const uint8_t*)(scratch + p.cls);
  const uint32_t* mask = (const uint32_t*)(scratch + p.mask);
  const float* T = scratch;
  const int K = p.K, NW = p.nw;
  const size_t ks = (size_t)k * p.seg.s;
  const unsigned long long n_units =
      (unsigned long long)p.n_groups * R * p.parts;
  const int nbq = (Q + 31) / 32, bp = (nbq + p.parts - 1) / p.parts;
  float* buf = s_row + warp * 32 * ROW_PITCH;
  // Rows of a whole group start 16-byte aligned in out.
  const bool vec_out = K % 4 == 0 && ((uintptr_t)out & 15) == 0;
  for (;;) {
    __syncthreads();
    if (tid == 0) s_unit = atomicAdd(next, 1ULL);
    __syncthreads();
    const unsigned long long id = s_unit;
    if (id >= n_units) return;
    const int part = (int)(id % p.parts);
    const unsigned long long gu = id / p.parts;
    const int g0 = (int)(gu % p.n_groups) * p.gs;
    const int r = (int)(gu / p.n_groups);
    const int gs = min(p.gs, K - g0), nf = gs * 3;
    const bool vec = gs == GROUP && vec_out;
    const int qb_end = min(nbq, (part + 1) * bp);
    for (int e = tid; e < gs * L; e += GW_T) {
      const int gl = e / L, j = e - gl * L;
      if (j < p.seg.len<CH>(g0 + gl)) {
        const size_t o = p.seg.base<CH>(g0 + gl) + j;
        const Terms t = weighted_terms(W[(size_t)r * ks + o], a[o]);
        s_v[e] = make_float4(t.w, t.wa, t.waa, 0.f);
      }
    }
    if (tid < nf) s_t[tid] = T[((size_t)r * K + g0) * 3 + tid];
    __syncthreads();
    for (int qb = part * bp + warp; qb < qb_end; qb += GW_WARPS) {
      const int qa = qb * 32, q = qa + lane, nq = min(32, Q - qa);
      // The classes first, all loads in flight together.
      int code[GROUP];
#pragma unroll
      for (int gl = 0; gl < GROUP; ++gl)
        code[gl] = gl < gs && q < Q ? cls[(size_t)(g0 + gl) * Q + q] : EMPTY;
      float mq[GROUP][3];
#pragma unroll
      for (int gl = 0; gl < GROUP; ++gl) {
        float* m = mq[gl];
        m[0] = m[1] = m[2] = 0.f;
        if (gl < gs) {
          const int g = g0 + gl;
          if (code[gl] == COVERED) {
            m[0] = s_t[gl * 3];
            m[1] = s_t[gl * 3 + 1];
            m[2] = s_t[gl * 3 + 2];
          } else if (code[gl] == MAYBE) {
            const int nwd = (p.seg.len<CH>(g) + 31) / 32;
            for (int w = 0; w < nwd; ++w) {
              uint32_t bits = mask[((size_t)g * NW + w) * Q + q];
              const float4* v = s_v + gl * L + w * 32;
              while (bits) {
                const float4 x = v[__ffs(bits) - 1];
                bits &= bits - 1;
                weighted_add(m, Terms{x.x, x.y, x.z});
              }
            }
          }
        }
      }
      put_row(buf + lane * ROW_PITCH, mq, gs);
      __syncwarp();
      store_rows(buf, out, nq, nf, vec, [&](int i) {
        return (((size_t)r * Q + qa + i) * K + g0) * 3;
      }, lane);
      __syncwarp();
    }
  }
}

// A group walk's grid: the blocks the card holds at once at these shared-
// memory bytes (opted in above 48 KB), at most its units; cached per
// (kernel, device, bytes).
int walk_grid(const void* kernel, int bytes, int threads, long long units,
              int* grid) {
  struct Entry {
    const void* fn;
    int dev, bytes, most;
  };
  static Entry cache[32];
  static int n_cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int most = 0;
  for (int i = 0; i < n_cache; ++i)
    if (cache[i].fn == kernel && cache[i].dev == dev &&
        cache[i].bytes == bytes)
      most = cache[i].most;
  if (most == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, bytes);
    if (err != cudaSuccess) return (int)err;
    most = (per_sm > 0 ? per_sm : 1) * sms;
    if (n_cache < 32) cache[n_cache++] = Entry{kernel, dev, bytes, most};
  }
  *grid = (int)(units < most ? units : most);
  return 0;
}

template <bool CH>
int launch_wide(const float* c, const float* a, const uint8_t* valid,
                const float* W, const float* q_lo, const float* q_hi,
                float* out, float* scratch, int R, int Q, int k, int d,
                const WPlan& p, cudaStream_t stream) {
  const long long leaf_y = (p.K + LEAF_T - 1) / LEAF_T;
  if (leaf_y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
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
  weighted_box_wide_kernel<CH><<<(p.K + LEAF_T / 32 - 1) / (LEAF_T / 32),
                                 LEAF_T, 0, stream>>>(
      c, valid, scratch + p.box, (uint32_t*)(scratch + p.vbits),
      (int*)(scratch + p.nan), (uint32_t*)(scratch + p.nanw),
      (int*)(scratch + p.ctr), p.seg, p.K, p.nw, p.ncw, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  weighted_class_wide_kernel<CH><<<p.n_tiles, NT, 0, stream>>>(
      q_lo, q_hi, scratch, Q, d, p);
  const long long runs = (long long)p.K * ((Q + TQ - 1) / TQ);
  if (runs > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  weighted_test_wide_kernel<CH><<<(unsigned)runs, TQ, 0, stream>>>(
      c, q_lo, q_hi, scratch, Q, d, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Above one chunk the walk writes the partials.
  float* dst = CH ? scratch + p.part : out;
  int grid = 0, gerr;
  if (!CH && p.reps) {
    gerr = walk_grid((const void*)weighted_group_reps_kernel,
                     p.walk_bytes, REPS_T,
                     (long long)(p.n_groups + 1) / 2 * ((R + WRB - 1) / WRB),
                     &grid);
    if (gerr != 0) return gerr;
    weighted_group_reps_kernel<<<grid, REPS_T, p.walk_bytes, stream>>>(
        a, W, scratch, dst, R, Q, k, p);
  } else {
    gerr = walk_grid((const void*)weighted_group_queries_kernel<CH>,
                     p.walk_bytes, GW_T,
                     (long long)p.n_groups * R * p.parts, &grid);
    if (gerr != 0) return gerr;
    weighted_group_queries_kernel<CH><<<grid, GW_T, p.walk_bytes, stream>>>(
        a, W, scratch, dst, R, Q, k, p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !CH) return (int)err;
  const size_t n_pairs = (size_t)R * Q * k;
  const size_t blocks = (n_pairs + FOLD_T - 1) / FOLD_T;
  weighted_fold_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), FOLD_T,
                         0, stream>>>(scratch + p.part, out, n_pairs,
                                      p.seg.n_ch);
  return (int)cudaGetLastError();
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
  weighted_box_kernel<CH><<<(p.K + LEAF_T / 32 - 1) / (LEAF_T / 32), LEAF_T,
                            0, stream>>>(c, valid, scratch + p.box,
                                         (uint32_t*)(scratch + p.vbits),
                                         (int*)(scratch + p.nan),
                                         (int*)(scratch + p.ctr), p.seg, p.K,
                                         p.nw, d);
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
  if (d > MAX_D) {
    WPlan p;
    if (!make_wide_plan(R, Q, k, s, d, &p)) return (int)cudaErrorInvalidValue;
    if (scratch_floats < (long long)p.floats)
      return (int)cudaErrorInvalidValue;
    return p.seg.n_ch > 1
        ? launch_wide<true>(c, a, valid, W, q_lo, q_hi, out, scratch, R, Q,
                            k, d, p, stream)
        : launch_wide<false>(c, a, valid, W, q_lo, q_hi, out, scratch, R, Q,
                             k, d, p, stream);
  }
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
  if (d > MAX_D) {
    WPlan w;
    if (!make_wide_plan(1, Q, k, s, d, &w)) return (int)cudaErrorInvalidValue;
    *lt = LT_MAX;
    *bytes = 0;  // the class and test kernels' shared memory is static
    return 0;
  }
  Plan p;
  if (!make_plan(1, Q, k, s, d, &p)) return (int)cudaErrorInvalidValue;
  *lt = p.lt;
  *bytes = p.bytes;
  return 0;
}

// The floats of a launch's scratch, or -1 where no plan exists.
extern "C" long long repro_weighted_scratch(int R, int Q, int k, int s,
                                            int d) {
  if (d > MAX_D) {
    WPlan w;
    return make_wide_plan(R, Q, k, s, d, &w) ? (long long)w.floats : -1;
  }
  Plan p;
  return make_plan(R, Q, k, s, d, &p) ? (long long)p.floats : -1;
}

// The group walk of a launch at d > MAX_D: returns 1 for the replicate
// walk (a lane a replicate), 0 for the query walk, -1 without a plan; gs:
// segments a group, bytes: its dynamic shared memory.
extern "C" int repro_weighted_group(int R, int Q, int k, int s, int d,
                                    int* gs, int* bytes) {
  WPlan w;
  if (!make_wide_plan(R, Q, k, s, d, &w)) return -1;
  *gs = w.gs;
  *bytes = w.walk_bytes;
  return w.reps;
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
