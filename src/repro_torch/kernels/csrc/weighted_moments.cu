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
// What bounds it on an H100: at the bootstrap's shapes (Q = 2048, k =
// 1024, s = 75, R = 200) the bytes of the (R, Q, k, 3) output, 5.03 GB,
// ~1.5 ms at 3.35 TB/s. The operations come under that. At few strata
// with many slots (Table 1's US arm: k = 1, s = 38,500) the operations of
// the mixed pairs' walks.
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
// covered or empty and the work is the output's store. Four kernels per
// launch, a fifth above one chunk:
//
//  1. weighted_totals_kernel: T[r, g] over the segment's valid slots in
//     slot order. One warp per (replicate, 32 segments) stages 32 slots of
//     each at a time with coalesced loads; lane l walks segment l.
//  2. weighted_box_kernel: one warp per segment writes the box around its
//     valid samples (+inf / -inf without one), its valid bits and a flag
//     for a NaN coordinate on a valid slot: fminf / fmaxf skip a NaN that
//     the slot test rejects, so a flagged segment is never covered.
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
//     c. lists the mixed pairs with their masks in the scratch;
//     d. loops over all R replicates in batches of RB_MAX, reusing the
//        classes: it stages the batch's totals tile with cp.async (the next
//        batch's load while this one is stored) and writes each
//        replicate's (QT, LT, 3) tile as rows of LT * 12 contiguous bytes,
//        T for covered pairs and +0.0 elsewhere: 16-byte streaming stores
//        when the segment count and LT are multiples of 4 (every row then
//        starts 16-byte aligned), 4-byte ones otherwise; neighbouring
//        threads write neighbouring addresses.
//  4. weighted_mixed_kernel: one thread per (mixed pair, replicate) walks
//     the set bits of the pair's mask in ascending slot order, WALK slot
//     loads in flight at a time, and overwrites the pair's +0.0. Its
//     products
//     w*a and (w*a)*a are formed where they are added: only mixed (pair,
//     replicate, slot) triples reach them (0.2 % of the pairs in 1-D on
//     the bootstrap's queries), so staging them once per (replicate, slot)
//     would cost shared memory sized for the worst case and a barrier per
//     batch for little. Walking inside the tile kernel would hold all its
//     warps at each batch's barrier for the walk's load latency; in a
//     kernel of its own the walks wait for nothing.
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
// mask would not fit, LT halves.
// Registers are capped at 64 (4 blocks an SM); nvcc -Xptxas=-v prints the
// counts at build. No float atomics, no tensor cores (no TF32): after the
// cover/empty split no large contraction is left to feed them.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per tile block: 8 warps
constexpr int TILE_BLOCKS = 4;   // tile blocks an SM: caps registers at 64
constexpr int RB_MAX = 8;        // replicates per batch of the tile loop
constexpr int QT = 32;           // queries per tile: one per lane
constexpr int LT_MAX = 32;       // segments per tile
constexpr int MAX_D = 16;        // predicate columns
constexpr int CHUNK = 2048;      // slots a segment: the order contract
constexpr int LEAF_T = 128;      // threads per totals and box block
constexpr int MIX_T = 128;       // threads per mixed-pair block
constexpr int MIX_R = 16;        // replicates per mixed-pair block
constexpr int WALK = 8;          // slot loads in flight per mixed pair
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
  size_t box, vbits, nan, counts, pairs, part, floats;  // scratch offsets
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
    p.sl = sl < lt ? sl : lt;
    long long off = 0;
    p.off_t = (int)off;    off = align16(off + 2LL * RB_MAX * lt * 12);
    p.off_box = (int)off;  off = align16(off + 8LL * lt * d);
    p.off_c = (int)off;    off = align16(off + 8LL * p.sl * 32 * d);
    p.off_mask = (int)off; off = align16(off + 4LL * nw * lt * QT);
    p.off_cls = (int)off;  off = align16(off + (long long)QT * lt);
    p.off_meta = (int)off; off = align16(off + 4LL * (3 * LT_MAX + 2));
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
    p.pairs = p.counts + p.n_tiles;
    // The partials start 16-byte aligned: the tiles store 4 floats at once.
    const size_t end = p.pairs + (size_t)p.n_tiles * QT * lt * (1 + nw);
    p.part = (end + 3) & ~(size_t)3;
    p.floats = n_ch > 1 ? p.part + (size_t)R * Q * K * 3 : end;
    *plan = p;
    return true;
  }
  return false;
}

// Per (replicate, segment): T = the moments of the segment's valid slots
// in slot order. One warp per (replicate, 32 segments) stages 32 slots of
// each at a time with coalesced loads; lane l then walks segment l's.
template <bool CH>
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
  const int my_len = lane < nl ? seg.len<CH>(g0 + lane) : 0;
  const int span = seg.s < CHUNK ? seg.s : CHUNK;  // the longest segment
  float m[3] = {0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < span; s0 += 32) {
    auto stage = [&](int li, size_t o) {
      s_w[warp][li][lane] = w[o];
      s_a[warp][li][lane] = a[o];
      s_v[warp][li][lane] = valid[o];
    };
    if (CH) {
      for (int li = 0; li < nl; ++li) {
        const int g = g0 + li;
        if (lane < min(32, seg.len<CH>(g) - s0))
          stage(li, seg.base<CH>(g) + s0 + lane);
      }
    } else if (lane < min(32, seg.s - s0)) {
      // One bound for the warp's segments: their loads issue together.
      for (int li = 0; li < nl; ++li)
        stage(li, (size_t)(g0 + li) * seg.s + s0 + lane);
    }
    __syncwarp();
    if (lane < nl) {
      const int n = min(32, my_len - s0);
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

// Per segment (one warp): its box around its valid samples (lo = +inf, hi
// = -inf without one), its valid bits, 32 slots a word (nw words, zero
// past its slots), and its NaN flag (1 iff a valid slot holds a NaN
// coordinate, x != x).
template <bool CH>
__global__ void __launch_bounds__(LEAF_T)
weighted_box_kernel(const float* __restrict__ c,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ box, uint32_t* __restrict__ vbits,
                    int* __restrict__ nan_flag, Segs seg, int K, int nw,
                    int d) {
  const int g = blockIdx.x * (LEAF_T / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
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

// One block per tile of QT queries x LT segments: classes, the mixed
// pairs' masks into the scratch, and every replicate's tile with T for
// covered pairs and +0.0 elsewhere, into `out` (R, Q, K, 3): the output
// itself at one segment a leaf, the partials above. VW floats per store (4
// when K and LT are multiples of 4, else 1); D > 0 fixes d at compile
// time.
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
  int* s_flag = (int*)(smem + p.off_meta);  // segment has a MAYBE pair
  int* s_rank = s_flag + LT_MAX;            // its rank among those
  int* s_list = s_rank + LT_MAX;            // those segments in order
  int* s_count = s_list + LT_MAX;           // [0] such segments, [1] mixed
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
  if (tid == 0) s_count[1] = 0;
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
        if (ch == NW - 1 && test)
          s_cls[lane * LT + l] = cnt[i] == 0 ? EMPTY : MIXED;
      }
    }
    __syncthreads();  // before stage(t + 2) overwrites this buffer
  }
  __syncthreads();

  // 3. The mixed pairs and their masks go to the scratch for the mixed
  // kernel: entry = (q << 16 | segment, NW mask words). The integer
  // atomic only orders the entries; no output depends on the order.
  uint32_t* pairs = (uint32_t*)(scratch + p.pairs) +
                    (size_t)tile * QT * LT * (1 + NW);
  for (int pi = tid; pi < QT * LT; pi += NT) {
    if (s_cls[pi] == MIXED) {
      const int e = atomicAdd(&s_count[1], 1);
      const int q = pi / LT, l = pi - q * LT;
      uint32_t* ent = pairs + (size_t)e * (1 + NW);
      ent[0] = ((uint32_t)q << 16) | (uint32_t)l;
      for (int wd = 0; wd < NW; ++wd)
        ent[1 + wd] = s_mask[(wd * LT + s_rank[l]) * QT + q];
    }
  }
  __syncthreads();
  if (tid == 0) ((int*)(scratch + p.counts))[tile] = s_count[1];

  // 4. The store units this thread owns (VW floats each) and which of
  // their floats are covered; the same for every replicate.
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

// The mixed pairs of tile blockIdx.x for replicates [blockIdx.y * MIX_R,
// + MIX_R): one thread per (pair, replicate) walks the set bits of the
// pair's mask in ascending slot order and overwrites the +0.0 that the
// tile kernel wrote there. The loads of up to WALK slots are in flight
// together; the updates run in slot order.
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
  weighted_totals_kernel<CH><<<dim3(R, (unsigned)leaf_y), LEAF_T, 0,
                               stream>>>(a, valid, W, scratch, k, p.seg,
                                         p.K);
  weighted_box_kernel<CH><<<(p.K + LEAF_T / 32 - 1) / (LEAF_T / 32), LEAF_T,
                            0, stream>>>(c, valid, scratch + p.box,
                                         (uint32_t*)(scratch + p.vbits),
                                         (int*)(scratch + p.nan), p.seg, p.K,
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

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
