// query_eval: classify every (query, leaf) pair and sum the aggregates of
// the covered leaves, in one pass.
//
// Replaces the Pallas kernel src/repro/kernels/query_eval.py::query_eval
// (body `_kernel`), which tiles (queries x leaves) on a sequential grid and
// accumulates `exact` with an MXU product cover(BQ, BK) @ leaf_agg(BK, 8).
//
// Output: rel (Q, k) int32, 2 = the query covers the leaf, 1 = partial,
// 0 = disjoint; an empty leaf (inverted box, lo > hi in some dimension)
// is 0. exact (Q, A) f32 = sum over covered leaves j of leaf_agg[j, :].
//
// Contract: the bits of the first version of this kernel. Its exact[q, a]
// starts at +0.0 and adds, in ascending leaf order, the aggregate of each
// covered leaf (`if (cover)`: an empty leaf's MIN/MAX columns hold +-inf),
// by FADD. Here the same sum runs over the covered leaves' list, in
// ascending order, through __fadd_rn; a batch that reads past the list's
// end adds +0.0, which changes no bits (a sum that starts at +0.0 never
// reaches -0.0 under round-to-nearest, and x + 0.0 = x for every other x).
// The classification is the first version's formula.
//
// What bounds it on an H100: memory. Per (query, leaf) pair it does ~4d
// compares and writes 4 bytes of rel; everything else (boxes, aggregates,
// query bounds) is O(k + Q). At Q = 2048, k = 1024 the rel write is 8 MB,
// ~2.5 us at 3.35 TB/s. The sums are a chain of dependent adds per (query,
// column), as long as the query's covered leaves: latency, not bytes.
//
// Design: a block of NT = 256 threads owns QB whole query rows (all k
// leaves), so each exact[q, a] is one register summed in one ascending
// pass with no second launch and no atomics. QB is the fewest queries that
// let ceil(Q / QB) blocks fill the card in one wave, by the occupancy
// calculator (at most MAX_QB). The block loops over leaf tiles of
// LK = 1024 leaves, four a thread:
//  1. The tile's aggregates (LK * A floats, one contiguous run) are copied
//     into shared memory by 16-byte cp.async, in flight while the threads
//     classify.
//  2. Thread t classifies leaves 4t .. 4t + 3 (their boxes in registers)
//     against each of the block's queries (bounds in shared memory) and
//     writes the four rel codes of a row with one 16-byte store when k is
//     a multiple of 4 (a warp writes 512 contiguous bytes of one row),
//     else four 4-byte stores. The four cover bits of eight neighbouring
//     lanes are OR-ed into one 32-bit word per 32 leaves (three shuffles):
//     the query's cover bitmask, in shared memory.
//  3. Warp w compacts query w's bitmask: lane i counts word i's bits, a
//     warp scan gives each word its offset, and the lane writes its set
//     bits' leaves there in ascending order (as offsets into the staged
//     aggregates): the covered leaves' list, ascending, padded to whole
//     batches of WALK with a slot that holds +0.0.
//  4. Thread (q, a), for q < QB and a < A, adds the listed leaves'
//     aggregates in list order: a batch's WALK offsets in one 16-byte
//     load, its values loaded one batch ahead of the adds, so that the
//     loads hide under the chain of adds. The sum carries into the next
//     tile.
// (A walk of the bitmask's set bits, whose loads wait on the bit search,
// was several times slower in a tuning run.)
// Any Q and k are taken by masking the ragged edge; leaves past k
// classify as empty and are never covered.
//
// Any d. Up to MAX_D = 16 columns the queries' bounds sit in shared memory
// and a leaf's box in registers, whole (D = 1..3 fixed at compile time, D
// = 0 up to 16). Above it the wide instantiation (D = -1) replaces step 2
// and moves step 1 after it; steps 3 and 4 are unchanged:
//  2'. The tile's boxes are staged once a block, WC = 8 columns at a time,
//     by cp.async (16 bytes a copy when d is a multiple of 4: a leaf's 8
//     columns are two copies), as they lie in device memory, a leaf's
//     columns in a row of 8 floats whose two halves swap places in every
//     other group of four leaves (so that a quarter-warp's 16-byte reads of
//     8 neighbouring leaves meet 32 banks). The next block's copies are in
//     flight while this block is classified. Thread t takes leaves t,
//     t + 256, t + 512 and t + 768 of the tile and reads their 8 columns
//     into registers; from them it forms their non-empty bits and its part
//     of the tile's box in each column (fminf of lo and of -hi: a NaN
//     drops out, leaves past k are +-inf), which a transposing halving
//     over the warp's lanes (16 shuffles) and the warps folds.
//     Each query's cut columns in the block are those where it does not
//     hold the tile's box: ql <= min lo and max hi <= qh fails (a NaN
//     bound, or a column that is NaN in every leaf, fails it). Every warp
//     forms all of the block's cut masks itself (two ballots), so no
//     barrier is spent on them. A (query, leaf) pair is compared on its
//     query's cut columns only. Where the query holds the tile's box, a
//     non-empty leaf is covered and not apart in that column (ql <= lo <=
//     hi <= qh), and an empty leaf is 0 whatever its columns say, so rel
//     is the formula's bit for bit: the compares are exact. The cut set is
//     a mask of the block's 8 columns, room for every column, so no query
//     falls back to a list of all of them (the capacity a list of cut
//     columns would need). A query's rel row goes out a 4-byte store a
//     leaf (a warp: 128 contiguous bytes), its cover word a ballot.
//  1'. The aggregates go into the staged columns' room once the last
//     block is read (cp.async, in flight while the last block's pairs are
//     compared and the rel rows written).
// The wide instantiation holds 2 blocks an SM (its shared memory, 84 KB).
//
// Shared memory: the aggregates (LK + 1) * A * 4 bytes (dynamic, 32 KB at
// A = 8; wide: the staged columns' 2 * LK * WC * 4 = 65,536 bytes, which
// the aggregates reuse), the lists MAX_QB * (LK + 16) * 2 = 16.3 KB, bitmasks, counts and
// bounds.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int LPT = 4;         // leaves per thread
constexpr int LK = NT * LPT;   // leaves per tile
constexpr int NW = LK / 32;    // cover words per query row and tile
constexpr int MAX_D = 16;      // predicate columns whole; above, a block
constexpr int MAX_A = 8;       // aggregate columns
constexpr int MAX_QB = NT / 32;  // queries per block: one warp compacts each
constexpr int WALK = 8;        // listed leaves a walk loads at once (16 B)
constexpr int MAX_DEVICES = 64;
constexpr int VARIANTS = 10;
constexpr int WC = 8;          // wide: columns a staged block
constexpr int WIDE_BYTES = 2 * LK * WC * 4;  // wide: the staged block

static_assert(NW == 32, "one lane per cover word");
static_assert(MAX_QB * MAX_A <= NT, "a walker per (query, column)");
static_assert(MAX_QB * LPT <= 32, "a thread's pairs' bits in one word");
static_assert(WC == 8 && NT == 256, "two 16-B chunks a leaf; 16 partials");
static_assert(MAX_QB <= 8 && 2 * WC <= MAX_D, "two ballots; two halves");
static_assert(WIDE_BYTES >= (LK + 1) * MAX_A * 4, "aggregates in its room");

// dst[i] = src[i] for i < n (dst in shared memory, 16-byte aligned): by
// 16-byte cp.async when src is 16-byte aligned too, a 4-byte copy for the
// tail and otherwise. The caller commits, waits and syncs.
__device__ __forceinline__ void stage_run(float* dst,
                                          const float* __restrict__ src,
                                          int n) {
  int head = 0;
  if (((uintptr_t)src & 15) == 0) {
    head = n & ~3;
    for (int i = 4 * threadIdx.x; i < head; i += 4 * NT) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + i));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = head + threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// One step of the wide instantiation's transposing halving: of its values
// v[0 .. 2 HALF), lane L keeps the half its bit 2 HALF picks and folds in
// the other lane's (L ^ 2 HALF) copy of it, into v[0 .. HALF).
template <int HALF>
__device__ __forceinline__ void halve(float (&v)[2 * WC], int lane) {
  const bool up = lane & (2 * HALF);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = up ? v[HALF + i] : v[i];
    const float send = up ? v[i] : v[HALF + i];
    v[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, 2 * HALF));
  }
}

// The wide instantiation's copies (step 2'): columns j0 .. j0 + WC - 1
// (clipped to d) of the tile's leaves k0 .. k0 + LK - 1 (clipped to k)
// into s_blo / s_bhi[leaf][WC], a leaf's two 4-column halves swapped in
// every other group of four leaves, by cp.async (16 bytes a copy when vec:
// d a multiple of 4 and the boxes 16-byte aligned); then the block's
// queries' bounds of those columns into half h of s_qlo / s_qhi. The
// caller waits and syncs.
__device__ __forceinline__ void stage_wide(
    float* s_blo, float* s_bhi, float (*s_qlo)[MAX_D], float (*s_qhi)[MAX_D],
    const float* __restrict__ leaf_lo, const float* __restrict__ leaf_hi,
    const float* __restrict__ q_lo, const float* __restrict__ q_hi,
    bool vec, int k0, int k, int j0, int d, int h, int q0, int nq) {
  const int tid = threadIdx.x;
  const int nj = min(WC, d - j0);
  if (vec) {  // nj is 4 or 8: whole 16-byte chunks
    const int per = nj >> 2;
    for (int i = tid; i < LK * per; i += NT) {
      const int l = per == 2 ? i >> 1 : i, c = per == 2 ? i & 1 : 0;
      if (k0 + l < k) {
        const int at = l * WC + 4 * (c ^ ((l >> 2) & 1));
        const size_t src = (size_t)(k0 + l) * d + j0 + 4 * c;
        cp_async16(s_blo + at, leaf_lo + src);
        cp_async16(s_bhi + at, leaf_hi + src);
      }
    }
  } else {
    for (int i = tid; i < LK * nj; i += NT) {
      const int l = i / nj, j = i - l * nj;
      if (k0 + l < k) {
        const int at = l * WC + 4 * ((j >> 2) ^ ((l >> 2) & 1)) + (j & 3);
        const size_t src = (size_t)(k0 + l) * d + j0 + j;
        cp_async4(s_blo + at, leaf_lo + src);
        cp_async4(s_bhi + at, leaf_hi + src);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < nq * nj; i += NT) {
    const int qq = i / nj, j = i - qq * nj;
    s_qlo[qq][h * WC + j] = q_lo[(size_t)(q0 + qq) * d + j0 + j];
    s_qhi[qq][h * WC + j] = q_hi[(size_t)(q0 + qq) * d + j0 + j];
  }
}

// One block per QB queries. D > 0 fixes d at compile time, D = 0 takes d
// up to MAX_D, D = -1 any d in staged blocks of WC columns; VEC writes rel
// rows with 16-byte stores (k a multiple of 4, rel 16-byte aligned).
template <int D, bool VEC>
__global__ void __launch_bounds__(NT)
query_eval_kernel(const float* __restrict__ leaf_lo,
                  const float* __restrict__ leaf_hi,
                  const float* __restrict__ leaf_agg,
                  const float* __restrict__ q_lo,
                  const float* __restrict__ q_hi,
                  int32_t* __restrict__ rel, float* __restrict__ exact,
                  int Q, int k, int d, int A, int QB) {
  constexpr int DD = D > 0 ? D : MAX_D;
  if (D > 0) d = D;
  // [leaf][a] of the tile, then A zeros (the list's padding reads them)
  extern __shared__ __align__(16) float s_agg[];
  // Per query its covered leaves' offsets in s_agg; a row is 32 bytes
  // past a multiple of 128, so that the walkers' batch loads of several
  // queries fall on different banks.
  __shared__ __align__(16) uint16_t s_list[MAX_QB][LK + 2 * WALK];
  __shared__ unsigned s_mask[MAX_QB][NW];
  __shared__ int s_count[MAX_QB];
  __shared__ float s_qlo[MAX_QB][MAX_D];
  __shared__ float s_qhi[MAX_QB][MAX_D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, Q - q0);
  if (D >= 0) {
    for (int i = tid; i < nq * d; i += NT) {
      const int qq = i / d, j = i - qq * d;
      s_qlo[qq][j] = q_lo[(size_t)q0 * d + i];
      s_qhi[qq][j] = q_hi[(size_t)q0 * d + i];
    }
  }
  if (tid < A) s_agg[LK * A + tid] = 0.f;
  const bool walker = tid < nq * A;
  const int wq = walker ? tid / A : 0, wa = walker ? tid - wq * A : 0;
  float acc = 0.f;

  for (int k0 = 0; k0 < k; k0 += LK) {
    const int n = min(LK, k - k0);
    const int n_agg = n * A;
    __syncthreads();  // the previous tile's walk is done with shared memory

    // 1. The tile's aggregates, one run, copied into shared memory by
    // cp.async while the threads classify (wide: after, 1').
    if constexpr (D >= 0) stage_run(s_agg, leaf_agg + (size_t)k0 * A, n_agg);

    // 2. Classification of leaves leaf0 .. leaf0 + 3 (past k: empty).
    const int leaf0 = k0 + tid * LPT;
    if constexpr (D < 0) {
      // 2'. The columns in blocks of WC, staged (design above, "Any d").
      // Thread t's leaves are t + NT * u; bit qq * LPT + u of cov / dis:
      // query qq covers / is apart from leaf u in every cut column so far /
      // in some cut column; bit u of ne: leaf u is not inverted so far.
      __shared__ float s_tred[NT / 32][2 * WC];  // each warp's fminf of lo
                                                  // and of -hi, a column
      float* s_blo = s_agg;                       // [leaf][WC], swizzled
      float* s_bhi = s_agg + LK * WC;
      const bool vec = (d & 3) == 0 &&
                       (((uintptr_t)leaf_lo | (uintptr_t)leaf_hi) & 15) == 0;
      unsigned cov = 0xffffffffu, dis = 0u, ne = (1u << LPT) - 1u;
      stage_wide(s_blo, s_bhi, s_qlo, s_qhi, leaf_lo, leaf_hi, q_lo, q_hi,
                 vec, k0, k, 0, d, 0, q0, nq);
      for (int j0 = 0, h = 0; j0 < d; j0 += WC, h ^= 1) {
        const int nj = min(WC, d - j0);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();  // the block's columns and bounds are in
        // The thread's leaves' columns (past k: an empty +-inf box).
        float lo[LPT][WC], hi[LPT][WC];
#pragma unroll
        for (int u = 0; u < LPT; ++u) {
          const int l = tid + NT * u;
          const int sw = 4 * ((l >> 2) & 1);
          const float4 a0 = *reinterpret_cast<const float4*>(s_blo + l * WC + sw);
          const float4 a1 =
              *reinterpret_cast<const float4*>(s_blo + l * WC + (4 - sw));
          const float4 b0 = *reinterpret_cast<const float4*>(s_bhi + l * WC + sw);
          const float4 b1 =
              *reinterpret_cast<const float4*>(s_bhi + l * WC + (4 - sw));
          const float la[WC] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float ha[WC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          const bool in = k0 + l < k;
#pragma unroll
          for (int j = 0; j < WC; ++j) {
            const bool on = in && j < nj;
            lo[u][j] = on ? la[j] : CUDART_INF_F;
            hi[u][j] = on ? ha[j] : -CUDART_INF_F;
            if (j < nj && !(lo[u][j] <= hi[u][j])) ne &= ~(1u << u);
          }
        }
        // The tile's box: each column's fminf of lo and of -hi over the
        // thread's leaves, then over the warp (a transposing halving: lane
        // L ends with value (L >> 1) & 15), then over the warps.
        float v[2 * WC];
#pragma unroll
        for (int j = 0; j < WC; ++j) {
          v[j] = fminf(fminf(lo[0][j], lo[1][j]), fminf(lo[2][j], lo[3][j]));
          v[WC + j] = fminf(fminf(-hi[0][j], -hi[1][j]),
                            fminf(-hi[2][j], -hi[3][j]));
        }
        halve<WC>(v, lane);
        halve<WC / 2>(v, lane);
        halve<WC / 4>(v, lane);
        halve<WC / 8>(v, lane);
        v[0] = fminf(v[0], __shfl_xor_sync(0xffffffffu, v[0], 1));
        if ((lane & 1) == 0) s_tred[warp][(lane >> 1) & 15] = v[0];
        __syncthreads();  // every thread holds its leaves' columns
        if (j0 + WC < d) {
          stage_wide(s_blo, s_bhi, s_qlo, s_qhi, leaf_lo, leaf_hi, q_lo, q_hi,
                     vec, k0, k, j0 + WC, d, h ^ 1, q0, nq);
        } else {
          // 1'. The staged columns are read: the aggregates take their
          // room, in flight while the last block's pairs are compared and
          // the rel rows written.
          if (tid < A) s_agg[LK * A + tid] = 0.f;
          stage_run(s_agg, leaf_agg + (size_t)k0 * A, n_agg);
        }
        // The cut masks: lane 8 * qa + jj tests column jj of queries qa
        // and qa + 4; bit 8 * qa + jj of cut[0] / cut[1].
        const int jj = lane & (WC - 1), qa = lane >> 3;
        float tl = s_tred[0][jj], nth = s_tred[0][WC + jj];
#pragma unroll
        for (int w = 1; w < NT / 32; ++w) {
          tl = fminf(tl, s_tred[w][jj]);
          nth = fminf(nth, s_tred[w][WC + jj]);
        }
        unsigned cut[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int qq = qa + 4 * p;
          const bool live = jj < nj && qq < nq;
          const bool held = live && s_qlo[qq][h * WC + jj] <= tl &&
                            -nth <= s_qhi[qq][h * WC + jj];
          cut[p] = __ballot_sync(0xffffffffu, live && !held);
        }
        for (int qq = 0; qq < nq; ++qq) {
          const unsigned cm =
              ((qq < 4 ? cut[0] : cut[1]) >> (WC * (qq & 3))) & 0xffu;
          if (cm == 0u) continue;
          bool cover[LPT], apart[LPT];
#pragma unroll
          for (int u = 0; u < LPT; ++u) {
            cover[u] = true;
            apart[u] = false;
          }
#pragma unroll
          for (int j = 0; j < WC; ++j) {
            if ((cm >> j) & 1u) {
              const float ql = s_qlo[qq][h * WC + j];
              const float qh = s_qhi[qq][h * WC + j];
#pragma unroll
              for (int u = 0; u < LPT; ++u) {
                cover[u] &= (ql <= lo[u][j]) & (hi[u][j] <= qh);
                apart[u] |= (qh < lo[u][j]) | (ql > hi[u][j]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < LPT; ++u) {
            const unsigned bit = 1u << (qq * LPT + u);
            if (!cover[u]) cov &= ~bit;
            if (apart[u]) dis |= bit;
          }
        }
      }
      for (int qq = 0; qq < nq; ++qq) {
        int32_t* row = rel + (size_t)(q0 + qq) * k;
#pragma unroll
        for (int u = 0; u < LPT; ++u) {
          const int l = tid + NT * u;
          const bool nonempty = (ne >> u) & 1u;
          const unsigned at = qq * LPT + u;
          const bool cover = nonempty & ((cov >> at) & 1u);
          const bool disjoint = !nonempty | ((dis >> at) & 1u);
          if (k0 + l < k) row[k0 + l] = cover ? 2 : (disjoint ? 0 : 1);
          const unsigned word = __ballot_sync(0xffffffffu, cover);
          if (lane == 0) s_mask[qq][warp + (NT / 32) * u] = word;
        }
      }
    } else {
      float lo[DD][LPT], hi[DD][LPT];
      bool nonempty[LPT];
#pragma unroll
      for (int u = 0; u < LPT; ++u) {
        const bool in = leaf0 + u < k;
        nonempty[u] = true;
#pragma unroll
        for (int j = 0; j < DD; ++j) {
          if (j < d) {
            lo[j][u] = in ? leaf_lo[(size_t)(leaf0 + u) * d + j] : 1.f;
            hi[j][u] = in ? leaf_hi[(size_t)(leaf0 + u) * d + j] : -1.f;
            nonempty[u] &= lo[j][u] <= hi[j][u];
          }
        }
      }
      for (int qq = 0; qq < nq; ++qq) {
        int code[LPT];
        unsigned bits = 0;
#pragma unroll
        for (int u = 0; u < LPT; ++u) {
          bool cover = nonempty[u], disjoint = !nonempty[u];
#pragma unroll
          for (int j = 0; j < DD; ++j) {
            if (j < d) {
              const float ql = s_qlo[qq][j], qh = s_qhi[qq][j];
              cover &= (ql <= lo[j][u]) & (hi[j][u] <= qh);
              disjoint |= (qh < lo[j][u]) | (ql > hi[j][u]);
            }
          }
          code[u] = cover ? 2 : (disjoint ? 0 : 1);
          bits |= (unsigned)cover << u;
        }
        int32_t* row = rel + (size_t)(q0 + qq) * k;
        if (VEC) {
          if (leaf0 < k)
            *reinterpret_cast<int4*>(row + leaf0) =
                make_int4(code[0], code[1], code[2], code[3]);
        } else {
#pragma unroll
          for (int u = 0; u < LPT; ++u)
            if (leaf0 + u < k) row[leaf0 + u] = code[u];
        }
        bits <<= (lane & 7) * LPT;
        bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
        bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
        bits |= __shfl_xor_sync(0xffffffffu, bits, 4);
        if ((lane & 7) == 0) s_mask[qq][tid >> 3] = bits;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // 3. Warp qq lists query qq's covered leaves in ascending order, as
    // their offsets in s_agg, then pads the list to a whole batch and one
    // more (the prefetch's) with the zero slot's offset.
    if (warp < nq) {
      unsigned m = s_mask[warp][lane];
      const int c = __popc(m);
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      uint16_t* list = s_list[warp];
      for (int i = incl - c; m; ++i, m &= m - 1)
        list[i] = (uint16_t)((lane * 32 + __ffs(m) - 1) * A);
      const int cnt = __shfl_sync(0xffffffffu, incl, 31);
      const int end = (cnt + WALK - 1) / WALK * WALK + WALK;
      if (cnt + lane < end) list[cnt + lane] = (uint16_t)(LK * A);
      if (lane == 0) s_count[warp] = cnt;
    }
    __syncthreads();

    // 4. The listed aggregates in list order: each batch's WALK offsets in
    // one 16-byte load, its values loaded a batch ahead of the adds. The
    // padding adds +0.0.
    if (walker) {
      const int batches = (s_count[wq] + WALK - 1) / WALK;
      const uint16_t* list = s_list[wq];
      const float* ag = s_agg + wa;
      float v[WALK];
      auto load = [&](int b, float* x) {
        const uint4 w = *reinterpret_cast<const uint4*>(list + b * WALK);
        const unsigned h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int u = 0; u < WALK / 2; ++u) {
          x[2 * u] = ag[h[u] & 0xffffu];
          x[2 * u + 1] = ag[h[u] >> 16];
        }
      };
      load(0, v);
      for (int b = 0; b < batches; ++b) {
        float nv[WALK];
        load(b + 1, nv);
#pragma unroll
        for (int u = 0; u < WALK; ++u) acc = __fadd_rn(acc, v[u]);
#pragma unroll
        for (int u = 0; u < WALK; ++u) v[u] = nv[u];
      }
    }
  }
  if (walker) exact[(size_t)(q0 + wq) * A + wa] = acc;
}

}  // namespace

// The launch's constants, for the wrapper's checks.
extern "C" int repro_query_eval_threads() { return NT; }
extern "C" int repro_query_eval_leaf_tile() { return LK; }
extern "C" int repro_query_eval_max_queries() { return MAX_QB; }
extern "C" int repro_query_eval_wide_cols() { return WC; }

extern "C" int repro_query_eval(const float* leaf_lo, const float* leaf_hi,
                                const float* leaf_agg, const float* q_lo,
                                const float* q_hi, int32_t* rel, float* exact,
                                int Q, int k, int d, int A, void* stream) {
  if (Q < 1 || k < 1 || d < 1 || A < 1 || A > MAX_A)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const bool vec = k % 4 == 0 && ((uintptr_t)rel & 15) == 0;
  const int variant =
      d > MAX_D ? 8 + vec : (vec ? 4 : 0) + (d <= 3 ? d : 0);
  using Kernel = void (*)(const float*, const float*, const float*,
                          const float*, const float*, int32_t*, float*, int,
                          int, int, int, int);
  Kernel kernel;
  switch (variant) {
    case 1: kernel = query_eval_kernel<1, false>; break;
    case 2: kernel = query_eval_kernel<2, false>; break;
    case 3: kernel = query_eval_kernel<3, false>; break;
    case 4: kernel = query_eval_kernel<0, true>; break;
    case 5: kernel = query_eval_kernel<1, true>; break;
    case 6: kernel = query_eval_kernel<2, true>; break;
    case 7: kernel = query_eval_kernel<3, true>; break;
    case 8: kernel = query_eval_kernel<-1, false>; break;
    case 9: kernel = query_eval_kernel<-1, true>; break;
    default: kernel = query_eval_kernel<0, false>; break;
  }
  // the aggregates and the zero slot (wide: the staged columns' room)
  const int bytes = d > MAX_D ? WIDE_BYTES : (LK + 1) * A * 4;
  // Per device, variant and A, once: the opt-in to the largest dynamic
  // shared memory (the static part and the aggregates of A = 8 pass 48 KB)
  // and the blocks the card holds at once, the multiprocessors times the
  // occupancy calculator's blocks each.
  static int resident[MAX_DEVICES][VARIANTS][MAX_A + 1];
  if (resident[dev][variant][A] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d > MAX_D ? WIDE_BYTES : (LK + 1) * MAX_A * 4);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        bytes);
    if (err != cudaSuccess) return (int)err;
    resident[dev][variant][A] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  // The fewest queries a block that fill the card in one wave.
  const long long res = resident[dev][variant][A];
  long long qb = (Q + res - 1) / res;
  qb = qb < 1 ? 1 : qb > MAX_QB ? MAX_QB : qb;
  const int blocks = (int)((Q + qb - 1) / qb);
  kernel<<<blocks, NT, bytes, (cudaStream_t)stream>>>(
      leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi, rel, exact, Q, k, d, A,
      (int)qb);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
