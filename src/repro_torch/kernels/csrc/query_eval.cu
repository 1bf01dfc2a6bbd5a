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
// = 0 up to 16). Above it the wide instantiation (D = -1) takes the
// columns in blocks of 16: the block's bounds in the same shared arrays,
// the leaves' box columns of the block in the same registers, and the
// thread's (query, leaf) pairs' cover and disjoint bits (8 queries x 4
// leaves: one 32-bit word each) and its leaves' non-empty bits ANDed /
// ORed over the blocks. The compares are exact, so rel is the d <= 16
// formula's whatever the block order; steps 1, 3 and 4 are unchanged.
//
// Shared memory: the aggregates (LK + 1) * A * 4 bytes (dynamic, 32 KB at
// A = 8), the lists MAX_QB * (LK + 16) * 2 = 16.3 KB, bitmasks, counts and
// bounds.
#include <cuda_runtime.h>
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

static_assert(NW == 32, "one lane per cover word");
static_assert(MAX_QB * MAX_A <= NT, "a walker per (query, column)");
static_assert(MAX_QB * LPT <= 32, "a thread's pairs' bits in one word");

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

// One block per QB queries. D > 0 fixes d at compile time, D = 0 takes d
// up to MAX_D, D = -1 any d in blocks of MAX_D columns; VEC writes rel
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
    // cp.async while the threads classify.
    stage_run(s_agg, leaf_agg + (size_t)k0 * A, n_agg);

    // 2. Classification of leaves leaf0 .. leaf0 + 3 (past k: empty).
    const int leaf0 = k0 + tid * LPT;
    if constexpr (D < 0) {
      // The columns in blocks of MAX_D: the block's query bounds in
      // s_qlo / s_qhi, the leaves' columns of the block in registers. Bit
      // qq * LPT + u of cov / dis: query qq covers / is disjoint from leaf
      // u in every block so far / in some block; bit u of ne: leaf u is
      // not inverted in any column so far.
      unsigned cov = 0xffffffffu, dis = 0u, ne = (1u << LPT) - 1u;
      for (int j0 = 0; j0 < d; j0 += MAX_D) {
        const int nj = min(MAX_D, d - j0);
        __syncthreads();  // the previous block's bounds are read
        for (int i = tid; i < nq * nj; i += NT) {
          const int qq = i / nj, j = i - qq * nj;
          s_qlo[qq][j] = q_lo[(size_t)(q0 + qq) * d + j0 + j];
          s_qhi[qq][j] = q_hi[(size_t)(q0 + qq) * d + j0 + j];
        }
        __syncthreads();
        float lo[MAX_D][LPT], hi[MAX_D][LPT];
#pragma unroll
        for (int u = 0; u < LPT; ++u) {
          const bool in = leaf0 + u < k;
          const size_t row = (size_t)(leaf0 + u) * d + j0;
#pragma unroll
          for (int j = 0; j < MAX_D; ++j) {
            if (j < nj) {
              lo[j][u] = in ? leaf_lo[row + j] : 1.f;
              hi[j][u] = in ? leaf_hi[row + j] : -1.f;
              if (!(lo[j][u] <= hi[j][u])) ne &= ~(1u << u);
            }
          }
        }
        for (int qq = 0; qq < nq; ++qq) {
#pragma unroll
          for (int u = 0; u < LPT; ++u) {
            bool cover = true, disjoint = false;
#pragma unroll
            for (int j = 0; j < MAX_D; ++j) {
              if (j < nj) {
                const float ql = s_qlo[qq][j], qh = s_qhi[qq][j];
                cover &= (ql <= lo[j][u]) & (hi[j][u] <= qh);
                disjoint |= (qh < lo[j][u]) | (ql > hi[j][u]);
              }
            }
            const unsigned bit = 1u << (qq * LPT + u);
            if (!cover) cov &= ~bit;
            if (disjoint) dis |= bit;
          }
        }
      }
      for (int qq = 0; qq < nq; ++qq) {
        int code[LPT];
        unsigned bits = 0;
#pragma unroll
        for (int u = 0; u < LPT; ++u) {
          const bool nonempty = (ne >> u) & 1u;
          const unsigned at = qq * LPT + u;
          const bool cover = nonempty & ((cov >> at) & 1u);
          const bool disjoint = !nonempty | ((dis >> at) & 1u);
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
  const int bytes = (LK + 1) * A * 4;  // the aggregates and the zero slot
  // Per device, variant and A, once: the opt-in to the largest dynamic
  // shared memory (the static part and the aggregates of A = 8 pass 48 KB)
  // and the blocks the card holds at once, the multiprocessors times the
  // occupancy calculator's blocks each.
  static int resident[MAX_DEVICES][VARIANTS][MAX_A + 1];
  if (resident[dev][variant][A] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (LK + 1) * MAX_A * 4);
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
