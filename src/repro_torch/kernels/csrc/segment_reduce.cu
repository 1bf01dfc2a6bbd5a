// segment_reduce: per-segment [sum v, sum v^2, count, min, max] of the
// values whose segment id lies in [0, k); other ids (-1 marks a dropped
// row) are skipped. An empty segment reads [0, 0, 0, +BIG, -BIG].
//
// Replaces the Pallas kernel
// src/repro/kernels/segment_reduce.py::segment_reduce (body `_kernel`),
// which walks row tiles on a sequential grid, builds a one-hot (BN, BK)
// tile and contracts it with [v, v^2, 1] on the MXU, carrying the (BK, 8)
// output block across the row dimension.
//
// weighted_segment_reduce, its weighted twin: per-segment [sum w*v,
// sum w*v^2, sum w] with one weight per row; an empty segment reads
// [0, 0, 0]. It replaces the Pallas kernel
// src/repro/kernels/segment_reduce.py::weighted_segment_reduce (body
// `_kernel_weighted`), the same one-hot MXU contraction with the moment
// matrix scaled by the row weight.
//
// What bounds both on an H100: at the streaming ingest's shapes (N = 4096
// rows, k = 1024 segments) and the fused bootstrap benchmark's (N =
// 76,800, k = 1024) nothing the card is built for: 8 or 12 bytes a row
// in, 20 or 12 bytes a segment out, ~6 operations a row, so the bound is
// well under a microsecond of bytes and the kernels are bound by their
// launches and their passes' latency.
//
// segment_reduce, one cooperative launch, deterministic with no float
// atomics (the sharded ingest's byte-equality to the single-device one
// rests on this reduction, so its arithmetic and bits stay those of the
// first, two-launch version):
//  * Phase 1: the rows are cut into C chunks of CH consecutive rows (CH
//    from N alone: repro_segment_reduce_chunk, mirrored by the wrapper's
//    segment_plan). A work item is a (chunk, segment tile) pair; the
//    blocks take the items in a grid-stride loop. For an item the block
//    stages its chunk's ids and values in shared memory; thread t owns
//    segment tile*BS + t and walks the chunk's rows in order,
//    accumulating its five moments in registers. Every thread reads the
//    same row at once (a shared memory broadcast). The partials go to
//    part (C, 5, k). An item whose segment tile holds none of the chunk's
//    ids (the chunk's min and max id are reduced first) writes the
//    identity and skips the walk.
//  * A grid-wide sync. The grid is capped at the blocks the card holds at
//    once (the occupancy calculator's count times the multiprocessors), as
//    a cooperative launch must be.
//  * Phase 2: thread s (grid-stride over the segments) combines
//    part[0..C-1][.][s] in chunk order, the loads of CU chunks in flight
//    at once. (Spreading the segments' runs of 32 over the warps of every
//    block, with 16 chunks in flight, was slower in a tuning run.)
// The sum order is thus fixed by (N, k) alone: row order inside a chunk,
// chunk order across chunks, whichever block takes an item; the per-row
// update is pinned to the first version's instructions (its SASS adds v
// and the count by FADD and v * v by FFMA), so nvcc cannot round it
// otherwise. MIN and MAX break a tie of +0.0 and -0.0 by the reference's
// rule (-0.0 below +0.0), which the first version left to the order of the
// rows: a chunk's running MIN or MAX at zero looks for the zero it prefers,
// and the combine uses min_sz / max_sz. Skewed ids (a stream in
// pickup-time order puts a whole batch into one to three leaves) do not
// serialise the batch: the chunks of one segment are walked by C items in
// parallel. Work is O(N * k) compares,
// which at the ingest's shapes is ~4 M and far below the launch cost; CH
// grows with N so that C stays <= MAX_C. Any N and k are taken by masking;
// there is no padding to a block size. `out` and the partials are carved
// from one buffer that the wrapper allocates per call.
//
// weighted_segment_reduce, one cooperative launch, deterministic with no
// float atomics. The wrapper's plan (weighted_segment_plan) cuts the rows
// into C <= W_MAX_C chunks of CH rows from N alone, one block of 8 warps
// each; kt = min(WKT, k) segments a pass:
//  1. Warp w takes the chunk's 32-row windows w, w + 8, ..., PF at a time:
//     their loads in flight together, then the run sums of each (each run
//     of equal ids summed by a shuffle tree into its first lane; the PF
//     windows' trees are independent), then each window's run sums added
//     to the warp's accumulator in shared memory in window order. Runs of
//     one id in a window add in lane order: a tag per segment finds such
//     twins, and only windows that have them rank their leaders by
//     __match_any_sync. O(CH) work whatever the ids: leaf-major ones give
//     a few long runs, uniform ones runs of one.
//  2. The block's partial, its warps' accumulators added in warp order,
//     goes to part[chunk] for the ids the chunk met ([lo, hi], recorded
//     beside it): the id-range skip. For k > WKT the range is read first
//     and the passes of kt segments cover it.
//  3. A grid-wide sync (cooperative groups; the grid is at most W_MAX_C
//     blocks, so it is resident on any card with that many
//     multiprocessors).
//  4. One warp per segment across the whole grid: lane c holds chunk c
//     (and c + 32), +0.0 where the segment lies outside the chunk's
//     range, and a fixed xor-shuffle tree adds the lanes.
// The sum order is fixed by (N, k) and the rows' positions alone: the same
// bits on every launch. It is another order than the earlier two-launch
// version's (which walked rows in order per chunk of at most 264, then
// combined the chunks in order in a second launch), so the bits may
// differ from that version's; no contract rests on them. `out`, the
// partials and the ranges are carved from one buffer that the wrapper
// allocates per call.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BS = 256;        // segments per block == threads per block
constexpr int MIN_CH = 256;    // rows per chunk, at least
constexpr int MAX_C = 264;     // chunks, at most (two per SM)
constexpr int TILE = 1024;     // rows staged in shared memory at a time
constexpr int CU = 8;          // chunks whose partials a combine loads at once
constexpr float POS_BIG = 3.0e38f;   // kernels/ref.py POS_BIG / NEG_BIG
constexpr float NEG_BIG = -3.0e38f;

// MIN/MAX of the chunks' partials under the reference's rule: of two equal
// values the OR of the bits (min) or the AND (max), so -0.0 orders below
// +0.0 whichever comes first; otherwise the smaller (larger) value, a NaN
// skipped, as the first version's fminf / fmaxf did. Order-free, so the
// result does not depend on the chunk order.
__device__ __forceinline__ float min_sz(float acc, float x) {
  const float tie = __int_as_float(__float_as_int(acc) | __float_as_int(x));
  return x < acc ? x : (x == acc ? tie : acc);
}

__device__ __forceinline__ float max_sz(float acc, float x) {
  const float tie = __int_as_float(__float_as_int(acc) & __float_as_int(x));
  return x > acc ? x : (x == acc ? tie : acc);
}

// Does rows [r0, r1)'s id range (ids outside [0, k) excluded) meet the
// segment tile [seg0, seg0 + BS)? Uniform across the block; s_min / s_max
// are BS / 32 ints of scratch.
__device__ __forceinline__ bool chunk_hits_tile(const int32_t* ids, int r0,
                                                int r1, int k, int seg0,
                                                int* s_min, int* s_max) {
  const int tid = threadIdx.x;
  int lo = 0x7fffffff, hi = -1;
  for (int r = r0 + tid; r < r1; r += BS) {
    const int id = ids[r];
    if (id >= 0 && id < k) { lo = min(lo, id); hi = max(hi, id); }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((tid & 31) == 0) { s_min[tid >> 5] = lo; s_max[tid >> 5] = hi; }
  __syncthreads();
  lo = s_min[0]; hi = s_max[0];
  for (int w = 1; w < BS / 32; ++w) {
    lo = min(lo, s_min[w]); hi = max(hi, s_max[w]);
  }
  return hi >= seg0 && lo < seg0 + BS;
}

// Item (chunk, segment tile seg0 / BS)'s partials into part (C, 5, k).
// Called by every thread of the block; the caller syncs the block first.
__device__ __forceinline__ void segment_item(const float* __restrict__ v,
                                             const int32_t* __restrict__ ids,
                                             float* __restrict__ part, int N,
                                             int k, int CH, int chunk,
                                             int seg0, float* s_v,
                                             int32_t* s_id, int* s_min,
                                             int* s_max) {
  const int tid = threadIdx.x;
  const int seg = seg0 + tid;
  const int r0 = chunk * CH;
  const int r1 = min(N, r0 + CH);

  const bool any = chunk_hits_tile(ids, r0, r1, k, seg0, s_min, s_max);

  float sum = 0.f, sumsq = 0.f, cnt = 0.f, mn = POS_BIG, mx = NEG_BIG;
  if (any) {  // uniform across the block
    for (int t0 = r0; t0 < r1; t0 += TILE) {
      const int n = min(TILE, r1 - t0);
      __syncthreads();  // the previous tile is consumed
      for (int i = tid; i < n; i += BS) {
        s_v[i] = v[t0 + i];
        s_id[i] = ids[t0 + i];
      }
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        if (s_id[i] == seg) {
          const float x = s_v[i];
          sum = __fadd_rn(sum, x);
          sumsq = __fmaf_rn(x, x, sumsq);
          cnt = __fadd_rn(cnt, 1.f);
          mn = x < mn ? x : mn;
          mx = x > mx ? x : mx;
        }
      }
      // Those compares keep the first of two zeros; the reference's rule
      // wants -0.0 for the MIN and +0.0 for the MAX of zeros of both signs.
      // A running MIN or MAX at zero looks again at the tile's rows for the
      // zero it prefers: rare, and kept out of the loop above, whose speed
      // rests on its two compares (any other update there was much slower
      // on skewed ids in a tuning run).
      if (mn == 0.f || mx == 0.f) {
        for (int i = 0; i < n; ++i) {
          if (s_id[i] == seg) {
            const int b = __float_as_int(s_v[i]);
            if (b == (int)0x80000000 && mn == 0.f) mn = -0.f;
            if (b == 0 && mx == 0.f) mx = 0.f;
          }
        }
      }
    }
  }
  if (seg < k) {
    float* p = part + (size_t)chunk * 5 * k + seg;
    p[0] = sum;
    p[(size_t)k] = sumsq;
    p[(size_t)2 * k] = cnt;
    p[(size_t)3 * k] = mn;
    p[(size_t)4 * k] = mx;
  }
}

// Launched cooperatively with at most the resident blocks: the items of
// phase 1 in a grid-stride loop, a grid sync, then the chunk-order combine
// of each segment.
__global__ void __launch_bounds__(BS)
segment_reduce_kernel(const float* __restrict__ v,
                      const int32_t* __restrict__ ids, float* out,
                      float* part, int N, int k, int CH, int C) {
  __shared__ float s_v[TILE];
  __shared__ int32_t s_id[TILE];
  __shared__ int s_min[BS / 32], s_max[BS / 32];

  const int n_tiles = (k + BS - 1) / BS;
  const long long items = (long long)C * n_tiles;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    __syncthreads();  // the previous item's shared memory is consumed
    segment_item(v, ids, part, N, k, CH, (int)(it % C),
                 (int)(it / C) * BS, s_v, s_id, s_min, s_max);
  }

  // Every chunk's partials are written.
  cg::this_grid().sync();

  for (long long seg = (long long)blockIdx.x * BS + threadIdx.x; seg < k;
       seg += (long long)gridDim.x * BS) {
    float sum = 0.f, sumsq = 0.f, cnt = 0.f, mn = POS_BIG, mx = NEG_BIG;
    // CU chunks' loads in flight together, then their adds in chunk order.
    for (int c0 = 0; c0 < C; c0 += CU) {
      float t[CU][5];
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const float* p = part + (size_t)(c0 + u) * 5 * k + seg;
        const bool in = c0 + u < C;
#pragma unroll
        for (int m = 0; m < 5; ++m) t[u][m] = in ? p[(size_t)m * k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        if (c0 + u < C) {
          sum = __fadd_rn(sum, t[u][0]);
          sumsq = __fadd_rn(sumsq, t[u][1]);
          cnt = __fadd_rn(cnt, t[u][2]);
          mn = min_sz(mn, t[u][3]);
          mx = max_sz(mx, t[u][4]);
        }
      }
    }
    float* o = out + (size_t)seg * 5;
    o[0] = sum;
    o[1] = sumsq;
    o[2] = cnt;
    o[3] = mn;
    o[4] = mx;
  }
}

constexpr int WNT = 256;       // threads per weighted block
constexpr int WW = WNT / 32;   // its warps
constexpr int WKT = 1024;      // segments a pass accumulates, at most
constexpr int W_MAX_C = 64;    // chunks (blocks), at most
constexpr int PF = 8;          // windows a warp loads at once
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

// The run sums of one 32-row window of a warp, a row per lane: `id` is the
// row's segment relative to the pass (-1: not in it) and x its [w*v, w*v^2,
// w]. Each run of equal ids is summed by a shuffle tree into its first
// lane; returns whether this lane leads a run of an id in the pass.
__device__ __forceinline__ bool run_sums(int id, float& x0, float& x1,
                                         float& x2, int lane) {
  const int prev = __shfl_up_sync(FULL, id, 1);
  const bool head = lane == 0 || prev != id;
  const unsigned heads = __ballot_sync(FULL, head);
  const unsigned above = heads & (0xfffffffeu << lane);
  const int end = above ? __ffs(above) - 1 : 32;  // first lane of next run
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y0 = __shfl_down_sync(FULL, x0, off);
    const float y1 = __shfl_down_sync(FULL, x1, off);
    const float y2 = __shfl_down_sync(FULL, x2, off);
    if (lane + off < end) {
      x0 = __fadd_rn(x0, y0);
      x1 = __fadd_rn(x1, y1);
      x2 = __fadd_rn(x2, y2);
    }
  }
  return head && id >= 0;
}

// The leaders' run sums of one window into acc (the warp's accumulator,
// [segment][3]); runs of one id add in lane order. The warp's tags (an int
// a segment) tell whether two leaders share an id: each leader writes its
// lane to its id's tag and a leader that reads another lane back has a
// twin. Only then are the leaders ranked (__match_any_sync, slow when the
// ids are many), and they add in rounds of rank.
__device__ __forceinline__ void add_runs(float* acc, int* tag, bool lead,
                                         int id, float x0, float x1,
                                         float x2, int lane) {
  if (lead) tag[id] = lane;
  __syncwarp();
  bool twin = false;
  if (lead) twin = tag[id] != lane;
  int rank = 0, rounds = 0;
  if (__any_sync(FULL, twin)) {
    const unsigned same = __match_any_sync(FULL, lead ? id : -1);
    rank = __popc(same & ((1u << lane) - 1u));
    rounds = __reduce_max_sync(FULL, lead ? rank : 0);
  }
  for (int r = 0; r <= rounds; ++r) {
    if (lead && rank == r) {
      float* p = acc + id * 3;
      p[0] = __fadd_rn(p[0], x0);
      p[1] = __fadd_rn(p[1], x1);
      p[2] = __fadd_rn(p[2], x2);
    }
    __syncwarp();
  }
}

// Min and max over the block (uniform result); s_lo / s_hi are WW ints.
__device__ __forceinline__ void block_min_max(int& lo, int& hi, int* s_lo,
                                              int* s_hi) {
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x >> 5] = lo;
    s_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  for (int w = 0; w < WW; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
  }
}

// Launched cooperatively with one block per chunk; dynamic shared memory
// holds WW accumulators of kt = min(WKT, k) segments and WW tag arrays.
__global__ void __launch_bounds__(WNT)
weighted_segment_kernel(const float* __restrict__ v,
                        const float* __restrict__ wt,
                        const int32_t* __restrict__ ids, float* out,
                        float* part, int* range, int N, int k, int CH,
                        int kt) {
  extern __shared__ float acc[];  // [warp][segment][3], then tags
  __shared__ int s_lo[WW], s_hi[WW];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = gridDim.x, chunk = blockIdx.x;
  const int r0 = chunk * CH, r1 = min(N, r0 + CH);
  const int n_win = (r1 - r0 + 31) / 32;
  float* wacc = acc + (size_t)warp * kt * 3;
  int* wtag = (int*)(acc + (size_t)WW * kt * 3) + (size_t)warp * kt;

  // Warp w adds windows w, w + WW, ... of segments [base, base + ns), PF
  // at a time: their loads in flight together, then their run sums (the
  // shuffle trees of the PF windows are independent), then their adds in
  // window order; (tlo, thi) widens to the ids met.
  int tlo = INT_MAX, thi = -1;
  auto add_windows = [&](int base, int ns) {
    for (int g0 = warp; g0 < n_win; g0 += WW * PF) {
      int gid[PF];
      float gw[PF], gv[PF];
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const long long r = r0 + (long long)(g0 + WW * u) * 32 + lane;
        gid[u] = -1;
        if (r < r1) {
          gid[u] = ids[r];
          gw[u] = wt[r];
          gv[u] = v[r];
        }
      }
      bool lead[PF];
      float x[PF][3];
      const int n_u = min(PF, (n_win - g0 + WW - 1) / WW);  // windows here
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        lead[u] = false;
        if (u >= n_u) continue;  // uniform across the warp
        const bool in = gid[u] >= base && gid[u] < base + ns;
        if (in) {
          tlo = min(tlo, gid[u]);
          thi = max(thi, gid[u]);
        }
        gid[u] = in ? gid[u] - base : -1;
        x[u][0] = in ? __fmul_rn(gw[u], gv[u]) : 0.f;
        x[u][1] = in ? __fmul_rn(x[u][0], gv[u]) : 0.f;
        x[u][2] = in ? gw[u] : 0.f;
        lead[u] = run_sums(gid[u], x[u][0], x[u][1], x[u][2], lane);
      }
#pragma unroll
      for (int u = 0; u < PF; ++u)
        if (u < n_u)
          add_runs(wacc, wtag, lead[u], gid[u], x[u][0], x[u][1], x[u][2],
                   lane);
    }
  };
  // The block's partial over segments [s0, s1]: the warps' accumulators
  // (relative to base) added in warp order.
  auto write_partial = [&](int base, int s0, int s1) {
    float* pc = part + (size_t)chunk * k * 3;
    for (int e = (s0 - base) * 3 + tid; e < (s1 + 1 - base) * 3; e += WNT) {
      float s = acc[e];
      for (int w = 1; w < WW; ++w)
        s = __fadd_rn(s, acc[(size_t)w * kt * 3 + e]);
      pc[(size_t)base * 3 + e] = s;
    }
  };
  // Every warp's accumulator to +0.0 (16-byte stores: WW * kt * 3 is a
  // multiple of 4).
  auto zero = [&]() {
    float4* a4 = reinterpret_cast<float4*>(acc);
    for (int i = tid; i < WW * kt * 3 / 4; i += WNT)
      a4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  };

  int lo, hi;  // the segments this chunk's partial holds
  if (k <= WKT) {
    // One pass over every segment; the range is the ids met.
    zero();
    __syncthreads();
    add_windows(0, k);
    lo = tlo;
    hi = thi;
    block_min_max(lo, hi, s_lo, s_hi);  // its barrier orders the adds
    if (lo <= hi) write_partial(0, lo, hi);
  } else {
    // Passes of kt segments over the chunk's id range, read first.
    lo = INT_MAX;
    hi = -1;
    for (int r = r0 + tid; r < r1; r += WNT) {
      const int id = ids[r];
      if (id >= 0 && id < k) {
        lo = min(lo, id);
        hi = max(hi, id);
      }
    }
    block_min_max(lo, hi, s_lo, s_hi);
    for (long long p0 = lo; p0 <= hi; p0 += kt) {
      const int base = (int)p0, ns = (int)min((long long)kt, hi - p0 + 1);
      __syncthreads();  // the previous pass's partial is written
      zero();
      __syncthreads();
      add_windows(base, ns);
      __syncthreads();
      write_partial(base, base, base + ns - 1);
    }
  }
  if (tid == 0) {
    range[2 * chunk] = lo;
    range[2 * chunk + 1] = hi;
  }

  // Every chunk's partial is written.
  cg::this_grid().sync();

  // One warp per segment: lane c holds chunk c (and c + 32), +0.0 where
  // the segment lies outside the chunk's range; a fixed xor-shuffle tree
  // adds the lanes, leaving the same bits in each. A warp's segments are
  // loaded together, SEGS at a time, with the ranges (a partial outside
  // its chunk's range is loaded but never used).
  constexpr int SEGS = 4;
  constexpr int NJ = W_MAX_C / 32;
  const int stride = C * WW;
  for (int seg0 = chunk * WW + warp; seg0 < k; seg0 += SEGS * stride) {
    int clo[NJ], chi[NJ];
    float t[SEGS][NJ][3];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      clo[j] = c < C ? range[2 * c] : INT_MAX;
      chi[j] = c < C ? range[2 * c + 1] : -1;
#pragma unroll
      for (int u = 0; u < SEGS; ++u) {
        const int seg = seg0 + u * stride;
        const bool any = c < C && seg < k;
        const float* pp = part + ((size_t)c * k + seg) * 3;
        t[u][j][0] = any ? pp[0] : 0.f;
        t[u][j][1] = any ? pp[1] : 0.f;
        t[u][j][2] = any ? pp[2] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < SEGS; ++u) {
      const int seg = seg0 + u * stride;
      if (seg >= k) break;  // uniform across the warp
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bool in = clo[j] <= seg && seg <= chi[j];
        const float t0 = in ? t[u][j][0] : 0.f, t1 = in ? t[u][j][1] : 0.f,
                    t2 = in ? t[u][j][2] : 0.f;
        if (j == 0) {
          s0 = t0;
          s1 = t1;
          s2 = t2;
        } else if (32 * j < C) {
          s0 = __fadd_rn(s0, t0);
          s1 = __fadd_rn(s1, t1);
          s2 = __fadd_rn(s2, t2);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s0 = __fadd_rn(s0, __shfl_xor_sync(FULL, s0, off));
        s1 = __fadd_rn(s1, __shfl_xor_sync(FULL, s1, off));
        s2 = __fadd_rn(s2, __shfl_xor_sync(FULL, s2, off));
      }
      if (lane == 0) {
        float* o = out + (size_t)seg * 3;
        o[0] = s0;
        o[1] = s1;
        o[2] = s2;
      }
    }
  }
}

}  // namespace

// Rows per chunk for N rows: at least MIN_CH, and enough that there are
// at most MAX_C chunks. The wrapper's segment_plan mirrors it.
extern "C" int repro_segment_reduce_chunk(int N) {
  const int ch = (N + MAX_C - 1) / MAX_C;
  return ch > MIN_CH ? ch : MIN_CH;
}

// MIN_CH and MAX_C, for the wrapper's plan to be checked against.
extern "C" int repro_segment_reduce_min_rows() { return MIN_CH; }
extern "C" int repro_segment_reduce_max_chunks() { return MAX_C; }

// buf: the wrapper's one buffer of at least (C + 1) * 5 * k floats, C =
// ceil(N / CH): out (k, 5), then the partials (C, 5, k). CH must be
// repro_segment_reduce_chunk(N), on which the bits rest.
extern "C" int repro_segment_reduce(const float* v, const int32_t* ids,
                                    float* buf, int N, int k, int CH,
                                    void* stream) {
  if (N < 0 || k < 1 || CH != repro_segment_reduce_chunk(N))
    return (int)cudaErrorInvalidValue;
  int C = (N + CH - 1) / CH;
  float* out = buf;
  float* part = buf + (size_t)5 * k;
  // Once per device: the resident blocks, which cap the cooperative grid.
  static int resident[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_reduce_kernel, BS, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const long long items = (long long)C * ((k + BS - 1) / BS);
  const long long want = items > 1 ? items : 1;
  const int grid = (int)(want < resident[dev] ? want : resident[dev]);
  void* args[] = {(void*)&v, (void*)&ids, (void*)&out, (void*)&part,
                  (void*)&N, (void*)&k,   (void*)&CH,  (void*)&C};
  return (int)cudaLaunchCooperativeKernel((void*)segment_reduce_kernel,
                                          dim3(grid), dim3(BS), args, 0,
                                          (cudaStream_t)stream);
}

// buf: the wrapper's one buffer of at least 3k + C * (3k + 2) floats: out
// (k, 3), then the partials (C, k, 3), then the chunks' ranges (C, 2)
// int32. C and CH are weighted_segment_plan's (segment_reduce.py): C chunks
// of CH rows (a multiple of 32), C = max(1, ceil(N / CH)) <= W_MAX_C.
extern "C" int repro_weighted_segment_reduce(const float* v, const float* w,
                                             const int32_t* ids, float* buf,
                                             int N, int k, int C, int CH,
                                             void* stream) {
  if (N < 0 || k < 1 || C < 1 || C > W_MAX_C || CH < 32 || CH % 32 != 0 ||
      (long long)C * CH < N || (C > 1 && (long long)(C - 1) * CH >= N))
    return (int)cudaErrorInvalidValue;
  float* out = buf;
  float* part = buf + (size_t)3 * k;
  int* range = (int*)(part + (size_t)C * 3 * k);
  int kt = k < WKT ? k : WKT;
  const size_t smem = (size_t)WW * kt * 4 * sizeof(float);
  // Once per device: opt in to the largest accumulators (above 48 KB of
  // dynamic shared memory) and prefer the largest shared-memory carveout.
  static bool granted[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!granted[dev]) {
    err = cudaFuncSetAttribute(weighted_segment_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(WW * WKT * 4 * sizeof(float)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          weighted_segment_kernel,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = true;
  }
  void* args[] = {(void*)&v,    (void*)&w,     (void*)&ids, (void*)&out,
                  (void*)&part, (void*)&range, (void*)&N,   (void*)&k,
                  (void*)&CH,   (void*)&kt};
  return (int)cudaLaunchCooperativeKernel((void*)weighted_segment_kernel,
                                          dim3(C), dim3(WNT), args, smem,
                                          (cudaStream_t)stream);
}

// W_MAX_C, for the wrapper's plan to be checked against.
extern "C" int repro_weighted_segment_max_chunks() { return W_MAX_C; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
