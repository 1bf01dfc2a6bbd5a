// join_epilogue: the epilogue of an fk-join answer (row 11 of PERF.md's
// kernel table): for every requested kind (sum, count, avg) of a batch,
// its estimate, half-width, hard bounds, fraction of rows touched and,
// with a confidence level, its clipped interval, in one launch over row
// 9's planes (csrc/join_moments.cu).
//
// The JAX package has no Pallas kernel for it: its epilogue is plain jnp
// (src/repro/joins/assemble.py:64 assemble_join,
// src/repro/uncertainty/intervals.py:198 _join_fb_half, :217
// compose_join_interval, :308 _with_interval), which XLA fuses on the
// TPU. The port's plain version (kernels/join_epilogue.py
// join_epilogue_plain) is that composition in torch, op by op: some 360
// launches over (Q, kP) planes an answer at three kinds.
//
// Inputs: row 9's eight (Q, kP) planes s_cell, c_cell, v_s, v_c, cov_sc,
// n_grp, r_s, r_c (cell id = leaf * P + part), sampled (Q, kP) bool,
// exact3 (Q, 3) and touched (Q,); the synopsis's cell_agg (kP, 5) =
// [SUM, SUMSQ, COUNT, MIN, MAX] and u_overflow (k,) int32 or int64; the
// interval's scale: lam (a float) without a level, else z, the level's
// normal quantile, read through a pointer (no host sync); under the
// "stratum" budget log(3 / delta), also through a pointer, as the plain
// version computes both (torch ops on the device), so their bits are the
// same. Output: out (n_kinds, 7, Q) f32, rows estimate, ci_half, lower,
// upper, frac_rows_touched, ci_lo, ci_hi (the last two only with a level).
//
// Per (query, cell), with m = sampled and over = the cell's stratum
// overflowed its universe buffer (u_overflow > 0):
//   cell bounds (assemble.py:23 join_cell_bounds), sum: mn / mx = cnt > 0
//     ? MIN / MAX : 0 (a select: empty cells carry +-inf),
//     p_ub = min(cnt max0(mx), s - cnt min0(mn)),
//     p_lb = max(cnt min0(mn), s - cnt max0(mx)); count: [0, cnt];
//   fb = m & (n_grp < thr | over), cltf = m & !fb (with a level);
//   the fallback half of a fb cell, per kind: det = max(p_ub - e, e -
//     p_lb), bern = sqrt(2 v L) + (2/3) r L, h = (n_grp > 0 & !over) ?
//     min(bern, det) : det, e / v / r the kind's s_cell / v_s / r_s or
//     c_cell / v_c / r_c.
// Per query: the masked sums m * x of s_cell, c_cell, p_lb, p_ub (cnt
// for count), and of v_s, v_c, cov_sc under m (no level) or cltf (a
// level); the sums of the fallback halves over fb; for AVG the masked max
// of MAX and min of MIN over m (fills -+3.4e38) and any(m). L is log(3 /
// delta) under "stratum"; under "union" it is log(3 max(n_fb, 1) / delta)
// with n_fb the query's fallback cells, so the block first counts them
// (one pass over the row's sampled and n_grp, which come back from L2 for
// the second). Then each kind's scalars in the plain version's order of
// operations: est, ci = scale sqrt(var) (+ the fallback halves), AVG's
// ratio variance and its fallback term (h_s + |est| h_c) / max(C - h_c,
// 1), the covered-mean / sampled-extreme bounds, and [est -+ half]
// clipped into [lower, upper].
//
// Bits: one block a query. Each thread takes chunks of CHUNK consecutive
// cells, chunk t, t + THREADS, ..., and folds its cells' float32 terms in
// cell order from +0.0 into float64 sums; the block combines the threads'
// partials by a fixed tree (warp shuffles, then the warps in order), and
// each sum is rounded once to float32. So a query's result depends on its
// row and kP alone: not on Q, its place in the batch or the grid, and two
// launches give the same bits. Whether a chunk is read as one 16-byte
// load or cell by cell changes no order. No float atomics. Every term and
// every scalar of the epilogue is float32, each add, multiply, divide and
// square root pinned (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn: no
// contraction into an FMA), as torch's elementwise kernels round each op;
// the sums' adds are __dadd_rn. Every MIN / MAX / clip / max0 / min0
// follows repro_torch.minmax's rules (XLA's): NaN propagates, a tie of
// zeros goes to -0.0 in a min and +0.0 in a max, the sign taken from the
// int32 min (max) of the operands' bits. The masked sums multiply by m (0
// * inf is NaN, as in the plain version); the fallback halves and the
// extremes select. Torch sums a row in float32 in another order, so
// against the plain version the sums agree within tolerance, and bit for
// bit where they are exact (every term +-0.0, no sampled cell, only
// covered cells). Why float64: AVG's fallback term divides by C - h_c,
// which at the join answer's shape cancels to a few units out of ~10^4 on
// some queries (PERF.md §6, row 11); there torch's own float32 sums put the
// plain version's ci_half ~4x its tolerance away from the value with exact
// sums, and a float32 fold in any other order lands as far off. The
// float64 sums give the exact sums' value, to the last rounding.
//
// What bounds it on an H100: bytes. At the join answer's shape (Q = 2048,
// kP = 16,384, three kinds with a level) it reads the eight planes (1.07
// GB) and sampled (34 MB) once, cell_agg and u_overflow (0.33 MB) from L2
// a block, and writes 2048 x 21 floats: ~1.11 GB, ~0.33 ms at 3.35 TB/s.
// Without a level it reads five planes. The operations (~30 a (query,
// cell), 8 of them float64 adds, ~25 more a fallback cell) are ~1.1 G,
// ~0.02 ms at 67 TFLOP/s (the float64 adds ~0.3 G at 34 TFLOP/s).
// Design, first version: a block of 256 threads a query, 16-byte loads of
// each plane where the rows are aligned (kP % 4 == 0), all the query's
// sums in registers, so each plane byte is read once; ~0.63 ms on an
// H100 80GB HBM3 at 700 W, 53 % of the bound (PERF.md §6, row 11).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // a block, one query
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 4;       // consecutive cells a thread takes at a time
constexpr int FIELDS = 7;      // output rows a kind
constexpr int NAGG = 5;        // cell_agg columns
constexpr int A_SUM = 0, A_COUNT = 2, A_MIN = 3, A_MAX = 4;
constexpr float BIG = 3.4e38f;                 // joins/assemble.py _BIG
constexpr float TWO_THIRDS = (float)(2.0 / 3.0);

// Planes, in the order of the entry's pointers.
enum { S_CELL, C_CELL, V_S, V_C, COV_SC, N_GRP, R_S, R_C, PLANES };

struct Args {
  const float* plane[PLANES];
  const uint8_t* sampled;
  const float* cell_agg;
  const void* u_overflow;
  const float* exact3;
  const float* touched;
  const float* z;
  const float* log_term;
  float* out;
  int Q, kP, P;
  int slot_sum, slot_count, slot_avg;  // output row of each kind, or -1
  int need;                            // bit p: plane p is read
  int union_budget, over64, vec;
  float lam, thr, inv_delta;
};

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}

// repro_torch.minmax's rules.
__device__ __forceinline__ float with_sign(float v, int bits) {
  return copysignf(v, bits < 0 ? -1.0f : 1.0f);
}
__device__ __forceinline__ float mm_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return with_sign(fminf(a, b), min(__float_as_int(a), __float_as_int(b)));
}
__device__ __forceinline__ float mm_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return with_sign(fmaxf(a, b), max(__float_as_int(a), __float_as_int(b)));
}
// minmax.max0 (F.threshold(x, 0, 0)): +0.0 for x <= 0, NaN kept.
__device__ __forceinline__ float max0(float x) {
  return x <= 0.0f ? 0.0f : x;
}
// minmax.min0 (clamp(x, max=0)): +0.0 for x > 0, x otherwise.
__device__ __forceinline__ float min0(float x) {
  return x > 0.0f ? 0.0f : x;
}
// torch.clamp(x, min=lo), NaN kept (lo is 1.0: no tie of zeros).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
// minmax.clip: min(max(x, lo), hi), NaN from any operand.
__device__ __forceinline__ float mm_clip(float x, float lo, float hi) {
  if (x != x) return x;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  const int b = min(max(__float_as_int(x), __float_as_int(lo)),
                    __float_as_int(hi));
  return with_sign(fminf(fmaxf(x, lo), hi), b);
}
// amax / amin folds, NaN propagating.
__device__ __forceinline__ float max_nan(float acc, float x) {
  return (x > acc || x != x) ? x : acc;
}
__device__ __forceinline__ float min_nan(float acc, float x) {
  return (x < acc || x != x) ? x : acc;
}

__device__ __forceinline__ double dadd(double a, float b) {
  return __dadd_rn(a, (double)b);
}

// A query's sums (one thread's partials, then the block's): float32
// terms summed in float64, rounded once to float32 at the end.
struct Acc {
  double s, c;           // sum m s_cell, sum m c_cell
  double vs, vc, csc;    // sum w v_s, w v_c, w cov_sc; w = m or cltf
  double lbs, ubs, ubc;  // sum m p_lb, m p_ub (sum); sum m cnt (count)
  double hs, hc;         // fallback halves over fb: sum, count
  float pmax, pmin;      // AVG's masked MAX / MIN values
  int kmax, kmin;        // and the int32 max / min of their terms' bits
  int any;               // some cell sampled

  __device__ void init() {
    s = c = vs = vc = csc = lbs = ubs = ubc = hs = hc = 0.0;
    pmax = -__int_as_float(0x7f800000);
    pmin = __int_as_float(0x7f800000);
    kmax = INT_MIN;
    kmin = INT_MAX;
    any = 0;
  }
  __device__ void merge(const Acc& o) {
    s = __dadd_rn(s, o.s);
    c = __dadd_rn(c, o.c);
    vs = __dadd_rn(vs, o.vs);
    vc = __dadd_rn(vc, o.vc);
    csc = __dadd_rn(csc, o.csc);
    lbs = __dadd_rn(lbs, o.lbs);
    ubs = __dadd_rn(ubs, o.ubs);
    ubc = __dadd_rn(ubc, o.ubc);
    hs = __dadd_rn(hs, o.hs);
    hc = __dadd_rn(hc, o.hc);
    pmax = max_nan(pmax, o.pmax);
    pmin = min_nan(pmin, o.pmin);
    kmax = max(kmax, o.kmax);
    kmin = min(kmin, o.kmin);
    any |= o.any;
  }
  __device__ void shfl_down(Acc& o, int off) const {
    const unsigned all = 0xffffffffu;
    o.s = __shfl_down_sync(all, s, off);
    o.c = __shfl_down_sync(all, c, off);
    o.vs = __shfl_down_sync(all, vs, off);
    o.vc = __shfl_down_sync(all, vc, off);
    o.csc = __shfl_down_sync(all, csc, off);
    o.lbs = __shfl_down_sync(all, lbs, off);
    o.ubs = __shfl_down_sync(all, ubs, off);
    o.ubc = __shfl_down_sync(all, ubc, off);
    o.hs = __shfl_down_sync(all, hs, off);
    o.hc = __shfl_down_sync(all, hc, off);
    o.pmax = __shfl_down_sync(all, pmax, off);
    o.pmin = __shfl_down_sync(all, pmin, off);
    o.kmax = __shfl_down_sync(all, kmax, off);
    o.kmin = __shfl_down_sync(all, kmin, off);
    o.any = __shfl_down_sync(all, any, off);
  }
};

__device__ __forceinline__ bool overflowed(const Args& g, int leaf) {
  return g.over64
      ? static_cast<const long long*>(g.u_overflow)[leaf] > 0
      : static_cast<const int*>(g.u_overflow)[leaf] > 0;
}

// The fallback half of one fb cell for one kind.
__device__ __forceinline__ float fb_half(float e, float v, float r,
                                         float p_lb, float p_ub, bool bern_ok,
                                         float L) {
  const float det = mm_max(fsub(p_ub, e), fsub(e, p_lb));
  if (!bern_ok) return det;
  const float bern = fadd(__fsqrt_rn(fmul(fmul(v, 2.0f), L)),
                          fmul(fmul(r, TWO_THIRDS), L));
  return mm_min(bern, det);
}

// One chunk's sampled flags and the planes in `need`, 16 bytes a plane
// where `vec`; cells past kP read as unsampled zeros (never folded).
__device__ __forceinline__ void load_chunk(const Args& g, size_t row, int j0,
                                           int need, bool m[CHUNK],
                                           float x[PLANES][CHUNK]) {
  if (g.vec) {
    const uchar4 mv = *reinterpret_cast<const uchar4*>(g.sampled + row + j0);
    m[0] = mv.x; m[1] = mv.y; m[2] = mv.z; m[3] = mv.w;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (need & (1 << p))
        v = *reinterpret_cast<const float4*>(g.plane[p] + row + j0);
      x[p][0] = v.x; x[p][1] = v.y; x[p][2] = v.z; x[p][3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const bool in = j0 + i < g.kP;
      m[i] = in && g.sampled[row + j0 + i];
#pragma unroll
      for (int p = 0; p < PLANES; ++p)
        x[p][i] = (in && (need & (1 << p))) ? g.plane[p][row + j0 + i]
                                            : 0.0f;
    }
  }
}

// The query's fallback cells (the "union" budget's first pass).
__device__ int count_fallback(const Args& g, size_t row) {
  int n = 0;
  for (int j = threadIdx.x; j < g.kP; j += THREADS) {
    if (g.sampled[row + j]
        && (g.plane[N_GRP][row + j] < g.thr || overflowed(g, j / g.P)))
      ++n;
  }
  return n;
}

// A thread's cells into its partials.
template <bool CI>
__device__ void fold_cells(const Args& g, size_t row, float L, Acc& a) {
  const bool w_sum = g.slot_sum >= 0, w_cnt = g.slot_count >= 0,
             w_avg = g.slot_avg >= 0;
  const bool need_s = w_sum || w_avg, need_c = w_cnt || w_avg;
  const int nch = (g.kP + CHUNK - 1) / CHUNK;
  for (int ch = threadIdx.x; ch < nch; ch += THREADS) {
    const int j0 = ch * CHUNK;
    bool m[CHUNK];
    float x[PLANES][CHUNK];
    load_chunk(g, row, j0, g.need, m, x);
    int leaf = j0 / g.P, part = j0 - leaf * g.P;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int j = j0 + i;
      if (j < g.kP) {
        const float mf = m[i] ? 1.0f : 0.0f;
        const float* ag = g.cell_agg + (size_t)j * NAGG;
        const float cnt = ag[A_COUNT];
        if (need_s) a.s = dadd(a.s, fmul(mf, x[S_CELL][i]));
        if (need_c) a.c = dadd(a.c, fmul(mf, x[C_CELL][i]));
        bool fb = false, over = false;
        float w = mf;
        if (CI) {
          over = overflowed(g, leaf);
          fb = m[i] && (x[N_GRP][i] < g.thr || over);
          w = (m[i] && !fb) ? 1.0f : 0.0f;
        }
        if (need_s) a.vs = dadd(a.vs, fmul(w, x[V_S][i]));
        if (need_c) a.vc = dadd(a.vc, fmul(w, x[V_C][i]));
        if (w_avg) a.csc = dadd(a.csc, fmul(w, x[COV_SC][i]));
        float p_lb = 0.0f, p_ub = 0.0f;
        if (w_sum || (CI && fb && need_s)) {
          const float sv = ag[A_SUM];
          const float mn = cnt > 0.0f ? ag[A_MIN] : 0.0f;
          const float mx = cnt > 0.0f ? ag[A_MAX] : 0.0f;
          p_ub = mm_min(fmul(cnt, max0(mx)), fsub(sv, fmul(cnt, min0(mn))));
          p_lb = mm_max(fmul(cnt, min0(mn)), fsub(sv, fmul(cnt, max0(mx))));
        }
        if (w_sum) {
          a.lbs = dadd(a.lbs, fmul(mf, p_lb));
          a.ubs = dadd(a.ubs, fmul(mf, p_ub));
        }
        if (w_cnt) a.ubc = dadd(a.ubc, fmul(mf, cnt));
        if (CI && fb) {
          const bool bern_ok = x[N_GRP][i] > 0.0f && !over;
          if (need_s)
            a.hs = dadd(a.hs, fb_half(x[S_CELL][i], x[V_S][i], x[R_S][i],
                                      p_lb, p_ub, bern_ok, L));
          if (need_c)
            a.hc = dadd(a.hc, fb_half(x[C_CELL][i], x[V_C][i], x[R_C][i],
                                      0.0f, cnt, bern_ok, L));
        }
        if (w_avg) {
          const float tx = m[i] ? ag[A_MAX] : -BIG;
          const float tn = m[i] ? ag[A_MIN] : BIG;
          a.pmax = max_nan(a.pmax, tx);
          a.kmax = max(a.kmax, __float_as_int(tx));
          a.pmin = min_nan(a.pmin, tn);
          a.kmin = min(a.kmin, __float_as_int(tn));
          a.any |= (int)m[i];
        }
      }
      if (++part == g.P) {
        part = 0;
        ++leaf;
      }
    }
  }
}

__device__ __forceinline__ void put(const Args& g, int slot, int q,
                                    int field, float v) {
  g.out[((size_t)slot * FIELDS + field) * g.Q + q] = v;
}

// One kind's row: estimate, half, lower, upper, touched, and the clipped
// interval with a level.
template <bool CI>
__device__ void put_kind(const Args& g, int slot, int q, float est,
                         float half, float lower, float upper, float tch) {
  put(g, slot, q, 0, est);
  put(g, slot, q, 1, half);
  put(g, slot, q, 2, lower);
  put(g, slot, q, 3, upper);
  put(g, slot, q, 4, tch);
  if (CI) {
    put(g, slot, q, 5, mm_clip(fsub(est, half), lower, upper));
    put(g, slot, q, 6, mm_clip(fadd(est, half), lower, upper));
  }
}

// Each kind's scalars from the block's sums (assemble_join,
// compose_join_interval and _with_interval, op for op).
// The block's sums, each rounded once to float32, and AVG's signed
// extremes.
struct Sums {
  float s, c, vs, vc, csc, lbs, ubs, ubc, hs, hc, pmax, pmin;
  bool any;
};

__device__ Sums rounded(const Acc& t) {
  Sums a;
  a.s = __double2float_rn(t.s);
  a.c = __double2float_rn(t.c);
  a.vs = __double2float_rn(t.vs);
  a.vc = __double2float_rn(t.vc);
  a.csc = __double2float_rn(t.csc);
  a.lbs = __double2float_rn(t.lbs);
  a.ubs = __double2float_rn(t.ubs);
  a.ubc = __double2float_rn(t.ubc);
  a.hs = __double2float_rn(t.hs);
  a.hc = __double2float_rn(t.hc);
  a.pmax = with_sign(t.pmax, t.kmax);
  a.pmin = with_sign(t.pmin, t.kmin);
  a.any = t.any != 0;
  return a;
}

template <bool CI>
__device__ void epilogue(const Args& g, int q, const Acc& acc) {
  const Sums a = rounded(acc);
  const float ex_s = g.exact3[(size_t)q * 3 + 0];
  const float ex_c = g.exact3[(size_t)q * 3 + 2];
  const float tch = g.touched[q];
  const float scale = CI ? *g.z : g.lam;
  if (g.slot_sum >= 0) {
    const float half = CI ? fadd(fmul(scale, __fsqrt_rn(a.vs)), a.hs)
                          : fmul(scale, __fsqrt_rn(a.vs));
    put_kind<CI>(g, g.slot_sum, q, fadd(ex_s, a.s), half, fadd(ex_s, a.lbs),
                 fadd(ex_s, a.ubs), tch);
  }
  if (g.slot_count >= 0) {
    const float half = CI ? fadd(fmul(scale, __fsqrt_rn(a.vc)), a.hc)
                          : fmul(scale, __fsqrt_rn(a.vc));
    // The count's cell lower bounds are zeros: their masked sum is +0.0.
    put_kind<CI>(g, g.slot_count, q, fadd(ex_c, a.c), half,
                 fadd(ex_c, 0.0f), fadd(ex_c, a.ubc), tch);
  }
  if (g.slot_avg >= 0) {
    const float s = fadd(ex_s, a.s);
    const float c = clamp_min(fadd(ex_c, a.c), 1.0f);
    const float est = __fdiv_rn(s, c);
    const float var_ratio = __fdiv_rn(
        max0(fadd(fsub(a.vs, fmul(fmul(2.0f, est), a.csc)),
                  fmul(fmul(est, est), a.vc))),
        fmul(c, c));
    float half = fmul(scale, __fsqrt_rn(var_ratio));
    if (CI) {
      const float half_fb = __fdiv_rn(fadd(a.hs, fmul(fabsf(est), a.hc)),
                                      clamp_min(fsub(c, a.hc), 1.0f));
      half = fadd(half, half_fb);
    }
    const bool has_cover = ex_c > 0.0f;
    const float avg_cover = __fdiv_rn(ex_s, clamp_min(ex_c, 1.0f));
    const bool both = has_cover && a.any;
    const float upper = both ? mm_max(avg_cover, a.pmax)
                             : (has_cover ? avg_cover : a.pmax);
    const float lower = both ? mm_min(avg_cover, a.pmin)
                             : (has_cover ? avg_cover : a.pmin);
    put_kind<CI>(g, g.slot_avg, q, est, half, lower, upper, tch);
  }
}

template <bool CI>
__global__ void __launch_bounds__(THREADS)
join_epilogue_kernel(const Args g) {
  __shared__ Acc s_warp[WARPS];
  __shared__ int s_nfb;
  const int q = blockIdx.x;
  const size_t row = (size_t)q * g.kP;
  float L = 0.0f;
  if (CI) {
    if (g.union_budget) {
      if (threadIdx.x == 0) s_nfb = 0;
      __syncthreads();
      const int n = count_fallback(g, row);
      if (n) atomicAdd(&s_nfb, n);     // an integer sum: any order
      __syncthreads();
      L = logf(fmul(fmul(clamp_min((float)s_nfb, 1.0f), 3.0f),
                    g.inv_delta));
    } else {
      L = *g.log_term;
    }
  }
  Acc a;
  a.init();
  fold_cells<CI>(g, row, L, a);
  // A fixed tree: within each warp by shuffles, then the warps in order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc o;
    a.shfl_down(o, off);
    a.merge(o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc t = s_warp[0];
    for (int w = 1; w < WARPS; ++w) t.merge(s_warp[w]);
    epilogue<CI>(g, q, t);
  }
}

}  // namespace

// The launch's constants, for the wrapper's limits.
extern "C" int repro_join_epilogue_threads() { return THREADS; }
extern "C" int repro_join_epilogue_chunk() { return CHUNK; }

// One launch on `stream`: a block a query. `z` is read with a level
// (ci != 0), `log_term` under the "stratum" budget; `slot_*` is each
// kind's row of `out`, -1 for a kind not requested.
extern "C" int repro_join_epilogue(
    const float* s_cell, const float* c_cell, const float* v_s,
    const float* v_c, const float* cov_sc, const float* n_grp,
    const float* r_s, const float* r_c, const uint8_t* sampled,
    const float* cell_agg, const void* u_overflow, const float* exact3,
    const float* touched, const float* z, const float* log_term, float* out,
    int Q, int kP, int P, int slot_sum, int slot_count, int slot_avg, int ci,
    int union_budget, int over64, float lam, float thr, float inv_delta,
    void* stream) {
  if (Q < 1 || kP < 1 || P < 1 || kP % P != 0 || kP > INT_MAX - CHUNK
      || (slot_sum < 0 && slot_count < 0 && slot_avg < 0)
      || (ci && (z == nullptr || (!union_budget && log_term == nullptr))))
    return (int)cudaErrorInvalidValue;
  Args g;
  const float* planes[PLANES] = {s_cell, c_cell, v_s, v_c, cov_sc, n_grp,
                                 r_s, r_c};
  const bool w_s = slot_sum >= 0 || slot_avg >= 0;
  const bool w_c = slot_count >= 0 || slot_avg >= 0;
  g.need = (w_s ? (1 << S_CELL) | (1 << V_S) : 0)
         | (w_c ? (1 << C_CELL) | (1 << V_C) : 0)
         | (slot_avg >= 0 ? 1 << COV_SC : 0)
         | (ci ? 1 << N_GRP : 0)
         | (ci && w_s ? 1 << R_S : 0) | (ci && w_c ? 1 << R_C : 0);
  bool vec = kP % CHUNK == 0
      && (reinterpret_cast<uintptr_t>(sampled) & 3) == 0;
  for (int p = 0; p < PLANES; ++p) {
    g.plane[p] = planes[p];
    if ((g.need >> p) & 1)
      vec = vec && (reinterpret_cast<uintptr_t>(planes[p]) & 15) == 0;
  }
  g.sampled = sampled;
  g.cell_agg = cell_agg;
  g.u_overflow = u_overflow;
  g.exact3 = exact3;
  g.touched = touched;
  g.z = z;
  g.log_term = log_term;
  g.out = out;
  g.Q = Q;
  g.kP = kP;
  g.P = P;
  g.slot_sum = slot_sum;
  g.slot_count = slot_count;
  g.slot_avg = slot_avg;
  g.union_budget = union_budget;
  g.over64 = over64;
  g.vec = vec;
  g.lam = lam;
  g.thr = thr;
  g.inv_delta = inv_delta;
  cudaStream_t st = (cudaStream_t)stream;
  if (ci)
    join_epilogue_kernel<true><<<(unsigned)Q, THREADS, 0, st>>>(g);
  else
    join_epilogue_kernel<false><<<(unsigned)Q, THREADS, 0, st>>>(g);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
