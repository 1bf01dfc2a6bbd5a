// join_moments: the per-(query, cell) statistics of an fk-join answer
// (row 9 of PERF.md's kernel table). A cell is a (fact leaf, dim
// partition) pair, id leaf * P + part; kP = k * P cells.
//
// The JAX package has no Pallas kernel for it: the join artifact stage is
// plain jnp (src/repro/joins/executor.py:108-171, compute_join_artifacts).
// There, a (Q, G) predicate over the G = k * su universe slots, two
// scatter-adds into (Q, G) group totals and six scatters into (Q, kP)
// cells give, per cell:
//   s_cell = sum_g t_s(g)          c_cell = sum_g t_c(g)
//   v_s    = (1 - p) sum_g t_s^2   v_c    = (1 - p) sum_g t_c^2
//   cov_sc = (1 - p) sum_g t_s t_c n_grp  = sum_g [t_c > 0]
//   r_s    = max(0, max_g |t_s|)   r_c    = max(0, max_g t_c)
// over the key groups g of the cell (the slots of one leaf that share a
// key; a group whose key has no dim partition is dropped), where
//   t_c(g) = sum over g's slots of  in ? 1/p : 0
//   t_s(g) = sum over g's slots of (in ? 1/p : 0) * a
// in slot order, in = the slot's [fact coords ‖ dim attrs] inside the
// query box (bounds inclusive, NaN never inside), and p = p_u. Beside
// them exact3 (Q, 3) = cover @ cell_agg[:, :3] and touched (Q,) =
// (sampled @ cell_agg[:, COUNT]) / max(total_rows, 1)
// (executor.py:122,164).
//
// Inputs (built once per synopsis epoch by plain torch,
// kernels/join_moments.py join_slots): each leaf's valid slots with a dim
// partition, stably sorted by (partition, key): coord (k, su, D), a
// (k, su), last (k, su) bool (slot i the last of its key group: its key
// differs from slot i + 1's, or it ends the leaf's runs); cell_start
// (k, P + 1) int32, cell (leaf, p) being the run
// [cell_start[leaf][p], cell_start[leaf][p + 1]);
// cell_box (kP, 2, D), the box of the run's coordinates with NaN left
// out, or (-inf, +inf) where a slot of the run has a non-finite a. The
// sort is stable, so a group's slots keep their slot order and a cell's
// groups come in ascending key order: the orders of the reference's two
// scatters. Then the queries q_lo / q_hi (Q, D), cover / sampled (Q, kP)
// bool, cell_agg (kP, 5) and total_rows (a float on the device).
//
// Output: out (8, Q, kP) f32, the planes s_cell, c_cell, v_s, v_c,
// cov_sc, n_grp, r_s, r_c; exact3 (Q, 3); touched (Q,).
//
// Bits: every sum runs in the reference's order, one element after the
// other from +0.0, each product and sum pinned with __fmul_rn /
// __fadd_rn (no contraction into an FMA), the (1 - p) scale after the
// sum. No float atomics, no library call, and nothing but the grid reads
// Q, so a row's bits do not depend on the batch it came in and two
// launches give the same bits. A cell whose box the query misses holds
// no slot inside the box, so its group totals are all +0.0 and it writes
// +0.0 without a walk: the reference's value. (A slot with a non-finite a
// puts NaN into t_s whatever the predicate, 0 * inf being NaN; its cell's
// box is unbounded, so it is always walked.)
//
// What bounds it on an H100: the bytes of the eight (Q, kP) planes, 1.07
// GB at the slice's shape (Q = 2048, k = 1024, P = 16), ~0.32 ms at
// 3.35 TB/s; the slot tests are ~1 G operations.
//
// Design, first version. Moments: a block owns QB = 128 queries (a thread
// each) and one leaf. For each of the leaf's cells it tests the cell's
// box against the thread's query and, if they meet, walks the cell's run
// of the leaf's sorted slots (every thread of a warp reads the same slot:
// a broadcast from L1), keeping the running group's totals (t_s, t_c) and
// folding them into the cell's eight sums at each group's last slot (the
// `last` flags, computed with the layout); the column loop is unrolled
// for D <= 4. The block's results go through shared memory, PC = 8 cells
// at a time, so the planes are written as rows of PC contiguous floats;
// ~39 KB of shared memory at D = 2. The eight (Q, kP) planes are most of
// the bytes, and their write pattern set this shape: earlier versions
// with other block shapes wrote them more than twice as slowly on an
// H100 (PERF.md, PR 19). Exact: one thread a (query, column) pair,
// the columns exact3's three and touched's sum, each a chain over the kP
// cells in ascending order, the cells staged in shared memory a tile at a
// time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 128;       // queries a block (moments), one a thread
constexpr int PC = 8;         // cells staged a round
constexpr int STATS = 8;      // output planes
constexpr int MAX_D = 16;     // predicate columns
constexpr int EX_Q = 8;       // queries a block (exact)
constexpr int EX_TILE = 512;  // cells a tile (exact)

// max with NaN kept (XLA's max), from the fold's +0.0 start.
__device__ __forceinline__ float max_nan(float acc, float x) {
  return (x > acc || x != x) ? x : acc;
}

// The eight sums of one cell for one query.
struct CellSums {
  float s, c, vs, vc, csc, ng, rs, rc;
  float ts, tc;   // the running group's totals
  __device__ __forceinline__ void init() {
    s = c = vs = vc = csc = ng = rs = rc = ts = tc = 0.0f;
  }
  // One slot: row_c = in ? 1/p : 0, added to the group's totals.
  __device__ __forceinline__ void add(bool in, float a, float inv_p) {
    const float row_c = in ? inv_p : 0.0f;
    tc = __fadd_rn(tc, row_c);
    ts = __fadd_rn(ts, __fmul_rn(row_c, a));
  }
  // The group's end: its totals into the cell's sums, in group order.
  __device__ __forceinline__ void fold() {
    s = __fadd_rn(s, ts);
    c = __fadd_rn(c, tc);
    vs = __fadd_rn(vs, __fmul_rn(ts, ts));
    vc = __fadd_rn(vc, __fmul_rn(tc, tc));
    csc = __fadd_rn(csc, __fmul_rn(ts, tc));
    ng = __fadd_rn(ng, tc > 0.0f ? 1.0f : 0.0f);
    rs = max_nan(rs, fabsf(ts));
    rc = max_nan(rc, tc);
    ts = 0.0f;
    tc = 0.0f;
  }
  __device__ __forceinline__ void save(float* o, int ps,
                                       float one_m_p) const {
    o[0 * ps] = s;
    o[1 * ps] = c;
    o[2 * ps] = __fmul_rn(one_m_p, vs);
    o[3 * ps] = __fmul_rn(one_m_p, vc);
    o[4 * ps] = __fmul_rn(one_m_p, csc);
    o[5 * ps] = ng;
    o[6 * ps] = rs;
    o[7 * ps] = rc;
  }
};

// Slot test of one query against a slot's coordinates: lo_j <= x_j <= hi_j
// for every column (false on NaN). DD > 0 fixes the column count at
// compile time; DD = 0 reads it from D.
template <int DD>
__device__ __forceinline__ bool inside(const float* x, const float* lo,
                                       const float* hi, int D) {
  bool in = true;
  if (DD > 0) {
#pragma unroll
    for (int j = 0; j < DD; ++j)
      in = in & (lo[j * QB] <= x[j]) & (x[j] <= hi[j * QB]);
  } else {
    for (int j = 0; j < D; ++j)
      in = in & (lo[j * QB] <= x[j]) & (x[j] <= hi[j * QB]);
  }
  return in;
}

// The block's work: QB queries, thread t taking query t, one leaf, its P
// cells in rounds of PC.
template <int DD>
__device__ void leaf_cells(const float* __restrict__ lc,
                           const float* __restrict__ la,
                           const uint8_t* __restrict__ lend,
                           const int* __restrict__ ls,
                           const float* __restrict__ lbox,
                           const float* s_lo, const float* s_hi,
                           float* s_out, float* __restrict__ out, int Q,
                           int q0, int nq, size_t kP, size_t col_leaf,
                           int P, int D, float inv_p, float one_m_p) {
  const int t = threadIdx.x;
  const int ps = QB * (PC + 1);
  const size_t plane = (size_t)Q * kP;
  const bool live = t < nq;
  for (int p0 = 0; p0 < P; p0 += PC) {
    const int pn = min(PC, P - p0);
    for (int pi = 0; pi < pn; ++pi) {
      const int p = p0 + pi;
      const float* box = lbox + (size_t)p * 2 * D;
      bool walk = live;
      for (int j = 0; j < D; ++j)
        walk = walk && !(s_hi[j * QB + t] < box[j]
                         || s_lo[j * QB + t] > box[D + j]);
      CellSums acc;
      acc.init();
      if (walk) {
        const int end = ls[p + 1];
        for (int i = ls[p]; i < end; ++i) {
          const float* x = lc + (size_t)i * (DD > 0 ? DD : D);
          acc.add(inside<DD>(x, s_lo + t, s_hi + t, D), la[i], inv_p);
          if (lend[i]) acc.fold();
        }
      }
      acc.save(s_out + t * (PC + 1) + pi, ps, one_m_p);
    }
    __syncthreads();
    const size_t col0 = col_leaf + p0;
    for (int e = t; e < nq * pn; e += QB) {
      const int qi = e / pn, pi = e - qi * pn;
      float* dst = out + (size_t)(q0 + qi) * kP + col0 + pi;
      const float* src = s_out + qi * (PC + 1) + pi;
#pragma unroll
      for (int st = 0; st < STATS; ++st)
        dst[st * plane] = src[st * ps];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(QB)
join_moments_kernel(const float* __restrict__ coord,
                    const float* __restrict__ a,
                    const uint8_t* __restrict__ last,
                    const int* __restrict__ cell_start,
                    const float* __restrict__ cell_box,
                    const float* __restrict__ q_lo,
                    const float* __restrict__ q_hi, float* __restrict__ out,
                    int Q, int su, int P, int D, float inv_p,
                    float one_m_p) {
  extern __shared__ float smem[];
  float* s_lo = smem;                       // [D][QB]
  float* s_hi = s_lo + D * QB;              // [D][QB]
  float* s_out = s_hi + D * QB;             // [STATS][QB][PC + 1]
  const int leaf = blockIdx.x;
  const int t = threadIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, Q - q0);
  for (int e = t; e < QB * D; e += QB) {
    const int qi = e / D, j = e - qi * D;
    const bool live = qi < nq;
    s_lo[j * QB + qi] = live ? q_lo[(size_t)(q0 + qi) * D + j] : 0.0f;
    s_hi[j * QB + qi] = live ? q_hi[(size_t)(q0 + qi) * D + j] : 0.0f;
  }
  __syncthreads();
  const size_t kP = (size_t)gridDim.x * P;
  const float* lc = coord + (size_t)leaf * su * D;
  const float* la = a + (size_t)leaf * su;
  const uint8_t* lend = last + (size_t)leaf * su;
  const int* ls = cell_start + (size_t)leaf * (P + 1);
  const float* lbox = cell_box + (size_t)leaf * P * 2 * D;
  const size_t col_leaf = (size_t)leaf * P;
  switch (D) {
    case 1:
      leaf_cells<1>(lc, la, lend, ls, lbox, s_lo, s_hi, s_out, out, Q, q0,
                    nq, kP, col_leaf, P, D, inv_p, one_m_p);
      break;
    case 2:
      leaf_cells<2>(lc, la, lend, ls, lbox, s_lo, s_hi, s_out, out, Q, q0,
                    nq, kP, col_leaf, P, D, inv_p, one_m_p);
      break;
    case 3:
      leaf_cells<3>(lc, la, lend, ls, lbox, s_lo, s_hi, s_out, out, Q, q0,
                    nq, kP, col_leaf, P, D, inv_p, one_m_p);
      break;
    case 4:
      leaf_cells<4>(lc, la, lend, ls, lbox, s_lo, s_hi, s_out, out, Q, q0,
                    nq, kP, col_leaf, P, D, inv_p, one_m_p);
      break;
    default:
      leaf_cells<0>(lc, la, lend, ls, lbox, s_lo, s_hi, s_out, out, Q, q0,
                    nq, kP, col_leaf, P, D, inv_p, one_m_p);
  }
}

// A block of EX_Q queries x 4 columns, one thread a (query, column)
// chain: columns 0-2 sum cover * cell_agg[:, col] (exact3), column 3
// sampled * cell_agg[:, COUNT] (touched, then divided), over the cells in
// ascending order. The cells come in tiles of EX_TILE: the block loads the
// tile's mask bytes (16 at a time where rows are 16-byte aligned) and its
// three aggregate columns into shared memory, then each thread runs its
// chain over them.
__global__ void __launch_bounds__(EX_Q * 4)
join_exact_kernel(const uint8_t* __restrict__ cover,
                  const uint8_t* __restrict__ sampled,
                  const float* __restrict__ cell_agg,
                  const float* __restrict__ total_rows,
                  float* __restrict__ exact3, float* __restrict__ touched,
                  int Q, size_t kP) {
  // Rows padded by 4 bytes (one bank) and columns by one float, so the
  // warp's rows and columns fall on distinct banks.
  __shared__ __align__(16) uint8_t s_mask[2][EX_Q][EX_TILE + 4];
  __shared__ float s_agg[3][EX_TILE + 1];
  const int t = threadIdx.x;
  const int qi = t >> 2, col = t & 3;
  const int q0 = blockIdx.x * EX_Q;
  const int nq = min(EX_Q, Q - q0);
  const uint8_t* m = s_mask[col < 3 ? 0 : 1][qi];
  const float* g = s_agg[col < 3 ? col : 2];
  float acc = 0.0f;
  // Whole 16-byte mask loads when every row and tile starts 16-aligned.
  const bool vec = (kP & 15) == 0
      && (reinterpret_cast<uintptr_t>(cover) & 15) == 0
      && (reinterpret_cast<uintptr_t>(sampled) & 15) == 0;
  for (size_t c0 = 0; c0 < kP; c0 += EX_TILE) {
    const int n = (int)min((size_t)EX_TILE, kP - c0);
    if (vec) {
      // 16 bytes a load, stored as four words (rows are word-aligned).
      const int nv = n >> 4;
      for (int e = t; e < nq * nv; e += EX_Q * 4) {
        const int r = e / nv, v = e - r * nv;
        const size_t at = (size_t)(q0 + r) * kP + c0 + ((size_t)v << 4);
        const uint4 cw = *reinterpret_cast<const uint4*>(cover + at);
        const uint4 sw = *reinterpret_cast<const uint4*>(sampled + at);
        uint32_t* cd = reinterpret_cast<uint32_t*>(&s_mask[0][r][v << 4]);
        uint32_t* sd = reinterpret_cast<uint32_t*>(&s_mask[1][r][v << 4]);
        cd[0] = cw.x; cd[1] = cw.y; cd[2] = cw.z; cd[3] = cw.w;
        sd[0] = sw.x; sd[1] = sw.y; sd[2] = sw.z; sd[3] = sw.w;
      }
    } else {
      for (int e = t; e < nq * n; e += EX_Q * 4) {
        const int r = e / n, j = e - r * n;
        const size_t at = (size_t)(q0 + r) * kP + c0 + j;
        s_mask[0][r][j] = cover[at];
        s_mask[1][r][j] = sampled[at];
      }
    }
    for (int e = t; e < 3 * n; e += EX_Q * 4) {
      const int c = e / n, j = e - c * n;
      s_agg[c][j] = cell_agg[(c0 + j) * 5 + c];
    }
    __syncthreads();
    if (qi < nq) {
#pragma unroll 4
      for (int j = 0; j < n; ++j)
        acc = __fadd_rn(acc, __fmul_rn(m[j] ? 1.0f : 0.0f, g[j]));
    }
    __syncthreads();
  }
  if (qi >= nq) return;
  const int q = q0 + qi;
  if (col < 3)
    exact3[(size_t)q * 3 + col] = acc;
  else
    touched[q] = __fdiv_rn(acc, fmaxf(*total_rows, 1.0f));
}

// Dynamic shared memory of the moments kernel: the bounds and the
// output tile.
size_t moments_smem(int D) {
  return sizeof(float) * (2 * (size_t)D * QB
                          + (size_t)STATS * QB * (PC + 1));
}

}  // namespace

// The launch's constants, for the wrapper's limits.
extern "C" int repro_join_moments_query_tile() { return QB; }
extern "C" int repro_join_moments_max_d() { return MAX_D; }

// Both kernels on `stream`, the moments first; returns the first error.
extern "C" int repro_join_cell_moments(
    const float* coord, const float* a, const uint8_t* last,
    const int* cell_start, const float* cell_box, const float* q_lo,
    const float* q_hi, const uint8_t* cover, const uint8_t* sampled,
    const float* cell_agg, const float* total_rows, float* out,
    float* exact3, float* touched, int Q, int k, int su, int P, int D,
    float inv_p, float one_m_p, void* stream) {
  if (Q < 1 || k < 1 || su < 1 || P < 1 || D < 1 || D > MAX_D
      || (Q + QB - 1) / QB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = moments_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      join_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)k, (unsigned)((Q + QB - 1) / QB));
  join_moments_kernel<<<grid, QB, smem, st>>>(
      coord, a, last, cell_start, cell_box, q_lo, q_hi, out, Q, su, P, D,
      inv_p, one_m_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  join_exact_kernel<<<(unsigned)((Q + EX_Q - 1) / EX_Q), EX_Q * 4, 0,
                      st>>>(cover, sampled, cell_agg, total_rows, exact3,
                            touched, Q, (size_t)k * P);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
