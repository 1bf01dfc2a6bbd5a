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
// launches give the same bits. (A slot with a non-finite a puts NaN into
// t_s whatever the predicate, 0 * inf being NaN; its cell's box is
// unbounded, so it is never skipped as empty.)
//
// What bounds it on an H100: the bytes of the eight (Q, kP) planes, 1.07
// GB at the slice's shape (Q = 2048, k = 1024, P = 16), ~0.32 ms at
// 3.35 TB/s; the slot tests are ~1 G operations.
//
// Design (the second; PR 19's first walked every cell a query's box met,
// one thread a query, and wrote the planes 32 bytes a row). A (query,
// cell) pair is
//   empty:   the query box misses the cell's box in some column. The cell
//            holds no slot inside the box, so its group totals are all
//            +0.0, and so is every statistic: the walk's values.
//   covered: the query box holds the cell's box and no slot of the run has
//            a NaN coordinate. Every slot is inside, so the walk is the
//            same for every such query: the cell's totals, walked once.
//   mixed:   the rest; only these walk.
// Three kernels a launch:
//  1. join_cells_kernel: a warp a cell walks its run with every slot
//     inside, through the same CellSums add / fold / save as a query's
//     walk, into the cell's totals (8, kP), and flags a NaN coordinate on
//     a slot of the run (the slot test rejects NaN; the box leaves it out).
//     The lanes load 32 slots at once and every lane folds them in order
//     from shuffles.
//  2. join_tile_kernel: a block owns CT = 128 consecutive cells (any
//     leaves) and QB = 32 queries, 8 warps of QW = 4 queries each. The
//     cells' boxes, flags and totals sit in shared memory. A lane takes 4
//     consecutive cells and classifies them under each of its warp's
//     queries; the mixed (query, cell) pairs go to a per-warp list (up to
//     W_CAP = 128), and the warp's lanes walk the list, a pair a lane,
//     loading WB = 8 (4 above 2 columns) slots of the run at once and
//     adding them in slot order into shared memory. Then the warp writes
//     each of its queries' plane rows once: the totals (covered), the walk
//     (mixed) or +0.0 (empty), a lane's 4 cells as one 16-byte streaming
//     store a plane, so each (query, plane) row piece of the tile is 512
//     contiguous bytes (4-byte stores where kP is not a multiple of 4). A
//     walk's latency is paid once for all of a warp's queries whose mixed
//     pairs fit the list, and no plane value is written twice (an
//     overwrite of a streamed 4-byte value cost more than the walks
//     themselves). The class test is the walk's own compare for empty, so
//     an empty pair writes what a walk of no inside slot writes, and a
//     covered pair the walk's bits. At most 64 registers a thread: four
//     blocks an SM.
//  3. join_exact_kernel: one thread a (query, column) chain, the columns
//     exact3's three and touched's sum, each over the kP cells in
//     ascending order, EX_Q = 16 queries a block of two warps. Tiles of
//     EX_TILE cells of the block's mask rows (16-byte cp.async where every
//     row is 16-byte aligned) and the three aggregate columns (4-byte
//     cp.async, transposed) arrive double-buffered while the previous tile
//     is folded, and the next 16 terms are formed while the current 16 are
//     added, so the 2 * Q * kP mask bytes stream from HBM under the chain.
//     The chain itself, 16,384 dependent adds at the join shape, bounds it.
//
// Any D. Up to MAX_D = 16 columns the tile kernel holds the tile's cell
// boxes whole in shared memory and a query's bounds in registers. Above
// 16 its wide instantiation (DD = -1) takes the columns in blocks of
// WIDE_COLS = 16 (wide_cols.cuh), so that shared memory and registers do
// not grow with D: for each block the cells' box columns go to shared
// memory and every warp ANDs its (query, cell) pairs' walk / covered bits
// (already one bit a pair) over the blocks before it lists the mixed
// ones; a walk tests 32 slots of its run at a time, block by block, then
// adds them in slot order, folding at each group's end. The compares are
// exact, so the classes, the walks' `in` and every bit are those of the
// D <= 16 kernel's test.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_cols.cuh"

namespace {

constexpr int CT = 128;        // cells a tile (moments)
constexpr int QB = 32;         // queries a block (moments)
constexpr int NT = 256;        // threads a block (moments): 8 warps
constexpr int STATS = 8;       // output planes
constexpr int MAX_D = 16;      // predicate columns whole; above, blocks
constexpr int CELL_T = 128;    // threads a block (cell totals)
constexpr int WB = 8;          // slots a walk loads at once
constexpr int QW = QB / (NT / 32);  // queries a warp (tile kernel)
constexpr int W_CAP = 128;     // mixed cells a warp lists before it walks
constexpr int EX_Q = 16;       // queries a block (exact): two warps
constexpr int EX_TILE = 1024;  // cells a tile (exact)
constexpr int EX_PAD = 16;     // bytes after each mask row (banks)
constexpr int EX_ROW = EX_TILE + EX_PAD;
// Floats an aggregate row: 16 past the tile for the next terms' read, 4
// more so the three rows fall on other banks.
constexpr int EX_AGG = EX_TILE + 20;
constexpr int EX_BUF = 2 * EX_Q * EX_ROW + 3 * EX_AGG * 4;  // bytes a tile
constexpr int MAX_GRID_Y = 65535;

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
  __device__ __forceinline__ void save(float* o, size_t ps,
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

// A cell's run of its leaf's sorted slots.
struct Run {
  const float* lc;      // the leaf's coordinates (su, D)
  const float* la;      // its values
  const uint8_t* lend;  // its group-end flags
  int start, end;
};

__device__ __forceinline__ Run cell_run(const float* coord, const float* a,
                                        const uint8_t* last,
                                        const int* cell_start, int cell,
                                        int su, int P, int D) {
  const int leaf = cell / P, p = cell - leaf * P;
  const int* ls = cell_start + (size_t)leaf * (P + 1);
  return {coord + (size_t)leaf * su * D, a + (size_t)leaf * su,
          last + (size_t)leaf * su, ls[p], ls[p + 1]};
}

// Slot test of one query against a slot's coordinates: lo_j <= x_j <= hi_j
// for every column (false on NaN). DD > 0 fixes the column count at
// compile time; DD = 0 reads it from D (<= MAX_D).
template <int DD>
__device__ __forceinline__ bool inside(const float* x, const float* lo,
                                       const float* hi, int D) {
  bool in = true;
  constexpr int N = DD > 0 ? DD : MAX_D;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (DD > 0 || j < D) in = in & (lo[j] <= x[j]) & (x[j] <= hi[j]);
  return in;
}

// A query's walk of a cell's run in slot order. With the column count
// fixed at compile time the loads of WB slots are issued together and the
// slots then added in order: the same operations as one slot at a time,
// one load latency a WB slots.
template <int DD>
__device__ __forceinline__ void walk_run(const Run& run, const float* ql,
                                         const float* qh, int D,
                                         float inv_p, CellSums& acc) {
  int i = run.start;
  if (DD > 0) {
    constexpr int N = DD > 0 ? DD : 1;
    // Half the batch above 2 columns: the registers of 8 slots' coordinates
    // would cost the tile kernel its fourth block an SM.
    constexpr int B = DD > 2 ? WB / 2 : WB;
    for (; i + B <= run.end; i += B) {
      float x[B][N], av[B];
      uint8_t ends[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
#pragma unroll
        for (int j = 0; j < N; ++j) x[u][j] = run.lc[(size_t)(i + u) * N + j];
        av[u] = run.la[i + u];
        ends[u] = run.lend[i + u];
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        acc.add(inside<DD>(x[u], ql, qh, D), av[u], inv_p);
        if (ends[u]) acc.fold();
      }
    }
  }
  for (; i < run.end; ++i) {
    const float* x = run.lc + (size_t)i * D;
    acc.add(inside<DD>(x, ql, qh, D), run.la[i], inv_p);
    if (run.lend[i]) acc.fold();
  }
}

// walk_run at D > MAX_D: 32 slots tested at a time (slots_inside_wide, the
// query's rows lo / hi of D bounds), then added in slot order, each group
// folded at its last slot: the same adds and folds as walk_run's.
__device__ __forceinline__ void walk_run_wide(const Run& run,
                                              const float* lo,
                                              const float* hi, int D,
                                              float inv_p, CellSums& acc) {
  for (int i0 = run.start; i0 < run.end; i0 += 32) {
    const int n = min(32, run.end - i0);
    const uint32_t m =
        slots_inside_wide(run.lc + (size_t)i0 * D, n, D, lo, hi);
    for (int b = 0; b < n; ++b) {
      acc.add((m >> b) & 1u, run.la[i0 + b], inv_p);
      if (run.lend[i0 + b]) acc.fold();
    }
  }
}

// 1. Per cell (a warp): the walk of its run with every slot inside (the
// totals a covered pair takes), into totals (8, kP), and its NaN-coordinate
// flag. The lanes load 32 slots of the run at once; every lane then folds
// the same slots in slot order from the shuffled values, so the warp's
// latency is one load a 32 slots, not one a slot.
__global__ void __launch_bounds__(CELL_T)
join_cells_kernel(const float* __restrict__ coord,
                  const float* __restrict__ a,
                  const uint8_t* __restrict__ last,
                  const int* __restrict__ cell_start,
                  float* __restrict__ totals, int* __restrict__ flag,
                  int kP, int su, int P, int D, float inv_p,
                  float one_m_p) {
  const int cell = blockIdx.x * (CELL_T / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (cell >= kP) return;
  const Run run = cell_run(coord, a, last, cell_start, cell, su, P, D);
  CellSums acc;
  acc.init();
  bool nan = false;
  for (int i0 = run.start; i0 < run.end; i0 += 32) {
    const int i = i0 + lane, n = min(32, run.end - i0);
    float av = 0.0f;
    int end = 0;
    if (lane < n) {
      const float* x = run.lc + (size_t)i * D;
      for (int j = 0; j < D; ++j) nan |= x[j] != x[j];
      av = run.la[i];
      end = run.lend[i];
    }
    for (int u = 0; u < n; ++u) {
      acc.add(true, __shfl_sync(0xffffffffu, av, u), inv_p);
      if (__shfl_sync(0xffffffffu, end, u)) acc.fold();
    }
  }
  nan = __any_sync(0xffffffffu, nan);
  if (lane == 0) {
    acc.save(totals + cell, (size_t)kP, one_m_p);
    flag[cell] = nan;
  }
}

// 2. The planes of CT cells x QB queries: a warp takes QW = QB / 8
// queries, VW cells a lane (4 with 16-byte stores when kP is a multiple of
// 4, else 1). The warp classifies its queries' cells and lists the mixed
// ones (at most W_CAP at a time), deals the list to its lanes to walk
// (walk_run) into shared memory, then writes each plane row piece of the
// listed queries once: the cell's totals (covered), the walk (mixed) or
// +0.0 (empty). One round of walks serves all of the warp's queries whose
// mixed cells fit the list.
template <int VW, int DD>  // DD > 0: D fixed; 0: D <= MAX_D; -1: any D
__global__ void __launch_bounds__(NT, 4)
join_tile_kernel(const float* __restrict__ coord,
                 const float* __restrict__ a,
                 const uint8_t* __restrict__ last,
                 const int* __restrict__ cell_start,
                 const float* __restrict__ cell_box,
                 const float* __restrict__ totals,
                 const int* __restrict__ flag,
                 const float* __restrict__ q_lo,
                 const float* __restrict__ q_hi, float* __restrict__ out,
                 int Q, int kP, int su, int P, int D, float inv_p,
                 float one_m_p) {
  if (DD > 0) D = DD;
  // The box columns shared memory holds at once: all D, or a block.
  const int DB = DD < 0 ? WIDE_COLS : D;
  extern __shared__ __align__(16) float smem[];
  float* s_box = smem;                   // [DB][lo, hi][CT]
  float* s_tot = s_box + 2 * DB * CT;    // [STATS][CT]
  int* s_flag = (int*)(s_tot + STATS * CT);  // [CT]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* w_res = (float*)(s_flag + CT) + warp * STATS * W_CAP;  // [8][W_CAP]
  uint16_t* w_list = (uint16_t*)((float*)(s_flag + CT)
                                 + NT / 32 * STATS * W_CAP) + warp * W_CAP;
  const int cell0 = blockIdx.x * CT;
  const int q0 = blockIdx.y * QB;
  const int nc = min(CT, kP - cell0);
  if constexpr (DD >= 0) {
    for (int i = tid; i < nc * 2 * D; i += NT) {
      const int e = i / (2 * D), r = i - e * 2 * D;
      const int side = r / D, j = r - side * D;
      s_box[(j * 2 + side) * CT + e] = cell_box[(size_t)cell0 * 2 * D + i];
    }
  }
  for (int i = tid; i < STATS * nc; i += NT) {
    const int st = i / nc, e = i - st * nc;
    s_tot[st * CT + e] = totals[(size_t)st * kP + cell0 + e];
  }
  for (int e = tid; e < nc; e += NT) s_flag[e] = flag[cell0 + e];
  __syncthreads();

  constexpr int ND = DD > 0 ? DD : MAX_D;
  constexpr int UR = CT / VW / 32;  // units a lane: UR * VW = 4 cells
  const size_t plane = (size_t)Q * kP;
  const int n_units = (nc + VW - 1) / VW;
  const unsigned below = (1u << lane) - 1u;
  // The warp's queries: q0 + warp + 8 * w for w < n_q.
  const int n_q = max(0, min(QW, (Q - q0 - warp + NT / 32 - 1) / (NT / 32)));
  // Per query w: the lane's 4 cells' classes (bits 4w + c) and, for mixed
  // cells, their places in the list (bits 8c of pos[w]).
  unsigned walks = 0u, covers = 0u;
  unsigned pos[QW];
  int n_mix = 0, w_first = 0;

  // Walk the listed cells, then write the rows of queries [w_first, w_end).
  auto flush = [&](int w_end) {
    __syncwarp();
    for (int m = lane; m < n_mix; m += 32) {
      const int w = w_list[m] >> 7, ce = w_list[m] & 0x7f;
      const int q = q0 + warp + (NT / 32) * w;
      const Run run = cell_run(coord, a, last, cell_start, cell0 + ce, su,
                               P, D);
      CellSums acc;
      acc.init();
      if constexpr (DD < 0) {
        walk_run_wide(run, q_lo + (size_t)q * D, q_hi + (size_t)q * D, D,
                      inv_p, acc);
      } else {
        float ql[ND], qh[ND];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const bool on = DD > 0 || j < D;
          ql[j] = on ? q_lo[(size_t)q * D + j] : 0.0f;
          qh[j] = on ? q_hi[(size_t)q * D + j] : 0.0f;
        }
        walk_run<DD>(run, ql, qh, D, inv_p, acc);
      }
      acc.save(w_res + m, W_CAP, one_m_p);
    }
    __syncwarp();
#pragma unroll
    for (int w = 0; w < QW; ++w) {
      if (w < w_first || w >= w_end) continue;
      float* orow = out + (size_t)(q0 + warp + (NT / 32) * w) * kP + cell0;
#pragma unroll
      for (int r = 0; r < UR; ++r) {
        const int u = r * 32 + lane;
        if (u >= n_units) continue;
#pragma unroll
        for (int st = 0; st < STATS; ++st) {
          float v[VW];
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const int c = r * VW + e, bit = 4 * w + c;
            v[e] = (covers >> bit) & 1u ? s_tot[st * CT + u * VW + e]
                 : (walks >> bit) & 1u
                     ? w_res[st * W_CAP + ((pos[w] >> (8 * c)) & 0xffu)]
                     : 0.0f;
          }
          if (VW == 4)
            __stcs(reinterpret_cast<float4*>(orow + st * plane + u * 4),
                   make_float4(v[0], v[VW > 1 ? 1 : 0], v[VW > 2 ? 2 : 0],
                               v[VW > 3 ? 3 : 0]));
          else
            __stcs(orow + st * plane + u, v[0]);
        }
      }
    }
    __syncwarp();  // before the list and the results are refilled
    n_mix = 0;
    w_first = w_end;
  };

  if constexpr (DD < 0) {
    // The classes a column block at a time: for each block its cells' box
    // columns into s_box, then every (query w, cell c) bit 4w + c of walks
    // (apart in no block so far) and covers (inside every block so far).
#pragma unroll
    for (int w = 0; w < QW; ++w) {
      if (w >= n_q) break;
#pragma unroll
      for (int r = 0; r < UR; ++r) {
        const int u = r * 32 + lane;
        const bool live = u < n_units;
        const int o = (live ? u : 0) * VW;
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const int bit = 4 * w + r * VW + e;
          if (live && u * VW + e < nc) {
            walks |= 1u << bit;
            if (s_flag[o + e] == 0) covers |= 1u << bit;
          }
        }
      }
    }
    for (int j0 = 0; j0 < D; j0 += WIDE_COLS) {
      const int nj = min(WIDE_COLS, D - j0);
      __syncthreads();  // the previous block's boxes are read
      for (int i = tid; i < nc * 2 * nj; i += NT) {
        const int e = i / (2 * nj), r = i - e * 2 * nj;
        const int side = r / nj, j = r - side * nj;
        s_box[(j * 2 + side) * CT + e] =
            cell_box[(size_t)(cell0 + e) * 2 * D + (size_t)side * D + j0 + j];
      }
      __syncthreads();
#pragma unroll 1
      for (int w = 0; w < QW; ++w) {
        if (w >= n_q) break;
        const size_t qr = (size_t)(q0 + warp + (NT / 32) * w) * D + j0;
        float ql[WIDE_COLS], qh[WIDE_COLS];
#pragma unroll
        for (int j = 0; j < WIDE_COLS; ++j) {
          ql[j] = j < nj ? q_lo[qr + j] : 0.0f;
          qh[j] = j < nj ? q_hi[qr + j] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < UR; ++r) {
          const int u = r * 32 + lane;
          const int o = (u < n_units ? u : 0) * VW;
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            bool walk = true, covered = true;
#pragma unroll
            for (int j = 0; j < WIDE_COLS; ++j) {
              if (j < nj) {
                const float lo = s_box[(j * 2) * CT + o + e];
                const float hi = s_box[(j * 2 + 1) * CT + o + e];
                walk = walk && !(qh[j] < lo || ql[j] > hi);
                covered = covered && ql[j] <= lo && hi <= qh[j];
              }
            }
            const int bit = 4 * w + r * VW + e;
            if (!walk) walks &= ~(1u << bit);
            if (!covered) covers &= ~(1u << bit);
          }
        }
      }
    }
    covers &= walks;
#pragma unroll
    for (int w = 0; w < QW; ++w) {
      if (w >= n_q) break;
      const unsigned mixed = ((walks & ~covers) >> (4 * w)) & 0xfu;
      // The list takes the query's mixed cells, after a flush of the
      // queries before it when they would not fit.
      int count = __popc(mixed);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        count += __shfl_xor_sync(0xffffffffu, count, off);
      if (n_mix + count > W_CAP) flush(w);
      pos[w] = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool m = (mixed >> c) & 1u;
        const unsigned b = __ballot_sync(0xffffffffu, m);
        const int at = n_mix + __popc(b & below);
        if (m) {
          w_list[at] = (uint16_t)(w << 7 | ((c / VW) * 32 + lane) * VW + c % VW);
          pos[w] |= (unsigned)at << (8 * c);
        }
        n_mix += __popc(b);
      }
    }
  } else {
#pragma unroll
    for (int w = 0; w < QW; ++w) {
      if (w >= n_q) break;
      const int q = q0 + warp + (NT / 32) * w;
      float ql[ND], qh[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const bool on = DD > 0 || j < D;
        ql[j] = on ? q_lo[(size_t)q * D + j] : 0.0f;
        qh[j] = on ? q_hi[(size_t)q * D + j] : 0.0f;
      }
      // Classes of the lane's cells by the walk's own compares: empty iff
      // apart in a column.
      unsigned mixed = 0u;
#pragma unroll
      for (int r = 0; r < UR; ++r) {
        const int u = r * 32 + lane;
        const bool live = u < n_units;
        const int o = (live ? u : 0) * VW;
        bool walk[VW], covered[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          walk[e] = live && u * VW + e < nc;
          covered[e] = s_flag[o + e] == 0;
        }
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          if (DD > 0 || j < D) {
#pragma unroll
            for (int e = 0; e < VW; ++e) {
              const float lo = s_box[(j * 2) * CT + o + e];
              const float hi = s_box[(j * 2 + 1) * CT + o + e];
              walk[e] = walk[e] && !(qh[j] < lo || ql[j] > hi);
              covered[e] = covered[e] && ql[j] <= lo && hi <= qh[j];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const int bit = 4 * w + r * VW + e;
          walks |= (unsigned)walk[e] << bit;
          covers |= (unsigned)(walk[e] && covered[e]) << bit;
          mixed |= (unsigned)(walk[e] && !covered[e]) << (r * VW + e);
        }
      }
      // The list takes the query's mixed cells, after a flush of the
      // queries before it when they would not fit.
      int count = __popc(mixed);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        count += __shfl_xor_sync(0xffffffffu, count, off);
      if (n_mix + count > W_CAP) flush(w);
      pos[w] = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool m = (mixed >> c) & 1u;
        const unsigned b = __ballot_sync(0xffffffffu, m);
        const int at = n_mix + __popc(b & below);
        if (m) {
          w_list[at] = (uint16_t)(w << 7 | ((c / VW) * 32 + lane) * VW + c % VW);
          pos[w] |= (unsigned)at << (8 * c);
        }
        n_mix += __popc(b);
      }
    }
  }
  flush(n_q);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
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

// The terms of cells j..j+15 of one chain: mask byte ? 1 : 0 times the
// aggregate, each product rounded once (__fmul_rn).
__device__ __forceinline__ void terms16(const uint8_t* m, const float* g,
                                        int j, float* p) {
  const uint4 mw = *reinterpret_cast<const uint4*>(m + j);
  const uint32_t w[4] = {mw.x, mw.y, mw.z, mw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 gv = *reinterpret_cast<const float4*>(g + j + 4 * k);
    p[4 * k] = __fmul_rn((w[k] & 0xffu) ? 1.0f : 0.0f, gv.x);
    p[4 * k + 1] = __fmul_rn((w[k] & 0xff00u) ? 1.0f : 0.0f, gv.y);
    p[4 * k + 2] = __fmul_rn((w[k] & 0xff0000u) ? 1.0f : 0.0f, gv.z);
    p[4 * k + 3] = __fmul_rn((w[k] & 0xff000000u) ? 1.0f : 0.0f, gv.w);
  }
}

// 3. A block of EX_Q queries x 4 columns (two warps), one thread a (query,
// column) chain: columns 0-2 sum cover * cell_agg[:, col] (exact3),
// column 3 sampled * cell_agg[:, COUNT] (touched, then divided), over the
// cells in ascending order, each term __fmul_rn(mask, agg) and each sum
// __fadd_rn. ASYNC: every mask row is 16-byte aligned (kP a multiple of
// 16, aligned pointers), so tiles arrive by cp.async into the other half
// of shared memory while this one is folded; else plain loads, one tile at
// a time.
template <bool ASYNC>
__global__ void __launch_bounds__(EX_Q * 4)
join_exact_kernel(const uint8_t* __restrict__ cover,
                  const uint8_t* __restrict__ sampled,
                  const float* __restrict__ cell_agg,
                  const float* __restrict__ total_rows,
                  float* __restrict__ exact3, float* __restrict__ touched,
                  int Q, int kP) {
  extern __shared__ __align__(16) unsigned char ex_smem[];
  const int t = threadIdx.x;
  const int qi = t >> 2, col = t & 3;
  const int q0 = blockIdx.x * EX_Q;
  const int nq = min(EX_Q, Q - q0);
  const int n_tiles = (kP + EX_TILE - 1) / EX_TILE;
  // Tile t's masks [2][EX_Q][EX_ROW] bytes, then its columns [3][EX_AGG].
  auto stage = [&](int tile, unsigned char* buf) {
    const int c0 = tile * EX_TILE;
    const int n = min(EX_TILE, kP - c0);
    float* agg = (float*)(buf + 2 * EX_Q * EX_ROW);
    if (ASYNC) {
      const int nv = n >> 4;
      for (int e = t; e < 2 * nq * nv; e += EX_Q * 4) {
        const int mr = e / nv, v = e - mr * nv;
        const int m = mr / nq, r = mr - m * nq;
        const uint8_t* src = (m == 0 ? cover : sampled)
            + (size_t)(q0 + r) * kP + c0 + v * 16;
        cp_async16(buf + (m * EX_Q + r) * EX_ROW + v * 16, src);
      }
      for (int e = t; e < 3 * n; e += EX_Q * 4) {
        const int j = e / 3, c = e - j * 3;
        cp_async4(agg + c * EX_AGG + j, cell_agg + (size_t)(c0 + j) * 5 + c);
      }
    } else {
      for (int e = t; e < 2 * nq * n; e += EX_Q * 4) {
        const int mr = e / n, j = e - mr * n;
        const int m = mr / nq, r = mr - m * nq;
        buf[(m * EX_Q + r) * EX_ROW + j] =
            (m == 0 ? cover : sampled)[(size_t)(q0 + r) * kP + c0 + j];
      }
      for (int e = t; e < 3 * n; e += EX_Q * 4) {
        const int j = e / 3, c = e - j * 3;
        agg[c * EX_AGG + j] = cell_agg[(size_t)(c0 + j) * 5 + c];
      }
    }
  };
  float acc = 0.0f;
  const int mrow = (col < 3 ? 0 : EX_Q) + qi;
  const int gcol = col < 3 ? col : 2;
  if (ASYNC) {
    stage(0, ex_smem);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    unsigned char* buf = ex_smem + (ASYNC ? (tile & 1) * EX_BUF : 0);
    if (ASYNC) {
      if (tile + 1 < n_tiles) {
        stage(tile + 1, ex_smem + ((tile + 1) & 1) * EX_BUF);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage(tile, buf);
    }
    const int n = min(EX_TILE, kP - tile * EX_TILE);
    const uint8_t* m = buf + mrow * EX_ROW;
    const float* g = (const float*)(buf + 2 * EX_Q * EX_ROW) + gcol * EX_AGG;
    __syncthreads();
    if (ASYNC && qi < nq) {
      // n is a multiple of 16: the next 16 terms are formed while the
      // current 16 are added, so the adds' chain does not wait on them.
      float p[16];
      terms16(m, g, 0, p);
      for (int j = 0; j < n; j += 16) {
        float pn[16];
        terms16(m, g, j + 16, pn);  // past n: padding, never added
#pragma unroll
        for (int k = 0; k < 16; ++k) acc = __fadd_rn(acc, p[k]);
#pragma unroll
        for (int k = 0; k < 16; ++k) p[k] = pn[k];
      }
    } else if (qi < nq) {
      int j = 0;
#pragma unroll 4
      for (; j + 4 <= n; j += 4) {
        const uint32_t mw = *reinterpret_cast<const uint32_t*>(m + j);
        const float4 gv = *reinterpret_cast<const float4*>(g + j);
        acc = __fadd_rn(acc, __fmul_rn((mw & 0xffu) ? 1.0f : 0.0f, gv.x));
        acc = __fadd_rn(acc, __fmul_rn((mw & 0xff00u) ? 1.0f : 0.0f, gv.y));
        acc = __fadd_rn(acc,
                        __fmul_rn((mw & 0xff0000u) ? 1.0f : 0.0f, gv.z));
        acc = __fadd_rn(acc,
                        __fmul_rn((mw & 0xff000000u) ? 1.0f : 0.0f, gv.w));
      }
      for (; j < n; ++j)
        acc = __fadd_rn(acc, __fmul_rn(m[j] ? 1.0f : 0.0f, g[j]));
    }
    __syncthreads();  // before this half is staged again
  }
  if (qi >= nq) return;
  const int q = q0 + qi;
  if (col < 3)
    exact3[(size_t)q * 3 + col] = acc;
  else
    touched[q] = __fdiv_rn(acc, fmaxf(*total_rows, 1.0f));
}

// Dynamic shared memory of the tile kernel: boxes, totals and flags, and
// per warp the walks' results and the list of mixed cells.
size_t tile_smem(int D) {
  const size_t db = D > MAX_D ? WIDE_COLS : D;  // box columns held at once
  return sizeof(float) * (2 * db * CT + (size_t)STATS * CT + CT
                          + (size_t)NT / 32 * STATS * W_CAP)
      + sizeof(uint16_t) * NT / 32 * W_CAP;
}

template <int VW>
cudaError_t launch_tiles(dim3 grid, size_t smem, cudaStream_t st,
                         const float* coord, const float* a,
                         const uint8_t* last, const int* cell_start,
                         const float* cell_box, const float* totals,
                         const int* flag, const float* q_lo,
                         const float* q_hi, float* out, int Q, int kP,
                         int su, int P, int D, float inv_p, float one_m_p) {
  auto kernel = join_tile_kernel<VW, 0>;
  if (D == 1) kernel = join_tile_kernel<VW, 1>;
  if (D == 2) kernel = join_tile_kernel<VW, 2>;
  if (D == 3) kernel = join_tile_kernel<VW, 3>;
  if (D == 4) kernel = join_tile_kernel<VW, 4>;
  if (D > MAX_D) kernel = join_tile_kernel<VW, -1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, st>>>(coord, a, last, cell_start, cell_box,
                                 totals, flag, q_lo, q_hi, out, Q, kP, su, P,
                                 D, inv_p, one_m_p);
  return cudaGetLastError();
}

}  // namespace

// The launch's constants, for the wrapper's limits and scratch.
extern "C" int repro_join_moments_query_tile() { return QB; }
extern "C" int repro_join_moments_cell_tile() { return CT; }
// Columns the tile kernel holds whole; above, it takes blocks of this many.
extern "C" int repro_join_moments_max_d() { return MAX_D; }
// Floats of the scratch: the cells' totals (8, kP) and flags (kP,).
extern "C" long long repro_join_moments_scratch(int kP) {
  return (long long)(STATS + 1) * kP;
}

// The three kernels on `stream`, cell totals first; returns the first
// error.
extern "C" int repro_join_cell_moments(
    const float* coord, const float* a, const uint8_t* last,
    const int* cell_start, const float* cell_box, const float* q_lo,
    const float* q_hi, const uint8_t* cover, const uint8_t* sampled,
    const float* cell_agg, const float* total_rows, float* out,
    float* exact3, float* touched, float* scratch, long long scratch_floats,
    int Q, int k, int su, int P, int D, float inv_p, float one_m_p,
    void* stream) {
  const long long kP = (long long)k * P;
  if (Q < 1 || k < 1 || su < 1 || P < 1 || D < 1
      || kP > 0x7fffffffLL || (Q + QB - 1) / QB > MAX_GRID_Y
      || scratch_floats < (STATS + 1) * kP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* totals = scratch;
  int* flag = (int*)(scratch + STATS * kP);
  constexpr int CELLS_A_BLOCK = CELL_T / 32;
  join_cells_kernel<<<(unsigned)((kP + CELLS_A_BLOCK - 1) / CELLS_A_BLOCK),
                      CELL_T, 0, st>>>(coord, a, last, cell_start, totals, flag,
                            (int)kP, su, P, D, inv_p, one_m_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((kP + CT - 1) / CT), (unsigned)((Q + QB - 1) / QB));
  const size_t smem = tile_smem(D);
  err = kP % 4 == 0
      ? launch_tiles<4>(grid, smem, st, coord, a, last, cell_start, cell_box,
                        totals, flag, q_lo, q_hi, out, Q, (int)kP, su, P, D,
                        inv_p, one_m_p)
      : launch_tiles<1>(grid, smem, st, coord, a, last, cell_start, cell_box,
                        totals, flag, q_lo, q_hi, out, Q, (int)kP, su, P, D,
                        inv_p, one_m_p);
  if (err != cudaSuccess) return (int)err;
  const bool async = kP % 16 == 0
      && (reinterpret_cast<uintptr_t>(cover) & 15) == 0
      && (reinterpret_cast<uintptr_t>(sampled) & 15) == 0
      && (reinterpret_cast<uintptr_t>(cell_agg) & 3) == 0;
  const int ex_smem = async ? 2 * EX_BUF : EX_BUF;
  auto exact = async ? join_exact_kernel<true> : join_exact_kernel<false>;
  err = cudaFuncSetAttribute(exact,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ex_smem);
  if (err != cudaSuccess) return (int)err;
  exact<<<(unsigned)((Q + EX_Q - 1) / EX_Q), EX_Q * 4, ex_smem, st>>>(
      cover, sampled, cell_agg, total_rows, exact3, touched, Q, (int)kP);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
