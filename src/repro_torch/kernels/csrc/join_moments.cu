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
// boxes whole in shared memory and a query's bounds in registers. Above,
// a tile kernel of its own runs (2', join_tile_wide_kernel), whose shared
// memory and registers do not grow with D. (The first one was the
// tile kernel with the columns in blocks of 16: it compared all D columns
// of every pair, then a lane a mixed pair tested all D columns of 32 slots
// at a time from L2, 100-byte rows a lane; at 25 columns on an H100 the
// walks took ~24 and the classes ~1.2 of its 25.6 ms,
// tools/wide_walk_split.py --target join.) Tiles of WCT = 64 cells x QB =
// 32 queries, three blocks an SM (two, with double-buffered rows, ran
// slower):
//  a. Classes, a block of CCOLS = 32 columns at a time: the cells' boxes,
//     the queries' bounds and the tile's box (fminf / fmaxf of its cells'
//     boxes) go to shared memory. A query compares only the columns where
//     its bounds do not hold the tile's box: any other column holds every
//     cell's box, so it passes both tests and every slot of the tile (the
//     rule of wide_cols.cuh; phase 30's queries bound 2-4 of 24 fact
//     columns). Those columns are the query's cut list (the first JCUT = 8,
//     with their bounds: row 9's own capacity, since a third of phase 30's
//     (query, tile)s cut 5 columns, past wide_cols.cuh's CUT_MAX = 4), and
//     of them a pair keeps those that do not hold its cell's box (a byte a
//     pair). A pair whose cell has a NaN coordinate (the box leaves NaN
//     out) or whose query cuts more than JCUT tests every column: the same
//     walk on a slower branch.
//  b. Walks: a warp takes a cell at a time from the block's counter. For
//     each window of SWIN = 32 slots it stages the run's rows in shared
//     memory by cp.async (one contiguous run, 16 bytes a copy, where D is
//     odd: a column of the window is then on 32 banks; else rows of D + 1
//     floats; above SCOLS = 31 columns a chunk of 31 at a time, only the
//     chunks a pair tests). The cell's mixed pairs' (query, column) test
//     items go a lane an item, each testing its column on every slot of
//     the window, and a query's items are ANDed by shuffles (at phase
//     30's join on an H100 the tests took ~0.48 ms so, ~1.0 a lane a slot
//     and a ballot a column, ~1.8 a lane a query). Then, while the next
//     window's rows and values are on their way, each mixed query's lane
//     folds its pair's relevant slots (inside, or with a non-finite
//     value, whose 0 * a is NaN) in slot order, folding a group at the
//     first end flag at or after its last relevant slot: a skipped slot
//     would add +0.0 or -0.0, which changes no sum, and a group with no
//     relevant slot folds nothing.
//  c. The results go to a round's room of W_RES = 1024 pairs at each
//     cell's offset (a round is as many of the block's queries as fit;
//     phase 30's blocks hold at most 939 mixed pairs, one round), then
//     every (query, plane) row piece of the tile is written once from the
//     totals (covered), the room (mixed) or +0.0 (empty), 16-byte
//     streaming stores (4-byte where kP % 4 != 0).
// The compares are exact and every fold runs in slot order, so every
// class, `in` and bit is the D <= 16 kernel's test's, and the first wide
// kernel's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 128;        // cells a tile (moments)
constexpr int QB = 32;         // queries a block (moments)
constexpr int NT = 256;        // threads a block (moments): 8 warps
constexpr int STATS = 8;       // output planes
constexpr int MAX_D = 16;      // predicate columns whole; above, 2' runs
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
template <int VW, int DD>  // DD > 0: D fixed; 0: D <= MAX_D
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
  extern __shared__ __align__(16) float smem[];
  float* s_box = smem;                   // [D][lo, hi][CT]
  float* s_tot = s_box + 2 * D * CT;     // [STATS][CT]
  int* s_flag = (int*)(s_tot + STATS * CT);  // [CT]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* w_res = (float*)(s_flag + CT) + warp * STATS * W_CAP;  // [8][W_CAP]
  uint16_t* w_list = (uint16_t*)((float*)(s_flag + CT)
                                 + NT / 32 * STATS * W_CAP) + warp * W_CAP;
  const int cell0 = blockIdx.x * CT;
  const int q0 = blockIdx.y * QB;
  const int nc = min(CT, kP - cell0);
  for (int i = tid; i < nc * 2 * D; i += NT) {
    const int e = i / (2 * D), r = i - e * 2 * D;
    const int side = r / D, j = r - side * D;
    s_box[(j * 2 + side) * CT + e] = cell_box[(size_t)cell0 * 2 * D + i];
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
      float ql[ND], qh[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const bool on = DD > 0 || j < D;
        ql[j] = on ? q_lo[(size_t)q * D + j] : 0.0f;
        qh[j] = on ? q_hi[(size_t)q * D + j] : 0.0f;
      }
      walk_run<DD>(run, ql, qh, D, inv_p, acc);
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

// 2'. The planes above MAX_D columns (join_tile_wide_kernel): tiles of WCT
// cells x QB queries, the block's query l = q0 + l. Shared memory is the
// same at every D (WideSmem); the design is in the file's comment.
constexpr int WCT = 64;          // cells a tile (wide)
constexpr int W_RES = 1024;      // mixed pairs' results a round (wide)
constexpr int JCUT = 8;          // cut columns a (query, tile) keeps (wide)
constexpr int CCOLS = 32;        // columns the classes take at once (wide)
constexpr int BROW = 2 * CCOLS + 1;  // floats a cell's staged box: odd, so
                                     // a column of 32 cells is on 32 banks
constexpr int QROW = CCOLS + 1;  // floats a query's staged bounds
constexpr int SWIN = 32;         // slots a staged window (wide)
constexpr int SCOLS = 31;        // columns a window stages at once (wide):
                                 // odd, so a column of 32 slots' rows is
                                 // on 32 banks
constexpr int WQ = QB / (NT / WCT);  // queries a thread classifies: 8
static_assert(QB == 32, "a lane a query: the walk's fold");
static_assert(WCT == 64 && NT == 256, "classes: 4 threads a cell");
static_assert(CCOLS == 32 && NT / QB == 8, "hold: 8 threads a query");

// The wide tile kernel's shared memory (bytes from the start), the same at
// every D. Beside the tile's totals, flags and runs: per cell the mixed
// and covered bits of the block's queries (byte h of a cell's word:
// queries 8h..8h+7) and the round's result offsets; per query its mixed
// cells, cut column count and first JCUT cut columns as (lo, hi, column,
// 0); per pair the columns of its query's list that cut it ([QB][WCT],
// bit t: list entry t); the results [STATS][W_RES] of a round's mixed
// pairs. Then, first for the classes and then for the walks: a column
// block's cell boxes [WCT][lo, hi][CCOLS] (BROW floats a cell), query
// bounds [lo, hi][QB][QROW], the tile's box [lo, hi][CCOLS], the queries'
// held columns and cut counts before the block [QB]; or per warp a
// window's staged rows (SWIN rows of up to SCOLS floats, and 4 for the
// rows' alignment) and values [SWIN].
struct WideSmem {
  static constexpr int tot = 0;
  static constexpr int flag = tot + 4 * STATS * WCT;
  static constexpr int rs = flag + 4 * WCT;
  static constexpr int re = rs + 4 * WCT;
  static constexpr int mix = re + 4 * WCT;
  static constexpr int cov = mix + 4 * WCT;
  static constexpr int off = cov + 4 * WCT;
  static constexpr int cnt = off + 4 * WCT;
  static constexpr int ncut = cnt + 4 * QB;
  static constexpr int cutv = ncut + 4 * QB;
  static constexpr int pcut = cutv + 16 * QB * JCUT;
  static constexpr int next = pcut + WCT * QB;
  static constexpr int res = next + 16;
  static constexpr int box = res + 4 * STATS * W_RES;
  static constexpr int qb = box + 4 * WCT * BROW;
  static constexpr int tb = qb + 4 * 2 * QB * QROW;
  static constexpr int hold = tb + 4 * 2 * CCOLS;
  static constexpr int nbase = hold + 4 * QB;
  static constexpr int xbuf = SWIN * SCOLS + 4;      // floats a window
  static constexpr int warp_floats = xbuf + SWIN;
  static constexpr int x = box;
  static constexpr int bytes =
      nbase + 4 * QB > x + 4 * NT / 32 * warp_floats
          ? nbase + 4 * QB
          : x + 4 * NT / 32 * warp_floats;
};
// Three blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block.
static_assert(3 * (WideSmem::bytes + 1024) <= 228 * 1024, "3 blocks an SM");
static_assert(WideSmem::cutv % 16 == 0 && WideSmem::box % 16 == 0,
              "aligned carve-up");

// The pointers of a block's WideSmem.
struct WideRoom {
  float* tot;
  int *flag, *rs, *re;
  const uint32_t* mix;  // per cell, bit l: (query l, cell) mixed
  const uint32_t* cov;  // covered
  uint8_t* mixb;        // the same words by bytes (classes write them)
  uint8_t* covb;
  int *off, *cnt, *ncut, *nbase, *next;
  float4* cutv;         // [QB][JCUT]: lo, hi, column (int bits), 0
  uint8_t* pcut;        // [QB][WCT]
  float *res, *box, *qb, *tb;
  uint32_t* hold;
  float* x;             // the warps' staged windows
};

__device__ __forceinline__ WideRoom wide_room(unsigned char* s) {
  WideRoom r;
  r.tot = (float*)(s + WideSmem::tot);
  r.flag = (int*)(s + WideSmem::flag);
  r.rs = (int*)(s + WideSmem::rs);
  r.re = (int*)(s + WideSmem::re);
  r.mixb = s + WideSmem::mix;
  r.covb = s + WideSmem::cov;
  r.mix = (const uint32_t*)r.mixb;
  r.cov = (const uint32_t*)r.covb;
  r.off = (int*)(s + WideSmem::off);
  r.cnt = (int*)(s + WideSmem::cnt);
  r.ncut = (int*)(s + WideSmem::ncut);
  r.nbase = (int*)(s + WideSmem::nbase);
  r.cutv = (float4*)(s + WideSmem::cutv);
  r.pcut = s + WideSmem::pcut;
  r.next = (int*)(s + WideSmem::next);
  r.res = (float*)(s + WideSmem::res);
  r.box = (float*)(s + WideSmem::box);
  r.qb = (float*)(s + WideSmem::qb);
  r.tb = (float*)(s + WideSmem::tb);
  r.hold = (uint32_t*)(s + WideSmem::hold);
  r.x = (float*)(s + WideSmem::x);
  return r;
}

// The classes of the tile's (query, cell) pairs, a column block of CCOLS
// at a time: for each block its cells' box columns, the queries' bounds
// and the tile's box (fminf / fmaxf over the cells' boxes) go to shared
// memory; a query holds a column where its bounds hold the tile's box
// there (8 threads a query, the bits gathered by ballots), and every other
// column goes to its cut list (the first JCUT with their bounds; the count
// goes on). Thread (cell ce, queries 8h..8h+7) compares its pairs on the
// columns its queries do not hold: apart in one, the pair is empty; inside
// every one, with no NaN coordinate on the cell's run, covered (a held
// column passes both tests for every cell of the tile: its box lies in the
// tile's); each list column that does not hold the cell's box cuts the
// pair (pcut). Ends with the cells' mixed and covered words written.
__device__ __forceinline__ void classify_wide(
    const WideRoom& r, const float* __restrict__ cell_box,
    const float* __restrict__ q_lo, const float* __restrict__ q_hi,
    int cell0, int nc, int q0, int nq, int D) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ce = tid % WCT, h = tid / WCT;
  const float inf = __int_as_float(0x7f800000);
  unsigned walk = 0u, cov = 0u;  // bit i: query WQ * h + i
  if (ce < nc) {
    for (int i = 0; i < WQ; ++i)
      if (WQ * h + i < nq) walk |= 1u << i;
    if (r.flag[ce] == 0) cov = walk;
  }
  for (int j0 = 0; j0 < D; j0 += CCOLS) {
    const int nj = min(CCOLS, D - j0);
    const uint32_t cols = nj >= 32 ? 0xffffffffu : (1u << nj) - 1u;
    __syncthreads();  // the previous block is read
    for (int i = tid; i < nc * 2 * nj; i += NT) {
      const int e = i / (2 * nj), rr = i - e * 2 * nj;
      const int side = rr / nj, j = rr - side * nj;
      r.box[e * BROW + side * CCOLS + j] =
          cell_box[(size_t)(cell0 + e) * 2 * D + (size_t)side * D + j0 + j];
    }
    for (int i = tid; i < 2 * nq * nj; i += NT) {
      const int side = i / (nq * nj), rr = i - side * nq * nj;
      const int l = rr / nj, j = rr - l * nj;
      r.qb[(side * QB + l) * QROW + j] =
          (side ? q_hi : q_lo)[(size_t)(q0 + l) * D + j0 + j];
    }
    __syncthreads();
    for (int j = warp; j < nj; j += NT / 32) {
      float lo = inf, hi = -inf;
      for (int e = lane; e < nc; e += 32) {
        lo = fminf(lo, r.box[e * BROW + j]);
        hi = fmaxf(hi, r.box[e * BROW + CCOLS + j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) {
        r.tb[j] = lo;
        r.tb[CCOLS + j] = hi;
      }
    }
    __syncthreads();
    {
      // Thread (query l, columns jj + 8s): held bits, then the list.
      const int l = tid >> 3, jj = tid & 7, sh = 8 * (l & 3);
      uint32_t hold = 0u;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = jj + 8 * s;
        const bool held = j < nj && l < nq
            && r.qb[l * QROW + j] <= r.tb[j]
            && r.tb[CCOLS + j] <= r.qb[(QB + l) * QROW + j];
        hold |= ((__ballot_sync(0xffffffffu, held) >> sh) & 0xffu) << (8 * s);
      }
      if (jj == 0 && l < nq) {
        int n = r.ncut[l];
        r.nbase[l] = n;
        for (uint32_t todo = ~hold & cols; todo != 0u; todo &= todo - 1u) {
          const int j = __ffs(todo) - 1;
          if (n < JCUT)
            r.cutv[l * JCUT + n] = make_float4(
                r.qb[l * QROW + j], r.qb[(QB + l) * QROW + j],
                __int_as_float(j0 + j), 0.0f);
          ++n;
        }
        r.ncut[l] = n;
        r.hold[l] = hold;
      }
    }
    __syncthreads();
    for (int i = 0; i < WQ; ++i) {
      if (!((walk >> i) & 1u)) continue;
      const int l = WQ * h + i;
      const float* ql = r.qb + l * QROW;
      const float* qh = r.qb + (QB + l) * QROW;
      const float* bl = r.box + ce * BROW;
      int t = r.nbase[l];
      uint32_t pc = 0u;
      for (uint32_t todo = ~r.hold[l] & cols; todo != 0u;
           todo &= todo - 1u, ++t) {
        const int j = __ffs(todo) - 1;
        const float lo = bl[j], hi = bl[CCOLS + j];
        if (qh[j] < lo || ql[j] > hi) {
          walk &= ~(1u << i);
          break;
        }
        if (!(ql[j] <= lo && hi <= qh[j])) {
          cov &= ~(1u << i);
          if (t < JCUT) pc |= 1u << t;
        }
      }
      r.pcut[l * WCT + ce] |= (uint8_t)pc;
    }
  }
  cov &= walk;
  r.mixb[ce * 4 + h] = (uint8_t)(walk & ~cov);
  r.covb[ce * 4 + h] = (uint8_t)cov;
}

// The k-th (from 0) set bit of m.
__device__ __forceinline__ int nth_bit(uint32_t m, int k) {
  for (; k > 0; --k) m &= m - 1u;
  return __ffs(m) - 1;
}

// Every mixed query's window bits at once, a lane a test item: a (query,
// column) of the staged columns [c0, c0 + ncol) its pair is tested on,
// that lane's pair's cut columns (pc: positions in its query's list) or
// every column (every: the cell has a NaN coordinate, or the query cuts
// more than JCUT). A round takes the queries, in lane order, whose items
// fit the 32 lanes; an item lane tests its column on each of the n
// staged slots (rows of srow floats from x), and the items of a query are
// ANDed (a segmented reduction by shuffles) into its lane's bits `my`. A
// query whose slots are all out already is not tested.
__device__ __forceinline__ uint32_t test_items(
    uint32_t my, bool mine, bool every, uint32_t pc, const WideRoom& r,
    const float* x, int srow, int n, const float* __restrict__ q_lo,
    const float* __restrict__ q_hi, int q0, int D, int c0, int ncol,
    int lane) {
  // The lane's query's items: its list positions in the chunk.
  uint32_t pcc = 0u;
  int cnt = 0;
  if (mine && my != 0u) {
    if (every) {
      cnt = ncol;
    } else {
      for (uint32_t t = pc; t != 0u; t &= t - 1u) {
        const int j = __float_as_int(r.cutv[lane * JCUT + __ffs(t) - 1].z)
                      - c0;
        if (j >= 0 && j < ncol) pcc |= t & (0u - t);
      }
      cnt = __popc(pcc);
    }
  }
  uint32_t rem = __ballot_sync(0xffffffffu, cnt > 0);
  while (rem != 0u) {
    // The round: the queries of rem whose items, in lane order, fit.
    const int c = (rem >> lane) & 1u ? cnt : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const int excl = incl - c;
    const bool in_round = c > 0 && incl <= 32;
    const uint32_t rq = __ballot_sync(0xffffffffu, in_round);
    const uint32_t starts =
        __reduce_or_sync(0xffffffffu, in_round ? 1u << excl : 0u);
    const int total = (int)__reduce_max_sync(0xffffffffu,
                                             in_round ? (unsigned)incl : 0u);
    // The lane's item: query l's k-th column.
    int l = lane, k = 0;
    if (lane < total) {
      l = nth_bit(rq, __popc(starts & ((2u << lane) - 1u)) - 1);
    }
    const int s = __shfl_sync(0xffffffffu, excl, l);
    const int cl = __shfl_sync(0xffffffffu, c, l);
    const int e = lane < total ? s + cl : lane + 1;
    const uint32_t pl = __shfl_sync(0xffffffffu, pcc, l);
    const bool evl = __shfl_sync(0xffffffffu, (int)every, l) != 0;
    uint32_t bits = 0xffffffffu;
    if (lane < total) {
      k = lane - s;
      int j;
      float lo, hi;
      if (evl) {
        j = k;
        lo = q_lo[(size_t)(q0 + l) * D + c0 + k];
        hi = q_hi[(size_t)(q0 + l) * D + c0 + k];
      } else {
        const float4 cv = r.cutv[l * JCUT + nth_bit(pl, k)];
        j = __float_as_int(cv.z) - c0;
        lo = cv.x;
        hi = cv.y;
      }
      const float* col = x + j;
      bits = 0u;
#pragma unroll 4
      for (int b = 0; b < n; ++b) {
        const float v = col[b * srow];
        bits |= (uint32_t)(lo <= v && v <= hi) << b;
      }
    }
    // Each query's items ANDed into its first item's lane.
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_down_sync(0xffffffffu, bits, o);
      if (lane + o < e) bits &= y;
    }
    const uint32_t got = __shfl_sync(0xffffffffu, bits, in_round ? excl : 0);
    if (in_round) my &= got;
    rem &= ~rq;
  }
  return my;
}

// A window's relevant slots of the lane's pair in slot order: those inside
// (my) and those whose value is not finite, whose 0 * a is NaN; the others
// would add +0.0 and -0.0 terms, which change no sum (a group's totals
// start at +0.0 and never hold -0.0), and a group with no relevant slot
// folds nothing. A group is folded at the first end flag at or after its
// last relevant slot (pend: a group is open; from: the window's first
// slot whose end flag closes it), the same sums in the same order as a
// fold at its last slot.
__device__ __forceinline__ void fold_window(CellSums& acc, uint32_t rel,
                                            uint32_t my, uint32_t ends,
                                            const float* xa, float inv_p,
                                            bool& pend) {
  int from = 0;
  for (; rel != 0u; rel &= rel - 1u) {
    const int b = __ffs(rel) - 1;
    if (pend && (ends & ((1u << b) - 1u) & ~((1u << from) - 1u)) != 0u)
      acc.fold();
    acc.add((my >> b) & 1u, xa[b], inv_p);
    pend = true;
    from = b;
  }
  if (pend && (ends >> from) != 0u) {
    acc.fold();
    pend = false;
  }
}

// Stage n slots' rows of columns [c0, c0 + ncol) from src (the first
// slot's column c0; D floats a slot) into the warp's buffer by cp.async,
// one commit group: slot b's row at the returned pointer + b * srow. Where
// the rows are one contiguous run (every column, srow = D) it goes 16 bytes
// at a time (4 at its unaligned ends; the buffer takes the run's
// alignment); else a float at a time.
__device__ __forceinline__ float* stage_rows(float* x,
                                             const float* __restrict__ src,
                                             int n, int D, int ncol,
                                             int srow, int lane) {
  if (ncol == D && srow == D) {
    const int total = n * D;
    const int head = min(total, (int)((16u - ((uintptr_t)src & 15u)) & 15u)
                                    / 4);
    float* x0 = x + ((4 - head) & 3);
    for (int e = lane; e < head; e += 32) cp_async4(x0 + e, src + e);
    const int chunks = (total - head) / 4;
    for (int k = lane; k < chunks; k += 32)
      cp_async16(x0 + head + 4 * k, src + head + 4 * k);
    for (int e = head + 4 * chunks + lane; e < total; e += 32)
      cp_async4(x0 + e, src + e);
    cp_async_commit();
    return x0;
  }
  const float inv = 1.0f / (float)ncol;
  for (int e = lane; e < n * ncol; e += 32) {
    const int b = (int)(((float)e + 0.5f) * inv);
    const int u = e - b * ncol;
    cp_async4(x + b * srow + u, src + (size_t)b * D + u);
  }
  cp_async_commit();
  return x;
}

// A window of a cell's run the warp walks: slots [i0, min(i0 + SWIN, end))
// of cell c, whose leaf's slots start at leaf0 and whose mixed queries
// this round are M.
struct Window {
  int c, i0, end;
  size_t leaf0;
  uint32_t M;
};

// The warp's next window: the cell's next one, else the first of the next
// cell (from the block's counter) with a mixed query this round; a mixed
// pair on a cell without a slot takes the walk of no slot (+0.0) here.
// False when no cell is left.
__device__ __forceinline__ bool next_window(const WideRoom& r, Window& w,
                                            uint32_t gm, int cell0, int nc,
                                            int su, int P, float one_m_p,
                                            int lane) {
  if (w.c >= 0 && w.i0 + SWIN < w.end) {
    w.i0 += SWIN;
    return true;
  }
  for (;;) {
    int c = 0;
    if (lane == 0) c = atomicAdd(r.next, 1);
    c = __shfl_sync(0xffffffffu, c, 0);
    if (c >= nc) return false;
    const uint32_t M = r.mix[c] & gm;
    if (M == 0u) continue;
    const int start = r.rs[c], end = r.re[c];
    if (start < end) {
      w = {c, start, end, (size_t)((cell0 + c) / P) * su, M};
      return true;
    }
    if ((M >> lane) & 1u) {
      CellSums none;
      none.init();
      none.save(r.res + r.off[c] + __popc(M & ((1u << lane) - 1u)), W_RES,
                one_m_p);
    }
  }
}

// The round's walks, a warp a cell at a time (taken in turn from the
// block's counter): a lane a test item while a window is tested, a lane a
// query while it is folded. For each window of SWIN slots the warp stages
// the run's rows (SCOLS columns at a time above SCOLS, only the chunks a
// mixed query tests) and the slots' values, end flags and non-finite
// flags; the next window's values are loaded during the tests
// (test_items), its rows staged during the fold of this one's relevant
// slots by every mixed query's lane.
__device__ __forceinline__ void walk_cells(
    const WideRoom& r, const float* __restrict__ coord,
    const float* __restrict__ a, const uint8_t* __restrict__ last,
    const float* __restrict__ q_lo, const float* __restrict__ q_hi,
    uint32_t gm, int cell0, int nc, int q0, int su, int P, int D,
    float inv_p, float one_m_p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xw = r.x + warp * WideSmem::warp_floats;
  // Rows of D floats where D is odd (a column of the window's slots on 32
  // banks), else of D + 1; above SCOLS, chunks of SCOLS.
  const int srow = D > SCOLS ? SCOLS : D | 1;
  Window cur = {-1, 0, 0, 0, 0u};
  float av = 0.0f;
  bool e = false;
  const float* x = xw;
  // A window's rows (cp.async) and its values and end flags (registers).
  auto stage = [&](const Window& w) {
    x = stage_rows(xw, coord + (w.leaf0 + w.i0) * D,
                   min(SWIN, w.end - w.i0), D, min(SCOLS, D), srow, lane);
  };
  auto values = [&](const Window& w) {
    av = 0.0f;
    e = false;
    if (lane < min(SWIN, w.end - w.i0)) {
      av = a[w.leaf0 + w.i0 + lane];
      e = last[w.leaf0 + w.i0 + lane] != 0;
    }
  };
  bool have = next_window(r, cur, gm, cell0, nc, su, P, one_m_p, lane);
  if (have) {
    stage(cur);
    values(cur);
  }
  CellSums acc;
  acc.init();
  bool pend = false;
  while (have) {
    const int n = min(SWIN, cur.end - cur.i0);
    const uint32_t valid = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
    const uint32_t M = cur.M;
    const bool mine = (M >> lane) & 1u;
    const bool nan_cell = r.flag[cur.c] != 0;
    // The lane's pair: every column, or its cut columns.
    const bool every = nan_cell || r.ncut[lane] > JCUT;
    const uint32_t pc = mine ? r.pcut[lane * WCT + cur.c] : 0u;
    float* xa = xw + WideSmem::xbuf;
    const uint32_t ends = __ballot_sync(0xffffffffu, e);
    const uint32_t nonfin =
        __ballot_sync(0xffffffffu, lane < n && !isfinite(av));
    __syncwarp();  // the last window's values are read
    xa[lane] = av;
    // The next window, its values on their way during this one's tests.
    Window nxt = cur;
    const bool have_n = next_window(r, nxt, gm, cell0, nc, su, P, one_m_p,
                                    lane);
    if (have_n) values(nxt);
    cp_async_wait<0>();
    __syncwarp();
    uint32_t my = valid;
    for (int c0 = 0; c0 < D; c0 += SCOLS) {
      const int ncol = min(SCOLS, D - c0);
      if (c0 > 0) {
        // A later column chunk, staged only if a mixed query tests it.
        bool need = mine && every;
        if (mine) {
          for (uint32_t t = pc; !need && t != 0u; t &= t - 1u) {
            const int j = __float_as_int(
                r.cutv[lane * JCUT + __ffs(t) - 1].z);
            need = j >= c0 && j < c0 + ncol;
          }
        }
        if (!__any_sync(0xffffffffu, need)) continue;
        __syncwarp();  // the previous chunk's rows are read
        x = stage_rows(xw, coord + (cur.leaf0 + cur.i0) * D + c0, n, D, ncol,
                       srow, lane);
        cp_async_wait<0>();
        __syncwarp();
      }
      my = test_items(my, mine, every, pc, r, x, srow, n, q_lo, q_hi, q0, D,
                      c0, ncol, lane);
    }
    __syncwarp();  // the rows are read
    if (have_n) stage(nxt);
    if (mine)
      fold_window(acc, (my | nonfin) & valid, my, ends, xa, inv_p, pend);
    if (cur.i0 + SWIN >= cur.end) {
      if (mine)
        acc.save(r.res + r.off[cur.c] + __popc(M & ((1u << lane) - 1u)),
                 W_RES, one_m_p);
      acc.init();
      pend = false;
    }
    cur = nxt;
    have = have_n;
  }
}

// The rows of the round's queries [qa, qb): each (query, plane) row piece
// of the tile written once, the cell's totals (covered), the walk's result
// (mixed) or +0.0 (empty): VW = 4, a half warp a piece, a lane's 4 cells
// one 16-byte streaming store; VW = 1, a warp a piece, 4-byte stores.
template <int VW>
__device__ __forceinline__ void store_rows(const WideRoom& r,
                                           float* __restrict__ out,
                                           uint32_t gm, int qa, int qb,
                                           int cell0, int nc, int q0, int Q,
                                           int kP) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t plane = (size_t)Q * kP;
  const int n_pieces = (qb - qa) * STATS;
  auto value = [&](int l, int st, int ce) {
    const uint32_t bit = 1u << l;
    const uint32_t mx = r.mix[ce] & gm;
    return (r.cov[ce] & bit) ? r.tot[st * WCT + ce]
         : (mx & bit) ? r.res[st * W_RES + r.off[ce] + __popc(mx & (bit - 1u))]
                      : 0.0f;
  };
  if (VW == 4) {
    const int c = 4 * (lane & 15);
    for (int p = 2 * warp + (lane >> 4); p < n_pieces; p += NT / 16) {
      const int l = qa + p / STATS, st = p % STATS;
      if (c >= nc) continue;
      float* o = out + st * plane + (size_t)(q0 + l) * kP + cell0 + c;
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(value(l, st, c), value(l, st, c + 1),
                         value(l, st, c + 2), value(l, st, c + 3)));
    }
  } else {
    for (int p = warp; p < n_pieces; p += NT / 32) {
      const int l = qa + p / STATS, st = p % STATS;
      float* o = out + st * plane + (size_t)(q0 + l) * kP + cell0;
      for (int ce = lane; ce < nc; ce += 32) __stcs(o + ce, value(l, st, ce));
    }
  }
}

template <int VW>
__global__ void __launch_bounds__(NT, 3)
join_tile_wide_kernel(const float* __restrict__ coord,
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
  extern __shared__ __align__(16) unsigned char wsmem[];
  const WideRoom r = wide_room(wsmem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cell0 = blockIdx.x * WCT, q0 = blockIdx.y * QB;
  const int nc = min(WCT, kP - cell0), nq = min(QB, Q - q0);
  for (int i = tid; i < STATS * nc; i += NT) {
    const int st = i / nc, e = i - st * nc;
    r.tot[st * WCT + e] = totals[(size_t)st * kP + cell0 + e];
  }
  if (tid < WCT) {
    const int cell = cell0 + tid;
    const int leaf = cell / P, p = cell - leaf * P;
    const int* ls = cell_start + (size_t)leaf * (P + 1);
    r.flag[tid] = tid < nc ? flag[cell] : 0;
    r.rs[tid] = tid < nc ? ls[p] : 0;
    r.re[tid] = tid < nc ? ls[p + 1] : 0;
  }
  for (int i = tid; i < WCT * QB / 4; i += NT)
    reinterpret_cast<uint32_t*>(r.pcut)[i] = 0u;
  if (tid < QB) r.ncut[tid] = 0;
  __syncthreads();
  classify_wide(r, cell_box, q_lo, q_hi, cell0, nc, q0, nq, D);
  __syncthreads();
  // Each query's mixed cells (a warp four queries, a lane two cells).
#pragma unroll
  for (int i = 0; i < QB / (NT / 32); ++i) {
    const int l = warp * (QB / (NT / 32)) + i;
    int n = 0;
    for (int ce = lane; ce < nc; ce += 32) n += (r.mix[ce] >> l) & 1u;
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0) r.cnt[l] = n;
  }
  __syncthreads();
  // Rounds of queries whose mixed pairs fit W_RES results (a query has at
  // most WCT <= W_RES of them).
  for (int qa = 0; qa < nq;) {
    int qb = qa, n = 0;
    while (qb < nq && n + r.cnt[qb] <= W_RES) n += r.cnt[qb++];
    const uint32_t gm = (qb >= 32 ? 0xffffffffu : (1u << qb) - 1u)
                        & ~((1u << qa) - 1u);
    if (qa > 0) __syncthreads();  // the previous round's rows are stored
    if (warp == 0) {
      // The round's result offsets, cell by cell (a lane two cells).
      const int c1 = 2 * lane, c2 = c1 + 1;
      const int n1 = c1 < nc ? __popc(r.mix[c1] & gm) : 0;
      const int n2 = c2 < nc ? __popc(r.mix[c2] & gm) : 0;
      int incl = n1 + n2;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      r.off[c1] = incl - n1 - n2;
      r.off[c2] = incl - n2;
      if (lane == 0) *r.next = 0;
    }
    __syncthreads();
    walk_cells(r, coord, a, last, q_lo, q_hi, gm, cell0, nc, q0, su, P, D,
               inv_p, one_m_p);
    __syncthreads();
    store_rows<VW>(r, out, gm, qa, qb, cell0, nc, q0, Q, kP);
    qa = qb;
  }
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

// Dynamic shared memory of the tile kernel (D <= MAX_D): boxes, totals
// and flags, and per warp the walks' results and the list of mixed cells.
size_t tile_smem(int D) {
  return sizeof(float) * (2 * (size_t)D * CT + (size_t)STATS * CT + CT
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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, st>>>(coord, a, last, cell_start, cell_box,
                                 totals, flag, q_lo, q_hi, out, Q, kP, su, P,
                                 D, inv_p, one_m_p);
  return cudaGetLastError();
}

// The wide tile kernel (D > MAX_D): tiles of WCT cells x QB queries.
template <int VW>
cudaError_t launch_wide(cudaStream_t st, const float* coord, const float* a,
                        const uint8_t* last, const int* cell_start,
                        const float* cell_box, const float* totals,
                        const int* flag, const float* q_lo,
                        const float* q_hi, float* out, int Q, int kP, int su,
                        int P, int D, float inv_p, float one_m_p) {
  auto kernel = join_tile_wide_kernel<VW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WideSmem::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((kP + WCT - 1) / WCT),
                  (unsigned)((Q + QB - 1) / QB));
  kernel<<<grid, NT, WideSmem::bytes, st>>>(coord, a, last, cell_start,
                                           cell_box, totals, flag, q_lo,
                                           q_hi, out, Q, kP, su, P, D, inv_p,
                                           one_m_p);
  return cudaGetLastError();
}

}  // namespace

// The launch's constants, for the wrapper's limits and scratch.
extern "C" int repro_join_moments_query_tile() { return QB; }
extern "C" int repro_join_moments_cell_tile() { return CT; }
// Columns the tile kernel holds whole; above, the wide tile kernel runs.
extern "C" int repro_join_moments_max_d() { return MAX_D; }
// The wide tile kernel's cells a tile and results a round.
extern "C" int repro_join_moments_wide_cell_tile() { return WCT; }
extern "C" int repro_join_moments_wide_results() { return W_RES; }
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
  if (D > MAX_D)
    err = kP % 4 == 0
        ? launch_wide<4>(st, coord, a, last, cell_start, cell_box, totals,
                         flag, q_lo, q_hi, out, Q, (int)kP, su, P, D, inv_p,
                         one_m_p)
        : launch_wide<1>(st, coord, a, last, cell_start, cell_box, totals,
                         flag, q_lo, q_hi, out, Q, (int)kP, su, P, D, inv_p,
                         one_m_p);
  else
    err = kP % 4 == 0
        ? launch_tiles<4>(grid, smem, st, coord, a, last, cell_start,
                          cell_box, totals, flag, q_lo, q_hi, out, Q, (int)kP,
                          su, P, D, inv_p, one_m_p)
        : launch_tiles<1>(grid, smem, st, coord, a, last, cell_start,
                          cell_box, totals, flag, q_lo, q_hi, out, Q, (int)kP,
                          su, P, D, inv_p, one_m_p);
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
