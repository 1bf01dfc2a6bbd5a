// route_multid: for each row, the leaf box at the least L1 distance
// (0 inside the box), the lowest leaf id on ties. Returns leaf (B,) int32
// and that distance (B,) f32.
//
// Replaces the Pallas kernel src/repro/kernels/route.py::route_multid_pallas
// (body `_route_kernel`), which walks (row tile, leaf tile) on a grid whose
// leaf dimension is sequential, carrying the running (min, argmin) pair in
// its output block, and merges tiles with a strict `<`.
//
// Bit-equal to the dense oracle route_multid_dense on finite rows: the
// distance of a (row, leaf) pair is max(max(lo_j - c_j, c_j - hi_j), 0)
// summed over the dimensions j in order, in fp32, starting from dimension
// 0's term. There is no multiply, so nothing can contract to an FMA. The
// winner's distance goes out plus +0.0, which turns a -0.0 (a sum of
// terms max(-0.0, +0.0), where fmaxf may keep the sign the oracle's
// maximum drops) into +0.0 and leaves every other value as it is. An
// empty leaf is an inverted box (lo = +inf, hi = -inf) whose distance is
// +inf by itself, so it needs no mask and no padding. On a row with a NaN
// or infinite coordinate fmaxf drops the NaN that the oracle's maximum
// propagates; there the kernel keeps the bits of its first version (one
// thread per row over all leaves), whose per-term expression and scan it
// repeats.
//
// What bounds it on an H100: operations. B * k * d terms at 5 fp32
// operations each, against (2 k + B) * d * 4 bytes in and 8 B bytes out.
//
// Design: the leaves are split across the G blocks of a thread-block
// cluster, which share one tile of NT * RT rows. The wrapper's plan
// (route_plan in route.py) picks RT (rows a thread), G and the leaves a
// group from (B, k) so that one ingest batch (B = 4096) makes at least a
// block per multiprocessor.
//  1. Thread t holds rows t, t + NT, ... of the tile in registers; block g
//     stages the boxes of its leaf range [g * lg, (g + 1) * lg) (clipped
//     to k; empty when k < G) in shared memory, TK leaves at a time, as
//     (lo, hi) float2 pairs dimension-major, so that every thread reads
//     the same pair at once (a broadcast) and one load serves RT rows.
//  2. It scans its range in ascending id and replaces a row's best only on
//     a strict `<`, starting from (+inf, the range's first id).
//  3. After cluster.sync(), block g merges rows g, g + G, ... of the tile:
//     the G partials in rank order through distributed shared memory
//     (map_shared_rank), from (+inf, 0), again on a strict `<`. The ranges
//     ascend with the rank, so this is the full scan's result exactly: the
//     lowest id among equal distances, and (+inf, 0) when every box is
//     empty. A second cluster.sync() keeps every block's partials alive
//     until the merge has read them.
// One launch, no scratch, no memset, no atomics: the same bits on every
// launch.
//
// Any d. Up to MAX_D = 16 columns a thread holds its rows whole in
// registers and the staged boxes hold every column. Above 16 the wide
// kernel (route_multid_wide_kernel) has its own plan (route_wide_plan in
// route.py) and shape:
//  1. A block is WW = 4 warps over one tile of 32 * RT rows (lane l holds
//     rows l, l + 32, ... of it), all four warps the same rows; the
//     cluster's G blocks split the tile's leaves as above, and the block's
//     range [l0, l1) is split again into WW ascending sub-ranges of
//     ceil(lg / WW) leaves, warp w the w-th. At B = 4096, k = 1024 that is
//     512 blocks of 4 warps (RT = 2, G = 8): 4 blocks and 16 warps an SM,
//     where the column-block kernel it replaces ran 4 warps an SM.
//  2. A lane reads its rows once a launch: up to WCOLS = 32 columns from c
//     into registers (16-byte loads when d is a multiple of 4, all in
//     flight at once); above it the tile's rows are copied into shared
//     memory once, each row at an odd stride (d | 1, so that 32 lanes
//     reading 32 rows' column j meet 32 banks), or read from c itself when
//     the tile at that d passes WIDE_ROW_SMEM bytes, so any d runs.
//  3. Each warp stages its own sub-range's boxes, WTK = 32 leaves (WTKA =
//     8 above 32 columns) x WCOLS columns at a time, into shared memory as
//     they lie in device memory, a leaf's lo (and hi) columns in a row of
//     WCOLS floats, by cp.async (16 bytes a copy when the rows allow it,
//     all in flight at once: no value passes through a register); only
//     __syncwarp orders them, no block barrier. Every lane then reads the
//     same leaf's four columns of lo and of hi with two 16-byte loads (a
//     broadcast) that serve its RT rows. Up to 32 columns the kernel is
//     compiled for 4 * NQ of them (NQ = ceil(d / 4): straight-line code,
//     no branch a column, the loads of a leaf free to run ahead), and a
//     leaf's distance is summed whole, column 0 to 4 NQ - 1, and compared
//     at once; above, each (row, leaf) distance of the tile is a register
//     carried across the column blocks in column order.
//  4. Each warp scans its sub-range in ascending id on a strict `<` from
//     (+inf, its first id); the block merges its warps' partials in warp
//     order through shared memory from (+inf, 0), then the cluster merges
//     the blocks' as above.
// So each distance is still one running fp32 sum in column order from
// column 0's term, fmaxf(fmaxf(lo - x, x - hi), 0) a term (the oracle's
// sum: per-block partial sums would round otherwise and move ties and leaf
// ids), and the result is the full scan's: contiguous ascending
// sub-ranges, each scanned on a strict `<` and merged in ascending order
// on a strict `<`, give the lowest id among the least distances (a
// partial of +inf is never taken, so its id does not matter), and (+inf,
// 0) when no distance is below +inf. The winner's distance gets +0.0.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 64;      // threads per block
constexpr int TK = 256;     // leaves staged per tile
constexpr int MAX_D = 16;   // coordinate columns
constexpr int MAX_G = 8;    // blocks per cluster: the portable limit

// Step 3 of the design, for both kernels: the block's partials of its
// tile's rows (best, best_i) into s_best / s_leaf, then rows g, g + G, ...
// merged over the cluster's G partials in rank order from (+inf, 0) on a
// strict `<`, and written out (the distance plus +0.0).
template <int RT>
__device__ __forceinline__ void merge_partials(
    cg::cluster_group& cluster, int G, int g, int tid,
    const float (&best)[RT], const int (&best_i)[RT], float* s_best,
    int* s_leaf, int row0, int B, int32_t* __restrict__ leaf_out,
    float* __restrict__ dist_out) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    s_best[r * NT + tid] = best[r];
    s_leaf[r * NT + tid] = best_i[r];
  }
  cluster.sync();
  for (int i = g + G * tid; i < RT * NT; i += G * NT) {
    float bd = CUDART_INF_F;
    int bl = 0;
    for (int h = 0; h < G; ++h) {
      const float v = cluster.map_shared_rank(s_best, h)[i];
      if (v < bd) {
        bd = v;
        bl = cluster.map_shared_rank(s_leaf, h)[i];
      }
    }
    const int row = row0 + i;
    if (row < B) {
      leaf_out[row] = bl;
      dist_out[row] = __fadd_rn(bd, 0.f);
    }
  }
  cluster.sync();  // the other blocks have read this block's partials
}

// D > 0 fixes d at compile time; D = 0 takes any d <= MAX_D (above it,
// route_multid_wide_kernel).
template <int D, int RT>
__global__ void __launch_bounds__(NT)
route_multid_kernel(const float* __restrict__ leaf_lo,
                    const float* __restrict__ leaf_hi,
                    const float* __restrict__ c,
                    int32_t* __restrict__ leaf_out,
                    float* __restrict__ dist_out, int B, int k, int d,
                    int lg) {
  constexpr int DD = D > 0 ? D : MAX_D;
  __shared__ float2 s_box[DD * TK];   // [dimension][leaf] = (lo, hi)
  __shared__ float s_best[RT * NT];   // the block's partials, row-indexed
  __shared__ int s_leaf[RT * NT];
  if (D > 0) d = D;

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / G) * (RT * NT);

  float x[RT][DD];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row0 + r * NT + tid;
#pragma unroll
    for (int j = 0; j < DD; ++j)
      x[r][j] = (row < B && j < d) ? c[(size_t)row * d + j] : 0.f;
  }

  const int l0 = (int)min((long long)k, (long long)g * lg);
  const int l1 = (int)min((long long)k, (long long)l0 + lg);
  float best[RT];
  int best_i[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    best[r] = CUDART_INF_F;
    best_i[r] = l0;
  }
  for (int k0 = l0; k0 < l1; k0 += TK) {
    const int n = min(TK, l1 - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < n * d; i += NT) {
      const int l = i / d, j = i - l * d;
      s_box[j * TK + l] = make_float2(leaf_lo[(size_t)k0 * d + i],
                                      leaf_hi[(size_t)k0 * d + i]);
    }
    __syncthreads();
    for (int l = 0; l < n; ++l) {
      float dist[RT];
      const float2 b0 = s_box[l];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        dist[r] = fmaxf(fmaxf(b0.x - x[r][0], x[r][0] - b0.y), 0.f);
#pragma unroll
      for (int j = 1; j < DD; ++j) {
        if (j < d) {
          const float2 b = s_box[j * TK + l];
#pragma unroll
          for (int r = 0; r < RT; ++r)
            dist[r] = dist[r] +
                      fmaxf(fmaxf(b.x - x[r][j], x[r][j] - b.y), 0.f);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (dist[r] < best[r]) {
          best[r] = dist[r];
          best_i[r] = k0 + l;
        }
      }
    }
  }
  merge_partials<RT>(cluster, G, g, tid, best, best_i, s_best, s_leaf, row0,
                     B, leaf_out, dist_out);
}

// The wide kernel's shape (design above, "Any d").
constexpr int WW = 4;              // warps a block
constexpr int WNT = 32 * WW;       // threads a block
constexpr int WCOLS = 32;          // register columns; columns a staged tile
constexpr int WTK = 32;            // leaves a warp stages a tile, d <= WCOLS
constexpr int WTKA = 8;            // the same above WCOLS columns
constexpr int WIDE_ROW_SMEM = 160 * 1024;  // staged rows, at most (bytes)
static_assert(MAX_D == 16 && WCOLS == 32, "the register widths 17..32: NQ 5..8");

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

// Warp w's boxes of leaves base .. base + n - 1, columns j0 .. j0 + nj - 1,
// into s_lo / s_hi[leaf][column] (WCOLS floats a leaf) by cp.async: 16
// bytes a copy when the rows allow it (vec: d and j0 multiples of 4, the
// arrays 16-byte aligned), else 4. Waits for them and syncs the warp.
__device__ __forceinline__ void stage_boxes(float* s_lo, float* s_hi,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ hi,
                                            int base, int n, int j0, int nj,
                                            int d, bool vec, int lane) {
  if (vec) {
    const int per = nj >> 2;
    for (int i = lane; i < n * per; i += 32) {
      const int l = i / per, q = i - l * per;
      const size_t at = (size_t)(base + l) * d + j0 + 4 * q;
      cp_async16(s_lo + l * WCOLS + 4 * q, lo + at);
      cp_async16(s_hi + l * WCOLS + 4 * q, hi + at);
    }
  } else {
    for (int i = lane; i < n * nj; i += 32) {
      const int l = i / nj, j = i - l * nj;
      const size_t at = (size_t)(base + l) * d + j0 + j;
      cp_async4(s_lo + l * WCOLS + j, lo + at);
      cp_async4(s_hi + l * WCOLS + j, hi + at);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();
}

// d > MAX_D: NQ > 0 (d <= 4 * NQ <= WCOLS) holds the rows in registers,
// read from c once, and sums a leaf's distance whole over 4 * NQ columns
// (columns d .. 4 NQ - 1 of the rows and the staged boxes hold +0.0, so
// each of their terms is +0.0: it changes no sum but -0.0, which compares
// as +0.0 and leaves as +0.0); NQ = 0 (d > WCOLS) takes the rows from the
// staged tile (xs > 0, its row stride) or from c (xs = 0), and carries
// each distance across column blocks of WCOLS.
template <int RT, int NQ>
__global__ void __launch_bounds__(WNT, 4)
route_multid_wide_kernel(const float* __restrict__ leaf_lo,
                         const float* __restrict__ leaf_hi,
                         const float* __restrict__ c,
                         int32_t* __restrict__ leaf_out,
                         float* __restrict__ dist_out, int B, int k, int d,
                         int lg, int xs) {
  constexpr int ROWS = 32 * RT;
  constexpr bool REG = NQ > 0;
  constexpr int TKW = REG ? WTK : WTKA;
  // [warp][leaf][column]: each warp's staged boxes
  __shared__ __align__(16) float s_lo[WW * WTK * WCOLS];
  __shared__ __align__(16) float s_hi[WW * WTK * WCOLS];
  __shared__ float s_wbest[WW * ROWS];   // each warp's partials
  __shared__ int s_wleaf[WW * ROWS];
  __shared__ float s_best[ROWS];         // the block's, for the cluster
  __shared__ int s_leaf[ROWS];
  extern __shared__ float s_rows[];      // [row][xs]: the tile's rows

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int row0 = (blockIdx.x / G) * ROWS;
  const int nrows = min(ROWS, B - row0);
  const bool vec = (d & 3) == 0 && (((uintptr_t)leaf_lo | (uintptr_t)leaf_hi
                                     | (uintptr_t)c) & 15) == 0;
  float* w_lo = s_lo + w * WTK * WCOLS;
  float* w_hi = s_hi + w * WTK * WCOLS;

  // 1. The block's leaf range and this warp's ascending sub-range.
  const int l0 = (int)min((long long)k, (long long)g * lg);
  const int l1 = (int)min((long long)k, (long long)l0 + lg);
  const int lw = (lg + WW - 1) / WW;
  const int w0 = (int)min((long long)l1, (long long)l0 + (long long)w * lw);
  const int w1 = (int)min((long long)l1, (long long)w0 + lw);
  float best[RT];
  int best_i[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    best[r] = CUDART_INF_F;
    best_i[r] = w0;
  }

  if constexpr (REG) {
    constexpr int DW = 4 * NQ;
    // 2. The lane's rows, once (rows past B repeat row B - 1, unwritten;
    // columns past d +0.0), and the warp's staged columns past d +0.0.
    float x[RT][DW];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float* src = c + (size_t)min(row0 + r * 32 + lane, B - 1) * d;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (vec) {
          const float4 v = *reinterpret_cast<const float4*>(src + 4 * q);
          x[r][4 * q] = v.x;
          x[r][4 * q + 1] = v.y;
          x[r][4 * q + 2] = v.z;
          x[r][4 * q + 3] = v.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            x[r][4 * q + u] = 4 * q + u < d ? src[4 * q + u] : 0.f;
        }
      }
    }
    for (int i = lane; i < WTK * (DW - d); i += 32) {
      const int l = i / (DW - d), j = d + i - l * (DW - d);
      w_lo[l * WCOLS + j] = 0.f;
      w_hi[l * WCOLS + j] = 0.f;
    }
    for (int base = w0; base < w1; base += TKW) {
      const int n = min(TKW, w1 - base);
      __syncwarp();  // the warp's previous tile is read
      stage_boxes(w_lo, w_hi, leaf_lo, leaf_hi, base, n, 0, d, d, vec, lane);
      for (int l = 0; l < n; ++l) {
        const float* bl = w_lo + l * WCOLS;
        const float* bh = w_hi + l * WCOLS;
        float dist[RT];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(bl + 4 * q);
          const float4 b = *reinterpret_cast<const float4*>(bh + 4 * q);
          const float la[4] = {a.x, a.y, a.z, a.w};
          const float ha[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 4 * q + u;
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const float t =
                  fmaxf(fmaxf(la[u] - x[r][j], x[r][j] - ha[u]), 0.f);
              dist[r] = j == 0 ? t : dist[r] + t;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (dist[r] < best[r]) {
            best[r] = dist[r];
            best_i[r] = base + l;
          }
        }
      }
    }
  } else {
    // 2. The tile's rows, once; rows past B as zeros.
    if (xs > 0) {
      for (int i = tid; i < ROWS * d; i += WNT) {
        const int r = i / d, j = i - r * d;
        s_rows[r * xs + j] = r < nrows ? c[(size_t)row0 * d + i] : 0.f;
      }
    }
    __syncthreads();
    const float* xr[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int rr = min(r * 32 + lane, max(nrows, 1) - 1);
      xr[r] = xs > 0 ? s_rows + (r * 32 + lane) * xs
                     : c + (size_t)(row0 + rr) * d;
    }
    for (int base = w0; base < w1; base += TKW) {
      const int n = min(TKW, w1 - base);
      float dist[RT][TKW];
      for (int j0 = 0; j0 < d; j0 += WCOLS) {
        const int nj = min(WCOLS, d - j0);
        __syncwarp();  // the warp's previous block is read
        stage_boxes(w_lo, w_hi, leaf_lo, leaf_hi, base, n, j0, nj, d, vec,
                    lane);
        for (int j = 0; j < nj; ++j) {
          float xj[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) xj[r] = xr[r][j0 + j];
#pragma unroll
          for (int l = 0; l < TKW; ++l) {
            if (l < n) {
              const float bl = w_lo[l * WCOLS + j], bh = w_hi[l * WCOLS + j];
#pragma unroll
              for (int r = 0; r < RT; ++r) {
                const float t = fmaxf(fmaxf(bl - xj[r], xj[r] - bh), 0.f);
                dist[r][l] = j0 + j == 0 ? t : dist[r][l] + t;
              }
            }
          }
        }
      }
#pragma unroll
      for (int l = 0; l < TKW; ++l) {
        if (l < n) {
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            if (dist[r][l] < best[r]) {
              best[r] = dist[r][l];
              best_i[r] = base + l;
            }
          }
        }
      }
    }
  }

  // 4. The warps' partials in warp order, then the cluster's blocks'.
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    s_wbest[w * ROWS + r * 32 + lane] = best[r];
    s_wleaf[w * ROWS + r * 32 + lane] = best_i[r];
  }
  __syncthreads();
  if (tid < ROWS) {
    float bd = CUDART_INF_F;
    int bl = 0;
#pragma unroll
    for (int h = 0; h < WW; ++h) {
      const float v = s_wbest[h * ROWS + tid];
      if (v < bd) {
        bd = v;
        bl = s_wleaf[h * ROWS + tid];
      }
    }
    s_best[tid] = bd;
    s_leaf[tid] = bl;
  }
  cluster.sync();
  for (int i = g + G * tid; i < ROWS; i += G * WNT) {
    float bd = CUDART_INF_F;
    int bl = 0;
    for (int h = 0; h < G; ++h) {
      const float v = cluster.map_shared_rank(s_best, h)[i];
      if (v < bd) {
        bd = v;
        bl = cluster.map_shared_rank(s_leaf, h)[i];
      }
    }
    if (i < nrows) {
      leaf_out[row0 + i] = bl;
      dist_out[row0 + i] = __fadd_rn(bd, 0.f);
    }
  }
  cluster.sync();  // the other blocks have read this block's partials
}

using Kernel = void (*)(const float*, const float*, const float*, int32_t*,
                       float*, int, int, int, int);

cudaError_t launch(Kernel kernel, const float* leaf_lo,
                   const float* leaf_hi, const float* c, int32_t* leaf,
                   float* dist, int B, int k, int d, int G, int lg,
                   int blocks, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, leaf_lo, leaf_hi, c, leaf, dist, B,
                            k, d, lg);
}

template <int RT>
cudaError_t launch_d(const float* leaf_lo, const float* leaf_hi,
                     const float* c, int32_t* leaf, float* dist, int B,
                     int k, int d, int G, int lg, int blocks,
                     cudaStream_t stream) {
  const Kernel kernel = d == 2 ? route_multid_kernel<2, RT>
                      : d == 3 ? route_multid_kernel<3, RT>
                               : route_multid_kernel<0, RT>;
  return launch(kernel, leaf_lo, leaf_hi, c, leaf, dist, B, k, d, G, lg,
                blocks, stream);
}

using WideKernel = void (*)(const float*, const float*, const float*,
                            int32_t*, float*, int, int, int, int, int);
constexpr int MAX_DEVICES = 64;

// d > MAX_D: the wide kernel over tiles of 32 * RT rows; above WCOLS
// columns its rows staged at stride d | 1 when they fit WIDE_ROW_SMEM
// bytes, else read from c.
template <int RT>
cudaError_t launch_wide(const float* leaf_lo, const float* leaf_hi,
                        const float* c, int32_t* leaf, float* dist, int B,
                        int k, int d, int G, int lg, int blocks,
                        cudaStream_t stream) {
  const bool reg = d <= WCOLS;
  const long long bytes = 4LL * 32 * RT * (d | 1);
  const int xs = !reg && bytes <= WIDE_ROW_SMEM ? (d | 1) : 0;
  const int nq = (d + 3) / 4;  // 5 .. 8 up to WCOLS columns
  const WideKernel kernel = !reg ? route_multid_wide_kernel<RT, 0>
                          : nq == 5 ? route_multid_wide_kernel<RT, 5>
                          : nq == 6 ? route_multid_wide_kernel<RT, 6>
                          : nq == 7 ? route_multid_wide_kernel<RT, 7>
                                    : route_multid_wide_kernel<RT, 8>;
  if (!reg) {
    // Once a device: the opt-in past 48 KB of dynamic shared memory.
    static bool opted[MAX_DEVICES][2];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!opted[dev][RT - 1]) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 WIDE_ROW_SMEM);
      if (err != cudaSuccess) return err;
      opted[dev][RT - 1] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(WNT);
  cfg.dynamicSmemBytes = xs > 0 ? (size_t)bytes : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, leaf_lo, leaf_hi, c, leaf, dist, B,
                            k, d, lg, xs);
}

}  // namespace

// rt, G and lg are route_launch_plan's (route.py): rows a thread (1, 2 or
// 4; up to MAX_D columns, route_plan's) or rows a lane (1 or 2; above it,
// route_wide_plan's), blocks a cluster (1, 2, 4 or 8) and leaves a group
// (G * lg >= k).
extern "C" int repro_route_multid(const float* leaf_lo, const float* leaf_hi,
                                  const float* c, int32_t* leaf, float* dist,
                                  int B, int k, int d, int rt, int G, int lg,
                                  void* stream) {
  const bool wide = d > MAX_D;
  if (B < 1 || k < 1 || d < 1 || lg < 1 ||
      (rt != 1 && rt != 2 && (rt != 4 || wide)) ||
      (G != 1 && G != 2 && G != 4 && G != MAX_G) || (long long)G * lg < k)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)rt * (wide ? 32 : NT);
  const long long tiles = (B + rows - 1) / rows;
  if (tiles * G > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (int)(tiles * G);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (wide)
    err = rt == 2 ? launch_wide<2>(leaf_lo, leaf_hi, c, leaf, dist, B, k, d,
                                   G, lg, blocks, st)
                  : launch_wide<1>(leaf_lo, leaf_hi, c, leaf, dist, B, k, d,
                                   G, lg, blocks, st);
  else if (rt == 4)
    err = launch_d<4>(leaf_lo, leaf_hi, c, leaf, dist, B, k, d, G, lg,
                      blocks, st);
  else if (rt == 2)
    err = launch_d<2>(leaf_lo, leaf_hi, c, leaf, dist, B, k, d, G, lg,
                      blocks, st);
  else
    err = launch_d<1>(leaf_lo, leaf_hi, c, leaf, dist, B, k, d, G, lg,
                      blocks, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// NT, MAX_G and the wide kernel's warps a block, for the wrapper's plans
// to be checked against.
extern "C" int repro_route_threads() { return NT; }
extern "C" int repro_route_max_groups() { return MAX_G; }
extern "C" int repro_route_wide_warps() { return WW; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
