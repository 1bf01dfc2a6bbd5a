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
// instantiation (route_multid_wide_kernel) keeps registers and shared
// memory fixed: its range goes in leaf tiles of TKW = 8, and for each
// tile the columns in blocks of 16, the rows' coordinates of the block in
// registers and the tile's box columns read from L1 (the same address in
// every lane: a broadcast), each (row, leaf) distance a register carried
// across the blocks. So each distance is still one running fp32 sum in
// column order from column 0's term, the oracle's sum: per-block partial
// sums would round otherwise and move ties and leaf ids. The scan, the
// strict `<` and the cluster merge are the d <= 16 kernel's.
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
constexpr int TKW = 8;      // leaves a tile of the wide kernel
constexpr int WIDE_COLS = MAX_D;  // columns a block of the wide kernel

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

// d > MAX_D (design above, "Any d"): route_multid_kernel's scan and
// merge, the distances of TKW leaves at a time summed over the column
// blocks in column order.
template <int RT>
__global__ void __launch_bounds__(NT)
route_multid_wide_kernel(const float* __restrict__ leaf_lo,
                         const float* __restrict__ leaf_hi,
                         const float* __restrict__ c,
                         int32_t* __restrict__ leaf_out,
                         float* __restrict__ dist_out, int B, int k, int d,
                         int lg) {
  __shared__ float s_best[RT * NT];   // the block's partials, row-indexed
  __shared__ int s_leaf[RT * NT];

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / G) * (RT * NT);

  const int l0 = (int)min((long long)k, (long long)g * lg);
  const int l1 = (int)min((long long)k, (long long)l0 + lg);
  float best[RT];
  int best_i[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    best[r] = CUDART_INF_F;
    best_i[r] = l0;
  }
  for (int k0 = l0; k0 < l1; k0 += TKW) {
    const int n = min(TKW, l1 - k0);
    float dist[RT][TKW];
    for (int j0 = 0; j0 < d; j0 += WIDE_COLS) {
      const int nj = min(WIDE_COLS, d - j0);
      float x[RT][WIDE_COLS];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int row = row0 + r * NT + tid;
#pragma unroll
        for (int j = 0; j < WIDE_COLS; ++j)
          x[r][j] = (row < B && j < nj) ? c[(size_t)row * d + j0 + j] : 0.f;
      }
#pragma unroll
      for (int l = 0; l < TKW; ++l) {
        if (l < n) {
          const float* lo = leaf_lo + (size_t)(k0 + l) * d + j0;
          const float* hi = leaf_hi + (size_t)(k0 + l) * d + j0;
#pragma unroll
          for (int j = 0; j < WIDE_COLS; ++j) {
            if (j < nj) {
              const float bl = lo[j], bh = hi[j];
#pragma unroll
              for (int r = 0; r < RT; ++r) {
                const float t = fmaxf(fmaxf(bl - x[r][j], x[r][j] - bh), 0.f);
                dist[r][l] = j0 + j == 0 ? t : dist[r][l] + t;
              }
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
            best_i[r] = k0 + l;
          }
        }
      }
    }
  }
  merge_partials<RT>(cluster, G, g, tid, best, best_i, s_best, s_leaf, row0,
                     B, leaf_out, dist_out);
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
                      : d > MAX_D ? route_multid_wide_kernel<RT>
                                  : route_multid_kernel<0, RT>;
  return launch(kernel, leaf_lo, leaf_hi, c, leaf, dist, B, k, d, G, lg,
                blocks, stream);
}

}  // namespace

// rt, G and lg are route_plan's (route.py): rows a thread (1, 2 or 4),
// blocks a cluster (1, 2, 4 or 8) and leaves a group (G * lg >= k).
extern "C" int repro_route_multid(const float* leaf_lo, const float* leaf_hi,
                                  const float* c, int32_t* leaf, float* dist,
                                  int B, int k, int d, int rt, int G, int lg,
                                  void* stream) {
  if (B < 1 || k < 1 || d < 1 || lg < 1 ||
      (rt != 1 && rt != 2 && rt != 4) ||
      (G != 1 && G != 2 && G != 4 && G != MAX_G) || (long long)G * lg < k)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (B + (long long)rt * NT - 1) / ((long long)rt * NT);
  if (tiles * G > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (int)(tiles * G);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (rt == 4)
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

// NT and MAX_G, for the wrapper's plan to be checked against.
extern "C" int repro_route_threads() { return NT; }
extern "C" int repro_route_max_groups() { return MAX_G; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
