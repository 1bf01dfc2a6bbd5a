// pair_tiles.cuh: the launch that stratified_moments.cu and
// sample_extremes.cu share. Both compute, for every (query, stratum) pair,
// one reduction of the stratum's samples that fall inside the query box,
// from the synopsis's leaf-major layout: sample_c (k, s, d), sample_a
// (k, s), sample_valid (k, s) bool, q_lo / q_hi (Q, d). A slot is relevant
// iff valid and lo_j <= c_j <= hi_j for every column j (inclusive bounds).
// They differ only in the reduction and the output, which a policy class
// `Acc` supplies (below).
//
// Design: a (query, stratum) pair is empty (no valid slot inside the box),
// covered (every valid slot inside) or mixed. A covered pair's result is
// the stratum's own reduction over its slots, the same for every query; an
// empty pair's is the reduction of no relevant slot; only mixed pairs walk
// their slots. One launch of NT = 256 threads a block; a block owns a tile
// of LT = 16 leaves and a group of the QT = 128-query tiles (query tiles
// group, group + groups, ...; groups is the most that keeps every block
// resident at once, by the occupancy calculator, so the grid runs in one
// wave):
//
//  1. It stages its leaves' slots in shared memory (one 16-byte cp.async
//     run per array when they fit in STAGE_BYTES and the arrays are
//     aligned, else chunks of loads with BATCH in flight per thread).
//  2. Thread l reduces leaf l's slots in slot order; the other threads
//     take a (leaf, column) pair each for the box around the leaf's valid
//     samples (fminf / fmaxf) and flag a leaf with a NaN coordinate on a
//     valid slot: fminf / fmaxf skip NaN, the slot test rejects it, so
//     such a leaf is never covered. Once per block, so `groups` times per
//     leaf tile, from L2.
//  3. For each of its query tiles (the next tile's queries arrive by
//     cp.async while one is served) every pair is classified from the box
//     with the slot test's own compares: covered iff the query box holds
//     the leaf's box, empty iff they are apart in some column. Exact for
//     the non-NaN samples. The tile in shared memory takes the leaf's
//     result or the empty one, and the other pairs go to a list.
//  4. The tile goes out as rows of LT * WIDTH contiguous floats a plane:
//     16-byte stores when k is a multiple of 4 and `out` is aligned,
//     4-byte ones otherwise.
//  5. The listed pairs are walked one thread each, all of the block's at
//     once (the list is flushed only when a tile's pairs might not fit):
//     the slots from shared memory when they are one staged chunk, else
//     from global memory (L2), eight slots' loads in flight, every slot
//     through the same update, and the result overwrites the tile's empty
//     one in `out`. A walk per tile would hold the block for the loop's
//     latency once per tile; deferred, the block's walks overlap each
//     other and the tiles' stores.
//
// With no replicates to spread them over, the fixed costs decide the time,
// so the per-leaf reductions and boxes are computed in the blocks rather
// than in a launch of their own, and the few walks run in the same blocks.
//
// The policy `Acc` (one object is one running reduction):
//   STATS   floats a leaf's reduction keeps in shared memory;
//   PLANES  output planes (1 or 2), Q * k * WIDTH floats each;
//   WIDTH   floats a pair takes in a plane;
//   init()              the reduction of no slot;
//   add(a, in)          one slot, `in` iff relevant; a result depends only
//                       on the slots' order, which every path keeps;
//   save(t) / load(t)   to and from the leaf's STATS floats;
//   fill(tile, q, l, inside)  the tile's entries of a covered (`inside`:
//                       this reduction) or an empty pair, at tile_at();
//   write(out, pair, plane)   a walked pair's result, pair = q * k + leaf,
//                       plane = Q * k * WIDTH.
//
// Shared memory (dynamic): the tile PLANES * WIDTH * QT * LT * 4 bytes,
// the staged chunk LT * sc * (4d + 5) bytes <= STAGE_BYTES, two query
// buffers QT * 16d, boxes, the leaves' reductions, flags and the walk list
// of LIST_CAP entries.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int QT = 128;            // queries per tile
constexpr int LT = 16;             // leaves per tile
constexpr int MAX_D = 16;          // predicate columns
constexpr int STAGE_BYTES = 24576; // staged slot chunk, at most
constexpr int BATCH = 8;           // loads in flight per thread (staging)
constexpr int LIST_CAP = 2 * QT * LT;  // pairs listed for walks, at most
constexpr int MAX_DEVICES = 64;
constexpr int VARIANTS = 8;

// The tile's entry of plane m, query q, leaf l: [plane][q][leaf][WIDTH].
template <class Acc>
__device__ __forceinline__ float* tile_at(float* s_tile, int m, int q,
                                          int l) {
  return s_tile + ((m * QT + q) * LT + l) * Acc::WIDTH;
}

// dst[l * dst_stride + i] = src[l * src_stride + i] for l < nl, i < row;
// BATCH independent loads in flight per thread.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int nl, int row, size_t src_stride,
                                      int dst_stride) {
  const int total = nl * row;
  for (int base = threadIdx.x; base < total; base += NT * BATCH) {
    T r[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        const int l = i / row;
        r[u] = src[(size_t)l * src_stride + (i - l * row)];
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        const int l = i / row;
        dst[l * dst_stride + (i - l * row)] = r[u];
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Copy nbytes from src (global) to dst (shared), both 16-byte aligned:
// 16-byte cp.async for the body, byte loads for the tail. The caller
// commits, waits and syncs.
__device__ __forceinline__ void copy_run(void* dst, const void* src,
                                         int nbytes) {
  const int n16 = nbytes >> 4;
  for (int i = threadIdx.x; i < n16; i += NT)
    cp_async16((char*)dst + 16 * i, (const char*)src + 16 * i);
  for (int i = (n16 << 4) + threadIdx.x; i < nbytes; i += NT)
    ((uint8_t*)dst)[i] = ((const uint8_t*)src)[i];
}

// The tile's rows out of shared memory, every plane: nq rows of nur store
// units of VW floats (NUR > 0 fixes nur at compile time), row_pitch
// floats apart, each plane `plane` floats after the one before.
template <class Acc, int VW, int NUR>
__device__ __forceinline__ void store_tile(const float* s_tile, float* ob,
                                           int nq, int nur_rt,
                                           size_t row_pitch, size_t plane) {
  static_assert(Acc::PLANES == 1 || Acc::PLANES == 2, "one or two planes");
  const int nur = NUR > 0 ? NUR : nur_rt;
  for (int u = threadIdx.x; u < Acc::PLANES * nq * nur; u += NT) {
    const int m = Acc::PLANES == 1 ? 0 : u >= nq * nur;
    const int r = u - m * nq * nur;
    const int q = r / nur, col = (r - q * nur) * VW;
    const float* src = s_tile + (m * QT + q) * LT * Acc::WIDTH + col;
    float* dst = ob + m * plane + q * row_pitch + col;
    if (VW == 4)
      *reinterpret_cast<float4*>(dst) =
          *reinterpret_cast<const float4*>(src);
    else
      *dst = *src;
  }
}

// One launch's grid and shared-memory carve-up (bytes).
struct Plan {
  int sc;    // slots per staged chunk
  int runs;  // one chunk and 16-byte aligned inputs: each staged array is
             // one contiguous run, copied with 16-byte cp.async
  int n_qt;  // query tiles
  int groups;  // query groups: the blocks of one leaf tile
  int n_blocks;
  int off_c, off_a, off_v, off_q, off_box, off_stat, off_nan, off_list,
      off_count, bytes;
};

int align16(long long x) { return (int)((x + 15) & ~15LL); }

template <class Acc>
bool make_plan(int Q, int k, int s, int d, bool aligned, Plan* plan) {
  Plan p;
  const long long per_slot = (long long)LT * (4 * d + 5);
  p.sc = (long long)s * per_slot <= STAGE_BYTES
             ? (s > 0 ? s : 1)
             : (int)(STAGE_BYTES / per_slot);
  p.runs = aligned && s > 0 && p.sc == s;
  long long off = 0;
  off = align16(off + 4LL * Acc::PLANES * Acc::WIDTH * QT * LT);
  p.off_c = (int)off;     off = align16(off + 4LL * LT * p.sc * d);
  p.off_a = (int)off;     off = align16(off + 4LL * LT * p.sc);
  p.off_v = (int)off;     off = align16(off + (long long)LT * p.sc);
  p.off_q = (int)off;     off = align16(off + 2 * 8LL * QT * d);
  p.off_box = (int)off;   off = align16(off + 8LL * LT * d);
  p.off_stat = (int)off;  off = align16(off + 4LL * Acc::STATS * LT);
  p.off_nan = (int)off;   off = align16(off + 4LL * LT);
  p.off_list = (int)off;  off = align16(off + 2LL * LIST_CAP);
  p.off_count = (int)off; off = align16(off + 4);
  p.bytes = (int)off;
  const long long n_qt = (Q + QT - 1) / QT, n_lt = (k + LT - 1) / LT;
  if (n_qt * n_lt > 0x7fffffffLL) return false;
  p.n_qt = (int)n_qt;
  p.groups = 1;
  p.n_blocks = (int)n_lt;
  *plan = p;
  return true;
}

// The query groups: as many as keep every block resident at once
// (`resident` blocks on the card) so that the grid runs in one wave, at
// least one and at most one per query tile; each leaf tile's reductions
// are computed once per group.
void set_groups(int k, long long resident, Plan* p) {
  const long long n_lt = (k + LT - 1) / LT;
  long long groups = resident / n_lt;
  groups = groups < 1 ? 1 : groups > p->n_qt ? p->n_qt : groups;
  p->groups = (int)groups;
  p->n_blocks = (int)(n_lt * groups);  // <= n_lt * n_qt < 2**31
}

// One block per (leaf tile of LT leaves, query group): the leaves'
// reductions and boxes once, then every QT-query tile qt = group,
// group + groups, ... of the group. VW floats per store (4 when k is a
// multiple of 4, else 1); D > 0 fixes d at compile time.
template <class Acc, int VW, int D>
__global__ void __launch_bounds__(NT)
pair_tile_kernel(const float* __restrict__ c, const float* __restrict__ a,
                 const uint8_t* __restrict__ valid,
                 const float* __restrict__ q_lo,
                 const float* __restrict__ q_hi, float* __restrict__ out,
                 int Q, int k, int s, int d, Plan p) {
  if (D > 0) d = D;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tile = (float*)smem;                    // tile_at()
  float* s_c = (float*)(smem + p.off_c);           // [leaf][slot][d]
  float* s_a = (float*)(smem + p.off_a);           // [leaf][slot]
  uint8_t* s_v = smem + p.off_v;                   // [leaf][slot]
  float* s_q = (float*)(smem + p.off_q);  // [buffer][lo, hi][q][d]
  float* s_box = (float*)(smem + p.off_box);       // [leaf][lo, hi][d]
  float* s_stat = (float*)(smem + p.off_stat);     // [leaf][STATS]
  int* s_nan = (int*)(smem + p.off_nan);           // [leaf]
  uint16_t* s_list = (uint16_t*)(smem + p.off_list);  // pairs to walk
  int* s_count = (int*)(smem + p.off_count);

  const int tid = threadIdx.x;
  const int group = blockIdx.x % p.groups;
  const int leaf0 = (blockIdx.x / p.groups) * LT;
  const int nl = min(LT, k - leaf0);
  const int sc = p.sc;
  const size_t plane = (size_t)Q * k * Acc::WIDTH;

  // The queries of tile qt into buffer buf: cp.async when the arrays are
  // runs (the caller commits and waits), else loads.
  auto load_queries = [&](int qt, int buf) {
    const int q0 = qt * QT, n = min(QT, Q - q0) * d;
    float* dst = s_q + buf * 2 * QT * d;
    if (p.runs) {
      copy_run(dst, q_lo + (size_t)q0 * d, n * 4);
      copy_run(dst + QT * d, q_hi + (size_t)q0 * d, n * 4);
    } else {
      stage(dst, q_lo + (size_t)q0 * d, 1, n, 0, 0);
      stage(dst + QT * d, q_hi + (size_t)q0 * d, 1, n, 0, 0);
    }
  };
  if (tid < LT) s_nan[tid] = 0;
  if (tid == 0) *s_count = 0;

  // 1-2. Reductions (thread l < nl: leaf l) and boxes (thread (tid + 32) %
  // NT: pair (leaf, column) = divmod(that, d)) over the chunks in slot
  // order.
  Acc acc;
  acc.init();
  const int bp = (tid + 32) % NT;
  const bool box_owner = bp < nl * d;
  const int bl = box_owner ? bp / d : 0, bj = box_owner ? bp - bl * d : 0;
  const float inf = __int_as_float(0x7f800000);
  float lo = inf, hi = -inf;
  bool nan = false;
  auto reduce_and_box = [&](int n) {
    if (tid < nl) {
      const uint8_t* v = s_v + tid * sc;
      const float* av = s_a + tid * sc;
#pragma unroll 8
      for (int i = 0; i < n; ++i) acc.add(av[i], v[i] != 0);
    }
    if (box_owner) {
      const uint8_t* v = s_v + bl * sc;
      const float* cl = s_c + bl * sc * d + bj;
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const bool on = v[i] != 0;
        const float x = cl[i * d];
        nan |= on & (x != x);
        lo = fminf(lo, on ? x : inf);
        hi = fmaxf(hi, on ? x : -inf);
      }
    }
  };
  const int n_ch = (s + sc - 1) / sc;
  auto stage_chunk = [&](int s0, int n) {
    stage(s_c, c + ((size_t)leaf0 * s + s0) * d, nl, n * d, (size_t)s * d,
          sc * d);
    stage(s_a, a + (size_t)leaf0 * s + s0, nl, n, (size_t)s, sc);
    stage(s_v, valid + (size_t)leaf0 * s + s0, nl, n, (size_t)s, sc);
  };
  if (p.runs) {
    copy_run(s_c, c + (size_t)leaf0 * s * d, nl * s * d * 4);
    copy_run(s_a, a + (size_t)leaf0 * s, nl * s * 4);
    copy_run(s_v, valid + (size_t)leaf0 * s, nl * s);
    load_queries(group, 0);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    reduce_and_box(s);
  } else {
    for (int ch = 0; ch < n_ch; ++ch) {
      const int s0 = ch * sc, n = min(sc, s - s0);
      __syncthreads();  // the previous chunk is no longer read
      stage_chunk(s0, n);
      __syncthreads();
      reduce_and_box(n);
    }
  }
  if (tid < nl) acc.save(s_stat + tid * Acc::STATS);
  if (box_owner) {
    s_box[bl * 2 * d + bj] = lo;
    s_box[bl * 2 * d + d + bj] = hi;
    if (nan) s_nan[bl] = 1;
  }

  // 5. The walks of the listed pairs, one thread each, all at once: in
  // slot order from init() over the leaf's slots, staged in shared memory
  // when they are one chunk, else read from global memory (L2), written
  // straight to `out` over the empty result the tile store left there. An
  // entry is (tile since it_base << 11 | query in the tile << 4 | leaf).
  int it_base = 0;
  const bool staged = n_ch == 1;
  auto walk_all = [&](int n_walk) {
    for (int e = tid; e < n_walk; e += NT) {
      const int ent = s_list[e];
      const int l = ent & (LT - 1);
      const int qt = (it_base + (ent >> 11)) * p.groups + group;
      const int q = qt * QT + ((ent >> 4) & (QT - 1));
      float ql[MAX_D], qh[MAX_D];
#pragma unroll
      for (int j = 0; j < MAX_D; ++j) {
        ql[j] = j < d ? q_lo[(size_t)q * d + j] : 0.f;
        qh[j] = j < d ? q_hi[(size_t)q * d + j] : 0.f;
      }
      const size_t o = (size_t)(leaf0 + l) * s;
      const uint8_t* v = staged ? s_v + l * sc : valid + o;
      const float* av = staged ? s_a + l * sc : a + o;
      const float* cl = staged ? s_c + l * sc * d : c + o * d;
      Acc w;
      w.init();
#pragma unroll 8
      for (int i = 0; i < s; ++i) {
        bool in = v[i] != 0;
#pragma unroll
        for (int j = 0; j < MAX_D; ++j) {
          if (j < d) {
            const float x = cl[i * d + j];
            in &= (ql[j] <= x) & (x <= qh[j]);
          }
        }
        w.add(av[i], in);
      }
      w.write(out, (size_t)q * k + leaf0 + l, plane);
    }
  };

  for (int it = 0, qt = group; qt < p.n_qt; ++it, qt += p.groups) {
    const int q0 = qt * QT, nq = min(QT, Q - q0);
    const int buf = it & 1;
    const float* sq_lo = s_q + buf * 2 * QT * d;
    const float* sq_hi = sq_lo + QT * d;
    if (p.runs) {
      // The next tile's queries arrive while this one is served.
      if (qt + p.groups < p.n_qt) load_queries(qt + p.groups, buf ^ 1);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      load_queries(qt, buf);
    }
    __syncthreads();

    // 3. Classes: covered pairs take the leaf's reduction, the rest the
    // empty one, and the ones not apart from the box go to the walk list.
    // Thread tid takes leaf tid % LT for queries tid / LT, + NT / LT, ...
    {
      const int l = tid % LT;
      if (l < nl) {
        float blo[MAX_D], bhi[MAX_D];
#pragma unroll
        for (int j = 0; j < MAX_D; ++j) {
          blo[j] = j < d ? s_box[l * 2 * d + j] : 0.f;
          bhi[j] = j < d ? s_box[l * 2 * d + d + j] : 0.f;
        }
        const bool no_nan = s_nan[l] == 0;
        Acc leaf;
        leaf.load(s_stat + l * Acc::STATS);
        for (int q = tid / LT; q < nq; q += NT / LT) {
          bool inside = no_nan, apart = false;
#pragma unroll
          for (int j = 0; j < MAX_D; ++j) {
            if (j < d) {
              const float ql = sq_lo[q * d + j], qh = sq_hi[q * d + j];
              inside &= (ql <= blo[j]) & (bhi[j] <= qh);
              apart |= (qh < blo[j]) | (bhi[j] < ql);
            }
          }
          leaf.fill(s_tile, q, l, inside);
          if (!inside && !apart)
            s_list[atomicAdd(s_count, 1)] =
                (uint16_t)((it - it_base) << 11 | q << 4 | l);
        }
      }
    }
    __syncthreads();

    // 4. The tile goes out as rows of nl * WIDTH contiguous floats a plane.
    constexpr int W = Acc::WIDTH;
    float* ob = out + ((size_t)q0 * k + leaf0) * W;
    if (nl == LT)
      store_tile<Acc, VW, LT * W / VW>(s_tile, ob, nq, 0, (size_t)k * W,
                                       plane);
    else
      store_tile<Acc, VW, 0>(s_tile, ob, nq, nl * W / VW, (size_t)k * W,
                             plane);
    __syncthreads();  // the tile is free again; its stores precede walks

    // The list is walked when the next tile's pairs might not fit, when
    // its tile field would overflow, and after the last tile.
    const int n_walk = *s_count;
    if (n_walk > LIST_CAP - QT * LT || it + 1 - it_base == 32 ||
        qt + p.groups >= p.n_qt) {
      walk_all(n_walk);
      __syncthreads();
      if (tid == 0) *s_count = 0;
      it_base = it + 1;
    }
  }
}

// Launch the kernel for policy Acc on `stream` (the caller has checked
// the arguments). Returns a cudaError_t.
template <class Acc>
int launch_pair_tiles(const float* c, const float* a, const uint8_t* valid,
                      const float* q_lo, const float* q_hi, float* out,
                      int Q, int k, int s, int d, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static int sms[MAX_DEVICES];
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  // Leaf and query tiles start at multiples of 16 elements, so the staged
  // runs are 16-byte aligned when the arrays are.
  const bool aligned =
      (((uintptr_t)c | (uintptr_t)a | (uintptr_t)valid | (uintptr_t)q_lo |
        (uintptr_t)q_hi) & 15) == 0;
  Plan p;
  if (!make_plan<Acc>(Q, k, s, d, aligned, &p))
    return (int)cudaErrorInvalidConfiguration;
  // 16-byte stores need every row start 16-byte aligned: k a multiple of
  // 4 and an aligned buffer.
  const bool vec = k % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const int variant = (vec ? 4 : 0) + (d <= 3 ? d : 0);
  using Kernel = void (*)(const float*, const float*, const uint8_t*,
                          const float*, const float*, float*, int, int, int,
                          int, Plan);
  Kernel kernel;
  switch (variant) {
    case 1: kernel = pair_tile_kernel<Acc, 1, 1>; break;
    case 2: kernel = pair_tile_kernel<Acc, 1, 2>; break;
    case 3: kernel = pair_tile_kernel<Acc, 1, 3>; break;
    case 4: kernel = pair_tile_kernel<Acc, 4, 0>; break;
    case 5: kernel = pair_tile_kernel<Acc, 4, 1>; break;
    case 6: kernel = pair_tile_kernel<Acc, 4, 2>; break;
    case 7: kernel = pair_tile_kernel<Acc, 4, 3>; break;
    default: kernel = pair_tile_kernel<Acc, 1, 0>; break;
  }
  // Once per device and variant: prefer the largest shared-memory
  // carveout, so that shared memory limits the blocks a multiprocessor
  // holds as little as it can; above 48 KB of dynamic shared memory opt
  // in, for the largest size asked so far.
  static int granted[MAX_DEVICES][VARIANTS];
  if (granted[dev][variant] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    granted[dev][variant] = 48 * 1024;
  }
  if (p.bytes > granted[dev][variant]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
    if (err != cudaSuccess) return (int)err;
    granted[dev][variant] = p.bytes;
  }
  // Blocks a multiprocessor holds at these shared-memory bytes (registers
  // decide at the serving shapes), cached per device and variant.
  static int occ_bytes[MAX_DEVICES][VARIANTS], occ[MAX_DEVICES][VARIANTS];
  if (occ_bytes[dev][variant] != p.bytes) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        p.bytes);
    if (err != cudaSuccess) return (int)err;
    occ[dev][variant] = per_sm > 0 ? per_sm : 1;
    occ_bytes[dev][variant] = p.bytes;
  }
  set_groups(k, (long long)occ[dev][variant] * sms[dev], &p);
  kernel<<<p.n_blocks, NT, p.bytes, (cudaStream_t)stream>>>(
      c, a, valid, q_lo, q_hi, out, Q, k, s, d, p);
  return (int)cudaGetLastError();
}

}  // namespace
