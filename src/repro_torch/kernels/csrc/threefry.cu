// threefry: the counter-based Threefry-2x32 draws of repro_torch.random
// (row 10 of PERF.md's kernel table), bit-equal to jax.random under its
// defaults (jax_threefry_partitionable=True, 64-bit mode off).
//
// The JAX package has no Pallas kernel for it: its draws are jax.random's
// threefry2x32 (jax/_src/prng.py, _threefry2x32_lowering), reached from
//   src/repro/uncertainty/bootstrap.py:67-74  _draw_weights (fold_in,
//       uniform, the Poisson(1) inverse CDF);
//   src/repro/streaming/ingest.py:302,386     split, uniform;
//   src/repro/sharded/ingest.py:113,150,253   uniform, uniform, split;
//   src/repro/streaming/join_ingest.py:149,253 uniform, split;
//   src/repro/joins/universe.py:37            fold_in, uniform(key, ()).
// The port's plain version is the int64 torch code of
// src/repro_torch/random.py (every uint32 word in an int64, masked with
// & 0xFFFFFFFF after each add and shift), ~140 elementwise launches a draw.
//
// Entries, one launch each:
//  * repro_threefry_fold_in(key, data, kind, scalar, n, out): out (n, 2)
//    int64 = the hash of the counter pairs (0, c_i) under one key, where
//    c_i is, by kind, 0: scalar + i (jax.random.split at scalar 0,
//    jax.random.fold_in of one datum at n = 1), 1: int32 data[i], 2: int64
//    data[i] mod 2^32 (jax.random.fold_in of a batch; a negative value
//    hashes as its two's complement);
//  * repro_threefry_uniform(keys, nkeys, n, out): out (nkeys, n) float32 =
//    jax.random.uniform(keys[b], (n,)) for each key b: 23 random mantissa
//    bits of b1 ^ b2 under the exponent of 1.0, minus 1.0 (n = 1 is
//    uniform(key, ()): the one counter pair (0, 0));
//  * repro_poisson_weights(key, cdf, valid, R, r0, k, s, W, kstar): the
//    bootstrap's resample weights. Replicate r's key is fold_in(key,
//    r0 + r), computed once a block; slot (i, j) draws the uniform of
//    counter i * s + j under it and counts w = #{t : u >= cdf[t]} over the
//    16-entry float32 Poisson(1) CDF table the caller passes
//    (uncertainty/bootstrap.py _P1_CDF; 16 compares, unrolled); W (R, k, s)
//    float32 = w where valid[i][j], +0.0 elsewhere (no hash is drawn for an
//    invalid slot); kstar (R, k) float32 = sum_j W, summed as an integer
//    and converted once: the plain version's float sum of small integers
//    is exact in any order below 2^24, which the wrapper checks (16 s <
//    2^24).
//
// Bits: uint32 arithmetic throughout (the wrap-around is the plain
// version's & MASK32), rotations by __funnelshift_l(x, x, r), key
// injection x0 += ks[(i+1)%3], x1 += ks[(i+2)%3] + (i+1) after each group
// of four rounds, and the uniform's last step 1.0f-exponent word minus
// 1.0f by __fsub_rn (exact; nothing can contract it). Counters run from 0
// to n - 1 for each key, n < 2^32 (the wrapper checks, as the plain
// version does); outputs are indexed in 64 bits.
//
// What bounds it on an H100: integer operations. The least work a draw
// needs (threefry.py KEY_OPS, HASH_OPS, UNIFORM_OPS, COUNT_OPS): a key's
// k2 and five injection constants once a key (7), a counter's hash under
// it 71 (its add into x1, 20 rounds of add, funnel shift and xor, 5
// injections of two adds; c0 = 0 makes x0's first add free), the uniform
// 4, a Poisson count by binary search over the monotone table 10 (5
// compares and 5 adds for its 17 outcomes) and the K* sum 1: 86 a valid
// slot of the fused draw, against 4 bytes written. At the fused answer's
// shape (R = 200, k = 1024, s = 75) that is about 1.32 G operations,
// 0.079 ms at 64 INT32 lanes an SM x 132 SMs x 1.98 GHz = 16.7 T/s,
// against 0.019 ms for its 62 MB of bytes. This kernel counts linearly
// (16 compares and 16 adds), 22 operations a slot above that least.
//
// Design, first version: one thread a counter for fold_in (split too)
// and uniform (the key words read through the pointer, so no host sync); for
// the fused draw, rows (r, i) of TPR threads (TPR a power of two from 32
// to 256, doubled from 32 while the grid fills less than one wave of the
// card and TPR < s), each thread walking its row's slots j = lane, lane +
// TPR, ... with the replicate's key in shared memory, the row's count
// reduced by __reduce_add_sync and, above one warp, in shared memory.
// A block holds 256 / TPR rows of one replicate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CDF_LEN = 16;
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// One round: add, rotate by r, xor.
#define REPRO_ROUND(x0, x1, r) \
  x0 += x1;                    \
  x1 = rotl(x1, r) ^ x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  REPRO_ROUND(x0, x1, 13) REPRO_ROUND(x0, x1, 15)
  REPRO_ROUND(x0, x1, 26) REPRO_ROUND(x0, x1, 6)
  x0 += k1; x1 += k2 + 1u;
  REPRO_ROUND(x0, x1, 17) REPRO_ROUND(x0, x1, 29)
  REPRO_ROUND(x0, x1, 16) REPRO_ROUND(x0, x1, 24)
  x0 += k2; x1 += k0 + 2u;
  REPRO_ROUND(x0, x1, 13) REPRO_ROUND(x0, x1, 15)
  REPRO_ROUND(x0, x1, 26) REPRO_ROUND(x0, x1, 6)
  x0 += k0; x1 += k1 + 3u;
  REPRO_ROUND(x0, x1, 17) REPRO_ROUND(x0, x1, 29)
  REPRO_ROUND(x0, x1, 16) REPRO_ROUND(x0, x1, 24)
  x0 += k1; x1 += k2 + 4u;
  REPRO_ROUND(x0, x1, 13) REPRO_ROUND(x0, x1, 15)
  REPRO_ROUND(x0, x1, 26) REPRO_ROUND(x0, x1, 6)
  x0 += k2; x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

#undef REPRO_ROUND

// The uniform in [0, 1) of one hash: ((b1 ^ b2) >> 9) | 0x3F800000 read
// as a float in [1, 2), minus 1.0f (exact).
__device__ __forceinline__ float to_uniform(uint32_t b1, uint32_t b2) {
  return __fsub_rn(__uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u), 1.0f);
}

// A key word: the low 32 bits of its int64.
__device__ __forceinline__ uint32_t word(const int64_t* p, int64_t i) {
  return (uint32_t)(uint64_t)p[i];
}

__global__ void fold_in_kernel(const int64_t* __restrict__ key,
                               const void* __restrict__ data, int kind,
                               uint32_t scalar, int64_t n,
                               longlong2* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  uint32_t c = scalar + (uint32_t)t;
  if (kind == 1)
    c = (uint32_t)static_cast<const int32_t*>(data)[t];
  else if (kind == 2)
    c = (uint32_t)(uint64_t)static_cast<const int64_t*>(data)[t];
  uint32_t b1, b2;
  threefry2x32(word(key, 0), word(key, 1), 0u, c, b1, b2);
  out[t] = make_longlong2((long long)b1, (long long)b2);
}

// total = nkeys * n threads; thread t draws counter t % n of key t / n.
__global__ void uniform_kernel(const int64_t* __restrict__ keys,
                               int64_t nkeys, int64_t n,
                               float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= nkeys * n) return;
  int64_t b = 0, i = t;
  if (n == 1) {
    b = t;
    i = 0;
  } else if (nkeys > 1) {
    b = t / n;
    i = t - b * n;
  }
  uint32_t b1, b2;
  threefry2x32(word(keys, 2 * b), word(keys, 2 * b + 1), 0u, (uint32_t)i,
               b1, b2);
  out[t] = to_uniform(b1, b2);
}

// Block: rows_per_block = THREADS / tpr rows (r, i) of one replicate r.
__global__ void __launch_bounds__(THREADS)
poisson_weights_kernel(const int64_t* __restrict__ key,
                       const float* __restrict__ cdf,
                       const uint8_t* __restrict__ valid, uint32_t r0,
                       int k, int s, int tpr, int blocks_per_rep,
                       float* __restrict__ W, float* __restrict__ kstar) {
  __shared__ uint32_t rkey[2];
  __shared__ int part[THREADS / 32];
  const int rep = blockIdx.x / blocks_per_rep;
  const int grp = blockIdx.x - rep * blocks_per_rep;
  if (threadIdx.x == 0) {
    uint32_t a, b;
    threefry2x32(word(key, 0), word(key, 1), 0u, r0 + (uint32_t)rep, a, b);
    rkey[0] = a;
    rkey[1] = b;
  }
  float c[CDF_LEN];
#pragma unroll
  for (int t = 0; t < CDF_LEN; ++t) c[t] = __ldg(cdf + t);
  __syncthreads();
  const uint32_t k0 = rkey[0], k1 = rkey[1];
  const int row = threadIdx.x / tpr;
  const int lane = threadIdx.x - row * tpr;
  const int i = grp * (THREADS / tpr) + row;
  int count = 0;
  if (i < k) {
    const uint8_t* v = valid + (int64_t)i * s;
    float* w_out = W + ((int64_t)rep * k + i) * s;
    for (int j = lane; j < s; j += tpr) {
      int w = 0;
      if (v[j]) {
        uint32_t b1, b2;
        threefry2x32(k0, k1, 0u, (uint32_t)i * (uint32_t)s + (uint32_t)j,
                     b1, b2);
        const float u = to_uniform(b1, b2);
#pragma unroll
        for (int t = 0; t < CDF_LEN; ++t) w += (u >= c[t]) ? 1 : 0;
      }
      w_out[j] = (float)w;
      count += w;
    }
  }
  count = __reduce_add_sync(0xFFFFFFFFu, count);
  if (tpr == 32) {
    if (lane == 0 && i < k) kstar[(int64_t)rep * k + i] = (float)count;
    return;
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = count;
  __syncthreads();
  if (lane == 0 && i < k) {
    const int warps = tpr / 32;
    int sum = 0;
    for (int w = 0; w < warps; ++w) sum += part[row * warps + w];
    kstar[(int64_t)rep * k + i] = (float)sum;
  }
}

unsigned blocks_for(int64_t total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
}

// Threads a row of the fused draw: doubled from one warp while the rows
// fill less than one wave of an H100 (132 SMs x 2048 threads) and a row
// has more slots than threads.
int row_threads(int64_t rows, int s) {
  int tpr = 32;
  while (tpr < THREADS && tpr < s && rows * tpr < 132LL * 2048) tpr *= 2;
  return tpr;
}

constexpr int64_t MAX_BLOCKS = 2147483647LL;

}  // namespace

// The table length the fused draw reads, for the wrapper's check.
extern "C" int repro_threefry_cdf_len() { return CDF_LEN; }

extern "C" int repro_threefry_fold_in(const int64_t* key, const void* data,
                                      int kind, unsigned int scalar,
                                      long long n, int64_t* out,
                                      void* stream) {
  if (n < 1 || kind < 0 || kind > 2 || (kind == 0 && n > 0xFFFFFFFFLL)
      || (n + THREADS - 1) / THREADS > MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  fold_in_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      key, data, kind, scalar, n, reinterpret_cast<longlong2*>(out));
  return (int)cudaGetLastError();
}

extern "C" int repro_threefry_uniform(const int64_t* keys, long long nkeys,
                                      long long n, float* out,
                                      void* stream) {
  if (nkeys < 1 || n < 1 || n > 0xFFFFFFFFLL
      || nkeys > (MAX_BLOCKS * THREADS) / n)
    return (int)cudaErrorInvalidValue;
  uniform_kernel<<<blocks_for(nkeys * n), THREADS, 0,
                   (cudaStream_t)stream>>>(keys, nkeys, n, out);
  return (int)cudaGetLastError();
}

extern "C" int repro_poisson_weights(const int64_t* key, const float* cdf,
                                     const uint8_t* valid, int R,
                                     unsigned int r0, int k, int s,
                                     float* W, float* kstar, void* stream) {
  if (R < 1 || k < 1 || s < 1 || (int64_t)k * s > 0xFFFFFFFFLL
      || 16LL * s >= (1LL << 24))
    return (int)cudaErrorInvalidValue;
  const int tpr = row_threads((int64_t)R * k, s);
  const int per_block = THREADS / tpr;
  const int blocks_per_rep = (k + per_block - 1) / per_block;
  if ((int64_t)R * blocks_per_rep > MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  poisson_weights_kernel<<<(unsigned)((int64_t)R * blocks_per_rep), THREADS,
                           0, (cudaStream_t)stream>>>(
      key, cdf, valid, r0, k, s, tpr, blocks_per_rep, W, kstar);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
