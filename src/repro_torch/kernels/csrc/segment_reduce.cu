// segment_reduce: per-segment [sum v, sum v^2, count, min, max] of the
// values whose segment id lies in [0, k); other ids (-1 marks a dropped
// row) are skipped. An empty segment reads [0, 0, 0, +BIG, -BIG].
//
// weighted_segment_reduce, its weighted twin in the same two passes:
// per-segment [sum w*v, sum w*v^2, sum w] with one weight per row; an
// empty segment reads [0, 0, 0]. It replaces the Pallas kernel
// src/repro/kernels/segment_reduce.py::weighted_segment_reduce (body
// `_kernel_weighted`), the same one-hot MXU contraction with the moment
// matrix scaled by the row weight. Its bound is bytes as well (12 bytes a
// row in, 12 a segment out).
//
// Replaces the Pallas kernel
// src/repro/kernels/segment_reduce.py::segment_reduce (body `_kernel`),
// which walks row tiles on a sequential grid, builds a one-hot (BN, BK)
// tile and contracts it with [v, v^2, 1] on the MXU, carrying the (BK, 8)
// output block across the row dimension.
//
// What bounds it on an H100: at the streaming ingest's shapes (N = 4096
// rows, k = 1024 segments) nothing the card is built for: 8 bytes a row
// in, 20 bytes a segment out, ~6 operations a row, so the bound is a few
// microseconds of bytes and the kernel is bound by its launch and its
// two passes' latency.
//
// Design, deterministic with no float atomics (the sharded ingest's
// byte-equality to the single-device one rests on this reduction):
//  * Pass 1: the rows are cut into C chunks of CH consecutive rows. Block
//    (chunk, segment tile) stages its chunk's ids and values in shared
//    memory; thread t owns segment tile*BS + t and walks the chunk's rows
//    in order, accumulating its five moments in registers. Every thread
//    reads the same row at once (a shared memory broadcast). The partials
//    go to part (C, 5, k). A block whose segment tile holds none of the
//    chunk's ids (the chunk's min and max id are reduced first) writes the
//    identity and skips the walk.
//  * Pass 2: thread s combines part[0..C-1][.][s] in chunk order.
// The sum order is thus fixed by (N, k) alone: row order inside a chunk,
// chunk order across chunks. Skewed ids (a stream in pickup-time order
// puts a whole batch into one to three leaves) do not serialise the
// batch: the chunks of one segment are walked by C blocks in parallel.
// Work is O(N * k) compares, which at the ingest's shapes is ~4 M and
// far below the launch cost; CH grows with N so that C stays <= MAX_C.
// Any N and k are taken by masking; there is no padding to a block size.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 256;        // segments per block == threads per block
constexpr int MIN_CH = 256;    // rows per chunk, at least
constexpr int MAX_C = 264;     // chunks, at most (two per SM)
constexpr int TILE = 1024;     // rows staged in shared memory at a time
constexpr float POS_BIG = 3.0e38f;   // kernels/ref.py POS_BIG / NEG_BIG
constexpr float NEG_BIG = -3.0e38f;

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

__global__ void __launch_bounds__(BS)
segment_partials(const float* __restrict__ v, const int32_t* __restrict__ ids,
                 float* __restrict__ part, int N, int k, int CH) {
  __shared__ float s_v[TILE];
  __shared__ int32_t s_id[TILE];
  __shared__ int s_min[BS / 32], s_max[BS / 32];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int seg0 = blockIdx.y * BS;
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
      for (int i = 0; i < n; ++i) {
        if (s_id[i] == seg) {
          const float x = s_v[i];
          sum += x;
          sumsq += x * x;
          cnt += 1.f;
          mn = x < mn ? x : mn;
          mx = x > mx ? x : mx;
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

__global__ void __launch_bounds__(BS)
segment_combine(const float* __restrict__ part, float* __restrict__ out,
                int k, int C) {
  const int seg = blockIdx.x * BS + threadIdx.x;
  if (seg >= k) return;
  float sum = 0.f, sumsq = 0.f, cnt = 0.f, mn = POS_BIG, mx = NEG_BIG;
  for (int c = 0; c < C; ++c) {
    const float* p = part + (size_t)c * 5 * k + seg;
    sum += p[0];
    sumsq += p[(size_t)k];
    cnt += p[(size_t)2 * k];
    mn = fminf(mn, p[(size_t)3 * k]);
    mx = fmaxf(mx, p[(size_t)4 * k]);
  }
  float* o = out + (size_t)seg * 5;
  o[0] = sum;
  o[1] = sumsq;
  o[2] = cnt;
  o[3] = mn;
  o[4] = mx;
}

__global__ void __launch_bounds__(BS)
weighted_partials(const float* __restrict__ v, const float* __restrict__ wt,
                  const int32_t* __restrict__ ids, float* __restrict__ part,
                  int N, int k, int CH) {
  __shared__ float s_v[TILE];
  __shared__ float s_w[TILE];
  __shared__ int32_t s_id[TILE];
  __shared__ int s_min[BS / 32], s_max[BS / 32];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int seg0 = blockIdx.y * BS;
  const int seg = seg0 + tid;
  const int r0 = chunk * CH;
  const int r1 = min(N, r0 + CH);
  const bool any = chunk_hits_tile(ids, r0, r1, k, seg0, s_min, s_max);

  float sum = 0.f, sumsq = 0.f, wsum = 0.f;
  if (any) {  // uniform across the block
    for (int t0 = r0; t0 < r1; t0 += TILE) {
      const int n = min(TILE, r1 - t0);
      __syncthreads();  // the previous tile is consumed
      for (int i = tid; i < n; i += BS) {
        s_v[i] = v[t0 + i];
        s_w[i] = wt[t0 + i];
        s_id[i] = ids[t0 + i];
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        if (s_id[i] == seg) {
          const float w = s_w[i];
          const float wv = w * s_v[i];
          sum += wv;
          sumsq += wv * s_v[i];
          wsum += w;
        }
      }
    }
  }
  if (seg < k) {
    float* p = part + (size_t)chunk * 3 * k + seg;
    p[0] = sum;
    p[(size_t)k] = sumsq;
    p[(size_t)2 * k] = wsum;
  }
}

__global__ void __launch_bounds__(BS)
weighted_combine(const float* __restrict__ part, float* __restrict__ out,
                 int k, int C) {
  const int seg = blockIdx.x * BS + threadIdx.x;
  if (seg >= k) return;
  float sum = 0.f, sumsq = 0.f, wsum = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* p = part + (size_t)c * 3 * k + seg;
    sum += p[0];
    sumsq += p[(size_t)k];
    wsum += p[(size_t)2 * k];
  }
  float* o = out + (size_t)seg * 3;
  o[0] = sum;
  o[1] = sumsq;
  o[2] = wsum;
}

}  // namespace

// Rows per chunk for N rows: at least MIN_CH, and enough that there are
// at most MAX_C chunks. The wrapper sizes `part` from it.
extern "C" int repro_segment_reduce_chunk(int N) {
  const int ch = (N + MAX_C - 1) / MAX_C;
  return ch > MIN_CH ? ch : MIN_CH;
}

// part: scratch of at least C * 5 * k floats, C = ceil(N / CH).
extern "C" int repro_segment_reduce(const float* v, const int32_t* ids,
                                    float* part, float* out, int N, int k,
                                    void* stream) {
  if (N < 0 || k < 1) return (int)cudaErrorInvalidValue;
  const int CH = repro_segment_reduce_chunk(N);
  const int C = (N + CH - 1) / CH;
  cudaStream_t st = (cudaStream_t)stream;
  if (C > 0) {
    dim3 grid(C, (k + BS - 1) / BS);
    segment_partials<<<grid, BS, 0, st>>>(v, ids, part, N, k, CH);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  segment_combine<<<(k + BS - 1) / BS, BS, 0, st>>>(part, out, k, C);
  return (int)cudaGetLastError();
}

// part: scratch of at least C * 3 * k floats, C = ceil(N / CH).
extern "C" int repro_weighted_segment_reduce(const float* v, const float* w,
                                             const int32_t* ids, float* part,
                                             float* out, int N, int k,
                                             void* stream) {
  if (N < 0 || k < 1) return (int)cudaErrorInvalidValue;
  const int CH = repro_segment_reduce_chunk(N);
  const int C = (N + CH - 1) / CH;
  cudaStream_t st = (cudaStream_t)stream;
  if (C > 0) {
    dim3 grid(C, (k + BS - 1) / BS);
    weighted_partials<<<grid, BS, 0, st>>>(v, w, ids, part, N, k, CH);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  weighted_combine<<<(k + BS - 1) / BS, BS, 0, st>>>(part, out, k, C);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
