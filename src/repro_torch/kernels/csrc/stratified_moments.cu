// stratified_moments: per (query, stratum) moments of the stratum's
// samples that fall inside the query box: [count, sum a, sum a^2].
//
// Replaces the Pallas kernel
// src/repro/kernels/stratified_estimate.py::stratified_moments (bodies
// `_moment_tile` and `_kernel`), which flattens the samples to (S,) with a
// leaf id per slot and contracts the predicate mask with a one-hot
// (S, k) stratum matrix on the MXU: O(Q * S * k) multiply-adds.
//
// Input is the synopsis's own leaf-major layout: sample_c (k, s, d),
// sample_a (k, s), sample_valid (k, s) bool, q_lo / q_hi (Q, d). Output
// (Q, k, 3) f32. A slot counts iff valid and lo_j <= c_j <= hi_j for every
// column j (inclusive bounds).
//
// What bounds it on an H100: operations. There are Q * k * s (query, slot)
// pairs at ~2d + 3 operations each, against O(k * s * d + Q * d) input
// bytes and 12 bytes of output per (query, stratum).
//
// Design: a slot only ever meets its own stratum, so the one-hot product
// goes away and the work is O(Q * k * s). One block of BQ = 128 threads
// per (query tile, leaf) stages that leaf's slots in shared memory (in
// chunks of S_TILE, so any s fits) and every thread, owning one query,
// walks the slots in order, accumulating count, sum and sum of squares
// in fp32 registers. All threads read the same slot at once (a shared
// memory broadcast). No atomics and no tensor cores: the reduction order
// is the slot order, fixed. Each thread writes its 3 results; the writes
// of one block are k * 12 bytes apart, which is the first thing to
// improve if this kernel shows up in the serving time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;     // queries per block == threads per block
constexpr int S_TILE = 256; // slots staged per chunk
constexpr int MAX_D = 16;   // predicate columns

__global__ void __launch_bounds__(BQ)
stratified_moments_kernel(const float* __restrict__ c,
                          const float* __restrict__ a,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ q_lo,
                          const float* __restrict__ q_hi,
                          float* __restrict__ out,
                          int Q, int k, int s, int d) {
  __shared__ float s_c[S_TILE * MAX_D];
  __shared__ float s_a[S_TILE];
  __shared__ uint8_t s_v[S_TILE];

  const int leaf = blockIdx.x;
  const int q = blockIdx.y * BQ + threadIdx.x;
  const bool active = q < Q;

  float ql[MAX_D], qh[MAX_D];
#pragma unroll
  for (int j = 0; j < MAX_D; ++j) {
    ql[j] = (active && j < d) ? q_lo[(size_t)q * d + j] : 0.f;
    qh[j] = (active && j < d) ? q_hi[(size_t)q * d + j] : 0.f;
  }

  float cnt = 0.f, sum = 0.f, sq = 0.f;
  const size_t base = (size_t)leaf * s;
  for (int s0 = 0; s0 < s; s0 += S_TILE) {
    const int n = min(S_TILE, s - s0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < n * d; i += BQ)
      s_c[i] = c[(base + s0) * d + i];
    for (int i = threadIdx.x; i < n; i += BQ) {
      s_a[i] = a[base + s0 + i];
      s_v[i] = valid[base + s0 + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      bool pred = s_v[i] != 0;
#pragma unroll
      for (int j = 0; j < MAX_D; ++j) {
        if (j < d) {
          const float cj = s_c[i * d + j];
          pred &= (ql[j] <= cj) & (cj <= qh[j]);
        }
      }
      if (pred) {
        const float av = s_a[i];
        cnt += 1.f;
        sum += av;
        sq += av * av;
      }
    }
  }
  if (active) {
    float* o = out + ((size_t)q * k + leaf) * 3;
    o[0] = cnt;
    o[1] = sum;
    o[2] = sq;
  }
}

}  // namespace

extern "C" int repro_stratified_moments(const float* c, const float* a,
                                        const uint8_t* valid,
                                        const float* q_lo, const float* q_hi,
                                        float* out, int Q, int k, int s,
                                        int d, void* stream) {
  if (Q < 1 || k < 1 || s < 0 || d < 1 || d > MAX_D)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(k, (Q + BQ - 1) / BQ);
  stratified_moments_kernel<<<grid, BQ, 0, (cudaStream_t)stream>>>(
      c, a, valid, q_lo, q_hi, out, Q, k, s, d);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
