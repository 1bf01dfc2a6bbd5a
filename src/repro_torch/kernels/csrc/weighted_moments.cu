// Weighted relevant-sample moments for the Poisson bootstrap: per (query,
// stratum) [sum w, sum w*a, sum w*a^2] over the stratum's valid samples
// that fall inside the query box. Two entry points share one source so
// that one digest covers both (a stale library can never pair an edited
// update with an old twin):
//
//  * stratified_weighted_moments: one weight row w (k, s) -> (Q, k, 3).
//    Replaces the Pallas kernel
//    src/repro/kernels/stratified_estimate.py::stratified_weighted_moments
//    (body `_kernel_weighted`), which scales the predicate mask by w and
//    contracts it with a one-hot (S, k) stratum matrix on the MXU. The scan
//    bootstrap launches it once per replicate.
//  * bootstrap_moments: R weight rows W (R, k, s) -> (R, Q, k, 3) in one
//    pass. Replaces the Pallas megakernel
//    src/repro/kernels/bootstrap.py::bootstrap_moments (body `_kernel`),
//    which reuses one predicate tile for an unrolled block of BR
//    replicates. The fused bootstrap (the default) launches it once per
//    answer.
//
// Contract (DESIGN.md §10): for every r, bootstrap_moments(W)[r] is bit
// for bit stratified_weighted_moments(W[r]). Both kernels walk a leaf's
// slots in slot order from a zero accumulator and call the same
// `weighted_update`, whose products and sums are written with explicit
// round-to-nearest intrinsics, so nvcc's FMA contraction cannot round the
// two differently. A slot counts iff valid and lo_j <= c_j <= hi_j for
// every column j; an invalid slot adds nothing whatever its weight.
//
// What bounds it on an H100: at the bootstrap's shapes (Q = 2048, k =
// 1024, s = 75, R = 200) the bytes of the (R, Q, k, 3) output, 5.03 GB,
// ~1.5 ms at 3.35 TB/s. The operations (2d compares a (query, slot) pair
// for the predicate, ~5 a relevant (query, slot, replicate)) come under
// that.
//
// Design, taken from csrc/stratified_moments.cu: one block of BQ = 128
// threads per (leaf, query tile[, replicate tile]); the leaf's slots are
// staged in shared memory in chunks of S_TILE, beside their weights (RT
// rows of them for the bootstrap); every thread owns one query and walks
// the slots in order, all threads reading the same slot at once (a shared
// memory broadcast). The bootstrap computes a slot's predicate once for
// its RT replicates and keeps RT x 3 accumulators in registers. No
// atomics, no tensor cores (no TF32). Each thread writes its 3 floats per
// replicate k * 12 bytes from its neighbour's; the leaf runs along
// blockIdx.x, so neighbouring blocks fill the rest of those sectors in L2
// at about the same time. That store pattern and the predicate recomputed
// per replicate tile are the first things to improve.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;     // queries per block == threads per block
constexpr int S_TILE = 256; // slots staged per chunk
constexpr int MAX_D = 16;   // predicate columns
constexpr int RT = 8;       // replicates per bootstrap block

// The one per-slot update of both kernels: m += [w, w*a, (w*a)*a].
__device__ __forceinline__ void weighted_update(float w, float a, float* m) {
  const float wa = __fmul_rn(w, a);
  m[0] = __fadd_rn(m[0], w);
  m[1] = __fadd_rn(m[1], wa);
  m[2] = __fadd_rn(m[2], __fmul_rn(wa, a));
}

// Is staged slot i relevant to the query whose bounds are ql/qh?
__device__ __forceinline__ bool slot_inside(const float* s_c,
                                            const uint8_t* s_v, int i, int d,
                                            const float* ql,
                                            const float* qh) {
  bool pred = s_v[i] != 0;
#pragma unroll
  for (int j = 0; j < MAX_D; ++j) {
    if (j < d) {
      const float cj = s_c[i * d + j];
      pred &= (ql[j] <= cj) & (cj <= qh[j]);
    }
  }
  return pred;
}

__device__ __forceinline__ void load_query(const float* q_lo,
                                           const float* q_hi, int q, int d,
                                           bool active, float* ql,
                                           float* qh) {
#pragma unroll
  for (int j = 0; j < MAX_D; ++j) {
    ql[j] = (active && j < d) ? q_lo[(size_t)q * d + j] : 0.f;
    qh[j] = (active && j < d) ? q_hi[(size_t)q * d + j] : 0.f;
  }
}

// Stage slots [s0, s0 + n) of a leaf (base = leaf * s) in shared memory.
__device__ __forceinline__ void stage_slots(const float* c, const float* a,
                                            const uint8_t* valid,
                                            size_t base, int s0, int n,
                                            int d, float* s_c, float* s_a,
                                            uint8_t* s_v) {
  for (int i = threadIdx.x; i < n * d; i += BQ)
    s_c[i] = c[(base + s0) * d + i];
  for (int i = threadIdx.x; i < n; i += BQ) {
    s_a[i] = a[base + s0 + i];
    s_v[i] = valid[base + s0 + i];
  }
}

__global__ void __launch_bounds__(BQ)
stratified_weighted_moments_kernel(const float* __restrict__ c,
                                   const float* __restrict__ a,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ w,
                                   const float* __restrict__ q_lo,
                                   const float* __restrict__ q_hi,
                                   float* __restrict__ out,
                                   int Q, int k, int s, int d) {
  __shared__ float s_c[S_TILE * MAX_D];
  __shared__ float s_a[S_TILE];
  __shared__ float s_w[S_TILE];
  __shared__ uint8_t s_v[S_TILE];

  const int leaf = blockIdx.x;
  const int q = blockIdx.y * BQ + threadIdx.x;
  const bool active = q < Q;
  float ql[MAX_D], qh[MAX_D];
  load_query(q_lo, q_hi, q, d, active, ql, qh);

  float m[3] = {0.f, 0.f, 0.f};
  const size_t base = (size_t)leaf * s;
  for (int s0 = 0; s0 < s; s0 += S_TILE) {
    const int n = min(S_TILE, s - s0);
    __syncthreads();  // the previous chunk is no longer read
    stage_slots(c, a, valid, base, s0, n, d, s_c, s_a, s_v);
    for (int i = threadIdx.x; i < n; i += BQ) s_w[i] = w[base + s0 + i];
    __syncthreads();
    for (int i = 0; i < n; ++i)
      if (slot_inside(s_c, s_v, i, d, ql, qh))
        weighted_update(s_w[i], s_a[i], m);
  }
  if (active) {
    float* o = out + ((size_t)q * k + leaf) * 3;
    o[0] = m[0];
    o[1] = m[1];
    o[2] = m[2];
  }
}

__global__ void __launch_bounds__(BQ)
bootstrap_moments_kernel(const float* __restrict__ c,
                         const float* __restrict__ a,
                         const uint8_t* __restrict__ valid,
                         const float* __restrict__ W,
                         const float* __restrict__ q_lo,
                         const float* __restrict__ q_hi,
                         float* __restrict__ out,
                         int R, int Q, int k, int s, int d) {
  __shared__ float s_c[S_TILE * MAX_D];
  __shared__ float s_a[S_TILE];
  __shared__ float s_w[RT][S_TILE];
  __shared__ uint8_t s_v[S_TILE];

  const int leaf = blockIdx.x;
  const int q = blockIdx.y * BQ + threadIdx.x;
  const int r0 = blockIdx.z * RT;
  const int nr = min(RT, R - r0);
  const bool active = q < Q;
  float ql[MAX_D], qh[MAX_D];
  load_query(q_lo, q_hi, q, d, active, ql, qh);

  float m[RT][3];
#pragma unroll
  for (int r = 0; r < RT; ++r) m[r][0] = m[r][1] = m[r][2] = 0.f;
  const size_t base = (size_t)leaf * s;
  const size_t ks = (size_t)k * s;
  for (int s0 = 0; s0 < s; s0 += S_TILE) {
    const int n = min(S_TILE, s - s0);
    __syncthreads();
    stage_slots(c, a, valid, base, s0, n, d, s_c, s_a, s_v);
    for (int i = threadIdx.x; i < nr * n; i += BQ) {
      const int r = i / n, j = i - r * n;
      s_w[r][j] = W[(size_t)(r0 + r) * ks + base + s0 + j];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (!slot_inside(s_c, s_v, i, d, ql, qh)) continue;
      const float av = s_a[i];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r < nr) weighted_update(s_w[r][i], av, m[r]);
    }
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < nr) {
        float* o = out + (((size_t)(r0 + r) * Q + q) * k + leaf) * 3;
        o[0] = m[r][0];
        o[1] = m[r][1];
        o[2] = m[r][2];
      }
    }
  }
}

}  // namespace

extern "C" int repro_stratified_weighted_moments(
    const float* c, const float* a, const uint8_t* valid, const float* w,
    const float* q_lo, const float* q_hi, float* out, int Q, int k, int s,
    int d, void* stream) {
  if (Q < 1 || k < 1 || s < 0 || d < 1 || d > MAX_D)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(k, (Q + BQ - 1) / BQ);
  stratified_weighted_moments_kernel<<<grid, BQ, 0, (cudaStream_t)stream>>>(
      c, a, valid, w, q_lo, q_hi, out, Q, k, s, d);
  return (int)cudaGetLastError();
}

extern "C" int repro_bootstrap_moments(const float* c, const float* a,
                                       const uint8_t* valid, const float* W,
                                       const float* q_lo, const float* q_hi,
                                       float* out, int R, int Q, int k,
                                       int s, int d, void* stream) {
  if (R < 1 || Q < 1 || k < 1 || s < 0 || d < 1 || d > MAX_D)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(k, (Q + BQ - 1) / BQ, (R + RT - 1) / RT);
  bootstrap_moments_kernel<<<grid, BQ, 0, (cudaStream_t)stream>>>(
      c, a, valid, W, q_lo, q_hi, out, R, Q, k, s, d);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
