// query_eval: classify every (query, leaf) pair and sum the aggregates of
// the covered leaves, in one pass.
//
// Replaces the Pallas kernel src/repro/kernels/query_eval.py::query_eval
// (body `_kernel`), which tiles (queries x leaves) on a sequential grid and
// accumulates `exact` with an MXU product cover(BQ, BK) @ leaf_agg(BK, 8).
//
// Output: rel (Q, k) int32, 2 = the query covers the leaf, 1 = partial,
// 0 = disjoint; an empty leaf (inverted box, lo > hi in some dimension)
// is 0. exact (Q, A) f32 = sum over covered leaves j of leaf_agg[j, :].
//
// What bounds it on an H100: memory. Per (query, leaf) pair it does ~4d
// compares and writes 4 bytes of rel; everything else (boxes, aggregates,
// query bounds) is O(k + Q). At Q = 2048, k = 1024 the rel write is 8 MB.
//
// Design: one block of BK = 256 threads per tile of BQ = 16 queries loops
// over leaf tiles of BK leaves staged in shared memory.
//  * Phase 1: thread t classifies leaf t of the tile against each of the
//    BQ queries, so a warp writes 32 consecutive rel words of one query
//    row: the dominant traffic is fully coalesced. The cover bits go to
//    shared memory.
//  * Phase 2: thread (q, a) for q < BQ, a < A walks the tile's leaves in
//    order and adds leaf_agg[j, a] where leaf j is covered (`if (cover)`,
//    not `cover * agg`: empty leaves carry +-inf in the MIN/MAX columns).
//    Each exact[q, a] is one register summed over all leaves in leaf
//    order: a fixed reduction order, no atomics, no tensor cores.
// Any Q and k are taken by masking the ragged edge; the leaf-tile padding
// is an inverted box, so it classifies as empty.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;     // queries per block
constexpr int BK = 256;    // leaves per tile == threads per block
constexpr int MAX_D = 16;  // predicate columns
constexpr int MAX_A = 8;   // aggregate columns

__global__ void __launch_bounds__(BK)
query_eval_kernel(const float* __restrict__ leaf_lo,
                  const float* __restrict__ leaf_hi,
                  const float* __restrict__ leaf_agg,
                  const float* __restrict__ q_lo,
                  const float* __restrict__ q_hi,
                  int32_t* __restrict__ rel, float* __restrict__ exact,
                  int Q, int k, int d, int A) {
  __shared__ float s_lo[MAX_D][BK];
  __shared__ float s_hi[MAX_D][BK];
  __shared__ float s_agg[BK][MAX_A];
  __shared__ float s_qlo[BQ][MAX_D];
  __shared__ float s_qhi[BQ][MAX_D];
  __shared__ unsigned char s_cov[BQ][BK];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;

  for (int i = tid; i < BQ * d; i += BK) {
    const int qq = i / d, j = i % d;
    const int q = q0 + qq;
    s_qlo[qq][j] = q < Q ? q_lo[(size_t)q * d + j] : 0.f;
    s_qhi[qq][j] = q < Q ? q_hi[(size_t)q * d + j] : 0.f;
  }

  const bool owner = tid < BQ * A;
  const int own_q = owner ? tid / A : 0;
  const int own_a = owner ? tid % A : 0;
  float acc = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();  // the previous tile's phase 2 is done with smem
    const int leaf = k0 + tid;
    const bool in = leaf < k;
    for (int j = 0; j < d; ++j) {
      s_lo[j][tid] = in ? leaf_lo[(size_t)leaf * d + j] : 1.f;
      s_hi[j][tid] = in ? leaf_hi[(size_t)leaf * d + j] : -1.f;
    }
    for (int i = tid; i < BK * A; i += BK) {
      const int l = i / A, a = i % A;
      s_agg[l][a] = (k0 + l < k) ? leaf_agg[(size_t)k0 * A + i] : 0.f;
    }
    __syncthreads();

    bool nonempty = true;
    for (int j = 0; j < d; ++j) nonempty &= s_lo[j][tid] <= s_hi[j][tid];
    for (int qq = 0; qq < BQ; ++qq) {
      bool cover = nonempty, disjoint = !nonempty;
      for (int j = 0; j < d; ++j) {
        const float lo = s_lo[j][tid], hi = s_hi[j][tid];
        const float ql = s_qlo[qq][j], qh = s_qhi[qq][j];
        cover &= (ql <= lo) & (hi <= qh);
        disjoint |= (qh < lo) | (ql > hi);
      }
      s_cov[qq][tid] = cover;
      const int q = q0 + qq;
      if (in && q < Q)
        rel[(size_t)q * k + leaf] = cover ? 2 : (disjoint ? 0 : 1);
    }
    __syncthreads();

    if (owner) {
      const int n = min(BK, k - k0);
      for (int l = 0; l < n; ++l)
        if (s_cov[own_q][l]) acc += s_agg[l][own_a];
    }
  }
  if (owner && q0 + own_q < Q) exact[(size_t)(q0 + own_q) * A + own_a] = acc;
}

}  // namespace

extern "C" int repro_query_eval(const float* leaf_lo, const float* leaf_hi,
                                const float* leaf_agg, const float* q_lo,
                                const float* q_hi, int32_t* rel, float* exact,
                                int Q, int k, int d, int A, void* stream) {
  if (Q < 1 || k < 1 || d < 1 || d > MAX_D || A < 1 || A > MAX_A)
    return (int)cudaErrorInvalidValue;
  const int blocks = (Q + BQ - 1) / BQ;
  query_eval_kernel<<<blocks, BK, 0, (cudaStream_t)stream>>>(
      leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi, rel, exact, Q, k, d, A);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
