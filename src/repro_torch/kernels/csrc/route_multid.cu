// route_multid: for each row, the leaf box at the least L1 distance
// (0 inside the box), the lowest leaf id on ties. Returns leaf (B,) int32
// and that distance (B,) f32.
//
// Replaces the Pallas kernel src/repro/kernels/route.py::route_multid_pallas
// (body `_route_kernel`), which walks (row tile, leaf tile) on a grid whose
// leaf dimension is sequential, carrying the running (min, argmin) pair in
// its output block, and merges tiles with a strict `<`.
//
// Bit-equal to the dense oracle route_multid_dense: the distance of a
// (row, leaf) pair is max(max(lo_j - c_j, c_j - hi_j), 0) summed over
// the dimensions j in order, in fp32, starting from dimension 0's term.
// There is no multiply, so nothing can contract to an FMA. Leaves are
// walked in ascending id and the best is replaced only on a strict `<`,
// so the lowest id wins ties; the start is (+inf, leaf 0), which is what
// argmin gives over a row of +inf. An empty leaf is an inverted box
// (lo = +inf, hi = -inf) whose distance is +inf by itself, so it needs
// no mask and no padding.
//
// What bounds it on an H100: operations. B * k * d pairs at 5 fp32
// operations each, against (2 k + B) * d * 4 bytes in and 8 B bytes out.
//
// Design: one thread per row, its coordinates in registers; one block of
// BB rows stages the leaf boxes through shared memory in tiles of TK
// leaves, stored dimension-major so that every thread reads the same
// word at once (a broadcast). At B = 4096 that is only 16 blocks for 132
// SMs: the card is mostly idle at the ingest's batch size. Splitting the
// leaves across blocks would need a second, ordered merge pass; that is
// tuning, left for later.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BB = 256;     // rows per block == threads per block
constexpr int TK = 256;     // leaves staged per tile
constexpr int MAX_D = 16;   // coordinate columns

__global__ void __launch_bounds__(BB)
route_multid_kernel(const float* __restrict__ leaf_lo,
                    const float* __restrict__ leaf_hi,
                    const float* __restrict__ c,
                    int32_t* __restrict__ leaf_out,
                    float* __restrict__ dist_out, int B, int k, int d) {
  __shared__ float s_lo[MAX_D][TK];
  __shared__ float s_hi[MAX_D][TK];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * BB + tid;
  const bool active = row < B;

  float x[MAX_D];
#pragma unroll
  for (int j = 0; j < MAX_D; ++j)
    x[j] = (active && j < d) ? c[(size_t)row * d + j] : 0.f;

  float best = CUDART_INF_F;
  int best_i = 0;
  for (int k0 = 0; k0 < k; k0 += TK) {
    const int n = min(TK, k - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < n * d; i += BB) {
      const int l = i / d, j = i % d;
      s_lo[j][l] = leaf_lo[(size_t)k0 * d + i];
      s_hi[j][l] = leaf_hi[(size_t)k0 * d + i];
    }
    __syncthreads();
    for (int l = 0; l < n; ++l) {
      float dist = fmaxf(fmaxf(s_lo[0][l] - x[0], x[0] - s_hi[0][l]), 0.f);
#pragma unroll
      for (int j = 1; j < MAX_D; ++j) {
        if (j < d)
          dist = dist + fmaxf(fmaxf(s_lo[j][l] - x[j], x[j] - s_hi[j][l]),
                              0.f);
      }
      if (dist < best) {
        best = dist;
        best_i = k0 + l;
      }
    }
  }
  if (active) {
    leaf_out[row] = best_i;
    dist_out[row] = best;
  }
}

}  // namespace

extern "C" int repro_route_multid(const float* leaf_lo, const float* leaf_hi,
                                  const float* c, int32_t* leaf, float* dist,
                                  int B, int k, int d, void* stream) {
  if (B < 1 || k < 1 || d < 1 || d > MAX_D)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + BB - 1) / BB;
  route_multid_kernel<<<blocks, BB, 0, (cudaStream_t)stream>>>(
      leaf_lo, leaf_hi, c, leaf, dist, B, k, d);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
