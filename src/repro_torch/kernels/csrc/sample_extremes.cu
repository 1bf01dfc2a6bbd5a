// sample_extremes: per (query, stratum) MIN and MAX of the stratum's
// samples that fall inside the query box; a pair with no such sample
// reads +BIG / -BIG (BIG = 3.4e38).
//
// The JAX package has no Pallas kernel for it: every backend shares one
// jnp broadcast (src/repro/kernels/backends.py:257,
// KernelBackend.sample_extremes), min / max over the slot axis of
// where(inside, a, +-BIG) on a (Q, k, s) intermediate.
//
// Input is the synopsis's leaf-major layout: sample_c (k, s, d),
// sample_a (k, s), sample_valid (k, s) bool, q_lo / q_hi (Q, d), s >= 1.
// Output: out_min, then out_max, each (Q, k) f32, one buffer. A slot is
// relevant iff valid and lo_j <= c_j <= hi_j for every column j.
//
// Contract: the bits of the plain version (sample_extremes_plain), NaN
// compared as NaN. Every pair's result is the fold of its s terms,
// relevant ? a : +BIG for the min (-BIG for the max), under the
// reference's rule: a NaN term gives NaN, -0.0 orders below +0.0 (equal
// terms combine by the OR of their bits for a min, the AND for a max),
// everything else by value. The rule is order-free, so any fold order
// gives the plain version's bits. The fold starts at +inf (-inf), not at
// +BIG: a stratum whose every slot is valid and holds +inf has the min
// +inf, as the plain version's reduction gives it.
//
// What bounds it on an H100: the bytes of the two (Q, k) outputs, 16.8 MB
// at the serving shapes (Q = 2048, k = 1024, s = 75), ~5 us at 3.35 TB/s.
// The plain broadcast builds the (Q, k, s) terms, 629 MB at those shapes.
//
// Design: pair_tiles.cuh (row 2's pair classes, shared with
// stratified_moments.cu), with the policy Extremes below. A covered pair's
// terms are valid ? a : BIG, the same for every query, so it takes the
// stratum's fold; an empty pair's terms are all BIG, so it reads +-BIG
// (s >= 1); only mixed pairs walk their slots. The tile is two planes of
// (QT, LT) floats, the min's and the max's: rows of LT * 4 contiguous
// bytes each. Shared memory ~37 KB at d = 1, ~51 KB at d = 3, ~84 KB at
// d = 16.
#include "pair_tiles.cuh"

namespace {

constexpr float BIG = 3.4e38f;     // kernels/sample_extremes.py BIG

// The fold's update under the reference's rule (order-free): a NaN term
// gives NaN and a NaN stays; of equal terms the OR of the bits (min) or
// the AND (max), so -0.0 wins a min's tie of zeros and +0.0 a max's.
__device__ __forceinline__ float fold_min(float acc, float x) {
  const float tie = __int_as_float(__float_as_int(acc) | __float_as_int(x));
  return (x < acc || x != x) ? x : (x == acc ? tie : acc);
}

__device__ __forceinline__ float fold_max(float acc, float x) {
  const float tie = __int_as_float(__float_as_int(acc) & __float_as_int(x));
  return (x > acc || x != x) ? x : (x == acc ? tie : acc);
}

// The min and the max of the terms relevant ? a : +BIG (-BIG), from +inf
// (-inf).
struct Extremes {
  static constexpr int STATS = 2, PLANES = 2, WIDTH = 1;
  float mn, mx;
  __device__ void init() {
    mn = __int_as_float(0x7f800000);
    mx = -mn;
  }
  __device__ void add(float a, bool in) {
    mn = fold_min(mn, in ? a : BIG);
    mx = fold_max(mx, in ? a : -BIG);
  }
  __device__ void save(float* t) const {
    t[0] = mn;
    t[1] = mx;
  }
  __device__ void load(const float* t) {
    mn = t[0];
    mx = t[1];
  }
  __device__ void fill(float* s_tile, int q, int l, bool inside) const {
    *tile_at<Extremes>(s_tile, 0, q, l) = inside ? mn : BIG;
    *tile_at<Extremes>(s_tile, 1, q, l) = inside ? mx : -BIG;
  }
  __device__ void write(float* out, size_t pair, size_t plane) const {
    out[pair] = mn;
    out[plane + pair] = mx;
  }
};

}  // namespace

// The launch's tiles, for the wrapper's limits.
extern "C" int repro_sample_extremes_query_tile() { return QT; }
extern "C" int repro_sample_extremes_leaf_tile() { return LT; }

extern "C" int repro_sample_extremes(const float* c, const float* a,
                                     const uint8_t* valid, const float* q_lo,
                                     const float* q_hi, float* out, int Q,
                                     int k, int s, int d, void* stream) {
  if (Q < 1 || k < 1 || s < 1 || d < 1 || d > MAX_D)
    return (int)cudaErrorInvalidValue;
  return launch_pair_tiles<Extremes>(c, a, valid, q_lo, q_hi, out, Q, k, s,
                                     d, stream);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
