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
// gives the plain version's bits, and so does pair_tiles.cuh's chunk order
// for s > 2048 (each chunk of 2048 slots folded, then the chunks' results
// folded by the same rule): the bits equal sample_extremes_plain's at
// every s. The fold starts at +inf (-inf), not at +BIG: a stratum whose
// every slot is valid and holds +inf has the min +inf, as the plain
// version's reduction gives it. It runs on order keys (an integer min and
// max a slot, below), which give the rule's bits for every result but a
// NaN, whose payload may differ from the plain version's.
//
// What bounds it on an H100: the bytes of the two (Q, k) outputs, 16.8 MB
// at the serving shapes (Q = 2048, k = 1024, s = 75), ~5 us at 3.35 TB/s.
// The plain broadcast builds the (Q, k, s) terms, 629 MB at those shapes.
// With few strata of many slots (k = 1, s = 38,500) the slot tests bound
// it, as they bound stratified_moments there.
//
// Design: pair_tiles.cuh (row 2's pair classes, shared with
// stratified_moments.cu), with the policy Extremes below. A covered pair's
// terms are valid ? a : BIG, the same for every query, so it takes the
// stratum's fold; an empty pair's terms are all BIG, so it reads +-BIG
// (s >= 1); only mixed pairs walk their slots; a chunk (s > 2048) the
// same. The one-pass tile is two planes of (QT, LT) floats, the min's and
// the max's: rows of LT * 4 contiguous bytes each. Shared memory ~37 KB at
// d = 1, ~51 KB at d = 3, ~84 KB at d = 16 (one pass); at every d > 16 as
// stratified_moments.cu's (pair_tiles.cuh's wide kernels).
#include <limits.h>

#include "pair_tiles.cuh"

namespace {

constexpr float BIG = 3.4e38f;     // kernels/sample_extremes.py BIG

// Order keys: a float's bits with the magnitude bits flipped under a
// negative sign compare as int32 in the reference's order (-0.0 below
// +0.0, everything else by value); a NaN term takes INT_MIN in the min's
// fold and INT_MAX in the max's, so it wins either. The map is its own
// inverse; a NaN key decodes to a NaN.
__device__ __forceinline__ int key_of(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float of_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ int min_key(float x) {
  return x != x ? INT_MIN : key_of(x);
}

__device__ __forceinline__ int max_key(float x) {
  return x != x ? INT_MAX : key_of(x);
}

// The min and the max of the terms relevant ? a : +BIG (-BIG), from +inf
// (-inf), as order keys.
struct Extremes {
  static constexpr int STATS = 2, PLANES = 2, WIDTH = 1;
  int kn, kx;
  __device__ void init() {
    const float inf = __int_as_float(0x7f800000);
    kn = key_of(inf);
    kx = key_of(-inf);
  }
  __device__ void none() {
    kn = key_of(BIG);
    kx = key_of(-BIG);
  }
  __device__ void add(float a, bool in) {
    const int k = key_of(a);
    const bool nan = a != a;
    kn = min(kn, in ? (nan ? INT_MIN : k) : key_of(BIG));
    kx = max(kx, in ? (nan ? INT_MAX : k) : key_of(-BIG));
  }
  __device__ void merge(const Extremes& p) {
    kn = min(kn, p.kn);
    kx = max(kx, p.kx);
  }
  __device__ void save(float* t) const {
    t[0] = of_key(kn);
    t[1] = of_key(kx);
  }
  __device__ void load(const float* t) {
    kn = min_key(t[0]);
    kx = max_key(t[1]);
  }
  __device__ void fill(float* s_tile, int q, int l, bool inside) const {
    *tile_at<Extremes>(s_tile, 0, q, l) = inside ? of_key(kn) : BIG;
    *tile_at<Extremes>(s_tile, 1, q, l) = inside ? of_key(kx) : -BIG;
  }
  __device__ void write(float* out, size_t pair, size_t plane) const {
    out[pair] = of_key(kn);
    out[plane + pair] = of_key(kx);
  }
};

}  // namespace

// The launch's tiles, the order contract's chunk and the scratch a launch
// needs, for the wrapper to be checked against.
extern "C" int repro_sample_extremes_query_tile() { return QT; }
extern "C" int repro_sample_extremes_leaf_tile() { return LT; }
extern "C" int repro_sample_extremes_slot_chunk() { return SLOT_CHUNK; }
extern "C" long long repro_sample_extremes_scratch(int Q, int k, int s,
                                                   int d) {
  return pair_scratch_floats<Extremes>(Q, k, s, d);
}

// scratch: the wrapper's buffer of scratch_floats floats, at least
// repro_sample_extremes_scratch(Q, k, s, d) (none for s <= 2048).
extern "C" int repro_sample_extremes(const float* c, const float* a,
                                     const uint8_t* valid, const float* q_lo,
                                     const float* q_hi, float* out,
                                     float* scratch, long long scratch_floats,
                                     int Q, int k, int s, int d,
                                     void* stream) {
  if (Q < 1 || k < 1 || s < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  return launch_pair_tiles<Extremes>(c, a, valid, q_lo, q_hi, out, scratch,
                                     scratch_floats, Q, k, s, d, stream);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
