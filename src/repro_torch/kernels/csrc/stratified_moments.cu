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
// Contract: fixed by s alone (pair_tiles.cuh's order contract, chunks of
// SLOT_CHUNK = 2048 slots). Each moment adds the relevant slots in slot
// order through `add_slot`: cnt + 1, sum + a and fma(a, a, sq), pinned
// with round-to-nearest intrinsics so that nvcc's FMA contraction cannot
// round two paths differently (the first version's `sq += a * a` compiled
// to that FFMA: FADD, FADD, FFMA in its SASS).
//  * s <= 2048: one fold from +0.0 over all s slots, the bits of the first
//    version of this kernel, which walked every (query, stratum) pair.
//  * s > 2048: each chunk of 2048 consecutive slots (the last one shorter)
//    gives a partial [cnt, sum, sq], summed in slot order from +0.0 through
//    `add_slot`; the pair's moments are the left fold of the partials in
//    chunk order from +0.0 with __fadd_rn (+0.0 + p = p here: a sum from
//    +0.0 under round-to-nearest never reaches -0.0).
// A pair's bits thus depend on its slots, s and the chunk only, never on
// Q, on the pair's place in the batch or on the grid: the plan cache's and
// the coalescer's demux identity and the shard-count invariance on merged
// synopses hold at every s. No float atomics; the same bits on every
// launch.
//
// What bounds it on an H100: the bytes of the (Q, k, 3) output, 25.2 MB
// at the serving shapes (Q = 2048, k = 1024, s = 75), ~7.7 us at
// 3.35 TB/s. A walk of every pair would cost Q * k * s slot tests, but a
// query box cuts few strata: on the serving queries 14.6 % of the 1-D
// pairs are covered, 85.2 % empty and 0.19 % mixed. With few strata of
// many slots (Table 1's US: k = 1, s = 38,500, every pair mixed) the slot
// tests bound it, Q * s of them, and every query tile reuses a staged
// chunk from shared memory.
//
// Design: pair_tiles.cuh, with the policy Moments below. A covered
// pair's (chunk's) moments are the stratum's (chunk's) totals [n_valid,
// sum a, sum a^2], summed in slot order through the same update, so the
// bits are those of a walk; an empty one's are +0.0, where a walk's
// accumulators would stay. The one-pass tile is (QT, LT, 3) floats, one
// plane: rows of LT * 12 contiguous bytes. Shared memory ~45 KB at d = 1,
// ~59 KB at d = 3, ~92 KB at d = 16 (one pass); at every d > 16, whose
// wide kernels take the columns in blocks of 16 (pair_tiles.cuh), ~54 KB
// (one pass) and 66-90 KB (chunk tiles, by Q).
#include "pair_tiles.cuh"

namespace {

// The per-slot update of every path: cnt + 1, sum + a, fma(a, a, sq) for
// a relevant slot; + 0.0 for another, which changes no bits (under
// round-to-nearest a sum that starts at +0.0 never reaches -0.0, and
// x + 0.0 = x for every other x), so the loops need no branch.
__device__ __forceinline__ void add_slot(float& cnt, float& sum, float& sq,
                                         float a, bool in) {
  const float x = in ? a : 0.f;
  cnt = __fadd_rn(cnt, in ? 1.f : 0.f);
  sum = __fadd_rn(sum, x);
  sq = __fmaf_rn(x, x, sq);
}

// [count, sum a, sum a^2] of the relevant slots, from +0.0.
struct Moments {
  static constexpr int STATS = 3, PLANES = 1, WIDTH = 3;
  float m0, m1, m2;
  __device__ void init() { m0 = m1 = m2 = 0.f; }
  __device__ void none() { m0 = m1 = m2 = 0.f; }
  __device__ void add(float a, bool in) { add_slot(m0, m1, m2, a, in); }
  __device__ void merge(const Moments& p) {
    m0 = __fadd_rn(m0, p.m0);
    m1 = __fadd_rn(m1, p.m1);
    m2 = __fadd_rn(m2, p.m2);
  }
  __device__ void save(float* t) const {
    t[0] = m0;
    t[1] = m1;
    t[2] = m2;
  }
  __device__ void load(const float* t) {
    m0 = t[0];
    m1 = t[1];
    m2 = t[2];
  }
  __device__ void fill(float* s_tile, int q, int l, bool inside) const {
    float* t = tile_at<Moments>(s_tile, 0, q, l);
    t[0] = inside ? m0 : 0.f;
    t[1] = inside ? m1 : 0.f;
    t[2] = inside ? m2 : 0.f;
  }
  __device__ void write(float* out, size_t pair, size_t) const {
    float* dst = out + pair * 3;
    dst[0] = m0;
    dst[1] = m1;
    dst[2] = m2;
  }
};

}  // namespace

// scratch: the wrapper's buffer of scratch_floats floats, at least
// repro_stratified_moments_scratch(Q, k, s, d) (none for s <= 2048).
extern "C" int repro_stratified_moments(const float* c, const float* a,
                                        const uint8_t* valid,
                                        const float* q_lo, const float* q_hi,
                                        float* out, float* scratch,
                                        long long scratch_floats, int Q,
                                        int k, int s, int d, void* stream) {
  if (Q < 1 || k < 1 || s < 0 || d < 1)
    return (int)cudaErrorInvalidValue;
  return launch_pair_tiles<Moments>(c, a, valid, q_lo, q_hi, out, scratch,
                                    scratch_floats, Q, k, s, d, stream);
}

// The order contract's chunk and the scratch a launch needs, for the
// wrapper to be checked against.
extern "C" int repro_stratified_moments_slot_chunk() { return SLOT_CHUNK; }
extern "C" long long repro_stratified_moments_scratch(int Q, int k, int s,
                                                      int d) {
  return pair_scratch_floats<Moments>(Q, k, s, d);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
