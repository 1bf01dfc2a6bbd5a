// wide_cols.cuh: the slot test of the wide kernels, those instantiated for
// more predicate columns than a block of WIDE_COLS (d > 16). Every d <= 16
// launch keeps its own code: query bounds and boxes in registers or shared
// memory arrays of 16 columns. Above that, a kernel takes the columns in
// blocks of WIDE_COLS, so that its registers and shared memory do not
// grow with d, and combines the blocks' flags by AND (inside, covered) or
// OR (apart). The compares are exact, so the order of the blocks changes
// no bit: a slot, a pair or a leaf gets the flags of the d <= 16 test.
//
// Cut columns (rows 2 and 8, pair_tiles.cuh; rows 3 and 4, a (query,
// segment) pair's own, weighted_moments.cu; row 9 keeps its own list of
// JCUT columns, join_moments.cu). A (query, leaf) pair whose
// query box holds the extent of the leaf's valid slots in column j, where
// no valid slot has a NaN coordinate, passes column j for every valid
// slot: lo_j <= min <= c_j <= max <= hi_j, with the slot test's own
// compares, which see neither the sign of a zero nor an order among NaNs.
// So only the columns that cut the pair (the query does not hold the
// extent there, or a valid slot has NaN there) can clear a valid slot's
// bit, and testing those alone gives every slot the bit of the test over
// all d columns; an invalid slot's bit is cleared by its valid byte.
// Testing more columns than those changes no bit either, so a walk may
// test a superset: the one pass keeps, for each query of a tile, the
// columns that cut any of its pairs with the tile's 16 leaves; the chunk
// tiles keep each (query, chunk)'s own. Up to CUT_MAX columns go in a cut
// word (16 bits a column, the last ones appended in the low bits, 0xffff
// where none); past that, or at d > CUT_COLS, the word is CUT_ALL and the
// walk tests every column, the same walk on a slower branch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIDE_COLS = 16;  // columns a block of the wide kernels
constexpr int CUT_MAX = 4;     // cut columns a listed pair keeps
constexpr int CUT_COLS = 1024; // columns up to which pairs keep their cuts
constexpr uint64_t CUT_NONE = ~0ull;                 // no column yet
constexpr uint64_t CUT_ALL = 0xfffefffefffefffeull;  // test every column
static_assert(CUT_MAX == 4, "a cut word holds four 16-bit columns");

// The cut word cw with column j appended: CUT_ALL once it already held
// CUT_MAX columns (the pair then tests every column), and from then on.
__device__ __forceinline__ uint64_t add_cut(uint64_t cw, int j) {
  return cw == CUT_ALL || (cw >> 48) != 0xffffu ? CUT_ALL
                                                : cw << 16 | (uint64_t)j;
}

// Column t of a cut word: < CUT_COLS for a column, larger for none.
__device__ __forceinline__ int cut_col(uint64_t cw, int t) {
  return (int)(cw >> (16 * t)) & 0xffff;
}

// Bit b set iff lo <= row[b] <= hi for the 32 floats of row (16-byte
// aligned): a staged column of 32 consecutive slots.
__device__ __forceinline__ uint32_t row_bits(const float* row, float lo,
                                             float hi) {
  uint32_t bits = 0u;
#pragma unroll
  for (int b = 0; b < 32; b += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + b);
    bits |= (uint32_t)((lo <= x.x) & (x.x <= hi)) << b |
            (uint32_t)((lo <= x.y) & (x.y <= hi)) << (b + 1) |
            (uint32_t)((lo <= x.z) & (x.z <= hi)) << (b + 2) |
            (uint32_t)((lo <= x.w) & (x.w <= hi)) << (b + 3);
  }
  return bits;
}

// The bits of m (slots of a staged row of 32) whose slot lies inside [lo,
// hi]: the held slots tested one by one.
__device__ __forceinline__ uint32_t held_bits(const float* row, uint32_t m,
                                              float lo, float hi) {
  uint32_t keep = 0u;
  for (uint32_t b = m; b != 0u; b &= b - 1u) {
    const int i = __ffs(b) - 1;
    keep |= (uint32_t)((lo <= row[i]) & (row[i] <= hi)) << i;
  }
  return keep;
}

}  // namespace
