// wide_cols.cuh: the slot test of the wide kernels, those instantiated for
// more predicate columns than a block of WIDE_COLS (d > 16). Every d <= 16
// launch keeps its own code: query bounds and boxes in registers or shared
// memory arrays of 16 columns. Above that, a kernel takes the columns in
// blocks of WIDE_COLS, so that its registers and shared memory do not
// grow with d, and combines the blocks' flags by AND (inside, covered) or
// OR (apart). The compares are exact, so the order of the blocks changes
// no bit: a slot, a pair or a leaf gets the flags of the d <= 16 test.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIDE_COLS = 16;  // columns a block of the wide kernels

// Bit b is set iff slot b of the n <= 32 consecutive slots whose
// coordinates start at x (rows of d floats) lies inside [lo_j, hi_j] in
// every column j, bounds inclusive (NaN is never inside). lo / hi are a
// query's rows of d floats, or nullptr for the unbounded box (-inf, +inf),
// which holds every slot without a NaN coordinate. A block's bounds sit in
// registers; the loop stops once no slot is left inside. n <= 0: none.
__device__ __forceinline__ uint32_t slots_inside_wide(
    const float* __restrict__ x, int n, int d, const float* __restrict__ lo,
    const float* __restrict__ hi) {
  if (n <= 0) return 0u;
  const float inf = __int_as_float(0x7f800000);
  uint32_t m = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
  for (int j0 = 0; j0 < d && m != 0u; j0 += WIDE_COLS) {
    const int nj = min(WIDE_COLS, d - j0);
    float ql[WIDE_COLS], qh[WIDE_COLS];
#pragma unroll
    for (int j = 0; j < WIDE_COLS; ++j) {
      const bool on = j < nj && lo != nullptr;
      ql[j] = on ? lo[j0 + j] : -inf;
      qh[j] = on ? hi[j0 + j] : inf;
    }
    for (int b = 0; b < n; ++b) {
      const float* xb = x + (size_t)b * d + j0;
      bool in = true;
#pragma unroll
      for (int j = 0; j < WIDE_COLS; ++j)
        if (j < nj) in &= (ql[j] <= xb[j]) & (xb[j] <= qh[j]);
      if (!in) m &= ~(1u << b);
    }
  }
  return m;
}

}  // namespace
