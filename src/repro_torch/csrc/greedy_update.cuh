// Per-column arithmetic shared by the Eq.-(6.3) sweep kernels
// (greedy_update.cu, greedy_update_lanes_sm90.cu).
//
// A column's bits are those of its row loop (repro::conj_mul_acc over the
// rows in order, explicit fmaf / fma) and of the epilogue below, written
// with round-to-nearest intrinsics so that nvcc's FMA contraction cannot
// fuse a product into the sum differently in one kernel than in another:
// every kernel that includes this header gives a column the same c and
// acc_out.  The (max, first index) comparison is a total order, so a fold
// of per-CTA pairs gives the first-index argmax in any order.
#pragma once

#include <cuda_runtime.h>

namespace repro::gu {

// acc + (re * re + im * im), each operation rounded on its own.  A real
// column passes im = 0 (adding +0 to a square keeps its bits).
__device__ __forceinline__ float add_abs2(float acc, float re, float im) {
  return __fadd_rn(acc, __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}
__device__ __forceinline__ double add_abs2(double acc, double re,
                                           double im) {
  return __dadd_rn(acc, __dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im)));
}

// (v, i) <- the better of (v, i) and (v2, i2): the larger value, then the
// smaller index.
template <typename R>
__device__ __forceinline__ void better(R& v, long long& i, R v2,
                                       long long i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

}  // namespace repro::gu
