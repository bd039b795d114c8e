// roq_apply: the ROQ serving interpolant apply, out = B @ F, for Hopper.
//
// Replaces the XLA GEMMs of the JAX serving engine
// (src/repro/serving/roq.py:115-122, _apply_real / _apply_split); that
// apply was never a Pallas kernel.  It is a kernel here because the
// engine promises that a request answered inside a zero-padded batch
// bucket has exactly the bits of its unpadded direct evaluation, so each
// output column must not depend on the batch width.  cuBLAS keeps no such
// promise: at complex128 its result for a column changes with the width
// (widths 24 to 36 at k = 8, measured on an H100).
//
// B is the (N, k) interpolant, F the (k, nb) batch at the EIM nodes, out
// (N, nb); all row-major, complex interleaved (float2 / double2).
//   out[n, b] = sum_{j < k} B[n, j] * F[j, b]
// summed over j = 0 .. k-1 in that order by one thread, in the working
// precision (float for f32 / c64, double for f64 / c128), no atomics: the
// bits of out[n, b] depend on row n of B and column b of F only.
//
// Bound on the H100: bytes.  B is read once (N k elements: 6.6 MB at the
// GW basis, N = 10,000, k = 83, complex64) and out written once (N nb
// elements); the flops, 8 N k nb at complex64, are ~5 us at 67 TFLOP/s
// for nb = 64, against ~3.5 us of bytes.  What the design does about it:
//   * one thread per (row group, column): the ROWS rows of a group share
//     each load of F[j, b], which stays in registers for ROWS multiply-adds;
//   * neighbouring threads take neighbouring columns b, so a warp reads
//     F[j, :] contiguously and reads each B[n, j] as one broadcast;
//   * rows of B are read along j by the same thread: consecutive loads of
//     one row fall in the same cache lines, which L1 keeps.
// This is the general route: csrc/roq_apply_sm90.cu (a panel of B and all
// of F in shared memory, the same sums in the same order, so the same
// bits) takes every (k, nb) whose F fits in shared memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 8;   // rows of B (and out) per thread

template <typename R, bool CPLX>
__global__ void __launch_bounds__(THREADS)
    apply(const repro::elem_t<R, CPLX>* __restrict__ B,
          const repro::elem_t<R, CPLX>* __restrict__ F,
          repro::elem_t<R, CPLX>* __restrict__ out, long long N, long long k,
          long long nb) {
  using E = repro::elem_t<R, CPLX>;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long groups = (N + ROWS - 1) / ROWS;
  if (idx >= groups * nb) return;
  const long long g = idx / nb, b = idx % nb;
  const long long n0 = g * ROWS;
  const int rows = (int)(N - n0 < ROWS ? N - n0 : ROWS);
  R re[ROWS], im[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) re[r] = im[r] = 0;
  const E* pb = B + n0 * k;
  for (long long j = 0; j < k; ++j) {
    const E f = F[j * nb + b];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows) repro::mul_acc(pb[r * k + j], f, re[r], im[r]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (r < rows) repro::put(out + (n0 + r) * nb + b, re[r], im[r]);
}

template <typename R, bool CPLX>
int launch(const void* B, const void* F, void* out, long long N, long long k,
           long long nb, void* stream) {
  using E = repro::elem_t<R, CPLX>;
  const long long threads = (N + ROWS - 1) / ROWS * nb;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  apply<R, CPLX><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(B), static_cast<const E*>(F),
      static_cast<E*>(out), N, k, nb);
  return (int)cudaGetLastError();
}

}  // namespace

#define ROQ_APPLY_ENTRY(NAME, R, CPLX)                                       \
  extern "C" int NAME(const void* B, const void* F, void* out, long long N,  \
                      long long k, long long nb, void* stream) {             \
    return launch<R, CPLX>(B, F, out, N, k, nb, stream);                     \
  }

ROQ_APPLY_ENTRY(roq_apply_f32, float, false)
ROQ_APPLY_ENTRY(roq_apply_f64, double, false)
ROQ_APPLY_ENTRY(roq_apply_c64, float, true)
ROQ_APPLY_ENTRY(roq_apply_c128, double, true)
