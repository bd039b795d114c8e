// block_sweep: the fused blocked Eq.-(6.3) sweep for Hopper.
//
// Replaces the Pallas TPU kernels src/repro/kernels/block_sweep/kernel.py
// block_sweep_real (:86, body _kernel_real :35) and block_sweep_complex
// (:119, body _kernel_complex :55).
//
// In one pass over S (N x M, row-major, the layout torch gives it), for a
// block of p new basis vectors Qnew (N x p, row-major):
//   C       = Qnew^H S                 (p, M)  dtype of S
//   acc_out = acc + sum_i |C_i|^2      (M,)    real
// Zero columns of Qnew (rejected candidates) are exact no-ops.
//
// Bound on the H100: bytes at the blocked path's widths.  Each element of
// S is read once and used for p (complex) multiply-adds: at complex64 that
// is 8p flops per 8 bytes.  At the main path's (N, M) = (10000, 131072)
// and p = 8, S is 10.5 GB (3.13 ms at 3.35 TB/s) and the flops are 8.4e10
// (1.25 ms at 67 TFLOP/s fp32 outside the tensor cores).  What the design
// does about it:
//   * S is read in place, interleaved complex as float2/double2: no re/im
//     planes and no padded copies (the TPU wrapper built both).
//   * One thread per column of S; a warp reads 32 neighbouring columns of
//     one row (256 contiguous bytes at complex64), UNROLL rows in flight.
//   * Each thread keeps PB complex accumulators in registers, PB the
//     smallest of {1, 2, 4, 8, 16, 32} that holds p.  A tile of ROWS rows
//     of Qnew is staged in shared memory, zero-padded to PB columns, and
//     read as a broadcast (every thread of a warp reads the same word).
//   * acc_out is fused into the same pass: no second read of C.
//   * p > 32 runs as panels of 32 rows of C, the later panels adding into
//     acc_out (correct, one more read of S per panel).
//   * Accumulation is in the working precision (double for f64/c128; the
//     TPU kernel summed those in f32), in a fixed order: no atomics.
// wgmma and a TMA ring are later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 32;    // rows of Qnew staged in shared memory per step
constexpr int UNROLL = 8;   // rows of S loaded before they are used
constexpr int PMAX = 32;    // widest panel one launch handles

template <typename R, bool CPLX, int PB>
__global__ void __launch_bounds__(THREADS)
    sweep(const repro::elem_t<R, CPLX>* __restrict__ Qnew, long long ldq,
          int p, const repro::elem_t<R, CPLX>* __restrict__ S,
          const R* acc, repro::elem_t<R, CPLX>* __restrict__ C,
          R* acc_out, long long N, long long M) {
  using E = repro::elem_t<R, CPLX>;
  __shared__ __align__(16) E qs[ROWS][PB];
  const long long col = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool ok = col < M;
  R re[PB], im[PB];
#pragma unroll
  for (int i = 0; i < PB; ++i) re[i] = im[i] = 0;
  for (long long n0 = 0; n0 < N; n0 += ROWS) {
    const int rows = (int)(N - n0 < ROWS ? N - n0 : ROWS);
    __syncthreads();
    for (int t = threadIdx.x; t < ROWS * PB; t += THREADS) {
      const int r = t / PB, i = t % PB;
      qs[r][i] = (r < rows && i < p) ? Qnew[(n0 + r) * ldq + i] : E{};
    }
    __syncthreads();
    if (!ok) continue;
    const E* ps = S + n0 * M + col;
    int r = 0;
    for (; r + UNROLL <= rows; r += UNROLL) {
      E s[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) s[u] = ps[(long long)(r + u) * M];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int i = 0; i < PB; ++i)
          repro::conj_mul_acc(qs[r + u][i], s[u], re[i], im[i]);
      }
    }
    for (; r < rows; ++r) {
      const E s = ps[(long long)r * M];
#pragma unroll
      for (int i = 0; i < PB; ++i)
        repro::conj_mul_acc(qs[r][i], s, re[i], im[i]);
    }
  }
  if (!ok) return;
  R sq = 0;
#pragma unroll
  for (int i = 0; i < PB; ++i) {
    if (i < p) {
      repro::put(C + (long long)i * M + col, re[i], im[i]);
      sq += re[i] * re[i] + im[i] * im[i];
    }
  }
  acc_out[col] = acc[col] + sq;
}

template <typename R, bool CPLX, int PB>
cudaError_t launch_panel(const repro::elem_t<R, CPLX>* Qnew, long long ldq,
                         int p, const repro::elem_t<R, CPLX>* S,
                         const R* acc, repro::elem_t<R, CPLX>* C, R* acc_out,
                         long long N, long long M, cudaStream_t st) {
  const unsigned nb = (unsigned)((M + THREADS - 1) / THREADS);
  sweep<R, CPLX, PB><<<nb, THREADS, 0, st>>>(Qnew, ldq, p, S, acc, C,
                                             acc_out, N, M);
  return cudaGetLastError();
}

template <typename R, bool CPLX>
int launch(const void* Qnew_, const void* S_, const void* acc_, void* C_,
           void* acc_out_, long long N, long long M, long long p,
           void* stream) {
  using E = repro::elem_t<R, CPLX>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const E* Qnew = static_cast<const E*>(Qnew_);
  const E* S = static_cast<const E*>(S_);
  E* C = static_cast<E*>(C_);
  R* acc_out = static_cast<R*>(acc_out_);
  for (long long lo = 0; lo < p; lo += PMAX) {
    const int pp = (int)(p - lo < PMAX ? p - lo : PMAX);
    // later panels add into what the earlier ones wrote (same thread reads
    // then writes each column, so in place is safe)
    const R* acc = lo == 0 ? static_cast<const R*>(acc_) : acc_out;
    const E* q = Qnew + lo;
    E* c = C + lo * M;
    cudaError_t err;
    if (pp <= 1)
      err = launch_panel<R, CPLX, 1>(q, p, pp, S, acc, c, acc_out, N, M, st);
    else if (pp <= 2)
      err = launch_panel<R, CPLX, 2>(q, p, pp, S, acc, c, acc_out, N, M, st);
    else if (pp <= 4)
      err = launch_panel<R, CPLX, 4>(q, p, pp, S, acc, c, acc_out, N, M, st);
    else if (pp <= 8)
      err = launch_panel<R, CPLX, 8>(q, p, pp, S, acc, c, acc_out, N, M, st);
    else if (pp <= 16)
      err = launch_panel<R, CPLX, 16>(q, p, pp, S, acc, c, acc_out, N, M, st);
    else
      err = launch_panel<R, CPLX, 32>(q, p, pp, S, acc, c, acc_out, N, M, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

#define BLOCK_SWEEP_ENTRY(NAME, R, CPLX)                                    \
  extern "C" int NAME(const void* Qnew, const void* S, const void* acc,     \
                      void* C, void* acc_out, long long N, long long M,     \
                      long long p, void* stream) {                          \
    return launch<R, CPLX>(Qnew, S, acc, C, acc_out, N, M, p, stream);      \
  }

BLOCK_SWEEP_ENTRY(block_sweep_f32, float, false)
BLOCK_SWEEP_ENTRY(block_sweep_f64, double, false)
BLOCK_SWEEP_ENTRY(block_sweep_c64, float, true)
BLOCK_SWEEP_ENTRY(block_sweep_c128, double, true)
