// greedy_update: the fused Eq.-(6.3) pivot-search sweep for Hopper, the
// general route: S whose rows TMA cannot address (odd M in complex64 /
// float64, M % 4 != 0 in float32, unaligned views); the rest takes
// greedy_update_lanes_sm90.cu.
//
// Replaces the Pallas TPU kernels src/repro/kernels/greedy_update/kernel.py
// greedy_update_real (:108, body _kernel_real :41) and
// greedy_update_complex (:147, body _kernel_complex :68).
//
// In one pass over S (N x M, row-major, the layout torch gives it):
//   c       = q^H S                      (M,)  dtype of S
//   acc_out = acc + |c|^2                (M,)  real
//   max_res = max(norms_sq - acc_out), argmax = its FIRST index.
//
// Bound on the H100: bytes.  Each element of S is read once and used for
// one (complex) multiply-add: 8 flops per 8 bytes at complex64, about
// 1 flop/byte against the card's ~20 fp32 flop/byte balance.  At the
// main path's (10000, 131072) complex64, S is 10.5 GB: 3.13 ms at
// 3.35 TB/s.  What the design does about it:
//   * S is read in place, interleaved complex as float2/double2 — no
//     re/im plane copies and no padding copies (the TPU wrapper
//     materialised both, tripling the traffic).  The ragged edge is a
//     bounds test: a column past M takes no part in the max.
//   * One thread per column; a warp reads 32 neighbouring columns of one
//     row, 256 contiguous bytes at complex64.  Eight rows are loaded
//     before they are used, so each thread keeps eight loads in flight.
//   * q is staged through shared memory in chunks of QCHUNK rows.
//   * Accumulation is in the working precision (double for f64/c128; the
//     TPU kernel summed those in f32), repro::conj_mul_acc a row and
//     greedy_update.cuh's acc + |c|^2, as in the other sweep kernels.
//   * An optional on-device flag (a bool; null means true) says whether
//     the sweep is live.  Each block reads it first; where it is false the
//     block skips S and writes what q = 0 gives: c = 0, acc_out = acc, and
//     its (max, first index) of norms - acc.  Every block reads the same
//     flag, so all take the same branch.
//   * The cross-block argmax is a second launch over the per-block
//     (max, index) pairs.  The comparison is a total order (larger value,
//     then smaller index), so the result is the same on every run and
//     equals the first-index argmax; no atomics.
#include <stdint.h>

#include "common.cuh"
#include "greedy_update.cuh"

namespace {

using repro::gu::better;

constexpr int THREADS = 256;
constexpr int QCHUNK = 1024;
constexpr int UNROLL = 8;
constexpr int REDUCE_THREADS = 1024;

// Block-wide (max, first index); the result is valid in thread 0.
template <typename R, int NT>
__device__ __forceinline__ void block_argmax(R& v, long long& i) {
  __shared__ R sv[NT / 32];
  __shared__ long long si[NT / 32];
  for (int off = 16; off > 0; off >>= 1) {
    R v2 = __shfl_down_sync(0xffffffffu, v, off);
    long long i2 = __shfl_down_sync(0xffffffffu, i, off);
    better(v, i, v2, i2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NT / 32; ++w) better(v, i, sv[w], si[w]);
  }
}

template <typename R, bool CPLX>
__global__ void __launch_bounds__(THREADS)
    sweep(const repro::elem_t<R, CPLX>* __restrict__ q,
          const repro::elem_t<R, CPLX>* __restrict__ S,
          const R* __restrict__ acc, const R* __restrict__ norms,
          const bool* __restrict__ active,
          repro::elem_t<R, CPLX>* __restrict__ c, R* __restrict__ acc_out,
          R* __restrict__ bmax, long long* __restrict__ bidx, long long N,
          long long M) {
  using E = repro::elem_t<R, CPLX>;
  __shared__ E qs[QCHUNK];
  const bool live = active == nullptr || *active;
  const long long col = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool ok = col < M;
  R re = 0, im = 0;
  for (long long n0 = 0; live && n0 < N; n0 += QCHUNK) {
    const int rows = (int)(N - n0 < QCHUNK ? N - n0 : QCHUNK);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += THREADS) qs[r] = q[n0 + r];
    __syncthreads();
    if (ok) {
      const E* p = S + n0 * M + col;
      int r = 0;
      for (; r + UNROLL <= rows; r += UNROLL) {
        E s[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) s[u] = p[(long long)(r + u) * M];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          repro::conj_mul_acc(qs[r + u], s[u], re, im);
      }
      for (; r < rows; ++r)
        repro::conj_mul_acc(qs[r], p[(long long)r * M], re, im);
    }
  }
  R v = -INFINITY;
  long long i = 0x7fffffffffffffffLL;
  if (ok) {
    repro::put(c + col, re, im);
    const R a = live ? repro::gu::add_abs2(acc[col], re, im) : acc[col];
    acc_out[col] = a;
    v = norms[col] - a;
    i = col;
  }
  block_argmax<R, THREADS>(v, i);
  if (threadIdx.x == 0) {
    bmax[blockIdx.x] = v;
    bidx[blockIdx.x] = i;
  }
}

template <typename R>
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_blocks(const R* __restrict__ bmax,
                  const long long* __restrict__ bidx, int nb,
                  R* __restrict__ out_max, long long* __restrict__ out_idx) {
  R v = -INFINITY;
  long long i = 0x7fffffffffffffffLL;
  for (int b = threadIdx.x; b < nb; b += REDUCE_THREADS)
    better(v, i, bmax[b], bidx[b]);
  block_argmax<R, REDUCE_THREADS>(v, i);
  if (threadIdx.x == 0) {
    *out_max = v;
    *out_idx = i;
  }
}

template <typename R, bool CPLX>
int launch(const void* q, const void* S, const void* acc, const void* norms,
           const void* active, void* c, void* acc_out, void* bmax,
           void* bidx, void* out_max,
           void* out_idx, long long N, long long M, void* stream) {
  using E = repro::elem_t<R, CPLX>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (int)((M + THREADS - 1) / THREADS);
  sweep<R, CPLX><<<nb, THREADS, 0, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(S),
      static_cast<const R*>(acc), static_cast<const R*>(norms),
      static_cast<const bool*>(active), static_cast<E*>(c),
      static_cast<R*>(acc_out), static_cast<R*>(bmax),
      static_cast<long long*>(bidx), N, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_blocks<R><<<1, REDUCE_THREADS, 0, st>>>(
      static_cast<const R*>(bmax), static_cast<const long long*>(bidx), nb,
      static_cast<R*>(out_max), static_cast<long long*>(out_idx));
  return (int)cudaGetLastError();
}

}  // namespace

// Number of per-block (max, index) pairs the caller allocates as scratch.
extern "C" long long greedy_update_num_blocks(long long M) {
  return (M + THREADS - 1) / THREADS;
}

// q (N,), S (N, M) row-major; `active` a device bool or null (true).
// Returns the CUDA error of the launches (0: none).
#define GREEDY_UPDATE_ENTRY(NAME, R, CPLX)                                   \
  extern "C" int NAME(const void* q, const void* S, const void* acc,         \
                      const void* norms, const void* active, void* c,        \
                      void* acc_out, void* bmax, void* bidx, void* out_max,  \
                      void* out_idx, long long N, long long M,               \
                      void* stream) {                                        \
    return launch<R, CPLX>(q, S, acc, norms, active, c, acc_out, bmax, bidx, \
                           out_max, out_idx, N, M, stream);                  \
  }

GREEDY_UPDATE_ENTRY(greedy_update_f32, float, false)
GREEDY_UPDATE_ENTRY(greedy_update_f64, double, false)
GREEDY_UPDATE_ENTRY(greedy_update_c64, float, true)
GREEDY_UPDATE_ENTRY(greedy_update_c128, double, true)
