// taylorf2: tiles of TaylorF2 waveform columns, generated on Hopper for the
// streamed RB-greedy (and for the resident snapshot matrix).
//
// Not a TPU kernel: the JAX package generates the same tiles with
// jax.jit(taylorf2_batch) (src/repro/data/providers.py:193-199,
// WaveformProvider, over src/repro/gw/waveform.py:62-98), code it leaves to
// XLA.  The port's plain version (gw/waveform.py::taylorf2_from_terms) is
// about forty separate float64 passes over the tile; the streamed driver
// regenerates every tile on every sweep, so that generator, not the sweep,
// would set the streamed build's time.
//
// The row terms of each frequency (f^(1/3), f^(-5/3), log(f)/3, f^(-7/6))
// and the column terms of each mass pair ((pi M)^(1/3), the prefactor,
// log(pi M)/3, the eta polynomials) are computed once per grid by
// gw/waveform.py::taylorf2_terms: rows (4, N) and cols (8, M), float64.
// An element is then, in float64, the operations of taylorf2_from_terms
// in the same order (each one rounded on its own: __dmul_rn / __dadd_rn,
// which the compiler does not fuse), one sincos, and the amplitude:
//   v = vM f13,  log v = lpm3 + lf3,
//   s = 1 + v^2 (a2 + v (a3 + v (a4 + v (a5 (1 + 3 log v)
//                                    + v (a6 - K6 log v + v a7))))),
//   psi = pre inv_f53 s - pi/4,
//   h = (amp cos psi, amp sin psi), rounded to the output type.
// With normalize, each column is scaled by 1 / sqrt(sum |h|^2) of its
// rounded values, rounded to the output's real type before the multiply.
//
// One column is the same bits whatever tile it is generated in: a block
// owns COLS = 32 columns (lane = column) and WARPS = 8 row groups (warp w
// takes rows w, w + 8, ...); each thread sums |h|^2 of its rows in order in
// float64, and warp 0 folds the 8 partial sums of a column in one fixed
// tree.  Nothing depends on the tile's width, its first column or the
// output's row stride.
//
// This is the general route; csrc/taylorf2_sm90.cu (one evaluation an
// element, the columns held across a cluster) takes every N whose slab
// fits in shared memory.  Bound on the H100: the float64 instruction
// issue.  A (10,000 x 65,536) complex64 tile writes 5.2 GB (1.57 ms at
// 3.35 TB/s); one evaluation of each element and its norm issue 49
// float64 instructions (ops.py::f64_instructions), 1.89 ms at 17 T a
// second.  This design evaluates every element of a normalized tile twice
// (the norm pass, then the scaled store) instead of reading the tile back,
// which doubles its operations.  What it does:
//   * no transcendental but the sincos per element: the powers and logs
//     are row or column terms;
//   * a warp writes one row's 32 neighbouring columns: 256 contiguous
//     bytes at complex64;
//   * the row terms are read as warp-wide broadcasts from L2 (4 N doubles
//     for the whole tile), the column terms once per thread.
#include "common.cuh"
#include "taylorf2.cuh"

namespace {

constexpr int COLS = 32;
constexpr int WARPS = 8;
constexpr int THREADS = COLS * WARPS;

using repro::tf2::ColTerms;
using repro::tf2::store;
using repro::tf2::stored_sq;

// one element from its row terms (rows: f13, inv_f53, log_f_3, amp)
__device__ __forceinline__ void element(const ColTerms& c, const double* rows,
                                        long long N, long long n, double& re,
                                        double& im) {
  repro::tf2::element(c, rows[n], rows[N + n], rows[2 * N + n],
                      rows[3 * N + n], re, im);
}

template <typename R>
__global__ void __launch_bounds__(THREADS)
    tile_kernel(const double* __restrict__ rows,
                const double* __restrict__ cols, long long N, long long M,
                long long lo, long long w, long long ld, int normalize,
                repro::elem_t<R, true>* __restrict__ out) {
  __shared__ double part[WARPS][COLS];
  __shared__ R scale[COLS];
  const int lane = threadIdx.x % COLS, warp = threadIdx.x / COLS;
  const long long j = (long long)blockIdx.x * COLS + lane;  // tile column
  const bool live = j < w;
  ColTerms c{};
  if (live) {  // vM, pre, log_piM_3, a2, a4, a5, a6, a7
    const double* p = cols + lo + j;
    c = ColTerms{p[0], p[M], p[2 * M], p[3 * M],
                 p[4 * M], p[5 * M], p[6 * M], p[7 * M]};
  }
  R sc = (R)1;
  if (normalize) {
    double acc = 0.0;
    if (live) {
      for (long long n = warp; n < N; n += WARPS) {
        double re, im;
        element(c, rows, N, n, re, im);
        acc = __dadd_rn(acc, stored_sq<R>(re, im));
      }
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0) {
      const double t = __dadd_rn(
          __dadd_rn(__dadd_rn(part[0][lane], part[1][lane]),
                    __dadd_rn(part[2][lane], part[3][lane])),
          __dadd_rn(__dadd_rn(part[4][lane], part[5][lane]),
                    __dadd_rn(part[6][lane], part[7][lane])));
      scale[lane] = (R)(1.0 / sqrt(t));
    }
    __syncthreads();
    sc = scale[lane];
  }
  if (!live) return;
  for (long long n = warp; n < N; n += WARPS) {
    double re, im;
    element(c, rows, N, n, re, im);
    store(out + n * ld + j, re, im, sc, normalize != 0);
  }
}

template <typename R>
int launch(const void* rows, const void* cols, long long N, long long M,
           long long lo, long long w, long long ld, int normalize, void* out,
           void* stream) {
  const unsigned blocks = (unsigned)((w + COLS - 1) / COLS);
  tile_kernel<R><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rows), static_cast<const double*>(cols), N,
      M, lo, w, ld, normalize, static_cast<repro::elem_t<R, true>*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

#define TAYLORF2_ENTRY(NAME, R)                                              \
  extern "C" int NAME(const void* rows, const void* cols, long long N,       \
                      long long M, long long lo, long long w, long long ld,  \
                      int normalize, void* out, void* stream) {              \
    return launch<R>(rows, cols, N, M, lo, w, ld, normalize, out, stream);   \
  }

TAYLORF2_ENTRY(taylorf2_tile_c64, float)
TAYLORF2_ENTRY(taylorf2_tile_c128, double)
