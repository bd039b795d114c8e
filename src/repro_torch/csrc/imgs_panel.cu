// imgs_panel: one classical Gram-Schmidt pass on a panel, for Hopper, the
// general route: a K whose slab of 8 rows does not fit in shared memory;
// the rest takes imgs_panel_sm90.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/imgs_panel/kernel.py
// imgs_panel_real (:76; bodies _proj_kernel :39, _update_kernel :57),
// which the TPU wrapper fed complex data through a 2N x 2K real embedding
// of Q built on every pass.
//
// Two dependent launches on Q (N x K) and the panel V (N x p), both
// row-major:
//   proj:    C  = Q^H V        (K, p)   one block per column k of Q
//   update:  V' = V - Q C      (N, p)   one thread per element of V'
//
// Bound on the H100: bytes.  Q is read once by each launch (the bound
// counts it once): at the blocked path's (10000, 108) complex64 that is
// 8.6 MB, 2.6 us at 3.35 TB/s; the flops (16 N K p) are far below the
// compute roof.  At this size the launches' fixed cost, not DRAM, is what
// the time will show.  What the design does about it:
//   * Native interleaved complex: no real embedding (which quadrupled Q)
//     and no plane copies.
//   * proj keeps PB accumulators per thread (PB the smallest of
//     {1, 2, 4, 8, 16, 32} that holds the panel; wider panels run as
//     column panels of 32), so each block reads its column of Q once for
//     the whole panel.  The reduction over N is a fixed shuffle tree in
//     each warp, then the warps' partial sums in a fixed order: no
//     atomics, so the same inputs give the same bits.
//   * update walks each row of Q in order; the threads of one row share
//     its loads, and C (K x p) stays in L1.
//   * Accumulation is in the working precision (float for f32/c64,
//     double for f64/c128).
#include "common.cuh"

namespace {

constexpr int PROJ_THREADS = 256;
constexpr int PROJ_WARPS = PROJ_THREADS / 32;
constexpr int UPDATE_THREADS = 256;
constexpr int PMAX = 32;

template <typename R, bool CPLX, int PB>
__global__ void __launch_bounds__(PROJ_THREADS)
    proj(const repro::elem_t<R, CPLX>* __restrict__ V, long long ldv, int p,
         const repro::elem_t<R, CPLX>* __restrict__ Q,
         repro::elem_t<R, CPLX>* __restrict__ C, long long ldc, long long N,
         long long K) {
  using E = repro::elem_t<R, CPLX>;
  __shared__ R sre[PROJ_WARPS][PB];
  __shared__ R sim[PROJ_WARPS][PB];
  const long long k = blockIdx.x;
  R re[PB], im[PB];
#pragma unroll
  for (int i = 0; i < PB; ++i) re[i] = im[i] = 0;
  for (long long n = threadIdx.x; n < N; n += PROJ_THREADS) {
    const E q = Q[n * K + k];
    const E* vrow = V + n * ldv;
#pragma unroll
    for (int i = 0; i < PB; ++i)
      if (i < p) repro::conj_mul_acc(q, vrow[i], re[i], im[i]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < PB; ++i) {
    for (int off = 16; off > 0; off >>= 1) {
      re[i] += __shfl_down_sync(0xffffffffu, re[i], off);
      im[i] += __shfl_down_sync(0xffffffffu, im[i], off);
    }
    if (lane == 0) {
      sre[warp][i] = re[i];
      sim[warp][i] = im[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < p) {
    R r = 0, m = 0;
    for (int w = 0; w < PROJ_WARPS; ++w) {
      r += sre[w][threadIdx.x];
      m += sim[w][threadIdx.x];
    }
    repro::put(C + k * ldc + threadIdx.x, r, m);
  }
}

template <typename R, bool CPLX>
__global__ void __launch_bounds__(UPDATE_THREADS)
    update(const repro::elem_t<R, CPLX>* __restrict__ V,
           const repro::elem_t<R, CPLX>* __restrict__ Q,
           const repro::elem_t<R, CPLX>* __restrict__ C,
           repro::elem_t<R, CPLX>* __restrict__ V_out, long long N,
           long long K, long long p) {
  const long long t = (long long)blockIdx.x * UPDATE_THREADS + threadIdx.x;
  if (t >= N * p) return;
  const long long n = t / p, i = t % p;
  const auto* qrow = Q + n * K;
  R re = 0, im = 0;
  for (long long k = 0; k < K; ++k)
    repro::mul_acc(qrow[k], C[k * p + i], re, im);
  R vr, vi;
  repro::get(V[t], vr, vi);
  repro::put(V_out + t, vr - re, vi - im);
}

template <typename R, bool CPLX, int PB>
cudaError_t launch_proj(const repro::elem_t<R, CPLX>* V, long long ld, int p,
                        const repro::elem_t<R, CPLX>* Q,
                        repro::elem_t<R, CPLX>* C, long long N, long long K,
                        cudaStream_t st) {
  proj<R, CPLX, PB><<<(unsigned)K, PROJ_THREADS, 0, st>>>(V, ld, p, Q, C,
                                                          ld, N, K);
  return cudaGetLastError();
}

template <typename R, bool CPLX>
int launch(const void* V_, const void* Q_, void* C_, void* V_out_,
           long long N, long long K, long long p, void* stream) {
  using E = repro::elem_t<R, CPLX>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const E* V = static_cast<const E*>(V_);
  const E* Q = static_cast<const E*>(Q_);
  E* C = static_cast<E*>(C_);
  // proj over column panels of at most PMAX: column i of C depends on
  // column i of V alone
  for (long long lo = 0; lo < p; lo += PMAX) {
    const int pp = (int)(p - lo < PMAX ? p - lo : PMAX);
    const E* v = V + lo;
    E* c = C + lo;
    cudaError_t err;
    if (pp <= 1)
      err = launch_proj<R, CPLX, 1>(v, p, pp, Q, c, N, K, st);
    else if (pp <= 2)
      err = launch_proj<R, CPLX, 2>(v, p, pp, Q, c, N, K, st);
    else if (pp <= 4)
      err = launch_proj<R, CPLX, 4>(v, p, pp, Q, c, N, K, st);
    else if (pp <= 8)
      err = launch_proj<R, CPLX, 8>(v, p, pp, Q, c, N, K, st);
    else if (pp <= 16)
      err = launch_proj<R, CPLX, 16>(v, p, pp, Q, c, N, K, st);
    else
      err = launch_proj<R, CPLX, 32>(v, p, pp, Q, c, N, K, st);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_out = N * p;
  update<R, CPLX><<<(unsigned)((n_out + UPDATE_THREADS - 1) / UPDATE_THREADS),
                    UPDATE_THREADS, 0, st>>>(V, Q, C,
                                             static_cast<E*>(V_out_), N, K, p);
  return (int)cudaGetLastError();
}

}  // namespace

#define IMGS_PANEL_ENTRY(NAME, R, CPLX)                                     \
  extern "C" int NAME(const void* V, const void* Q, void* C, void* V_out,   \
                      long long N, long long K, long long p, void* stream) { \
    return launch<R, CPLX>(V, Q, C, V_out, N, K, p, stream);                \
  }

IMGS_PANEL_ENTRY(imgs_panel_f32, float, false)
IMGS_PANEL_ENTRY(imgs_panel_f64, double, false)
IMGS_PANEL_ENTRY(imgs_panel_c64, float, true)
IMGS_PANEL_ENTRY(imgs_panel_c128, double, true)
