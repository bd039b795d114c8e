// imgs_project: one classical Gram-Schmidt pass for Hopper, the general
// route: K whose slab of 8 rows does not fit in shared memory; the rest
// takes imgs_project_sm90.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/imgs_project/kernel.py
// imgs_project_real (:67; bodies _proj_kernel :31, _update_kernel :48),
// which the TPU wrapper also fed complex data through a 2N x 2K real
// embedding of Q built on every pass.
//
// Two dependent launches on Q (N x K, row-major) and v (N,):
//   proj:    c  = Q^H v        (K,)   one block per column k
//   update:  v' = v - Q c      (N,)   one warp per row n
//
// Bound on the H100: bytes.  Q is read once by each launch (the bound
// counts it once): at the main path's (10000, 100) complex64 that is
// 8 MB, 2.4 us at 3.35 TB/s; the flops (16 N K) are negligible.  At this
// size the launches' fixed cost, not DRAM, is what the time will show.
// What the design does about it:
//   * Native interleaved complex: no real embedding (which quadrupled Q)
//     and no plane copies.
//   * proj reduces over N with one block per k: each thread sums a
//     strided set of rows, then a fixed-shape shared-memory tree adds the
//     partial sums.  No atomics, so the same inputs give the same bits.
//     The strided column reads waste most of each 32-byte sector, but
//     the K blocks together touch Q once and it stays in the 50 MB L2.
//   * update reads each row of Q contiguously (a warp's lanes walk k) and
//     reduces with a fixed shuffle tree.
//   * Accumulation is in the working precision (float for f32/c64,
//     double for f64/c128).
//   * An optional on-device flag (a bool; null means true) says whether
//     the pass is live.  Each block of both launches reads it first; where
//     it is false the block skips Q and writes what Q = 0 gives: c = 0 and
//     v' = v.
#include "common.cuh"

namespace {

constexpr int PROJ_THREADS = 256;
constexpr int UPDATE_THREADS = 256;

template <typename R, bool CPLX>
__global__ void __launch_bounds__(PROJ_THREADS)
    proj(const repro::elem_t<R, CPLX>* __restrict__ v,
         const repro::elem_t<R, CPLX>* __restrict__ Q,
         const bool* __restrict__ active,
         repro::elem_t<R, CPLX>* __restrict__ c, long long N, long long K) {
  __shared__ R sre[PROJ_THREADS];
  __shared__ R sim[PROJ_THREADS];
  const long long k = blockIdx.x;
  if (active != nullptr && !*active) {  // the same in every block
    if (threadIdx.x == 0) repro::put(c + k, R(0), R(0));
    return;
  }
  R re = 0, im = 0;
  for (long long n = threadIdx.x; n < N; n += PROJ_THREADS)
    repro::conj_mul_acc(Q[n * K + k], v[n], re, im);
  sre[threadIdx.x] = re;
  sim[threadIdx.x] = im;
  __syncthreads();
  for (int s = PROJ_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sre[threadIdx.x] += sre[threadIdx.x + s];
      sim[threadIdx.x] += sim[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) repro::put(c + k, sre[0], sim[0]);
}

template <typename R, bool CPLX>
__global__ void __launch_bounds__(UPDATE_THREADS)
    update(const repro::elem_t<R, CPLX>* __restrict__ v,
           const repro::elem_t<R, CPLX>* __restrict__ Q,
           const repro::elem_t<R, CPLX>* __restrict__ c,
           const bool* __restrict__ active,
           repro::elem_t<R, CPLX>* __restrict__ v_out, long long N,
           long long K) {
  const long long row =
      (long long)blockIdx.x * (UPDATE_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // whole warps leave together; no block barrier
  if (active != nullptr && !*active) {
    if (lane == 0) v_out[row] = v[row];
    return;
  }
  R re = 0, im = 0;
  const auto* qrow = Q + row * K;
  for (long long k = lane; k < K; k += 32)
    repro::mul_acc(qrow[k], c[k], re, im);
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_down_sync(0xffffffffu, re, off);
    im += __shfl_down_sync(0xffffffffu, im, off);
  }
  if (lane == 0) {
    R vr, vi;
    repro::get(v[row], vr, vi);
    repro::put(v_out + row, vr - re, vi - im);
  }
}

template <typename R, bool CPLX>
int launch(const void* v, const void* Q, const void* active, void* c,
           void* v_out, long long N, long long K, void* stream) {
  using E = repro::elem_t<R, CPLX>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool* flag = static_cast<const bool*>(active);
  proj<R, CPLX><<<(unsigned)K, PROJ_THREADS, 0, st>>>(
      static_cast<const E*>(v), static_cast<const E*>(Q), flag,
      static_cast<E*>(c), N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = UPDATE_THREADS / 32;
  update<R, CPLX><<<(unsigned)((N + rows_per_block - 1) / rows_per_block),
                    UPDATE_THREADS, 0, st>>>(
      static_cast<const E*>(v), static_cast<const E*>(Q),
      static_cast<const E*>(c), flag, static_cast<E*>(v_out), N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// v (N,), Q (N, K) row-major; `active` a device bool or null (true); c (K,)
// and v_out (N,) written.  Returns the CUDA error of the launches (0: none).
#define IMGS_PROJECT_ENTRY(NAME, R, CPLX)                                   \
  extern "C" int NAME(const void* v, const void* Q, const void* active,     \
                      void* c, void* v_out, long long N, long long K,       \
                      void* stream) {                                       \
    return launch<R, CPLX>(v, Q, active, c, v_out, N, K, stream);           \
  }

IMGS_PROJECT_ENTRY(imgs_project_f32, float, false)
IMGS_PROJECT_ENTRY(imgs_project_f64, double, false)
IMGS_PROJECT_ENTRY(imgs_project_c64, float, true)
IMGS_PROJECT_ENTRY(imgs_project_c128, double, true)
