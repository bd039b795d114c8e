// imgs_project_sm90: one classical Gram-Schmidt pass for Hopper in one
// co-resident launch, the route of every K whose slab of 8 rows fits in
// shared memory.
//
// Replaces, with imgs_project.cu (the general route), the Pallas TPU kernel
// src/repro/kernels/imgs_project/kernel.py imgs_project_real (:67; bodies
// _proj_kernel :31, _update_kernel :48), which the TPU wrapper fed complex
// data through a 2N x 2K real embedding of Q built on every pass.  Same
// function as imgs_project.cu and ref.py, on Q (N x K, row-major) and v
// (N,):
//   c  = Q^H v        (K,)
//   v' = v - Q c      (N,)
//
// Bound on the H100: bytes.  Q is read once: at the greedy path's
// (10000, 100) complex64 that is 8 MB, 2.4 us at 3.35 TB/s; the flops
// (16 N K) are far below the compute roof.  What the design does about it:
//   * One launch, and Q read from DRAM once.  Each CTA owns R consecutive
//     rows (the wrapper gives each SM one CTA: R = 76 at N = 10,000, 132
//     CTAs).  Because Q is row-major the rows are R x K contiguous elements:
//     the CTA copies them into shared memory with cp.async in whole 16-byte
//     sectors (the ragged head and tail in 4-byte words), computes its
//     partial c_b = Q_b^H v_b, and keeps the slab there through the update.
//     Rows that do not fit (N beyond the SMs' shared memory) are taken in
//     chunks of T rows; the last stays resident and the others are copied
//     again for the update.
//   * Each CTA writes its partial (K values, padded to 16 bytes) to scratch
//     that the wrapper owns, then waits at one grid-wide barrier on a
//     counter that the wrapper owns (one atomic per CTA; it flips the
//     counter's top bit and leaves its low bits at 0).  The launch is
//     cooperative (cudaLaunchCooperativeKernel), so every CTA is
//     resident and the barrier cannot hang; a grid that cannot be resident
//     fails to launch.
//   * Every CTA folds the partials in the same fixed order (each thread a
//     16-byte vector of outputs over a fixed range of slabs, the ranges then
//     summed in order), so every CTA holds the same bits of c; CTA 0 writes
//     c.  The only atomic is the barrier's integer add.
//   * The update: a warp takes ROWS_AT_ONCE rows of the resident slab at
//     once, its lanes over k, then a fixed shuffle tree per row;
//     v' = v - Q_b c.
//   * Native interleaved complex; every sum in the working precision (FP32
//     FMA for float32 / complex64, no tensor cores, no TF32; double for
//     float64 / complex128).
//   * An optional on-device flag (a bool; null means true) says whether the
//     pass is live.  Each CTA reads it first; where it is false the CTA
//     writes what Q = 0 gives (v' = v, and c = 0 from CTA 0) and returns
//     before the barrier, without reading Q.  Every CTA reads the same
//     flag, so either all meet at the barrier or none does.
#include "common.cuh"
#include "sm90.cuh"

#include <stdint.h>

namespace {

using repro::sm90::smem_u32;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PARTS = 32;  // most row (projection) or slab (fold) ranges
constexpr int LOADS = 8;   // partial vectors in flight per folding thread
constexpr int ROWS_AT_ONCE = 5;  // rows a warp of the update sums at once

template <typename R>
using vec_t = std::conditional_t<std::is_same_v<R, float>, float4, double2>;

__device__ __forceinline__ float4 to_vec(const float (&a)[4]) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ double2 to_vec(const double (&a)[2]) {
  return make_double2(a[0], a[1]);
}

__host__ __device__ constexpr long long round16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared memory of a CTA: c (K, padded to 16 bytes), the ranges' sums
// (THREADS vectors of 16 bytes), v's chunk (T) and Q's chunk (T x K, after
// up to 16 bytes that align it like its source), in elements of `itemsize`
// bytes.
constexpr long long smem_bytes(long long K, long long T, long long itemsize) {
  return round16(K * itemsize) + THREADS * 16LL + round16(T * itemsize) + 16 +
         T * K * itemsize;
}

__device__ __forceinline__ void cp_async4(unsigned char* dst,
                                          const unsigned char* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned char* dst,
                                           const unsigned char* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Rows [r0, r0 + rows) of Q into shared memory at `raw` (16-byte aligned,
// 16 bytes of slack), placed at the source's address mod 16 so that the
// middle goes in 16-byte copies (the ragged head and tail in 4-byte
// words); returns where row r0 lands.  The caller waits with wait_copies.
template <typename E>
__device__ __forceinline__ const E* load_rows(unsigned char* raw, const E* Q,
                                              long long r0, int rows, int K) {
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(Q + r0 * K);
  unsigned char* dst = raw + (reinterpret_cast<uintptr_t>(src) & 15);
  const long long bytes = (long long)rows * K * (long long)sizeof(E);
  const long long mis = (16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15;
  const long long head = mis < bytes ? mis : bytes;
  const long long body_end = head + ((bytes - head) & ~15LL);
  for (long long b = 4LL * threadIdx.x; b < head; b += 4LL * THREADS)
    cp_async4(dst + b, src + b);
  for (long long b = head + 16LL * threadIdx.x; b < body_end;
       b += 16LL * THREADS)
    cp_async16(dst + b, src + b);
  for (long long b = body_end + 4LL * threadIdx.x; b < bytes;
       b += 4LL * THREADS)
    cp_async4(dst + b, src + b);
  asm volatile("cp.async.commit_group;" ::: "memory");
  return reinterpret_cast<const E*>(dst);
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every CTA of the (co-resident) grid waits here until all have arrived;
// the writes of each before it are visible to the reads of all after it.
// One atomic per CTA on a counter of its own (the wrapper's): CTA 0 adds
// 2^31 - (n - 1) and the others 1, so the n arrivals add 2^31 and flip the
// counter's top bit, which every CTA waits for.  The low bits return to 0,
// so the counter needs no reset.  A wait of seconds means a CTA that never
// arrives: the kernel traps (a launch error) rather than hang the card.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned n = gridDim.x;
    __threadfence();
    const unsigned old =
        atomicAdd(bar, blockIdx.x == 0 ? 0x80000000u - (n - 1) : 1u);
    for (long long spins = 0;
         ((load_acquire(bar) ^ old) & 0x80000000u) == 0; ++spins)
      if (spins > (1LL << 22)) __trap();
    __threadfence();
  }
  __syncthreads();
}

// The projection's sums over a chunk's rows: with parts == 1 each thread's
// k (k = threadIdx.x, + THREADS, ...) into cs[k]; else row range pj of
// k = pk (rows n = pj mod parts, in order) into (re, im).
template <typename R, bool CPLX>
__device__ __forceinline__ void project_rows(const repro::elem_t<R, CPLX>* q,
                                             const repro::elem_t<R, CPLX>* vs,
                                             int rows, int K, int parts,
                                             int pk, int pj,
                                             repro::elem_t<R, CPLX>* cs,
                                             R& re, R& im) {
  if (parts == 1) {
    for (int k = threadIdx.x; k < K; k += THREADS) {
      R sr = 0, si = 0, cr, ci;
#pragma unroll 4
      for (int n = 0; n < rows; ++n)
        repro::conj_mul_acc(q[(long long)n * K + k], vs[n], sr, si);
      repro::get(cs[k], cr, ci);
      repro::put(cs + k, cr + sr, ci + si);
    }
    return;
  }
  if (pj >= parts) return;
#pragma unroll 4
  for (int n = pj; n < rows; n += parts)
    repro::conj_mul_acc(q[(long long)n * K + pk], vs[n], re, im);
}

// acc += src[s nv + o] for s in [s0, s1), in order of s, LOADS in flight.
template <typename R>
__device__ __forceinline__ void sum_slabs(const vec_t<R>* src, int nv, int o,
                                          int s0, int s1,
                                          R (&acc)[16 / sizeof(R)]) {
  constexpr int NR = 16 / sizeof(R);
  for (int s = s0; s < s1; s += LOADS) {
    vec_t<R> x[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (s + u < s1) x[u] = __ldcg(src + (long long)(s + u) * nv + o);
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (s + u < s1) {
        const R* r = reinterpret_cast<const R*>(&x[u]);
#pragma unroll
        for (int e = 0; e < NR; ++e) acc[e] += r[e];
      }
  }
}

// cs = the sum of the grid's partials (nv vectors of 16 bytes each), in an
// order fixed by nv and the grid alone: the same bits in every CTA.
template <typename R>
__device__ __forceinline__ void fold(const vec_t<R>* partials, int nv,
                                     vec_t<R>* cs, vec_t<R>* red) {
  constexpr int NR = 16 / sizeof(R);
  const int n = (int)gridDim.x;
  int parts = nv * 2 > THREADS ? 1 : THREADS / nv;
  parts = parts < PARTS ? parts : PARTS;
  parts = parts < n ? parts : n;
  if (parts == 1) {
    for (int o = threadIdx.x; o < nv; o += THREADS) {
      R acc[NR] = {};
      sum_slabs<R>(partials, nv, o, 0, n, acc);
      cs[o] = to_vec(acc);
    }
    __syncthreads();
    return;
  }
  const int o = threadIdx.x % nv, j = threadIdx.x / nv;
  const int per = (n + parts - 1) / parts;
  if (j < parts) {
    R acc[NR] = {};
    const int s0 = j * per, s1 = s0 + per < n ? s0 + per : n;
    sum_slabs<R>(partials, nv, o, s0, s1, acc);
    red[j * nv + o] = to_vec(acc);
  }
  __syncthreads();
  if (threadIdx.x < nv) {
    R acc[NR] = {};
    for (int jj = 0; jj < parts; ++jj) {
      const R* r = reinterpret_cast<const R*>(&red[jj * nv + threadIdx.x]);
#pragma unroll
      for (int e = 0; e < NR; ++e) acc[e] += r[e];
    }
    cs[threadIdx.x] = to_vec(acc);
  }
  __syncthreads();
}

// v_out[n] = vs[n] - sum_k q[n K + k] cs[k] for the chunk's rows: a warp
// takes ROWS_AT_ONCE rows at once (rows n0, n0 + WARPS, ...), its lanes
// over k in order, then a fixed shuffle tree per row, the rows' trees
// interleaved.
template <typename R, bool CPLX>
__device__ __forceinline__ void update_rows(
    const repro::elem_t<R, CPLX>* q, int rows, int K,
    const repro::elem_t<R, CPLX>* cs, const repro::elem_t<R, CPLX>* vs,
    repro::elem_t<R, CPLX>* v_out) {
  using E = repro::elem_t<R, CPLX>;
  const int lane = threadIdx.x & 31;
  for (int n0 = threadIdx.x >> 5; n0 < rows; n0 += ROWS_AT_ONCE * WARPS) {
    R re[ROWS_AT_ONCE] = {}, im[ROWS_AT_ONCE] = {};
    for (int k = lane; k < K; k += 32) {
      const E ck = cs[k];
#pragma unroll
      for (int i = 0; i < ROWS_AT_ONCE; ++i)
        if (n0 + i * WARPS < rows)
          repro::mul_acc(q[(long long)(n0 + i * WARPS) * K + k], ck, re[i],
                         im[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < ROWS_AT_ONCE; ++i) {
        re[i] += __shfl_down_sync(0xffffffffu, re[i], off);
        im[i] += __shfl_down_sync(0xffffffffu, im[i], off);
      }
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < ROWS_AT_ONCE; ++i) {
        const int n = n0 + i * WARPS;
        if (n < rows) {
          R vr, vi;
          repro::get(vs[n], vr, vi);
          repro::put(v_out + n, vr - re[i], vi - im[i]);
        }
      }
  }
}

template <typename R, bool CPLX>
__global__ void __launch_bounds__(THREADS, 1)
    project(const repro::elem_t<R, CPLX>* __restrict__ v,
            const repro::elem_t<R, CPLX>* __restrict__ Q,
            const bool* __restrict__ active,
            repro::elem_t<R, CPLX>* __restrict__ c,
            repro::elem_t<R, CPLX>* __restrict__ v_out,
            repro::elem_t<R, CPLX>* __restrict__ scratch,
            unsigned* __restrict__ bar, long long N, int K, int rows_per_cta,
            int T) {
  using E = repro::elem_t<R, CPLX>;
  using Vec = vec_t<R>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KPa = (int)(round16((long long)K * sizeof(E)) / sizeof(E));
  const int nv = KPa * (int)sizeof(E) / 16;
  E* cs = reinterpret_cast<E*>(smem);                       // KPa
  unsigned char* red = smem + (size_t)KPa * sizeof(E);      // THREADS x 16
  E* vs = reinterpret_cast<E*>(red + THREADS * 16);         // T
  unsigned char* qraw = reinterpret_cast<unsigned char*>(vs) +
                        round16((long long)T * sizeof(E));  // 16 + T x K

  const long long lo = (long long)blockIdx.x * rows_per_cta;
  const long long hi = lo + rows_per_cta < N ? lo + rows_per_cta : N;
  if (active != nullptr && !*active) {  // the same in every CTA
    for (long long n = lo + threadIdx.x; n < hi; n += THREADS)
      v_out[n] = v[n];
    if (blockIdx.x == 0)
      for (int k = threadIdx.x; k < K; k += THREADS)
        repro::put(c + k, R(0), R(0));
    return;
  }
  const int nchunks = (int)((hi - lo + T - 1) / T);
  for (int k = threadIdx.x; k < KPa; k += THREADS) cs[k] = E{};

  // the partial c_b = Q_b^H v_b, chunk by chunk; the last chunk stays
  // resident.  With K <= THREADS / 2 each k is summed over `parts`
  // interleaved row ranges (a thread each), added in order at the end.
  const int parts = K * 2 > THREADS ? 1 : (THREADS / K < PARTS ? THREADS / K
                                                                : PARTS);
  const int pk = threadIdx.x % K, pj = threadIdx.x / K;
  R re = 0, im = 0;
  const E* q = nullptr;
  for (int ch = 0; ch < nchunks; ++ch) {
    const long long r0 = lo + (long long)ch * T;
    const int rows = (int)(hi - r0 < T ? hi - r0 : T);
    if (ch > 0) __syncthreads();  // every thread is done with the last one
    q = load_rows(qraw, Q, r0, rows, K);
    for (int n = threadIdx.x; n < rows; n += THREADS) vs[n] = v[r0 + n];
    wait_copies();
    project_rows<R, CPLX>(q, vs, rows, K, parts, pk, pj, cs, re, im);
  }
  if (parts > 1) {
    E* sums = reinterpret_cast<E*>(red);
    if (pj < parts) repro::put(sums + pj * K + pk, re, im);
    __syncthreads();
    if (threadIdx.x < K) {
      R sr = 0, si = 0, cr, ci;
      for (int j = 0; j < parts; ++j) {
        repro::get(sums[j * K + threadIdx.x], cr, ci);
        sr += cr;
        si += ci;
      }
      repro::put(cs + threadIdx.x, sr, si);
    }
  }
  __syncthreads();
  Vec* mine = reinterpret_cast<Vec*>(scratch) + (long long)blockIdx.x * nv;
  for (int o = threadIdx.x; o < nv; o += THREADS)
    mine[o] = reinterpret_cast<const Vec*>(cs)[o];

  grid_barrier(bar);
  fold<R>(reinterpret_cast<const Vec*>(scratch), nv,
          reinterpret_cast<Vec*>(cs), reinterpret_cast<Vec*>(red));
  if (blockIdx.x == 0)
    for (int k = threadIdx.x; k < K; k += THREADS) c[k] = cs[k];

  // the update: the resident chunk first, then the others copied again
  for (int i = 0; i < nchunks; ++i) {
    const int ch = (nchunks - 1 + i) % nchunks;
    const long long r0 = lo + (long long)ch * T;
    const int rows = (int)(hi - r0 < T ? hi - r0 : T);
    if (i > 0) {
      __syncthreads();  // every warp is done with the previous chunk
      q = load_rows(qraw, Q, r0, rows, K);
      for (int n = threadIdx.x; n < rows; n += THREADS) vs[n] = v[r0 + n];
      wait_copies();
    }
    update_rows<R, CPLX>(q, rows, K, cs, vs, v_out + r0);
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <typename R, bool CPLX>
int launch(const void* v, const void* Q, const void* active, void* c,
           void* v_out, void* scratch, void* bar, long long N, long long K,
           long long rows_per_cta, long long T, void* stream) {
  using E = repro::elem_t<R, CPLX>;
  if (N < 1 || K < 1 || K > 0x7fffffffLL || T < 1 || rows_per_cta < 1 ||
      rows_per_cta > 0x7fffffffLL || ceil_div(N, rows_per_cta) > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(Q) % alignof(E) != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes(K, T, sizeof(E));
  cudaError_t err =
      repro::sm90::allow_dynamic_smem<project<R, CPLX>>(smem);
  if (err != cudaSuccess) return (int)err;
  const E* v_ = static_cast<const E*>(v);
  const E* Q_ = static_cast<const E*>(Q);
  const bool* active_ = static_cast<const bool*>(active);
  E* c_ = static_cast<E*>(c);
  E* v_out_ = static_cast<E*>(v_out);
  E* scratch_ = static_cast<E*>(scratch);
  unsigned* bar_ = static_cast<unsigned*>(bar);
  int K_ = (int)K, rows_ = (int)rows_per_cta, T_ = (int)T;
  void* args[] = {&v_, &Q_, &active_, &c_, &v_out_, &scratch_, &bar_,
                  &N, &K_, &rows_, &T_};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&project<R, CPLX>),
      dim3((unsigned)ceil_div(N, rows_per_cta)), dim3(THREADS), args, smem,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// Bytes of shared memory a CTA takes with chunks of T rows of K elements
// of `itemsize` bytes (the wrapper sizes T to its budget by the same sum).
extern "C" long long imgs_project_sm90_smem(long long K, long long T,
                                            long long itemsize) {
  return smem_bytes(K, T, itemsize);
}

// v (N,), Q (N, K) row-major; `active` a device bool or null (true); c (K,)
// and v_out (N,) written.  CTAs of rows_per_cta rows each, taken in chunks
// of T; `scratch` 16-byte aligned, one partial of K elements padded to 16
// bytes per CTA; `bar` one uint32 of the wrapper's, whose low 31 bits are 0
// (left so).  Returns the CUDA error of the cooperative launch (0: none).
#define IMGS_PROJECT_SM90_ENTRY(NAME, R, CPLX)                                \
  extern "C" int NAME(const void* v, const void* Q, const void* active,      \
                      void* c, void* v_out, void* scratch, void* bar,        \
                      long long N, long long K, long long rows_per_cta,      \
                      long long T, void* stream) {                           \
    return launch<R, CPLX>(v, Q, active, c, v_out, scratch, bar, N, K,       \
                           rows_per_cta, T, stream);                         \
  }

IMGS_PROJECT_SM90_ENTRY(imgs_project_sm90_f32, float, false)
IMGS_PROJECT_SM90_ENTRY(imgs_project_sm90_f64, double, false)
IMGS_PROJECT_SM90_ENTRY(imgs_project_sm90_c64, float, true)
IMGS_PROJECT_SM90_ENTRY(imgs_project_sm90_c128, double, true)
