// imgs_panel_sm90: one classical Gram-Schmidt pass on a panel for Hopper,
// the route of every K whose slab of rows fits in shared memory.
//
// Replaces, with imgs_panel.cu (the general route), the Pallas TPU kernel
// src/repro/kernels/imgs_panel/kernel.py imgs_panel_real (:76; bodies
// _proj_kernel :39, _update_kernel :57), which the TPU wrapper fed complex
// data through a 2N x 2K real embedding of Q built on every pass.  Same
// function as imgs_panel.cu and ref.py, on Q (N x K) and the panel V
// (N x p), both row-major:
//   proj:    C  = Q^H V        (K, p)
//   update:  V' = V - Q C      (N, p)
//
// Bound on the H100: bytes.  The bound counts Q once: at the blocked
// path's (10000, 108) complex64, with p = 8, 8.6 MB of Q and 1.3 MB of V,
// C and V', 2.96 us at 3.35 TB/s; the flops (16 N K p) are far below the
// compute roof.  What the design does about it:
//   * Split N into slabs of T consecutive rows.  The wrapper picks T so
//     that each SM gets one slab (T = 76 at the path's N = 10,000: 132
//     slabs on 132 SMs) and the slab fits in shared memory.  Because Q
//     is row-major a slab is T x K contiguous elements: each CTA copies it
//     into shared memory with cp.async, a warp reading 32 consecutive
//     elements, so every DRAM sector is used whole.  The copies are of one
//     element each (not 16 bytes) because the rows land K | 1 elements
//     apart, an odd stride, so that the update's reads of different rows
//     fall in different banks.  Both launches read Q so, once each.
//   * proj: each CTA computes its partial C_b = Q_b^H V_b (K x p) and
//     writes it to scratch that the wrapper owns.  Then a tree of tickets
//     folds the partials: a ticket per group of GROUP slabs elects the
//     group's last CTA, which sums the group's partials in slab order into
//     the next level's scratch, and so on until one group is left, whose
//     last CTA writes C.  The order of every sum is fixed, so the bits do
//     not depend on which CTA finishes last; the only atomics are the
//     integer tickets, and the electing CTA resets each counter to 0 for
//     the next launch on the stream.  No second pass over the partials.
//   * update: each CTA copies its slab of Q again, with C (K x p) in shared
//     memory, and writes V'_b.
//   * Both products are blocked 2 x 2 in registers (proj: two k by two
//     columns, update: two rows by two columns), one shared-memory load per
//     complex multiply-add.  Native interleaved complex and FP32 FMA for
//     float32 / complex64 (no tensor cores, no TF32); double for float64 /
//     complex128.  Each output is one thread's sum over the slab's rows
//     (proj) or over k (update), in order.
//   * Panels wider than PMAX = 32 columns run as column panels: column i of
//     C and of V' depends on column i of V alone.
#include "common.cuh"
#include "sm90.cuh"

#include <stdint.h>

namespace {

using repro::sm90::smem_u32;

constexpr int THREADS = 256;
constexpr int PMAX = 32;   // widest column panel
constexpr int GROUP = 16;  // partials folded by each elected CTA
constexpr int FOLD_VECS = 2;  // 16-byte vectors each folding thread takes

__device__ __forceinline__ void cp_async(void* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async(void* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async(void* dst, const float2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async(void* dst, const double2* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Rows [row0, row0 + rows) of Q (K contiguous elements each) into shared
// memory, Kp = K | 1 elements apart; the caller waits with wait_slab.
template <typename E>
__device__ __forceinline__ void load_slab(E* qs, const E* Q, long long row0,
                                          int rows, int K, int Kp) {
  const E* src = Q + row0 * K;
  for (int e = threadIdx.x; e < rows * K; e += THREADS)
    cp_async(qs + (e / K) * Kp + e % K, src + e);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_slab() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// The CTA's ticket on `counter`, of `n` in all: true in every thread of the
// CTA that took the last one, which resets the counter.  The CTA's writes
// before the call are visible to the elected CTA's reads after it.
__device__ __forceinline__ bool last_arrival(int* counter, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(counter, 1);
    last = t == n - 1;
    if (last) *counter = 0;  // all n tickets are taken
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Partials are KPa = KP rounded up to 16 bytes apart, so that the fold
// reads them as 16-byte vectors.
template <typename E>
__host__ __device__ constexpr int padded(int KP) {
  return (KP + (int)(16 / sizeof(E)) - 1) / (int)(16 / sizeof(E)) *
         (int)(16 / sizeof(E));
}

// Sum over s < n of src[s KPa + o], in order of s, for o < KP; written to
// dst[o] or, with ldc > 0, to C[(o / pp) ldc + o % pp].  Each thread takes
// FOLD_VECS vectors of 16 bytes of outputs at a time, with GROUP loads of
// each in flight.
template <typename R, bool CPLX>
__device__ __forceinline__ void fold(const repro::elem_t<R, CPLX>* src, int n,
                                     int KP, int pp,
                                     repro::elem_t<R, CPLX>* dst,
                                     long long ldc) {
  using E = repro::elem_t<R, CPLX>;
  using Vec = std::conditional_t<std::is_same_v<R, float>, float4, double2>;
  constexpr int NR = 16 / sizeof(R), NE = 16 / sizeof(E);
  const int nv = padded<E>(KP) / NE;  // vectors of one partial
  const Vec* vsrc = reinterpret_cast<const Vec*>(src);
  for (int o0 = threadIdx.x; o0 < nv; o0 += FOLD_VECS * THREADS) {
    R acc[FOLD_VECS][NR] = {};
    for (int s0 = 0; s0 < n; s0 += GROUP) {
      Vec v[FOLD_VECS][GROUP];
#pragma unroll
      for (int u = 0; u < FOLD_VECS; ++u)
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (s0 + j < n && o0 + u * THREADS < nv)
            v[u][j] = __ldcg(vsrc + (long long)(s0 + j) * nv + o0 +
                             u * THREADS);
#pragma unroll
      for (int u = 0; u < FOLD_VECS; ++u)
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (s0 + j < n) {
            const R* x = reinterpret_cast<const R*>(&v[u][j]);
#pragma unroll
            for (int r = 0; r < NR; ++r) acc[u][r] += x[r];
          }
    }
#pragma unroll
    for (int u = 0; u < FOLD_VECS; ++u)
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const int e = (o0 + u * THREADS) * NE + j;
        if (e < KP)
          repro::put(ldc > 0 ? dst + (long long)(e / pp) * ldc + e % pp
                             : dst + e,
                     acc[u][CPLX ? 2 * j : j],
                     CPLX ? acc[u][2 * j + 1] : R(0));
      }
  }
}

template <typename R, bool CPLX>
__global__ void __launch_bounds__(THREADS)
    panel_proj(const repro::elem_t<R, CPLX>* __restrict__ V, long long ldv,
               int pp, const repro::elem_t<R, CPLX>* __restrict__ Q,
               repro::elem_t<R, CPLX>* __restrict__ scratch,
               repro::elem_t<R, CPLX>* __restrict__ C, long long ldc,
               int* __restrict__ tickets, long long N, int K, int T) {
  using E = repro::elem_t<R, CPLX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Kp = K | 1, pe = pp + (pp & 1);
  E* qs = reinterpret_cast<E*>(smem);  // T x Kp
  E* vs = qs + (size_t)T * Kp;         // T x pe
  const long long row0 = (long long)blockIdx.x * T;
  const int rows = (int)(N - row0 < T ? N - row0 : T);
  load_slab(qs, Q, row0, rows, K, Kp);
  for (int e = threadIdx.x; e < rows * pe; e += THREADS) {
    const int n = e / pe, i = e % pe;
    vs[e] = i < pp ? V[(row0 + n) * ldv + i] : E{};
  }
  wait_slab();

  // the partial C_b = Q_b^H V_b: each thread a 2 x 2 block, rows (k, k + 1)
  // by columns (i, i + 1), summed over the slab's rows in order.  A block
  // past K or pp reads padding or the next row and is not written.
  const int KP = K * pp, KPa = padded<E>(KP), kb = (K + 1) / 2, ib = pe / 2;
  E* mine = scratch + (long long)blockIdx.x * KPa;
  for (int t = threadIdx.x; t < kb * ib; t += THREADS) {
    const int k = 2 * (t / ib), i = 2 * (t % ib);
    R re[4] = {}, im[4] = {};
#pragma unroll 4
    for (int n = 0; n < rows; ++n) {
      const E q0 = qs[n * Kp + k], q1 = qs[n * Kp + k + 1];
      const E v0 = vs[n * pe + i], v1 = vs[n * pe + i + 1];
      repro::conj_mul_acc(q0, v0, re[0], im[0]);
      repro::conj_mul_acc(q0, v1, re[1], im[1]);
      repro::conj_mul_acc(q1, v0, re[2], im[2]);
      repro::conj_mul_acc(q1, v1, re[3], im[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k + j / 2, ii = i + j % 2;
      if (kk < K && ii < pp) repro::put(mine + kk * pp + ii, re[j], im[j]);
    }
  }

  // the tree of tickets: level by level, GROUP partials to one, in order
  int idx = (int)blockIdx.x, n = (int)gridDim.x;
  E* src = scratch;
  for (;;) {
    const int g = idx / GROUP, g0 = g * GROUP;
    const int gn = n - g0 < GROUP ? n - g0 : GROUP;
    const int ngroups = (n + GROUP - 1) / GROUP;
    if (!last_arrival(tickets + g, gn)) return;
    if (ngroups == 1) {
      fold<R, CPLX>(src, gn, KP, pp, C, ldc);
      return;
    }
    E* dst = src + (long long)n * KPa;
    fold<R, CPLX>(src + (long long)g0 * KPa, gn, KP, pp,
                  dst + (long long)g * KPa, 0);
    tickets += ngroups;
    src = dst;
    idx = g;
    n = ngroups;
  }
}

template <typename R, bool CPLX>
__global__ void __launch_bounds__(THREADS)
    panel_update(const repro::elem_t<R, CPLX>* __restrict__ V,
                 long long ldv, int pp,
                 const repro::elem_t<R, CPLX>* __restrict__ Q,
                 const repro::elem_t<R, CPLX>* __restrict__ C, long long ldc,
                 repro::elem_t<R, CPLX>* __restrict__ V_out, long long N,
                 int K, int T) {
  using E = repro::elem_t<R, CPLX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Kp = K | 1, pe = pp + (pp & 1);
  E* qs = reinterpret_cast<E*>(smem);  // T x Kp
  E* cs = qs + (size_t)T * Kp;         // K x pe
  const long long row0 = (long long)blockIdx.x * T;
  const int rows = (int)(N - row0 < T ? N - row0 : T);
  load_slab(qs, Q, row0, rows, K, Kp);
  for (int e = threadIdx.x; e < K * pe; e += THREADS) {
    const int k = e / pe, i = e % pe;
    cs[e] = i < pp ? C[k * ldc + i] : E{};
  }
  wait_slab();

  // each thread a 2 x 2 block of V': rows (n, n + 1) by columns (i, i + 1),
  // summed over k in order; a block past rows or pp is not written
  const int nb = (rows + 1) / 2, ib = pe / 2;
  for (int t = threadIdx.x; t < nb * ib; t += THREADS) {
    const int n = 2 * (t / ib), i = 2 * (t % ib);
    R re[4] = {}, im[4] = {};
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const E q0 = qs[n * Kp + k], q1 = qs[(n + 1) * Kp + k];
      const E c0 = cs[k * pe + i], c1 = cs[k * pe + i + 1];
      repro::mul_acc(q0, c0, re[0], im[0]);
      repro::mul_acc(q0, c1, re[1], im[1]);
      repro::mul_acc(q1, c0, re[2], im[2]);
      repro::mul_acc(q1, c1, re[3], im[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n + j / 2, ii = i + j % 2;
      if (nn < rows && ii < pp) {
        const long long at = (row0 + nn) * ldv + ii;
        R vr, vi;
        repro::get(V[at], vr, vi);
        repro::put(V_out + at, vr - re[j], vi - im[j]);
      }
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Partials of the tree (the slabs', then each level's but the last, which
// writes C) and tickets of all its levels, for nslabs slabs.
void tree_sizes(long long nslabs, long long* partials, long long* tickets) {
  *partials = nslabs;
  *tickets = 0;
  for (long long n = nslabs;;) {
    const long long groups = ceil_div(n, GROUP);
    *tickets += groups;
    if (groups == 1) return;
    *partials += groups;
    n = groups;
  }
}

template <typename R, bool CPLX>
int launch(const void* V_, const void* Q_, void* C_, void* V_out_,
           void* scratch_, void* tickets, long long N, long long K,
           long long p, long long T, void* stream) {
  using E = repro::elem_t<R, CPLX>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long Kp = K | 1;
  if (T < 1 || Kp > 0x7fffffffLL / (T + PMAX) ||
      ceil_div(N, T) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const E* V = static_cast<const E*>(V_);
  const E* Q = static_cast<const E*>(Q_);
  E* C = static_cast<E*>(C_);
  E* V_out = static_cast<E*>(V_out_);
  const long long nslabs = ceil_div(N, T);
  const long long pe = p < PMAX ? p + (p & 1) : PMAX;
  const size_t smem_proj = (size_t)T * (Kp + pe) * sizeof(E);
  const size_t smem_update = (size_t)(T * Kp + K * pe) * sizeof(E);
  using repro::sm90::allow_dynamic_smem;
  cudaError_t err;
  if ((err = allow_dynamic_smem<panel_proj<R, CPLX>>(smem_proj)) !=
          cudaSuccess ||
      (err = allow_dynamic_smem<panel_update<R, CPLX>>(smem_update)) !=
          cudaSuccess)
    return (int)err;
  for (long long lo = 0; lo < p; lo += PMAX) {
    const int pp = (int)(p - lo < PMAX ? p - lo : PMAX);
    panel_proj<R, CPLX><<<(unsigned)nslabs, THREADS, smem_proj, st>>>(
        V + lo, p, pp, Q, static_cast<E*>(scratch_), C + lo, p,
        static_cast<int*>(tickets), N, (int)K, (int)T);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    panel_update<R, CPLX><<<(unsigned)nslabs, THREADS, smem_update, st>>>(
        V + lo, p, pp, Q, C + lo, p, V_out + lo, N, (int)K, (int)T);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Elements of scratch (the partials of the tree's levels) and ints of
// tickets (at 0, left at 0) a call on (N, K, p) with slabs of T rows needs.
extern "C" long long imgs_panel_sm90_scratch(long long N, long long K,
                                             long long p, long long T) {
  long long partials, tickets;
  tree_sizes(ceil_div(N, T), &partials, &tickets);
  const int KP = (int)(K * (p < PMAX ? p : PMAX));
  // padded<float> rounds up to 4 elements: enough for every type
  return partials * padded<float>(KP);
}

extern "C" long long imgs_panel_sm90_tickets(long long N, long long T) {
  long long partials, tickets;
  tree_sizes(ceil_div(N, T), &partials, &tickets);
  return tickets;
}

// V (N, p), Q (N, K) row-major; C (K, p) and V_out (N, p) written; slabs of
// T rows, whose T x ((K | 1) + P) elements (proj) and T (K | 1) + K P
// (update) fit in shared memory, P the column panel's width rounded up to
// even.  Returns the CUDA error of the launches (0: none).
#define IMGS_PANEL_SM90_ENTRY(NAME, R, CPLX)                                 \
  extern "C" int NAME(const void* V, const void* Q, void* C, void* V_out,   \
                      void* scratch, void* tickets, long long N, long long K, \
                      long long p, long long T, void* stream) {              \
    return launch<R, CPLX>(V, Q, C, V_out, scratch, tickets, N, K, p, T,    \
                           stream);                                          \
  }

IMGS_PANEL_SM90_ENTRY(imgs_panel_sm90_f32, float, false)
IMGS_PANEL_SM90_ENTRY(imgs_panel_sm90_f64, double, false)
IMGS_PANEL_SM90_ENTRY(imgs_panel_sm90_c64, float, true)
IMGS_PANEL_SM90_ENTRY(imgs_panel_sm90_c128, double, true)
