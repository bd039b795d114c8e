// greedy_update_sm90: the fused Eq.-(6.3) pivot-search sweep for Hopper, the
// route of every S whose rows are a multiple of 16 bytes.
//
// Replaces, with greedy_update.cu (the general route: rows that TMA cannot
// address, odd M in complex64 / float64, M % 4 != 0 in float32), the Pallas
// TPU kernels src/repro/kernels/greedy_update/kernel.py greedy_update_real
// (:108, body _kernel_real :41) and greedy_update_complex (:147, body
// _kernel_complex :68).  Same function as greedy_update.cu and ref.py:
//   c       = q^H S                      (M,)  dtype of S
//   acc_out = acc + |c|^2                (M,)  real
//   max_res = max(norms_sq - acc_out), argmax = its FIRST index,
// in one launch.
//
// Bound on the H100: bytes.  Each element of S is read once for one
// (complex) multiply-add, ~1 flop per byte.  At the greedy path's
// (10000, 131072) complex64, S is 10.5 GB: 3.13 ms at 3.35 TB/s.  What the
// design does about it:
//   * A CTA owns W = 128 columns and streams all N rows of them through a
//     ring of STAGES stages of shared memory.  One producer thread issues a
//     2-D TMA load per stage (RS rows x W columns of S, 32 KB) and a 1-D
//     TMA load of the stage's RS entries of q, both completing on the
//     stage's full mbarrier; the 128 consumer threads, one per column,
//     release the stage on its empty mbarrier.  There is no block-wide
//     barrier in the streaming loop, and with two CTAs on an SM each keeps
//     up to 96 KB of loads in flight.  TMA fills columns past M and rows
//     past N with zeros; the full barrier counts the whole box's bytes.
//   * The tensor maps see S and q as words of 4 (float32) or 8 bytes (the
//     other types; complex128 as two words): interleaved complex is read in
//     place, no plane copies.
//   * Each consumer sums its column over the rows in order in the working
//     precision (double for f64 / c128).
//   * An optional on-device flag (a bool; null means true) says whether
//     the sweep is live.  Each CTA reads it first; where it is false the
//     producer issues no load and the consumers write what q = 0 gives:
//     c = 0, acc_out = acc, and the (max, first index) of norms - acc,
//     folded through the ticket as in a live sweep (so the counter is left
//     at 0).  Every CTA reads the same flag, so all take the same branch.
//   * One launch per sweep: each CTA writes its (max, first index) pair and
//     takes a ticket; the CTA that takes the last ticket folds every pair
//     and resets the counter to 0 for the next launch on the stream.  The
//     comparison is a total order (larger value, then smaller index), so
//     the result is the first-index argmax whatever the order of the fold,
//     and two launches on the same inputs give the same bits.  The only
//     atomic is the integer ticket.
#include "common.cuh"
#include "sm90.cuh"

#include <stdint.h>
#include <stdio.h>

namespace {

using namespace repro::sm90;

constexpr int W = 128;                 // columns per CTA, one consumer each
constexpr int CONSUMERS = W;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 32768;     // bytes of S in one stage

template <typename E>
__host__ __device__ constexpr int stage_rows() {
  return STAGE_BYTES / (W * (int)sizeof(E));
}

template <typename E>
constexpr size_t smem_bytes() {
  return 128 /* alignment slack */ +
         (size_t)STAGES * (STAGE_BYTES + stage_rows<E>() * sizeof(E));
}

template <typename R>
__device__ __forceinline__ void better(R& v, long long& i, R v2,
                                       long long i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// (max, first index) over the consumer threads; valid in thread 0.  Named
// barrier 1: the producer warp takes no part.
template <typename R>
__device__ __forceinline__ void consumers_argmax(R& v, long long& i) {
  __shared__ R sv[CONSUMERS / 32];
  __shared__ long long si[CONSUMERS / 32];
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
  bar_sync(1, CONSUMERS);
  if (threadIdx.x == 0)
    for (int w = 1; w < CONSUMERS / 32; ++w) better(v, i, sv[w], si[w]);
  bar_sync(1, CONSUMERS);  // sv / si free for the next call
}

template <typename R, bool CPLX>
__global__ void __launch_bounds__(THREADS, 2)
    sweep(const __grid_constant__ CUtensorMap smap,
          const __grid_constant__ CUtensorMap qmap, int words,
          const R* __restrict__ acc, const R* __restrict__ norms,
          const bool* __restrict__ active,
          repro::elem_t<R, CPLX>* __restrict__ c, R* __restrict__ acc_out,
          R* __restrict__ bmax, long long* __restrict__ bidx,
          int* __restrict__ ticket, R* __restrict__ out_max,
          long long* __restrict__ out_idx, long long N, long long M) {
  using E = repro::elem_t<R, CPLX>;
  constexpr int RS = stage_rows<E>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int is_last;
  // TMA writes boxes at 128-byte aligned addresses
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  E* sS = reinterpret_cast<E*>(smem);                       // STAGES x RS x W
  E* sq = reinterpret_cast<E*>(smem + STAGES * STAGE_BYTES);  // STAGES x RS
  const long long col0 = (long long)blockIdx.x * W;
  const bool live = active == nullptr || *active;
  // a sweep that is not live streams no stage
  const int n_stages = live ? (int)((N + RS - 1) / RS) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % STAGES;
        mbar_wait(smem_u32(&empty[slot]), ((s / STAGES) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[slot]);
        mbar_expect_tx(bar, STAGE_BYTES + RS * (uint32_t)sizeof(E));
        tma_load_2d(smem_u32(sS + (size_t)slot * RS * W), &smap, bar,
                    (int)(col0 * words), s * RS);
        tma_load_1d(smem_u32(sq + slot * RS), &qmap, bar, s * RS * words);
      }
    }
    return;
  }

  // the consumers: column col0 + threadIdx.x, rows in order
  R re = 0, im = 0;
  for (int stage = 0; stage < n_stages; ++stage) {
    const int slot = stage % STAGES;
    mbar_wait(smem_u32(&full[slot]), (stage / STAGES) & 1);
    const int rows = (int)(N - (long long)stage * RS < RS
                               ? N - (long long)stage * RS
                               : RS);
    const E* t = sS + (size_t)slot * RS * W + threadIdx.x;
    const E* qq = sq + slot * RS;
#pragma unroll 8
    for (int r = 0; r < rows; ++r)
      repro::conj_mul_acc(qq[r], t[r * W], re, im);
    mbar_arrive(smem_u32(&empty[slot]));
  }

  const long long col = col0 + threadIdx.x;
  R v = -INFINITY;
  long long i = 0x7fffffffffffffffLL;
  if (col < M) {
    repro::put(c + col, re, im);
    const R a = live ? acc[col] + (re * re + im * im) : acc[col];
    acc_out[col] = a;
    v = norms[col] - a;
    i = col;
  }
  consumers_argmax(v, i);
  if (threadIdx.x == 0) {
    bmax[blockIdx.x] = v;
    bidx[blockIdx.x] = i;
    __threadfence();
    const int t = atomicAdd(ticket, 1);
    is_last = t == (int)gridDim.x - 1;
    if (is_last) *ticket = 0;  // every CTA has taken its ticket
  }
  bar_sync(1, CONSUMERS);
  if (!is_last) return;
  __threadfence();
  v = -INFINITY;
  i = 0x7fffffffffffffffLL;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += CONSUMERS)
    better(v, i, __ldcg(bmax + b), __ldcg(bidx + b));
  consumers_argmax(v, i);
  if (threadIdx.x == 0) {
    *out_max = v;
    *out_idx = i;
  }
}

// A rank-1 or rank-2 map of `words`-word elements: dims innermost first,
// row stride in bytes; no swizzle, zeros past the ends.
bool make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr,
              int rank, const cuuint64_t* dims, cuuint64_t row_bytes,
              const cuuint32_t* box) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) {
    fprintf(stderr, "greedy_update_sm90: cuTensorMapEncodeTiled not found\n");
    return false;
  }
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, dt, (cuuint32_t)rank, const_cast<void*>(ptr),
                         dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "greedy_update_sm90: cuTensorMapEncodeTiled: %d\n",
            (int)r);
    return false;
  }
  return true;
}

template <typename R, bool CPLX>
int launch(const void* q, const void* S, const void* acc, const void* norms,
           const void* active, void* c, void* acc_out, void* bmax,
           void* bidx, void* ticket,
           void* out_max, void* out_idx, long long N, long long M,
           void* stream) {
  using E = repro::elem_t<R, CPLX>;
  constexpr int RS = stage_rows<E>();
  // words of 4 bytes for float32, 8 bytes for the rest
  const int word = std::is_same_v<E, float> ? 4 : 8;
  const int words = (int)sizeof(E) / word;
  const CUtensorMapDataType dt = word == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
  if (((uintptr_t)S | (uintptr_t)q) % 16 || (M * (long long)sizeof(E)) % 16 ||
      N > 0x7fffffffLL || M * words > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap smap, qmap;
  const cuuint64_t sdims[2] = {(cuuint64_t)(M * words), (cuuint64_t)N};
  const cuuint32_t sbox[2] = {(cuuint32_t)(W * words), (cuuint32_t)RS};
  const cuuint64_t qdims[1] = {(cuuint64_t)(N * words)};
  const cuuint32_t qbox[1] = {(cuuint32_t)(RS * words)};
  if (!make_map(&smap, dt, S, 2, sdims, (cuuint64_t)(M * sizeof(E)), sbox) ||
      !make_map(&qmap, dt, q, 1, qdims, 0, qbox))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<E>();
  const cudaError_t err = allow_dynamic_smem<sweep<R, CPLX>>(smem);
  if (err != cudaSuccess) return (int)err;
  const long long nb = (M + W - 1) / W;
  sweep<R, CPLX><<<(unsigned)nb, THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      smap, qmap, words, static_cast<const R*>(acc),
      static_cast<const R*>(norms), static_cast<const bool*>(active),
      static_cast<E*>(c),
      static_cast<R*>(acc_out), static_cast<R*>(bmax),
      static_cast<long long*>(bidx), static_cast<int*>(ticket),
      static_cast<R*>(out_max), static_cast<long long*>(out_idx), N, M);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of per-CTA (max, index) pairs the caller allocates as scratch.
extern "C" long long greedy_update_sm90_num_blocks(long long M) {
  return (M + W - 1) / W;
}

// q (N,), S (N, M) row-major with 16-byte aligned bases and M * itemsize a
// multiple of 16; `active` a device bool or null (true); `ticket` one int
// at 0, left at 0.  Returns the CUDA error of the launch (0: none).
#define GREEDY_UPDATE_SM90_ENTRY(NAME, R, CPLX)                              \
  extern "C" int NAME(const void* q, const void* S, const void* acc,         \
                      const void* norms, const void* active, void* c,        \
                      void* acc_out, void* bmax, void* bidx, void* ticket,   \
                      void* out_max, void* out_idx, long long N, long long M, \
                      void* stream) {                                        \
    return launch<R, CPLX>(q, S, acc, norms, active, c, acc_out, bmax, bidx, \
                           ticket, out_max, out_idx, N, M, stream);          \
  }

GREEDY_UPDATE_SM90_ENTRY(greedy_update_sm90_f32, float, false)
GREEDY_UPDATE_SM90_ENTRY(greedy_update_sm90_f64, double, false)
GREEDY_UPDATE_SM90_ENTRY(greedy_update_sm90_c64, float, true)
GREEDY_UPDATE_SM90_ENTRY(greedy_update_sm90_c128, double, true)
