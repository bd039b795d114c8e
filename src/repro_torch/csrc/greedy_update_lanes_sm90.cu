// greedy_update_lanes_sm90: B lanes of the fused Eq.-(6.3) pivot-search
// sweep in one launch, for Hopper: the sm90 route of every sweep.  The
// lockstep many-basis build launches it once a round for all its lanes; the
// scalar drivers (greedy_update's "sm90" route) launch it with B = 1.
//
// Replaces, with greedy_update.cu (the general route: rows that TMA cannot
// address, odd M in complex64 / float64, M % 4 != 0 in float32, unaligned
// views), the Pallas TPU kernels src/repro/kernels/greedy_update/kernel.py
// greedy_update_real (:108, body _kernel_real :41) and
// greedy_update_complex (:147, body _kernel_complex :68), and the loop of
// them that the reference's batched pallas route runs once a lane
// (src/repro/core/backend.py:408-448, batched_pivot_update).  For each
// lane b:
//   c_b       = q_b^H S_b                  (M,)  dtype of S
//   acc_out_b = acc_b + |c_b|^2            (M,)  real
//   max_res_b = max(norms_b - acc_out_b), argmax_b = its FIRST index,
// where S_b is one shared (N, M) S for every lane, or S[b] of a stacked
// (B, N, M) S.  A lane whose active flag is false gets what q = 0 gives:
// c = 0, acc_out = acc, and the (max, first index) of norms - acc.
//
// Bits: a lane's results do not depend on B, on its group or on the layout:
// its column is summed over the rows in order, repro::conj_mul_acc a row,
// in the working precision (double for f64 / c128), with greedy_update.cuh's
// epilogue and fold, over the same 128-column CTAs.  So every lane of a
// lockstep build is bitwise the scalar driver's sweep on (q_b, S_b).
//
// Bound on the H100: bytes, while the lanes' multiply-adds fit beside the
// stream.  Each element of S is read once for one (complex) multiply-add a
// lane.  At the greedy path's (10000, 131072) complex64, S is 10.5 GB:
// 3.13 ms at 3.35 TB/s.  Shared layout: a CTA owns W = 128 columns and sums
// them for a group of up to L = 16 lanes, so S goes through the ring once
// for the group.  At B = 8 that is 3.14 ms, against 8 B N M = 84 GFLOP,
// 1.25 ms at the FP32 rate; the lanes' work reaches the stream's time near
// B = 16.  B > 16 runs as ceil(B / 16) groups along the grid's second axis,
// each a read of S.  Stacked layout: the grid's second axis is the lane,
// and lane b's CTAs stream S[b]: one read of the whole stack, one launch
// for all lanes.
//   * A CTA streams all N rows of its columns through a ring of STAGES
//     stages of shared memory.  One producer thread issues a 3-D TMA load a
//     stage (RS rows x W columns of S, 32 KB; one map over (Bs, N, M), Bs =
//     1 in the shared layout) and beside it one 1-D TMA box of RS entries of
//     q for each live lane of the group (q's lanes sit q_stride elements
//     apart, a multiple of 16 bytes when B > 1: TMA starts a box at a
//     16-byte aligned address only), all completing on the stage's full
//     mbarrier; the 128 consumer threads, one a column, release the stage
//     on its empty mbarrier.  There is no block-wide barrier in the
//     streaming loop, and with two CTAs on an SM each keeps up to 96 KB of
//     loads in flight.  TMA fills columns past M and rows past N with
//     zeros; the full barrier counts the whole box's bytes.
//   * The tensor maps see S and q as words of 4 (float32) or 8 bytes (the
//     other types; complex128 as two words): interleaved complex is read in
//     place, no plane copies.
//   * Each consumer holds its column's L (re, im) sums in registers.  A
//     masked lane does no multiply-adds and gets no rows of q; a group
//     with no live lane issues no load (the scalar drivers' latched "no
//     stop yet" flag: the masked steps after a stop do not sweep S).
//   * Each lane has its own (max, index) pairs and its own ticket: the CTA
//     that takes a lane's last ticket folds that lane's pairs and resets
//     the ticket to 0 for the next launch on the stream.  The comparison is
//     a total order (larger value, then smaller index), so the result is
//     the first-index argmax whatever the order of the fold, and two
//     launches on the same inputs give the same bits.  The only atomics
//     are the integer tickets.
#include "common.cuh"
#include "greedy_update.cuh"
#include "sm90.cuh"

#include <stdint.h>
#include <stdio.h>

namespace {

using namespace repro::sm90;
using repro::gu::better;

constexpr int W = 128;                   // columns per CTA, one consumer each
constexpr int CONSUMERS = W;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 32768;       // bytes of S in one stage
constexpr int MAX_GROUP = 16;            // lanes a CTA sums at once

template <typename E>
__host__ __device__ constexpr int stage_rows() {
  return STAGE_BYTES / (W * (int)sizeof(E));
}

template <typename E, int L>
constexpr size_t smem_bytes() {
  return 128 /* alignment slack */ +
         (size_t)STAGES * (STAGE_BYTES + (size_t)L * stage_rows<E>() *
                                             sizeof(E));
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

// Grid (M / W, groups): CTA (x, y) sums columns [x W, x W + W) for lanes
// [y L, y L + L) (stacked: L = 1 and lane y reads S[y]).
template <typename R, bool CPLX, int L>
__global__ void __launch_bounds__(THREADS, 2)
    sweep_lanes(const __grid_constant__ CUtensorMap smap,
                const __grid_constant__ CUtensorMap qmap, int words, int B,
                int stacked, long long q_stride, const R* __restrict__ acc,
                const R* __restrict__ norms,
                const bool* __restrict__ active,
                repro::elem_t<R, CPLX>* __restrict__ c,
                R* __restrict__ acc_out, R* __restrict__ bmax,
                long long* __restrict__ bidx, int* __restrict__ tickets,
                R* __restrict__ out_max, long long* __restrict__ out_idx,
                long long N, long long M) {
  using E = repro::elem_t<R, CPLX>;
  constexpr int RS = stage_rows<E>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int is_last[L];
  // TMA writes boxes at 128-byte aligned addresses
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  E* sS = reinterpret_cast<E*>(smem);                         // STAGES x RS x W
  E* sq = reinterpret_cast<E*>(smem + STAGES * STAGE_BYTES);  // STAGES x L x RS
  const long long col0 = (long long)blockIdx.x * W;
  const int nb = (int)gridDim.x;
  const int lane0 = (int)blockIdx.y * L;
  const int nl = B - lane0 < L ? B - lane0 : L;
  // the group's live lanes; every CTA of the group reads the same flags
  unsigned mask = 0;
  for (int l = 0; l < nl; ++l)
    if (active == nullptr || active[lane0 + l]) mask |= 1u << l;
  const int n_stages = mask ? (int)((N + RS - 1) / RS) : 0;

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
      const uint32_t q_bytes = __popc(mask) * RS * (uint32_t)sizeof(E);
      const int z = stacked ? lane0 : 0;
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % STAGES;
        mbar_wait(smem_u32(&empty[slot]), ((s / STAGES) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[slot]);
        mbar_expect_tx(bar, STAGE_BYTES + q_bytes);
        tma_load_3d(smem_u32(sS + (size_t)slot * RS * W), &smap, bar,
                    (int)(col0 * words), s * RS, z);
        for (int l = 0; l < nl; ++l)
          if (mask >> l & 1)
            tma_load_1d(smem_u32(sq + (size_t)(slot * L + l) * RS), &qmap,
                        bar,
                        (int)(((lane0 + l) * q_stride + (long long)s * RS) *
                              words));
      }
    }
    return;
  }

  // the consumers: column col0 + threadIdx.x, rows in order, every lane
  R re[L], im[L];
#pragma unroll
  for (int l = 0; l < L; ++l) re[l] = im[l] = 0;
  for (int stage = 0; stage < n_stages; ++stage) {
    const int slot = stage % STAGES;
    mbar_wait(smem_u32(&full[slot]), (stage / STAGES) & 1);
    const int rows = (int)(N - (long long)stage * RS < RS
                               ? N - (long long)stage * RS
                               : RS);
    const E* t = sS + (size_t)slot * RS * W + threadIdx.x;
    const E* qq = sq + (size_t)slot * L * RS;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const E s = t[r * W];
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (mask >> l & 1)
          repro::conj_mul_acc(qq[l * RS + r], s, re[l], im[l]);
    }
    mbar_arrive(smem_u32(&empty[slot]));
  }

  const long long col = col0 + threadIdx.x;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (l >= nl) break;
    const long long lane = lane0 + l;
    R v = -INFINITY;
    long long i = 0x7fffffffffffffffLL;
    if (col < M) {
      const long long o = lane * M + col;
      repro::put(c + o, re[l], im[l]);
      const R a = mask >> l & 1 ? repro::gu::add_abs2(acc[o], re[l], im[l])
                                : acc[o];
      acc_out[o] = a;
      v = norms[o] - a;
      i = col;
    }
    consumers_argmax(v, i);
    if (threadIdx.x == 0) {
      bmax[lane * nb + blockIdx.x] = v;
      bidx[lane * nb + blockIdx.x] = i;
      __threadfence();
      const int t = atomicAdd(tickets + lane, 1);
      is_last[l] = t == nb - 1;
      if (is_last[l]) tickets[lane] = 0;  // every CTA has taken its ticket
    }
  }
  bar_sync(1, CONSUMERS);
  for (int l = 0; l < nl; ++l) {
    if (!is_last[l]) continue;
    __threadfence();
    const long long lane = lane0 + l;
    R v = -INFINITY;
    long long i = 0x7fffffffffffffffLL;
    for (int b = threadIdx.x; b < nb; b += CONSUMERS)
      better(v, i, __ldcg(bmax + lane * nb + b),
             __ldcg(bidx + lane * nb + b));
    consumers_argmax(v, i);
    if (threadIdx.x == 0) {
      out_max[lane] = v;
      out_idx[lane] = i;
    }
  }
}

// A tensor map of `words`-word elements: dims innermost first, the byte
// strides of the outer dims; no swizzle, zeros past the ends.
bool make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr,
              int rank, const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) {
    fprintf(stderr,
            "greedy_update_lanes_sm90: cuTensorMapEncodeTiled not found\n");
    return false;
  }
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, dt, (cuuint32_t)rank, const_cast<void*>(ptr),
                         dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "greedy_update_lanes_sm90: cuTensorMapEncodeTiled: %d\n",
            (int)r);
    return false;
  }
  return true;
}

template <typename R, bool CPLX, int L>
int launch_group(const CUtensorMap& smap, const CUtensorMap& qmap, int words,
                 int B, int stacked, long long q_stride, const void* acc,
                 const void* norms, const void* active, void* c,
                 void* acc_out, void* bmax, void* bidx, void* tickets,
                 void* out_max, void* out_idx, long long N, long long M,
                 void* stream) {
  using E = repro::elem_t<R, CPLX>;
  const size_t smem = smem_bytes<E, L>();
  const cudaError_t err = allow_dynamic_smem<sweep_lanes<R, CPLX, L>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + W - 1) / W),
                  (unsigned)(stacked ? B : (B + L - 1) / L));
  sweep_lanes<R, CPLX, L><<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      smap, qmap, words, B, stacked, q_stride, static_cast<const R*>(acc),
      static_cast<const R*>(norms), static_cast<const bool*>(active),
      static_cast<E*>(c), static_cast<R*>(acc_out), static_cast<R*>(bmax),
      static_cast<long long*>(bidx), static_cast<int*>(tickets),
      static_cast<R*>(out_max), static_cast<long long*>(out_idx), N, M);
  return (int)cudaGetLastError();
}

template <typename R, bool CPLX>
int launch(const void* q, long long q_stride, const void* S, int stacked,
           const void* acc, const void* norms, const void* active, void* c,
           void* acc_out, void* bmax, void* bidx, void* tickets,
           void* out_max, void* out_idx, long long B, long long N,
           long long M, void* stream) {
  using E = repro::elem_t<R, CPLX>;
  constexpr int RS = stage_rows<E>();
  // words of 4 bytes for float32, 8 bytes for the rest
  const int word = std::is_same_v<E, float> ? 4 : 8;
  const int words = (int)sizeof(E) / word;
  const CUtensorMapDataType dt = word == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
  // q's elements, its last lane ending at its N-th
  const long long q_len = (B - 1) * q_stride + N;
  // TMA starts a box only at a 16-byte aligned address: S's rows and q's
  // lanes must sit on 16-byte multiples
  if (((uintptr_t)S | (uintptr_t)q) % 16 || (M * (long long)sizeof(E)) % 16 ||
      (B > 1 && (q_stride * (long long)sizeof(E)) % 16) || B < 1 ||
      B > 65535 || q_stride < N || N > 0x7fffffffLL ||
      M * words > 0x7fffffffLL || q_len * words > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap smap, qmap;
  const cuuint64_t sdims[3] = {(cuuint64_t)(M * words), (cuuint64_t)N,
                               (cuuint64_t)(stacked ? B : 1)};
  const cuuint64_t sstrides[2] = {(cuuint64_t)(M * sizeof(E)),
                                  (cuuint64_t)(N * M * sizeof(E))};
  const cuuint32_t sbox[3] = {(cuuint32_t)(W * words), (cuuint32_t)RS, 1};
  const cuuint64_t qdims[1] = {(cuuint64_t)(q_len * words)};
  const cuuint64_t qstrides[1] = {0};  // a 1-D map has no outer stride
  const cuuint32_t qbox[1] = {(cuuint32_t)(RS * words)};
  if (!make_map(&smap, dt, S, 3, sdims, sstrides, sbox) ||
      !make_map(&qmap, dt, q, 1, qdims, qstrides, qbox))
    return (int)cudaErrorInvalidValue;
  // the group: the fewest lanes of 1, 2, 4, 8, 16 that hold min(B, 16);
  // a stacked launch sums one lane a CTA
  const long long g = stacked ? 1 : (B < MAX_GROUP ? B : MAX_GROUP);
#define GROUP_LAUNCH(LL)                                                     \
  return launch_group<R, CPLX, LL>(smap, qmap, words, (int)B, stacked,       \
                                   q_stride, acc, norms, active, c, acc_out, \
                                   bmax, bidx, tickets, out_max, out_idx, N, \
                                   M, stream)
  if (g <= 1) GROUP_LAUNCH(1);
  if (g <= 2) GROUP_LAUNCH(2);
  if (g <= 4) GROUP_LAUNCH(4);
  if (g <= 8) GROUP_LAUNCH(8);
  GROUP_LAUNCH(MAX_GROUP);
#undef GROUP_LAUNCH
}

}  // namespace

// Number of (max, index) pairs a lane takes as scratch: one a CTA.
extern "C" long long greedy_update_lanes_sm90_num_blocks(long long M) {
  return (M + W - 1) / W;
}

// q (B, N) with lanes q_stride >= N elements (a multiple of 16 bytes when
// B > 1) apart; S (N, M) shared (stacked 0) or (B, N, M) stacked (1),
// row-major; S and q 16-byte aligned and M * itemsize a multiple of 16.  acc, norms, c,
// acc_out (B, M); bmax, bidx (B, num_blocks); `active` a device (B,) bool
// or null (all true); `tickets` B ints at 0, left at 0; out_max, out_idx
// (B,).  Returns the CUDA error of the launch (0: none).
#define GREEDY_UPDATE_LANES_ENTRY(NAME, R, CPLX)                             \
  extern "C" int NAME(const void* q, long long q_stride, const void* S,      \
                      int stacked, const void* acc, const void* norms,       \
                      const void* active, void* c, void* acc_out,            \
                      void* bmax, void* bidx, void* tickets, void* out_max,  \
                      void* out_idx, long long B, long long N, long long M,  \
                      void* stream) {                                        \
    return launch<R, CPLX>(q, q_stride, S, stacked, acc, norms, active, c,   \
                           acc_out, bmax, bidx, tickets, out_max, out_idx,   \
                           B, N, M, stream);                                 \
  }

GREEDY_UPDATE_LANES_ENTRY(greedy_update_lanes_sm90_f32, float, false)
GREEDY_UPDATE_LANES_ENTRY(greedy_update_lanes_sm90_f64, double, false)
GREEDY_UPDATE_LANES_ENTRY(greedy_update_lanes_sm90_c64, float, true)
GREEDY_UPDATE_LANES_ENTRY(greedy_update_lanes_sm90_c128, double, true)
