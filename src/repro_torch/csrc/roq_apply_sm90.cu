// roq_apply_sm90: the ROQ serving interpolant apply, out = B @ F, for
// Hopper, with the panel of B and the whole of F held in shared memory.
//
// Replaces, like csrc/roq_apply.cu (the general route, kept beside it), the
// XLA GEMMs of the JAX serving engine (src/repro/serving/roq.py:115-122);
// that apply was never a Pallas kernel.  The engine promises that a request
// answered inside a zero-padded batch bucket has exactly the bits of its
// unpadded direct evaluation, so each output column must not depend on the
// batch width (cuBLAS breaks that at complex128).
//
// B is the (N, k) interpolant, F the (k, nb) batch at the EIM nodes, out
// (N, nb); all row-major, complex interleaved (float2 / double2).
//   out[n, b] = sum_{j < k} B[n, j] * F[j, b]
// is summed by one thread over j = 0 .. k-1 in that order with
// repro::mul_acc from zero, in the working precision: the very sequence of
// the general kernel, so both routes give the same bits, and the bits of
// out[n, b] depend on row n of B and column b of F only.  No tensor cores:
// wgmma would round complex64 to TF32, and DMMA sums in its own order.
//
// Bound on the H100: at the GW basis (N 10,000, k 83, complex64) and
// bucket 64, the operations (8 N k nb flops, 6.3 us at 67 TFLOP/s) over
// the bytes (B read once and out written once, 3.5 us).  What the design
// does about it:
//   * a CTA takes BM consecutive rows of B, one contiguous block of BM k
//     elements, and all of F (k nb elements), into shared memory with two
//     bulk copies (cp.async.bulk on an mbarrier) where the addresses are
//     16-byte aligned, with 4-byte words otherwise;
//   * BM is what spreads N over one CTA per SM (ceil(N / SMs), 76 rows at
//     N 10,000), so that even bucket 2 has 132 CTAs in flight;
//   * each thread keeps an RR x CC register tile of outputs (rows ry + i ty,
//     columns cx + jj tx): per j it reads RR values of B (a broadcast within
//     a warp's row) and CC of F (consecutive in a warp) from shared memory
//     for RR CC multiply-adds.  The tile's shape follows nb and the type;
//     it never changes the order in which one output's terms are summed.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int MAX_THREADS = 512;

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ void copy_words(unsigned char* dst,
                                           const unsigned char* src, int from,
                                           int to) {
  for (int b = from + 4 * (int)threadIdx.x; b < to; b += 4 * (int)blockDim.x)
    *reinterpret_cast<uint32_t*>(dst + b) =
        *reinterpret_cast<const uint32_t*>(src + b);
}

template <typename R, bool CPLX, int RR, int CC>
__global__ void __launch_bounds__(MAX_THREADS)
    apply_sm90(const repro::elem_t<R, CPLX>* __restrict__ B,
               const repro::elem_t<R, CPLX>* __restrict__ F,
               repro::elem_t<R, CPLX>* __restrict__ out, long long N, int k,
               int nb, int tx, int aligned) {
  using E = repro::elem_t<R, CPLX>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* fs = smem + 16;  // the mbarrier, F (k x nb), the panel
  unsigned char* bs = fs + round16(k * nb * (int)sizeof(E));
  const int ty = (int)blockDim.x / tx;
  const int bm = ty * RR;
  const long long n0 = (long long)blockIdx.x * bm;
  const int rows = (int)min((long long)bm, N - n0);
  const int fbytes = k * nb * (int)sizeof(E);
  const int pbytes = rows * k * (int)sizeof(E);
  const unsigned char* fg = reinterpret_cast<const unsigned char*>(F);
  const unsigned char* bg = reinterpret_cast<const unsigned char*>(B + n0 * k);
  const uint32_t bar = repro::sm90::smem_u32(smem);

  if (aligned) {  // two bulk copies, their last < 16 bytes in words
    const int f16 = fbytes & ~15, p16 = pbytes & ~15;
    if (threadIdx.x == 0) {
      repro::sm90::mbar_init(bar, 1);
      repro::sm90::mbar_fence_init();
      repro::sm90::mbar_expect_tx(bar, (uint32_t)(f16 + p16));
      if (f16) repro::sm90::bulk_load(repro::sm90::smem_u32(fs), fg, f16, bar);
      if (p16) repro::sm90::bulk_load(repro::sm90::smem_u32(bs), bg, p16, bar);
    }
    copy_words(fs, fg, f16, fbytes);
    copy_words(bs, bg, p16, pbytes);
    __syncthreads();
    repro::sm90::mbar_wait(bar, 0);
  } else {
    copy_words(fs, fg, 0, fbytes);
    copy_words(bs, bg, 0, pbytes);
    __syncthreads();
  }

  const E* Fs = reinterpret_cast<const E*>(fs);
  const int cx = (int)threadIdx.x % tx, ry = (int)threadIdx.x / tx;
  int fc[CC];  // columns past nb read column nb - 1 and are not stored
#pragma unroll
  for (int jj = 0; jj < CC; ++jj) {
    const int c = cx + jj * tx;
    fc[jj] = c < nb ? c : nb - 1;
  }
  // rows past the panel's last read what is left in shared memory and are
  // not stored
  const E* bp = reinterpret_cast<const E*>(bs) + ry * k;
  R re[RR][CC], im[RR][CC];
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int jj = 0; jj < CC; ++jj) re[i][jj] = im[i][jj] = 0;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    E f[CC], b[RR];
#pragma unroll
    for (int jj = 0; jj < CC; ++jj) f[jj] = Fs[j * nb + fc[jj]];
#pragma unroll
    for (int i = 0; i < RR; ++i) b[i] = bp[i * ty * k + j];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int jj = 0; jj < CC; ++jj)
        repro::mul_acc(b[i], f[jj], re[i][jj], im[i][jj]);
  }
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const int r = ry + i * ty;
    if (r >= rows) continue;
    E* o = out + (n0 + r) * nb;
#pragma unroll
    for (int jj = 0; jj < CC; ++jj) {
      const int c = cx + jj * tx;
      if (c < nb) repro::put(o + c, re[i][jj], im[i][jj]);
    }
  }
}

template <typename R, bool CPLX, int RR, int CC>
int launch_tile(const void* B, const void* F, void* out, long long N, int k,
                int nb, int tx, int ty, int aligned, void* stream) {
  using E = repro::elem_t<R, CPLX>;
  const long long bm = (long long)ty * RR;
  const size_t smem =
      16 + round16(k * nb * (int)sizeof(E)) + (size_t)bm * k * sizeof(E);
  cudaError_t err =
      repro::sm90::allow_dynamic_smem<apply_sm90<R, CPLX, RR, CC>>(smem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (N + bm - 1) / bm;
  apply_sm90<R, CPLX, RR, CC>
      <<<(unsigned)ctas, tx * ty, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const E*>(B), static_cast<const E*>(F),
          static_cast<E*>(out), N, k, nb, tx, aligned);
  return (int)cudaGetLastError();
}

template <typename R, bool CPLX>
int launch(const void* B, const void* F, void* out, long long N, long long k,
           long long nb, int rr, int cc, int tx, int ty, int aligned,
           void* stream) {
  if (tx < 1 || ty < 1 || tx * ty > MAX_THREADS || (long long)tx * cc < nb)
    return (int)cudaErrorInvalidValue;
  const int K = (int)k, NB = (int)nb;
#define ROQ_TILE(RR_, CC_)                                                  \
  if (rr == RR_ && cc == CC_)                                               \
    return launch_tile<R, CPLX, RR_, CC_>(B, F, out, N, K, NB, tx, ty,      \
                                          aligned, stream);
  ROQ_TILE(1, 1)
  ROQ_TILE(1, 2)
  ROQ_TILE(1, 4)
  ROQ_TILE(2, 1)
  ROQ_TILE(2, 2)
  ROQ_TILE(2, 4)
  ROQ_TILE(4, 1)
  ROQ_TILE(4, 2)
  ROQ_TILE(4, 4)
#undef ROQ_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan (rr x cc register tile, tx x ty threads, bm = rr ty rows of B a
// CTA) comes from kernels/roq_apply/ops.py::plan.  Returns the CUDA error
// of the launch.
#define ROQ_APPLY_SM90_ENTRY(NAME, R, CPLX)                                  \
  extern "C" int NAME(const void* B, const void* F, void* out, long long N,  \
                      long long k, long long nb, int rr, int cc, int tx,     \
                      int ty, int aligned, void* stream) {                   \
    return launch<R, CPLX>(B, F, out, N, k, nb, rr, cc, tx, ty, aligned,     \
                           stream);                                          \
  }

ROQ_APPLY_SM90_ENTRY(roq_apply_sm90_f32, float, false)
ROQ_APPLY_SM90_ENTRY(roq_apply_sm90_f64, double, false)
ROQ_APPLY_SM90_ENTRY(roq_apply_sm90_c64, float, true)
ROQ_APPLY_SM90_ENTRY(roq_apply_sm90_c128, double, true)
