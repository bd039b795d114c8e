// column_norms: sum_n |X[n, i]|^2 for each column of an (N, M) matrix, in
// the fixed order of repro_torch/sums.py, bit for bit.
//
// Not a TPU kernel: the JAX package sums the norms with XLA
// (jnp.sum(jnp.abs(S)**2, 0), src/repro/core/greedy.py:302).  The port
// sums them in an order fixed by N alone, so that a column's bits do not
// depend on the tile it sits in (the streamed build equals the resident
// one only so), and its plain version is a halving tree of elementwise
// torch ops: ~log2 N passes over the data, each allocating.  This kernel
// is that tree in one read of X.
//
// The tree.  Level 0 is |x|^2 of each row (re*re + im*im for a complex
// element, each product and the sum rounded on its own); level l + 1 has
// n_{l+1} = ceil(n_l / 2) rows, row j = X_l[j] + X_l[j + h_l] for
// j < h_l = n_l / 2, and row h_l = X_l[2 h_l] carried when n_l is odd.
// A row of level L is thus a binary tree over at most 2^L rows of X; a
// missing child (below a carried row) is summed as +0, which leaves the
// other operand's bits unchanged (every value is a sum of squares: +0,
// positive, inf or NaN).  Every operation is __fmul_rn / __fadd_rn (or the
// double forms), so nvcc cannot contract a*a + b*b into an FMA.
//
// Bound on the H100: bytes.  Each element of X is read once; the output
// is one real per column.  The paper's tile (10,000 x 65,536 complex64,
// 5.24 GB) is 1.56 ms at 3.35 TB/s; the squares and adds are 3 flops an
// element, far below the FP32 rate.
//
// Design.  A CTA owns W adjacent columns (W * 8 or W * 16 bytes of each
// row: whole 32-byte sectors) and its 512 threads are G = 512 / W groups
// of W lanes, one lane a column.  Phase 1 forms level L of the tree (the
// smallest L whose n_L * W reals fit in SMEM_BUDGET of shared memory)
// straight from global memory: group g evaluates rows g, g + G, ... of
// level L, each 2^L independent loads issued together and folded in the
// tree's order in registers.  Phase 2 folds the remaining levels in
// shared memory, one __syncthreads a level (in place: row j < h reads j
// and j + h, the carried row h is read and written by the thread of
// row 0), and lane c of group 0 writes column c.  At N 10,000, L = 4
// (625 rows, 80 KB), two CTAs an SM, 16 loads in flight a thread.  When
// no L <= MAX_LEVEL fits (N > 25,600), the wrapper first runs partial
// stages that write level PARTIAL_LEVEL of the tree to a scratch matrix
// (the same tree, so the same bits) and then a final stage on it.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;

template <typename T>
struct real_of {
  using type = T;
};
template <>
struct real_of<float2> {
  using type = float;
};
template <>
struct real_of<double2> {
  using type = double;
};

__device__ __forceinline__ float leaf(float x) { return __fmul_rn(x, x); }
__device__ __forceinline__ double leaf(double x) { return __dmul_rn(x, x); }
__device__ __forceinline__ float leaf(float2 x) {
  return __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
}
__device__ __forceinline__ double leaf(double2 x) {
  return __dadd_rn(__dmul_rn(x.x, x.x), __dmul_rn(x.y, x.y));
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

// Row j of level D of one column's tree (j < 0: a missing child, +0).
// h[l] = n_l / 2.  SQ: the leaves are |x|^2 of X; else X holds the rows
// of an earlier level already.
template <int D, bool SQ, typename T>
__device__ __forceinline__ typename real_of<T>::type node(
    const T* __restrict__ col, long long rs, const int* h, int j) {
  using R = typename real_of<T>::type;
  if constexpr (D == 0) {
    if (j < 0) return R(0);
    const T v = col[(long long)j * rs];
    if constexpr (SQ)
      return leaf(v);
    else
      return v;
  } else {
    const int hh = h[D - 1];
    int a = j, b = j + hh;
    if (j < 0) {
      a = -1;
      b = -1;
    } else if (j >= hh) {  // j == hh, n_{D-1} odd: the carried row
      a = 2 * hh;
      b = -1;
    }
    return add(node<D - 1, SQ>(col, rs, h, a), node<D - 1, SQ>(col, rs, h, b));
  }
}

// FINAL: the whole tree, out[col] (out_rs unused).  Else level L only,
// out[j * out_rs + col].
template <typename T, bool SQ, int L, int W, bool FINAL>
__global__ void __launch_bounds__(THREADS, 2)
    column_norms_kernel(const T* __restrict__ x, long long rs, long long cs,
                        int n, int m, typename real_of<T>::type* out,
                        long long out_rs) {
  using R = typename real_of<T>::type;
  constexpr int G = THREADS / W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* s = reinterpret_cast<R*>(smem_raw);
  const int c = threadIdx.x % W, g = threadIdx.x / W;
  const long long col = (long long)blockIdx.x * W + c;
  const bool live = col < m;
  int h[L > 0 ? L : 1];
  int nl = n;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    h[l] = nl >> 1;
    nl -= nl >> 1;
  }
  const T* colp = x + (live ? col : 0) * cs;
  if constexpr (!FINAL) {
    if (live)
      for (int j = g; j < nl; j += G)
        out[(long long)j * out_rs + col] = node<L, SQ>(colp, rs, h, j);
    return;
  } else {
    for (int j = g; j < nl; j += G)
      s[j * W + c] = live ? node<L, SQ>(colp, rs, h, j) : R(0);
    __syncthreads();
    while (nl > 1) {
      const int hh = nl >> 1, odd = nl & 1;
      for (int j = g; j < hh; j += G) {
        const R sum = add(s[j * W + c], s[(j + hh) * W + c]);
        if (j == 0 && odd) {
          const R carry = s[2 * hh * W + c];
          s[hh * W + c] = carry;
        }
        s[j * W + c] = sum;
      }
      __syncthreads();
      nl = hh + odd;
    }
    if (g == 0 && live) out[col] = s[c];
  }
}

template <typename T, bool SQ, int L, bool FINAL>
int launch_level(const void* x, long long rs, long long cs, int n, int m,
                 void* out, long long out_rs, int smem, cudaStream_t s) {
  using R = typename real_of<T>::type;
  constexpr int W = sizeof(R) == 4 ? 32 : 16;
  auto kernel = column_norms_kernel<T, SQ, L, W, FINAL>;
  if (FINAL && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((m + W - 1) / W);
  kernel<<<blocks, THREADS, FINAL ? smem : 0, s>>>(
      static_cast<const T*>(x), rs, cs, n, m, static_cast<R*>(out), out_rs);
  return (int)cudaGetLastError();
}

constexpr int PARTIAL_LEVEL = 4;

template <typename T, bool SQ>
int launch(const void* x, long long rs, long long cs, int n, int m, int level,
           int final_stage, void* out, long long out_rs, int smem,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!final_stage) {
    if (level != PARTIAL_LEVEL) return (int)cudaErrorInvalidValue;
    return launch_level<T, SQ, PARTIAL_LEVEL, false>(x, rs, cs, n, m, out,
                                                     out_rs, 0, s);
  }
  switch (level) {
    case 0:
      return launch_level<T, SQ, 0, true>(x, rs, cs, n, m, out, 0, smem, s);
    case 1:
      return launch_level<T, SQ, 1, true>(x, rs, cs, n, m, out, 0, smem, s);
    case 2:
      return launch_level<T, SQ, 2, true>(x, rs, cs, n, m, out, 0, smem, s);
    case 3:
      return launch_level<T, SQ, 3, true>(x, rs, cs, n, m, out, 0, smem, s);
    case 4:
      return launch_level<T, SQ, 4, true>(x, rs, cs, n, m, out, 0, smem, s);
    case 5:
      return launch_level<T, SQ, 5, true>(x, rs, cs, n, m, out, 0, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define COLUMN_NORMS_ENTRY(name, T, SQ)                                      \
  extern "C" int name(const void* x, long long rs, long long cs, int n,      \
                      int m, int level, int final_stage, void* out,          \
                      long long out_rs, int smem, void* stream) {            \
    return launch<T, SQ>(x, rs, cs, n, m, level, final_stage, out, out_rs,   \
                         smem, stream);                                      \
  }

COLUMN_NORMS_ENTRY(column_norms_f32, float, true)
COLUMN_NORMS_ENTRY(column_norms_f64, double, true)
COLUMN_NORMS_ENTRY(column_norms_c64, float2, true)
COLUMN_NORMS_ENTRY(column_norms_c128, double2, true)
COLUMN_NORMS_ENTRY(column_fold_f32, float, false)
COLUMN_NORMS_ENTRY(column_fold_f64, double, false)
