// flash_attention: causal / sliding-window GQA attention for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// flash_attention_kernel (:96; body _fa_kernel :32), the attention of
// models/attention.py with impl="flash".  It computes what the TPU kernel
// computes: softmax(q k^T * scale + mask) v with the running max m, sum l
// and output acc in f32, queries end-aligned to the keys (query row r sits
// at absolute position r + Skv - Sq), the kv head of query head h being
// h / (Hq / Hkv), and the key tiles that causality or the window rule out
// for a whole query tile skipped.
//
// One CTA (4 warps) per (query tile of 64 rows, q head, batch), in the
// (B, H, S, D) index order of the public function but with any strides,
// so the (B, S, H, D) activations of the model are read in place.  The
// CTA loops over the key tiles in shared memory; each warp owns 16 query
// rows from the scores to the output, so within a tile it syncs only with
// itself.
//
// Bound on the H100: operations.  At the prefill's shape (B 4, Hq 32,
// Hkv 8, S 2048, D 128, bf16, causal) the two products are 137.4 GFLOP,
// 0.139 ms at 989 TFLOP/s, against 168 MB of q, k, v and o, 0.050 ms at
// 3.35 TB/s.  What this first design does about it:
//   * bf16 / f16 run both products on the tensor cores (WMMA 16x16x16,
//     f32 accumulation); the scores, the softmax and the output stay f32.
//     P is rounded to the input type for the second product, as in every
//     flash-attention kernel.
//   * f32 inputs get full f32 FMA math, never TF32.
//   * Fully masked key tiles are never loaded; partly masked ones are
//     masked per element, with masked probabilities set to exactly 0 (the
//     TPU kernel's finite -1e30 relies on a later alpha = 0 to wipe them).
//   * The scale is applied after the dot, in f32, as the plain version
//     (ref.py) does; the TPU kernel scales q first.
//   * Heaviest query tiles (last under causality) are scheduled first.
// Not yet: wgmma, TMA, warp specialization, register-resident O.  The
// output accumulator lives in shared memory (its WMMA fragment layout is
// opaque, so the per-row rescale by alpha is done there).
// No atomics: the same inputs give the same bits.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;                 // query rows per warp
constexpr int BQ = WARPS * ROWS;         // query rows per CTA
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, Sq, Skv, D;
  long long sq[4], sk[4], sv[4], so[4];  // element strides, (B, H, S, D)
  int causal;
  int window;                            // <= 0: no window
  float scale;
  int vec;                               // 16-byte aligned rows: vector loads
};

// Tile shapes and shared-memory padding per input type.  The 16-bit types
// go through WMMA, whose pointers must be 32-byte aligned and whose leading
// dimensions must be multiples of 16 bytes; f32 rows get an odd stride so
// that a warp reading one column of 32 rows hits 32 banks.
template <typename T>
struct Traits {
  static constexpr bool MMA = true;
  static constexpr int BK = 64;
  static constexpr int PADT = 8;
  static constexpr int PADF = 4;
};
template <>
struct Traits<float> {
  static constexpr bool MMA = false;
  static constexpr int BK = 32;
  static constexpr int PADT = 1;
  static constexpr int PADF = 1;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// Copy rows [0, n_valid) of a (rows x D) tile from global memory (row
// stride gs) into shared memory (row stride lds); rows past n_valid are
// zero.
template <typename T>
__device__ void load_rows(T* s, int lds, const T* g, long long gs, int rows,
                          int n_valid, int D, bool vec) {
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      const int per_row = D / 8;
      for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
        const int r = idx / per_row;
        const int c = (idx - r * per_row) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < n_valid)
          val = __ldg(reinterpret_cast<const uint4*>(g + r * gs + c));
        *reinterpret_cast<uint4*>(s + r * lds + c) = val;
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < rows * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    s[r * lds + c] = r < n_valid ? g[r * gs + c] : from_f<T>(0.f);
  }
}

template <typename T>
size_t smem_bytes(int D) {
  using Tr = Traits<T>;
  return (size_t)(BQ + 2 * Tr::BK) * (D + Tr::PADT) * sizeof(T)  // q, k, v
         + (size_t)BQ * (Tr::BK + Tr::PADF) * sizeof(float)      // scores
         + (size_t)BQ * (Tr::BK + Tr::PADT) * sizeof(T)          // probs
         + (size_t)BQ * (D + Tr::PADF) * sizeof(float);          // output
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fa_kernel(const Args a) {
  using Tr = Traits<T>;
  constexpr int BK = Tr::BK;
  constexpr int HALF = BK / 2;  // columns per lane in the softmax
  const int D = a.D;
  const int ldt = D + Tr::PADT, lds = BK + Tr::PADF;
  const int ldp = BK + Tr::PADT, ldo = D + Tr::PADF;

  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * ldt;
  T* sV = sK + BK * ldt;
  float* sS = reinterpret_cast<float*>(sV + BK * ldt);
  T* sP = reinterpret_cast<T*>(sS + BQ * lds);
  float* sO = reinterpret_cast<float*>(sP + BQ * ldp);

  const int nqt = (a.Sq + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_lo = qt * BQ;
  const int q_valid = min(BQ, a.Sq - q_lo);
  const int off = a.Skv - a.Sq;

  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1] +
                q_lo * a.sq[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];

  load_rows(sQ, ldt, qp, a.sq[2], BQ, q_valid, D, a.vec);
  for (int i = threadIdx.x; i < BQ * ldo; i += THREADS) sO[i] = 0.f;

  // The keys any row of this tile may see: skip the rest whole.
  const int i_lo = q_lo + off, i_hi = q_lo + q_valid - 1 + off;
  int kv_lo = 0, kv_hi = a.Skv;
  if (a.causal) kv_hi = min(kv_hi, i_hi + 1);
  if (a.window > 0) kv_lo = max(0, i_lo - a.window + 1);
  const int t_begin = kv_lo / BK;
  const int t_end = kv_hi > kv_lo ? (kv_hi + BK - 1) / BK : t_begin;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;              // the warp's first row
  const int my_row = r0 + lane / 2;        // softmax: two lanes per row
  const int half = lane % 2;
  const int i_abs = q_lo + my_row + off;   // absolute position of my_row
  const bool row_ok = my_row < q_valid;
  float m = -INFINITY, l = 0.f;            // running max and sum of my_row

  for (int t = t_begin; t < t_end; ++t) {
    const int k_lo = t * BK;
    const int k_valid = min(BK, a.Skv - k_lo);
    __syncthreads();  // the previous tile's k, v are consumed
    load_rows(sK, ldt, kp + k_lo * a.sk[2], a.sk[2], BK, k_valid, D, a.vec);
    load_rows(sV, ldt, vp + k_lo * a.sv[2], a.sv[2], BK, k_valid, D, a.vec);
    __syncthreads();

    // scores S = Q K^T of the warp's rows (unscaled, f32)
    if constexpr (Tr::MMA) {
      using namespace nvcuda;
      for (int j0 = 0; j0 < BK; j0 += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
        for (int d0 = 0; d0 < D; d0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fq;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fk;
          wmma::load_matrix_sync(fq, sQ + r0 * ldt + d0, ldt);
          wmma::load_matrix_sync(fk, sK + j0 * ldt + d0, ldt);
          wmma::mma_sync(c, fq, fk, c);
        }
        wmma::store_matrix_sync(sS + r0 * lds + j0, c, lds,
                                wmma::mem_row_major);
      }
    } else {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      const float* kr = reinterpret_cast<const float*>(sK) + lane * ldt;
      const float* qr = reinterpret_cast<const float*>(sQ) + r0 * ldt;
      for (int d = 0; d < D; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(qr[r * ldt + d], kv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sS[(r0 + r) * lds + lane] = acc[r];
    }
    __syncwarp();

    // online softmax of my_row over my half of the tile's columns
    const float* srow = sS + my_row * lds + half * HALF;
    const int j0 = k_lo + half * HALF;
    auto visible = [&](int j) {
      return row_ok && j < a.Skv && (!a.causal || j <= i_abs) &&
             (a.window <= 0 || j > i_abs - a.window);
    };
    float mx = -INFINITY;
    for (int c = 0; c < HALF; ++c)
      if (visible(j0 + c)) mx = fmaxf(mx, srow[c] * a.scale);
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float m_new = fmaxf(m, mx);
    // m == -inf: nothing seen yet, acc is 0 and alpha is immaterial
    const float alpha = m_new == -INFINITY ? 1.f : expf(m - m_new);
    float sum = 0.f;
    T* prow = sP + my_row * ldp + half * HALF;
    for (int c = 0; c < HALF; ++c) {
      const float p = (m_new != -INFINITY && visible(j0 + c))
                          ? expf(srow[c] * a.scale - m_new)
                          : 0.f;
      sum += p;
      prow[c] = from_f<T>(p);
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();

    // O = alpha O + P V over the warp's rows
    if constexpr (Tr::MMA) {
      using namespace nvcuda;
      for (int d = half; d < D; d += 2) sO[my_row * ldo + d] *= alpha;
      __syncwarp();
      for (int d0 = 0; d0 < D; d0 += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::load_matrix_sync(o, sO + r0 * ldo + d0, ldo,
                               wmma::mem_row_major);
        for (int c0 = 0; c0 < BK; c0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fp;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fv;
          wmma::load_matrix_sync(fp, sP + r0 * ldp + c0, ldp);
          wmma::load_matrix_sync(fv, sV + c0 * ldt + d0, ldt);
          wmma::mma_sync(o, fp, fv, o);
        }
        wmma::store_matrix_sync(sO + r0 * ldo + d0, o, ldo,
                                wmma::mem_row_major);
      }
    } else {
      float al[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) al[r] = __shfl_sync(FULL, alpha, 2 * r);
      const float* pr = reinterpret_cast<const float*>(sP) + r0 * ldp;
      const float* vr = reinterpret_cast<const float*>(sV);
      for (int d = lane; d < D; d += 32) {
        float acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = sO[(r0 + r) * ldo + d] * al[r];
        for (int c = 0; c < BK; ++c) {
          const float vv = vr[c * ldt + d];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc[r] = fmaf(pr[r * ldp + c], vv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sO[(r0 + r) * ldo + d] = acc[r];
      }
    }
    __syncwarp();
  }
  __syncthreads();  // sO's zero fill is visible even when no tile ran

  T* op = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[1] + q_lo * a.so[2];
  for (int r = 0; r < ROWS; ++r) {
    const float lr = __shfl_sync(FULL, l, 2 * r);
    if (r0 + r >= q_valid) continue;
    for (int d = lane; d < D; d += 32)
      op[(r0 + r) * a.so[2] + d] = from_f<T>(sO[(r0 + r) * ldo + d] / lr);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, long long B,
           long long Hq, long long Hkv, long long Sq, long long Skv,
           long long D, const long long* strides, int causal, int window,
           float scale, int vec, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.Hq = (int)Hq;
  a.Hkv = (int)Hkv;
  a.Sq = (int)Sq;
  a.Skv = (int)Skv;
  a.D = (int)D;
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[4 + i];
    a.sv[i] = strides[8 + i];
    a.so[i] = strides[12 + i];
  }
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.vec = vec;
  const size_t smem = smem_bytes<T>((int)D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  fa_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D), o like q, each given by its
// element strides (strides[0:4] q, [4:8] k, [8:12] v, [12:16] o; the last
// of each is 1).  Returns the CUDA error of the launch (0: none).
#define FA_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      long long B, long long Hq, long long Hkv,             \
                      long long Sq, long long Skv, long long D,             \
                      const long long* strides, int causal, int window,     \
                      float scale, int vec, void* stream) {                 \
    return launch<T>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides, causal,   \
                     window, scale, vec, stream);                           \
  }

FA_ENTRY(flash_attention_f32, float)
FA_ENTRY(flash_attention_bf16, __nv_bfloat16)
FA_ENTRY(flash_attention_f16, __half)
