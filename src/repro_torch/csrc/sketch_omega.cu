// sketch_omega: the test blocks of the randomized range-finder, drawn on
// Hopper from the JAX package's own stream.
//
// Not a TPU kernel: the JAX package draws each tile's block Omega_t with
// jax.random (src/repro/core/randomized.py:99-123, _test_block), code it
// leaves to XLA.  This kernel draws the same numbers: Threefry-2x32 (20
// rounds, 5 key injections) of each element's flat row-major index i,
// counter (i >> 32, i & 0xffffffff), under a key the wrapper derives on the
// host exactly as the reference does (kernels/sketch_omega/ref.py: the x64
// PRNGKey, fold_in by tile, fold_in 0 / 1 for the real / imaginary part).
// Then, per element (ref.py's docstring has the reasons):
//   gaussian f32: f = mantissa fill of bits1 ^ bits2, in [0, 1);
//                 u = max(lo, f * (1 - lo) + lo), lo = -(1 - 2^-24);
//                 sqrt(2) * erfinvf(u), every operation rounded on its own;
//   gaussian f64: f = mantissa fill of (bits1 << 32) | bits2, the same in
//                 float64 (lo = -(1 - 2^-53), erfinv);
//   rademacher:   +1 where the top bit of bits1 is 0, else -1 (the x64
//                 form of bernoulli(0.5));
//   complex:      each part divided by sqrt(2) in float64, rounded to the
//                 real type.
// So the bits and every rademacher block are the reference's and the plain
// version's bit for bit; a gaussian element differs from them only through
// erfinv (CUDA's erfinvf / erfinv against XLA's and PyTorch's CPU ones).
//
// Bound on the H100: instruction issue, not bytes.  The paper's tile
// (65,536 x 110 complex64) writes 57.7 MB, 0.017 ms at 3.35 TB/s; its
// 14.4 M Threefry evaluations need 20 rotates and 20 xors each on the
// integer ALU pipe, plus 3 (gaussian) or 1 (rademacher) operations of the
// bits-to-float step, 0.037 / 0.035 ms at 64 an SM a clock; the adds can
// go to the FMA pipe, but they take issue slots too: a gaussian draw issues
// 102 instructions (its adds, ALU work, erfinvf; ops.py ISSUE_PER_DRAW),
// 0.044 ms at 4 warp-instructions an SM a clock, which binds (rademacher:
// 64, 0.028 ms, so its ALU pipe binds).  The design is the plain one:
// each thread draws whole elements in a grid-stride loop (a complex
// element is two evaluations and one 8- or 16-byte store, a warp's stores
// contiguous), the key words in registers, the rotations funnel shifts,
// nothing in shared memory, no host sync and no per-element host work:
// one launch writes the whole block.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CTAS_PER_SM = 8;  // 2,048 threads an SM
constexpr double SQRT2 = 1.4142135623730951;

struct Key {
  uint32_t k0, k1;
};

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3); x1 ^= x0;
}

// threefry2x32 of the counter (x0, x1), as jax._src.prng's lowering
__device__ __forceinline__ void threefry(Key k, uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += k.k0; x1 += k.k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k.k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k0; x1 += k.k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k.k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k.k0 + 5u;
  y0 = x0; y1 = x1;
}

template <typename R, bool GAUSS>
__device__ __forceinline__ R draw(Key k, unsigned long long i);

template <>
__device__ __forceinline__ float draw<float, true>(Key k,
                                                   unsigned long long i) {
  uint32_t b1, b2;
  threefry(k, (uint32_t)(i >> 32), (uint32_t)i, b1, b2);
  const float f = __uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u) - 1.0f;
  const float lo = -0x1.fffffep-1f;  // nextafter(-1, 0)
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, lo)), lo));
  return __fmul_rn((float)SQRT2, erfinvf(u));
}

template <>
__device__ __forceinline__ double draw<double, true>(Key k,
                                                     unsigned long long i) {
  uint32_t b1, b2;
  threefry(k, (uint32_t)(i >> 32), (uint32_t)i, b1, b2);
  const unsigned long long m =
      ((unsigned long long)b1 << 20) | (b2 >> 12) | 0x3FF0000000000000ull;
  const double f = __longlong_as_double((long long)m) - 1.0;
  const double lo = -0x1.fffffffffffffp-1;  // nextafter(-1, 0)
  const double u = fmax(lo, __dadd_rn(__dmul_rn(f, __dsub_rn(1.0, lo)), lo));
  return __dmul_rn(SQRT2, erfinv(u));
}

template <typename R>
__device__ __forceinline__ R rademacher(Key k, unsigned long long i) {
  uint32_t b1, b2;
  threefry(k, (uint32_t)(i >> 32), (uint32_t)i, b1, b2);
  return (b1 >> 31) ? R(-1) : R(1);
}

template <>
__device__ __forceinline__ float draw<float, false>(Key k,
                                                    unsigned long long i) {
  return rademacher<float>(k, i);
}

template <>
__device__ __forceinline__ double draw<double, false>(Key k,
                                                      unsigned long long i) {
  return rademacher<double>(k, i);
}

template <typename R>
__device__ __forceinline__ R over_sqrt2(R x) {
  return (R)__ddiv_rn((double)x, SQRT2);
}

template <typename R, bool GAUSS>
__global__ void __launch_bounds__(THREADS)
    omega_real(Key k, long long n, R* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS)
    out[i] = draw<R, GAUSS>(k, (unsigned long long)i);
}

template <typename R, bool GAUSS>
__global__ void __launch_bounds__(THREADS)
    omega_complex(Key kr, Key ki, long long n,
                  repro::elem_t<R, true>* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const R re = over_sqrt2(draw<R, GAUSS>(kr, (unsigned long long)i));
    const R im = over_sqrt2(draw<R, GAUSS>(ki, (unsigned long long)i));
    repro::put(out + i, re, im);
  }
}

int grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long want = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * CTAS_PER_SM;
  return (int)(want < cap ? want : cap);
}

template <typename R>
int launch_real(Key k, long long n, int gaussian, void* out,
                cudaStream_t s) {
  if (n > 0) {
    const int g = grid_for(n);
    if (gaussian)
      omega_real<R, true><<<g, THREADS, 0, s>>>(k, n, static_cast<R*>(out));
    else
      omega_real<R, false><<<g, THREADS, 0, s>>>(k, n, static_cast<R*>(out));
  }
  return (int)cudaGetLastError();
}

template <typename R>
int launch_complex(Key kr, Key ki, long long n, int gaussian, void* out,
                   cudaStream_t s) {
  using E = repro::elem_t<R, true>;
  if (n > 0) {
    const int g = grid_for(n);
    if (gaussian)
      omega_complex<R, true><<<g, THREADS, 0, s>>>(kr, ki, n,
                                                    static_cast<E*>(out));
    else
      omega_complex<R, false><<<g, THREADS, 0, s>>>(kr, ki, n,
                                                     static_cast<E*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// n elements of a row-major block; kr0, kr1 the key (of the real part);
// ki0, ki1 that of the imaginary part (ignored for real types); gaussian 1
// for a normal block, 0 for rademacher.
extern "C" {

int sketch_omega_f32(unsigned kr0, unsigned kr1, unsigned, unsigned,
                     long long n, int gaussian, void* out, void* stream) {
  return launch_real<float>({kr0, kr1}, n, gaussian, out,
                            static_cast<cudaStream_t>(stream));
}

int sketch_omega_f64(unsigned kr0, unsigned kr1, unsigned, unsigned,
                     long long n, int gaussian, void* out, void* stream) {
  return launch_real<double>({kr0, kr1}, n, gaussian, out,
                             static_cast<cudaStream_t>(stream));
}

int sketch_omega_c64(unsigned kr0, unsigned kr1, unsigned ki0, unsigned ki1,
                     long long n, int gaussian, void* out, void* stream) {
  return launch_complex<float>({kr0, kr1}, {ki0, ki1}, n, gaussian, out,
                               static_cast<cudaStream_t>(stream));
}

int sketch_omega_c128(unsigned kr0, unsigned kr1, unsigned ki0,
                      unsigned ki1, long long n, int gaussian, void* out,
                      void* stream) {
  return launch_complex<double>({kr0, kr1}, {ki0, ki1}, n, gaussian, out,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
