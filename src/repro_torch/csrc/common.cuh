// Element helpers shared by the repro_torch CUDA kernels.
//
// Complex tensors are read in PyTorch's interleaved layout as float2 /
// double2 (8- / 16-byte aligned loads); real tensors as float / double.
// Every product accumulates in the working precision of the data: float
// for float32 / complex64, double for float64 / complex128.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

namespace repro {

template <typename R, bool CPLX>
using elem_t = std::conditional_t<
    CPLX, std::conditional_t<std::is_same_v<R, float>, float2, double2>, R>;

// (re, im) += conj(a) * b
__device__ __forceinline__ void conj_mul_acc(float a, float b, float& re,
                                             float&) {
  re = fmaf(a, b, re);
}
__device__ __forceinline__ void conj_mul_acc(double a, double b, double& re,
                                             double&) {
  re = fma(a, b, re);
}
__device__ __forceinline__ void conj_mul_acc(float2 a, float2 b, float& re,
                                             float& im) {
  re = fmaf(a.x, b.x, re);
  re = fmaf(a.y, b.y, re);
  im = fmaf(a.x, b.y, im);
  im = fmaf(-a.y, b.x, im);
}
__device__ __forceinline__ void conj_mul_acc(double2 a, double2 b, double& re,
                                             double& im) {
  re = fma(a.x, b.x, re);
  re = fma(a.y, b.y, re);
  im = fma(a.x, b.y, im);
  im = fma(-a.y, b.x, im);
}

// (re, im) += a * b
__device__ __forceinline__ void mul_acc(float a, float b, float& re, float&) {
  re = fmaf(a, b, re);
}
__device__ __forceinline__ void mul_acc(double a, double b, double& re,
                                        double&) {
  re = fma(a, b, re);
}
__device__ __forceinline__ void mul_acc(float2 a, float2 b, float& re,
                                        float& im) {
  re = fmaf(a.x, b.x, re);
  re = fmaf(-a.y, b.y, re);
  im = fmaf(a.x, b.y, im);
  im = fmaf(a.y, b.x, im);
}
__device__ __forceinline__ void mul_acc(double2 a, double2 b, double& re,
                                        double& im) {
  re = fma(a.x, b.x, re);
  re = fma(-a.y, b.y, re);
  im = fma(a.x, b.y, im);
  im = fma(a.y, b.x, im);
}

__device__ __forceinline__ void put(float* p, float re, float) { *p = re; }
__device__ __forceinline__ void put(double* p, double re, double) { *p = re; }
__device__ __forceinline__ void put(float2* p, float re, float im) {
  *p = make_float2(re, im);
}
__device__ __forceinline__ void put(double2* p, double re, double im) {
  *p = make_double2(re, im);
}

__device__ __forceinline__ void get(float v, float& re, float& im) {
  re = v;
  im = 0.f;
}
__device__ __forceinline__ void get(double v, double& re, double& im) {
  re = v;
  im = 0.0;
}
__device__ __forceinline__ void get(float2 v, float& re, float& im) {
  re = v.x;
  im = v.y;
}
__device__ __forceinline__ void get(double2 v, double& re, double& im) {
  re = v.x;
  im = v.y;
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
