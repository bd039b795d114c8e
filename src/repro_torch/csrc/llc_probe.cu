// llc_probe: the streaming rate of one working set read `reps` times over,
// in one launch, for the roofline model's last-level-cache measurement
// (repro_torch/api/roofline.py::_timed_stream_rate).
//
// Not a TPU kernel: the JAX package chains `reps` dependent vdots in one
// jitted loop (src/repro/api/roofline.py:165-183), which XLA runs as one
// program.  A chain of torch ops is one launch a dot; at working sets of
// 1-8 MB each dot takes a few microseconds, so launches, not the cache,
// would set the rate and no cliff would show.  This kernel makes all the
// passes in one launch.
//
// Bound: bytes, by design.  Each pass reads the working set once, so a
// call moves reps * 4n bytes; the rate is that over the kernel's time.
// Below the L2's capacity the passes after the first hit L2, above it
// they stream from device memory.  Three things keep the rate honest:
//   - the loads are ld.global.cg (cached in L2 only): a CTA's slice of a
//     1-16 MB working set would otherwise fit its SM's 256 KB L1, and L1
//     would hide L2;
//   - they are volatile asm, so the compiler can neither merge the passes
//     nor hoist a load out of the loop;
//   - the passes are one flat loop over (pass, element), four float4 loads
//     a thread in flight before their sums, so a small working set is not
//     read one latency at a time.
// CTA b owns a fixed slice of the working set for every pass and writes
// the sum of squares of what it read to partial[b].
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ float4 load_cg(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(THREADS)
    llc_probe_kernel(const float4* __restrict__ x, long long n4, int reps,
                     float* __restrict__ partial) {
  const long long blocks = gridDim.x;
  const long long lo = n4 * blockIdx.x / blocks;
  const long long hi = n4 * (blockIdx.x + 1) / blocks;
  const unsigned P = (unsigned)(hi - lo);
  const float4* slice = x + lo;
  float acc[UNROLL] = {0.f, 0.f, 0.f, 0.f};
  if (P > 0) {
    // item t of the flat loop reads element t mod P of the slice; i0 is
    // that of the thread's current t, off[u] the offsets of its unrolled
    // items, each sum below 2P
    const unsigned total = P * (unsigned)reps;
    constexpr unsigned STEP = THREADS * UNROLL;
    const unsigned step_mod = STEP % P;
    unsigned off[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) off[u] = (u * THREADS) % P;
    unsigned i0 = threadIdx.x % P;
    for (unsigned t = threadIdx.x; t < total; t += STEP) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        unsigned i = i0 + off[u];
        if (i >= P) i -= P;
        v[u] = t + u * THREADS < total ? load_cg(slice + i)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        acc[u] = fmaf(v[u].x, v[u].x, acc[u]);
        acc[u] = fmaf(v[u].y, v[u].y, acc[u]);
        acc[u] = fmaf(v[u].z, v[u].z, acc[u]);
        acc[u] = fmaf(v[u].w, v[u].w, acc[u]);
      }
      i0 += step_mod;
      if (i0 >= P) i0 -= P;
    }
  }
  float a = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) a += __shfl_down_sync(0xffffffffu, a, d);
  __shared__ float warp_sums[THREADS / 32];
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w];
    partial[blockIdx.x] = s;
  }
}

}  // namespace

extern "C" int llc_probe_f32(const void* x, long long n4, int reps,
                             void* partial, int blocks, void* stream) {
  llc_probe_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), n4, reps, static_cast<float*>(partial));
  return (int)cudaGetLastError();
}
