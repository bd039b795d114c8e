// flash_attention_sm90: causal / sliding-window GQA attention for Hopper,
// the bf16 / f16 route at head dims 64, 80, 96, 128 and 256.
//
// Replaces, with flash_attention.cu (the general route: f32, the other
// head dims, unaligned views), the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py flash_attention_kernel (:96;
// body _fa_kernel :32).  Same function as flash_attention.cu and ref.py:
// softmax(q k^T * scale + mask) v with the running max m, sum l and output
// acc in f32, queries end-aligned to the keys (query row r sits at absolute
// position r + Skv - Sq), the kv head of query head h being h / (Hq / Hkv),
// masked probabilities exactly 0 and alpha kept at 1 while a row has seen
// no key, the scale applied in f32 after the dot, P rounded to the input
// type for the second product.  No atomics: the same inputs give the same
// bits.
//
// Bound on the H100: operations.  At the prefill's shape (B 4, Hq 32,
// Hkv 8, S 2048, D 128, bf16, causal) the two products are 137.4 GFLOP,
// 0.139 ms at 989 TFLOP/s, against 168 MB of q, k, v and o, 0.050 ms at
// 3.35 TB/s.  What the design does about it:
//   * A CTA of three warpgroups works on items of (128 query rows, q head,
//     batch).  A producer warpgroup (one thread of it) issues TMA loads: an
//     item's Q once, then its K and V tiles through a ring of STAGES stages
//     of shared memory, each with full (TMA bytes arrived) and empty
//     (consumers done) mbarriers.  Two consumer warpgroups own 64 query
//     rows each; setmaxnreg moves the producer's registers to them.
//   * TMA reads the strided (D, S, H, B) views through 4-D tensor maps
//     built on the host per call, in boxes of 64 elements (128 bytes) along
//     D with the 128-byte swizzle; rows past Sq / Skv arrive as zeros.
//   * Both products are wgmma with f32 accumulators in registers:
//     S = Q K^T (m64nBKk16, Q and K K-major from shared memory), then
//     O += P V (m64nDk16, P from registers, V MN-major from shared memory,
//     as TMA stored it).  S's accumulator fragment is P's A fragment, so P
//     never touches shared memory; O is rescaled by alpha in registers.
//   * Softmax in base 2 and in f32: p = 2^(s c - m c) with c = scale
//     log2(e) is one FFMA and one ex2 per score; the row max and sum come
//     from quad shuffles of the fragment.  Masks are applied only on key
//     tiles that cross the causal diagonal, the window's edge or Skv (two
//     integer compares per score there): full tiles take no test.
//   * Overlap: warpgroups take turns to issue their products, so one's
//     softmax runs while the other's products keep the tensor cores busy;
//     within a warpgroup, a tile's softmax runs while the previous tile's
//     P V is in flight.  CTAs are persistent, one per SM, and the next
//     work item's Q is loaded while the current one finishes; O leaves
//     through shared memory and TMA stores (rows past Sq not written).
//   * Schedule: heaviest query tiles (last under causality) first; within a
//     query tile the q heads in head order, so the Hq / Hkv heads that share
//     a kv head run side by side and share K and V in L2.  Key tiles that
//     causality or the window rule out for a whole item are never loaded.
//   * Head dims 80 and 96 (stablelm-3b's 80) run the D 128 kernel on tensor
//     maps whose D extent is the true D: TMA fills the boxes' columns past
//     D with zeros (no HBM bytes) and does not store them, so Q K^T adds
//     exact zeros and P V's extra columns are dropped; each output element
//     has the bits of the D 128 kernel on zero-padded inputs.  The scale is
//     the caller's (the wrapper's default is the true D's).  It costs the
//     D 128 kernel's tensor-core work: 1.6x the products at D 80, 1.33x at
//     D 96.
#include "common.cuh"
#include "sm90.cuh"  // mbarriers, named barriers, the tensor-map encoder

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <float.h>
#include <stdint.h>
#include <stdio.h>

namespace {

using namespace repro::sm90;

constexpr int BQ = 128;       // query rows per CTA, 64 per consumer warpgroup
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CHUNK = 64;     // elements of one 128-byte swizzled row

// Keys per tile and depth of the K / V ring: what Q + stages x (K + V)
// leave room for in the 227 KB of shared memory a CTA may have.
template <int D>
struct Tiles {
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int STAGES = D <= 128 ? 3 : 2;
  static constexpr size_t SMEM =
      1024 /* alignment slack */ + (size_t)(BQ + 2 * STAGES * BK) * D * 2;
};

struct Args {
  int Hq, Hkv, Sq, Skv, B;
  int causal;
  int window;       // <= 0: no window
  float scale_log2; // |sm_scale| log2(e), at least FLT_MIN
  int negate;       // sm_scale < 0: S is computed as -Q K^T
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Shared memory -> global through a tensor map; the box's rows past the
// tensor's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// 2^x by the special-function unit, subnormal results flushed to 0 (what
// exp2f compiles to under fast math)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define R32                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31"
#define R64                                                              \
  R32 ", "                                                               \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "    \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63"
#define R128                                                             \
  R64 ", "                                                               \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "    \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "    \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "       \
  "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "   \
  "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "   \
  "%124, %125, %126, %127"
#define D8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D32(i) D8(i), D8(i + 8), D8(i + 16), D8(i + 24)
#define D64(i) D32(i), D32(i + 32)
#define D128 D64(0), D64(64)

// d (m64nN, f32) = SA A B + (scale_d ? d : 0), A and B from shared memory
// (both K-major) and SA = +-1, and d += A B with A from registers and B
// MN-major.
#define WGMMA_FNS(TY, CTY)                                                 \
  template <int SA>                                                        \
  __device__ __forceinline__ void wgmma_ss(float(&d)[32], uint64_t da,     \
                                           uint64_t db, int scale_d,       \
                                           CTY) {                          \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
        "{" R32 "}, %32, %33, p, %35, 1, 0, 0;\n}\n"                       \
        : D32(0)                                                           \
        : "l"(da), "l"(db), "r"(scale_d), "n"(SA));                        \
  }                                                                        \
  template <int SA>                                                        \
  __device__ __forceinline__ void wgmma_ss(float(&d)[64], uint64_t da,     \
                                           uint64_t db, int scale_d,       \
                                           CTY) {                          \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
        "{" R64 "}, %64, %65, p, %67, 1, 0, 0;\n}\n"                       \
        : D64(0)                                                           \
        : "l"(da), "l"(db), "r"(scale_d), "n"(SA));                        \
  }                                                                        \
  __device__ __forceinline__ void wgmma_rs(float(&d)[32],                  \
                                           const uint32_t(&a)[4],          \
                                           uint64_t db, CTY) {             \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
        "{" R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"           \
        : D32(0)                                                           \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));    \
  }                                                                        \
  __device__ __forceinline__ void wgmma_rs(float(&d)[64],                  \
                                           const uint32_t(&a)[4],          \
                                           uint64_t db, CTY) {             \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "       \
        "{" R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"           \
        : D64(0)                                                           \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));    \
  }                                                                        \
  __device__ __forceinline__ void wgmma_rs(float(&d)[128],                 \
                                           const uint32_t(&a)[4],          \
                                           uint64_t db, CTY) {             \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                      \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "       \
        "{" R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"     \
        : D128                                                             \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));    \
  }

WGMMA_FNS("bf16", __nv_bfloat16)
WGMMA_FNS("f16", __half)

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ----------------------------------------------------------------- kernel
// Shared memory (1024-byte aligned for the 128-byte swizzle): Q as D / 64
// boxes of (BQ rows x 64), then per stage K and V as D / 64 boxes of
// (BK rows x 64) each.  Row r, column c of a box sits at byte
// r * 128 + ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2 of it.
//
// Persistent: each CTA walks the work items (query tile, q head, batch)
// blockIdx.x, + gridDim.x, ...  The producer loads the next item's Q as soon
// as the consumers' last S product of the current one has read Q, so the
// load overlaps that item's last softmax, P V and output.  The output goes
// out by TMA stores from the shared memory of the item's last K / V stage.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    fa_sm90_kernel(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const __grid_constant__ CUtensorMap tmo, const Args a) {
  constexpr int BK = Tiles<D>::BK;
  constexpr int STAGES = Tiles<D>::STAGES;
  constexpr int NCH = D / CHUNK;              // 128-byte boxes along D
  constexpr uint32_t Q_BYTES = BQ * D * 2;
  constexpr uint32_t KV_BYTES = BK * D * 2;   // one K (or V) tile

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 3 * STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  auto sK = [&](int s) { return sQ + Q_BYTES + 2 * s * KV_BYTES; };
  auto sV = [&](int s) { return sK(s) + KV_BYTES; };
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t q_empty = smem_u32(&bars[1]);
  auto k_full = [&](int s) { return smem_u32(&bars[2 + s]); };
  auto v_full = [&](int s) { return smem_u32(&bars[2 + STAGES + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[2 + 2 * STAGES + s]); };

  // Work item w: heaviest (last) query tiles first; within a query tile the
  // q heads in order, those of one kv head side by side.
  const int nqt = (a.Sq + BQ - 1) / BQ;
  const int n_items = nqt * a.Hq * a.B;
  const int off = a.Skv - a.Sq;
  struct Item {
    int q_lo, h, b, hk, t_begin, t_end;
  };
  auto item = [&](int w) {
    Item it;
    const int per_tile = a.Hq * a.B;
    const int qt = nqt - 1 - w / per_tile;
    const int rem = w % per_tile;
    it.b = rem / a.Hq;
    it.h = rem % a.Hq;
    it.hk = it.h / (a.Hq / a.Hkv);
    it.q_lo = qt * BQ;
    // the key tiles any row of the item may see: the rest are skipped
    const int q_valid = min(BQ, a.Sq - it.q_lo);
    const int i_lo = it.q_lo + off, i_hi = it.q_lo + q_valid - 1 + off;
    int kv_lo = 0, kv_hi = a.Skv;
    if (a.causal) kv_hi = min(kv_hi, i_hi + 1);
    if (a.window > 0) kv_lo = max(0, i_lo - a.window + 1);
    it.t_begin = kv_lo / BK;
    it.t_end = kv_hi > kv_lo ? (kv_hi + BK - 1) / BK : it.t_begin;
    return it;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);     // every consumer thread arrives
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0, qi = 0;  // tiles and items so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const Item x = item(w);
        for (int t = x.t_begin; t < x.t_end; ++t, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full(s), KV_BYTES);
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            tma_load(sK(s) + c * BK * 128, &tmk, k_full(s), c * CHUNK,
                     t * BK, x.hk, x.b);
          mbar_expect_tx(v_full(s), KV_BYTES);
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            tma_load(sV(s) + c * BK * 128, &tmv, v_full(s), c * CHUNK,
                     t * BK, x.hk, x.b);
          if (t == x.t_begin) {  // Q once the last item's is consumed
            mbar_wait(q_empty, (qi & 1) ^ 1);
            mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
            for (int c = 0; c < NCH; ++c)
              tma_load(sQ + c * BQ * 128, &tmq, q_full, c * CHUNK, x.q_lo,
                       x.h, x.b);
            ++qi;
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;      // 0 or 1: rows 64 wg + ...
    const int lane = threadIdx.x % 32;
    // this thread's rows in the item: r0 holds d[4j], d[4j+1]; r0 + 8
    // d[4j+2], d[4j+3], at columns 8j + cpair, + 1
    const int r0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int cpair = 2 * (lane % 4);
    const uint32_t sQ_wg = sQ + wg * 64 * 128;  // the warpgroup's Q rows

    float o[D / 2];
    float m0, m1, l0, l1, alpha0, alpha1;
    float sc[BK / 2];    // S of the newest tile, then its probabilities
    uint32_t p[BK / 4];  // P of the tile before, in the input type
    int i0, i1, wg_lo, wg_hi;  // absolute positions of rows of the item

    // S = +-Q K^T of the tile in stage st (unscaled, f32; negated for a
    // negative scale) issued as one wgmma group
    auto issue_s = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // box kk / 4; 16 columns (32 bytes) further per step within it
        const uint32_t c = kk / 4, w = (kk % 4) * 32;
        const uint64_t da = sw128_desc(sQ_wg + c * BQ * 128 + w, 16, 1024);
        const uint64_t db = sw128_desc(sK(st) + c * BK * 128 + w, 16, 1024);
        if (a.negate)
          wgmma_ss<-1>(sc, da, db, kk > 0, T());
        else
          wgmma_ss<1>(sc, da, db, kk > 0, T());
      }
      wg_commit();
    };
    // O += P V of the tile in stage st as one wgmma group.  V's box rows
    // are keys (K), its columns D (N): MN-major, the next 64 columns one
    // box (BK x 128 bytes) further on.
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                p[4 * kk + 3]};
        wgmma_rs(o, pa, sw128_desc(sV(st) + kk * 16 * 128, BK * 128, 1024),
                 T());
      }
      wg_commit();
    };
    // Online softmax of tile t in place in sc.  m stays in the units of
    // the product S (c = |scale| log2(e) > 0, a negative scale having gone
    // into S's sign), so p = 2^(s c - m c) is one FFMA and one ex2.  Masked
    // elements (only on tiles that need it) become -inf, so p = 0 exactly.
    auto softmax = [&](int t) {
      const int k_lo = t * BK;
      const float c = a.scale_log2;
      const bool full =
          k_lo + BK <= a.Skv && (!a.causal || k_lo + BK - 1 <= wg_lo) &&
          (a.window <= 0 || k_lo > wg_hi - a.window);
      if (!full) {
        // row r sees the tile's columns lo_r <= col <= hi_r; sc[x] is
        // column (x / 4) * 8 + (x & 1) + cpair
        int hi0 = a.Skv - 1 - k_lo, hi1 = hi0;
        int lo0 = -(1 << 30), lo1 = lo0;
        if (a.causal) {
          hi0 = min(hi0, i0 - k_lo);
          hi1 = min(hi1, i1 - k_lo);
        }
        if (a.window > 0) {
          lo0 = i0 - a.window + 1 - k_lo;
          lo1 = i1 - a.window + 1 - k_lo;
        }
        hi0 -= cpair;
        hi1 -= cpair;
        lo0 -= cpair;
        lo1 -= cpair;
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
          const int col = (x / 4) * 8 + (x & 1);
          const int lo = (x & 2) ? lo1 : lo0, hi = (x & 2) ? hi1 : hi0;
          if (col < lo || col > hi) sc[x] = -INFINITY;
        }
      }
      // four partial maxima and sums per row: short dependency chains
      float pm0[4], pm1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pm0[u] = fmaxf(sc[4 * u], sc[4 * u + 1]);
        pm1[u] = fmaxf(sc[4 * u + 2], sc[4 * u + 3]);
      }
#pragma unroll
      for (int x = 16; x < BK / 2; x += 4) {
        pm0[x / 4 % 4] = fmaxf(pm0[x / 4 % 4], fmaxf(sc[x], sc[x + 1]));
        pm1[x / 4 % 4] = fmaxf(pm1[x / 4 % 4], fmaxf(sc[x + 2], sc[x + 3]));
      }
      float mx0 = fmaxf(fmaxf(pm0[0], pm0[1]), fmaxf(pm0[2], pm0[3]));
      float mx1 = fmaxf(fmaxf(pm1[0], pm1[1]), fmaxf(pm1[2], pm1[3]));
#pragma unroll
      for (int sh = 1; sh <= 2; sh *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // m == -inf: nothing seen yet, O and l are 0 and alpha stays 1
      alpha0 = m0 == -INFINITY ? 1.f : exp2_ftz((m0 - mn0) * c);
      alpha1 = m1 == -INFINITY ? 1.f : exp2_ftz((m1 - mn1) * c);
      // a row that sees no key yet: every s is -inf, 2^(-inf - 0) = 0
      const float b0 = mn0 == -INFINITY ? 0.f : mn0 * c;
      const float b1 = mn1 == -INFINITY ? 0.f : mn1 * c;
      float ps0[4] = {0.f, 0.f, 0.f, 0.f}, ps1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int x = 0; x < BK / 2; x += 4) {
        sc[x] = exp2_ftz(fmaf(sc[x], c, -b0));
        sc[x + 1] = exp2_ftz(fmaf(sc[x + 1], c, -b0));
        sc[x + 2] = exp2_ftz(fmaf(sc[x + 2], c, -b1));
        sc[x + 3] = exp2_ftz(fmaf(sc[x + 3], c, -b1));
        ps0[x / 4 % 4] += sc[x] + sc[x + 1];
        ps1[x / 4 % 4] += sc[x + 2] + sc[x + 3];
      }
      // this thread's share of the row sums; quad-summed at the end
      l0 = l0 * alpha0 + ((ps0[0] + ps0[1]) + (ps0[2] + ps0[3]));
      l1 = l1 * alpha1 + ((ps1[0] + ps1[1]) + (ps1[2] + ps1[3]));
      m0 = mn0;
      m1 = mn1;
    };
    // P in the input type: the S fragment is the A fragment of P V
    auto to_p = [&] {
#pragma unroll
      for (int x = 0; x < BK / 4; ++x)
        p[x] = pack2(sc[2 * x], sc[2 * x + 1], T());
    };
    auto rescale_o = [&] {
#pragma unroll
      for (int x = 0; x < D / 2; x += 4) {
        o[x] *= alpha0;
        o[x + 1] *= alpha0;
        o[x + 2] *= alpha1;
        o[x + 3] *= alpha1;
      }
    };
    // Turns between the two warpgroups (named barriers 1 and 2): one
    // issues its wgmma only on its turn and then hands the turn over, so
    // one's softmax runs while the other's products keep the tensor cores
    // busy.  Warpgroup 0 takes an item's first turn; both take n + 1, and
    // warpgroup 1 hands over all but its last, so every phase completes.
    auto turn_begin = [&] {
      asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
    };
    auto turn_end = [&](bool last) {
      if (!(last && wg == 1))
        asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
    };

    int it = 0, qi = 0;  // tiles and items so far
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const Item x = item(w);
      i0 = x.q_lo + r0 + off;
      i1 = i0 + 8;
      wg_lo = x.q_lo + wg * 64 + off;
      wg_hi = wg_lo + 63;
#pragma unroll
      for (int u = 0; u < D / 2; ++u) o[u] = 0.f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
      // n >= 1: the wrapper refuses causal Sq > Skv and windows < 1, so
      // every row sees a key (its own position under causality, key
      // Skv - 1 otherwise)
      const int n = x.t_end - x.t_begin;
      // Within a warpgroup, tile i's softmax runs while the wgmma of P V
      // for tile i - 1 is in flight; O is rescaled by tile i's alpha once
      // that P V is done, off the warpgroups' turns.  Q is released once
      // the last S is done.
      if (wg == 1) asm volatile("bar.arrive 1, 256;" ::: "memory");
      mbar_wait(q_full, qi & 1);
      mbar_wait(k_full(it % STAGES), (it / STAGES) & 1);
      turn_begin();
      fence_regs(sc);
      wg_fence();
      issue_s(it % STAGES);
      turn_end(false);
      wg_wait<0>();
      fence_regs(sc);
      if (n == 1) mbar_arrive(q_empty);
      softmax(x.t_begin);
      to_p();
      for (int i = 1; i < n; ++i) {
        const int st = (it + i) % STAGES, prev = (it + i - 1) % STAGES;
        mbar_wait(k_full(st), ((it + i) / STAGES) & 1);
        turn_begin();
        fence_regs(sc);
        wg_fence();
        issue_s(st);
        mbar_wait(v_full(prev), ((it + i - 1) / STAGES) & 1);
        fence_regs(o);
        wg_fence();
        issue_pv(prev);
        turn_end(false);
        wg_wait<1>();  // S of tile i; P V of tile i - 1 may still run
        fence_regs(sc);
        if (i == n - 1) mbar_arrive(q_empty);
        softmax(x.t_begin + i);
        wg_wait<0>();
        fence_regs(o);
        fence_regs(p);  // p stays live (and unchanged) until its wgmma ends
        mbar_arrive(empty(prev));
        to_p();
        rescale_o();  // by tile i's alpha, before P V of tile i is issued
      }
      const int last = (it + n - 1) % STAGES;
      mbar_wait(v_full(last), ((it + n - 1) / STAGES) & 1);
      turn_begin();
      fence_regs(o);
      wg_fence();
      issue_pv(last);
      turn_end(true);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(p);

      // Epilogue: O / l in the input type, out through the last tile's
      // stage (its K and V are consumed once both warpgroups' products
      // are done) as 128-byte swizzled boxes of 64 columns, the layout TMA
      // stores, then one TMA store per box of the warpgroup's 64 rows
      // (rows past Sq are not written); the stage is released once the
      // stores have read it.
#pragma unroll
      for (int sh = 1; sh <= 2; sh *= 2) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
        l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const uint32_t sO = sK(last);
      bar_sync(3, 256);
#pragma unroll
      for (int u = 0; u < D / 2; u += 4) {
        const int j = u / 4;  // 8-column chunk
        const uint32_t box = sO + (j / 8) * BQ * 128;
        const uint32_t c16 = (j % 8) * 16 + cpair * 2;
        const uint32_t w0 = pack2(o[u] * inv0, o[u + 1] * inv0, T());
        const uint32_t w1 = pack2(o[u + 2] * inv1, o[u + 3] * inv1, T());
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(
                         box + r0 * 128 + (c16 ^ ((r0 & 7) << 4))),
                     "r"(w0)
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(
                         box + (r0 + 8) * 128 + (c16 ^ (((r0 + 8) & 7) << 4))),
                     "r"(w1)
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_sync(4 + wg, 128);
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_store(&tmo, sO + c * BQ * 128 + wg * 64 * 128, c * CHUNK,
                    x.q_lo + wg * 64, x.h, x.b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      bar_sync(4 + wg, 128);
      mbar_arrive(empty(last));
      it += n;
      ++qi;
    }
  }
}

// ------------------------------------------------------------------- host
// The 4-D map (D, S, H, B) of one operand given its (B, H, S, D) element
// strides; boxes of 64 x rows x 1 x 1, 128-byte swizzle; loads read zeros
// past D and S, stores write nothing there.
bool make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr,
              long long B, long long H, long long S, long long D,
              const long long* st, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) {
    fprintf(stderr,
            "flash_attention_sm90: cuTensorMapEncodeTiled not found\n");
    return false;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {CHUNK, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r =
      enc(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "flash_attention_sm90: cuTensorMapEncodeTiled: %d\n",
            (int)r);
    return false;
  }
  return true;
}

// The kernel built for head dim D on operands of head dim d <= D (d < D:
// the maps' columns d..D-1 load as zeros and are not stored).
template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o,
             long long B, long long Hq, long long Hkv, long long Sq,
             long long Skv, long long d, const long long* strides,
             int causal, int window, float scale, void* stream) {
  const CUtensorMapDataType dt = std::is_same_v<T, __half>
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tmq, tmk, tmv, tmo;
  if (!make_map(&tmq, dt, q, B, Hq, Sq, d, strides, BQ) ||
      !make_map(&tmo, dt, o, B, Hq, Sq, d, strides + 12, BQ / 2) ||
      !make_map(&tmk, dt, k, B, Hkv, Skv, d, strides + 4, Tiles<D>::BK) ||
      !make_map(&tmv, dt, v, B, Hkv, Skv, d, strides + 8, Tiles<D>::BK))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.Hq = (int)Hq;
  a.Hkv = (int)Hkv;
  a.Sq = (int)Sq;
  a.Skv = (int)Skv;
  a.B = (int)B;
  a.causal = causal;
  a.window = window;
  // with c = max(|scale| log2(e), FLT_MIN) > 0, -inf * c stays -inf for a
  // masked element even at scale 0 (then every visible p is 2^0 = 1)
  a.scale_log2 = fmaxf((float)(fabs((double)scale) * 1.4426950408889634),
                       FLT_MIN);
  a.negate = scale < 0.f;
  const size_t smem = Tiles<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fa_sm90_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one CTA per SM, each walking its share of the items
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const long long items = ((Sq + BQ - 1) / BQ) * Hq * B;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  fa_sm90_kernel<T, D><<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(tmq, tmk, tmv,
                                                              tmo, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, long long B,
           long long Hq, long long Hkv, long long Sq, long long Skv,
           long long D, const long long* strides, int causal, int window,
           float scale, void* stream) {
  switch (D) {
    case 64:
      return launch_d<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides,
                             causal, window, scale, stream);
    case 80:
    case 96:
    case 128:
      return launch_d<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides,
                              causal, window, scale, stream);
    case 256:
      return launch_d<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides,
                              causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D), o like q, each given by its
// element strides (strides[0:4] q, [4:8] k, [8:12] v, [12:16] o; the last
// of each is 1, the others and the base pointers multiples of 16 bytes),
// D in {64, 80, 96, 128, 256}.  Returns the CUDA error of the launch (0:
// none).
#define FA_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      long long B, long long Hq, long long Hkv,             \
                      long long Sq, long long Skv, long long D,             \
                      const long long* strides, int causal, int window,     \
                      float scale, void* stream) {                          \
    return launch<T>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides, causal,   \
                     window, scale, stream);                                \
  }

FA_ENTRY(flash_attention_sm90_bf16, __nv_bfloat16)
FA_ENTRY(flash_attention_sm90_f16, __half)
