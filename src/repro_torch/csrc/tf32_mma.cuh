// The split-precision TF32 tensor-core pieces (sm_90a, mma.sync) that the
// f32 attention kernels share: csrc/hstu_attention.cu (forward and
// backward), csrc/flash_attention_tf32.cu (the softmax forward) and
// csrc/flash_attention_bwd_tf32.cu (its backward). Each
// source includes this header and builds into its own library;
// kernels/build.py hashes the headers with each source, so an edited header
// rebuilds every library.
//
// Every product is mma.sync m16n8k8 in TF32, three times over in split
// precision (3xTF32), each operand x taken as hi + lo with hi = rn_tf32(x)
// and lo = rn_tf32(x - hi); a product is then hi.lo' + lo.hi' + hi.hi'
// (small terms first) accumulated in f32, about 1e-6 relative where one
// TF32 pass keeps about 5e-4.
//
// Fragments (PTX ISA, m16n8k8 .tf32; lane = 4 g + t): A (16 x 8, row) holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, col) holds
// (t, g), (t + 4, g); the accumulator (16 x 8) holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). The accumulator's columns are not the A
// fragment's, so a block of weights that the next product takes as its A
// operand does not move at all: that product's 8 k indices are renumbered,
// k = t standing for column 2t and k = t + 4 for column 2t + 1, and its B
// fragment is read from the rows those columns name. The sum over k is the
// same, added in another order.
//
// An MMA adds its products to its accumulator truncating, not rounding, so
// a long chain of MMAs into one running sum drifts toward zero, most where
// the terms share a sign (ref.flash_attention_fwd_tf32 models it).
// product_abt can therefore keep the small products' sum apart
// (`kApart`), and also take each k step's hi.hi' products from zero and
// add them to the sum by an f32 add that rounds (`kRoundSteps`): the flash
// forward needs its scores that exact (a softmax weight's relative error
// is its score's absolute error). The flash forward also sums each step's
// P V from zero.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The tensor-core shape of every kernel: a block owns 128 rows (8 warps x
// 16) of one (b, h) and walks the other side 32 rows a step.
constexpr int kRows = 128;
constexpr int kStep = 32;
constexpr int kThreads = 256;

// A (B, T, heads, hd) strided view with unit stride along hd.
struct View {
  const float* p;
  int64_t sb, st, sh;
};

__device__ __forceinline__ const float* head_base(const View& x, int b, int h) {
  return x.p + b * x.sb + h * x.sh;
}

// x = hi + lo in two TF32 values, each rounded to nearest (the MMA would
// otherwise truncate the low 13 bits of an f32 register). cvt.rn (ties to
// even) is one instruction on sm_90 (F2FP.TF32); cvt.rna (ties away) is
// three (a finiteness test, an add, a mask), and the splits are most of the
// instructions around each MMA. The two differ only at exact ties.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// d += a b for one m16n8k8 TF32 fragment triple, over the warp.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of four f32 values, split.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
    split_tf32(x2, hi[2], lo[2]);
    split_tf32(x3, hi[3], lo[3]);
  }
};

// small += hi.lo' + lo.hi', then big += hi.hi', b given as its two f32
// values and split here. With big and small the same accumulator, d += a b
// in 3xTF32 (mma_tf32x3).
__device__ __forceinline__ void mma_tf32x3_apart(float (&big)[4], float (&small)[4],
                                                 const FragA& a, float b0, float b1) {
  uint32_t bhi[2], blo[2];
  split_tf32(b0, bhi[0], blo[0]);
  split_tf32(b1, bhi[1], blo[1]);
  mma_tf32(small, a.hi, blo);
  mma_tf32(small, a.lo, bhi);
  mma_tf32(big, a.hi, bhi);
}

__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const FragA& a, float b0,
                                           float b1) {
  mma_tf32x3_apart(d, d, a, b0, b1);
}

// 16-byte global -> shared copy that completes at the next cp_async_wait;
// zero-fills the 16 bytes instead where `full` is false (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Every committed group but the newest `n` has landed in shared memory.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// Four 8 x 4 f32 blocks of shared memory (ldmatrix's 8 x 8 b16) into the
// warp's registers: lanes 8i .. 8i + 7 name the rows of block i (16 bytes
// each), and lane 4g + t gets r[i] = block i's row g, float t.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Rows [t0, t0 + kN) of one (b, head) into dst (row stride kD + 4 floats),
// columns [0, kD): the view's columns [0, d) where the row is below T, zero
// elsewhere. With `vec` (d % 4 == 0, every row 16-byte aligned) by
// cp.async, landing at the next cp_async_wait; else by plain loads and
// stores, a barrier away from every reader.
template <int kD, int kN>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int64_t st,
                                          int t0, int T, int d, bool vec) {
  constexpr int kLd = kD + 4, kChunks = kD / 4;
  if (vec) {
    for (int u = threadIdx.x; u < kN * kChunks; u += kThreads) {
      const int r = u / kChunks, c = u % kChunks;
      const bool full = t0 + r < T && 4 * c < d;
      cp_async16(dst + r * kLd + 4 * c, full ? base + (t0 + r) * st + 4 * c : base, full);
    }
  } else {
    for (int u = threadIdx.x; u < kN * kD; u += kThreads) {
      const int r = u / kD, c = u % kD;
      dst[r * kLd + c] = t0 + r < T && c < d ? __ldg(base + (t0 + r) * st + c) : 0.f;
    }
  }
}

// c[nb] += A B^T for the warp's 16 rows `a` (16 x kD) against 32 rows `b`
// (32 x kD), both row-major with stride kD + 4: the 16 x 32 block of row
// products as four 16 x 8 accumulators. Both fragments come by ldmatrix
// (A: one x4 a k step; B: one x4 for two n blocks), its 16-byte rows in
// distinct banks at a stride of 4 mod 32 words. With kApart the small
// products (hi.lo' + lo.hi') run in a chain of their own, added to c at the
// end: a small term added to the large running sum loses its low bits at
// every MMA. Without it every product runs in c's one chain. With
// kRoundSteps (and kApart) each k step's hi.hi' MMA runs from zero and is
// added to c by an f32 add: c then carries no truncation of its own, only
// the rounding of 8-column partial sums.
template <int kD, bool kApart = false, bool kRoundSteps = false>
__device__ __forceinline__ void product_abt(float (&c)[4][4], const float* a,
                                            const float* b, int lane) {
  static_assert(kApart || !kRoundSteps, "kRoundSteps keeps the small products apart too");
  constexpr int kLd = kD + 4;
  float small[4][4] = {};
  const int m = lane >> 3, r = lane & 7;
  const float* pa = a + (r + 8 * (m & 1)) * kLd + 4 * (m >> 1);  // rows g | g + 8, cols t | t + 4
  const float* pb = b + (r + 8 * (m >> 1)) * kLd + 4 * (m & 1);  // (b0, b1) of nb, then nb + 1
#pragma unroll
  for (int k0 = 0; k0 < kD; k0 += 8) {
    uint32_t x[4];
    ldsm_x4(x, pa + k0);
    FragA fa;
    fa.set(__uint_as_float(x[0]), __uint_as_float(x[1]), __uint_as_float(x[2]),
           __uint_as_float(x[3]));
#pragma unroll
    for (int nb = 0; nb < 4; nb += 2) {
      uint32_t y[4];
      ldsm_x4(y, pb + 8 * nb * kLd + k0);
      if constexpr (kRoundSteps) {
        float h0[4] = {}, h1[4] = {};
        mma_tf32x3_apart(h0, small[nb], fa, __uint_as_float(y[0]), __uint_as_float(y[1]));
        mma_tf32x3_apart(h1, small[nb + 1], fa, __uint_as_float(y[2]), __uint_as_float(y[3]));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[nb][e] += h0[e];
          c[nb + 1][e] += h1[e];
        }
      } else {
        mma_tf32x3_apart(c[nb], kApart ? small[nb] : c[nb], fa, __uint_as_float(y[0]),
                         __uint_as_float(y[1]));
        mma_tf32x3_apart(c[nb + 1], kApart ? small[nb + 1] : c[nb + 1], fa,
                         __uint_as_float(y[2]), __uint_as_float(y[3]));
      }
    }
  }
  if constexpr (kApart) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nb][e] += small[nb][e];
    }
  }
}

// acc[nd] += P X for P the 16 x 32 block held as accumulators (p[kc] its
// columns 8 kc .. 8 kc + 7) and X 32 rows of kD (stride kD + 4): the A
// fragment is P's own registers, k = t standing for column 2t and k = t + 4
// for 2t + 1, so the B fragment reads X's rows 2t and 2t + 1. Two n blocks
// share each read: n = g of blocks 2p and 2p + 1 stands for X's columns
// 16p + 2g and 16p + 2g + 1, one 8-byte load (banks 8t + 2g and 8t + 4 + 2g
// a half warp: no conflicts). acc[2p][e] and acc[2p + 1][e] thus hold
// output columns 16p + 4t + 2 (e & 1) and that + 1.
template <int kD>
__device__ __forceinline__ void product_ab(float (&acc)[kD / 8][4], const float (&p)[4][4],
                                           const float* x, int g, int t) {
  constexpr int kLd = kD + 4;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    FragA fa;
    fa.set(p[kc][0], p[kc][2], p[kc][1], p[kc][3]);
    const float* r0 = x + (8 * kc + 2 * t) * kLd + 2 * g;
#pragma unroll
    for (int pr = 0; pr < kD / 16; ++pr) {
      const float2 u = *reinterpret_cast<const float2*>(r0 + 16 * pr);
      const float2 w = *reinterpret_cast<const float2*>(r0 + kLd + 16 * pr);
      mma_tf32x3(acc[2 * pr], fa, u.x, w.x);
      mma_tf32x3(acc[2 * pr + 1], fa, u.y, w.y);
    }
  }
}

// Rows r0 + g (+ 8) of the warp's 16 x kD accumulators times `mul`
// (columns as product_ab leaves them: 16p + 4t .. 16p + 4t + 3 from
// acc[2p], acc[2p + 1]) into a contiguous (B, T, heads, hd) output, below
// T and hd; a float4 a row and p where hd % 4 == 0.
template <int kD>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[kD / 8][4], float mul,
                                           int b, int h, int r0, int T, int heads, int hd,
                                           int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= T) continue;
    float* dst = out + ((static_cast<int64_t>(b) * T + row) * heads + h) * hd;
#pragma unroll
    for (int pr = 0; pr < kD / 16; ++pr) {
      const int c = 16 * pr + 4 * t;
      const float x[4] = {acc[2 * pr][2 * half] * mul, acc[2 * pr + 1][2 * half] * mul,
                          acc[2 * pr][2 * half + 1] * mul, acc[2 * pr + 1][2 * half + 1] * mul};
      if (hd % 4 == 0 && c < hd) {
        *reinterpret_cast<float4*>(dst + c) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < hd) dst[c + j] = x[j];
        }
      }
    }
  }
}

}  // namespace
