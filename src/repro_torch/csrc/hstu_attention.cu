// HSTU pointwise attention for Hopper (sm_90a), forward and backward, f32:
//   O[b,i,h,:] = sum_j m(i,j) * silu(scale * q_i . k_j) * inv_t * v_j
// with m(i,j) = [j < T] (and [i >= j] when causal), scale = 1/sqrt(dqk) and
// inv_t = 1/T. There is no softmax, so nothing is normalised across j: the
// output is a plain sum over key tiles.
//
// Replaces the Pallas TPU kernel `hstu_attention`
// (src/repro/kernels/hstu_attention.py), which walks a (b*h, q block,
// k block) grid sequentially and carries an f32 accumulator in VMEM across
// the k axis; JAX differentiates the layer's jnp form instead, so the TPU
// has no backward kernel. Hopper blocks run in no order and carry nothing
// between them, so each block owns one (b, h) and one tile of the rows it
// writes and loops over the other side's tiles itself:
//   - forward: one block per 64-row query tile; it loops over the key
//     tiles up to the diagonal (the tiles wholly above it are skipped when
//     causal: every entry there is masked, so the function is the same);
//   - dq: one block per 128-row query tile, looping over the same keys;
//     dQ = scale * dS K with dS = m * dA * inv_t * silu'(scale S),
//     dA = dO V^T and silu'(x) = sig(x) (1 + x (1 - sig(x)));
//   - dk/dv: one block per 128-row key tile, looping over the queries from
//     the diagonal on; dK = scale * dS^T Q and dV = (m * silu(scale S) * inv_t)^T dO.
// The backward recomputes S tile by tile and never stores a score matrix.
// Every output element is summed by one thread (or one warp's MMA) in a
// fixed order, with no atomics, so two runs give the same bits.
//
// Bound: arithmetic. At the HSTU shape (b = 64, h = 8, T = 1024, d = 128)
// one causal forward does 137.6 GFLOP on 0.8 GB of inputs and one backward
// 343.9 GFLOP; the H100's f32 CUDA cores (67 TFLOP/s) need 2.1 and 5.1 ms,
// its TF32 tensor cores (495 TFLOP/s) 0.8 and 2.1 ms at the three passes
// that f32 accuracy takes, its memory 0.3 and 0.6 ms.
//
// The forward, simply, on the CUDA cores in f32: 256 threads per block,
// each owning a 4 x 4 tile of the 64 x 64 score block and a 4 x 8 tile of
// the 64 x (<= 128) output block (columns c and c + 64), so every inner
// step reads two or three float4s from shared memory for 16 or 32 fused
// multiply-adds. Operands are staged in shared memory transposed (d-major,
// rows padded to 68 floats: float4 reads along the rows, at most 2-way
// conflicts on the transposing stores) when the 64 rows of a tile are the
// fast index, and row-major when d is. Global loads are float4 along d when
// every stride allows it (the layer's q, k, v are column slices of one
// (b, s, h, 2dqk + 2dv) tensor, rows 16 K apart), a warp covering 8 rows x
// 16 floats. No tensor cores, no cp.async or TMA overlap; two blocks an SM.
//
// The backward on the tensor cores, in 3xTF32 through mma.sync (the note
// before kBwdRows says how): 8 warps a block, each owning 16 of the
// block's 128 rows; the other side comes 32 rows a step through a
// two-stage cp.async ring, so the next step's loads fly behind this step's
// products. Tiles stay f32 in shared memory, rows padded to d + 4 floats
// (4 mod 32 words: every fragment read is free of bank conflicts), and are
// split into TF32 hi and lo parts as fragments are read. Head dims are
// zero-padded to 16, 32, 64 or 128 (one instantiation each).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 64;      // query or key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 68;       // row stride of a transposed (d-major) tile
constexpr int kMaxD = 128;     // head dims up to 128; row stride of a row-major tile

// A (B, T, H, D) strided view with unit stride along D.
struct View {
  const float* p;
  int64_t sb, st, sh;
};

__device__ __forceinline__ const float* head_base(const View& x, int b, int h) {
  return x.p + b * x.sb + h * x.sh;
}

// The 64 x D tile of rows [t0, t0 + 64) of one (b, h) head, transposed:
// dst[d * kPad + r] = x[t0 + r][d], zero where t0 + r >= T or d >= D (for d
// below D rounded up to 4). A warp covers 8 rows x 4 groups of 4 columns.
__device__ void load_transposed(float* dst, const float* base, int64_t st,
                                int t0, int T, int D, bool vec) {
  const int groups = (D + 3) >> 2;
  const int chunks = 8 * ((groups + 3) >> 2);
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < chunks; c += kThreads / 32) {
    const int r = (c & 7) * 8 + (lane & 7);
    const int g = (c >> 3) * 4 + (lane >> 3);
    if (g >= groups) continue;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    const int t = t0 + r;
    if (t < T) {
      const float* src = base + t * st + 4 * g;
      if (vec) {
        x = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        const int d = 4 * g;
        x.x = __ldg(src);
        if (d + 1 < D) x.y = __ldg(src + 1);
        if (d + 2 < D) x.z = __ldg(src + 2);
        if (d + 3 < D) x.w = __ldg(src + 3);
      }
    }
    float* col = dst + 4 * g * kPad + r;
    col[0] = x.x;
    col[kPad] = x.y;
    col[2 * kPad] = x.z;
    col[3 * kPad] = x.w;
  }
}

// The same tile row-major: dst[r * kMaxD + d] = x[t0 + r][d], zero where
// t0 + r >= T or D <= d < D rounded up to 4; columns beyond are not written
// (they only reach output columns that are never stored).
__device__ void load_rows(float* dst, const float* base, int64_t st, int t0,
                          int T, int D, bool vec) {
  const int groups = (D + 3) >> 2;
  for (int u = threadIdx.x; u < kTile * groups; u += kThreads) {
    const int r = u / groups;
    const int g = u - r * groups;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    const int t = t0 + r;
    if (t < T) {
      const float* src = base + t * st + 4 * g;
      if (vec) {
        x = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        const int d = 4 * g;
        x.x = __ldg(src);
        if (d + 1 < D) x.y = __ldg(src + 1);
        if (d + 2 < D) x.z = __ldg(src + 2);
        if (d + 3 < D) x.w = __ldg(src + 3);
      }
    }
    *reinterpret_cast<float4*>(dst + r * kMaxD + 4 * g) = x;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[r][c] += sum_{d < D} at[d * kPad + 4 ty + r] * bt[d * kPad + 4 tx + c]:
// the 4 x 4 corner of a 64 x 64 product of two transposed tiles.
__device__ __forceinline__ void product_tt(float (&acc)[4][4], const float* at,
                                           const float* bt, int D, int ty, int tx) {
  for (int d = 0; d < D; ++d) {
    const float4 a = ld4(at + d * kPad + 4 * ty);
    const float4 b = ld4(bt + d * kPad + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

// acc[r][c] += sum_{j < 64} pt[j * kPad + 4 ty + r] * rows[j * kMaxD + col(c)]
// with col(c) = 4 tx + c for c < 4 and 64 + 4 tx + c - 4 after: a 4 x 8
// corner of a 64 x 128 product of a transposed tile and a row-major one.
__device__ __forceinline__ void product_tr(float (&acc)[4][8], const float* pt,
                                           const float* rows, int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    const float4 a = ld4(pt + j * kPad + 4 * ty);
    const float4 b0 = ld4(rows + j * kMaxD + 4 * tx);
    const float4 b1 = ld4(rows + j * kMaxD + 64 + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

// Row i0 + 4 ty + r of a contiguous (B, T, H, D) output, columns 4 tx + c
// and 64 + 4 tx + c, where the row is below T and the column below D.
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[4][8],
                                           int b, int h, int i0, int T, int H,
                                           int D, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = i0 + 4 * ty + r;
    if (t >= T) continue;
    float* row = out + ((static_cast<int64_t>(b) * T + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64) + 4 * tx + (c & 3);
      if (col < D) row[col] = acc[r][c];
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads, 2)
hstu_fwd_kernel(View q, View k, View v, float* __restrict__ o, int T, int H,
                int dqk, int dv, int causal, float scale, float inv_t,
                bool vec_qk, bool vec_v) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dqk4 = (dqk + 3) & ~3;
  float* qt = smem;                    // Q tile, transposed
  float* x = qt + dqk4 * kPad;         // K tile transposed, then V row-major
  const int x_size = dqk4 * kPad > kTile * kMaxD ? dqk4 * kPad : kTile * kMaxD;
  float* at = x + x_size;              // A tile, [key][query]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;  // longest first
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = head_base(q, b, h);
  const float* kb = head_base(k, b, h);
  const float* vb = head_base(v, b, h);

  load_transposed(qt, qb, q.st, q0, T, dqk, vec_qk);
  float acc[4][8] = {};
  const int k_end = causal ? min(T, q0 + kTile) : T;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile's reads of x and at are done
    load_transposed(x, kb, k.st, k0, T, dqk, vec_qk);
    __syncthreads();
    float s[4][4] = {};
    product_tt(s, qt, x, dqk, ty, tx);
    float a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = q0 + 4 * ty + r, j = k0 + 4 * tx + c;
        const float z = s[r][c] * scale;
        const bool keep = j < T && (!causal || i >= j);
        a[r][c] = keep ? z * sigmoid(z) * inv_t : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      st4(at + (4 * tx + c) * kPad + 4 * ty, a[0][c], a[1][c], a[2][c], a[3][c]);
    }
    __syncthreads();  // every thread is done with the K tile in x
    load_rows(x, vb, v.st, k0, T, dv, vec_v);
    __syncthreads();
    product_tr(acc, at, x, ty, tx);
  }
  store_rows(o, acc, b, h, q0, T, H, dv, ty, tx);
}

// ---------------------------------------------------------------------------
// The backward on the tensor cores: every product is mma.sync m16n8k8 in
// TF32, three times over in split precision (3xTF32), each operand x taken
// as hi + lo with hi = rn_tf32(x) and lo = rn_tf32(x - hi); a product is
// then hi.lo' + lo.hi' + hi.hi' (small terms first) accumulated in f32,
// about 1e-6 relative where one TF32 pass keeps about 5e-4.
//
// Fragments (PTX ISA, m16n8k8 .tf32; lane = 4 g + t): A (16 x 8, row) holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, col) holds
// (t, g), (t + 4, g); the accumulator (16 x 8) holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). The accumulator's columns are not the A
// fragment's, so dS and A, which the next product takes as its A operand,
// do not move at all: that product's 8 k indices are renumbered, k = t
// standing for column 2t and k = t + 4 for column 2t + 1, and its B
// fragment is read from the rows those columns name. The sum over k is the
// same, added in another order.

// The tensor-core shape of the backward: a block owns 128 rows (8 warps x
// 16) of one (b, h) and walks the other side 32 rows a step.
constexpr int kBwdRows = 128;
constexpr int kBwdStep = 32;
constexpr int kBwdThreads = 256;

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

// d += a b in 3xTF32, b given as its two f32 values and split here.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const FragA& a, float b0,
                                           float b1) {
  uint32_t bhi[2], blo[2];
  split_tf32(b0, bhi[0], blo[0]);
  split_tf32(b1, bhi[1], blo[1]);
  mma_tf32(d, a.hi, blo);
  mma_tf32(d, a.lo, bhi);
  mma_tf32(d, a.hi, bhi);
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

// Rows [t0, t0 + kRows) of one (b, h) head into dst (row stride kD + 4
// floats), columns [0, kD): the view's columns [0, d) where the row is
// below T, zero elsewhere. With `vec` (d % 4 == 0, every row 16-byte
// aligned) by cp.async, landing at the next cp_async_wait; else by plain
// loads and stores, a barrier away from every reader.
template <int kD, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int64_t st,
                                          int t0, int T, int d, bool vec) {
  constexpr int kLd = kD + 4, kChunks = kD / 4;
  if (vec) {
    for (int u = threadIdx.x; u < kRows * kChunks; u += kBwdThreads) {
      const int r = u / kChunks, c = u % kChunks;
      const bool full = t0 + r < T && 4 * c < d;
      cp_async16(dst + r * kLd + 4 * c, full ? base + (t0 + r) * st + 4 * c : base, full);
    }
  } else {
    for (int u = threadIdx.x; u < kRows * kD; u += kBwdThreads) {
      const int r = u / kD, c = u % kD;
      dst[r * kLd + c] = t0 + r < T && c < d ? __ldg(base + (t0 + r) * st + c) : 0.f;
    }
  }
}

// c[nb] += A B^T for the warp's 16 rows `a` (16 x kD) against 32 rows `b`
// (32 x kD), both row-major with stride kD + 4: the 16 x 32 block of row
// products as four 16 x 8 accumulators. Both fragments come by ldmatrix
// (A: one x4 a k step; B: one x4 for two n blocks), its 16-byte rows in
// distinct banks at a stride of 4 mod 32 words.
template <int kD>
__device__ __forceinline__ void product_abt(float (&c)[4][4], const float* a,
                                            const float* b, int lane) {
  constexpr int kLd = kD + 4;
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
      mma_tf32x3(c[nb], fa, __uint_as_float(y[0]), __uint_as_float(y[1]));
      mma_tf32x3(c[nb + 1], fa, __uint_as_float(y[2]), __uint_as_float(y[3]));
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
// output columns 16p + 4t + 2 (e & 1) and that + 1 (store_frags).
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

// The masked dS (in place of s) and A (in place of da, when `want_a`) of a
// 16 x 32 accumulator block from its scores s (q . k, not yet scaled) and
// da (dO . v). Entry (nb, e) sits at row r0 + g + 8 (e >> 1) and column
// c0 + 8 nb + 2t + (e & 1); rows are queries and columns keys when
// rows_are_queries, else the other way round.
__device__ __forceinline__ void grads_of_frags(float (&s)[4][4], float (&da)[4][4],
                                               bool want_a, int r0, int c0,
                                               bool rows_are_queries, int T, int causal,
                                               float scale, float inv_t, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), col = c0 + 8 * nb + 2 * t + (e & 1);
      const int i = rows_are_queries ? row : col;
      const int j = rows_are_queries ? col : row;
      const bool keep = i < T && j < T && (!causal || i >= j);
      const float z = s[nb][e] * scale;
      const float sg = __fdividef(1.f, 1.f + __expf(-z));  // about 1e-7 relative
      s[nb][e] = keep ? da[nb][e] * inv_t * (sg * (1.f + z * (1.f - sg))) * scale : 0.f;
      if (want_a) da[nb][e] = keep ? z * sg * inv_t : 0.f;
    }
  }
}

// Rows r0 + g (+ 8) of the warp's 16 x kD accumulators (columns as
// product_ab leaves them: 16p + 4t .. 16p + 4t + 3 from acc[2p], acc[2p + 1])
// into a contiguous (B, T, H, D) output, below T and D; a float4 a row and
// p where D % 4 == 0.
template <int kD>
__device__ __forceinline__ void store_frags(float* out, const float (&acc)[kD / 8][4], int b,
                                            int h, int r0, int T, int H, int D, int g,
                                            int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= T) continue;
    float* dst = out + ((static_cast<int64_t>(b) * T + row) * H + h) * D;
#pragma unroll
    for (int pr = 0; pr < kD / 16; ++pr) {
      const int c = 16 * pr + 4 * t;
      const float x[4] = {acc[2 * pr][2 * half], acc[2 * pr + 1][2 * half],
                          acc[2 * pr][2 * half + 1], acc[2 * pr + 1][2 * half + 1]};
      if (D % 4 == 0 && c < D) {
        *reinterpret_cast<float4*>(dst + c) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < D) dst[c + j] = x[j];
        }
      }
    }
  }
}

// Shared memory of either backward kernel: the block's 128 rows of two
// operands, and a two-stage ring of 32 rows of the other two.
template <int kD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (kD + 4) * (2 * kBwdRows + 2 * 2 * kBwdStep);
}

// dQ for 128 query rows of one (b, h): S = Q K^T and dA = dO V^T for each
// step of 32 keys up to the diagonal, dS from them, dQ += dS K. Q and dO
// stay in shared memory; K and V come through the ring, the next step's
// loads in flight behind this step's products. A warp skips a step whose
// keys are all after its 16 queries (causal).
template <int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
hstu_bwd_dq_kernel(View q, View k, View v, View dout, float* __restrict__ dq, int T, int H,
                   int dqk, int dv, int causal, float scale, float inv_t, bool vec_qk,
                   bool vec_v) {
  constexpr int kLd = kD + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // 128 query rows
  float* dos = qs + kBwdRows * kLd;               // their dO rows
  float* ring = dos + kBwdRows * kLd;             // stage s: K rows, then V rows
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (T + kBwdRows - 1) / kBwdRows;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kBwdRows;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp;
  const float* kb = head_base(k, b, h);
  const float* vb = head_base(v, b, h);

  load_tile<kD, kBwdRows>(qs, head_base(q, b, h), q.st, q0, T, dqk, vec_qk);
  load_tile<kD, kBwdRows>(dos, head_base(dout, b, h), dout.st, q0, T, dv, vec_v);
  load_tile<kD, kBwdStep>(ring, kb, k.st, 0, T, dqk, vec_qk);
  load_tile<kD, kBwdStep>(ring + kBwdStep * kLd, vb, v.st, 0, T, dv, vec_v);
  cp_async_commit();
  float acc[kD / 8][4] = {};
  const int k_end = causal ? min(T, q0 + kBwdRows) : T;
  const int steps = (k_end + kBwdStep - 1) / kBwdStep;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {  // the stage read one step ago; a barrier has passed
      float* next = ring + ((step + 1) & 1) * 2 * kBwdStep * kLd;
      const int k1 = (step + 1) * kBwdStep;
      load_tile<kD, kBwdStep>(next, kb, k.st, k1, T, dqk, vec_qk);
      load_tile<kD, kBwdStep>(next + kBwdStep * kLd, vb, v.st, k1, T, dv, vec_v);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = step * kBwdStep;
    const float* ks = ring + (step & 1) * 2 * kBwdStep * kLd;
    if (row0 < T && !(causal && k0 > row0 + 15)) {
      float s[4][4] = {}, da[4][4] = {};
      product_abt<kD>(s, qs + 16 * warp * kLd, ks, lane);
      product_abt<kD>(da, dos + 16 * warp * kLd, ks + kBwdStep * kLd, lane);
      grads_of_frags(s, da, false, row0, k0, true, T, causal, scale, inv_t, g, t);
      product_ab<kD>(acc, s, ks, g, t);
    }
    __syncthreads();  // every warp is done with this stage
  }
  store_frags<kD>(dq, acc, b, h, row0, T, H, dqk, g, t);
}

// dK and dV for 128 key rows of one (b, h): S^T = K Q^T and dA^T = V dO^T
// for each step of 32 queries from the diagonal on, A^T and dS^T from them,
// dV += A^T dO and dK += dS^T Q. K and V stay in shared memory; Q and dO
// come through the ring. A warp skips a step whose queries are all before
// its 16 keys (causal).
template <int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
hstu_bwd_dkdv_kernel(View q, View k, View v, View dout, float* __restrict__ dk,
                     float* __restrict__ dvo, int T, int H, int dqk, int dv, int causal,
                     float scale, float inv_t, bool vec_qk, bool vec_v) {
  constexpr int kLd = kD + 4;
  extern __shared__ float4 smem4[];
  float* kbuf = reinterpret_cast<float*>(smem4);  // 128 key rows
  float* vbuf = kbuf + kBwdRows * kLd;            // their V rows
  float* ring = vbuf + kBwdRows * kLd;            // stage s: Q rows, then dO rows
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = static_cast<int>(blockIdx.y) * kBwdRows;  // tile 0 loops longest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 16 * warp;
  const float* qb = head_base(q, b, h);
  const float* ob = head_base(dout, b, h);

  const int i_begin = causal ? k0 : 0;
  load_tile<kD, kBwdRows>(kbuf, head_base(k, b, h), k.st, k0, T, dqk, vec_qk);
  load_tile<kD, kBwdRows>(vbuf, head_base(v, b, h), v.st, k0, T, dv, vec_v);
  load_tile<kD, kBwdStep>(ring, qb, q.st, i_begin, T, dqk, vec_qk);
  load_tile<kD, kBwdStep>(ring + kBwdStep * kLd, ob, dout.st, i_begin, T, dv, vec_v);
  cp_async_commit();
  float acc_k[kD / 8][4] = {}, acc_v[kD / 8][4] = {};
  const int steps = (T - i_begin + kBwdStep - 1) / kBwdStep;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      float* next = ring + ((step + 1) & 1) * 2 * kBwdStep * kLd;
      const int i1 = i_begin + (step + 1) * kBwdStep;
      load_tile<kD, kBwdStep>(next, qb, q.st, i1, T, dqk, vec_qk);
      load_tile<kD, kBwdStep>(next + kBwdStep * kLd, ob, dout.st, i1, T, dv, vec_v);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int i0 = i_begin + step * kBwdStep;
    const float* qs = ring + (step & 1) * 2 * kBwdStep * kLd;
    const float* dos = qs + kBwdStep * kLd;
    if (key0 < T && !(causal && i0 + kBwdStep - 1 < key0)) {
      float s[4][4] = {}, da[4][4] = {};
      product_abt<kD>(s, kbuf + 16 * warp * kLd, qs, lane);  // [key][query]
      product_abt<kD>(da, vbuf + 16 * warp * kLd, dos, lane);
      grads_of_frags(s, da, true, key0, i0, false, T, causal, scale, inv_t, g, t);
      product_ab<kD>(acc_v, da, dos, g, t);  // da holds A^T now, s dS^T
      product_ab<kD>(acc_k, s, qs, g, t);
    }
    __syncthreads();
  }
  store_frags<kD>(dk, acc_k, b, h, key0, T, H, dqk, g, t);
  store_frags<kD>(dvo, acc_v, b, h, key0, T, H, dv, g, t);
}

int x_floats(int d4) { return d4 * kPad > kTile * kMaxD ? d4 * kPad : kTile * kMaxD; }

// Dynamic shared memory above 48 KB has to be granted per kernel first.
cudaError_t grant(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Whether float4 loads along d are aligned for every (b, t, h) row.
bool vec_ok(const float* p, int64_t sb, int64_t st, int64_t sh, int64_t d) {
  return d % 4 == 0 && sb % 4 == 0 && st % 4 == 0 && sh % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool shape_ok(int64_t B, int64_t T, int64_t H, int64_t dqk, int64_t dv) {
  return B > 0 && T > 0 && H > 0 && dqk > 0 && dv > 0 && dqk <= kMaxD &&
         dv <= kMaxD && B * H <= INT_MAX && T <= INT_MAX - kTile &&
         (T + kTile - 1) / kTile <= 65535;
}

template <int kD>
int launch_bwd(const View& qv, const View& kv, const View& vv, const View& ov, float* dq,
               float* dk, float* dv_out, int64_t B, int64_t T, int64_t H, int64_t dqk,
               int64_t dv, int causal, float scale, float inv_t, bool vec_qk, bool vec_v,
               cudaStream_t st) {
  const size_t bytes = bwd_smem_bytes<kD>();
  cudaError_t err = grant(reinterpret_cast<const void*>(hstu_bwd_dq_kernel<kD>), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = grant(reinterpret_cast<const void*>(hstu_bwd_dkdv_kernel<kD>), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((T + kBwdRows - 1) / kBwdRows));
  hstu_bwd_dq_kernel<kD><<<grid, kBwdThreads, bytes, st>>>(
      qv, kv, vv, ov, dq, static_cast<int>(T), static_cast<int>(H), static_cast<int>(dqk),
      static_cast<int>(dv), causal, scale, inv_t, vec_qk, vec_v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hstu_bwd_dkdv_kernel<kD><<<grid, kBwdThreads, bytes, st>>>(
      qv, kv, vv, ov, dk, dv_out, static_cast<int>(T), static_cast<int>(H),
      static_cast<int>(dqk), static_cast<int>(dv), causal, scale, inv_t, vec_qk, vec_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// q, k (B, T, H, dqk) and v (B, T, H, dv) are strided views (element
// strides sb, st, sh; unit stride along d); o is a contiguous
// (B, T, H, dv) output, every element of which is written. dqk and dv are
// at most 128. Launches on `stream` and returns cudaGetLastError() (0 on
// success). The caller checks shapes, types and devices.
extern "C" int repro_hstu_attention_fwd_f32(
    const float* q, int64_t qsb, int64_t qst, int64_t qsh,
    const float* k, int64_t ksb, int64_t kst, int64_t ksh,
    const float* v, int64_t vsb, int64_t vst, int64_t vsh, float* o,
    int64_t B, int64_t T, int64_t H, int64_t dqk, int64_t dv, int causal,
    float scale, float inv_t, void* stream) {
  if (!shape_ok(B, T, H, dqk, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const int dqk4 = static_cast<int>((dqk + 3) & ~3);
  const size_t bytes = sizeof(float) * (static_cast<size_t>(dqk4) * kPad +
                                        x_floats(dqk4) + kTile * kPad);
  cudaError_t err = grant(reinterpret_cast<const void*>(hstu_fwd_kernel), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_qk = vec_ok(q, qsb, qst, qsh, dqk) && vec_ok(k, ksb, kst, ksh, dqk);
  const bool vec_v = vec_ok(v, vsb, vst, vsh, dv);
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((T + kTile - 1) / kTile));
  hstu_fwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      View{q, qsb, qst, qsh}, View{k, ksb, kst, ksh}, View{v, vsb, vst, vsh}, o,
      static_cast<int>(T), static_cast<int>(H), static_cast<int>(dqk),
      static_cast<int>(dv), causal, scale, inv_t, vec_qk, vec_v);
  return static_cast<int>(cudaGetLastError());
}

// The backward of the forward above for the output gradient `dout` (a
// strided (B, T, H, dv) view, unit stride along d): writes every element of
// the contiguous dq, dk (B, T, H, dqk) and dv (B, T, H, dv). Launches the dq
// kernel, then the dk/dv kernel, on `stream`, both at the smallest padded
// head dim of 16, 32, 64 or 128 that holds dqk and dv; returns
// cudaGetLastError().
extern "C" int repro_hstu_attention_bwd_f32(
    const float* q, int64_t qsb, int64_t qst, int64_t qsh,
    const float* k, int64_t ksb, int64_t kst, int64_t ksh,
    const float* v, int64_t vsb, int64_t vst, int64_t vsh,
    const float* dout, int64_t osb, int64_t ost, int64_t osh, float* dq,
    float* dk, float* dv_out, int64_t B, int64_t T, int64_t H, int64_t dqk,
    int64_t dv, int causal, float scale, float inv_t, void* stream) {
  if (!shape_ok(B, T, H, dqk, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_qk = vec_ok(q, qsb, qst, qsh, dqk) && vec_ok(k, ksb, kst, ksh, dqk);
  const bool vec_v = vec_ok(v, vsb, vst, vsh, dv) && vec_ok(dout, osb, ost, osh, dv);
  const View qv{q, qsb, qst, qsh}, kv{k, ksb, kst, ksh}, vv{v, vsb, vst, vsh},
      ov{dout, osb, ost, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t d = dqk > dv ? dqk : dv;
  if (d <= 16)
    return launch_bwd<16>(qv, kv, vv, ov, dq, dk, dv_out, B, T, H, dqk, dv, causal, scale,
                          inv_t, vec_qk, vec_v, st);
  if (d <= 32)
    return launch_bwd<32>(qv, kv, vv, ov, dq, dk, dv_out, B, T, H, dqk, dv, causal, scale,
                          inv_t, vec_qk, vec_v, st);
  if (d <= 64)
    return launch_bwd<64>(qv, kv, vv, ov, dq, dk, dv_out, B, T, H, dqk, dv, causal, scale,
                          inv_t, vec_qk, vec_v, st);
  return launch_bwd<128>(qv, kv, vv, ov, dq, dk, dv_out, B, T, H, dqk, dv, causal, scale,
                         inv_t, vec_qk, vec_v, st);
}
