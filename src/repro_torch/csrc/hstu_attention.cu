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
// between them, so each block owns one (b, h) and one 64-row tile of the
// rows it writes and loops over the other side's tiles itself:
//   - forward: one block per query tile; it loops over the key tiles up to
//     the diagonal (the tiles wholly above it are skipped when causal:
//     every entry there is masked, so the function is the same);
//   - dq: one block per query tile, looping over the same key tiles;
//     dQ = scale * dS K with dS = m * dA * inv_t * silu'(scale S),
//     dA = dO V^T and silu'(x) = sig(x) (1 + x (1 - sig(x)));
//   - dk/dv: one block per key tile, looping over the query tiles from the
//     diagonal on; dK = scale * dS^T Q and dV = (m * silu(scale S) * inv_t)^T dO.
// The backward recomputes S tile by tile and never stores a score matrix.
// Every output element is summed by one thread in a fixed order, with no
// atomics, so two runs give the same bits.
//
// Bound: arithmetic. At the HSTU shape (b = 64, h = 8, T = 1024, d = 128)
// one causal forward does 137.6 GFLOP on 0.8 GB of inputs; the H100's f32
// CUDA cores (67 TFLOP/s) need 2.1 ms for it, its memory 0.3 ms. Design for
// that, simply: 256 threads per block, each owning a 4 x 4 tile of the
// 64 x 64 score block and a 4 x 8 tile of the 64 x (<= 128) output block
// (columns c and c + 64), so every inner step reads two or three float4s
// from shared memory for 16 or 32 fused multiply-adds. Operands are staged
// in shared memory transposed (d-major, rows padded to 68 floats: float4
// reads along the rows, at most 2-way conflicts on the transposing stores)
// when the 64 rows of a tile are the fast index, and row-major when d is.
// Global loads are float4 along d when every stride allows it (the layer's
// q, k, v are column slices of one (b, s, h, 2dqk + 2dv) tensor, rows 16 K
// apart), a warp covering 8 rows x 16 floats. This is the simple form: CUDA
// cores in f32, no tensor cores (wgmma with 3xTF32 is the redesign target),
// no cp.async or TMA overlap; the forward fits two blocks on an SM, the
// backward kernels one.

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

// The masked dS and A of one 64 x 64 block from its scores s (q . k, not
// yet scaled) and da (dO . v): rows i = i0 + .., columns j = j0 + .. when
// the block is [query][key] (rows_are_queries) and the other way round
// otherwise.
__device__ __forceinline__ void grads_of_block(const float (&s)[4][4],
                                               const float (&da)[4][4],
                                               float (&ds)[4][4], float (&a)[4][4],
                                               int r0, int c0, bool rows_are_queries,
                                               int T, int causal, float scale,
                                               float inv_t, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = r0 + 4 * ty + r, col = c0 + 4 * tx + c;
      const int i = rows_are_queries ? row : col;
      const int j = rows_are_queries ? col : row;
      const bool keep = i < T && j < T && (!causal || i >= j);
      const float z = s[r][c] * scale;
      const float sg = sigmoid(z);
      a[r][c] = keep ? z * sg * inv_t : 0.f;
      ds[r][c] = keep ? da[r][c] * inv_t * (sg * (1.f + z * (1.f - sg))) * scale : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
hstu_bwd_dq_kernel(View q, View k, View v, View dout, float* __restrict__ dq,
                   int T, int H, int dqk, int dv, int causal, float scale,
                   float inv_t, bool vec_qk, bool vec_v) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dqk4 = (dqk + 3) & ~3, dv4 = (dv + 3) & ~3;
  const int x1_size = dqk4 * kPad > kTile * kMaxD ? dqk4 * kPad : kTile * kMaxD;
  float* qt = smem;                  // Q tile, transposed
  float* dot = qt + dqk4 * kPad;     // dO tile, transposed
  float* x1 = dot + dv4 * kPad;      // K tile transposed, then row-major
  float* x2 = x1 + x1_size;          // V tile, transposed
  float* dst = x2 + dv4 * kPad;      // dS tile, [key][query]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* kb = head_base(k, b, h);
  const float* vb = head_base(v, b, h);

  load_transposed(qt, head_base(q, b, h), q.st, q0, T, dqk, vec_qk);
  load_transposed(dot, head_base(dout, b, h), dout.st, q0, T, dv, vec_v);
  float acc[4][8] = {};
  const int k_end = causal ? min(T, q0 + kTile) : T;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_transposed(x1, kb, k.st, k0, T, dqk, vec_qk);
    load_transposed(x2, vb, v.st, k0, T, dv, vec_v);
    __syncthreads();
    float s[4][4] = {}, da[4][4] = {}, ds[4][4], a[4][4];
    product_tt(s, qt, x1, dqk, ty, tx);
    product_tt(da, dot, x2, dv, ty, tx);
    grads_of_block(s, da, ds, a, q0, k0, true, T, causal, scale, inv_t, ty, tx);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      st4(dst + (4 * tx + c) * kPad + 4 * ty, ds[0][c], ds[1][c], ds[2][c], ds[3][c]);
    }
    __syncthreads();  // every thread is done with the K tile in x1
    load_rows(x1, kb, k.st, k0, T, dqk, vec_qk);
    __syncthreads();
    product_tr(acc, dst, x1, ty, tx);
  }
  store_rows(dq, acc, b, h, q0, T, H, dqk, ty, tx);
}

__global__ void __launch_bounds__(kThreads, 1)
hstu_bwd_dkdv_kernel(View q, View k, View v, View dout, float* __restrict__ dk,
                     float* __restrict__ dvo, int T, int H, int dqk, int dv,
                     int causal, float scale, float inv_t, bool vec_qk, bool vec_v) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dqk4 = (dqk + 3) & ~3, dv4 = (dv + 3) & ~3;
  const int x1_size = dqk4 * kPad > kTile * kMaxD ? dqk4 * kPad : kTile * kMaxD;
  const int x2_size = dv4 * kPad > kTile * kMaxD ? dv4 * kPad : kTile * kMaxD;
  float* kt = smem;                  // K tile, transposed
  float* vt = kt + dqk4 * kPad;      // V tile, transposed
  float* x1 = vt + dv4 * kPad;       // Q tile transposed, then row-major
  float* x2 = x1 + x1_size;          // dO tile transposed, then row-major
  float* pt = x2 + x2_size;          // A tile, [query][key]
  float* dst = pt + kTile * kPad;    // dS tile, [query][key]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = static_cast<int>(blockIdx.y) * kTile;  // tile 0 loops longest
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = head_base(q, b, h);
  const float* ob = head_base(dout, b, h);

  load_transposed(kt, head_base(k, b, h), k.st, k0, T, dqk, vec_qk);
  load_transposed(vt, head_base(v, b, h), v.st, k0, T, dv, vec_v);
  float acc_k[4][8] = {}, acc_v[4][8] = {};
  for (int i0 = causal ? k0 : 0; i0 < T; i0 += kTile) {
    __syncthreads();
    load_transposed(x1, qb, q.st, i0, T, dqk, vec_qk);
    load_transposed(x2, ob, dout.st, i0, T, dv, vec_v);
    __syncthreads();
    float s[4][4] = {}, da[4][4] = {}, ds[4][4], a[4][4];
    product_tt(s, kt, x1, dqk, ty, tx);   // [key][query]
    product_tt(da, vt, x2, dv, ty, tx);
    grads_of_block(s, da, ds, a, k0, i0, false, T, causal, scale, inv_t, ty, tx);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      st4(pt + (4 * tx + c) * kPad + 4 * ty, a[0][c], a[1][c], a[2][c], a[3][c]);
      st4(dst + (4 * tx + c) * kPad + 4 * ty, ds[0][c], ds[1][c], ds[2][c], ds[3][c]);
    }
    __syncthreads();  // every thread is done with the transposed Q and dO
    load_rows(x1, qb, q.st, i0, T, dqk, vec_qk);
    load_rows(x2, ob, dout.st, i0, T, dv, vec_v);
    __syncthreads();
    product_tr(acc_v, pt, x2, ty, tx);
    product_tr(acc_k, dst, x1, ty, tx);
  }
  store_rows(dk, acc_k, b, h, k0, T, H, dqk, ty, tx);
  store_rows(dvo, acc_v, b, h, k0, T, H, dv, ty, tx);
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
// kernel, then the dk/dv kernel, on `stream`; returns cudaGetLastError().
extern "C" int repro_hstu_attention_bwd_f32(
    const float* q, int64_t qsb, int64_t qst, int64_t qsh,
    const float* k, int64_t ksb, int64_t kst, int64_t ksh,
    const float* v, int64_t vsb, int64_t vst, int64_t vsh,
    const float* dout, int64_t osb, int64_t ost, int64_t osh, float* dq,
    float* dk, float* dv_out, int64_t B, int64_t T, int64_t H, int64_t dqk,
    int64_t dv, int causal, float scale, float inv_t, void* stream) {
  if (!shape_ok(B, T, H, dqk, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const int dqk4 = static_cast<int>((dqk + 3) & ~3), dv4 = static_cast<int>((dv + 3) & ~3);
  const size_t dq_bytes = sizeof(float) * (static_cast<size_t>(dqk4) * kPad + dv4 * kPad +
                                           x_floats(dqk4) + dv4 * kPad + kTile * kPad);
  const size_t dkdv_bytes = sizeof(float) * (static_cast<size_t>(dqk4) * kPad + dv4 * kPad +
                                             x_floats(dqk4) + x_floats(dv4) + 2 * kTile * kPad);
  cudaError_t err = grant(reinterpret_cast<const void*>(hstu_bwd_dq_kernel), dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = grant(reinterpret_cast<const void*>(hstu_bwd_dkdv_kernel), dkdv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_qk = vec_ok(q, qsb, qst, qsh, dqk) && vec_ok(k, ksb, kst, ksh, dqk);
  const bool vec_v = vec_ok(v, vsb, vst, vsh, dv) && vec_ok(dout, osb, ost, osh, dv);
  const View qv{q, qsb, qst, qsh}, kv{k, ksb, kst, ksh}, vv{v, vsb, vst, vsh},
      ov{dout, osb, ost, osh};
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((T + kTile - 1) / kTile));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hstu_bwd_dq_kernel<<<grid, kThreads, dq_bytes, st>>>(
      qv, kv, vv, ov, dq, static_cast<int>(T), static_cast<int>(H),
      static_cast<int>(dqk), static_cast<int>(dv), causal, scale, inv_t, vec_qk, vec_v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hstu_bwd_dkdv_kernel<<<grid, kThreads, dkdv_bytes, st>>>(
      qv, kv, vv, ov, dk, dv_out, static_cast<int>(T), static_cast<int>(H),
      static_cast<int>(dqk), static_cast<int>(dv), causal, scale, inv_t, vec_qk, vec_v);
  return static_cast<int>(cudaGetLastError());
}
