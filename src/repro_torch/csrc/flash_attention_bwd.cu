// Backward of causal (or full) softmax attention for Hopper (sm_90a), f32 or
// bf16: given q, k, v, the forward's output o, the output gradient do and
// the forward's row logsumexp lse (csrc/flash_attention.cu writes it), it
// computes
//   P_ij  = exp(scale q_i . k_j - lse_i)   (0 where masked)
//   delta_i = do_i . o_i
//   dv_j  = sum_i P_ij do_i
//   dS_ij = P_ij (do_i . v_j - delta_i)
//   dq_i  = scale sum_j dS_ij k_j,   dk_j = scale sum_i dS_ij q_i
// with scale = 1/sqrt(hd) and the forward's mask: key j < Tk and, when
// causal, j <= i, positions counted from 0 on both sides even when
// Tq != Tk. q, o and do are (B, Tq, H, hd); k and v are (B, Tk, KV, hd) with
// H % KV == 0, query head h reading kv head h / (H / KV); each kv head's dk
// and dv sum over its group of query heads. Inputs are strided views with a
// unit stride along hd; dq, dk and dv are contiguous, in the inputs' type.
//
// Replaces no Pallas kernel: the TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:70) is forward only, and the JAX
// package gets this gradient by autodiff of `chunked_attention`
// (src/repro/models/layers.py:160), which FuXi's layers run. Here it is a
// kernel, as the hstu_attention backward is (csrc/hstu_attention.cu).
//
// Three launches, no atomics, every sum in a fixed order, so two runs give
// the same bits:
//   1. delta: one warp a (b, h, query) row, do . o summed lane-strided and
//      then by a fixed shuffle tree, into an f32 (B, H, Tq) scratch. delta
//      is a pass of its own because both kernels below need it.
//   2. dq: one block a (b, h, 32-query tile); it loops over the 64-key
//      tiles up to the diagonal, recomputes S and P from lse, forms dS and
//      adds dS K into registers, key by key.
//   3. dk/dv: one block a (b, kv head, 64-key tile); it loops over the
//      group's query heads and, in each, over the 32-query tiles from the
//      diagonal on, and adds P^T do and dS^T q into registers, query by
//      query.
// Bound: operations. At FuXi's shape (fuxi-kuairand: B 64 a micro-batch,
// T 512, H = KV = 8, hd 64, f32, causal) one call does 43.0 GFLOP (10 hd a
// kept (query, key) pair: S, dP, dv, dq and dk), 0.643 ms at the 66.9
// TFLOP/s f32 CUDA-core peak, against 0.16 ms for its 0.54 GB of bytes at
// 3.35 TB/s (q, k, v, o and do read, dq, dk and dv written). FuXi holds its
// gradients to 1e-5 of their magnitudes, which one TF32 pass does not
// meet, so every product runs on the CUDA cores in f32 (bf16 inputs are
// lifted to f32 as they are loaded). This is the
// simple form: each block stages f32 tiles in shared memory (a row stride
// of hd rounded up to 16, plus one, so that a column's rows fall in
// distinct banks) and each thread owns a 2 x 4 patch of the 32 x 64 score
// tile and a (rows x hd/16) patch of its gradient tile. The tensor-core
// design (3xTF32 mma.sync or wgmma, as the hstu_attention kernels) is
// later work. Head dims 1 to 256: the kernels are instantiated for head
// dims up to 64, 128 and 256, and mask the columns past hd.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 32;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 8 warps; thread (ty, tx) = (tid / 16, tid % 16)
constexpr int kMaxD = 256;
constexpr int kLdS = kBK + 1;  // row stride (floats) of a 32 x 64 score tile

// A (B, T, heads, hd) strided view with unit stride along hd.
struct View {
  const void* p;
  int64_t sb, st, sh;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__host__ __device__ inline int round16(int hd) { return (hd + 15) & ~15; }

// Rows [t0, t0 + rows) of one head into an f32 tile: dst[r * ld + c] =
// x[t0 + r][c], zero where t0 + r >= T_len or c >= hd, for every c < hdp.
template <typename T>
__device__ void load_tile(float* dst, int ld, int rows, const T* base, int64_t st, int t0,
                          int T_len, int hd, int hdp) {
  for (int u = threadIdx.x; u < rows * hdp; u += kThreads) {
    const int r = u / hdp, c = u - r * hdp;
    const int t = t0 + r;
    dst[r * ld + c] = (t < T_len && c < hd) ? to_f(base[static_cast<int64_t>(t) * st + c]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ const T* head_base(const View& x, int b, int h) {
  return static_cast<const T*>(x.p) + b * x.sb + h * x.sh;
}

// delta[(b H + h) Tq + i] = do[b, i, h] . o[b, i, h], one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(View ov, View dov, float* __restrict__ delta, int64_t rows, int Tq,
                       int H, int hd) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t r = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5; r < rows;
       r += warps) {
    const int64_t bh = r / Tq;
    const int i = static_cast<int>(r - bh * Tq);
    const int b = static_cast<int>(bh / H), h = static_cast<int>(bh - static_cast<int64_t>(b) * H);
    const T* o = head_base<T>(ov, b, h) + static_cast<int64_t>(i) * ov.st;
    const T* g = head_base<T>(dov, b, h) + static_cast<int64_t>(i) * dov.st;
    float acc = 0.f;
    for (int c = lane; c < hd; c += 32) acc = fmaf(to_f(g[c]), to_f(o[c]), acc);
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) delta[r] = acc;
  }
}

// The 32 x 64 tiles of S = q k^T and dP = do v^T for the thread's patch
// (rows ty + 16 r, r < 2; columns tx + 16 c, c < 4), each summed over
// d < hd in order; then P = exp(scale S - lse) and dS = P (dP - delta),
// both 0 where masked or past the rows. qs/dos hold the query tile (rows
// q0..), ks/vs the key tile (rows k0..).
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks,
                                       const float* vs, int ld, int hd, const float* row_lse,
                                       const float* row_delta, int q0, int k0, int Tq, int Tk,
                                       bool causal, float scale, float p[2][4], float ds[2][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[2][4] = {}, dp[2][4] = {};
  for (int d = 0; d < hd; ++d) {
    float a[2], g[2], b[4], w[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a[r] = qs[(ty + 16 * r) * ld + d];
      g[r] = dos[(ty + 16 * r) * ld + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      b[c] = ks[(tx + 16 * c) * ld + d];
      w[c] = vs[(tx + 16 * c) * ld + d];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(a[r], b[c], s[r][c]);
        dp[r][c] = fmaf(g[r], w[c], dp[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + 16 * c;
      const bool keep = i < Tq && j < Tk && (!causal || i >= j);
      const float pv = keep ? expf(s[r][c] * scale - row_lse[ty + 16 * r]) : 0.f;
      p[r][c] = pv;
      ds[r][c] = keep ? pv * (dp[r][c] - row_delta[ty + 16 * r]) : 0.f;
    }
  }
}

// Shared-memory bytes of either kernel: four f32 tiles (two of kBQ rows,
// two of kBK), `score_tiles` 32 x 64 tiles and the rows' lse and delta.
__host__ __device__ inline size_t smem_bytes(int hd, int score_tiles) {
  const int ld = round16(hd) + 1;
  return sizeof(float) * ((2 * kBQ + 2 * kBK) * ld + score_tiles * kBQ * kLdS + 2 * kBQ);
}

// dq of one (b, h, 32-query tile); kC >= hdp / 16 columns a thread.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(View qv, View kv, View vv, View dov, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Tq, int Tk, int H,
                    int KV, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  const int hdp = round16(hd), ld = hdp + 1;
  float* qs = smem;
  float* dos = qs + kBQ * ld;
  float* ks = dos + kBQ * ld;
  float* vs = ks + kBK * ld;
  float* dss = vs + kBK * ld;
  float* row_lse = dss + kBQ * kLdS;
  float* row_delta = row_lse + kBQ;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the longest (causal) tiles first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int cols = hdp >> 4;

  load_tile(qs, ld, kBQ, head_base<T>(qv, b, h), qv.st, q0, Tq, hd, hdp);
  load_tile(dos, ld, kBQ, head_base<T>(dov, b, h), dov.st, q0, Tq, hd, hdp);
  if (threadIdx.x < kBQ) {
    const int i = q0 + threadIdx.x;
    const int64_t row = (static_cast<int64_t>(b) * H + h) * Tq + i;
    row_lse[threadIdx.x] = i < Tq ? lse[row] : 0.f;
    row_delta[threadIdx.x] = i < Tq ? delta[row] : 0.f;
  }

  float acc[2][kC];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
  }
  const int k_tiles = (Tk + kBK - 1) / kBK;
  const int q_last = min(q0 + kBQ, Tq) - 1;
  const int k_end = causal ? min(k_tiles, q_last / kBK + 1) : k_tiles;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's products are done with K, V and dS
    load_tile(ks, ld, kBK, head_base<T>(kv, b, kh), kv.st, k0, Tk, hd, hdp);
    load_tile(vs, ld, kBK, head_base<T>(vv, b, kh), vv.st, k0, Tk, hd, hdp);
    __syncthreads();
    float p[2][4], ds[2][4];
    scores(qs, dos, ks, vs, ld, hd, row_lse, row_delta, q0, k0, Tq, Tk, causal, scale, p, ds);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) dss[(ty + 16 * r) * kLdS + tx + 16 * c] = ds[r][c];
    }
    __syncthreads();  // dS is whole
    for (int j = 0; j < kBK; ++j) {
      const float a0 = dss[ty * kLdS + j], a1 = dss[(ty + 16) * kLdS + j];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c < cols) {
          const float kk = ks[j * ld + tx + 16 * c];
          acc[0][c] = fmaf(a0, kk, acc[0][c]);
          acc[1][c] = fmaf(a1, kk, acc[1][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Tq) continue;
    T* out = dq + ((static_cast<int64_t>(b) * Tq + i) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (c < cols && col < hd) out[col] = from_f<T>(acc[r][c] * scale);
    }
  }
}

// dk and dv of one (b, kv head, 64-key tile); kC >= hdp / 16 columns a
// thread, for 4 key rows (ty + 16 r).
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(View qv, View kv, View vv, View dov, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int Tq, int Tk, int H, int KV, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  const int hdp = round16(hd), ld = hdp + 1;
  float* ks = smem;
  float* vs = ks + kBK * ld;
  float* qs = vs + kBK * ld;
  float* dos = qs + kBQ * ld;
  float* ps = dos + kBQ * ld;
  float* dss = ps + kBQ * kLdS;
  float* row_lse = dss + kBQ * kLdS;
  float* row_delta = row_lse + kBQ;

  const int b = blockIdx.x / KV;
  const int kh = blockIdx.x - b * KV;
  const int group = H / KV;
  const int k0 = blockIdx.y * kBK;  // the first key tiles meet the most (causal) queries
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int cols = hdp >> 4;

  load_tile(ks, ld, kBK, head_base<T>(kv, b, kh), kv.st, k0, Tk, hd, hdp);
  load_tile(vs, ld, kBK, head_base<T>(vv, b, kh), vv.st, k0, Tk, hd, hdp);

  float acc_k[4][kC], acc_v[4][kC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }
  const int q_tiles = (Tq + kBQ - 1) / kBQ;
  const int qt_begin = causal ? k0 / kBQ : 0;  // the first tile holding a query i >= k0
  for (int h = kh * group; h < (kh + 1) * group; ++h) {
    for (int qt = qt_begin; qt < q_tiles; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's products are done with Q, dO, P and dS
      load_tile(qs, ld, kBQ, head_base<T>(qv, b, h), qv.st, q0, Tq, hd, hdp);
      load_tile(dos, ld, kBQ, head_base<T>(dov, b, h), dov.st, q0, Tq, hd, hdp);
      if (threadIdx.x < kBQ) {
        const int i = q0 + threadIdx.x;
        const int64_t row = (static_cast<int64_t>(b) * H + h) * Tq + i;
        row_lse[threadIdx.x] = i < Tq ? lse[row] : 0.f;
        row_delta[threadIdx.x] = i < Tq ? delta[row] : 0.f;
      }
      __syncthreads();
      float p[2][4], ds[2][4];
      scores(qs, dos, ks, vs, ld, hd, row_lse, row_delta, q0, k0, Tq, Tk, causal, scale, p,
             ds);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ps[(ty + 16 * r) * kLdS + tx + 16 * c] = p[r][c];
          dss[(ty + 16 * r) * kLdS + tx + 16 * c] = ds[r][c];
        }
      }
      __syncthreads();  // P and dS are whole
      for (int i = 0; i < kBQ; ++i) {
        float pa[4], sa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[r] = ps[i * kLdS + ty + 16 * r];
          sa[r] = dss[i * kLdS + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          if (c < cols) {
            const float g = dos[i * ld + tx + 16 * c];
            const float x = qs[i * ld + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc_v[r][c] = fmaf(pa[r], g, acc_v[r][c]);
              acc_k[r][c] = fmaf(sa[r], x, acc_k[r][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= Tk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Tk + j) * KV + kh) * hd;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (c < cols && col < hd) {
        dk[off + col] = from_f<T>(acc_k[r][c] * scale);
        dv[off + col] = from_f<T>(acc_v[r][c]);
      }
    }
  }
}

template <typename T, int kC>
cudaError_t launch_grads(View q, View k, View v, View dout, const float* lse, const float* delta,
                         void* dq, void* dk, void* dv, int B, int Tq, int Tk, int H, int KV,
                         int hd, int causal, float scale, cudaStream_t stream) {
  const size_t dq_bytes = smem_bytes(hd, 1), dkdv_bytes = smem_bytes(hd, 2);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, kC>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<T, kC>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_bytes));
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(static_cast<unsigned>(B * H), static_cast<unsigned>((Tq + kBQ - 1) / kBQ));
  flash_bwd_dq_kernel<T, kC><<<dq_grid, kThreads, dq_bytes, stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(dq), Tq, Tk, H, KV, hd, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(static_cast<unsigned>(B * KV), static_cast<unsigned>((Tk + kBK - 1) / kBK));
  flash_bwd_dkdv_kernel<T, kC><<<kv_grid, kThreads, dkdv_bytes, stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, H, KV, hd,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(View q, View k, View v, View o, View dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int64_t B, int64_t Tq, int64_t Tk, int64_t H, int64_t KV,
           int64_t hd, int causal, float scale, void* stream_ptr) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd > kMaxD || B * H > INT_MAX || Tq > INT_MAX - kBK || Tk > INT_MAX - kBK ||
      (Tq + kBQ - 1) / kBQ > 65535 || (Tk + kBK - 1) / kBK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t rows = B * H * Tq;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks < 65535 * 8 ? blocks : 65535 * 8),
                              kThreads, 0, stream>>>(o, dout, delta, rows, static_cast<int>(Tq),
                                                     static_cast<int>(H), static_cast<int>(hd));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int b = static_cast<int>(B), tq = static_cast<int>(Tq), tk = static_cast<int>(Tk);
  const int h = static_cast<int>(H), kvh = static_cast<int>(KV), d = static_cast<int>(hd);
  const int hdp = round16(d);
  if (hdp <= 64)
    err = launch_grads<T, 4>(q, k, v, dout, lse, delta, dq, dk, dv, b, tq, tk, h, kvh, d,
                             causal, scale, stream);
  else if (hdp <= 128)
    err = launch_grads<T, 8>(q, k, v, dout, lse, delta, dq, dk, dv, b, tq, tk, h, kvh, d,
                             causal, scale, stream);
  else
    err = launch_grads<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, b, tq, tk, h, kvh, d,
                              causal, scale, stream);
  return static_cast<int>(err);
}

}  // namespace

// q, o, do (B, Tq, H, hd) and k, v (B, Tk, KV, hd) are strided views
// (element strides sb, st, sh; unit stride along hd) of one type; lse is
// the forward's contiguous f32 (B, H, Tq) row logsumexp; delta is a
// contiguous f32 (B, H, Tq) scratch the call overwrites; dq (B, Tq, H, hd)
// and dk, dv (B, Tk, KV, hd) are contiguous outputs of the inputs' type,
// every element of which is written. 1 <= hd <= 256, H % KV == 0.
// Launches three kernels on `stream` and returns the first CUDA error (0 on
// success). The caller checks shapes, types and devices.
#define REPRO_FLASH_BWD_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* q, int64_t qsb, int64_t qst, int64_t qsh, const void* k,    \
                      int64_t ksb, int64_t kst, int64_t ksh, const void* v, int64_t vsb,       \
                      int64_t vst, int64_t vsh, const void* o, int64_t osb, int64_t ost,       \
                      int64_t osh, const void* dout, int64_t dsb, int64_t dst, int64_t dsh,    \
                      const void* lse, void* delta, void* dq, void* dk, void* dv, int64_t B,   \
                      int64_t Tq, int64_t Tk, int64_t H, int64_t KV, int64_t hd, int causal,   \
                      float scale, void* stream) {                                             \
    return launch<T>(View{q, qsb, qst, qsh}, View{k, ksb, kst, ksh}, View{v, vsb, vst, vsh},   \
                     View{o, osb, ost, osh}, View{dout, dsb, dst, dsh},                        \
                     static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,   \
                     B, Tq, Tk, H, KV, hd, causal, scale, stream);                             \
  }

REPRO_FLASH_BWD_ENTRY(repro_flash_attention_bwd_f32, float)
REPRO_FLASH_BWD_ENTRY(repro_flash_attention_bwd_bf16, bf16)
