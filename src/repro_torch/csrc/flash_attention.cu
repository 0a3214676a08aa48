// Causal (or full) softmax attention forward for Hopper (sm_90a), bf16 or f32:
//   O[b,i,h,:] = sum_j w_ij v_j,  w_i = softmax_j(m(i,j) ? scale q_i . k_j : -1e30)
// with scale = 1/sqrt(hd) and m(i,j) = [j < Tk] (and [j <= i] when causal,
// positions counted from 0 on both sides even when Tq != Tk). q is
// (B, Tq, H, hd); k and v are (B, Tk, KV, hd) with H % KV == 0, query head h
// reading kv head h / (H / KV), so grouped-query attention never builds the
// repeated copies. The output is contiguous (B, Tq, H, hd) in the inputs'
// type. When asked (a non-null `lse`), the kernel also writes each row's
// logsumexp m + log d of the masked, scaled scores, f32 (B, H, Tq), which
// the backward (csrc/flash_attention_bwd.cu) reads; the output and its bits
// are the same either way.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:70), and computes what it computes:
// a running max m (from -1e30), denominator d and f32 accumulator acc over
// key tiles; masked scores -1e30, not -inf; p = exp(s - m) is rounded to
// the type of v before it multiplies v (the denominator sums the unrounded
// p); the output is acc / max(d, 1e-30) in q's type. The TPU grid walks
// (b*h, query block, key block) in order and carries m, d and acc in VMEM
// across the key axis, visiting the blocks above the diagonal too. Hopper
// blocks run in no order and carry nothing between them, so here one block
// owns one (b, h) and one 64-row query tile, loops over the key tiles up to
// the diagonal itself and skips the ones above it. That is exact: a wholly
// masked tile adds exp(-1e30 - m) = 0 with alpha = 1, and tile 0, which
// holds key 0, is always visited. Every sum is taken by one thread or one
// warp in a fixed order, with no atomics: two runs give the same bits.
//
// Bound: operations. At the serving shape (stablelm-12b prefill: B 8,
// T 2048, H 32, KV 8, hd 160, bf16, causal) one call does 343.7 GFLOP of
// products (4 hd per unmasked (query, key) pair); at the 989 TFLOP/s dense
// bf16 tensor-core peak that is 0.35 ms, while its 420 MB of q, k, v and
// output take 0.13 ms at 3.35 TB/s. So the products go to the tensor cores:
// this is the simple form, `mma.sync` bf16 tiles with f32 accumulation
// through the WMMA API (16 x 16 x 16 fragments), no wgmma, TMA or
// warp-specialised pipeline (that is the redesign). Per key tile, with
// 256 threads (8 warps):
//   1. K tile -> shared memory (16-byte loads when aligned);
//   2. S = Q K^T, 64 x 64 f32: each warp two 16 x 16 fragments, to shared;
//   3. V tile -> shared memory (over K); softmax rows, 4 threads a row
//      (16 columns each, shuffles for the row max and sum): P in bf16 to
//      shared, the row's m and d in registers, the row's O scaled by alpha;
//   4. O += P V, O a 64 x hd f32 tile in shared memory: each warp loads
//      its 16 x 16 fragments of O, multiplies and stores them back.
// f32 inputs take the same steps with steps 2 and 4 on the CUDA cores in
// f32 (each thread a 4 x 4 score and a 4 x hd/16 output tile), so that f32
// attention stays f32; only the tests and the reduced configs run it.
// Head dims 1 to 256: tiles are padded to a multiple of 16 with zeros,
// padded key rows are masked, padded query rows are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxD = 256;
constexpr int kLdS = kTile + 4;  // row stride (floats) of the score tile
constexpr int kLdP = kTile + 8;  // row stride (bf16) of the bf16 P tile
constexpr float kNegInf = -1e30f;

// A (B, T, heads, hd) strided view with unit stride along hd.
struct View {
  const void* p;
  int64_t sb, st, sh;
};

// Shared-memory layout for one element type and head dim.
struct Layout {
  int hdp;   // hd rounded up to 16
  int ld;    // row stride (elements) of the Q and K/V tiles
  int ld_o;  // row stride (floats) of the O tile
  size_t q, kv, s, p, o, stat, bytes;  // byte offsets and total
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <typename T>
__host__ __device__ inline Layout layout(int hd) {
  Layout l;
  l.hdp = (hd + 15) & ~15;
  // bf16 tiles feed WMMA (a stride of 8 elements = 16 bytes); f32 tiles
  // feed the SIMT products, where an odd stride spreads a column's rows
  // over all banks
  l.ld = sizeof(T) == 2 ? l.hdp + 8 : l.hdp + 1;
  l.ld_o = l.hdp + 4;
  size_t off = 0;
  l.q = off;
  off = align128(off + sizeof(T) * kTile * l.ld);
  l.kv = off;
  off = align128(off + sizeof(T) * kTile * l.ld);
  l.s = off;
  off = align128(off + sizeof(float) * kTile * kLdS);
  l.p = sizeof(T) == 2 ? off : l.s;  // f32 P overwrites S in place
  if (sizeof(T) == 2) off = align128(off + sizeof(bf16) * kTile * kLdP);
  l.o = off;
  off = align128(off + sizeof(float) * kTile * l.ld_o);
  l.stat = off;
  l.bytes = off + sizeof(float) * kTile;
  return l;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// Rows [t0, t0 + 64) of one head into a tile: dst[r * ld + c] = x[t0 + r][c],
// zero where t0 + r >= T or c >= hd, for every c < hdp.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* base, int64_t st, int t0, int T_len,
                          int hd, int hdp, bool vec) {
  constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  const int chunks = hdp / kVec;
  for (int u = threadIdx.x; u < kTile * chunks; u += kThreads) {
    const int r = u / chunks;
    const int c0 = (u - r * chunks) * kVec;
    const int t = t0 + r;
    T vals[kVec];
    if (vec) {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // zero bits: +0 in either type
      if (t < T_len && c0 < hd) raw = __ldg(reinterpret_cast<const uint4*>(base + t * st + c0));
      memcpy(vals, &raw, sizeof(raw));
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        vals[i] = (t < T_len && c0 + i < hd) ? base[t * st + c0 + i] : from_f<T>(0.f);
    }
    T* row = dst + r * ld + c0;
    if (sizeof(T) == 2) {  // ld and c0 are multiples of 8: one 16-byte store
      uint4 packed;
      memcpy(&packed, vals, sizeof(packed));
      *reinterpret_cast<uint4*>(row) = packed;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) row[i] = vals[i];
    }
  }
}

// S = Q K^T (64 x 64, f32) into s. bf16: WMMA, warp w owns row strip w / 2
// and column strips 2 (w % 2) and 2 (w % 2) + 1.
__device__ void scores(const bf16* q, const bf16* k, float* s, const Layout& l, int) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int rs = warp >> 1, cs = (warp & 1) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
  wmma::fill_fragment(c0, 0.f);
  wmma::fill_fragment(c1, 0.f);
  for (int kk = 0; kk < l.hdp; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0, b1;
    wmma::load_matrix_sync(a, q + rs * 16 * l.ld + kk, l.ld);
    wmma::load_matrix_sync(b0, k + cs * 16 * l.ld + kk, l.ld);
    wmma::load_matrix_sync(b1, k + (cs + 1) * 16 * l.ld + kk, l.ld);
    wmma::mma_sync(c0, a, b0, c0);
    wmma::mma_sync(c1, a, b1, c1);
  }
  wmma::store_matrix_sync(s + rs * 16 * kLdS + cs * 16, c0, kLdS, wmma::mem_row_major);
  wmma::store_matrix_sync(s + rs * 16 * kLdS + (cs + 1) * 16, c1, kLdS, wmma::mem_row_major);
}

// f32: thread (ty, tx) sums S[ty + 16 r][tx + 16 c] over d < hd in order.
__device__ void scores(const float* q, const float* k, float* s, const Layout& l, int hd) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int d = 0; d < hd; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = q[(ty + 16 * r) * l.ld + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = k[(tx + 16 * c) * l.ld + d];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[(ty + 16 * r) * kLdS + tx + 16 * c] = acc[r][c];
  }
}

// O += P V (O 64 x hdp f32 in shared memory, already scaled by alpha).
// bf16: WMMA over the 4 x hdp/16 fragments of O, round-robin over the warps.
__device__ void accumulate(const bf16* p, const bf16* v, float* o, const Layout& l, int) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int frags = 4 * (l.hdp / 16);
  for (int f = warp; f < frags; f += kThreads / 32) {
    const int rs = f & 3, cs = f >> 2;
    float* of = o + rs * 16 * l.ld_o + cs * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, of, l.ld_o, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p + rs * 16 * kLdP + kk, kLdP);
      wmma::load_matrix_sync(b, v + kk * l.ld + cs * 16, l.ld);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(of, c, l.ld_o, wmma::mem_row_major);
  }
}

// f32: thread (ty, tx) owns O[ty + 16 r][tx + 16 c] and sums over the 64
// keys in order. P lies in the score tile (stride kLdS).
__device__ void accumulate(const float* p, const float* v, float* o, const Layout& l, int hd) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int cols = (hd + 15) >> 4;
  float acc[4][kMaxD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < kMaxD / 16; ++c)
      if (c < cols) acc[r][c] = o[(ty + 16 * r) * l.ld_o + tx + 16 * c];
  }
  for (int j = 0; j < kTile; ++j) {
    float a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = p[(ty + 16 * r) * kLdS + j];
#pragma unroll
    for (int c = 0; c < kMaxD / 16; ++c) {
      if (c < cols) {
        const float b = v[j * l.ld + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(a[r], b, acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < kMaxD / 16; ++c)
      if (c < cols) o[(ty + 16 * r) * l.ld_o + tx + 16 * c] = acc[r][c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(View qv, View kv, View vv, T* __restrict__ out, float* __restrict__ lse,
                 int Tq, int Tk, int H, int KV, int hd, int causal, float scale, bool vec) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout l = layout<T>(hd);
  T* qs = reinterpret_cast<T*>(smem + l.q);
  T* kvs = reinterpret_cast<T*>(smem + l.kv);
  float* s = reinterpret_cast<float*>(smem + l.s);
  T* p = reinterpret_cast<T*>(smem + l.p);
  const int ldp = sizeof(T) == 2 ? kLdP : kLdS;
  float* o = reinterpret_cast<float*>(smem + l.o);
  float* denom = reinterpret_cast<float*>(smem + l.stat);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kh = h / (H / KV);
  // the longest (causal) tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const T* qb = static_cast<const T*>(qv.p) + b * qv.sb + h * qv.sh;
  const T* kb = static_cast<const T*>(kv.p) + b * kv.sb + kh * kv.sh;
  const T* vb = static_cast<const T*>(vv.p) + b * vv.sb + kh * vv.sh;

  load_tile(qs, l.ld, qb, qv.st, q0, Tq, hd, l.hdp, vec);
  for (int u = threadIdx.x; u < kTile * l.ld_o; u += kThreads) o[u] = 0.f;

  // softmax ownership: row `row`, columns 16 part .. 16 part + 15
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qi = q0 + row;
  float m_run = kNegInf, d_run = 0.f;

  const int k_tiles = (Tk + kTile - 1) / kTile;
  const int q_last = min(q0 + kTile, Tq) - 1;
  const int k_end = causal ? min(k_tiles, q_last / kTile + 1) : k_tiles;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's products are done with K/V and P
    load_tile(kvs, l.ld, kb, kv.st, k0, Tk, hd, l.hdp, vec);
    __syncthreads();
    scores(qs, kvs, s, l, hd);
    __syncthreads();  // S is whole; K is free
    load_tile(kvs, l.ld, vb, vv.st, k0, Tk, hd, l.hdp, vec);

    float sv[16];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int j = part * 16 + c, kpos = k0 + j;
      const bool keep = kpos < Tk && (!causal || qi >= kpos);
      sv[c] = keep ? s[row * kLdS + j] * scale : kNegInf;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float e = expf(sv[c] - m_new);
      sum += e;
      p[row * ldp + part * 16 + c] = from_f<T>(e);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    d_run = d_run * alpha + sum;
    m_run = m_new;
    for (int c = part; c < l.hdp; c += 4) o[row * l.ld_o + c] *= alpha;
    __syncthreads();  // P, V and the scaled O are whole
    accumulate(p, kvs, o, l, hd);
  }
  if (part == 0) {
    denom[row] = fmaxf(d_run, 1e-30f);
    if (lse != nullptr && qi < Tq)
      lse[(static_cast<int64_t>(b) * H + h) * Tq + qi] = m_run + logf(d_run);
  }
  __syncthreads();
  for (int u = threadIdx.x; u < kTile * hd; u += kThreads) {
    const int r = u / hd, c = u - r * hd;
    const int t = q0 + r;
    if (t < Tq)
      out[((static_cast<int64_t>(b) * Tq + t) * H + h) * hd + c] =
          from_f<T>(o[r * l.ld_o + c] / denom[r]);
  }
}

// Whether 16-byte loads along hd are aligned for every (b, t, head) row.
template <typename T>
bool vec_ok(const void* p, int64_t sb, int64_t st, int64_t sh, int64_t hd) {
  constexpr int64_t n = 16 / sizeof(T);
  return hd % n == 0 && sb % n == 0 && st % n == 0 && sh % n == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* q, int64_t qsb, int64_t qst, int64_t qsh, const void* k,
           int64_t ksb, int64_t kst, int64_t ksh, const void* v, int64_t vsb, int64_t vst,
           int64_t vsh, void* out, void* lse, int64_t B, int64_t Tq, int64_t Tk, int64_t H,
           int64_t KV, int64_t hd, int causal, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd > kMaxD || B * H > INT_MAX || Tq > INT_MAX - kTile || Tk > INT_MAX - kTile ||
      (Tq + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout<T>(static_cast<int>(hd));
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(flash_fwd_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = vec_ok<T>(q, qsb, qst, qsh, hd) && vec_ok<T>(k, ksb, kst, ksh, hd) &&
                   vec_ok<T>(v, vsb, vst, vsh, hd);
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((Tq + kTile - 1) / kTile));
  flash_fwd_kernel<T><<<grid, kThreads, l.bytes, static_cast<cudaStream_t>(stream)>>>(
      View{q, qsb, qst, qsh}, View{k, ksb, kst, ksh}, View{v, vsb, vst, vsh},
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<int>(Tq), static_cast<int>(Tk),
      static_cast<int>(H), static_cast<int>(KV), static_cast<int>(hd), causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Tq, H, hd), k and v (B, Tk, KV, hd) are strided views (element
// strides sb, st, sh; unit stride along hd) of one type; out is a
// contiguous (B, Tq, H, hd) output of that type, every element of which is
// written; lse is null or a contiguous f32 (B, H, Tq) output, every element
// of which is written. 1 <= hd <= 256, H % KV == 0. Launches on `stream` and returns
// cudaGetLastError() (0 on success). The caller checks shapes, types and
// devices.
#define REPRO_FLASH_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* q, int64_t qsb, int64_t qst, int64_t qsh, const void* k, \
                      int64_t ksb, int64_t kst, int64_t ksh, const void* v, int64_t vsb,    \
                      int64_t vst, int64_t vsh, void* out, void* lse, int64_t B,            \
                      int64_t Tq, int64_t Tk, int64_t H, int64_t KV, int64_t hd, int causal, \
                      float scale, void* stream) {                                          \
    return launch<T>(q, qsb, qst, qsh, k, ksb, kst, ksh, v, vsb, vst, vsh, out, lse, B, Tq, \
                     Tk, H, KV, hd, causal, scale, stream);                                 \
  }

REPRO_FLASH_ENTRY(repro_flash_attention_fwd_f32, float)
REPRO_FLASH_ENTRY(repro_flash_attention_fwd_bf16, bf16)
