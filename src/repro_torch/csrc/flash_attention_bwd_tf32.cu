// Backward of causal (or full) softmax attention for Hopper (sm_90a), f32
// on the TF32 tensor cores in split precision (3xTF32). Given q, k, v, the
// forward's output o, the output gradient do and the forward's row
// logsumexp lse (csrc/flash_attention_tf32.cu writes it), it computes what
// csrc/flash_attention_bwd.cu computes:
//   P_ij  = exp(scale q_i . k_j - lse_i)   (0 where masked)
//   delta_i = do_i . o_i
//   dv_j  = sum_i P_ij do_i
//   dS_ij = P_ij (do_i . v_j - delta_i)
//   dq_i  = scale sum_j dS_ij k_j,   dk_j = scale sum_i dS_ij q_i
// with scale = 1/sqrt(hd) of the real head dim and the forward's mask: key
// j < Tk and, when causal, j <= i, positions counted from 0 on both sides
// even when Tq != Tk. q, o and do are (B, Tq, H, hd); k and v are
// (B, Tk, KV, hd) with H % KV == 0, query head h reading kv head
// h / (H / KV); each kv head's dk and dv sum over its group of query heads.
// Inputs are f32 strided views with a unit stride along hd; dq, dk and dv
// are contiguous f32, and keys that no query sees get dk = dv = 0.
//
// Replaces no Pallas kernel: the TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:70) is forward only, and the JAX
// package gets this gradient by autodiff of `chunked_attention`
// (src/repro/models/layers.py:160), which FuXi's layers run. It takes f32
// at head dims up to 128 (FuXi's training backward); bf16 and larger head
// dims stay on csrc/flash_attention_bwd.cu.
//
// Bound: operations. At FuXi's shape (B 64, T 512, H = KV = 8, hd 64,
// causal) one call does 43.0 GFLOP (10 hd a kept (query, key) pair: S, dP,
// dv, dq and dk): 0.261 ms on the TF32 tensor cores at the three passes f32
// accuracy takes (3 x 43.0 GFLOP at 495 TFLOP/s), 0.643 ms on the f32 CUDA
// cores (66.9 TFLOP/s), 0.161 ms for its 0.538 GB of bytes (3.35 TB/s).
// csrc/flash_attention_bwd.cu runs every product on the CUDA cores, its
// score loop reading 12 shared-memory values for 16 FMAs, and stages P and
// dS in shared memory between the two halves of each tile.
//
// So every product runs on the tensor cores as mma.sync m16n8k8 TF32,
// three times over in split precision, on csrc/tf32_mma.cuh's pieces, in
// the shape of the hstu_attention backward (csrc/hstu_attention.cu):
//   1. delta: one warp a (b, h, query) row, do . o summed lane-strided and
//      then by a fixed shuffle tree, into an f32 (B, H, Tq) scratch (a copy
//      of flash_bwd_delta_kernel: the two sources build apart);
//   2. dq: one block a (b, h, 128 query rows), the longest causal tiles
//      first; 8 warps of 16 rows. Q and dO stay in shared memory, each
//      warp's rows' lse and delta in registers; K and V of the kv head come
//      32 rows a step through a two-stage cp.async ring, up to the
//      diagonal. Each step: S = Q K^T and dP = dO V^T, then P and dS in the
//      accumulators where they lie, then dS K with dS as the A operand
//      unmoved (tf32_mma.cuh: product_ab), scaled at the store;
//   3. dk/dv: one block a (b, kv head, 128 key rows), key tile 0 first. K
//      and V stay in shared memory; for each query head of the group in
//      head order, Q and dO come 32 rows a step through the ring from the
//      diagonal on, those rows' lse and delta staged beside them (in S^T
//      they index columns). Each step: S^T = K Q^T and dP^T = V dO^T, P^T
//      and dS^T in the registers, then P^T dO into dV and dS^T Q into dK.
// A warp skips a step whose keys all lie after its rows (dq) or whose
// queries all lie before its keys (dk/dv), causal. No atomics and a fixed
// summation order: two runs give the same bits, in every layout.
//
// The tensor cores add an MMA's products to its accumulator truncating, so
// a long chain of MMAs into one running sum drifts toward zero where the
// terms share a sign (tf32_mma.cuh; the flash forward met it). Every chain is
// kept within one 32-row step: S and dP keep their small products
// (hi.lo' + lo.hi') apart (product_abt<kD, true>), and each step's dS K,
// P^T dO and dS^T Q are summed from zero (12 MMAs a column block) and added
// to dQ, dV and dK by one f32 add. ref.flash_attention_bwd_tf32 models it
// (chains="long" is the one-chain form). S's hi.hi' products stay one
// chain of kD / 8 MMAs an entry: the backward's limit carries each
// score's own rounding (ref.flash_attention_bwd_bound), so the forward's
// rounding adds (kRoundSteps), which cost registers and time, buy nothing
// here.
//
// Shared memory at hd 64: (64 + 4) x (2 x 128 + 2 x 2 x 32) x 4 B = 104,448
// bytes a block (the dk/dv kernel 512 more for the staged lse and delta),
// so two blocks share an SM at head dims up to 64 (`__launch_bounds__`
// caps them at 128 registers); at hd 128 one block (202,752 bytes). ptxas
// registers and spills by head dim: chip_smoke's build phase prints them
// (PERF.md §6 records them).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxD = 128;  // head dims up to 128

// The view, the block shape (a block owns 128 rows, 8 warps x 16, and
// walks the other side 32 rows a step), the split, the MMA, cp.async,
// ldmatrix, the tile load, both products and the row store are
// csrc/tf32_mma.cuh's. There
// the fragment layouts are set out: entry (nb, e) of a 16 x 32 accumulator
// block sits at row g + 8 (e >> 1) and column 8 nb + 2t + (e & 1) of lane
// 4 g + t, and product_ab takes the block as its A operand without moving
// it.

// delta[(b H + h) Tq + i] = do[b, i, h] . o[b, i, h], one warp a row.
__global__ void __launch_bounds__(kThreads)
flash_tf32_bwd_delta_kernel(View ov, View dov, float* __restrict__ delta, int64_t rows,
                            int Tq, int H, int hd) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t r = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5; r < rows;
       r += warps) {
    const int64_t bh = r / Tq;
    const int i = static_cast<int>(r - bh * Tq);
    const int b = static_cast<int>(bh / H), h = static_cast<int>(bh - static_cast<int64_t>(b) * H);
    const float* o = head_base(ov, b, h) + static_cast<int64_t>(i) * ov.st;
    const float* g = head_base(dov, b, h) + static_cast<int64_t>(i) * dov.st;
    float acc = 0.f;
    for (int c = lane; c < hd; c += 32) acc = fmaf(g[c], o[c], acc);
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) delta[r] = acc;
  }
}

// P and dS of one (query i, key j) entry in place of its score s (q . k,
// not yet scaled) and dp (do . v): 0 where masked, rows past Tq included
// (their zero-filled q would give exp(-lse), not 0).
__device__ __forceinline__ void grads_of_entry(float& s, float& dp, int i, int j, float lse,
                                               float delta, int Tq, int Tk, int causal,
                                               float scale) {
  const bool keep = i < Tq && j < Tk && (!causal || i >= j);
  const float p = keep ? expf(s * scale - lse) : 0.f;
  s = p;
  dp = p * (dp - delta);
}

// acc += part, entry by entry: a step's sum, taken from zero, added to the
// running one by one f32 add.
template <int kD>
__device__ __forceinline__ void add_step(float (&acc)[kD / 8][4], const float (&part)[kD / 8][4]) {
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// Shared memory of the dq kernel: 128 rows of Q and of dO, and a two-stage
// ring of 32 K rows and 32 V rows.
template <int kD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (kD + 4) * (2 * kRows + 2 * 2 * kStep);
}

// Shared memory of the dk/dv kernel: 128 rows of K and of V, a two-stage
// ring of 32 Q rows and 32 dO rows, and each stage's 32 lse and delta.
template <int kD>
constexpr size_t dkdv_smem_bytes() {
  return dq_smem_bytes<kD>() + sizeof(float) * 2 * 2 * kStep;
}

// dQ for 128 query rows of one (b, h): for each step of 32 keys up to the
// diagonal, S = Q K^T and dP = dO V^T (small products apart), P and dS in
// their accumulators, then dS K from zero, added to dQ.
template <int kD>
__global__ void __launch_bounds__(kThreads, kD <= 64 ? 2 : 1)
flash_tf32_bwd_dq_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq, int Tq,
                         int Tk, int H, int KV, int hd, int causal, float scale, bool vec_q,
                         bool vec_k, bool vec_v, bool vec_do) {
  constexpr int kLd = kD + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // 128 query rows
  float* dos = qs + kRows * kLd;                 // their dO rows
  float* ring = dos + kRows * kLd;               // stage s: K rows, then V rows
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KV);
  const int n_tiles = (Tq + kRows - 1) / kRows;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kRows;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp;
  const float* kb = head_base(k, b, kh);
  const float* vb = head_base(v, b, kh);

  load_tile<kD, kRows>(qs, head_base(q, b, h), q.st, q0, Tq, hd, vec_q);
  load_tile<kD, kRows>(dos, head_base(dout, b, h), dout.st, q0, Tq, hd, vec_do);
  load_tile<kD, kStep>(ring, kb, k.st, 0, Tk, hd, vec_k);
  load_tile<kD, kStep>(ring + kStep * kLd, vb, v.st, 0, Tk, hd, vec_v);
  cp_async_commit();
  float row_lse[2], row_delta[2];  // rows row0 + g and row0 + g + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row0 + g + 8 * half;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Tq + i;
    row_lse[half] = i < Tq ? lse[at] : 0.f;
    row_delta[half] = i < Tq ? delta[at] : 0.f;
  }
  float acc[kD / 8][4] = {};
  // causal: the block's last query row sees keys up to itself
  const int k_end = causal ? min(Tk, min(Tq, q0 + kRows)) : Tk;
  const int steps = (k_end + kStep - 1) / kStep;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {  // the stage read one step ago; a barrier has passed
      float* next = ring + ((step + 1) & 1) * 2 * kStep * kLd;
      const int k1 = (step + 1) * kStep;
      load_tile<kD, kStep>(next, kb, k.st, k1, Tk, hd, vec_k);
      load_tile<kD, kStep>(next + kStep * kLd, vb, v.st, k1, Tk, hd, vec_v);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step's K and V rows have landed
    __syncthreads();     // ... for every thread
    const int k0 = step * kStep;
    const float* ks = ring + (step & 1) * 2 * kStep * kLd;
    if (row0 < Tq && !(causal && k0 > row0 + 15)) {
      float s[4][4] = {}, dp[4][4] = {};
      product_abt<kD, true>(s, qs + 16 * warp * kLd, ks, lane);
      product_abt<kD, true>(dp, dos + 16 * warp * kLd, ks + kStep * kLd, lane);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          grads_of_entry(s[nb][e], dp[nb][e], row0 + g + 8 * (e >> 1),
                         k0 + 8 * nb + 2 * t + (e & 1), row_lse[e >> 1], row_delta[e >> 1],
                         Tq, Tk, causal, scale);
        }
      }
      float part[kD / 8][4] = {};
      product_ab<kD>(part, dp, ks, g, t);  // dp holds dS now
      add_step<kD>(acc, part);
    }
    __syncthreads();  // every warp is done with this stage
  }
  store_rows<kD>(dq, acc, scale, b, h, row0, Tq, H, hd, g, t);
}

// dK and dV for 128 key rows of one (b, kv head): for each query head of
// its group in head order, and each step of 32 queries from the diagonal
// on, S^T = K Q^T and dP^T = V dO^T (small products apart), P^T and dS^T
// in their accumulators, then P^T dO and dS^T Q, each from zero, added to
// dV and dK. The ring runs over (head, step) pairs, so the next head's
// first rows load behind the last step of the one before.
template <int kD>
__global__ void __launch_bounds__(kThreads, kD <= 64 ? 2 : 1)
flash_tf32_bwd_dkdv_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dk,
                           float* __restrict__ dv, int Tq, int Tk, int H, int KV, int hd,
                           int causal, float scale, bool vec_q, bool vec_k, bool vec_v,
                           bool vec_do) {
  constexpr int kLd = kD + 4;
  extern __shared__ float4 smem4[];
  float* kbuf = reinterpret_cast<float*>(smem4);  // 128 key rows
  float* vbuf = kbuf + kRows * kLd;                // their V rows
  float* ring = vbuf + kRows * kLd;                // stage s: Q rows, then dO rows
  float* stats = ring + 2 * 2 * kStep * kLd;       // stage s: 32 lse, then 32 delta
  const int b = blockIdx.x / KV, kh = blockIdx.x % KV;
  const int group = H / KV;
  const int k0 = static_cast<int>(blockIdx.y) * kRows;  // tile 0 loops longest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 16 * warp;

  // causal: the first query that sees a key of the block is k0
  const int i_begin = causal ? k0 : 0;
  const int per_head = Tq > i_begin ? (Tq - i_begin + kStep - 1) / kStep : 0;
  const int total = per_head * group;
  // step n's Q and dO rows into stage n & 1 and their lse and delta beside
  // them (plain loads: a barrier lies between them and every reader)
  auto stage_in = [&](int n) {
    const int h = kh * group + n / per_head;
    const int i0 = i_begin + (n % per_head) * kStep;
    float* st = ring + (n & 1) * 2 * kStep * kLd;
    load_tile<kD, kStep>(st, head_base(q, b, h), q.st, i0, Tq, hd, vec_q);
    load_tile<kD, kStep>(st + kStep * kLd, head_base(dout, b, h), dout.st, i0, Tq, hd, vec_do);
    if (threadIdx.x < 2 * kStep) {
      const int i = i0 + (threadIdx.x & (kStep - 1));
      const int64_t at = (static_cast<int64_t>(b) * H + h) * Tq + i;
      stats[(n & 1) * 2 * kStep + threadIdx.x] =
          i < Tq ? (threadIdx.x < kStep ? lse[at] : delta[at]) : 0.f;
    }
  };
  load_tile<kD, kRows>(kbuf, head_base(k, b, kh), k.st, k0, Tk, hd, vec_k);
  load_tile<kD, kRows>(vbuf, head_base(v, b, kh), v.st, k0, Tk, hd, vec_v);
  if (total > 0) stage_in(0);
  cp_async_commit();
  float acc_k[kD / 8][4] = {}, acc_v[kD / 8][4] = {};
  for (int n = 0; n < total; ++n) {
    if (n + 1 < total) stage_in(n + 1);  // the stage read one step ago; a barrier has passed
    cp_async_commit();
    cp_async_wait<1>();  // this step's Q and dO rows have landed
    __syncthreads();     // ... for every thread, with their lse and delta
    const int i0 = i_begin + (n % per_head) * kStep;
    const float* qs = ring + (n & 1) * 2 * kStep * kLd;
    const float* dos = qs + kStep * kLd;
    const float* st = stats + (n & 1) * 2 * kStep;
    if (key0 < Tk && !(causal && i0 + kStep - 1 < key0)) {
      float s[4][4] = {}, dp[4][4] = {};
      product_abt<kD, true>(s, kbuf + 16 * warp * kLd, qs, lane);  // [key][query]
      product_abt<kD, true>(dp, vbuf + 16 * warp * kLd, dos, lane);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nb + 2 * t + (e & 1);  // the query's column in the step
          grads_of_entry(s[nb][e], dp[nb][e], i0 + c, key0 + g + 8 * (e >> 1), st[c],
                         st[kStep + c], Tq, Tk, causal, scale);
        }
      }
      float part[kD / 8][4] = {};
      product_ab<kD>(part, s, dos, g, t);  // s holds P^T now
      add_step<kD>(acc_v, part);
#pragma unroll
      for (int nn = 0; nn < kD / 8; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nn][e] = 0.f;
      }
      product_ab<kD>(part, dp, qs, g, t);  // dp holds dS^T
      add_step<kD>(acc_k, part);
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // K and V's copies, where no step read them
  store_rows<kD>(dk, acc_k, scale, b, kh, key0, Tk, KV, hd, g, t);
  store_rows<kD>(dv, acc_v, 1.f, b, kh, key0, Tk, KV, hd, g, t);
}

// Whether float4 loads along hd are aligned for every (b, t, head) row.
bool vec_ok(const float* p, int64_t sb, int64_t st, int64_t sh, int64_t hd) {
  return hd % 4 == 0 && sb % 4 == 0 && st % 4 == 0 && sh % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Dynamic shared memory above 48 KB has to be granted per kernel first.
cudaError_t grant(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// launch(std::integral_constant<int, kD>{}) at the smallest padded head dim
// of 16, 32, 64 or 128 that holds hd.
template <typename F>
int at_head_dim(int64_t hd, F&& launch) {
  if (hd <= 16) return launch(std::integral_constant<int, 16>{});
  if (hd <= 32) return launch(std::integral_constant<int, 32>{});
  if (hd <= 64) return launch(std::integral_constant<int, 64>{});
  return launch(std::integral_constant<int, 128>{});
}

}  // namespace

// q, o, do (B, Tq, H, hd) and k, v (B, Tk, KV, hd) are f32 strided views
// (element strides sb, st, sh; unit stride along hd); lse is the forward's
// contiguous f32 (B, H, Tq) row logsumexp; delta is a contiguous f32
// (B, H, Tq) scratch the call overwrites; dq (B, Tq, H, hd) and dk, dv
// (B, Tk, KV, hd) are contiguous f32 outputs, every element of which is
// written. 1 <= hd <= 128, H % KV == 0. Launches the delta pass, the dq
// kernel and the dk/dv kernel on `stream` and returns the first CUDA error
// (0 on success). The caller checks shapes, types and devices.
extern "C" int repro_flash_attention_bwd_tf32x3(
    const void* q, int64_t qsb, int64_t qst, int64_t qsh, const void* k, int64_t ksb,
    int64_t kst, int64_t ksh, const void* v, int64_t vsb, int64_t vst, int64_t vsh,
    const void* o, int64_t osb, int64_t ost, int64_t osh, const void* dout, int64_t dsb,
    int64_t dst, int64_t dsh, const void* lse, void* delta, void* dq, void* dk, void* dv,
    int64_t B, int64_t Tq, int64_t Tk, int64_t H, int64_t KV, int64_t hd, int causal,
    float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd > kMaxD || B * H > INT_MAX || Tq > INT_MAX - kRows || Tk > INT_MAX - kRows ||
      (Tq + kRows - 1) / kRows > 65535 || (Tk + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* op = static_cast<const float*>(o);
  const float* dp = static_cast<const float*>(dout);
  const View qv{qp, qsb, qst, qsh}, kv{kp, ksb, kst, ksh}, vv{vp, vsb, vst, vsh},
      ov{op, osb, ost, osh}, dov{dp, dsb, dst, dsh};
  const bool vec_q = vec_ok(qp, qsb, qst, qsh, hd), vec_k = vec_ok(kp, ksb, kst, ksh, hd),
             vec_v = vec_ok(vp, vsb, vst, vsh, hd), vec_do = vec_ok(dp, dsb, dst, dsh, hd);
  const float* lse_p = static_cast<const float*>(lse);
  float* delta_p = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = B * H * Tq;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_tf32_bwd_delta_kernel<<<static_cast<unsigned>(blocks < 65535 * 8 ? blocks : 65535 * 8),
                                kThreads, 0, st>>>(ov, dov, delta_p, rows, static_cast<int>(Tq),
                                                   static_cast<int>(H), static_cast<int>(hd));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return at_head_dim(hd, [&](auto pad) {
    constexpr int kD = decltype(pad)::value;
    constexpr size_t dq_bytes = dq_smem_bytes<kD>(), dkdv_bytes = dkdv_smem_bytes<kD>();
    cudaError_t e = grant(reinterpret_cast<const void*>(flash_tf32_bwd_dq_kernel<kD>), dq_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = grant(reinterpret_cast<const void*>(flash_tf32_bwd_dkdv_kernel<kD>), dkdv_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int tq = static_cast<int>(Tq), tk = static_cast<int>(Tk), h = static_cast<int>(H),
              kvh = static_cast<int>(KV), d = static_cast<int>(hd);
    const dim3 dq_grid(static_cast<unsigned>(B * H),
                       static_cast<unsigned>((Tq + kRows - 1) / kRows));
    flash_tf32_bwd_dq_kernel<kD><<<dq_grid, kThreads, dq_bytes, st>>>(
        qv, kv, vv, dov, lse_p, delta_p, static_cast<float*>(dq), tq, tk, h, kvh, d, causal,
        scale, vec_q, vec_k, vec_v, vec_do);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 kv_grid(static_cast<unsigned>(B * KV),
                       static_cast<unsigned>((Tk + kRows - 1) / kRows));
    flash_tf32_bwd_dkdv_kernel<kD><<<kv_grid, kThreads, dkdv_bytes, st>>>(
        qv, kv, vv, dov, lse_p, delta_p, static_cast<float*>(dk), static_cast<float*>(dv), tq,
        tk, h, kvh, d, causal, scale, vec_q, vec_k, vec_v, vec_do);
    return static_cast<int>(cudaGetLastError());
  });
}
