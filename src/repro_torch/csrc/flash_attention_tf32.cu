// Causal (or full) softmax attention forward for Hopper (sm_90a), f32 on
// the TF32 tensor cores in split precision (3xTF32):
//   O[b,i,h,:] = sum_j w_ij v_j,  w_i = softmax_j(m(i,j) ? scale q_i . k_j : -1e30)
// with m(i,j) = [j < Tk] (and [j <= i] when causal, positions counted from
// 0 on both sides even when Tq != Tk). q is (B, Tq, H, hd); k and v are
// (B, Tk, KV, hd) strided views with H % KV == 0, query head h reading kv
// head h / (H / KV) in place. The output is contiguous f32 (B, Tq, H, hd);
// when asked (a non-null `lse`) the kernel also writes each row's
// logsumexp m + log d, f32 (B, H, Tq), which the backward
// (csrc/flash_attention_bwd.cu) reads. The output's bits are the same
// either way.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:70) for f32 at head dims up to 128
// (FuXi's training forward), and computes what csrc/flash_attention.cu
// computes: a running max m (from -1e30), a denominator d of the unrounded
// p and an f32 accumulator over key tiles; masked scores -1e30, not -inf;
// the output acc / max(d, 1e-30). Every sum is taken in a fixed order with
// no atomics, and nothing depends on the layout: two runs give the same
// bits, and so do the same values in any layout.
//
// Bound: operations. At FuXi's shape (B 64, T 512, H = KV = 8, hd 64,
// causal) one call does 17.2 GFLOP of products (4 hd per kept pair) on
// 0.268 GB of q, k, v and output: 0.104 ms on the TF32 tensor cores at the
// three passes f32 accuracy takes (3 x 17.2 GFLOP at 495 TFLOP/s), 0.257 ms
// on the f32 CUDA cores (66.9 TFLOP/s), 0.080 ms of memory (3.35 TB/s).
// csrc/flash_attention.cu runs both products on the CUDA cores, reading 8
// shared-memory values for 16 FMAs, with the O tile in shared memory.
//
// So both products run on the tensor cores as mma.sync m16n8k8 TF32, three
// times over in split precision (1e-6 relative, where one pass keeps 5e-4
// and misses the kernel's limit of 1e-5 of sum_j w_ij |v_j|). The shape is
// hstu_fwd_kernel's (csrc/hstu_attention.cu): a block owns one (b, h) and
// 128 query rows, 8 warps of 16; Q stays in shared memory; K and V come 32
// rows a step through a two-stage cp.async ring, this step's V rows
// loading behind S = Q K^T and the next step's K rows behind O += P V.
// Tiles are f32, rows padded to hd + 4 floats (4 mod 32 words: fragment
// reads free of bank conflicts), split into TF32 hi and lo parts as
// fragments are read. The softmax runs in the score accumulators: each lane
// holds two rows' 8 scores a step, takes the row max over its quad by two
// shuffles and overwrites the scores with p, which feed P V as the A
// operand where they lie; O = alpha O + P V stays in registers. Each lane
// keeps its part of the two denominators; the quad's four parts are added
// at the end. A warp skips a step whose 32 keys all come after its 16
// queries (causal): that step would add exp(-1e30 - m) = 0 with alpha = 1.
// Head dims are zero-padded to 16, 32, 64 or 128 (one instantiation each).
//
// The tensor cores add an MMA's products to its accumulator truncating,
// not rounding, so a long chain of MMAs into one running sum drifts toward
// zero, most where the values share a sign. Two sums are therefore kept
// short: S's small products (hi.lo' + lo.hi') are summed apart from its
// hi.hi' ones, and each step's P V is summed from zero (12 MMAs) and added
// to O by one fmaf. S's hi.hi' products also run from zero for each 8
// columns of hd and are added to S by an f32 add (product_abt's
// kRoundSteps): a weight's relative error is its score's absolute error,
// and at scores of std ~9 one chain of 8 truncating MMAs a score put the
// output past the limit of an f64 evaluation on one of chip_smoke's phase
// 12 draws (1.11 of it; 0.87 at most on the same draws with the rounding
// adds, for about 9% more time).
// ref.flash_attention_fwd_tf32 models the truncation (its chains="long" is
// the one-chain form, which misses the limit), and chip_smoke's phase 12
// holds values of one sign at FuXi's shape (v shifted by 2, scores of std
// ~1, 4 and 9) within the limit of an f64 evaluation.
//
// ptxas -v (nvcc 12.9, sm_90a; chip_smoke's build phase prints it): hd 16
// 119 registers, no spill; hd 32, 64 and 128 the two-blocks cap of
// __launch_bounds__, 128, spilling 48, 44 and 460 bytes (stores). Two
// blocks share an SM at every head dim: 256 threads x 128 registers each,
// and 52,224 bytes of shared memory at hd 64 (101,376 at hd 128).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxD = 128;  // head dims up to 128
constexpr float kNegInf = -1e30f;

// The view, the block shape (a block owns 128 query rows, 8 warps x 16, of
// one (b, h) and walks the keys 32 rows a step), the split, the MMA,
// FragA, cp.async, ldmatrix, the tile load and both products are
// csrc/tf32_mma.cuh's, shared with csrc/hstu_attention.cu. There the
// fragment layouts are set out: the accumulator (16 x 8) of lane 4 g + t
// holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), and product_ab
// takes it as its A operand without moving it. S = Q K^T runs
// product_abt with kApart (its small products in a chain of their own)
// and kRoundSteps (each 8 columns' hi.hi' products from zero, added by an
// f32 add).

// One step of the online softmax in the registers of a 16 x 32 score block
// s (q . k, not yet scaled) of queries r0 .. r0 + 15 and keys c0 .. c0 + 31:
// entry (nb, e) at query r0 + g + 8 (e >> 1) and key c0 + 8 nb + 2t + (e & 1),
// so half = e >> 1 names the lane's row. Leaves p = exp(z - m_new) in s,
// with z the scaled score or -1e30 where masked; m[half] becomes m_new,
// alpha[half] exp(m_old - m_new), and the lane's part of d[half]
// d alpha + its p's (added in order).
__device__ __forceinline__ void softmax_step(float (&s)[4][4], float (&m)[2], float (&d)[2],
                                             float (&alpha)[2], int r0, int c0, int Tk,
                                             int causal, float scale, int g, int t) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1), j = c0 + 8 * nb + 2 * t + (e & 1);
      const bool keep = j < Tk && (!causal || i >= j);
      s[nb][e] = keep ? s[nb][e] * scale : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    const float m_new = fmaxf(m[half], mx[half]);
    alpha[half] = expf(m[half] - m_new);
    m[half] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nb][e] = expf(s[nb][e] - m[e >> 1]);
      sum[e >> 1] += s[nb][e];
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) d[half] = d[half] * alpha[half] + sum[half];
}

// Shared memory: the block's 128 query rows and two stages of 32 rows.
template <int kD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kD + 4) * (kRows + 2 * kStep);
}

// O (and the lse) for 128 query rows of one (b, h): for each step of 32
// keys up to the diagonal, S = Q K^T, the softmax step in S's registers,
// then O = alpha O + P V, P V summed from zero apart (a chain of 12 MMAs,
// not one through every step; csrc/tf32_mma.cuh says why) and added by one
// fmaf.
// Stage 0 of the ring holds the step's K rows, stage 1 its
// V rows: this step's V rows load behind S = Q K^T, the next step's K rows
// behind P V. At hd 64 that is 52,224 bytes of shared memory, at 128
// 101,376; at most 128 registers a thread, so two blocks share an SM and
// one block's products run while the other waits at a barrier.
template <int kD>
__global__ void __launch_bounds__(kThreads, 2)
flash_tf32_fwd_kernel(View q, View k, View v, float* __restrict__ o,
                      float* __restrict__ lse, int Tq, int Tk, int H, int KV, int hd,
                      int causal, float scale, bool vec_q, bool vec_k, bool vec_v) {
  constexpr int kLd = kD + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // 128 query rows
  float* ks = qs + kRows * kLd;                   // stage 0: 32 K rows
  float* vs = ks + kStep * kLd;                   // stage 1: their V rows
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KV);
  const int n_tiles = (Tq + kRows - 1) / kRows;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kRows;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp;
  const float* kb = head_base(k, b, kh);
  const float* vb = head_base(v, b, kh);

  load_tile<kD, kRows>(qs, head_base(q, b, h), q.st, q0, Tq, hd, vec_q);
  load_tile<kD, kStep>(ks, kb, k.st, 0, Tk, hd, vec_k);
  cp_async_commit();
  load_tile<kD, kStep>(vs, vb, v.st, 0, Tk, hd, vec_v);
  cp_async_commit();
  cp_async_wait<1>();  // Q and the first K rows have landed
  __syncthreads();
  float acc[kD / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, d[2] = {0.f, 0.f};
  // causal: the block's last query row sees keys up to itself
  const int k_end = causal ? min(Tk, min(Tq, q0 + kRows)) : Tk;
  const int steps = (k_end + kStep - 1) / kStep;
  for (int step = 0; step < steps; ++step) {
    const int k0 = step * kStep;
    const bool live = row0 < Tq && !(causal && k0 > row0 + 15);
    float s[4][4] = {}, alpha[2];
    if (live) {
      product_abt<kD, true, true>(s, qs + 16 * warp * kLd, ks, lane);
      softmax_step(s, m, d, alpha, row0, k0, Tk, causal, scale, g, t);
    }
    cp_async_wait<0>();  // this step's V rows have landed
    __syncthreads();     // ... for every thread, and no warp reads the K rows now
    if (step + 1 < steps) load_tile<kD, kStep>(ks, kb, k.st, k0 + kStep, Tk, hd, vec_k);
    cp_async_commit();
    if (live) {
      float pv[kD / 8][4] = {};
      product_ab<kD>(pv, s, vs, g, t);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
      }
    }
    cp_async_wait<0>();  // the next step's K rows have landed
    __syncthreads();     // ... for every thread, and no warp reads the V rows now
    if (step + 1 < steps) load_tile<kD, kStep>(vs, vb, v.st, k0 + kStep, Tk, hd, vec_v);
    cp_async_commit();
  }
  if (row0 >= Tq) return;  // no barrier follows
  // the quad's four parts of each row's denominator, (t, t ^ 1) then the
  // other pair: the same bits in all four lanes
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    d[half] += __shfl_xor_sync(0xffffffffu, d[half], 1);
    d[half] += __shfl_xor_sync(0xffffffffu, d[half], 2);
  }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row < Tq) lse[(static_cast<int64_t>(b) * H + h) * Tq + row] = m[half] + logf(d[half]);
    }
  }
  const float den[2] = {fmaxf(d[0], 1e-30f), fmaxf(d[1], 1e-30f)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= Tq) continue;
    float* dst = o + ((static_cast<int64_t>(b) * Tq + row) * H + h) * hd;
#pragma unroll
    for (int pr = 0; pr < kD / 16; ++pr) {
      const int c = 16 * pr + 4 * t;
      const float x[4] = {acc[2 * pr][2 * half] / den[half],
                          acc[2 * pr + 1][2 * half] / den[half],
                          acc[2 * pr][2 * half + 1] / den[half],
                          acc[2 * pr + 1][2 * half + 1] / den[half]};
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

// Whether float4 loads along hd are aligned for every (b, t, head) row.
bool vec_ok(const float* p, int64_t sb, int64_t st, int64_t sh, int64_t hd) {
  return hd % 4 == 0 && sb % 4 == 0 && st % 4 == 0 && sh % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// q (B, Tq, H, hd), k and v (B, Tk, KV, hd) are f32 strided views (element
// strides sb, st, sh; unit stride along hd); out is a contiguous f32
// (B, Tq, H, hd) output, every element of which is written; lse is null or
// a contiguous f32 (B, H, Tq) output, every element of which is written.
// 1 <= hd <= 128, H % KV == 0. Launches on `stream` and returns
// cudaGetLastError() (0 on success). The caller checks shapes, types and
// devices.
extern "C" int repro_flash_attention_fwd_tf32x3(
    const void* q, int64_t qsb, int64_t qst, int64_t qsh, const void* k, int64_t ksb,
    int64_t kst, int64_t ksh, const void* v, int64_t vsb, int64_t vst, int64_t vsh,
    void* out, void* lse, int64_t B, int64_t Tq, int64_t Tk, int64_t H, int64_t KV,
    int64_t hd, int causal, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd > kMaxD || B * H > INT_MAX || Tq > INT_MAX - kRows || Tk > INT_MAX - kStep ||
      (Tq + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const View qv{qp, qsb, qst, qsh}, kv{kp, ksb, kst, ksh}, vv{vp, vsb, vst, vsh};
  const bool vec_q = vec_ok(qp, qsb, qst, qsh, hd), vec_k = vec_ok(kp, ksb, kst, ksh, hd),
             vec_v = vec_ok(vp, vsb, vst, vsh, hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return at_head_dim(hd, [&](auto pad) {
    constexpr int kD = decltype(pad)::value;
    constexpr size_t bytes = smem_bytes<kD>();
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(flash_tf32_fwd_kernel<kD>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(B * H),
                    static_cast<unsigned>((Tq + kRows - 1) / kRows));
    flash_tf32_fwd_kernel<kD><<<grid, kThreads, bytes, st>>>(
        qv, kv, vv, static_cast<float*>(out), static_cast<float*>(lse),
        static_cast<int>(Tq), static_cast<int>(Tk), static_cast<int>(H),
        static_cast<int>(KV), static_cast<int>(hd), causal, scale, vec_q, vec_k, vec_v);
    return static_cast<int>(cudaGetLastError());
  });
}
