// Backward of causal (or full) softmax attention for Hopper (sm_90a), bf16,
// on the tensor cores through wgmma, fed by TMA: LM training's backward in
// kernels/flash_attention.py. It computes what csrc/flash_attention_bwd.cu
// computes: given q, k, v, the forward's output o, the output gradient do
// and the forward's row logsumexp lse,
//   P_ij  = exp(scale q_i . k_j - lse_i)   (0 where masked)
//   delta_i = do_i . o_i
//   dv_j  = sum_i P_ij do_i
//   dS_ij = P_ij (do_i . v_j - delta_i)
//   dq_i  = scale sum_j dS_ij k_j,   dk_j = scale sum_i dS_ij q_i
// with scale = 1/sqrt(hd) and the forward's mask: key j < Tk and, when
// causal, j <= i, positions counted from 0 on both sides even when
// Tq != Tk. q, o and do are (B, Tq, H, hd); k and v are (B, Tk, KV, hd) with
// H % KV == 0, query head h reading kv head h / (H / KV); each kv head's dk
// and dv sum over its group of query heads, in head order.
//
// Replaces no Pallas kernel: the TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:70) is forward only, and the JAX
// package gets this gradient by autodiff of `chunked_attention`
// (src/repro/models/layers.py:160).
//
// Bound: operations. At LM training's call (stablelm-3b: B 2, T 4096,
// H = KV = 32, hd 80, causal) the function does 429.6 GFLOP (10 hd a kept
// (query, key) pair: S, dP, dv, dq and dk), 0.434 ms at the 989 TFLOP/s
// dense bf16 tensor-core peak, against 0.10 ms for its 0.34 GB of bytes at
// 3.35 TB/s; at pixtral-12b's (B 2, T 4096, 32 heads of 160 over 8) 859.2
// GFLOP, 0.869 ms, against 0.13 ms for 0.42 GB. Only wgmma reaches that
// rate, so every product runs there, with the forward's pieces
// (csrc/wgmma.cuh), in three launches, no atomics, every sum in a fixed
// order (two runs give the same bits):
//   1. delta: one warp a (b, h, query) row, do . o over 16-byte loads (8
//      columns a lane, added in order) and a fixed shuffle tree, into an
//      f32 (B, H, Tq) scratch.
//   2. dq: one block a (b, h, 128-query tile), longest causal tiles first;
//      warpgroups 0 and 1 consume, 64 query rows each (setmaxnreg 232),
//      warpgroup 2 produces (setmaxnreg 40; one thread issues every copy).
//      TMA loads the Q and dO tiles once, and 64-key K and V tiles into a
//      ring of 2 stages (a full barrier a stage for the copy's bytes, an
//      empty one every consumer thread arrives at). S = Q K^T and dP = dO V^T
//      run as wgmma with both operands K-major from shared memory; in the
//      accumulator layout P = exp2(S scale log2(e) - lse log2(e)) and
//      dS = P (dP - delta), the rows' lse and delta read once into
//      registers; dS, in bf16, is the A fragment of dQ += dS K, K an
//      MN-major B operand (the forward's P V form, transpose bit included).
//      Epilogue: dq = scale acc in bf16 into the warpgroup's rows of the Q
//      tile, stored by TMA.
//   3. dk/dv: one block a (b, kv head, 128-key tile), the first key tiles
//      (the most queries, causal) first; the same three warpgroups, 64 keys
//      a consumer. K and V are loaded once; the block walks the group's
//      query heads in head order and in each the query tiles (64 rows, 32
//      above hd 128: QStep) from the diagonal on, Q and dO by TMA through
//      the ring (2 stages, 4 above hd 128) and the tile's lse
//      (times log2(e)) and delta written into the stage by a producer warp
//      with plain loads (it arrives at the stage's full barrier with the
//      copy). It computes the transposed scores S^T = K Q^T and dP^T = V dO^T
//      (mma_ss), forms P^T and dS^T in registers with each column's lse and
//      delta read from shared memory, and takes both from registers as A:
//      dV += P^T dO and dK += dS^T Q (mma_rs, dO and Q MN-major B). So no
//      operand is ever written back to shared memory. Epilogue: dk = scale
//      acc and dv = acc in bf16 into the warpgroup's rows of the K and V
//      tiles, stored by TMA.
// Rounding, as SDPA's backward: S, dP and every sum in f32; P is rounded to
// bf16 only as the A operand of dV, dS only as the A operand of dq and dk
// (never S before the exp). ref.flash_attention_bwd_bf16 models it on the
// CPU; ref.flash_attention_bwd_bound(..., products="bf16") is its bound.
// Masking: tiles wholly above the diagonal are skipped (a warpgroup whose
// 64 rows a tile masks wholly only releases the stage); on the others P = 0
// where the pair is masked or past T. Rows past T come back from TMA as
// zeros, and the stores clip them. Registers of a dk/dv consumer: at hd 128
// dK and dV 64 each, S^T and dP^T 32 each at 64 queries a tile, the bf16
// P^T and dS^T 16 each (224); at hd 160 dK and dV take 80 each, so the
// query step is 32: S^T and dP^T are m64n32k16 products (mma_ss<32>) of 16
// registers each, P^T and dS^T 8 each (208, under setmaxnreg's 232), and
// dV and dK take two k16 steps of mma_rs<160> a tile. The step changes no
// sum's order: dK and dV still add their queries 16 at a time, in order. The dq kernel keeps 64-key tiles at every head dim (dQ 80, S and
// dP 32 each, dS 16 at hd 160).
// Head dims 64, 80, 128 and 160 (the column blocks of Atom<HD>); anything
// else goes to the other backward kernels, and views TMA cannot describe
// are copied first (the wrapper's choice).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;         // rows a block owns: two consumer warpgroups of 64
constexpr int kStep = 64;          // the dq kernel: keys a tile
constexpr int kStages = 2;         // the dq kernel's ring
constexpr int kThreads = 384;      // warpgroups 0 and 1 consume, 2 produces
constexpr int kDeltaThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// A (B, T, heads, hd) bf16 strided view with unit stride along hd.
struct View {
  const void* p;
  int64_t sb, st, sh;
};

// The dk/dv kernel's queries a tile and its ring: 64 in 2 stages, as the
// dq kernel's keys; above hd 128, where dK and dV alone hold HD registers a
// thread, 32 in 4 stages, so that S^T and dP^T (m64n32) take 16 each.
template <int HD>
struct QStep {
  static constexpr int kRows = HD > 128 ? 32 : 64;
  static constexpr int kStages = HD > 128 ? 4 : 2;
};

// Shared-memory layouts, from a 1024-byte aligned base: every tile in the
// column blocks of Atom<HD>, a 128-row tile (kBig), a 64-row one (kSmall)
// or one of the dk/dv kernel's query step (kQTile).
template <int HD>
struct Tiles : Atom<HD> {
  static constexpr uint32_t kBig = kRows * HD * 2;
  static constexpr uint32_t kSmall = kStep * HD * 2;
  static constexpr uint32_t kQTile = QStep<HD>::kRows * HD * 2;
};

// dq: Q and dO (128 rows), then the ring of K and V (64 rows); barriers:
// Q/dO full, K/V full a stage, empty a stage.
template <int HD>
struct DqShape : Tiles<HD> {
  using T = Tiles<HD>;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = T::kBig;
  static constexpr uint32_t kK = 2 * T::kBig;
  static constexpr uint32_t kV = kK + kStages * T::kSmall;
  static constexpr uint32_t kBar = kV + kStages * T::kSmall;
  static constexpr uint32_t kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment room
};

// dk/dv: K and V (128 rows), then the ring of Q and dO (QStep rows) and of
// the tile's lse (log2 units) and delta; barriers: K/V full, full a stage,
// empty a stage.
template <int HD>
struct DkdvShape : Tiles<HD> {
  using T = Tiles<HD>;
  static constexpr int kQRows = QStep<HD>::kRows, kQStages = QStep<HD>::kStages;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = T::kBig;
  static constexpr uint32_t kQ = 2 * T::kBig;
  static constexpr uint32_t kDO = kQ + kQStages * T::kQTile;
  static constexpr uint32_t kLse = kDO + kQStages * T::kQTile;
  static constexpr uint32_t kDelta = kLse + kQStages * kQRows * 4;
  static constexpr uint32_t kBar = kDelta + kQStages * kQRows * 4;
  static constexpr uint32_t kSmem = kBar + 8 * (1 + 2 * kQStages) + 1024;
};

// delta[(b H + h) Tq + i] = do[b, i, h] . o[b, i, h], one warp a row: lane
// c < hd / 8 adds columns 8c..8c+7 in order from one 16-byte load of each
// (the views are TMA's: 16-byte aligned rows), then a fixed shuffle tree.
__global__ void __launch_bounds__(kDeltaThreads)
flash_wgmma_bwd_delta_kernel(View ov, View dov, float* __restrict__ delta, int64_t rows, int Tq,
                             int H, int hd) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kDeltaThreads / 32);
  for (int64_t r = (static_cast<int64_t>(blockIdx.x) * kDeltaThreads + threadIdx.x) >> 5;
       r < rows; r += warps) {
    const int64_t bh = r / Tq;
    const int64_t i = r - bh * Tq;
    const int64_t b = bh / H, h = bh - b * H;
    float acc = 0.f;
    if (lane < hd / 8) {
      const uint4 ov8 = *reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(ov.p) + b * ov.sb + h * ov.sh + i * ov.st + 8 * lane);
      const uint4 dv8 = *reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(dov.p) + b * dov.sb + h * dov.sh + i * dov.st + 8 * lane);
      const bf16* o = reinterpret_cast<const bf16*>(&ov8);
      const bf16* g = reinterpret_cast<const bf16*>(&dv8);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc = fmaf(__bfloat162float(g[c]), __bfloat162float(o[c]), acc);
    }
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) delta[r] = acc;
  }
}

// The swizzled byte offset of (row, column c) in a tile of `rows` rows.
template <int HD>
__device__ __forceinline__ uint32_t tile_offset(int rows, int row, int c) {
  using A = Atom<HD>;
  uint32_t off = (c / A::kAtom) * rows * A::kRowBytes + row * A::kRowBytes + (c % A::kAtom) * 2;
  return off ^ (((off >> 7) & (A::kRowBytes / 16 - 1)) << 4);  // the TMA swizzle
}

// acc times `mul` in bf16 into rows row0.. of a 128-row tile at `tile`
// (this thread's accumulator entries), then, after the warpgroup's
// barrier, its first thread TMA-stores the 64 rows at (head, t0, b).
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], float mul, uint8_t* tile,
                                           uint32_t tile_u32, int wg, int row_lo, int col,
                                           const CUtensorMap* map, int head, int t0, int b) {
  using A = Atom<HD>;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = wg * 64 + row_lo + 8 * ((i >> 1) & 1);
    *reinterpret_cast<uint32_t*>(tile + tile_offset<HD>(kRows, row, 8 * (i >> 2) + col)) =
        pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (threadIdx.x == wg * 128) {
    for (int cb = 0; cb < A::kBlocks; ++cb)
      tma_store(map, tile_u32 + cb * kRows * A::kRowBytes + wg * 64 * A::kRowBytes,
                cb * A::kAtom, head, t0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// A 128-row tile's column blocks from rows t0.. of (head, b), as two
// 64-row boxes a block.
template <int HD>
__device__ __forceinline__ void load_big(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int t0, int b) {
  using A = Atom<HD>;
  for (int cb = 0; cb < A::kBlocks; ++cb)
    for (int half = 0; half < 2; ++half)
      tma_load(dst + cb * kRows * A::kRowBytes + half * kStep * A::kRowBytes, map, bar,
               cb * A::kAtom, head, t0 + half * kStep, b);
}

// An N-row tile's column blocks from rows t0.. of (head, b); the map's
// boxes are N rows.
template <int HD, int N>
__device__ __forceinline__ void load_small(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int head, int t0, int b) {
  using A = Atom<HD>;
  for (int cb = 0; cb < A::kBlocks; ++cb)
    tma_load(dst + cb * N * A::kRowBytes, map, bar, cb * A::kAtom, head, t0, b);
}

// D (64 x N) = A B^T over hd: A the warpgroup's 64 rows of a 128-row tile
// at `a`, B an N-row tile at `b`, both K-major; issued, not waited for.
template <int HD, int N>
__device__ __forceinline__ void scores(float (&d)[N / 2], uint32_t a, uint32_t b) {
  using A = Atom<HD>;
  constexpr uint32_t kSbo = 8 * A::kRowBytes;  // between 8-row groups
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int cb = kk * 16 / A::kAtom, within = kk * 16 % A::kAtom;
    mma_ss<N>(d, make_desc(a + cb * kRows * A::kRowBytes + within * 2, 16, kSbo, A::kLayout),
              make_desc(b + cb * N * A::kRowBytes + within * 2, 16, kSbo, A::kLayout), kk > 0);
  }
}

// acc (64 x HD) += A B: A the bf16 fragments of a 64 x N product (k-step
// kb's in a[kb]), B an N-row tile at `b`, MN-major; issued, not waited for.
template <int HD, int N>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 2], uint32_t (&a)[N / 16][4],
                                           uint32_t b) {
  using A = Atom<HD>;
#pragma unroll
  for (int kb = 0; kb < N / 16; ++kb)
    mma_rs<HD>(acc, a[kb],
               make_desc(b + kb * 16 * A::kRowBytes, N * A::kRowBytes, 8 * A::kRowBytes,
                         A::kLayout));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap dqmap,
                          const float* __restrict__ lse, const float* __restrict__ delta, int Tq,
                          int Tk, int H, int KV, int causal, float scale_log2, float scale) {
  using S = DqShape<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t qdo_full = base + S::kBar;
  auto full = [&](int s) { return base + S::kBar + 8u * (1 + s); };
  auto empty = [&](int s) { return base + S::kBar + 8u * (1 + kStages + s); };

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // the longest causal tiles first
  const int k_tiles = (Tk + kStep - 1) / kStep;
  const int q_last = min(q0 + kRows, Tq) - 1;
  const int n_tiles = causal ? min(k_tiles, q_last / kStep + 1) : k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qdo_full, 2 * S::kBig);
      load_big<HD>(base + S::kQ, &qmap, qdo_full, h, q0, b);
      load_big<HD>(base + S::kDO, &domap, qdo_full, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full(s), 2 * S::kSmall);
        load_small<HD, kStep>(base + S::kK + s * S::kSmall, &kmap, full(s), kh, t * kStep, b);
        load_small<HD, kStep>(base + S::kV + s * S::kSmall, &vmap, full(s), kh, t * kStep, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int row_lo = warp * 16 + (lane >> 2);  // this thread's rows: row_lo, row_lo + 8
    const int col = 2 * (lane & 3);             // and columns col, col + 1 of each 8
    const int w0 = q0 + wg * 64;                 // the warpgroup's first row
    const int q_row = w0 + row_lo;
    const uint32_t q_rows = base + S::kQ + wg * 64 * S::kRowBytes;
    const uint32_t do_rows = base + S::kDO + wg * 64 * S::kRowBytes;

    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // the rows' lse in log2 units, delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q_row + 8 * r;
      if (i < Tq) {
        const int64_t at = (static_cast<int64_t>(b) * H + h) * Tq + i;
        lse2[r] = lse[at] * kLog2e;
        dl[r] = delta[at];
      }
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(qdo_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = t * kStep;
      mbar_wait(full(s), (t / kStages) & 1);
      if (causal && k0 > w0 + 63) {  // wholly above this warpgroup's diagonal
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t k_tile = base + S::kK + s * S::kSmall;
      const uint32_t v_tile = base + S::kV + s * S::kSmall;

      // S = Q K^T and dP = dO V^T, one commit group
      float sc[kStep / 2], dp[kStep / 2];
#pragma unroll
      for (int i = 0; i < kStep / 2; ++i) sc[i] = dp[i] = 0.f;  // overwritten: scale_d = 0 first
      wgmma_fence();
      scores<HD, kStep>(sc, q_rows, k_tile);
      scores<HD, kStep>(dp, do_rows, v_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P and dS in the accumulator layout: register i holds row
      // row_lo + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + col + (i & 1)
      const bool edge = k0 + kStep > Tk || (causal && k0 + kStep - 1 > w0);
      uint32_t ds[kStep / 16][4];
#pragma unroll
      for (int i = 0; i < kStep / 2; i += 2) {
        const int r = (i >> 1) & 1;
        float g[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(fmaf(sc[i + e], scale_log2, -lse2[r]));
          if (edge) {
            const int kpos = k0 + 8 * (i >> 2) + col + e;
            if (kpos >= Tk || (causal && kpos > q_row + 8 * r)) p = 0.f;
          }
          g[e] = p * (dp[i + e] - dl[r]);
        }
        ds[i >> 3][(i >> 1) & 3] = pack_bf16(g[0], g[1]);
      }

      // dQ += dS K
      fence_regs(acc);
      wgmma_fence();
      accumulate<HD, kStep>(acc, ds, k_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }
    store_rows<HD>(acc, scale, smem + S::kQ, base + S::kQ, wg, row_lo, col, &dqmap, h, w0, b);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap,
                            const __grid_constant__ CUtensorMap dkmap,
                            const __grid_constant__ CUtensorMap dvmap,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            int Tq, int Tk, int H, int KV, int causal, float scale_log2,
                            float scale) {
  using S = DkdvShape<HD>;
  constexpr int kQRows = S::kQRows, kQStages = S::kQStages;  // queries a tile, the ring
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base + S::kBar;
  auto full = [&](int s) { return base + S::kBar + 8u * (1 + s); };
  auto empty = [&](int s) { return base + S::kBar + 8u * (1 + kQStages + s); };

  const int b = blockIdx.x / KV;
  const int kh = blockIdx.x - b * KV;
  const int group = H / KV;
  const int k0 = blockIdx.y * kRows;  // the first key tiles meet the most (causal) queries
  const int q_tiles = (Tq + kQRows - 1) / kQRows;
  const int qt_begin = causal ? k0 / kQRows : 0;  // the first tile holding a query i >= k0
  const int per_head = max(q_tiles - qt_begin, 0);
  const int n_tiles = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the copy's thread and the lse / delta warp
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy, one warp the rows' lse
    // and delta --------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(kv_full, 2 * S::kBig);
      load_big<HD>(base + S::kK, &kmap, kv_full, kh, k0, b);
      load_big<HD>(base + S::kV, &vmap, kv_full, kh, k0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kQStages;
        const int hq = kh * group + t / per_head;
        const int q0 = (qt_begin + t % per_head) * kQRows;
        mbar_wait(empty(s), ((t / kQStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * S::kQTile);
        load_small<HD, kQRows>(base + S::kQ + s * S::kQTile, &qmap, full(s), hq, q0, b);
        load_small<HD, kQRows>(base + S::kDO + s * S::kQTile, &domap, full(s), hq, q0, b);
      }
    } else if (threadIdx.x >= 288 && threadIdx.x < 320) {
      const int lane = threadIdx.x - 288;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kQStages;
        const int hq = kh * group + t / per_head;
        const int q0 = (qt_begin + t % per_head) * kQRows;
        float* ls = reinterpret_cast<float*>(smem + S::kLse) + s * kQRows;
        float* dd = reinterpret_cast<float*>(smem + S::kDelta) + s * kQRows;
        mbar_wait(empty(s), ((t / kQStages) & 1) ^ 1);
#pragma unroll
        for (int e = 0; e < kQRows / 32; ++e) {
          const int i = q0 + lane + 32 * e;
          float l = 0.f, d = 0.f;
          if (i < Tq) {
            const int64_t at = (static_cast<int64_t>(b) * H + hq) * Tq + i;
            l = lse[at] * kLog2e;
            d = delta[at];
          }
          ls[lane + 32 * e] = l;
          dd[lane + 32 * e] = d;
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int row_lo = warp * 16 + (lane >> 2);  // this thread's keys: row_lo, row_lo + 8
    const int col = 2 * (lane & 3);             // and queries col, col + 1 of each 8
    const int w0 = k0 + wg * 64;                 // the warpgroup's first key
    const int key = w0 + row_lo;
    const uint32_t k_rows = base + S::kK + wg * 64 * S::kRowBytes;
    const uint32_t v_rows = base + S::kV + wg * 64 * S::kRowBytes;

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_tiles > 0) mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kQStages;
      const int q0 = (qt_begin + t % per_head) * kQRows;
      mbar_wait(full(s), (t / kQStages) & 1);
      if (causal && q0 + kQRows - 1 < w0) {  // every query before this warpgroup's keys
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t q_tile = base + S::kQ + s * S::kQTile;
      const uint32_t do_tile = base + S::kDO + s * S::kQTile;
      const float* ls = reinterpret_cast<const float*>(smem + S::kLse) + s * kQRows;
      const float* dd = reinterpret_cast<const float*>(smem + S::kDelta) + s * kQRows;

      // S^T = K Q^T and dP^T = V dO^T, one commit group
      float st[kQRows / 2], dpt[kQRows / 2];
#pragma unroll
      for (int i = 0; i < kQRows / 2; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
      scores<HD, kQRows>(st, k_rows, q_tile);
      scores<HD, kQRows>(dpt, v_rows, do_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T in the accumulator layout: register i holds key
      // key + 8 ((i >> 1) & 1), query q0 + 8 (i >> 2) + col + (i & 1)
      const bool edge = q0 + kQRows > Tq || (causal && q0 < w0 + 63);
      uint32_t pt[kQRows / 16][4], dst[kQRows / 16][4];
#pragma unroll
      for (int i = 0; i < kQRows / 2; i += 2) {
        const int r = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + col;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dd + c);
        const float lq[2] = {l2.x, l2.y}, dq[2] = {d2.x, d2.y};
        float p[2], g[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = exp2f(fmaf(st[i + e], scale_log2, -lq[e]));
          if (edge) {
            const int qpos = q0 + c + e;
            if (qpos >= Tq || (causal && key + 8 * r > qpos)) p[e] = 0.f;
          }
          g[e] = p[e] * (dpt[i + e] - dq[e]);
        }
        pt[i >> 3][(i >> 1) & 3] = pack_bf16(p[0], p[1]);
        dst[i >> 3][(i >> 1) & 3] = pack_bf16(g[0], g[1]);
      }

      // dV += P^T dO and dK += dS^T Q
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      accumulate<HD, kQRows>(dv, pt, do_tile);
      accumulate<HD, kQRows>(dk, dst, q_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty(s));
    }
    store_rows<HD>(dk, scale, smem + S::kK, base + S::kK, wg, row_lo, col, &dkmap, kh, w0, b);
    store_rows<HD>(dv, 1.f, smem + S::kV, base + S::kV, wg, row_lo, col, &dvmap, kh, w0, b);
  }
}

template <int HD>
int launch(View q, View k, View v, View o, View dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int64_t B, int64_t Tq, int64_t Tk, int64_t H, int64_t KV,
           int causal, float scale, void* stream_ptr) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || B * H > INT_MAX ||
      Tq > INT_MAX - kRows || Tk > INT_MAX - kRows || (Tq + kRows - 1) / kRows > 65535 ||
      (Tk + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // q and do twice: 64-row boxes for the dq kernel, the query step's for dk/dv
  constexpr int kQRows = QStep<HD>::kRows;
  CUtensorMap qm, km, vm, dom, dqm, dkm, dvm, qsm, dosm;
  if (!make_map<HD>(encode, &qm, q.p, H, Tq, B, q.sh, q.st, q.sb, kStep) ||
      !make_map<HD>(encode, &qsm, q.p, H, Tq, B, q.sh, q.st, q.sb, kQRows) ||
      !make_map<HD>(encode, &dosm, dout.p, H, Tq, B, dout.sh, dout.st, dout.sb, kQRows) ||
      !make_map<HD>(encode, &km, k.p, KV, Tk, B, k.sh, k.st, k.sb, kStep) ||
      !make_map<HD>(encode, &vm, v.p, KV, Tk, B, v.sh, v.st, v.sb, kStep) ||
      !make_map<HD>(encode, &dom, dout.p, H, Tq, B, dout.sh, dout.st, dout.sb, kStep) ||
      !make_map<HD>(encode, &dqm, dq, H, Tq, B, HD, H * HD, Tq * H * HD, kStep) ||
      !make_map<HD>(encode, &dkm, dk, KV, Tk, B, HD, KV * HD, Tk * KV * HD, kStep) ||
      !make_map<HD>(encode, &dvm, dv, KV, Tk, B, HD, KV * HD, Tk * KV * HD, kStep))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  const int64_t rows = B * H * Tq;
  const int64_t blocks = (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
  flash_wgmma_bwd_delta_kernel<<<static_cast<unsigned>(blocks < 65535 * 8 ? blocks : 65535 * 8),
                                 kDeltaThreads, 0, stream>>>(
      o, dout, delta, rows, static_cast<int>(Tq), static_cast<int>(H), HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale_log2 = scale * kLog2e;
  const int tq = static_cast<int>(Tq), tk = static_cast<int>(Tk);
  const int h = static_cast<int>(H), kvh = static_cast<int>(KV);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(flash_wgmma_bwd_dq_kernel<HD>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DqShape<HD>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dq_grid(static_cast<unsigned>(B * H), static_cast<unsigned>((Tq + kRows - 1) / kRows));
  flash_wgmma_bwd_dq_kernel<HD><<<dq_grid, kThreads, DqShape<HD>::kSmem, stream>>>(
      qm, km, vm, dom, dqm, lse, delta, tq, tk, h, kvh, causal, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(flash_wgmma_bwd_dkdv_kernel<HD>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DkdvShape<HD>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(static_cast<unsigned>(B * KV),
                     static_cast<unsigned>((Tk + kRows - 1) / kRows));
  flash_wgmma_bwd_dkdv_kernel<HD><<<kv_grid, kThreads, DkdvShape<HD>::kSmem, stream>>>(
      qsm, km, vm, dosm, dkm, dvm, lse, delta, tq, tk, h, kvh, causal, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, do (B, Tq, H, hd) and k, v (B, Tk, KV, hd) are bf16 strided views
// that a TMA map describes (element strides sb, st, sh, each a multiple of
// 8, of size-1 dims too; unit stride along hd; 16-byte aligned bases); lse
// is the forward's contiguous f32 (B, H, Tq) row logsumexp; delta is a
// contiguous f32 (B, H, Tq) scratch the call overwrites; dq (B, Tq, H, hd)
// and dk, dv (B, Tk, KV, hd) are contiguous bf16 outputs, every element of
// which is written. hd in {64, 80, 128, 160}, H % KV == 0. Launches three
// kernels on `stream` and returns the first CUDA error (0 on success). The
// caller checks shapes, types, devices and alignment.
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, int64_t qsb, int64_t qst, int64_t qsh, const void* k, int64_t ksb,
    int64_t kst, int64_t ksh, const void* v, int64_t vsb, int64_t vst, int64_t vsh,
    const void* o, int64_t osb, int64_t ost, int64_t osh, const void* dout, int64_t dsb,
    int64_t dst, int64_t dsh, const void* lse, void* delta, void* dq, void* dk, void* dv,
    int64_t B, int64_t Tq, int64_t Tk, int64_t H, int64_t KV, int64_t hd, int causal,
    float scale, void* stream) {
#define REPRO_FLASH_BWD_HD(N)                                                                  \
  case N:                                                                                      \
    return launch<N>(View{q, qsb, qst, qsh}, View{k, ksb, kst, ksh}, View{v, vsb, vst, vsh},   \
                     View{o, osb, ost, osh}, View{dout, dsb, dst, dsh},                        \
                     static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,   \
                     B, Tq, Tk, H, KV, causal, scale, stream);
  switch (hd) {
    REPRO_FLASH_BWD_HD(64)
    REPRO_FLASH_BWD_HD(80)
    REPRO_FLASH_BWD_HD(128)
    REPRO_FLASH_BWD_HD(160)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_BWD_HD
}
