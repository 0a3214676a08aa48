// Causal (or full) softmax attention forward for Hopper (sm_90a), bf16, on
// the tensor cores through wgmma, fed by TMA: the main-path kernel of
// kernels/flash_attention.py. It computes what flash_attention.cu's general
// kernel (flash_fwd_kernel) computes:
//   O[b,i,h,:] = sum_j w_ij v_j,  w_i = softmax_j(m(i,j) ? scale q_i . k_j : -1e30)
// with scale = 1/sqrt(hd) and m(i,j) = [j < Tk] (and [j <= i] when causal,
// positions counted from 0 on both sides even when Tq != Tk); q is
// (B, Tq, H, hd), k and v are (B, Tk, KV, hd), query head h reading kv head
// h / (H / KV) in place; the output is contiguous (B, Tq, H, hd) bf16.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:70), and keeps its arithmetic: a
// running max m (from -1e30), denominator d and f32 accumulator over key
// tiles in ascending order; masked scores -1e30, not -inf; p = exp(s - m)
// rounded to bf16 before it multiplies v while d sums the unrounded p; the
// output acc / max(d, 1e-30) in bf16. Scores are scaled by scale * log2(e)
// and exponentiated with exp2f (the same function, one rounding apart).
// Tiles above the diagonal are skipped: exact, since a wholly masked tile
// adds exp(-1e30 - m) = 0 with alpha = 1, and tile 0, which holds key 0
// visible to every query, is always the first. No split over keys, no
// atomics: each row's sums are taken in one fixed order, so two runs give
// the same bits.
//
// Bound: operations. At the serving shape (stablelm-12b prefill: B 8,
// T 2048, H 32, KV 8, hd 160, causal) one call does 343.8 GFLOP of bf16
// products, 0.35 ms at the 989 TFLOP/s dense tensor-core peak, while its
// 420 MB of q, k, v and output take 0.13 ms at 3.35 TB/s. Only wgmma reaches
// that rate, so the design keeps the tensor cores fed and everything else
// out of their way:
//   - One block per (b, h, 128-row query tile), longest causal tiles first:
//     three warpgroups. Warpgroup 2 is the producer: one thread issues
//     every copy and the warpgroup gives its registers away (setmaxnreg 40);
//     warpgroups 0 and 1 consume (setmaxnreg 232), 64 query rows each.
//   - TMA loads the Q tile once, and K and V tiles into a ring of 2 stages,
//     each stage guarded by a full barrier per tensor (the copy's bytes)
//     and one empty barrier (every consumer thread arrives when its
//     products are done with the stage). Tensor maps are 4-D over the
//     strided (B, T, heads, hd) views, built on the host with
//     cuTensorMapEncodeTiled (looked up with the runtime's entry-point
//     query, so the library links nothing but the CUDA runtime) and passed as
//     __grid_constant__ parameters. Rows past T come back as zeros and
//     are masked anyway.
//   - S = Q K^T: wgmma m64nNk16 (N = keys per tile), both operands K-major
//     from shared memory, S in registers in the accumulator layout.
//   - The softmax runs on S in that layout: a thread holds 2 rows, the 4
//     threads of a quad share a row, so the row max takes two shuffles;
//     the denominator is kept per thread and summed over the quad at the
//     end. P goes to bf16 in registers and is the A operand of the next
//     wgmma (the accumulator layout of columns 16k..16k+15 is the A
//     fragment of k-step k).
//   - O += P V: wgmma with A from registers and V an MN-major B operand
//     from shared memory (hd contiguous; the descriptor's transpose bit).
//     O stays in registers over the whole key loop; the epilogue divides by
//     max(d, 1e-30), writes bf16 into the warpgroup's own rows of the Q
//     tile (no longer read) in the swizzled layout, and TMA stores them.
//   - hd 160 and 80 are no multiple of 64, the width of a 128-byte swizzle
//     atom. Each tile is stored as hd / W column blocks of W elements, with
//     W the largest of 64, 32, 16 dividing hd and the matching 128-, 64- or
//     32-byte swizzle (hd 160: five 32-wide blocks in the 64-byte swizzle),
//     so no product is padded. The descriptors' byte offsets follow W.
//   - Keys per tile: 128 for hd <= 160 (Q 40 KB + 2 stages of K and V,
//     160 KB, at hd 160), 64 above (registers: a 64 x 256 f32 O is 128 a
//     thread).
// Head dims 64, 80, 128, 160, 192 and 256; anything else, f32, and views
// TMA cannot describe go to flash_fwd_kernel (the wrapper's choice).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;    // query rows per block: two consumer warpgroups of 64
constexpr int kStages = 2;    // the K / V ring
constexpr int kThreads = 384; // warpgroups 0 and 1 consume, 2 produces
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Tile shapes and the shared-memory layout for one head dim. Every tile is
// hd / kAtom column blocks, each rows x kAtom bf16 in the TMA swizzle of
// kAtom * 2 bytes; offsets are from a 1024-byte aligned base.
template <int HD>
struct Shape {
  static_assert(HD % 16 == 0 && HD <= 256, "head dim");
  static constexpr int kKeys = HD <= 160 ? 128 : 64;  // keys per tile
  static constexpr int kAtom = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int kBlocks = HD / kAtom;
  static constexpr int kRowBytes = kAtom * 2;  // one row of a column block
  static constexpr uint64_t kLayout = kAtom == 64 ? 1 : kAtom == 32 ? 2 : 3;  // B128/B64/B32
  static constexpr uint32_t kQBytes = kRows * HD * 2;
  static constexpr uint32_t kTileBytes = kKeys * HD * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  static constexpr uint32_t kBars = 1 + 3 * kStages;  // q full; k, v full; empty
  static constexpr uint32_t kSmem = kBar + 8 * kBars + 1024;  // + alignment room
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map, coordinates innermost first, into shared
// memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of a wgmma accumulator across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x N, f32) = A B (+ D when scale_d): A 64 x 16 and B N x 16, both
// K-major from shared memory.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

// D (64 x N, f32) += A B: A 64 x 16 bf16 from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B 16 x N MN-major from shared memory.
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

// The wgmma shapes this kernel issues, one instruction each (outputs
// listed register by register, as inline PTX needs them).

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<160>(float (&d)[80], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, int Tq, int Tk, int H, int KV,
                   int causal, float scale_log2) {
  using S = Shape<HD>;
  constexpr int kKeys = S::kKeys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + S::kBar;
  auto k_full = [&](int s) { return base + S::kBar + 8u * (1 + s); };
  auto v_full = [&](int s) { return base + S::kBar + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return base + S::kBar + 8u * (1 + 2 * kStages + s); };

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // the longest causal tiles first
  const int k_tiles = (Tk + kKeys - 1) / kKeys;
  const int q_last = min(q0 + kRows, Tq) - 1;
  const int n_tiles = causal ? min(k_tiles, q_last / kKeys + 1) : k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
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
      mbar_expect_tx(q_full, S::kQBytes);
      for (int cb = 0; cb < S::kBlocks; ++cb)
        tma_load(base + S::kQ + cb * kRows * S::kRowBytes, &qmap, q_full, cb * S::kAtom, h,
                 q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);  // the first round passes
        const uint32_t k_tile = base + S::kK + s * S::kTileBytes;
        const uint32_t v_tile = base + S::kV + s * S::kTileBytes;
        mbar_expect_tx(k_full(s), S::kTileBytes);
        for (int cb = 0; cb < S::kBlocks; ++cb)
          tma_load(k_tile + cb * kKeys * S::kRowBytes, &kmap, k_full(s), cb * S::kAtom, kh,
                   t * kKeys, b);
        mbar_expect_tx(v_full(s), S::kTileBytes);
        for (int cb = 0; cb < S::kBlocks; ++cb)
          tma_load(v_tile + cb * kKeys * S::kRowBytes, &vmap, v_full(s), cb * S::kAtom, kh,
                   t * kKeys, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int row_lo = warp * 16 + (lane >> 2);  // this thread's rows: row_lo, row_lo + 8
    const int col = 2 * (lane & 3);             // and columns col, col + 1 of each 8
    const int q_row = q0 + wg * 64 + row_lo;
    const uint32_t q_tile = base + S::kQ + wg * 64 * S::kRowBytes;
    constexpr uint32_t kSbo = 8 * S::kRowBytes;  // between 8-row groups

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf}, d_run[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int k0 = t * kKeys;
      const uint32_t k_tile = base + S::kK + s * S::kTileBytes;
      const uint32_t v_tile = base + S::kV + s * S::kTileBytes;

      // S = Q K^T: hd / 16 k-steps, each within one column block
      float sc[kKeys / 2];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;  // overwritten: scale_d = 0 first
      mbar_wait(k_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int cb = kk * 16 / S::kAtom, within = kk * 16 % S::kAtom;
        const uint64_t da = make_desc(q_tile + cb * kRows * S::kRowBytes + within * 2, 16,
                                      kSbo, S::kLayout);
        const uint64_t db = make_desc(k_tile + cb * kKeys * S::kRowBytes + within * 2, 16,
                                      kSbo, S::kLayout);
        mma_ss<kKeys>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the running softmax on S in its accumulator layout: register i holds
      // row row_lo + 8 ((i >> 1) & 1), column 8 (i >> 2) + col + (i & 1)
      const bool edge = k0 + kKeys > Tk || (causal && k0 + kKeys - 1 > q0 + wg * 64);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        float x = sc[i] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * (i >> 2) + col + (i & 1);
          if (kpos >= Tk || (causal && kpos > q_row + 8 * r)) x = kNegInf;
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m_run[r] - mx[r]);
        m_run[r] = mx[r];
      }
      uint32_t p[kKeys / 16][4];
#pragma unroll
      for (int i = 0; i < kKeys / 2; i += 2) {
        const int r = (i >> 1) & 1;
        const float e0 = exp2f(sc[i] - m_run[r]);
        const float e1 = exp2f(sc[i + 1] - m_run[r]);
        sum[r] += e0 + e1;
        p[i >> 3][(i >> 1) & 3] = pack_bf16(e0, e1);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) d_run[r] = d_run[r] * alpha[r] + sum[r];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V: kKeys / 16 k-steps of 16 keys, V MN-major
      mbar_wait(v_full(s), ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kKeys / 16; ++kb) {
        const uint64_t dv = make_desc(v_tile + kb * 16 * S::kRowBytes,
                                      kKeys * S::kRowBytes, kSbo, S::kLayout);
        mma_rs<HD>(o, p[kb], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(empty(s));
    }

    // epilogue: O / max(d, 1e-30) in bf16 into this warpgroup's rows of the
    // Q tile, in the swizzled column-block layout, then TMA stores
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 1);
      d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 2);
      d_run[r] = fmaxf(d_run[r], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + col;
      uint32_t off = (c / S::kAtom) * kRows * S::kRowBytes +
                     (wg * 64 + row_lo + 8 * r) * S::kRowBytes + (c % S::kAtom) * 2;
      off ^= ((off >> 7) & (S::kRowBytes / 16 - 1)) << 4;  // the TMA swizzle
      *reinterpret_cast<uint32_t*>(smem + S::kQ + off) =
          pack_bf16(o[i] / d_run[r], o[i + 1] / d_run[r]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0) {
      for (int cb = 0; cb < S::kBlocks; ++cb)
        tma_store(&omap, q_tile + cb * kRows * S::kRowBytes, cb * S::kAtom, h, q0 + wg * 64,
                  b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, through the runtime's entry-point
// query (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (hd, heads, T, B) over a bf16 view with element strides sh,
// st, sb, boxes of kAtom x 1 x rows x 1 in the kAtom swizzle.
template <int HD>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* p, int64_t heads, int64_t T,
              int64_t B, int64_t sh, int64_t st, int64_t sb, int rows) {
  using S = Shape<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(S::kAtom), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = S::kAtom == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : S::kAtom == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, int64_t qsb, int64_t qst, int64_t qsh, const void* k, int64_t ksb,
           int64_t kst, int64_t ksh, const void* v, int64_t vsb, int64_t vst, int64_t vsh,
           void* out, int64_t B, int64_t Tq, int64_t Tk, int64_t H, int64_t KV, int causal,
           float scale, void* stream) {
  using S = Shape<HD>;
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || B * H > INT_MAX ||
      Tq > INT_MAX - kRows || Tk > INT_MAX - kRows || (Tq + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm, om;
  if (!make_map<HD>(encode, &qm, q, H, Tq, B, qsh, qst, qsb, kRows) ||
      !make_map<HD>(encode, &km, k, KV, Tk, B, ksh, kst, ksb, S::kKeys) ||
      !make_map<HD>(encode, &vm, v, KV, Tk, B, vsh, vst, vsb, S::kKeys) ||
      !make_map<HD>(encode, &om, out, H, Tq, B, HD, H * HD, Tq * H * HD, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(flash_wgmma_kernel<HD>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((Tq + kRows - 1) / kRows));
  flash_wgmma_kernel<HD><<<grid, kThreads, S::kSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, om, static_cast<int>(Tq), static_cast<int>(Tk), static_cast<int>(H),
      static_cast<int>(KV), causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Tq, H, hd), k and v (B, Tk, KV, hd) are bf16 strided views (element
// strides sb, st, sh, each a multiple of 8, of size-1 dims too; unit stride
// along hd; 16-byte aligned bases); out is a contiguous (B, Tq, H, hd) bf16
// output, every element of which is written. hd in {64, 80, 128, 160, 192,
// 256}, H % KV == 0. Launches on `stream` and returns cudaGetLastError() (0
// on success). The caller checks shapes, types, devices and alignment.
extern "C" int repro_flash_attention_fwd_wgmma(
    const void* q, int64_t qsb, int64_t qst, int64_t qsh, const void* k, int64_t ksb,
    int64_t kst, int64_t ksh, const void* v, int64_t vsb, int64_t vst, int64_t vsh, void* out,
    int64_t B, int64_t Tq, int64_t Tk, int64_t H, int64_t KV, int64_t hd, int causal,
    float scale, void* stream) {
#define REPRO_FLASH_HD(N)                                                                     \
  case N:                                                                                     \
    return launch<N>(q, qsb, qst, qsh, k, ksb, kst, ksh, v, vsb, vst, vsh, out, B, Tq, Tk, H, \
                     KV, causal, scale, stream);
  switch (hd) {
    REPRO_FLASH_HD(64)
    REPRO_FLASH_HD(80)
    REPRO_FLASH_HD(128)
    REPRO_FLASH_HD(160)
    REPRO_FLASH_HD(192)
    REPRO_FLASH_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_HD
}
