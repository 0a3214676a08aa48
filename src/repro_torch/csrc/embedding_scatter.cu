// Embedding row scatter for Hopper (sm_90a), in place, the DBP commit:
//   table[idx[i]] = rows[i];  table_accum[idx[i]] = accum[i]
// for every i with 0 <= idx[i] < table_rows; every other slot (the
// buffer's SENTINEL padding) is dropped and writes nothing.
//
// Replaces no Pallas kernel: it is the port of the XLA scatter
// `rows.at[local_idx].set(br, mode="drop")` (and the same for the adagrad
// state) in EmbeddingEngine.writeback (src/repro/core/embedding/engine.py).
// JAX updates the donated master in place; PyTorch has no scatter that
// drops out-of-range targets, and masking them first needs the number of
// valid slots on the host, which is a device sync per step. Here the drop
// is a test per warp, so the write-back costs one launch and no sync.
//
// The targets must be distinct (a buffer's keys are unique), so no two
// warps write one row and the result is the same on every run.
//
// Bound: memory bandwidth. No arithmetic; per valid slot it reads one
// buffer row and accumulator and writes one table row and accumulator;
// every index is read once. Design for that: one warp per slot, lanes
// striding over D with float4 when D % 4 == 0 and both row pointers are
// 16-byte aligned, 64-bit row offsets (the dlrm-ctr master holds 7.3e9
// elements).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scatter_rows_kernel(float* __restrict__ table, float* __restrict__ table_accum,
                    int64_t table_rows, int64_t dim,
                    const int32_t* __restrict__ idx,
                    const float* __restrict__ rows,
                    const float* __restrict__ accum, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int64_t r = idx[i];
  if (r < 0 || r >= table_rows) return;
  float* dst = table + r * dim;
  const float* from = rows + i * dim;
  if (kVec) {
    const int64_t d4 = dim >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(from);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int64_t c = lane; c < d4; c += 32) dst4[c] = __ldg(src4 + c);
  } else {
    for (int64_t c = lane; c < dim; c += 32) dst[c] = __ldg(from + c);
  }
  if (lane == 0) table_accum[r] = __ldg(accum + i);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks shapes, types and devices; targets must be distinct.
extern "C" int repro_embedding_scatter_f32(float* table, float* table_accum,
                                           int64_t table_rows, int64_t dim,
                                           const int32_t* idx, const float* rows,
                                           const float* accum, int64_t n,
                                           void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (dim % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(table) |
                     reinterpret_cast<uintptr_t>(rows)) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    scatter_rows_kernel<true><<<grid, block, 0, st>>>(
        table, table_accum, table_rows, dim, idx, rows, accum, n);
  } else {
    scatter_rows_kernel<false><<<grid, block, 0, st>>>(
        table, table_accum, table_rows, dim, idx, rows, accum, n);
  }
  return static_cast<int>(cudaGetLastError());
}
