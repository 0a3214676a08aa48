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
// is a test per slot, so the write-back costs one launch and no sync.
//
// The targets must be distinct (a buffer's keys are unique), so no two
// warps write one row and the result is the same on every run.
//
// Bound: memory bandwidth. No arithmetic; per valid slot it reads one
// buffer row and accumulator and writes one table row and accumulator;
// every index is read once. At the write-backs of the main paths most
// slots are padding (about 38k of 319,488 valid at dlrm-ctr, 71k of
// 393,216 at HSTU), so the design spends nothing on an empty slot beyond
// its index: each warp takes 32 consecutive slots, reads their indices
// with one coalesced load and keeps the valid ones with a ballot; the lane
// that owns a slot writes its accumulator (read coalesced). The warp then
// walks the set bits in groups of up to four rows, issuing each group's
// loads before its stores (lanes stride over D in float4 when D % 4 == 0
// and both row pointers are 16-byte aligned, else in floats). Row offsets
// are 64-bit (the dlrm-ctr master holds 7.3e9 elements).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowsInFlight = 4;  // rows whose loads a lane issues before its stores

// T is float4 (D % 4 == 0, aligned rows) or float; `width` is D in units of T.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scatter_rows_kernel(float* __restrict__ table, float* __restrict__ table_accum,
                    int64_t table_rows, int64_t width,
                    const int32_t* __restrict__ idx,
                    const float* __restrict__ rows,
                    const float* __restrict__ accum, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * 32;
  if (base >= n) return;  // the whole warp
  const int64_t i = base + lane;
  const int32_t r = i < n ? idx[i] : -1;
  const bool valid = r >= 0 && r < table_rows;
  if (valid) table_accum[r] = __ldg(accum + i);
  unsigned todo = __ballot_sync(0xffffffffu, valid);
  T* dst = reinterpret_cast<T*>(table);
  const T* src = reinterpret_cast<const T*>(rows);
  while (todo) {
    int64_t from[kRowsInFlight] = {}, to[kRowsInFlight] = {};
    int m = 0;
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      if (todo) {
        const int s = __ffs(todo) - 1;
        todo &= todo - 1;
        from[j] = (base + s) * width;
        to[j] = static_cast<int64_t>(__shfl_sync(0xffffffffu, r, s)) * width;
        m = j + 1;
      }
    }
    for (int64_t c = lane; c < width; c += 32) {
      T x[kRowsInFlight];
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        if (j < m) x[j] = __ldg(src + from[j] + c);
      }
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        if (j < m) dst[to[j] + c] = x[j];
      }
    }
  }
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
  const int64_t per_block = 32 * kWarpsPerBlock;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (dim % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(table) |
                     reinterpret_cast<uintptr_t>(rows)) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    scatter_rows_kernel<float4><<<grid, block, 0, st>>>(
        table, table_accum, table_rows, dim / 4, idx, rows, accum, n);
  } else {
    scatter_rows_kernel<float><<<grid, block, 0, st>>>(
        table, table_accum, table_rows, dim, idx, rows, accum, n);
  }
  return static_cast<int>(cudaGetLastError());
}
