// Embedding row gather for Hopper (sm_90a): out[i] = table[idx[i]], and a
// zero row where idx[i] < 0 or idx[i] >= rows.
//
// Replaces the Pallas TPU kernel `embedding_gather`
// (src/repro/kernels/embedding_gather.py) together with the clamp-and-mask
// wrapper around it (`gather_rows` in src/repro/kernels/dispatch.py): the
// gather and the sentinel mask are one pass, so no clamped copy and no
// second masking pass over the output ever touch device memory.
//
// Bound: memory bandwidth. The function does no arithmetic; it moves
// 2 * n * D * 4 + 4 * n bytes (rows read, rows written, indices read).
// Design for that: one warp per output row, lanes striding over D with
// 16-byte float4 loads and stores when D % 4 == 0 and both base pointers are
// 16-byte aligned (then every row is aligned), so a 128-wide f32 row is one
// fully coalesced 512-byte transaction per warp; a scalar loop otherwise.
// Each warp loads its own index (one broadcast word for all lanes) and
// computes the row offset in 64 bits: the full dlrm-ctr table holds
// 57,012,000 x 128 = 7.3e9 elements, past the int32 range.
// Table rows go through the read-only data cache (__ldg).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const float* __restrict__ table, int64_t rows, int64_t dim,
                   const int32_t* __restrict__ idx, int64_t n,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int64_t r = idx[i];
  const bool valid = r >= 0 && r < rows;
  float* dst = out + i * dim;
  if (kVec) {
    const int64_t d4 = dim >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    if (valid) {
      const float4* src4 = reinterpret_cast<const float4*>(table + r * dim);
      for (int64_t c = lane; c < d4; c += 32) dst4[c] = __ldg(src4 + c);
    } else {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int64_t c = lane; c < d4; c += 32) dst4[c] = zero;
    }
  } else {
    if (valid) {
      const float* src = table + r * dim;
      for (int64_t c = lane; c < dim; c += 32) dst[c] = __ldg(src + c);
    } else {
      for (int64_t c = lane; c < dim; c += 32) dst[c] = 0.f;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (n x dim) and checks shapes, types and devices.
extern "C" int repro_embedding_gather_f32(const float* table, int64_t rows,
                                          int64_t dim, const int32_t* idx,
                                          int64_t n, float* out,
                                          void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (dim % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(table) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    gather_rows_kernel<true><<<grid, block, 0, s>>>(table, rows, dim, idx, n, out);
  } else {
    gather_rows_kernel<false><<<grid, block, 0, s>>>(table, rows, dim, idx, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
