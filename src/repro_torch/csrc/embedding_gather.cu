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
// 2 * n * D * e + 4 * n bytes for e-byte elements (rows read, rows written,
// indices read). It copies f32 rows (the master table and its buffers) and
// bf16 rows (the lookups of a model that computes in bf16) as bits.
// Design for that: one warp per output row, lanes striding over the row in
// 16-byte vectors when a row is a whole number of them and both base
// pointers are 16-byte aligned (then every row is aligned), so a 128-wide
// f32 row is one fully coalesced 512-byte transaction per warp; element by
// element otherwise. Each warp loads its own index (one broadcast word for
// all lanes) and computes the row offset in 64 bits: the full dlrm-ctr
// table holds 57,012,000 x 128 = 7.3e9 elements, past the int32 range.
// Table rows go through the read-only data cache (__ldg).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

// T is the element (float, or uint16_t for bf16 bits); kVec copies 16-byte
// vectors of a row that is a whole number of them.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const T* __restrict__ table, int64_t rows, int64_t dim,
                   const int32_t* __restrict__ idx, int64_t n,
                   T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int64_t r = idx[i];
  const bool valid = r >= 0 && r < rows;
  T* dst = out + i * dim;
  if (kVec) {
    const int64_t width = dim * static_cast<int64_t>(sizeof(T)) / 16;
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    if (valid) {
      const uint4* src4 = reinterpret_cast<const uint4*>(table + r * dim);
      for (int64_t c = lane; c < width; c += 32) dst4[c] = __ldg(src4 + c);
    } else {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      for (int64_t c = lane; c < width; c += 32) dst4[c] = zero;
    }
  } else {
    if (valid) {
      const T* src = table + r * dim;
      for (int64_t c = lane; c < dim; c += 32) dst[c] = __ldg(src + c);
    } else {
      for (int64_t c = lane; c < dim; c += 32) dst[c] = T(0);
    }
  }
}

template <typename T>
void launch(const void* table, int64_t rows, int64_t dim, const int32_t* idx,
            int64_t n, void* out, dim3 grid, dim3 block, cudaStream_t s) {
  const T* src = static_cast<const T*>(table);
  T* dst = static_cast<T*>(out);
  const bool vec = (dim * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(table) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  if (vec) {
    gather_rows_kernel<T, true><<<grid, block, 0, s>>>(src, rows, dim, idx, n, dst);
  } else {
    gather_rows_kernel<T, false><<<grid, block, 0, s>>>(src, rows, dim, idx, n, dst);
  }
}

}  // namespace

// Rows of `elem_bytes` (4: f32, 2: bf16) elements. Launches on `stream` and
// returns cudaGetLastError() (0 on success). The caller allocates `out`
// (n x dim) and checks shapes, types and devices.
extern "C" int repro_embedding_gather(const void* table, int64_t rows,
                                      int64_t dim, int64_t elem_bytes,
                                      const int32_t* idx, int64_t n, void* out,
                                      void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    launch<float>(table, rows, dim, idx, n, out, grid, block, s);
  } else if (elem_bytes == 2) {
    launch<uint16_t>(table, rows, dim, idx, n, out, grid, block, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
