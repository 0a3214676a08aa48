// Dual-buffer intersection copy for Hopper (sm_90a), DBP stage 4b:
//   s = src[i];  hit = s < ka
//   out[i], out_accum[i] = active[s], active_accum[s]     if hit
//                          prefetch[i], prefetch_accum[i] otherwise
// A negative s wraps to s + ka (and clamps at 0), as an index into the
// active buffer does in both JAX backends.
//
// Replaces the Pallas TPU kernel `buffer_sync_rows`
// (src/repro/kernels/buffer_sync.py), one grid step per prefetch row with
// the active row's block index fed by scalar prefetch, together with the
// adagrad-state select the JAX engine does beside it
// (`jnp.where(hit, aa[src], pa)` in EmbeddingEngine.sync_buffers): the
// rows and their accumulator move in one pass, so no clamped index, no
// gathered copy and no second select ever touch device memory.
//
// Bound: memory bandwidth. No arithmetic; per prefetch row it reads one
// row (active or prefetch, never both) and its accumulator, writes one row
// and one accumulator, and reads one index. Design for that: one warp per
// prefetch row, each warp loading its own index (one broadcast word), lanes
// striding over D with 16-byte float4 loads and stores when D % 4 == 0 and
// the three row pointers are 16-byte aligned, a scalar loop otherwise;
// 64-bit row offsets; rows through the read-only data cache (__ldg).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
buffer_sync_kernel(const float* __restrict__ active,
                   const float* __restrict__ active_accum, int64_t ka,
                   const float* __restrict__ prefetch,
                   const float* __restrict__ prefetch_accum,
                   const int32_t* __restrict__ src, int64_t kp, int64_t dim,
                   float* __restrict__ out, float* __restrict__ out_accum) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= kp) return;
  int64_t s = src[i];
  const bool hit = s < ka;
  if (hit && s < 0) {
    s += ka;
    if (s < 0) s = 0;
  }
  const float* from = hit ? active + s * dim : prefetch + i * dim;
  float* dst = out + i * dim;
  if (kVec) {
    const int64_t d4 = dim >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(from);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int64_t c = lane; c < d4; c += 32) dst4[c] = __ldg(src4 + c);
  } else {
    for (int64_t c = lane; c < dim; c += 32) dst[c] = __ldg(from + c);
  }
  if (lane == 0) out_accum[i] = hit ? __ldg(active_accum + s) : __ldg(prefetch_accum + i);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (kp x dim) and `out_accum` (kp,), checks shapes,
// types and devices, and passes ka > 0.
extern "C" int repro_buffer_sync_f32(const float* active, const float* active_accum,
                                     int64_t ka, const float* prefetch,
                                     const float* prefetch_accum,
                                     const int32_t* src, int64_t kp, int64_t dim,
                                     float* out, float* out_accum, void* stream) {
  if (kp <= 0) return 0;
  if (ka <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (kp + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (dim % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(active) |
                     reinterpret_cast<uintptr_t>(prefetch) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    buffer_sync_kernel<true><<<grid, block, 0, st>>>(
        active, active_accum, ka, prefetch, prefetch_accum, src, kp, dim, out,
        out_accum);
  } else {
    buffer_sync_kernel<false><<<grid, block, 0, st>>>(
        active, active_accum, ka, prefetch, prefetch_accum, src, kp, dim, out,
        out_accum);
  }
  return static_cast<int>(cudaGetLastError());
}
