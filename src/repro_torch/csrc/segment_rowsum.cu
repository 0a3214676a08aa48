// Deterministic segment row-sum for Hopper (sm_90a):
//   out[s] = sum of grads[l] over every l with ids[l] == s, in f32,
// for s in [0, S). Ids outside [0, S) fall in no segment and are dropped.
//
// Replaces the Pallas TPU kernel `segment_rowsum_sorted`
// (src/repro/kernels/segment_rowsum.py), which sums an (L, D) block into an
// (S, D) tile per grid step as a one-hot matmul on the TPU's matrix unit,
// carrying the output tile across the sequential L axis of its grid. Blocks
// on Hopper run in no order and nothing carries between them, and float
// atomics would make the sum's bits change from run to run. So the sum is
// turned around: the caller orders the positions by a stable integer sort
// of the ids (`sorted_ids`, `perm`), and one warp owns each output segment.
// A first pass finds every segment's run in the sorted ids, one thread per
// segment doing a binary search (`starts[s]` = first position whose id is
// >= s). Then one warp per segment sums grads[perm[p]] for p in
// [starts[s], starts[s+1]), in ascending p, which is ascending input
// position because the sort is stable: the same order as a sequential
// scatter-add, the same bits on every run, and no atomics. An empty
// segment writes zeros. Ids need not arrive sorted (the engine's
// plan.inverse does not).
//
// Bound: memory bandwidth. The function reads each in-range grads row once
// and writes every output row once, plus the ids (and the sort's
// permutation); it does one add per element read. Design for that: lanes
// stride over D with 16-byte float4 loads and stores when D % 4 == 0 and
// both base pointers are 16-byte aligned, so a 128-wide f32 row is one
// coalesced 512-byte transaction per warp; a scalar loop otherwise. A run
// is walked 32 positions at a time: the lanes load the 32 row numbers in
// one coalesced read and broadcast them with shuffles, and 8 row loads are
// in flight before they are added in order, so a hot key's long run is not
// one dependent load at a time. Row offsets are 64-bit. Each segment is
// summed by one warp, so the longest run (a hot key in one micro-batch)
// sets the kernel's tail.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// starts[s] = first position in sorted[0, n) whose value is >= s, for
// s in [0, segments]: one thread per segment boundary.
__global__ void __launch_bounds__(256)
segment_starts_kernel(const int32_t* __restrict__ sorted, int64_t n,
                      int64_t segments, int64_t* __restrict__ starts) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s > segments) return;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(__ldg(sorted + mid)) < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  starts[s] = lo;
}

// A row's columns as float4 (kVec) or float.
template <bool kVec>
struct Cols;

template <>
struct Cols<true> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T load(const float* row, int64_t c) {
    return __ldg(reinterpret_cast<const float4*>(row) + c);
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ void store(float* row, int64_t c, const T& v) {
    reinterpret_cast<float4*>(row)[c] = v;
  }
};

template <>
struct Cols<false> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T load(const float* row, int64_t c) {
    return __ldg(row + c);
  }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
  static __device__ __forceinline__ void store(float* row, int64_t c, const T& v) {
    row[c] = v;
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_rowsum_kernel(const float* __restrict__ grads, int64_t dim,
                      const int64_t* __restrict__ perm,
                      const int64_t* __restrict__ starts, int64_t segments,
                      float* __restrict__ out) {
  using C = Cols<kVec>;
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= segments) return;  // the whole warp: s is per warp
  const int64_t lo = __ldg(starts + s);
  const int64_t hi = __ldg(starts + s + 1);
  const int64_t width = kVec ? dim >> 2 : dim;
  float* dst = out + s * dim;
  for (int64_t c0 = 0; c0 < width; c0 += 32) {
    const int64_t c = c0 + lane;
    const bool on = c < width;
    typename C::T acc = C::zero();
    for (int64_t base = lo; base < hi; base += 32) {
      // row numbers of positions base .. base+31, one per lane
      const int64_t mine = base + lane < hi ? __ldg(perm + base + lane) : 0;
      const int cnt = static_cast<int>(hi - base < 32 ? hi - base : 32);
      int u = 0;
      for (; u + kUnroll <= cnt; u += kUnroll) {
        typename C::T g[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int64_t r = __shfl_sync(kFullMask, mine, u + k);
          g[k] = on ? C::load(grads + r * dim, c) : C::zero();
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) C::add(acc, g[k]);
      }
      for (; u < cnt; ++u) {
        const int64_t r = __shfl_sync(kFullMask, mine, u);
        if (on) C::add(acc, C::load(grads + r * dim, c));
      }
    }
    if (on) C::store(dst, c, acc);
  }
}

}  // namespace

// `sorted_ids` (n,) are the ids after a stable sort and `perm` (n,) the
// input position of each; `grads` is (rows, dim) with every perm entry a
// valid row; `starts` is scratch of segments + 1 entries. Writes every row
// of `out` (segments x dim). Launches two kernels on `stream` and returns
// cudaGetLastError() (0 on success). The caller allocates `out` and
// `starts` and checks shapes, types and devices.
extern "C" int repro_segment_rowsum_f32(const float* grads, int64_t dim,
                                        const int32_t* sorted_ids,
                                        const int64_t* perm, int64_t n,
                                        int64_t segments, int64_t* starts,
                                        float* out, void* stream) {
  if (segments <= 0) return 0;
  const int64_t blocks = (segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t bound_blocks = (segments + 1 + 255) / 256;
  if (blocks > INT_MAX || bound_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  segment_starts_kernel<<<static_cast<unsigned>(bound_blocks), 256, 0, st>>>(
      sorted_ids, n, segments, starts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (dim % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(grads) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  if (vec) {
    segment_rowsum_kernel<true><<<grid, block, 0, st>>>(grads, dim, perm, starts,
                                                        segments, out);
  } else {
    segment_rowsum_kernel<false><<<grid, block, 0, st>>>(grads, dim, perm, starts,
                                                         segments, out);
  }
  return static_cast<int>(cudaGetLastError());
}
