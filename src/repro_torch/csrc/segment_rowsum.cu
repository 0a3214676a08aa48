// Deterministic segment row-sum for Hopper (sm_90a):
//   out[s] = sum of grads[l] over every l with ids[l] == s, in f32,
// for s in [0, S). Ids outside [0, S) fall in no segment and are dropped.
//
// Replaces the Pallas TPU kernel `segment_rowsum_sorted`
// (src/repro/kernels/segment_rowsum.py), which sums an (L, D) block into an
// (S, D) tile per grid step as a one-hot matmul on the TPU's matrix unit,
// carrying the output tile across the sequential L axis of its grid in
// blocks of 256 rows. Blocks on Hopper run in no order and nothing carries
// between them, and float atomics would make the sum's bits change from
// run to run. So the sum is turned around: the caller orders the positions
// by a stable integer sort of the ids (`sorted_ids`, `perm`), and
//   1. `segment_starts_kernel` finds every segment's run in the sorted ids,
//      one thread per segment doing a binary search (`starts[s]` = first
//      position whose id is >= s);
//   2. `segment_chunks_kernel` sums every chunk: the run's positions cut
//      into chunks of `chunk` consecutive positions, each summed in
//      ascending position (ascending input position, the sort being
//      stable). Segment s's chunk 0 goes to out[s]; a chunk j >= 1 goes to
//      partial[e], e the stripe (sorted positions [e chunk, (e + 1) chunk))
//      where it starts: no other chunk j >= 1 starts there, so the work
//      items need no scan, and a run's chunks 1, 2, ... lie in consecutive
//      stripes. An empty segment writes zeros;
//   3. `segment_combine_kernel` adds each long run's partials to out[s] in
//      chunk order: ((c0 + c1) + c2) + ...
// `chunk` comes from the caller (the Python wrapper's CHUNK, 64 positions:
// a quarter of the TPU kernel's block_l, so that a chunk's dependent chain
// of row loads, 8 in flight, stays under the time of the whole pass at the
// training paths' shapes). A run of at most `chunk` positions is one chunk:
// the same order and bits as a sequential scatter-add in input order. Every
// call on the same inputs gives the same bits, with no atomics.
//
// Bound: memory bandwidth. The function reads each in-range grads row once
// and writes every output row once, plus the ids (and the sort's
// permutation); it does one add per element read. Design for that: a work
// item covers all D columns at once, one lane per float4 (16-byte loads and
// stores when D % 4 == 0 and both base pointers are 16-byte aligned; a
// scalar loop otherwise), over as many warps as D needs (up to 8), so each
// row is one coalesced read. The pass is persistent (as many blocks as the
// card holds), long runs' chunks first. A chunk is walked 32 positions at a
// time: each warp loads the 32 row numbers in one coalesced read and
// broadcasts them with shuffles, and 8 row loads are in flight before they
// are added in order. A hot key's long run is split over ceil(n / chunk) work items, so
// no item walks more than `chunk` rows (the one-warp-per-segment form of
// the first port walked a 5,400-row run alone, once per 32-float4 strip).
// Row offsets are 64-bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
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

// Item `item` of one call: stripes first (stripe e: the extra chunk,
// number j >= 1 in its run, if any, that starts among sorted positions
// [e chunk, (e + 1) chunk); at most one does, since a chunk j >= 1 starts at
// least `chunk` positions into its run), then segment s's chunk 0. Sets the
// positions [lo, hi) to sum and where to write; false when the stripe holds
// no chunk start.
__device__ __forceinline__ bool item_range(int64_t item, const int32_t* __restrict__ sorted,
                                           const int64_t* __restrict__ starts,
                                           int64_t segments, int64_t stripes, int64_t chunk,
                                           int64_t& lo, int64_t& hi, int64_t& row) {
  if (item < stripes) {
    const int64_t p = item * chunk;
    const int64_t id = __ldg(sorted + p);
    if (id < 0 || id >= segments) return false;
    const int64_t s0 = __ldg(starts + id), s1 = __ldg(starts + id + 1);
    const int64_t c = s0 + (p - s0 + chunk - 1) / chunk * chunk;  // first chunk start >= p
    if (c == s0 || c >= s1) return false;  // chunk 0 is the segment's item
    lo = c;
    hi = c + chunk < s1 ? c + chunk : s1;
    row = item;
  } else {
    const int64_t s = item - stripes;
    lo = __ldg(starts + s);
    const int64_t s1 = __ldg(starts + s + 1);
    hi = lo + chunk < s1 ? lo + chunk : s1;
    row = s;
  }
  return true;
}

// Persistent: each group of `warps` warps (a power of two dividing 8)
// takes items group, group + groups, ...; its lanes cover the row's
// `width` columns (float4 or float), warp-major, looping when D needs more
// than 8 warps. Stripes come first, so the long runs' chunks start early.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
segment_chunks_kernel(const float* __restrict__ grads, int64_t dim,
                      const int32_t* __restrict__ sorted, const int64_t* __restrict__ perm,
                      const int64_t* __restrict__ starts, int64_t segments,
                      int64_t stripes, int64_t chunk, int warps, float* __restrict__ out,
                      float* __restrict__ partial) {
  using C = Cols<kVec>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_block = kThreads / 32 / warps;
  const int64_t groups = static_cast<int64_t>(gridDim.x) * per_block;
  const int64_t width = kVec ? dim >> 2 : dim;
  const int stride = warps * 32;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * per_block + warp / warps;
       item < stripes + segments; item += groups) {
    int64_t lo, hi, row;
    if (!item_range(item, sorted, starts, segments, stripes, chunk, lo, hi, row)) continue;
    float* dst = (item < stripes ? partial : out) + row * dim;
    for (int64_t c = (warp % warps) * 32 + lane;
         c - lane < width; c += stride) {  // whole warps step together
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
}

// Stripe e holding chunk 1 of a run adds the run's partials (chunks 1..J,
// in stripes e .. e + J - 1) to out[s] in chunk order; one thread per
// column (float4 or float), blockIdx.y the column block.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
segment_combine_kernel(const int32_t* __restrict__ sorted, const int64_t* __restrict__ starts,
                       int64_t segments, int64_t chunk, int64_t dim,
                       const float* __restrict__ partial, float* __restrict__ out) {
  using C = Cols<kVec>;
  const int64_t e = blockIdx.x;
  const int64_t p = e * chunk;
  const int64_t s = __ldg(sorted + p);
  if (s < 0 || s >= segments) return;
  const int64_t s0 = __ldg(starts + s), s1 = __ldg(starts + s + 1);
  if (p <= s0 || p - s0 > chunk || s0 + chunk >= s1) return;  // not chunk 1's stripe
  const int64_t width = kVec ? dim >> 2 : dim;
  const int64_t c = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (c >= width) return;
  const int64_t parts = (s1 - s0 - 1) / chunk;  // chunks 1 .. parts
  typename C::T acc = C::load(out + s * dim, c);
  int64_t t = 0;
  for (; t + kUnroll <= parts; t += kUnroll) {
    typename C::T v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = C::load(partial + (e + t + k) * dim, c);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) C::add(acc, v[k]);
  }
  for (; t < parts; ++t) C::add(acc, C::load(partial + (e + t) * dim, c));
  C::store(out + s * dim, c, acc);
}

bool vec_ok(const float* a, const float* b, int64_t dim) {
  return dim % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0);
}

}  // namespace

extern "C" {

// The positions of the run of each segment: `starts` (segments + 1) from
// the stably sorted ids (n,). Returns cudaGetLastError().
int repro_segment_starts(const int32_t* sorted_ids, int64_t n, int64_t segments,
                         int64_t* starts, void* stream) {
  const int64_t blocks = (segments + 1 + 255) / 256;
  if (segments <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  segment_starts_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(sorted_ids, n, segments,
                                                               starts);
  return static_cast<int>(cudaGetLastError());
}

// Every chunk's sum: chunk 0 of segment s into out[s] (segments x dim),
// the extra chunk starting in stripe e (sorted positions [e chunk,
// (e + 1) chunk)) into partial[e] (stripes = ceil(n / chunk) rows). `sorted`
// and `perm` are the stably sorted ids and the input row of each position.
// Returns cudaGetLastError().
int repro_segment_chunks_f32(const float* grads, int64_t dim, const int32_t* sorted,
                             const int64_t* perm, const int64_t* starts, int64_t n,
                             int64_t segments, int64_t chunk, float* out, float* partial,
                             void* stream) {
  if (segments <= 0 || dim <= 0 || n <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_ok(grads, out, dim) && vec_ok(partial, out, dim);
  const int64_t width = vec ? dim / 4 : dim;
  int warps = 1;
  while (warps < kThreads / 32 && warps * 32 < width) warps *= 2;
  const int64_t stripes = (n + chunk - 1) / chunk;
  const int64_t per_block = kThreads / 32 / warps;
  const int64_t needed = (stripes + segments + per_block - 1) / per_block;
  // persistent: as many blocks as the card holds at once
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vec ? segment_chunks_kernel<true> : segment_chunks_kernel<false>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(needed < resident ? needed : resident);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    segment_chunks_kernel<true><<<blocks, kThreads, 0, st>>>(
        grads, dim, sorted, perm, starts, segments, stripes, chunk, warps, out, partial);
  } else {
    segment_chunks_kernel<false><<<blocks, kThreads, 0, st>>>(
        grads, dim, sorted, perm, starts, segments, stripes, chunk, warps, out, partial);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[s] += the partials of each run longer than `chunk`, in chunk order.
// Returns cudaGetLastError().
int repro_segment_combine_f32(const int32_t* sorted, const int64_t* starts, int64_t n,
                              int64_t segments, int64_t chunk, int64_t dim,
                              const float* partial, float* out, void* stream) {
  if (segments <= 0 || dim <= 0 || n <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_ok(partial, out, dim);
  const int64_t width = vec ? dim / 4 : dim;
  const int64_t stripes = (n + chunk - 1) / chunk;
  const int64_t col_blocks = (width + kThreads - 1) / kThreads;
  if (stripes > INT_MAX || col_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(stripes), static_cast<unsigned>(col_blocks));
  const unsigned threads = static_cast<unsigned>(width < kThreads ? width : kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    segment_combine_kernel<true><<<grid, threads, 0, st>>>(sorted, starts, segments, chunk, dim,
                                                           partial, out);
  } else {
    segment_combine_kernel<false><<<grid, threads, 0, st>>>(sorted, starts, segments, chunk,
                                                            dim, partial, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
