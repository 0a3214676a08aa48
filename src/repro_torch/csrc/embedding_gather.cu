// Embedding row gather for Hopper (sm_90a): out[i] = table[idx[i]], and a
// zero row where idx[i] < 0 or idx[i] >= rows.
//
// Replaces the Pallas TPU kernel `embedding_gather`
// (src/repro/kernels/embedding_gather.py) together with the clamp-and-mask
// wrapper around it (`gather_rows` in src/repro/kernels/dispatch.py): the
// gather and the sentinel mask are one pass, so no clamped copy and no
// second masking pass over the output ever touch device memory.
//
// Bound: bytes. The function does no arithmetic; it moves 2 * n * D * e +
// 4 * n bytes for e-byte elements (rows read, rows written, indices read).
// It copies f32 rows (the master table and its buffers) and bf16 rows (the
// lookups of a model that computes in bf16) as bits.
//
// What held the first design back on small calls was latency. It gave one
// warp to each output row, and each lane loaded one 16-byte vector and
// stored it before it loaded the next. A call with few wide rows (the LM
// decode: 32 rows of 20,480 bytes) then ran on 4 of the 132 SMs, and each
// lane waited for 40 round trips to memory one after another.
//
// The design, part by part:
// - Work items are (rows, column chunk). A lane keeps kLoads loads in
//   flight, 64 bytes (four 16-byte vectors, or 16 f32 or 32 bf16
//   elements), so a warp moves up to 2 KB an item. A row wider than that
//   is split over several warps and blocks (the Pallas kernel's `block_d`
//   split); narrower rows share a warp, up to 32 of them.
// - Load j of lane l moves unit 32 j + l of the item, so each load
//   instruction of a warp reads 32 consecutive units of one source row and
//   writes them to one output row (512 contiguous bytes in 16-byte
//   vectors). On the card this was faster on DLRM's 512-byte rows than
//   giving each row its own group of lanes (PERF.md, PR 20).
// - All of a lane's loads go out (through the read-only data cache,
//   __ldg) before its first store; the ragged end of a row is masked; a
//   sentinel row stores zeros and reads nothing.
// - A warp reads the indices of its rows once, one coalesced load by its
//   first lanes, and each load takes its row's index by a shuffle: an
//   index load followed by the row loads is the whole dependency chain.
// - The grid follows the items, with a grid-stride loop where a call has
//   more items than the grid holds, and blocks of fewer warps when a call
//   has few items, so that a small call still spreads over the SMs.
// - The launch plan (vector width, loads a lane, lanes a row, chunks a
//   row, warps a block, blocks) is computed from the shape alone by the
//   wrapper, `launch_plan` in kernels/embedding_gather.py, and passed in;
//   this file checks it against the pointers and the shape.
// - 16-byte vectors when a row is a whole number of them and both base
//   pointers are 16-byte aligned (then every row is aligned); element by
//   element otherwise, with the same split and the same loads-before-stores
//   order. Row offsets are 64-bit: the full dlrm-ctr table holds
//   57,012,000 x 128 = 7.3e9 elements, past the int32 range.
// - Per-item arithmetic is kept small (no division when a row is one
//   chunk, 32-bit offsets within a row): a variant that spent more of it
//   on each item was slower on DLRM's 512-byte rows (PERF.md, PR 20).
// No atomics: every output element is written by one lane, the same bits
// on every run.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kLaneBytes = 64;  // bytes a lane keeps in flight

// V is the unit of a load: uint4 (16 bytes of any element type), or one
// element's bits (uint32_t for f32, uint16_t for bf16). A row is `width`
// units. An item covers `span` units of each of its `1 << r_shift` rows
// (span = 32 kLoads >> r_shift), and load j of lane l moves unit 32 j + l
// of the item: row (32 j + l) / span, column (32 j + l) % span, so each
// load instruction of the warp reads and writes 32 consecutive units of a
// row, or whole rows when they are narrower.
template <typename V>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
gather_rows_kernel(const V* __restrict__ table, int64_t rows, int width,
                   const int32_t* __restrict__ idx, int64_t n,
                   V* __restrict__ out, int r_shift, int chunks,
                   int64_t items) {
  constexpr int kLoads = kLaneBytes / static_cast<int>(sizeof(V));
  constexpr int kLoadsShift = kLoads == 4 ? 2 : kLoads == 16 ? 4 : 5;
  static_assert(1 << kLoadsShift == kLoads, "loads a lane: 4, 16 or 32");
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 1 << r_shift;
  const int span_shift = 5 + kLoadsShift - r_shift;
  const int span = 1 << span_shift;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  // the item is the same for every lane of a warp, so all 32 reach the
  // shuffles below together
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
       item < items; item += stride) {
    int64_t row_group = item;
    int chunk = 0;
    if (chunks > 1) {  // a row split over items (then one row a warp)
      row_group = item / chunks;
      chunk = static_cast<int>(item - row_group * chunks);
    }
    const int64_t row0 = row_group << r_shift;
    int32_t mine = -1;
    if (lane < rows_per_warp && row0 + lane < n) mine = __ldg(idx + row0 + lane);
    const int first = chunk << span_shift;
    const int count = min(span, width - first);  // units of each row to copy
    // every load out before the first store; a sentinel row loads nothing
    // and stores zeros
    V buf[kLoads];
    uint32_t copy = 0, zero = 0;  // bit j: load j copies a unit, or zeroes one
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = (j << 5) + lane;
      const int k = u >> span_shift;
      const int32_t r = __shfl_sync(0xffffffffu, mine, k);
      if (row0 + k < n && (u & (span - 1)) < count) {
        if (r >= 0 && r < rows) {
          buf[j] = __ldg(table + static_cast<int64_t>(r) * width + first + (u & (span - 1)));
          copy |= 1u << j;
        } else {
          zero |= 1u << j;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = (j << 5) + lane;
      V* dst = out + (row0 + (u >> span_shift)) * width + first + (u & (span - 1));
      if (copy >> j & 1) {
        *dst = buf[j];
      } else if (zero >> j & 1) {
        *dst = V{};
      }
    }
  }
}

template <typename V>
int launch(const void* table, int64_t rows, int64_t row_bytes,
           const int32_t* idx, int64_t n, void* out, int64_t loads,
           int64_t rows_per_warp, int64_t chunks, int64_t warps_per_block,
           int64_t blocks, cudaStream_t s) {
  constexpr int64_t kLoads = kLaneBytes / static_cast<int64_t>(sizeof(V));
  const int64_t width = row_bytes / static_cast<int64_t>(sizeof(V));
  int r_shift = 0;
  while ((int64_t{1} << r_shift) < rows_per_warp) ++r_shift;
  const int64_t span = 32 * kLoads / rows_per_warp;
  // the plan must cover each row exactly: whole chunks of one row a warp
  // when a row takes more than one item
  if ((int64_t{1} << r_shift) != rows_per_warp || rows_per_warp > 32 ||
      loads != kLoads || width > INT_MAX || chunks != (width + span - 1) / span ||
      (chunks > 1 && rows_per_warp != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t items = (n + rows_per_warp - 1) / rows_per_warp * chunks;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks),
                          static_cast<unsigned>(warps_per_block * 32), 0, s>>>(
      static_cast<const V*>(table), rows, static_cast<int>(width), idx, n,
      static_cast<V*>(out), r_shift, static_cast<int>(chunks), items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of `dim` elements of `elem_bytes` (4: f32, 2: bf16), copied in
// loads of `vec_bytes` (16, or `elem_bytes`) by the wrapper's launch plan:
// `loads` loads a lane, `rows_per_warp` rows an item, `chunks` items a row,
// `warps_per_block` warps in each of `blocks` blocks. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a plan
// that does not fit the shape or the pointers. The caller allocates `out`
// (n x dim) and checks shapes, types and devices.
extern "C" int repro_embedding_gather(const void* table, int64_t rows,
                                      int64_t dim, int64_t elem_bytes,
                                      const int32_t* idx, int64_t n, void* out,
                                      int64_t vec_bytes, int64_t loads,
                                      int64_t rows_per_warp, int64_t chunks,
                                      int64_t warps_per_block,
                                      int64_t blocks, void* stream) {
  if (n <= 0) return 0;
  if (warps_per_block < 1 || warps_per_block > kMaxWarpsPerBlock ||
      blocks < 1 || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_bytes = dim * elem_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_bytes == 16) {
    const bool aligned = row_bytes % 16 == 0 &&
                         (reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out)) % 16 == 0;
    if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
    return launch<uint4>(table, rows, row_bytes, idx, n, out, loads,
                         rows_per_warp, chunks, warps_per_block, blocks, s);
  }
  if (vec_bytes == elem_bytes && elem_bytes == 4) {
    return launch<uint32_t>(table, rows, row_bytes, idx, n, out, loads,
                            rows_per_warp, chunks, warps_per_block, blocks, s);
  }
  if (vec_bytes == elem_bytes && elem_bytes == 2) {
    return launch<uint16_t>(table, rows, row_bytes, idx, n, out, loads,
                            rows_per_warp, chunks, warps_per_block, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
