// K9 · row_patch: the batched row scatter of one incremental pack.
//
// Replaces kube_batch_tpu/cache/incremental.py · _row_patch, the jitted
// `buf.at[rows].set(vals)` over every row-patched snapshot field, issued
// as ONE dispatch for the whole dirty set.  Here too one launch serves
// every field: the wrapper stages, in one pinned host buffer shipped by
// one non-blocking copy, a table of fields followed by each field's row
// indices and row values; the kernel reads the table and copies rows.
//
// Table entry (5 × int64): destination pointer, row bytes, row count k,
// byte offset of the k int32 row indices, byte offset of the k rows of
// values (both offsets into the staged buffer, values 16-byte aligned).
//
// Grid: blockIdx.y is the field, each warp of a block copies one row
// (blockIdx.x · WARPS + warp).  A row whose byte width is a multiple of
// 4 is copied in 32-bit words, any other (bool[T], a u8 row of 3
// pressure flags) byte by byte, so every snapshot dtype works (f32,
// i32, bool, i64).  Duplicate indices carry identical values (the
// wrapper pads a field's indices by repeating its first row), so the
// order in which duplicate writes land does not matter.
//
// Bound on this card: bytes — each staged byte is read once and each
// patched row written once; there is no arithmetic.  A steady cycle
// patches kilobytes, so a launch is latency-bound (a few microseconds).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

struct Entry {
  int64_t dst, row_bytes, rows, idx_off, val_off;
};

__global__ void row_patch_kernel(const uint8_t* __restrict__ staged,
                                 int n_fields) {
  const int f = blockIdx.y;
  if (f >= n_fields) return;
  const Entry e = reinterpret_cast<const Entry*>(staged)[f];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * WARPS + warp;
  if (r >= e.rows) return;
  const int32_t row = reinterpret_cast<const int32_t*>(staged + e.idx_off)[r];
  uint8_t* dst = reinterpret_cast<uint8_t*>(e.dst) + (int64_t)row * e.row_bytes;
  const uint8_t* src = staged + e.val_off + r * e.row_bytes;
  if (e.row_bytes % 4 == 0) {
    const int64_t words = e.row_bytes / 4;
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (int64_t i = lane; i < words; i += 32) d[i] = s[i];
  } else {
    for (int64_t i = lane; i < e.row_bytes; i += 32) dst[i] = src[i];
  }
}

}  // namespace

extern "C" int kb_row_patch(const void* staged, int n_fields, int64_t max_rows,
                            void* stream) {
  if (n_fields == 0 || max_rows == 0) return 0;
  dim3 grid((unsigned)((max_rows + WARPS - 1) / WARPS), (unsigned)n_fields);
  row_patch_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)staged, n_fields);
  return (int)cudaGetLastError();
}
