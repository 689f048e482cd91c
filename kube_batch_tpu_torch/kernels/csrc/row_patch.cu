// K9 · row_patch: the batched row scatter of one incremental pack.
//
// Replaces kube_batch_tpu/cache/incremental.py · _row_patch, the jitted
// `buf.at[rows].set(vals)` over every row-patched snapshot field, issued
// as ONE dispatch for the whole dirty set.  Here too one launch serves
// every field.  The wrapper (kernels/row_patch.py) writes, into a pinned
// host slot of a ring it keeps per device, a table of fields followed by
// each field's int32 row indices and its rows gathered straight from the
// host arrays; kb_row_patch reads the table on the host, checks every
// index against its buffer, and launches once; the kernel reads the
// mapped slot over the host link (zero-copy, so no device staging buffer
// and no copy before the launch).  It then records the slot's event,
// which the wrapper waits on before it rewrites the slot.
//
// Table entry (8 × int64): destination pointer, the buffer's rows, row
// bytes, row count k, byte offset of the k indices, byte offset of the k
// rows of values (both 16-byte aligned in the slot), the field's copy
// unit (gcd(row bytes, 16) bytes, and no wider than the destination's
// alignment), and its first unit in the launch (a prefix over fields).
//
// The table travels in the launch's parameters (at most MAX_FIELDS
// entries, 64 bytes each, under the 4 KB a launch carries), so no thread
// reads it over the link.  Every unit of every field is one position of
// one grid (a grid-stride loop): a thread finds its field by a binary
// search over the prefixes, its row and unit by a shift, and copies one
// unit with one load and one store — 16 bytes where the row width allows
// (f32[T, 4] requests: one unit a row), single bytes only for rows of odd
// width (bool[N, 3] pressure flags).  Rows of every width share the grid,
// so a 1-byte row does not hold a warp.  Duplicate indices carry
// identical values (the wrapper pads a field's indices by repeating its
// first row, and gathers every value from the host array), so the order
// in which duplicate writes land does not matter.
//
// Bound on this card: the staged bytes cross the host link once (the
// kernel's reads of the mapped slot) and the patched rows
// are written to device memory once; at a steady cycle's hundreds of
// kilobytes the link, not HBM, sets the least time.  There is no
// arithmetic.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_FIELDS = 60;
constexpr int THREADS = 256;

struct Entry {
  int64_t dst, buf_rows, row_bytes, rows, idx_off, val_off, unit, first;
};

struct Table {
  Entry e[MAX_FIELDS];
};

__device__ __forceinline__ void copy_unit(uint8_t* dst, const uint8_t* src, int64_t unit) {
  switch (unit) {
    case 16: *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src); break;
    case 8: *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src); break;
    case 2: *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src); break;
    default: *dst = *src;
  }
}

__global__ void __launch_bounds__(THREADS)
row_patch_kernel(const __grid_constant__ Table t, int n, int64_t units,
                 const uint8_t* __restrict__ staged) {
  for (int64_t u = (int64_t)blockIdx.x * THREADS + threadIdx.x; u < units;
       u += (int64_t)gridDim.x * THREADS) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.e[mid].first <= u) lo = mid;
      else hi = mid - 1;
    }
    const Entry& e = t.e[lo];
    const int shift = __ffsll(e.unit) - 1;
    const int64_t local = u - e.first;
    const int64_t per_row = e.row_bytes >> shift;
    const int64_t r = local / per_row, off = (local - r * per_row) << shift;
    const int32_t row = reinterpret_cast<const int32_t*>(staged + e.idx_off)[r];
    copy_unit(reinterpret_cast<uint8_t*>(e.dst) + row * e.row_bytes + off,
              staged + e.val_off + r * e.row_bytes + off, e.unit);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

}  // namespace

// A slot of the ring: `bytes` of pinned host memory mapped into the
// card's address space (its device address in *mapped) and an event.
extern "C" int kb_row_patch_slot(int64_t bytes, void** host, void** mapped, void** event) {
  cudaError_t err = cudaHostAlloc(host, (size_t)bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return (int)err;
  err = cudaHostGetDevicePointer(mapped, *host, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaEventCreateWithFlags(reinterpret_cast<cudaEvent_t*>(event),
                                       cudaEventDisableTiming);
}

extern "C" int kb_row_patch_slot_free(void* host, void* event) {
  const cudaError_t err = cudaEventDestroy(reinterpret_cast<cudaEvent_t>(event));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFreeHost(host);
}

// Blocks the host until the last launch that read a slot has finished.
extern "C" int kb_row_patch_wait(void* event) {
  return (int)cudaEventSynchronize(reinterpret_cast<cudaEvent_t>(event));
}

// slot: the staged bytes on the host (table first); mapped: the slot's
// device address, where the kernel reads them.  Returns -2, and launches
// nothing, when an index lies outside its buffer's rows.
extern "C" int kb_row_patch(const void* slot, int n_fields, int64_t units, const void* mapped,
                            void* event, cudaStream_t stream) {
  if (n_fields < 1 || n_fields > MAX_FIELDS || units < 1) return -1;
  Table t;
  std::memcpy(t.e, slot, sizeof(Entry) * n_fields);
  const uint8_t* host = static_cast<const uint8_t*>(slot);
  for (int f = 0; f < n_fields; ++f) {
    const Entry& e = t.e[f];
    const int32_t* idx = reinterpret_cast<const int32_t*>(host + e.idx_off);
    for (int64_t r = 0; r < e.rows; ++r) {
      if (idx[r] < 0 || idx[r] >= e.buf_rows) return -2;
    }
  }
  const int64_t want = (units + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 4LL * sm_count() ? want : 4LL * sm_count());
  row_patch_kernel<<<blocks, THREADS, 0, stream>>>(t, n_fields, units,
                                                  static_cast<const uint8_t*>(mapped));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaEventRecord(reinterpret_cast<cudaEvent_t>(event), stream);
}
