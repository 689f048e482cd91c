// K7 · segment sums and the water-fill of queue shares, three entry points.
//
// Replaces the segment sums of the reference package — every J/Q/S sum
// and count of drf, proportion, gang and predicates
// (kube_batch_tpu/api/snapshot.py · count_per_job / sum_req_per_job and
// the jax.ops.segment_sum calls of plugins/drf.py, proportion.py,
// predicates.py), the port's single site being api/snapshot.py ·
// segment_sum — and ops/waterfill.py · waterfill_deserved.
//
// kb_segment_sum (float32 values): every call site sums rows by
// seg = where(mask, base, S), where `base` is one of three id vectors
// (task_job, the task's queue, its namespace) that change only when a
// pack writes them, and only the mask changes from call to call.  So the
// stable order of the rows by `base` — a CSR `order` i32[T] and
// `offsets` i32[S+1], api/snapshot.py · SegmentIndex — is built once per
// pack, and a call needs no sort.  Each segment's index range
// order[offsets[s] : offsets[s+1]] (ascending row index, the order the
// stable sort gives) is cut into G equal runs, one block each; a block
// skips the rows whose seg is not s (masked out) and sums the rest.
// Thread i of B takes positions i, i+B, i+2B, ... of its run; warp
// shuffles with fixed offsets (16, 8, 4, 2, 1) and one shared-memory
// pass over the warps combine them; with G > 1 the last of a segment's
// blocks to finish adds the G partials in run order.  B (32 to 256) and
// G (1 to 64) come from the shapes alone, so that a segment of the mean
// length T / S gives each thread about one position: a job (tens of rows)
// gets one warp and one run, a queue of the main path (about 21,000 of
// 65,536 rows) 256 threads in 32 runs, so a long segment is spread over
// many SMs, and no host read of `offsets` is needed.  Blocks
// per segment (rather than fixed row chunks across segments) keep each
// segment's combine in one fixed order, in one launch with no float
// atomics.  The partition and the
// combine depend only on the shapes and the index, never on scheduling,
// so two runs are bitwise equal; the sums are float64, rounded once to
// float32 (exact for integer-valued data below 2**53, so equal to
// index_add_ bit for bit there).
//
// kb_segment_count (int32 or bool values): counts need no index —
// integer addition gives the same result in any order.  A grid of
// threads, one row each: the lanes of a warp that hold the same segment
// are grouped by __match_any_sync, their values added by
// __reduce_add_sync, and the group's first lane adds the sum with one
// integer atomicAdd into the output, zeroed by a memset in the same
// stream.  Sums wrap modulo 2**32, as the plain version's int64 sum cast
// to int32 does.
//
// kb_waterfill: one thread per resource column runs the Q+1 iterations of
// the water-fill; the columns are independent.  The queue sums go left to
// right in float32 and every operation is the plain version's, separately
// rounded (__fmul_rn etc.; the build passes --fmad=false), so the kernel
// equals the plain version bit for bit.
//
// Bound on this card: bytes, and at the port's shapes launch latency.
// The earlier design sorted the ids on every call (a CUB radix sort and
// its temporary allocation), binary-searched each segment's range and
// ran a __syncthreads ladder per column: 5.4× index_add_ at T = 8,192.
// Now a float call is a memset of the tickets (when G > 1) and one
// launch; it reads the order and the ids once (8 bytes a row), the kept
// rows' values once, and writes each segment's sums once (and G float64
// partials); a count call reads the ids and values once and
// makes one atomic per segment per warp.  At the preempt path's shapes
// the call is bound by its launch and the wrapper's host time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int CHUNK = 8;    // columns summed per pass over a segment's rows
constexpr int MAX_R = 32;
constexpr int COUNT_THREADS = 256;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void add_row(double (&acc)[CHUNK],
                                        const float* __restrict__ row, int width) {
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    if (c < width) acc[c] += (double)row[c];
  }
}

// Segment s = blockIdx.x / G, run g = blockIdx.x % G.  With G = 1 the
// block writes the segment's sums; otherwise it writes its float64
// partials and the last of the segment's G blocks (a ticket after a
// __threadfence) adds them in order g = 0, 1, ... and writes the sums.
// Which block finishes last does not change that order.  The tickets
// are zeroed by kb_segment_sum before the launch.
__global__ void segment_sum_kernel(const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ seg,
                                   const float* __restrict__ values, int C, int G,
                                   float* __restrict__ out, double* __restrict__ partial,
                                   int32_t* __restrict__ ticket) {
  const int32_t s = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int B = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ double warp_part[MAX_THREADS / 32][CHUNK];
  __shared__ bool last;
  const int seg_lo = offsets[s], seg_hi = offsets[s + 1];
  const int run = (seg_hi - seg_lo + G - 1) / G;
  const int lo = min(seg_hi, seg_lo + g * run), hi = min(seg_hi, lo + run);
  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    const int width = min(CHUNK, C - c0);
    double acc[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) acc[c] = 0.0;
    int i = lo + threadIdx.x;
    // four positions per step, loads issued together, added in position
    // order (the same order as one position per step)
    for (; i + 3 * B < hi; i += 4 * B) {
      const int r0 = order[i], r1 = order[i + B], r2 = order[i + 2 * B],
                r3 = order[i + 3 * B];
      const bool k0 = seg[r0] == s, k1 = seg[r1] == s, k2 = seg[r2] == s,
                 k3 = seg[r3] == s;
      if (k0) add_row(acc, values + (int64_t)r0 * C + c0, width);
      if (k1) add_row(acc, values + (int64_t)r1 * C + c0, width);
      if (k2) add_row(acc, values + (int64_t)r2 * C + c0, width);
      if (k3) add_row(acc, values + (int64_t)r3 * C + c0, width);
    }
    for (; i < hi; i += B) {
      const int r = order[i];
      if (seg[r] == s) add_row(acc, values + (int64_t)r * C + c0, width);
    }
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) acc[c] = warp_sum(acc[c]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) warp_part[warp][c] = acc[c];
    }
    __syncthreads();
    if (warp == 0) {
      const int warps = B >> 5;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const double v = warp_sum(lane < warps ? warp_part[lane][c] : 0.0);
        if (lane == 0 && c < width) {
          if (G == 1) out[(int64_t)s * C + c0 + c] = (float)v;
          else partial[((int64_t)s * G + g) * C + c0 + c] = v;
        }
      }
    }
    __syncthreads();
  }
  if (G == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket + s, 1) == G - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const volatile double* p = partial + (int64_t)s * G * C;
  for (int c = threadIdx.x; c < C; c += B) {
    double v = 0.0;
    for (int k = 0; k < G; ++k) v += p[(int64_t)k * C + c];
    out[(int64_t)s * C + c] = (float)v;
  }
}

template <typename In>
__global__ void segment_count_kernel(const int32_t* __restrict__ seg,
                                     const In* __restrict__ values, int64_t T,
                                     int C, int S, int32_t* __restrict__ out) {
  const unsigned lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // `base` is the same for every lane of a warp, so whole warps iterate
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < T; base += stride) {
    const int64_t t = base + threadIdx.x;
    const int32_t s = t < T ? seg[t] : -1;
    const bool valid = s >= 0 && s < S;
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? s : -1);
    const bool leader = (unsigned)(__ffs(peers) - 1) == lane;
    for (int c = 0; c < C; ++c) {
      const int v = valid ? (int)values[t * C + c] : 0;
      const int sum = __reduce_add_sync(peers, v);
      if (valid && leader && sum != 0) atomicAdd(out + (int64_t)s * C + c, sum);
    }
  }
}

__global__ void waterfill_kernel(const float* __restrict__ weights,
                                 const float* __restrict__ request,
                                 const float* __restrict__ total,
                                 const uint8_t* __restrict__ queue_mask, int Q,
                                 int R, uint8_t* __restrict__ unsat,
                                 float* __restrict__ deserved) {
  const int r = threadIdx.x;
  if (r >= R) return;
  for (int q = 0; q < Q; ++q) {
    deserved[q * R + r] = 0.0f;
    unsat[q * R + r] = queue_mask[q];
  }
  float remaining = total[r];
  for (int it = 0; it <= Q; ++it) {
    float wsum = 0.0f;
    for (int q = 0; q < Q; ++q) {
      wsum = __fadd_rn(wsum, unsat[q * R + r] ? weights[q] : 0.0f);
    }
    float spent = 0.0f;
    for (int q = 0; q < Q; ++q) {
      const float req = queue_mask[q] ? request[q * R + r] : 0.0f;
      const float w = unsat[q * R + r] ? weights[q] : 0.0f;
      const float inc = wsum > 0.0f
          ? __fdiv_rn(__fmul_rn(remaining, w), fmaxf(wsum, 1e-9f)) : 0.0f;
      float filled = __fadd_rn(deserved[q * R + r], inc);
      const bool hit = filled >= req;
      filled = fminf(filled, req);
      spent = __fadd_rn(spent, __fsub_rn(filled, deserved[q * R + r]));
      deserved[q * R + r] = filled;
      unsat[q * R + r] = unsat[q * R + r] && !hit;
    }
    remaining = fmaxf(__fsub_rn(remaining, spent), 0.0f);
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

// values f32[T, C] → out f32[S, C]; order i32[T], offsets i32[S + 1]: the
// rows of segment s by `base` are order[offsets[s] : offsets[s + 1]].
// threads (a multiple of 32, at most 1024) and G (runs per segment) come
// from the shapes (kernels/segment_sum.py · sum_shape); with G > 1,
// partial holds f64[S, G, C] and ticket i32[S], which is zeroed here.
extern "C" int kb_segment_sum(const int32_t* order, const int32_t* offsets,
                              const int32_t* seg, const float* values, int C, int S,
                              int threads, int G, float* out, double* partial,
                              int32_t* ticket, cudaStream_t stream) {
  if (S == 0 || C == 0) return 0;
  if (threads < 32 || threads > MAX_THREADS || (threads & 31) || G < 1) return -1;
  if (G > 1) {
    const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(int32_t) * (size_t)S, stream);
    if (err != cudaSuccess) return (int)err;
  }
  segment_sum_kernel<<<(unsigned)S * G, threads, 0, stream>>>(
      order, offsets, seg, values, C, G, out, partial, ticket);
  return (int)cudaGetLastError();
}

// dtype: 1 = int32 values, 2 = bool (one byte) values → out i32[S, C]
extern "C" int kb_segment_count(const int32_t* seg, const void* values, int dtype,
                                int64_t T, int C, int S, int32_t* out,
                                cudaStream_t stream) {
  if (S == 0 || C == 0) return 0;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)S * C, stream);
  if (err != cudaSuccess) return (int)err;
  if (T == 0) return 0;
  const int64_t want = (T + COUNT_THREADS - 1) / COUNT_THREADS;
  const int blocks = (int)(want < 8LL * sm_count() ? want : 8LL * sm_count());
  if (dtype == 1) {
    segment_count_kernel<int32_t><<<blocks, COUNT_THREADS, 0, stream>>>(
        seg, (const int32_t*)values, T, C, S, out);
  } else if (dtype == 2) {
    segment_count_kernel<uint8_t><<<blocks, COUNT_THREADS, 0, stream>>>(
        seg, (const uint8_t*)values, T, C, S, out);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int kb_waterfill(const float* weights, const float* request,
                            const float* total, const uint8_t* queue_mask, int Q,
                            int R, uint8_t* unsat, float* deserved,
                            cudaStream_t stream) {
  if (R > MAX_R) return -1;
  if (Q == 0 || R == 0) return 0;
  waterfill_kernel<<<1, MAX_R, 0, stream>>>(weights, request, total, queue_mask,
                                            Q, R, unsat, deserved);
  return (int)cudaGetLastError();
}
