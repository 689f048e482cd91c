// K7 · segment sums and the water-fill of queue shares, four entry points.
//
// Replaces the segment sums of the reference package — every J/Q/S sum
// and count of drf, proportion, gang and predicates
// (kube_batch_tpu/api/snapshot.py · count_per_job / sum_req_per_job and
// the jax.ops.segment_sum calls of plugins/drf.py, proportion.py,
// predicates.py), the port's single site being api/snapshot.py ·
// segment_sum — and ops/waterfill.py · waterfill_deserved, with the
// queue-request sum that feeds it (plugins/proportion.py ·
// queue_deserved).
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
// The water-fill: each resource column is filled on its own, so a warp
// takes a column and iterates it to its fixed point with no barrier of
// the block.  A column's state — deserved, request, the iteration's
// increments and the unsatisfied bits of its Q queues — sits in shared
// memory (in a global scratch the wrapper allocates once a column needs
// more than SMEM_LIMIT less the kernel's static shared memory, which
// kb_fill_static_smem reports), in blocks of 32 queues 33 words apart.  The
// element updates go a lane a queue, 32 queues at a time (the new
// unsatisfied word by ballot).  Both sums of an iteration (the weight of
// the unsatisfied queues and `spent`) go in blocks of 32 queues: lane b
// adds block b from 0 in queue order (the padding of 33 keeps both access
// patterns on 32 banks), then every lane adds the block sums from 0 in
// block order by shuffles —
// the order of XLA's float32 reduction on the CPU at these shapes, and of
// the plain version (kernels/segment_sum.py · _sum_queues); every other
// operation is the plain version's, separately rounded (__fmul_rn etc.;
// the build passes --fmad=false), so the kernel equals it bit for bit.
// The iteration is a function of the carry (deserved, remaining,
// unsatisfied), so a column stops at the first iteration that leaves its
// carry bitwise unchanged (__any_sync of the lanes' changes), or after
// Q + 1; the plain version stops at the same point.  Any R: columns loop
// over the warps, and kb_waterfill spreads them over blocks of up to
// FILL_WARPS warps.
//
// kb_queue_deserved is the fill fed by a queue sum in one launch: the
// blocks of kb_segment_sum (the same partition, so the sums are bitwise
// queue_request's), then the block that completes the last segment (a
// ticket after a __threadfence, as the G > 1 combine takes one) fills
// the [Q, R] sums.  Its tickets are a buffer the wrapper keeps, zero
// between calls: each is cleared by the block that takes it last, so the
// call is one launch and no memset.
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
// the call is bound by its launch and the wrapper's host time.  The fill
// is a chain of dependent float adds (2 · (32 + NB) an iteration and
// column) times the iterations to the fixed point; its first design, a
// thread a column walking all Q + 1 iterations and both sums over the
// queues in global memory, did O(Q^2) dependent accesses a column.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int CHUNK = 8;    // columns summed per pass over a segment's rows
constexpr int COUNT_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
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
// __threadfence) adds them in order g = 0, 1, ... and writes the sums,
// then clears the ticket.  Which block finishes last does not change
// that order.  Returns true (in every thread) in the block that wrote
// segment s's sums.
__device__ bool sum_segment(const int32_t* __restrict__ order,
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
  if (G == 1) return true;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket + s, 1) == G - 1;
    if (last) ticket[s] = 0;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const volatile double* p = partial + (int64_t)s * G * C;
  for (int c = threadIdx.x; c < C; c += B) {
    double v = 0.0;
    for (int k = 0; k < G; ++k) v += p[(int64_t)k * C + c];
    out[(int64_t)s * C + c] = (float)v;
  }
  return true;
}

__global__ void segment_sum_kernel(const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ seg,
                                   const float* __restrict__ values, int C, int G,
                                   float* __restrict__ out, double* __restrict__ partial,
                                   int32_t* __restrict__ ticket) {
  sum_segment(order, offsets, seg, values, C, G, out, partial, ticket);
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

// The water-fill.  `request` is read through L2 (__ldcg): in
// kb_queue_deserved other blocks of the launch have just written it.
struct Fill {
  const float* weights;    // f32[Q]
  const float* request;    // f32[Q, R]
  const float* total;      // f32[R]
  const uint8_t* mask;     // bool[Q]
  float* deserved;         // f32[Q, R]
  int Q, R;
};

// Queue q's place in a column's arrays: blocks of 32 queues, 33 words
// apart, so that lane k reading queue 32b + k and lane b reading queue
// 32b + k (for one k) both hit 32 different banks.
__device__ __forceinline__ int fill_slot(int q) { return (q >> 5) * 33 + (q & 31); }

// Σ over the lanes' block sums p (block b0 + i held by lane i), from `acc`
// in block order; every lane gets the result.
__device__ __forceinline__ float add_blocks(float acc, float p, int n) {
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, __shfl_sync(FULL, p, i));
  return acc;
}

// Block b's sum of x from 0 in queue order (its padding holds +0.0, which
// leaves a sum from +0.0 unchanged).
__device__ __forceinline__ float block_sum(const float* x, int b) {
  float p = 0.0f;
#pragma unroll
  for (int k = 0; k < 32; ++k) p = __fadd_rn(p, x[b * 33 + k]);
  return p;
}

// Column c of the fill, by one warp, to its fixed point.  wt: the
// weights; des, req, diff: f32[33 * NB] (diff holds each iteration's
// filled - deserved, +0.0 past Q); uns: u32[NB], bit k of word b for
// queue 32b + k.  The element updates go a lane a queue, 32 queues at a
// time; the two sums a lane a block, then across blocks by shuffles.
__device__ void fill_column(const Fill& a, int c, const float* wt, float* des, float* req,
                            float* diff, unsigned* uns, int NB, int lane) {
  const int Q = a.Q, R = a.R;
  for (int b = 0; b < NB; ++b) {
    const int q = b * 32 + lane;
    const bool m = q < Q && a.mask[q] != 0;
    req[b * 33 + lane] = m ? __ldcg(a.request + (int64_t)q * R + c) : 0.0f;
    des[b * 33 + lane] = 0.0f;
    diff[b * 33 + lane] = 0.0f;
    const unsigned bits = __ballot_sync(FULL, m);
    if (lane == 0) uns[b] = bits;
  }
  __syncwarp();
  float rem = a.total[c];
  for (int it = 0; it <= Q; ++it) {
    float wsum = 0.0f;
    for (int b0 = 0; b0 < NB; b0 += 32) {
      const int b = b0 + lane;
      float p = 0.0f;
      if (b < NB) {
        const unsigned bits = uns[b];
#pragma unroll
        for (int k = 0; k < 32; ++k) p = __fadd_rn(p, (bits >> k & 1u) ? wt[b * 33 + k] : 0.0f);
      }
      wsum = add_blocks(wsum, p, min(32, NB - b0));
    }
    const float div = fmaxf(wsum, 1e-9f);
    bool changed = false;
#pragma unroll 4
    for (int b = 0; b < NB; ++b) {
      const int q = b * 32 + lane, i = b * 33 + lane;
      const unsigned bits = uns[b];
      bool still = false;
      if (q < Q) {
        const bool u = bits >> lane & 1u;
        const float w = u ? wt[i] : 0.0f;
        const float inc = wsum > 0.0f ? __fdiv_rn(__fmul_rn(rem, w), div) : 0.0f;
        const float old = des[i], r = req[i];
        float f = __fadd_rn(old, inc);
        still = u && !(f >= r);
        f = fminf(f, r);
        diff[i] = __fsub_rn(f, old);
        changed |= __float_as_uint(f) != __float_as_uint(old);
        des[i] = f;
      }
      const unsigned keep = __ballot_sync(FULL, still);
      changed |= keep != bits;
      if (lane == 0) uns[b] = keep;
    }
    __syncwarp();
    float spent = 0.0f;
    for (int b0 = 0; b0 < NB; b0 += 32) {
      const int b = b0 + lane;
      spent = add_blocks(spent, b < NB ? block_sum(diff, b) : 0.0f, min(32, NB - b0));
    }
    const float next = fmaxf(__fsub_rn(rem, spent), 0.0f);
    changed |= __float_as_uint(next) != __float_as_uint(rem);
    rem = next;
    if (!__any_sync(FULL, changed)) break;
  }
  for (int q = lane; q < Q; q += 32) a.deserved[(int64_t)q * R + c] = des[fill_slot(q)];
  __syncwarp();
}

// Columns c0 .. c1 - 1 by the first W warps of the block.  `base` (shared
// memory or the block's global scratch) holds the weights, f32[33 * NB],
// then per warp f32[100 * NB]: deserved, request, diff, the unsatisfied
// words.
__device__ void fill_columns(const Fill& a, int c0, int c1, int W, float* base) {
  const int NB = (a.Q + 31) >> 5;
  for (int q = threadIdx.x; q < a.Q; q += blockDim.x) base[fill_slot(q)] = a.weights[q];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= W) return;
  float* st = base + 33 * NB + (int64_t)warp * 100 * NB;
  for (int c = c0 + warp; c < c1; c += W)
    fill_column(a, c, base, st, st + 33 * NB, st + 66 * NB,
                reinterpret_cast<unsigned*>(st + 99 * NB), NB, lane);
}

// Block x fills columns x·W .. x·W + W - 1; `scratch` (null: shared memory)
// holds block_floats floats a block.
__global__ void waterfill_kernel(Fill a, int W, float* scratch, int64_t block_floats) {
  extern __shared__ __align__(16) float fill_smem[];
  const int c0 = blockIdx.x * W;
  fill_columns(a, c0, min(a.R, c0 + W), W,
               scratch ? scratch + blockIdx.x * block_floats : fill_smem);
}

// The queue sums (as segment_sum_kernel, into a.request), then the block
// that completes the last of the S segments fills them with its first W
// warps.  ticket: i32[S + 1], zero between calls.
__global__ void queue_deserved_kernel(const int32_t* __restrict__ order,
                                      const int32_t* __restrict__ offsets,
                                      const int32_t* __restrict__ seg,
                                      const float* __restrict__ values, int G,
                                      double* __restrict__ partial,
                                      int32_t* __restrict__ ticket, Fill a, int W,
                                      float* scratch) {
  extern __shared__ __align__(16) float fill_smem[];
  __shared__ bool last;
  const int S = a.Q;
  float* sums = const_cast<float*>(a.request);
  if (!sum_segment(order, offsets, seg, values, a.R, G, sums, partial, ticket)) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket + S, 1) == S - 1;
    if (last) ticket[S] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  fill_columns(a, 0, a.R, W, scratch ? scratch : fill_smem);
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

// weights f32[Q], request f32[Q, R], total f32[R], queue_mask bool[Q] →
// deserved f32[Q, R]; W warps a block, ceil(R / W) blocks; smem bytes of
// dynamic shared memory a block, or (smem 0) scratch holding block_floats
// floats a block (kernels/segment_sum.py · fill_plan).
extern "C" int kb_waterfill(const float* weights, const float* request, const float* total,
                            const uint8_t* queue_mask, int Q, int R, float* deserved, int W,
                            int smem, float* scratch, int64_t block_floats,
                            cudaStream_t stream) {
  if (Q == 0 || R == 0) return 0;
  if (W < 1 || W > 32 || (smem == 0) == (scratch == nullptr)) return -1;
  const Fill a{weights, request, total, queue_mask, deserved, Q, R};
  waterfill_kernel<<<(R + W - 1) / W, 32 * W, smem, stream>>>(a, W, scratch, block_floats);
  return (int)cudaGetLastError();
}

// The static shared memory of the fill's kernels (fused 1:
// queue_deserved_kernel, whose sum phase holds some; 0: waterfill_kernel)
// into *bytes: without an opt-in, static and dynamic shared memory
// together must fit 48 KB, so the wrapper plans the dynamic part within
// 48 KB less this.
extern "C" int kb_fill_static_smem(int fused, int64_t* bytes) {
  cudaFuncAttributes attr{};
  const cudaError_t err = fused ? cudaFuncGetAttributes(&attr, queue_deserved_kernel)
                                : cudaFuncGetAttributes(&attr, waterfill_kernel);
  *bytes = (int64_t)attr.sharedSizeBytes;
  return (int)err;
}

// kb_segment_sum's operands with S = Q queues and C = R columns, summed
// into sums f32[Q, R] (partial f64[Q, G, R] when G > 1), then filled as
// kb_waterfill fills them into deserved, by W of the last block's
// `threads` / 32 warps (smem bytes of shared memory, or scratch).
// ticket: i32[Q + 1], zero between calls (each call leaves it zero).
extern "C" int kb_queue_deserved(const int32_t* order, const int32_t* offsets,
                                 const int32_t* seg, const float* values, const float* weights,
                                 const float* total, const uint8_t* queue_mask, int Q, int R,
                                 int threads, int G, float* sums, double* partial,
                                 int32_t* ticket, float* deserved, int W, int smem,
                                 float* scratch, cudaStream_t stream) {
  if (Q == 0 || R == 0) return 0;
  if (threads < 32 || threads > MAX_THREADS || (threads & 31) || G < 1 || W < 1
      || W > threads / 32 || (smem == 0) == (scratch == nullptr)) return -1;
  const Fill a{weights, sums, total, queue_mask, deserved, Q, R};
  queue_deserved_kernel<<<(unsigned)Q * G, threads, smem, stream>>>(
      order, offsets, seg, values, G, partial, ticket, a, W, scratch);
  return (int)cudaGetLastError();
}
