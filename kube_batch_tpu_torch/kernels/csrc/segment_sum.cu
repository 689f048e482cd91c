// K7 · segment sums and the water-fill of queue shares, two entry points.
//
// Replaces the segment sums of the reference package — every J/Q/S sum
// and count of drf, proportion, gang and predicates
// (kube_batch_tpu/api/snapshot.py · count_per_job / sum_req_per_job and
// the jax.ops.segment_sum calls of plugins/drf.py, proportion.py,
// predicates.py), the port's single site being api/snapshot.py ·
// segment_sum — and ops/waterfill.py · waterfill_deserved.
//
// kb_segment_sum: rows arrive sorted by segment id (a stable torch.sort
// of int32 ids outside the kernel, as K3's and K5's sorts are).  One block
// owns one segment: it finds the segment's row range by binary search,
// each thread sums rows lo+tid, lo+tid+blockDim, ... in that order, up to
// 8 columns per pass, and a fixed-shape tree in shared memory combines the
// threads.  The block size is a power of two near the mean segment length
// (32 to 1024), so a few long segments (queues) still get many threads.
// The order of every add depends only on the shapes and the segment's
// rows, never on scheduling, so the result is the same on every run;
// there are no atomics.  Floats accumulate in
// float64 and are rounded once to float32; integers accumulate in int64
// and are written as int32 counts.  On integer-valued data below 2**53
// every order of summation gives the exact sum, so the kernel equals
// index_add_ bit for bit there.
//
// kb_waterfill: one thread per resource column runs the Q+1 iterations of
// the water-fill; the columns are independent.  The queue sums go left to
// right in float32 and every operation is the plain version's, separately
// rounded (__fmul_rn etc.; the build passes --fmad=false), so the kernel
// equals the plain version bit for bit.
//
// Bound on this card: bytes — each row's segment id, its position in the
// sort and its C values are read once, each segment's C sums written
// once; the adds (T·C in float64) are far below the float64 rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int CHUNK = 8;    // columns summed per pass over a segment's rows
constexpr int MAX_R = 32;

__device__ int64_t lower_bound(const int32_t* __restrict__ s_seg, int64_t T,
                               int32_t key) {
  int64_t lo = 0, hi = T;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (s_seg[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename In, typename Acc, typename Out>
__global__ void segment_sum_kernel(const int32_t* __restrict__ s_seg,
                                   const int64_t* __restrict__ perm,
                                   const In* __restrict__ values, int64_t T,
                                   int C, Out* __restrict__ out) {
  const int32_t s = blockIdx.x;
  __shared__ int64_t range[2];
  __shared__ Acc partial[MAX_THREADS];
  if (threadIdx.x == 0) {
    range[0] = lower_bound(s_seg, T, s);
    range[1] = lower_bound(s_seg, T, s + 1);
  }
  __syncthreads();
  const int64_t lo = range[0], hi = range[1];
  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    const int width = min(CHUNK, C - c0);
    Acc acc[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) acc[c] = 0;
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const In* row = values + perm[i] * C + c0;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        if (c < width) acc[c] += (Acc)row[c];
      }
    }
    for (int c = 0; c < width; ++c) {
      partial[threadIdx.x] = acc[c];
      __syncthreads();
      for (int w = blockDim.x / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) partial[threadIdx.x] += partial[threadIdx.x + w];
        __syncthreads();
      }
      if (threadIdx.x == 0) out[(int64_t)s * C + c0 + c] = (Out)partial[0];
      __syncthreads();
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

}  // namespace

// dtype: 0 = float32 values (float64 sums, float32 out),
//        1 = int32 values (int64 sums, int32 out)
extern "C" int kb_segment_sum(const int32_t* s_seg, const int64_t* perm,
                              const void* values, int dtype, int64_t T, int C,
                              int S, void* out, cudaStream_t stream) {
  if (S == 0 || C == 0) return 0;
  // a power of two from 32 to 1024, about the mean segment length
  int threads = 32;
  while (threads < MAX_THREADS && (int64_t)threads * S < T) threads *= 2;
  if (dtype == 0) {
    segment_sum_kernel<float, double, float><<<S, threads, 0, stream>>>(
        s_seg, perm, (const float*)values, T, C, (float*)out);
  } else if (dtype == 1) {
    segment_sum_kernel<int32_t, int64_t, int32_t><<<S, threads, 0, stream>>>(
        s_seg, perm, (const int32_t*)values, T, C, (int32_t*)out);
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
