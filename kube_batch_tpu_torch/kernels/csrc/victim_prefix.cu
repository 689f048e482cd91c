// K5 · victim prefix: per node, the fewest victims whose release fits the
// preemptor, and the node the preemption step opens its plan on.
//
// Replaces kube_batch_tpu/ops/preemption.py · _min_victims_per_node
// (lines 80-112) and the feasible argmin node of choose_node (lines
// 219-235).
//
// Candidate victims arrive sorted by (node, sacrifice) — a stable
// torch.sort outside the kernel, as K3's is; non-victims carry node id N
// and sort last.  One block; each thread owns nodes n = tid, tid+THREADS,
// ...: it finds node n's segment by binary search, and unless the
// preemptor already fits the node's FutureIdle (k = 0) walks the segment
// in sacrifice order with a float64 running release, rounded once to
// float32 and added to FutureIdle, stopping at the first k whose release
// fits (k = BIG_K when none does).  Then a block reduction picks the
// lowest-index node among the feasible ones with the smallest k, exactly
// as jnp.argmax(feasible & (kk == min kk)) does (node 0 when none is
// feasible), and thread 0 reads that node's first victim — the argmin of
// sacrifice on it — and whether the preemptor fits it with no victim.
//
// Precision: the reference takes one global float32 cumsum; the float64
// prefix here is exact for integer-valued requests below 2**53 and rounds
// once, so it agrees with the reference wherever the reference's float32
// sums are exact (ROADMAP §C).
//
// Bound on this card: bytes — each victim row (position, node id, [R]
// request) is read at most once, plus the [N, R] FutureIdle and the node
// mask; the k of every node is written once.  N is a few thousand at
// most, so one block suffices; the walk stops at the first fitting k.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_R = 8;
constexpr int THREADS = 1024;
constexpr int BIG_K = 0x7fffffff / 4;

__device__ int64_t lower_bound(const int64_t* __restrict__ s, int64_t T,
                               int64_t key) {
  int64_t lo = 0, hi = T;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (s[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ bool fits_future(const float* __restrict__ preq,
                            const float* __restrict__ future_n,
                            const float* __restrict__ eps, int R) {
  bool ok = true;
  for (int r = 0; r < R; ++r) {
    ok = ok && ((preq[r] <= future_n[r]) || (preq[r] < eps[r]));
  }
  return ok;
}

__global__ void victim_prefix_kernel(const int64_t* __restrict__ perm,
                                     const int64_t* __restrict__ s_node,
                                     const float* __restrict__ req,
                                     const float* __restrict__ future,
                                     const float* __restrict__ preq,
                                     const float* __restrict__ eps,
                                     const uint8_t* __restrict__ ok, int64_t T,
                                     int N, int R, int32_t* __restrict__ k_out,
                                     int32_t* __restrict__ out) {
  __shared__ unsigned long long best[THREADS / 32];
  unsigned long long mine = ~0ull;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    int k = BIG_K;
    if (fits_future(preq, future + (int64_t)n * R, eps, R)) {
      k = 0;
    } else {
      double prefix[MAX_R];
      for (int r = 0; r < R; ++r) prefix[r] = 0.0;
      const int64_t start = lower_bound(s_node, T, n);
      for (int64_t j = start; j < T && s_node[j] == n; ++j) {
        const int64_t t = perm[j];
        bool fit = true;
        for (int r = 0; r < R; ++r) {
          prefix[r] += (double)req[t * R + r];
          const float avail = __fadd_rn(future[(int64_t)n * R + r], (float)prefix[r]);
          fit = fit && ((preq[r] <= avail) || (preq[r] < eps[r]));
        }
        if (fit) {
          k = (int)(j - start + 1);
          break;
        }
      }
    }
    k_out[n] = k;
    if (k < BIG_K && ok[n]) {
      const unsigned long long key = ((unsigned long long)k << 32) | (uint32_t)n;
      mine = key < mine ? key : mine;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xffffffffu, mine, off);
    mine = other < mine ? other : mine;
  }
  if ((threadIdx.x & 31) == 0) best[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long b = ~0ull;
    for (int w = 0; w < THREADS / 32; ++w) b = best[w] < b ? best[w] : b;
    const bool any = b != ~0ull;
    const int n = any ? (int)(b & 0xffffffffu) : 0;
    const int64_t start = lower_bound(s_node, T, n);
    const bool any_vic = start < T && s_node[start] == n;
    out[0] = n;
    out[1] = any ? 1 : 0;
    out[2] = any_vic ? (int32_t)perm[start] : 0;
    out[3] = any_vic ? 1 : 0;
    out[4] = fits_future(preq, future + (int64_t)n * R, eps, R) ? 1 : 0;
  }
}

}  // namespace

// out: [n_best, any_feasible, first victim on n_best (0 if none),
//       any victim on n_best, preemptor fits n_best with no victim]
extern "C" int kb_victim_prefix(const int64_t* perm, const int64_t* s_node,
                                const float* req, const float* future,
                                const float* preq, const float* eps,
                                const uint8_t* ok, int64_t T, int N, int R,
                                int32_t* k_out, int32_t* out,
                                cudaStream_t stream) {
  if (R > MAX_R) return -1;
  victim_prefix_kernel<<<1, THREADS, 0, stream>>>(perm, s_node, req, future, preq,
                                                  eps, ok, T, N, R, k_out, out);
  return (int)cudaGetLastError();
}
