// K6 · the per-step scans of the preemption loop, two entry points.
//
// Replaces the [T]- and [T, N]-wide reductions of the step body of
// kube_batch_tpu/ops/preemption.py · preemption_rounds (lines 149-260):
//
//   kb_preempt_open (no plan in progress — a preemptor is chosen this step)
//     p_new               argmin of rank over eligible tasks, lowest index
//                         on ties, index 0 when none is eligible (jnp.argmin)
//     any_eligible
//     any_victim_possible ∃ t: allocated in the snapshot and in the live
//                         state, real, not a provisional victim
//     any_direct_fit      ∃ t eligible, n real and ready:
//                         fits(req[t], FutureIdle[n]) — an early-exit
//                         [T, N, R] reduction of fp32 compares
//   kb_preempt_continue (a plan is open on node n)
//     v, any_victim       argmin of sacrifice (= −rank) over candidate
//                         victims on node n, lowest index on ties
//
// On an opening step the victim on the chosen node comes from K5, which
// already walks that node's victims in sacrifice order; and the direct-fit
// test only matters when no plan is open.  So each step launches one of
// the two kernels, once.
//
// One block each.  Each thread folds its strided rows into a packed 64-bit
// key (value << 32 | index), so the minimum key is the argmin with the
// lowest index on ties; warp shuffles and one shared-memory pass finish
// the reduction.  The direct-fit scan gives each thread whole eligible
// rows and stops every thread once any cell fits (a shared flag).  Nothing
// is summed, so the result does not depend on scheduling.
//
// Bound on this card: bytes when a direct fit is found early (each [T]
// input read once, the eligible rows' requests and the [N, R] FutureIdle);
// operations (2·R compares per cell) when no cell fits and every eligible
// row meets every ready node.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_R = 8;
constexpr int THREADS = 1024;
constexpr unsigned long long NONE = ~0ull;

__device__ bool allocated(int32_t s) {
  // ALLOCATED, BINDING, BOUND, RUNNING (api/types.py · ALLOCATED_STATUSES)
  return s == 1 || s == 3 || s == 4 || s == 5;
}

__device__ unsigned long long block_min(unsigned long long v, unsigned long long* shared) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long b = NONE;
  for (int w = 0; w < THREADS / 32; ++w) b = shared[w] < b ? shared[w] : b;
  __syncthreads();
  return b;
}

__global__ void preempt_open_kernel(
    int T, int N, int R, const int32_t* __restrict__ rank,
    const uint8_t* __restrict__ elig, const int32_t* __restrict__ snap_state,
    const int32_t* __restrict__ live_state, const uint8_t* __restrict__ task_mask,
    const uint8_t* __restrict__ prov, const float* __restrict__ req,
    const float* __restrict__ future, const uint8_t* __restrict__ node_ok,
    const float* __restrict__ eps, int32_t* __restrict__ out) {
  __shared__ unsigned long long warp_min[THREADS / 32];
  __shared__ int found;
  unsigned long long key = NONE;
  int possible = 0;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    if (elig[t]) {
      const unsigned long long k = ((unsigned long long)(uint32_t)rank[t] << 32) | (uint32_t)t;
      key = k < key ? k : key;
    }
    possible |= allocated(snap_state[t]) && allocated(live_state[t]) &&
                task_mask[t] && !prov[t];
  }
  const unsigned long long p = block_min(key, warp_min);
  const int any_possible = __syncthreads_or(possible);
  if (threadIdx.x == 0) found = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += THREADS) {
    if (!elig[t]) continue;
    if (*(volatile int*)&found) break;
    for (int m = 0; m < N; ++m) {
      if (!node_ok[m]) continue;
      bool ok = true;
      for (int r = 0; r < R; ++r) {
        const float q = req[(int64_t)t * R + r];
        ok = ok && ((q <= future[(int64_t)m * R + r]) || (q < eps[r]));
      }
      if (ok) {
        *(volatile int*)&found = 1;
        break;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    out[0] = p == NONE ? 0 : (int32_t)(p & 0xffffffffu);
    out[1] = p == NONE ? 0 : 1;
    out[2] = any_possible ? 1 : 0;
    out[3] = found;
  }
}

__global__ void preempt_continue_kernel(
    int T, const int32_t* __restrict__ rank, const uint8_t* __restrict__ victims,
    const int32_t* __restrict__ task_node, int n, int32_t* __restrict__ out) {
  __shared__ unsigned long long warp_min[THREADS / 32];
  unsigned long long key = NONE;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    if (victims[t] && task_node[t] == n) {
      // sacrifice = −rank; T−1−rank orders the same way and is ≥ 0
      const unsigned long long k = ((unsigned long long)(uint32_t)(T - 1 - rank[t]) << 32) | (uint32_t)t;
      key = k < key ? k : key;
    }
  }
  const unsigned long long v = block_min(key, warp_min);
  if (threadIdx.x == 0) {
    out[0] = v == NONE ? 0 : (int32_t)(v & 0xffffffffu);
    out[1] = v == NONE ? 0 : 1;
  }
}

}  // namespace

// out: [p_new, any_eligible, any_victim_possible, any_direct_fit]
extern "C" int kb_preempt_open(int T, int N, int R, const int32_t* rank,
                               const uint8_t* elig, const int32_t* snap_state,
                               const int32_t* live_state, const uint8_t* task_mask,
                               const uint8_t* prov, const float* req,
                               const float* future, const uint8_t* node_ok,
                               const float* eps, int32_t* out, cudaStream_t stream) {
  if (R > MAX_R) return -1;
  preempt_open_kernel<<<1, THREADS, 0, stream>>>(
      T, N, R, rank, elig, snap_state, live_state, task_mask, prov, req, future,
      node_ok, eps, out);
  return (int)cudaGetLastError();
}

// out: [victim on n, any victim on n]
extern "C" int kb_preempt_continue(int T, const int32_t* rank, const uint8_t* victims,
                                   const int32_t* task_node, int n, int32_t* out,
                                   cudaStream_t stream) {
  preempt_continue_kernel<<<1, THREADS, 0, stream>>>(T, rank, victims, task_node, n, out);
  return (int)cudaGetLastError();
}
