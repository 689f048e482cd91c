// K3 · resolve conflicts and apply placements, two entry points.
//
// Replaces kube_batch_tpu/ops/assignment.py · _segment_prefix and
// _resolve_conflicts (the per-node segmented prefix fit, one_per_node,
// the per-node anti-affinity serialize count) and the apply step of
// allocate_rounds (segment_sum of accepted requests into per-node deltas,
// node_future / node_idle / task_state / task_node updates, lines 421-431).
//
// Both kernels walk the proposers sorted by (node, rank) — the sort is a
// stable torch.sort outside the kernel, as XLA's sort is outside any
// kernel in the reference.  One thread owns one node's segment: it finds
// the segment start in the sorted order, walks it in rank order and
// writes only its own node's rows and its own segment's tasks, so there
// are no atomics and the result does not depend on scheduling.
//
// Precision: the reference takes ONE global float32 cumsum over the
// sorted requests and subtracts, which rounds once the running total
// passes 2**24 (memory is in bytes; cpu totals pass it at the flagship
// scale).  Here each segment's prefix, and each node's delta, is summed
// in float64 — exact for integer-valued requests below 2**53 — and the
// delta is rounded once to float32.  Kernel and plain version agree bit
// for bit on every world; they agree with the reference wherever its
// float32 sums are exact.
//
// Bound on this card: bytes.  Each sorted row is read once (perm, node
// id, [R] request) plus the node's [R] avail; resolve writes one byte per
// proposer, apply writes [R] floats per touched node and two ints per
// accepted task.  A segment is walked serially by one thread; segments
// are short because proposals are dealt round-robin across tied nodes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_R = 8;
constexpr int THREADS = 256;

__global__ void resolve_kernel(const int64_t* __restrict__ perm,
                               const int64_t* __restrict__ s_node,
                               const float* __restrict__ req,
                               const float* __restrict__ avail,
                               const float* __restrict__ eps,
                               const uint8_t* __restrict__ serialize,
                               int one_per_node, int T, int N, int R,
                               uint8_t* __restrict__ accept) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  const int64_t n = s_node[i];
  if (n >= N || (i > 0 && s_node[i - 1] == n)) return;  // not a segment start
  double before[MAX_R];
  float cap[MAX_R];
  for (int r = 0; r < R; ++r) {
    before[r] = 0.0;
    cap[r] = avail[n * R + r];
  }
  int participants = 0;
  for (int j = i; j < T && s_node[j] == n; ++j) {
    const int64_t t = perm[j];
    bool fit = true;
    for (int r = 0; r < R; ++r) {
      const float q = req[t * R + r];
      const double within = before[r] + (double)q;
      fit = fit && ((within <= (double)cap[r]) || (q < eps[r]));
      before[r] += (double)q;
    }
    bool acc = fit;
    if (one_per_node) {
      acc = acc && (j == i);
    } else if (serialize) {
      const bool part = serialize[t] && acc;
      acc = acc && (!part || participants == 0);
      participants += part ? 1 : 0;
    }
    accept[t] = acc ? 1 : 0;
  }
}

__global__ void apply_kernel(const int64_t* __restrict__ perm,
                             const int64_t* __restrict__ s_node,
                             const uint8_t* __restrict__ accept,
                             const float* __restrict__ req, int use_future,
                             int new_status, int T, int N, int R,
                             float* __restrict__ node_future,
                             float* __restrict__ node_idle,
                             int32_t* __restrict__ task_state,
                             int32_t* __restrict__ task_node) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  const int64_t n = s_node[i];
  if (n >= N || (i > 0 && s_node[i - 1] == n)) return;
  double delta[MAX_R];
  for (int r = 0; r < R; ++r) delta[r] = 0.0;
  bool any = false;
  for (int j = i; j < T && s_node[j] == n; ++j) {
    const int64_t t = perm[j];
    if (!accept[t]) continue;
    any = true;
    for (int r = 0; r < R; ++r) delta[r] += (double)req[t * R + r];
    task_state[t] = new_status;
    task_node[t] = (int32_t)n;
  }
  if (!any) return;
  for (int r = 0; r < R; ++r) {
    const float d = (float)delta[r];
    node_future[n * R + r] = __fsub_rn(node_future[n * R + r], d);
    if (!use_future) node_idle[n * R + r] = __fsub_rn(node_idle[n * R + r], d);
  }
}

}  // namespace

extern "C" int kb_resolve(const int64_t* perm, const int64_t* s_node, const float* req,
                          const float* avail, const float* eps,
                          const uint8_t* serialize, int one_per_node, int T, int N,
                          int R, uint8_t* accept, cudaStream_t stream) {
  if (R > MAX_R) return -1;
  if (T == 0) return 0;
  resolve_kernel<<<(T + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      perm, s_node, req, avail, eps, serialize, one_per_node, T, N, R, accept);
  return (int)cudaGetLastError();
}

extern "C" int kb_apply(const int64_t* perm, const int64_t* s_node,
                        const uint8_t* accept, const float* req, int use_future,
                        int new_status, int T, int N, int R, float* node_future,
                        float* node_idle, int32_t* task_state, int32_t* task_node,
                        cudaStream_t stream) {
  if (R > MAX_R) return -1;
  if (T == 0) return 0;
  apply_kernel<<<(T + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      perm, s_node, accept, req, use_future, new_status, T, N, R, node_future,
      node_idle, task_state, task_node);
  return (int)cudaGetLastError();
}
