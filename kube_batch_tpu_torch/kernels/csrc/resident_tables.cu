// K11 · resident label tables of the inter-pod affinity predicate.
//
// Replaces kube_batch_tpu/plugins/predicates.py · resident_podlabels,
// _resident_mask and resident_domain_labels, which XLA lowers to segment
// sums of f32[T, K] label rows by node (and, per topology key, by domain)
// followed by `> 0`:
//   Hb[n, k] = some resident of node n carries pod label k
//   Ab[n, k] = some resident of node n carries an anti term on label k
//   Hd[d, k] = some resident of domain d carries label k (every key)
//   Ad[d, l] = some resident of domain d carries a topology anti term on
//              label l under the key of d's column
// A resident is a real task that holds a node: allocated or pipelined
// (plus Releasing when `include_releasing`).
//
// Bound on this card: bytes.  The label rows are read once (T * (2K + K2)
// floats) and the tables written once; there is no arithmetic to speak
// of.  Design: presence is an OR of non-negative 0/1 values, exact in any
// order, so no sort by node (as K7's segment sums do) and no float sum is
// needed: one thread per (task, column) and a store of 1 for every present
// label.  Two threads that store 1 into the same byte race benignly: every
// store writes the same value.  The wrapper zeroes the tables first.
// Padded topology-key columns point at the dead domain row, exactly as the
// reference's loop over every key column does, so that row is reproduced
// bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool resident(int s, int node, bool real, bool rel) {
  // allocated statuses (1, 3, 4, 5), pipelined (2), releasing (6)
  bool held = (s >= 1 && s <= 5) || (rel && s == 6);
  return held && node >= 0 && real;
}

__global__ void resident_tables_kernel(
    const float* __restrict__ podlabels, const float* __restrict__ anti,
    const float* __restrict__ anti_topo, const int32_t* __restrict__ task_node,
    const int32_t* __restrict__ task_state, const uint8_t* __restrict__ task_mask,
    const int32_t* __restrict__ node_key_domain, const int32_t* __restrict__ term_key,
    const int32_t* __restrict__ term_label, int T, int K, int K2, int TK, int rel,
    uint8_t* __restrict__ Hb, uint8_t* __restrict__ Ab, uint8_t* __restrict__ Hd,
    uint8_t* __restrict__ Ad) {
  const int t = blockIdx.x * blockDim.y + threadIdx.y;
  if (t >= T) return;
  const int node = task_node[t];
  if (!resident(task_state[t], node, task_mask[t] != 0, rel != 0)) return;
  const int* dom = node_key_domain + (size_t)node * TK;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (podlabels[(size_t)t * K + k] > 0.f) {
      Hb[(size_t)node * K + k] = 1;
      for (int tk = 0; tk < TK; ++tk) Hd[(size_t)dom[tk] * K + k] = 1;
    }
    if (anti[(size_t)t * K + k] > 0.f) Ab[(size_t)node * K + k] = 1;
  }
  for (int j = threadIdx.x; j < K2; j += blockDim.x) {
    if (anti_topo[(size_t)t * K2 + j] > 0.f)
      Ad[(size_t)dom[term_key[j]] * K + term_label[j]] = 1;
  }
}

}  // namespace

// Hd / Ad may be null when TK == 0 (no topology terms).  Tables are
// zeroed by the caller.
extern "C" int kb_resident_tables(
    const float* podlabels, const float* anti, const float* anti_topo,
    const int32_t* task_node, const int32_t* task_state, const uint8_t* task_mask,
    const int32_t* node_key_domain, const int32_t* term_key, const int32_t* term_label,
    int T, int K, int K2, int TK, int include_releasing, uint8_t* Hb, uint8_t* Ab,
    uint8_t* Hd, uint8_t* Ad, cudaStream_t stream) {
  if (T == 0 || (K == 0 && K2 == 0)) return 0;
  dim3 block(32, 8);   // 32 columns x 8 tasks
  dim3 grid((T + 7) / 8);
  resident_tables_kernel<<<grid, block, 0, stream>>>(
      podlabels, anti, anti_topo, task_node, task_state, task_mask, node_key_domain,
      term_key, term_label, T, K, TK ? K2 : 0, TK, include_releasing, Hb, Ab, Hd, Ad);
  return (int)cudaGetLastError();
}
