// K11 · resident label tables of the inter-pod affinity predicate, as
// 32-bit words.
//
// Replaces kube_batch_tpu/plugins/predicates.py · resident_podlabels,
// _resident_mask and resident_domain_labels, and the Hb.any(0) of
// bootstrap_mask, which XLA lowers to segment sums of f32[T, K] label
// rows by node (and, per topology key, by domain) followed by `> 0`:
//   Hb[n, k] = some resident of node n carries pod label k
//   Ab[n, k] = some resident of node n carries an anti term on label k
//   Hd[d, k] = some resident of domain d carries label k (every key)
//   Ad[d, l] = some resident of domain d carries a topology anti term on
//              label l under the key of d's column
//   term_exists[k] = Hb[:, k].any()
// A resident is a real task that holds a node: allocated or pipelined
// (the future set), plus Releasing (the `_now` set, which the Idle pass
// reads on the anti / symmetry side).
//
// Bound on this card: bytes.  Each task's state, node and mask are read
// once, a resident's label / anti / anti-topology words once (K10's task
// words, kept on the snapshot: 12 bytes a row at K = K2 = 32, where the
// float rows were 384), and the tables written once; there is no
// arithmetic to speak of.
// Design: presence is an OR of bits, exact in any order, so kernel and
// plain version agree bit for bit whatever order the atomics land in.
//   * One thread per task reads the row once and ORs it into the `_now`
//     set (when asked for) and, unless the task is Releasing, into the
//     future set — both resident sets from one launch.
//   * Node tables: atomicOr on the node's words (about ten residents a
//     node, little contention).
//   * Domain tables and term_exists: a few hundred domains collect
//     thousands of residents each (a zone about 16,000), which would
//     serialize on global atomics.  Each block ORs into its own copy in
//     shared memory (D * words(K) words a set: 1 KB at D = 256) and
//     flushes every nonzero word with one global atomicOr.  Tables too
//     large for 48 KB of shared memory take the global atomics directly.
//   * The C entry zeroes the one buffer holding every table with one
//     cudaMemsetAsync, then launches once.
// Padded topology-key columns point at the dead domain row, exactly as
// the reference's loop over every key column does, so that row is
// reproduced bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_WORDS = 12288;   // 48 KB

struct Dims {
  int T, N, D, KW, K2W, TK, now, domains;
  __host__ __device__ int nw() const { return 3 * KW + 2 * K2W; }
  __host__ __device__ int node_sets() const { return now ? 4 : 2; }
  __host__ __device__ int dom_sets() const { return domains ? (now ? 4 : 2) : 0; }
  // words of the domain tables and term_exists, in buffer order
  __host__ __device__ int tail_words() const { return dom_sets() * D * KW + KW; }
};

// Buffer layout, every table words(K) words a row:
//   node:   Hb, Ab [, Hb_now, Ab_now]      each N rows
//   domain: Hd, Ad [, Hd_now, Ad_now]      each D rows (when domains)
//   term_exists                            one row
template <bool SMEM>
__global__ void __launch_bounds__(THREADS) resident_words_kernel(
    Dims d, const uint32_t* __restrict__ task_words, const int32_t* __restrict__ task_node,
    const int32_t* __restrict__ task_state, const uint8_t* __restrict__ task_mask,
    const int32_t* __restrict__ nkd, const int32_t* __restrict__ term_key,
    const int32_t* __restrict__ term_label, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* const node = out;
  uint32_t* const tail = out + (size_t)d.node_sets() * d.N * d.KW;
  uint32_t* const tab = SMEM ? smem : tail;   // domain tables, then term_exists
  const int tail_words = d.tail_words();
  const size_t dset = (size_t)d.D * d.KW;     // words of one domain set
  uint32_t* const exists = tab + d.dom_sets() * dset;
  if (SMEM) {
    for (int i = threadIdx.x; i < tail_words; i += THREADS) smem[i] = 0u;
    __syncthreads();
  }
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int n = t < d.T ? task_node[t] : -1;
  const int s = t < d.T ? task_state[t] : 0;
  const bool placed = n >= 0 && t < d.T && task_mask[t];
  // allocated statuses (1, 3, 4, 5) and pipelined (2); releasing (6)
  const bool fut = placed && s >= 1 && s <= 5;
  const bool now = d.now && placed && (fut || s == 6);
  if (fut || now) {
    const uint32_t* row = task_words + (size_t)t * d.nw();
    const size_t nset = (size_t)d.N * d.KW;
    uint32_t* const hb = node + (size_t)n * d.KW;
    for (int w = 0; w < d.KW; ++w) {
      const uint32_t an = row[d.KW + w], lab = row[2 * d.KW + w];
      if (fut) {
        if (lab) {
          atomicOr(hb + w, lab);
          atomicOr(exists + w, lab);
        }
        if (an) atomicOr(hb + nset + w, an);
      }
      if (now) {
        if (lab) atomicOr(hb + 2 * nset + w, lab);
        if (an) atomicOr(hb + 3 * nset + w, an);
      }
    }
    if (d.domains) {
      const int* dom = nkd + (size_t)n * d.TK;
      for (int tk = 0; tk < d.TK; ++tk) {
        uint32_t* const hd = tab + (size_t)dom[tk] * d.KW;
        for (int w = 0; w < d.KW; ++w) {
          const uint32_t lab = row[2 * d.KW + w];
          if (!lab) continue;
          if (fut) atomicOr(hd + w, lab);
          if (now) atomicOr(hd + 2 * dset + w, lab);
        }
      }
      for (int w = 0; d.TK && w < d.K2W; ++w) {   // no key column: no term lands
        uint32_t bits = row[3 * d.KW + d.K2W + w];
        while (bits) {
          const int j = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          const int lab = term_label[j];
          uint32_t* const ad = tab + dset + (size_t)dom[term_key[j]] * d.KW + (lab >> 5);
          const uint32_t bit = 1u << (lab & 31);
          if (fut) atomicOr(ad, bit);
          if (now) atomicOr(ad + 2 * dset, bit);
        }
      }
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < tail_words; i += THREADS)
      if (smem[i]) atomicOr(tail + i, smem[i]);
  }
}

}  // namespace

// task_words u32[T, 3 KW + 2 K2W] (K10's [aff | anti | labels | aff_topo
// | anti_topo]); out u32 in the layout above, zeroed here.  nkd,
// term_key and term_label are read only with `domains`.
extern "C" int kb_resident_words(
    const uint32_t* task_words, const int32_t* task_node, const int32_t* task_state,
    const uint8_t* task_mask, const int32_t* nkd, const int32_t* term_key,
    const int32_t* term_label, int T, int N, int D, int KW, int K2W, int TK,
    int with_now, int domains, uint32_t* out, cudaStream_t stream) {
  Dims d{T, N, D, KW, K2W, TK, with_now, domains};
  const size_t words = (size_t)d.node_sets() * N * KW + d.tail_words();
  int err = (int)cudaMemsetAsync(out, 0, words * sizeof(uint32_t), stream);
  if (err || T == 0 || KW == 0) return err;
  const int blocks = (T + THREADS - 1) / THREADS;
  const int tail = d.tail_words();
  if (tail <= SMEM_WORDS) {
    resident_words_kernel<true><<<blocks, THREADS, tail * sizeof(uint32_t), stream>>>(
        d, task_words, task_node, task_state, task_mask, nkd, term_key, term_label, out);
  } else {
    resident_words_kernel<false><<<blocks, THREADS, 0, stream>>>(
        d, task_words, task_node, task_state, task_mask, nkd, term_key, term_label, out);
  }
  return (int)cudaGetLastError();
}
