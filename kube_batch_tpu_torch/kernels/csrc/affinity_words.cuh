// K10's words form: the inter-pod affinity predicate of one task row
// against one node row, both as 32-bit words (kernels/affinity.py ·
// AffinityWords, built by affinity_mask.cu · kb_affinity_words), tested
// cell by cell inside the kernel that needs the cell.
//
// Replaces, cell by cell, kube_batch_tpu/plugins/predicates.py ·
// pod_affinity_predicate: a cell (t, n) is feasible when
// popcount(aff_t & Hb_n) >= thr[t, 0], popcount(aff_topo_t & present_n)
// >= thr[t, 1], and anti_t & Hb_anti_n, labels_t & sym_n and anti_topo_t &
// present_now_n are all 0.  Every count is a popcount of 0/1 words, so the
// test is exact.
//
// A row of words holds five groups, [aff | anti | labels | aff_topo |
// anti_topo] for a task and [Hb | Hb_anti | sym | present | present_now]
// for a node, of KW, KW, KW, K2W and K2W words.  A kernel instantiated for
// W words a group (1, 2 or 8: `words_case`) holds a row padded to 5·W
// words, zero past a vocabulary's own words.
//
// Included by propose.cu (kernel K2 tests the cells of its tiles) and
// failure_counts.cu (kernel K4 tests the cells it tallies).

#pragma once

#include <cstdint>

namespace affinity_words {

// Affinity words of one node or task row, groups [0..5) of W words each.
template <int W>
struct Words {
  uint32_t v[W > 0 ? 5 * W : 1];
};

// Words a row holds in memory.
__host__ __device__ __forceinline__ int row_words(int KW, int K2W) { return 3 * KW + 2 * K2W; }

// The instantiation a call takes for vocabularies of KW and K2W words (0:
// no words).
__host__ __device__ __forceinline__ int words_case(bool has_words, int KW, int K2W) {
  if (!has_words) return 0;
  const int w = KW > K2W ? KW : K2W;
  return w <= 1 ? 1 : (w <= 2 ? 2 : 8);
}

// Word w of group g of a row (0 past the group's own words).
template <int W>
__device__ __forceinline__ uint32_t word_at(int KW, int K2W, const uint32_t* row, int g,
                                            int w) {
  const bool topo = g >= 3;
  if (w >= (topo ? K2W : KW)) return 0u;
  return row[topo ? 3 * KW + (g - 3) * K2W + w : g * KW + w];
}

// The 5·W words of a row starting at `p` (device or shared memory).
template <int W>
__device__ __forceinline__ void load_words_at(int KW, int K2W, const uint32_t* p,
                                              Words<W>& out) {
#pragma unroll
  for (int g = 0; g < 5; ++g)
#pragma unroll
    for (int w = 0; w < W; ++w) out.v[g * W + w] = word_at<W>(KW, K2W, p, g, w);
}

// The cell test on a task row's words `tw` (5·W) and its thresholds
// against a node row's words.
template <int W>
__device__ __forceinline__ bool words_ok(const uint32_t* tw, int thr0, int thr1,
                                         const Words<W>& nw) {
  int have = 0, have2 = 0;
  uint32_t hit = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    have += __popc(tw[w] & nw.v[w]);
    hit |= (tw[W + w] & nw.v[W + w]) | (tw[2 * W + w] & nw.v[2 * W + w])
         | (tw[4 * W + w] & nw.v[4 * W + w]);
    have2 += __popc(tw[3 * W + w] & nw.v[3 * W + w]);
  }
  return hit == 0 && have >= thr0 && have2 >= thr1;
}

}  // namespace affinity_words
