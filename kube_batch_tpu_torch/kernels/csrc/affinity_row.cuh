// K10's row form: the inter-pod affinity predicate of ONE task p against
// one state's future-oriented resident tables (kernel K11's words), tested
// node by node where a kernel needs it, with nothing written per node.
//
// Replaces kube_batch_tpu/plugins/predicates.py · pod_affinity_row.  The
// row form reads one table set in both orientations: required affinity
// and anti-affinity against Hb, symmetry against Ab OR'ed over Ad at the
// node's domain of every topology key, the topology terms against Hd.
//
// row_prepare (one warp): p's words [aff | anti | labels | aff_topo |
// anti_topo] from the snapshot's kept task words, its two thresholds
// need - bootstrap (the waiver read from the term-exists words), and the
// list of p's topology terms (only those p names as affinity or
// anti-affinity), into shared memory.  row_cell (any thread, node n):
// the cell test of affinity_mask.cu · cell(), with node n's words read
// from K11's tables in registers, and only the words and terms p uses.
// Every count is a popcount of 0/1 words, so the test is exact.
//
// Included by affinity_mask.cu (the row and cell entries),
// victim_prefix.cu (kernel K5 tests node n inside its own launch) and
// preempt_scan.cu (kernel K6 tests the plan's node of a continuing step).

#pragma once

#include <cstdint>

namespace affinity_row {

constexpr int MAXW = 8;        // words per vocabulary: K, K2 <= 256
constexpr int MAXK2 = 32 * MAXW;

// The row operand (kernels/affinity.py · AffinityRow): the snapshot's task
// words u32[T, NW] (NW = 3 ceil(K/32) + 2 ceil(K2/32)), K11's future
// tables Hb, Ab [N, ceil(K/32)], Hd, Ad [D, ceil(K/32)] (null when K2 == 0)
// and term_exists, the snapshot's node_key_domain i32[N, TK] and topology
// term arrays, and p (int64, on the card).  TK = 0 when K2 == 0.
// task_words == nullptr: no operand.
struct Operand {
  const uint32_t* task_words;
  const uint32_t* Hb;
  const uint32_t* Ab;
  const uint32_t* Hd;
  const uint32_t* Ad;
  const uint32_t* exists;
  const int32_t* nkd;
  const int32_t* term_key;
  const int32_t* term_label;
  const int64_t* p;
  int K, K2, TK;
};

struct Shared {
  uint32_t tw[5 * MAXW];
  int32_t thr[2];
  int nterm;
  // p's topology terms: key << 10 | label << 2 | affinity << 1 | anti
  uint32_t term[MAXK2];
};

__device__ __forceinline__ int kw(int width) { return (width + 31) >> 5; }

__device__ __forceinline__ uint32_t bit(const uint32_t* words, int j) {
  return (words[j >> 5] >> (j & 31)) & 1u;
}

// One warp (all 32 lanes) fills `s` for task *o.p.
__device__ void prepare(const Operand& o, Shared& s) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int KW = kw(o.K), K2W = kw(o.K2), nw = 3 * KW + 2 * K2W;
  const uint32_t* tw = o.task_words + *o.p * nw;
  for (int w = lane; w < nw; w += 32) s.tw[w] = tw[w];
  int need = 0, boot = 0;
  if (lane < KW) {
    const uint32_t a = tw[lane];
    need = __popc(a);
    boot = __popc(a & tw[2 * KW + lane] & ~o.exists[lane]);
  }
  int need2 = 0, boot2 = 0, base = 0;
  for (int j0 = 0; j0 < o.K2; j0 += 32) {
    const int j = j0 + lane;
    uint32_t a = 0u, an = 0u, packed = 0u;
    if (j < o.K2) {
      a = bit(tw + 3 * KW, j);
      an = bit(tw + 3 * KW + K2W, j);
      if (a | an) {
        const int lab = o.term_label[j];
        packed = ((uint32_t)o.term_key[j] << 10) | ((uint32_t)lab << 2) | (a << 1) | an;
        if (a) {
          ++need2;
          boot2 += (int)(bit(tw + 2 * KW, lab) & (bit(o.exists, lab) ^ 1u));
        }
      }
    }
    const unsigned used = __ballot_sync(full, (a | an) != 0u);
    if (a | an) s.term[base + __popc(used & ((1u << lane) - 1u))] = packed;
    base += __popc(used);
  }
  need = __reduce_add_sync(full, need);
  boot = __reduce_add_sync(full, boot);
  need2 = __reduce_add_sync(full, need2);
  boot2 = __reduce_add_sync(full, boot2);
  if (lane == 0) {
    s.thr[0] = need - boot;
    s.thr[1] = need2 - boot2;
    s.nterm = base;
  }
}

// The cell (p, n) after `prepare` (and a barrier): feasible when p's
// required terms are met (bootstrap waived), no resident carries one of
// p's anti terms and no resident's anti term names p's labels.
__device__ __forceinline__ bool cell(const Operand& o, const Shared& s, int n) {
  const int KW = kw(o.K);
  const int32_t* dom = o.nkd + (int64_t)n * o.TK;
  int have = 0;
  uint32_t hit = 0u;
  for (int w = 0; w < KW; ++w) {
    const uint32_t a = s.tw[w], an = s.tw[KW + w], l = s.tw[2 * KW + w];
    if (a | an) {
      const uint32_t hb = o.Hb[(int64_t)n * KW + w];
      have += __popc(a & hb);
      hit |= an & hb;
    }
    if (l) {
      uint32_t sym = o.Ab[(int64_t)n * KW + w];
      for (int tk = 0; tk < o.TK; ++tk) sym |= o.Ad[(int64_t)dom[tk] * KW + w];
      hit |= l & sym;
    }
  }
  if (hit || have < s.thr[0]) return false;
  if (!o.K2) return true;
  int have2 = 0;
  for (int i = 0; i < s.nterm; ++i) {
    const uint32_t t = s.term[i];
    const int lab = (int)((t >> 2) & 0xffu);
    const uint32_t present = bit(o.Hd + (int64_t)dom[t >> 10] * KW, lab);
    if ((t & 1u) && present) return false;
    have2 += (int)(present & (t >> 1) & 1u);
  }
  return have2 >= s.thr[1];
}

}  // namespace affinity_row

// The row operand as a C entry takes it (victim_prefix.cu's and
// preempt_scan.cu's), Operand's fields in order: task_words, Hb, Ab, Hd,
// Ad, exists, nkd, term_key, term_label, p (row_p), K, K2, TK;
// row_task_words null: no affinity row.
#define KB_ROW_PARAMS                                                                     \
  const uint32_t *row_task_words, const uint32_t *row_Hb, const uint32_t *row_Ab,         \
      const uint32_t *row_Hd, const uint32_t *row_Ad, const uint32_t *row_exists,         \
      const int32_t *row_nkd, const int32_t *row_term_key, const int32_t *row_term_label, \
      const int64_t *row_p, int row_K, int row_K2, int row_TK
#define KB_ROW_OPERAND                                                                \
  const affinity_row::Operand row{row_task_words, row_Hb,   row_Ab,       row_Hd,         \
                                  row_Ad,         row_exists, row_nkd,    row_term_key,   \
                                  row_term_label, row_p,    row_K,        row_K2,         \
                                  row_K2 ? row_TK : 0}
