// K3 · resolve conflicts and apply placements, two entry points.
//
// kb_resolve replaces kube_batch_tpu/ops/assignment.py · _resolve_conflicts
// whole, with its _segment_prefix: the (node, rank) sort of the round's
// proposers, the per-node segmented prefix fit, one_per_node, the per-node
// serialize count and the global rank watermark; it also adds the
// acceptances the watermark cancelled to a device counter.  kb_apply
// replaces the apply step of allocate_rounds (segment_sum of accepted
// requests into per-node deltas, node_future / node_idle / task_state /
// task_node updates, lines 421-431).
//
// kb_resolve: one launch of one thread-block cluster.  C blocks of 1,024
// threads (C = ceil(T / 1,024) up to 16, where the card places such a
// cluster at the shared memory it needs, else 8); block b keeps the sorted
// positions [b*S, (b+1)*S) in its shared memory (S = ceil(T / C) <= 8,192
// rows: a u32 code and a u32 row id, double-buffered, 16 B a row).  The
// blocks read and write each other's shared memory (distributed shared
// memory) and meet at the cluster's hardware barrier, so the phases below
// need no second launch and no device-memory round trip; values every
// block needs from every other (digit totals, scan aggregates, the
// watermark) are read by one warp, a lane a block, and combined by
// shuffles.  Past what a cluster keeps (T > 131,072 on an H100) the same
// kernel keeps the rows in a device-memory scratch the caller passes
// (16 B a row, read through L2), any number of rows in a cluster of 16
// (kb_resolve_plan says which, and how much scratch): there a warp's digit
// counters are u32 and each row's acceptance flags a word of the sort's
// free buffer, so a thread owns as many rows as T needs.
//
//   1. Sort into the order of torch.sort(node_key * T + rank, stable=True):
//      node, then rank, then row, node_key = N for an inactive row (last).
//      First the rows in (rank, row) order: when the ranks are a
//      permutation of [0, T) (rank_fn's dense ranks: every auction round),
//      row r goes to position rank[r] (one scatter; a position no row took
//      shows a shared or out-of-range rank); otherwise the rows, in index
//      order, are radix-sorted by rank.  Then a stable radix sort by
//      node_key.  Each sort is least significant digit first, 8 bits a
//      pass, stable, and skips digits constant over every row (AND and OR
//      of the keys).  A pass: each warp counts its rows' digits (rows of
//      one digit find each other with __match_any_sync; warp-private u16
//      counters, u32 from the scratch), the block publishes its digit totals; after a barrier
//      every block reads every block's totals, which give each digit's
//      start and the block's place among the rows of the digit; each row
//      is written to the block that owns its new position; a barrier.  A
//      run of one node may hold every row: nothing here depends on run
//      lengths.
//   2. The segmented exclusive prefix of the requests in float64, all R
//      dims at once.  A thread owns up to 8 consecutive sorted rows
//      (ceil(T / 16,384) from the scratch); the (started a segment, sum since the last start) pairs combine by warp
//      shuffles, across warps in shared memory and across blocks through
//      the cluster.  Requests are integer-valued below 2^53 (millicores,
//      bytes, counts), so every float64 sum of them is exact and the order
//      in which the scan adds them changes nothing: the prefix equals the
//      plain version's float64 cumsum bit for bit.  The fit of a row is
//      then all dims of (before + q <= avail[node]) | (q < eps), as in the
//      reference, with before in float64 (the reference's one float32
//      cumsum rounds once its running total passes 2^24).
//   3. one_per_node keeps each run's first row; else with a serialize
//      mask, a second segmented scan (of serialize & fit) keeps a
//      participant only when no earlier row of its run is one.
//   4. The watermark: the min rank over active & ~accept, per block and
//      then over the cluster; kept = accept & (rank < watermark); each
//      block adds its cancelled count to cancelled[0] (one atomic).
// Outputs: perm (sorted position -> row) and s_node (sorted position ->
// node_key) as int64 for kb_apply, and kept (bool[T]).
//
// Bound on this card: bytes (the proposers' rows in and out, their
// requests, their nodes' avail).  What cost before was one thread walking
// a node's whole run serially (two dependent loads a row, 0.5 us a row on
// a long run) and the glue around it (a library sort, about fifteen
// launches); this is one launch whose time is the sort's passes (rows a
// block, hence up to 16 blocks) and a dozen cluster barriers.
//
// kb_apply: one launch over the sorted positions, APPLY_ROWS consecutive
// positions a thread (one: the fewest dependent loads a thread), as
// kb_resolve's threads own theirs.  Each accepted
// row writes its own task_state and task_node.  Its request joins its
// node's float64 delta: a node's run that starts and ends in one thread
// lands there; runs that cross threads meet in a segmented scan by warp
// shuffles and across the block's warps, and land at the thread holding
// their end; runs that cross blocks add their block's part to a
// persistent float64 accumulator with atomics (exact: the requests are
// integer-valued below 2^53, so the order of the adds changes nothing),
// and each block the run spans then adds to the run's arrival word; the
// block that completes it lands the node and clears its entries
// (ApplyScratch).  A block with no accepted row skips the scan.  Each delta is rounded once to float32 and subtracted
// from node_future (and node_idle), as the plain version does, bit for
// bit.  No thread walks a run: the time does not depend on the longest
// run (the parent design walked each node's run in one thread, 0.5 us a
// row on a long run).  Bound: bytes (the sorted order and node ids, the
// accepted rows' requests and state, the touched nodes' rows).

#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_R = 8;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int GROUPS = THREADS / RADIX;       // warps of a digit, in groups
constexpr int GROUP_WARPS = WARPS / GROUPS;
constexpr int MAX_CLUSTER = 16;
constexpr int ROWS_MAX = 8192;                // rows a block keeps in shared memory
constexpr int ROWS_TARGET = 1024;             // rows a block takes while the cluster can grow
constexpr int ROW_BYTES = 16;                 // two codes and two ids
constexpr int APPLY_THREADS = 256;
constexpr int APPLY_WARPS = APPLY_THREADS / 32;
constexpr int APPLY_ROWS = 1;                 // consecutive sorted positions a thread
constexpr int APPLY_W = MAX_R + 1;            // the sums of a node and their count
constexpr uint32_t EMPTY = 0xffffffffu;       // a rank-order slot no row took

struct ResolveArgs {
  const int32_t* prop_node;
  const uint8_t* active;
  const int32_t* rank;
  const float* req;
  const float* avail;
  const float* eps;
  const uint8_t* serialize;   // bool[T] or null
  uint32_t* scratch;          // u32[4][T]: the rows' codes and ids, where they live in device memory
  int one_per_node, T, N, R, S;
  int64_t* perm;
  int64_t* s_node;
  uint8_t* kept;
  unsigned long long* cancelled;  // i64 counter or null
};

// Count: a warp's per-digit counter, u16 where the rows live in shared
// memory (at most 8,192 a block), u32 from the scratch (any number)
template <typename Count>
struct SharedT {
  Count wcnt[WARPS][RADIX];        // per warp and digit: count, then offset
  uint32_t gsum[2][GROUPS][RADIX];
  uint32_t dsum[RADIX];            // this block's count of each digit (read by the cluster)
  uint32_t base[RADIX];            // sorted position of the block's first row of each digit
  uint32_t warp_tmp[WARPS];
  uint32_t code_and[2], code_or[2];  // of the block's ranks [0] and node keys [1] (read by the cluster)
  uint32_t bad;                    // a rank out of range or shared (read by the cluster)
  uint32_t fold[6];                // cluster folds, one word each
  double wsum[WARPS][MAX_R];
  int wflag[WARPS];
  double agg[2][MAX_R];            // the block's (started, sum) of scan 0 and 1 (read by the cluster)
  int agg_started[2];
  double carry[MAX_R];
  unsigned min_rank;               // read by the cluster
  unsigned cancelled;
};
template <bool SCRATCH>
using Shared = SharedT<std::conditional_t<SCRATCH, uint32_t, uint16_t>>;

// The rows being sorted, two buffers of a u32 code and a u32 row id.
// `code` and `id` start at this block's first position: in its shared
// memory, or (SCRATCH) in the device-memory scratch, whose arrays from
// position 0 are `all_code` and `all_id`.
struct Rows {
  uint32_t* code[2];
  uint32_t* id[2];
  uint32_t* all_code[2];
  uint32_t* all_id[2];
};

template <bool SCRATCH>
__device__ __forceinline__ Rows rows_of(uint8_t* smem, uint32_t* scratch, int S, int T, int r0) {
  Rows r;
  for (int k = 0; k < 2; ++k) {
    if (SCRATCH) {
      r.all_code[k] = scratch + (int64_t)k * T;
      r.all_id[k] = scratch + (int64_t)(2 + k) * T;
      r.code[k] = r.all_code[k] + r0;
      r.id[k] = r.all_id[k] + r0;
    } else {
      r.code[k] = reinterpret_cast<uint32_t*>(smem) + (int64_t)k * S;
      r.id[k] = reinterpret_cast<uint32_t*>(smem) + (int64_t)(2 + k) * S;
      r.all_code[k] = r.all_id[k] = nullptr;
    }
  }
  return r;
}

// A row word another block may have written: from L2 in the scratch.
template <bool SCRATCH>
__device__ __forceinline__ uint32_t ld(const uint32_t* p) {
  return SCRATCH ? __ldcg(p) : *p;
}

// Row word at sorted position `pos` of buffer `dst`, in the block that
// owns the position (or the scratch).
template <bool SCRATCH>
__device__ __forceinline__ void put(const cg::cluster_group& cl, uint32_t* const (&own)[2],
                                    uint32_t* const (&all)[2], int dst, uint32_t pos, int S,
                                    uint32_t v) {
  if (SCRATCH) {
    all[dst][pos] = v;
  } else {
    const uint32_t q = pos / (uint32_t)S;
    cl.map_shared_rank(own[dst], q)[pos - q * (uint32_t)S] = v;
  }
}

// Exclusive prefix over threads 0 .. RADIX-1 of one value each (other
// threads pass 0 and get 0).  Every thread of the block calls it.
__device__ uint32_t digit_exclusive(uint32_t v, uint32_t* warp_tmp) {
  constexpr int DW = RADIX / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31 && warp < DW) warp_tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < DW ? warp_tmp[lane] : 0u;
    uint32_t wi = w;
    for (int o = 1; o < DW; o <<= 1) {
      const uint32_t t = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < DW) warp_tmp[lane] = wi - w;
  }
  __syncthreads();
  return warp < DW ? warp_tmp[warp] + incl - v : 0u;
}

// A u32 word of every block's shared memory (`slot`), folded by `op`
// over the cluster: warp 0 reads a block a lane.  `out` is a word of this
// block's own, used by this fold only.  Every thread of the block calls
// it and gets the result.
template <typename Op>
__device__ uint32_t cluster_fold(const cg::cluster_group& cl, uint32_t* slot, int C,
                                 uint32_t identity, Op op, uint32_t* out) {
  if (threadIdx.x < 32) {
    uint32_t v = (int)threadIdx.x < C ? *cl.map_shared_rank(slot, threadIdx.x) : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
    if (threadIdx.x == 0) *out = v;
  }
  __syncthreads();
  return *out;
}

struct And { __device__ uint32_t operator()(uint32_t x, uint32_t y) const { return x & y; } };
struct Or { __device__ uint32_t operator()(uint32_t x, uint32_t y) const { return x | y; } };
struct Min { __device__ uint32_t operator()(uint32_t x, uint32_t y) const { return x < y ? x : y; } };

// One stable pass over the 8-bit digit at `shift` across the cluster:
// rows move from buffer `src` of every block to buffer `dst` of the
// block owning their new position.  Every thread of every block calls it.
template <bool SCRATCH>
__device__ void cluster_pass(const cg::cluster_group& cl, const Rows& b, int src, int dst,
                             int shift, int rows, int S, int C, int brank,
                             Shared<SCRATCH>& sh) {
  using Count = std::remove_reference_t<decltype(sh.wcnt[0][0])>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int per_warp = (((S + WARPS - 1) / WARPS) + 31) & ~31;
  const int lo = warp * per_warp, hi = min(rows, lo + per_warp);
  const uint32_t* cin = b.code[src];
  const uint32_t* iin = b.id[src];
  uint32_t* w0 = reinterpret_cast<uint32_t*>(&sh.wcnt[0][0]);
  for (int i = tid; i < (int)(sizeof(sh.wcnt) / 4); i += THREADS) w0[i] = 0;
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const uint32_t d = i < hi ? (ld<SCRATCH>(cin + i) >> shift) & 0xffu : RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    if (i < hi && (peers & below) == 0)
      sh.wcnt[warp][d] = (Count)(sh.wcnt[warp][d] + __popc(peers));
    __syncwarp();
  }
  __syncthreads();
  // warp offsets within each digit: thread (g, d) over its group's warps,
  // then the digit threads over the groups
  const int d = tid & (RADIX - 1), g = tid / RADIX;
  uint32_t run = 0;
  for (int w = g * GROUP_WARPS; w < (g + 1) * GROUP_WARPS; ++w) {
    const uint32_t c = sh.wcnt[w][d];
    sh.wcnt[w][d] = (Count)run;
    run += c;
  }
  sh.gsum[0][g][d] = run;
  __syncthreads();
  if (tid < RADIX) {
    uint32_t total = 0;
    for (int q = 0; q < GROUPS; ++q) {
      const uint32_t c = sh.gsum[0][q][tid];
      sh.gsum[0][q][tid] = total;
      total += c;
    }
    sh.dsum[tid] = total;
  }
  __syncthreads();
  for (int w = g * GROUP_WARPS; w < (g + 1) * GROUP_WARPS; ++w)
    sh.wcnt[w][d] = (Count)(sh.wcnt[w][d] + sh.gsum[0][g][d]);
  cl.sync();   // every block's digit totals are published
  // this digit's rows in blocks before this one, and its total: the
  // groups read the blocks in turn
  uint32_t before = 0, total = 0;
  for (int q = g; q < C; q += GROUPS) {
    const uint32_t c = *cl.map_shared_rank(&sh.dsum[d], (unsigned)q);
    total += c;
    if (q < brank) before += c;
  }
  sh.gsum[0][g][d] = before;
  sh.gsum[1][g][d] = total;
  __syncthreads();
  uint32_t all = 0;
  before = 0;
  if (tid < RADIX) {
    for (int q = 0; q < GROUPS; ++q) {
      before += sh.gsum[0][q][tid];
      all += sh.gsum[1][q][tid];
    }
  }
  const uint32_t start = digit_exclusive(all, sh.warp_tmp);
  if (tid < RADIX) sh.base[tid] = start + before;
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool ok = i < hi;
    uint32_t c = 0, v = 0, dd = RADIX;
    if (ok) {
      c = ld<SCRATCH>(cin + i);
      v = ld<SCRATCH>(iin + i);
      dd = (c >> shift) & 0xffu;
    }
    const unsigned peers = __match_any_sync(FULL, dd);
    const uint32_t lrank = __popc(peers & below);
    if (ok) {
      const uint32_t pos = sh.base[dd] + sh.wcnt[warp][dd] + lrank;
      put<SCRATCH>(cl, b.code, b.all_code, dst, pos, S, c);
      put<SCRATCH>(cl, b.id, b.all_id, dst, pos, S, v);
    }
    __syncwarp();
    if (ok && lrank == 0) sh.wcnt[warp][dd] = (Count)(sh.wcnt[warp][dd] + __popc(peers));
    __syncwarp();
  }
  cl.sync();   // every row is in place; every block is done reading totals
}

// Segmented exclusive scan across the cluster.  Each thread passes the
// aggregate of its run (started: a segment starts in the run; s: the sum
// since the run's last start, or over the run) and gets the sum flowing
// into its run from earlier rows of the same segment.  `W` sums are
// scanned together; `slot` names the published aggregate.  Every thread
// of every block calls it.
template <typename Sh>
__device__ void seg_exclusive(const cg::cluster_group& cl, int started, double (&s)[MAX_R],
                              int W, int slot, int brank, Sh& sh) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int f = started;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int fu = __shfl_up_sync(FULL, f, o);
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < W) {
        const double su = __shfl_up_sync(FULL, s[r], o);
        if (lane >= o && !f) s[r] += su;
      }
    }
    if (lane >= o) f |= fu;
  }
  if (lane == 31) {
    sh.wflag[warp] = f;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r)
      if (r < W) sh.wsum[warp][r] = s[r];
  }
  // lane exclusive, in place: the inclusive value of the lane before
  const int ef = __shfl_up_sync(FULL, f, 1);
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < W) {
      const double t = __shfl_up_sync(FULL, s[r], 1);
      s[r] = lane > 0 ? t : 0.0;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // the same scan over the warps' aggregates: exclusive per warp, and
    // the block's aggregate published for the cluster
    int wf = sh.wflag[lane];
    double ws[MAX_R];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) ws[r] = r < W ? sh.wsum[lane][r] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int fu = __shfl_up_sync(FULL, wf, o);
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) {
        if (r < W) {
          const double su = __shfl_up_sync(FULL, ws[r], o);
          if (lane >= o && !wf) ws[r] += su;
        }
      }
      if (lane >= o) wf |= fu;
    }
    const int xf = __shfl_up_sync(FULL, wf, 1);
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < W) {
        const double t = __shfl_up_sync(FULL, ws[r], 1);
        sh.wsum[lane][r] = lane > 0 ? t : 0.0;
        if (lane == 31) sh.agg[slot][r] = ws[r];
      }
    }
    sh.wflag[lane] = lane > 0 ? xf : 0;
    if (lane == 31) sh.agg_started[slot] = wf;
  }
  cl.sync();   // every block's aggregate is published
  if (warp == 0) {
    // lane q < brank takes block q's aggregate; the same scan over the
    // lanes leaves the carry into this block at lane brank - 1
    int qf = 0;
    double qs[MAX_R];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) qs[r] = 0.0;
    if (lane < brank) {
      qf = *cl.map_shared_rank(&sh.agg_started[slot], (unsigned)lane);
#pragma unroll
      for (int r = 0; r < MAX_R; ++r)
        if (r < W) qs[r] = *cl.map_shared_rank(&sh.agg[slot][r], (unsigned)lane);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int fu = __shfl_up_sync(FULL, qf, o);
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) {
        if (r < W) {
          const double su = __shfl_up_sync(FULL, qs[r], o);
          if (lane >= o && !qf) qs[r] += su;
        }
      }
      if (lane >= o) qf |= fu;
    }
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < W && lane == (brank > 0 ? brank - 1 : 0)) sh.carry[r] = brank > 0 ? qs[r] : 0.0;
    }
  }
  __syncthreads();
  // block carry, then the warp's prefix, then the lane's
  const int wf = sh.wflag[warp];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < W) {
      double p = sh.carry[r];
      p = wf ? sh.wsum[warp][r] : p + sh.wsum[warp][r];
      s[r] = ef && lane > 0 ? s[r] : p + s[r];
    }
  }
  __syncthreads();   // carry and warp prefixes are read before the next scan
}

// A thread's rows' acceptance and serialize-participant flags (row lo + j
// is j): bits of two registers where a thread owns at most 8 rows (the
// rows in shared memory), else a word a row in the scratch's free buffer,
// so a thread may own as many rows as T needs.
template <bool SCRATCH>
struct Flags {
  uint64_t acc = 0u, part = 0u;
  __device__ __forceinline__ void set(int j, bool ac, bool pa) {
    acc |= (uint64_t)ac << j;
    part |= (uint64_t)pa << j;
  }
  __device__ __forceinline__ bool accepted(int j) const { return (acc >> j) & 1u; }
  __device__ __forceinline__ bool participant(int j) const { return (part >> j) & 1u; }
  __device__ __forceinline__ void drop(int j) { acc &= ~(1ull << j); }
};
template <>
struct Flags<true> {
  uint32_t* f;   // bit 0 accepted, bit 1 participant
  __device__ __forceinline__ void set(int j, bool ac, bool pa) {
    f[j] = (ac ? 1u : 0u) | (pa ? 2u : 0u);
  }
  __device__ __forceinline__ bool accepted(int j) const { return f[j] & 1u; }
  __device__ __forceinline__ bool participant(int j) const { return (f[j] >> 1) & 1u; }
  __device__ __forceinline__ void drop(int j) { f[j] &= ~1u; }
};

template <bool SCRATCH>
struct Sorted {
  const uint32_t* node;   // sorted position -> node_key, from the block's first position
  const uint32_t* id;     // sorted position -> row
  uint32_t prev_node;     // the node_key at the block's position -1 (if any)
  bool first_block;

  __device__ __forceinline__ uint32_t node_at(int i) const { return ld<SCRATCH>(node + i); }
  __device__ __forceinline__ uint32_t row_at(int i) const { return ld<SCRATCH>(id + i); }
  __device__ __forceinline__ bool starts(int i, uint32_t n) const {
    if (i == 0) return first_block || prev_node != n;
    return node_at(i - 1) != n;
  }
};

// The stable passes over the digits in which `varying` has a bit, from
// buffer `cur`; returns the buffer that holds the result.
template <bool SCRATCH>
__device__ int sort_passes(const cg::cluster_group& cl, const Rows& b, int cur, uint32_t varying,
                           int rows, int S, int C, int brank, Shared<SCRATCH>& sh) {
  for (int shift = 0; shift < 32; shift += 8) {
    if (((varying >> shift) & 0xffu) == 0u) continue;
    cluster_pass<SCRATCH>(cl, b, cur, cur ^ 1, shift, rows, S, C, brank, sh);
    cur ^= 1;
  }
  return cur;
}

// The digits in which the block codes published in slot k of code_and /
// code_or differ, over the cluster (after a cl.sync).
template <typename Sh>
__device__ __forceinline__ uint32_t varying_bits(const cg::cluster_group& cl, int k, int C,
                                                 Sh& sh) {
  return cluster_fold(cl, &sh.code_and[k], C, FULL, And(), &sh.fold[1 + 2 * k]) ^
         cluster_fold(cl, &sh.code_or[k], C, 0u, Or(), &sh.fold[2 + 2 * k]);
}

template <typename Sh>
__device__ __forceinline__ void publish_bits(uint32_t c_and, uint32_t c_or, int k, Sh& sh) {
  c_and = __reduce_and_sync(FULL, c_and);
  c_or = __reduce_or_sync(FULL, c_or);
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(&sh.code_and[k], c_and);
    atomicOr(&sh.code_or[k], c_or);
  }
}

template <bool SCRATCH>
__global__ void __launch_bounds__(THREADS, 1) resolve_kernel(ResolveArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Shared<SCRATCH> sh;
  const cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int brank = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  const int S = a.S, T = a.T, N = a.N, R = a.R;
  const int r0 = brank * S;
  const int rows = max(0, min(S, T - r0));
  const Rows b = rows_of<SCRATCH>(smem, a.scratch, S, T, r0);

  if (tid == 0) {
    for (int r = 0; r < 2; ++r) {
      sh.code_and[r] = FULL;
      sh.code_or[r] = 0u;
    }
    sh.bad = 0u;
    sh.min_rank = FULL;
    sh.cancelled = 0u;
  }
  // 0. the rows in (rank, row) order.  Where the ranks are a permutation
  // of [0, T) (rank_fn's dense ranks), that order is one scatter away:
  // row r to position rank[r].  A position no row took means two rows
  // share a rank (or a rank is out of range): then the rows, in index
  // order, are radix-sorted by rank, which is stable.
  for (int i = tid; i < rows; i += THREADS) b.id[0][i] = EMPTY;
  cl.sync();
  uint32_t bad = 0u;
  for (int i = tid; i < rows; i += THREADS) {
    const uint32_t rk = (uint32_t)a.rank[r0 + i];
    if (rk >= (uint32_t)T) {
      bad = 1u;
      continue;
    }
    put<SCRATCH>(cl, b.id, b.all_id, 0, rk, S, (uint32_t)(r0 + i));
  }
  cl.sync();
  for (int i = tid; i < rows; i += THREADS)
    if (ld<SCRATCH>(b.id[0] + i) == EMPTY) bad = 1u;
  bad = __reduce_or_sync(FULL, bad);
  if (lane == 0 && bad) atomicOr(&sh.bad, 1u);
  cl.sync();
  int cur = 0;
  if (cluster_fold(cl, &sh.bad, C, 0u, Or(), &sh.fold[0])) {
    uint32_t c_and = FULL, c_or = 0u;
    for (int i = tid; i < rows; i += THREADS) {
      const uint32_t rk = (uint32_t)a.rank[r0 + i];
      b.code[0][i] = rk;
      b.id[0][i] = (uint32_t)(r0 + i);
      c_and &= rk;
      c_or |= rk;
    }
    publish_bits(c_and, c_or, 0, sh);
    cl.sync();
    cur = sort_passes<SCRATCH>(cl, b, 0, varying_bits(cl, 0, C, sh), rows, S, C, brank, sh);
  }

  // 1. then a stable sort by node_key: node, then rank, then row, the
  // order of torch.sort(node_key * T + rank, stable=True); node_key = N
  // for an inactive row (last)
  {
    uint32_t c_and = FULL, c_or = 0u;
    for (int i = tid; i < rows; i += THREADS) {
      const uint32_t row = ld<SCRATCH>(b.id[cur] + i);
      const uint32_t key = a.active[row] ? (uint32_t)a.prop_node[row] : (uint32_t)N;
      b.code[cur][i] = key;
      c_and &= key;
      c_or |= key;
    }
    publish_bits(c_and, c_or, 1, sh);
    cl.sync();
    cur = sort_passes<SCRATCH>(cl, b, cur, varying_bits(cl, 1, C, sh), rows, S, C, brank, sh);
  }
  Sorted<SCRATCH> so;
  so.node = b.code[cur];
  so.id = b.id[cur];
  so.first_block = brank == 0;
  so.prev_node = brank == 0 ? 0u
                 : SCRATCH ? ld<SCRATCH>(b.all_code[cur] + r0 - 1)
                           : cl.map_shared_rank(b.code[cur], (unsigned)(brank - 1))[S - 1];

  // 2. the segmented prefix of the requests, and the fit
  const int k = (S + THREADS - 1) / THREADS;   // rows a thread (<= 8 in shared memory)
  const int lo = min(rows, tid * k), hi = min(rows, lo + k);
  int started = 0;
  double s[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) s[r] = 0.0;
  for (int i = lo; i < hi; ++i) {
    const uint32_t node = so.node_at(i);
    if (so.starts(i, node)) {
      started = 1;
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) s[r] = 0.0;
    }
    if (node < (uint32_t)N) {
      const float* q = a.req + (int64_t)so.row_at(i) * R;
#pragma unroll
      for (int r = 0; r < MAX_R; ++r)
        if (r < R) s[r] += (double)q[r];
    }
  }
  seg_exclusive(cl, started, s, R, 0, brank, sh);
  Flags<SCRATCH> fl;
  if constexpr (SCRATCH) fl.f = b.code[cur ^ 1] + lo;   // the sort's free buffer
  for (int i = lo; i < hi; ++i) {
    const uint32_t node = so.node_at(i);
    const bool st = so.starts(i, node);
    if (st) {
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) s[r] = 0.0;
    }
    bool fit = false, part = false;
    if (node < (uint32_t)N) {
      const uint32_t row = so.row_at(i);
      const float* q = a.req + (int64_t)row * R;
      const float* av = a.avail + (int64_t)node * R;
      fit = true;
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) {
        if (r < R) {
          const float qr = q[r];
          fit = fit && ((s[r] + (double)qr <= (double)av[r]) || (qr < a.eps[r]));
          s[r] += (double)qr;
        }
      }
      if (a.one_per_node) fit = fit && st;
      part = fit && !a.one_per_node && a.serialize && a.serialize[row];
    }
    fl.set(i - lo, fit, part);
  }

  // 3. at most one serialize participant per node: the earlier rows' count
  if (!a.one_per_node && a.serialize) {
    int st_any = 0;
    double cnt[MAX_R];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) cnt[r] = 0.0;
    for (int i = lo; i < hi; ++i) {
      if (so.starts(i, so.node_at(i))) {
        st_any = 1;
        cnt[0] = 0.0;
      }
      cnt[0] += fl.participant(i - lo) ? 1.0 : 0.0;
    }
    seg_exclusive(cl, st_any, cnt, 1, 1, brank, sh);
    for (int i = lo; i < hi; ++i) {
      const int j = i - lo;
      if (so.starts(i, so.node_at(i))) cnt[0] = 0.0;
      const bool pj = fl.participant(j);
      if (pj && cnt[0] > 0.0) fl.drop(j);
      cnt[0] += pj ? 1.0 : 0.0;
    }
  }

  // 4. the watermark: the best rank among rejected proposers
  unsigned mine = FULL;
  for (int i = lo; i < hi; ++i) {
    if (so.node_at(i) < (uint32_t)N && !fl.accepted(i - lo)) {
      const uint32_t rk = (uint32_t)a.rank[so.row_at(i)];
      mine = rk < mine ? rk : mine;
    }
  }
  mine = __reduce_min_sync(FULL, mine);
  if (lane == 0) atomicMin(&sh.min_rank, mine);
  cl.sync();
  const unsigned wm = cluster_fold(cl, &sh.min_rank, C, FULL, Min(), &sh.fold[5]);
  unsigned cancelled = 0u;
  for (int i = lo; i < hi; ++i) {
    const uint32_t node = so.node_at(i);
    const uint32_t row = so.row_at(i);
    const bool acc = fl.accepted(i - lo);
    bool keep = false;
    if (acc) {
      keep = (uint32_t)a.rank[row] < wm;
      cancelled += keep ? 0u : 1u;
    }
    a.perm[r0 + i] = (int64_t)row;
    a.s_node[r0 + i] = (int64_t)node;
    a.kept[row] = keep ? 1 : 0;
  }
  if (a.cancelled) {
    cancelled = __reduce_add_sync(FULL, cancelled);
    if (lane == 0 && cancelled) atomicAdd(&sh.cancelled, cancelled);
    __syncthreads();
    if (tid == 0 && sh.cancelled) atomicAdd(a.cancelled, (unsigned long long)sh.cancelled);
  }
  cl.sync();   // no block leaves while another may read its shared memory
}

struct ApplyArgs {
  const int64_t* perm;     // sorted position -> row
  const int64_t* s_node;   // sorted position -> node (N and above: inactive)
  const uint8_t* accept;   // bool[T] by row
  const float* req;        // f32[T, R]
  int use_future, new_status;
  int64_t T;
  int N, R;
  float* node_future;
  float* node_idle;
  int32_t* task_state;
  int32_t* task_node;
};

// kb_apply's persistent scratch, zero between calls (each run that spans
// blocks clears its own entries once it lands): per node the float64
// sums of its accepted requests and their count (APPLY_W words a node),
// and an arrival word.  The blocks a run spans add to the arrival word's
// high half: the block where the run starts 1 + its index, each block it
// passes 1, the block where it ends -(its index); a block whose part of
// the run has an accepted row adds 1 to the low half too.  The high half
// is 0 exactly when every one of them has added: that block lands the
// node if the low half counts a part with sums, and clears the entries.
struct ApplyScratch {
  double* acc;                    // f64[N, APPLY_W]
  unsigned long long* arrivals;   // u64[N]
};

// The accepted rows counted in v (its element R).
__device__ __forceinline__ double count_of(const ApplyArgs& a, const double (&v)[APPLY_W]) {
  double count = 0.0;
#pragma unroll
  for (int r = 0; r < APPLY_W; ++r)
    if (r == a.R) count = v[r];
  return count;
}

// Node n's delta, rounded once to float32, off node_future (and
// node_idle) when one of its rows was accepted (v[R] counts them).
__device__ __forceinline__ void land(const ApplyArgs& a, int64_t n, const double (&v)[APPLY_W]) {
  if (count_of(a, v) == 0.0) return;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < a.R) {
      const float d = (float)v[r];
      a.node_future[n * a.R + r] = __fsub_rn(a.node_future[n * a.R + r], d);
      if (!a.use_future) a.node_idle[n * a.R + r] = __fsub_rn(a.node_idle[n * a.R + r], d);
    }
  }
}

// This block's part `v` of node n's run, which spans blocks: its sums
// join the scratch, then the block adds `count` to the run's arrival
// word (ApplyScratch); the block that completes it lands the node and
// clears its entries.
__device__ __forceinline__ void arrive(const ApplyArgs& a, const ApplyScratch& sc, int64_t n,
                                       const double (&v)[APPLY_W], int W, int count) {
  double* acc = sc.acc + n * APPLY_W;
  unsigned long long add = (unsigned long long)(unsigned)count << 32;   // count mod 2^32
  if (count_of(a, v) > 0.0) {
#pragma unroll
    for (int r = 0; r < APPLY_W; ++r)
      if (r < W) atomicAdd(acc + r, v[r]);
    __threadfence();   // the sums before the arrival
    add += 1ull;
  }
  const unsigned long long now = atomicAdd(sc.arrivals + n, add) + add;
  if ((now >> 32) != 0ull || now == 0ull) return;   // not complete, or no sums
  sc.arrivals[n] = 0ull;
  __threadfence();
  double sum[APPLY_W];
#pragma unroll
  for (int r = 0; r < APPLY_W; ++r) {
    sum[r] = r < W ? __ldcg(acc + r) : 0.0;
    if (r < W) acc[r] = 0.0;
  }
  land(a, n, sum);
}

__device__ __forceinline__ int64_t node_at(const ApplyArgs& a, int64_t i) {
  const int64_t n = a.s_node[i];
  return n < a.N ? n : a.N;
}

__global__ void __launch_bounds__(APPLY_THREADS) apply_kernel(ApplyArgs a, ApplyScratch sc) {
  __shared__ double w_sum[APPLY_WARPS][APPLY_W];
  __shared__ int w_flag[APPLY_WARPS];
  __shared__ double s_incl[APPLY_THREADS][APPLY_W];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = a.R + 1;
  const int64_t T = a.T, N = a.N;
  const int64_t b0 = (int64_t)blockIdx.x * APPLY_THREADS * APPLY_ROWS;
  const int64_t bend = min(T, b0 + (int64_t)APPLY_THREADS * APPLY_ROWS);
  const int64_t lo = min(bend, b0 + (int64_t)tid * APPLY_ROWS);
  const int64_t hi = min(bend, lo + (int64_t)APPLY_ROWS);

  // 1. the thread's rows, in runs of one node: each accepted row writes
  // its state and node; a run that starts and ends here lands at once;
  // one that started before this thread and ends here (the head) waits
  // for the scan; the last run, when it goes on past this thread, is
  // what the thread hands the scan
  double cur[APPLY_W], head[APPLY_W];
#pragma unroll
  for (int r = 0; r < APPLY_W; ++r) cur[r] = head[r] = 0.0;
  // the rows' nodes, task rows and acceptance first: independent loads
  int64_t nodes[APPLY_ROWS], rows[APPLY_ROWS];
  bool acc[APPLY_ROWS];
#pragma unroll
  for (int j = 0; j < APPLY_ROWS; ++j) {
    nodes[j] = lo + j < hi ? node_at(a, lo + j) : N;
    rows[j] = lo + j < hi ? a.perm[lo + j] : 0;
  }
  const int64_t before = lo > 0 && lo < hi ? node_at(a, lo - 1) : -1;
  const int64_t after = hi < T && lo < hi ? node_at(a, hi) : -1;
  // the node of the row before this block: a run that has it came from
  // an earlier block
  const int64_t before_block = b0 > 0 ? node_at(a, b0 - 1) : -1;
#pragma unroll
  for (int j = 0; j < APPLY_ROWS; ++j) acc[j] = nodes[j] < N && a.accept[rows[j]];
  int64_t node = N, head_node = N;
  bool starts = true, head_open = false;
#pragma unroll
  for (int j = 0; j < APPLY_ROWS; ++j) {
    if (lo + j >= hi) continue;   // past the rows: the rest are too
    const int64_t n = nodes[j];
    if (j == 0 || n != node) {
      if (j > 0) {   // the run before row j ends in this thread
        if (starts) {
          if (node < N) land(a, node, cur);
        } else {
          head_open = true;
          head_node = node;
#pragma unroll
          for (int r = 0; r < APPLY_W; ++r) head[r] = cur[r];
        }
      }
#pragma unroll
      for (int r = 0; r < APPLY_W; ++r) cur[r] = 0.0;
      node = n;
      starts = j > 0 || before != n;
    }
    if (acc[j]) {
      const int64_t t = rows[j];
#pragma unroll
      for (int r = 0; r < APPLY_W; ++r)
        cur[r] += r < a.R ? (double)a.req[t * a.R + r] : r == a.R ? 1.0 : 0.0;
      a.task_state[t] = a.new_status;
      a.task_node[t] = (int32_t)n;
    }
  }
  const bool open_end = lo < hi && after == node;
  if (lo < hi && !open_end) {   // the last run ends in this thread too
    if (starts) {
      if (node < N) land(a, node, cur);
    } else {
      head_open = true;
      head_node = node;
#pragma unroll
      for (int r = 0; r < APPLY_W; ++r) head[r] = cur[r];
    }
  }

  // 2. a segmented inclusive scan over the block's threads of (the last
  // run starts here, its sum so far): by warp shuffles, then the warps'
  // aggregates in shared memory.  Sums of integer-valued requests below
  // 2^53 are exact in float64 in any order.  A block where no row is
  // accepted adds nothing to any run and skips it.
  bool mine = false;
#pragma unroll
  for (int j = 0; j < APPLY_ROWS; ++j) mine = mine || acc[j];
  double v[APPLY_W];
#pragma unroll
  for (int r = 0; r < APPLY_W; ++r) v[r] = open_end ? cur[r] : 0.0;
  if (__syncthreads_or(mine)) {
    int f = open_end ? (int)starts : 1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int fu = __shfl_up_sync(FULL, f, o);
#pragma unroll
      for (int r = 0; r < APPLY_W; ++r) {
        if (r < W) {   // W is the same in every lane
          const double vu = __shfl_up_sync(FULL, v[r], o);
          if (lane >= o && !f) v[r] += vu;
        }
      }
      if (lane >= o) f |= fu;
    }
    if (lane == 31) {
      w_flag[warp] = f;
#pragma unroll
      for (int r = 0; r < APPLY_W; ++r) w_sum[warp][r] = v[r];
    }
    __syncthreads();
    if (!f) {   // the run flows in from earlier warps: their aggregates back to a start
      for (int w = warp - 1; w >= 0; --w) {
#pragma unroll
        for (int r = 0; r < APPLY_W; ++r)
          if (r < W) v[r] += w_sum[w][r];
        if (w_flag[w]) break;
      }
    }
#pragma unroll
    for (int r = 0; r < APPLY_W; ++r) s_incl[tid][r] = v[r];
    __syncthreads();
    if (head_open && tid > 0) {   // the head's part of its run before this thread
#pragma unroll
      for (int r = 0; r < APPLY_W; ++r) head[r] += s_incl[tid - 1][r];
    }
  }

  // 3. the head's run ends in this thread: it lands here when it started
  // in this block; otherwise this block's part joins the run's float64
  // sum in the scratch and the block ends the run's count.  The block's
  // last run, when it goes on into the next block, adds its part here and
  // starts (or passes on) the count.
  if (head_open && head_node < N) {
    if (before_block != head_node)
      land(a, head_node, head);
    else
      arrive(a, sc, head_node, head, W, -(int)blockIdx.x);
  }
  if (open_end && hi == bend && node < N)
    arrive(a, sc, node, v, W, before_block == node ? 1 : 1 + (int)blockIdx.x);
}

// Whether the card places one cluster of C blocks of the kernel at this
// much dynamic shared memory a block (after the one-time attributes).
bool places(const void* kernel, int C, size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();   // clear: a refused size only means a smaller one
    return false;
  }
  return n > 0;
}

struct Plan {
  int T, C;
  bool scratch;
};

// The launch over T rows on this card: the rows in the cluster's shared
// memory where a cluster keeps them (C = ceil(T / ROWS_TARGET) blocks, up
// to 16, S = ceil(T / C) <= ROWS_MAX rows a block, placed by the card at
// S * ROW_BYTES of shared memory a block; else 8 blocks), or else in a
// device-memory scratch (16 or 8 blocks, any rows a block).  C = 0: the
// card places no such cluster.  Returns a CUDA error.
int plan_for(int T, Plan* out) {
  static bool attributes = false;
  static Plan cache[8];
  static int cached = 0;
  for (int i = 0; i < cached; ++i)
    if (cache[i].T == T) {
      *out = cache[i];
      return 0;
    }
  if (!attributes) {
    int err = (int)cudaFuncSetAttribute(resolve_kernel<false>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        ROWS_MAX * ROW_BYTES);
    if (!err) err = (int)cudaFuncSetAttribute(
        resolve_kernel<false>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (!err) err = (int)cudaFuncSetAttribute(
        resolve_kernel<true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
    attributes = true;
  }
  Plan p = {T, 0, false};
  int C = (T + ROWS_TARGET - 1) / ROWS_TARGET;
  if (C > MAX_CLUSTER || (T + C - 1) / C > ROWS_MAX) C = MAX_CLUSTER;
  const int shared_tries[2] = {C, 8}, scratch_tries[2] = {MAX_CLUSTER, 8};
  for (int c : shared_tries) {
    const int S = (T + c - 1) / c;
    if (c <= C && S <= ROWS_MAX &&
        places((const void*)resolve_kernel<false>, c, (size_t)S * ROW_BYTES)) {
      p.C = c;
      break;
    }
  }
  if (!p.C) {
    for (int c : scratch_tries) {
      if (places((const void*)resolve_kernel<true>, c, 0)) {
        p.C = c;
        p.scratch = true;
        break;
      }
    }
  }
  if (cached < 8) cache[cached++] = p;
  *out = p;
  return 0;
}

}  // namespace

// The blocks kb_resolve launches over T rows (0: more rows than it takes)
// and the bytes of device-memory scratch it then needs (0: none).
// Returns a CUDA error code.
extern "C" int kb_resolve_plan(int T, int* blocks, int64_t* scratch_bytes) {
  Plan p = {T, 0, false};
  if (T >= 1) {
    const int err = plan_for(T, &p);
    if (err) return err;
  }
  *blocks = p.C;
  *scratch_bytes = p.scratch ? (int64_t)16 * T : 0;
  return 0;
}

// scratch: u32[4 * T] of device memory where kb_resolve_plan asks for it,
// else unused (may be null).  Returns a CUDA error code
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int kb_resolve(const int32_t* prop_node, const uint8_t* active, const int32_t* rank,
                          const float* req, const float* avail, const float* eps,
                          const uint8_t* serialize, int one_per_node, int T, int N, int R,
                          int64_t* perm, int64_t* s_node, uint8_t* kept, int64_t* cancelled,
                          uint32_t* scratch, void* stream) {
  if (T < 1 || N < 1 || R < 1 || R > MAX_R) return (int)cudaErrorInvalidValue;
  Plan p;
  const int err0 = plan_for(T, &p);
  if (err0) return err0;
  if (p.C == 0 || (p.scratch && !scratch)) return (int)cudaErrorInvalidValue;
  const int C = p.C;
  const int S = (T + C - 1) / C;
  ResolveArgs a;
  a.prop_node = prop_node;
  a.active = active;
  a.rank = rank;
  a.req = req;
  a.avail = avail;
  a.eps = eps;
  a.serialize = serialize;
  a.scratch = scratch;
  a.one_per_node = one_per_node;
  a.T = T;
  a.N = N;
  a.R = R;
  a.S = S;
  a.perm = perm;
  a.s_node = s_node;
  a.kept = kept;
  a.cancelled = reinterpret_cast<unsigned long long*>(cancelled);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.scratch ? 0 : (size_t)S * ROW_BYTES;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = p.scratch ? cudaLaunchKernelEx(&cfg, resolve_kernel<true>, a)
                                    : cudaLaunchKernelEx(&cfg, resolve_kernel<false>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// scratch: a persistent buffer of N * (APPLY_W + 1) * 8 bytes
// (ApplyScratch), zero before the first call (each call leaves it so);
// one call at a time uses it.  Returns a CUDA error code.
extern "C" int kb_apply(const int64_t* perm, const int64_t* s_node,
                        const uint8_t* accept, const float* req, int use_future,
                        int new_status, int64_t T, int N, int R, float* node_future,
                        float* node_idle, int32_t* task_state, int32_t* task_node,
                        void* scratch, cudaStream_t stream) {
  if (R < 1 || R > MAX_R || N < 1 || T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  ApplyArgs a{perm, s_node, accept, req, use_future, new_status, T, N, R,
              node_future, node_idle, task_state, task_node};
  uint8_t* base = static_cast<uint8_t*>(scratch);
  ApplyScratch sc{reinterpret_cast<double*>(base),
                  reinterpret_cast<unsigned long long*>(base + (size_t)N * APPLY_W * 8)};
  const int64_t per_block = (int64_t)APPLY_THREADS * APPLY_ROWS;
  const int64_t blocks = (T + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  apply_kernel<<<(unsigned)blocks, APPLY_THREADS, 0, stream>>>(a, sc);
  return (int)cudaGetLastError();
}
