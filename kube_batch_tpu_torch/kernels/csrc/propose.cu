// K2 · propose: each eligible pending task's best feasible node, in two
// entry points.
//
// Replaces the propose half of kube_batch_tpu/ops/assignment.py ·
// allocate_rounds (fit, feasibility, masked score, score_quantum floor,
// row max, tie mask; lines 339-357), the score terms of
// plugins/nodeorder.py (least_requested, balanced) summed by
// framework/policy.py · score_fn, and _round_robin_proposals with its
// node-axis ordinal (_node_cumsum).  XLA materializes several [T, N]
// float tensors per round for these.
//
// Pass 1 (kb_propose_best): per task row, the max of the masked score,
// the number of feasible nodes tied at it, and whether any node is
// feasible.  Pass 2 (kb_propose_pick): per active row, the index of the
// (k+1)-th tied node in node order, k = active_rank mod ties (computed
// between the passes by a stable argsort); 0 for inactive rows, as
// argmax of an all-false row gives.
//
// Bound on this card: pass 1 must read, for the eligible rows only, the
// bool[T, N] predicate mask (0.54 GB at the flagship shapes when every
// row is eligible), any dynamic mask or affinity words and any additive
// score term ([T, N], or a class term's [C, N] table: 0.56 MB for the
// pod-affinity score on the affinity path); the per-node inputs ([N, R] floats, 128 KB each)
// once; and it does two IEEE divisions a resource dim for each feasible
// cell.  A row that is not eligible has a fixed answer (no feasible node:
// the floored NEG_INF, no tie, inactive) and needs no read.  Design of
// pass 1:
//   * Only eligible rows are walked.  compact_eligible (one block) lists
//     the eligible rows on the card and zeroes the split counters;
//     propose_best_kernel, launched with a block for each work item
//     there can be, reads the count, and block i takes work item i (32
//     listed rows x one node range) if there is one: the host reads
//     nothing and sizes nothing from the data.  Every block first writes
//     the fixed answer of the rows of its stride that are not eligible.
//   * 32 rows a block, a lane a row, eight warps over the node range.
//     The nodes go through shared memory in tiles of 256 (avail, future,
//     cap, the node mask and, in the words form, the five words), in a
//     double-buffered ring: the next tile is loaded with cp.async while
//     this one is scored, so node data crosses L2 once per 32 rows, not
//     once per 8.
//   * The fit test and the node-order score ((0 + w_lr·lr) + w_bal·bal,
//     seven IEEE divisions at R = 4) depend on the request and the node
//     only, and the tasks of a gang ask for the same resources.  So the
//     block sorts its 32 rows into request classes (bitwise-equal
//     requests) and, per tile, a thread a node computes each class's fit
//     and score once into shared memory; a row's cell then costs its
//     masks, its words, its extra terms, the quantum floor and the max.
//   * A lane reads its row's mask 16 cells at a time (one uint4 when the
//     row is 16-byte aligned), the dynamic mask the same way and each
//     extra score term as float4s: a [T, N] term at row t, a class term
//     (kernel K13's table [C, N], the pod-affinity score) at row cls[t],
//     as aligned as row t.
//   * When few rows are eligible, a row group's node range is split
//     across blocks (up to one tile each) so that every SM has work; the
//     last block of a group to finish combines the groups' partial
//     (max, ties, infeasible) in a fixed order, read through L2.  With 1 %
//     of 65,536 rows eligible this is 6-8x faster than a block per row
//     group over every node, and 1.5-1.9x with 7.5 %
//     (scripts/check_torch_k2_k8.py, its `no_split` design).
//   * Each warp also leaves, per listed row and per CHUNK_N = 32 nodes of
//     a tile it scores, the chunk's (max, count tied at the max) in the
//     scratch, indexed by the row's slot in the list: its own partial,
//     before the warps are combined.  A tile is scored by one block, so
//     split row groups need no combine.  At T = 65,536 and N = 8,192 that
//     is 84 MB (5 B an entry) for every listed row.
// Pass 2 (a warp a listed row, the grid sized for T since the host does
// not read the list's length) needs those scores again only to find the
// (k+1)-th tie.  Before, it read its row from node 0 and rescored every
// cell up to the chosen tie, half a row on average (4,096 cells of seven
// IEEE divisions each at N = 8,192).  Now the warp reads the row's chunk
// summaries, counts the ties of every chunk whose max is the row's best
// (exact: the best is the max of the chunk maxima), finds the chunk that
// holds the (k+1)-th tie by a warp prefix, and rescores only that
// chunk's 32 cells, with pass 1's functions, to pick the node.  A
// summary per 256-node tile (CHUNK_N = TILE_N, the warps combined in
// shared memory) takes an eighth of the scratch and leaves pass 1 as
// fast (within 1.2 %), but pass 2 then rescores 256 cells and took
// 1.2-2.0x as long; per 32 nodes both passes together were faster in
// every case scripts/check_torch_k5_pick.py times (its `chunk256`; on an
// H100 80GB HBM3 at 700 W).
// The inter-pod affinity predicate comes as a bool[T, N] mask (`dyn`) or,
// as the auction rounds give it, as words (kernel K10's
// kb_affinity_words): a lane holds its row's words and thresholds in
// registers (a warp of pass 2 its row's, in shared memory), the node's
// words come from the staged tile (pass 2: registers), and a cell is
// tested as K10's pass 3 tests it: popcount(aff & Hb) >= thr0, anti &
// Hb_anti, labels & sym and anti_topo & present_now all 0,
// popcount(aff_topo & present) >= thr1.  A row with no word set passes
// every cell and skips the test.  Kernels are instantiated per word
// count W (words a vocabulary takes, 1, 2 or 8; 0 without words).
//
// Ties decide placements, so the score must be bit-identical to the
// plain version and to the reference: every multiply, add and divide is
// an explicitly rounded intrinsic, in the reference's order (terms
// ((0 + w*lr) + w*bal) + extras..., resource dims left to right), and the
// file is compiled with --fmad=false.  Both passes score a cell with the
// same functions (fits, node_score, finish_score).  The max and the tie
// count are exact in any order of combination.

#include <cstdint>
#include <math.h>
#include <type_traits>
#include <cuda_runtime.h>

#include "affinity_words.cuh"

namespace {

constexpr int MAX_R = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF_SCORE = -1e30f;
constexpr float MAX_SCORE = 10.0f;
// pass 1
constexpr int ROWS = 32;              // listed rows a work item, one a lane
constexpr int TILE_N = 256;           // nodes a staged tile
constexpr int WARP_N = TILE_N / WARPS;  // nodes of a tile a warp scores
constexpr int GROUP = 16;             // cells a lane reads at once
constexpr int ITEMS_TARGET = 1024;    // split row groups until this many items
constexpr int COMPACT_THREADS = 1024;
// the nodes of a tie summary: pass 1 leaves each listed row's (max, ties)
// over every CHUNK_N consecutive nodes, pass 2 rescores one such chunk
constexpr int CHUNK_N = WARP_N;
constexpr int CHUNK_WARPS = CHUNK_N / WARP_N;   // warps of a tile that score a chunk
static_assert(WARP_N % GROUP == 0, "a warp's nodes are whole groups");
static_assert(CHUNK_N % WARP_N == 0 && TILE_N % CHUNK_N == 0, "chunks of whole warps");
using ChunkTies = std::conditional_t<(CHUNK_N < 256), uint8_t, uint16_t>;
static_assert(TILE_N == THREADS, "a thread stages one node's mask byte a tile");

struct Args {
  const uint8_t* pred;      // bool[T, N]
  const uint8_t* dyn;       // bool[T, N] or null
  const float* req;         // f32[T, R]
  const float* avail;       // f32[N, R]
  const float* eps;         // f32[R]
  const uint8_t* node_mask; // bool[N]
  const uint8_t* eligible;  // bool[T]
  const float* future;      // f32[N, R]
  const float* cap;         // f32[N, R]
  const float* extra0;      // f32[T, N], f32[C, N] or null (already weighted)
  const float* extra1;      // f32[T, N], f32[C, N] or null
  const int32_t* cls0;      // i32[T]: extra0's row of task t (null: row t)
  const int32_t* cls1;      // i32[T]: extra1's row of task t (null: row t)
  const uint32_t* tw;       // u32[T, NW] affinity task words or null
  const int32_t* thr;       // i32[T, 2] their thresholds
  const uint32_t* nwd;      // u32[N, NW] affinity node words
  int KW, K2W;              // words of the two vocabularies
  int T, N, R;
  int has_lr, has_bal, d0, d1;
  float w_lr, w_bal, inv_q;  // inv_q == 0: no quantum floor
  int vec_pred, vec_dyn, vec_x;  // rows 16-byte aligned: wide loads
};

struct NodeRow {
  float avail[MAX_R], future[MAX_R], cap[MAX_R];
  bool mask;
};

// Affinity words of a row and the cell test: affinity_words.cuh, shared
// with kernel K4.
using affinity_words::Words;
using affinity_words::words_ok;

__device__ __forceinline__ int words_stride(const Args& a) {
  return affinity_words::row_words(a.KW, a.K2W);
}

template <int W>
__device__ __forceinline__ uint32_t word_at(const Args& a, const uint32_t* row, int g, int w) {
  return affinity_words::word_at<W>(a.KW, a.K2W, row, g, w);
}

// The 5·W words of a row starting at `p` (device or shared memory).
template <int W>
__device__ __forceinline__ void load_words_at(const Args& a, const uint32_t* p, Words<W>& out) {
  affinity_words::load_words_at<W>(a.KW, a.K2W, p, out);
}

template <int W>
__device__ __forceinline__ void load_words(const Args& a, const uint32_t* base, int row,
                                           Words<W>& out) {
  load_words_at<W>(a, base + (size_t)row * words_stride(a), out);
}

__device__ __forceinline__ void load_node(const Args& a, int n, NodeRow& nr) {
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < a.R) {
      nr.avail[r] = a.avail[(size_t)n * a.R + r];
      nr.future[r] = a.future[(size_t)n * a.R + r];
      nr.cap[r] = a.cap[(size_t)n * a.R + r];
    }
  }
  nr.mask = a.node_mask[n] != 0;
}

// A task row's requests and the resource dims' epsilons, in registers
// (every loop over dims is unrolled to MAX_R and guarded by r < R), and
// the requests of the balanced score's two dims.
struct RowReq {
  float v[MAX_R], eps[MAX_R];
  float d0, d1;
};

__device__ __forceinline__ void load_row(const Args& a, int t, bool has, RowReq& q) {
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    q.v[r] = has && r < a.R ? a.req[(size_t)t * a.R + r] : 0.f;
    q.eps[r] = r < a.R ? a.eps[r] : 0.f;
  }
  q.d0 = has && a.d0 < a.R ? a.req[(size_t)t * a.R + a.d0] : 0.f;
  q.d1 = has && a.d1 < a.R ? a.req[(size_t)t * a.R + a.d1] : 0.f;
}

// Does request q fit on a node (av: its R avail values, `stride` floats
// apart)?
__device__ __forceinline__ bool fits(const Args& a, const RowReq& q, const float* av,
                                     int stride) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r)
    if (r < a.R) ok = ok && ((q.v[r] <= av[r * stride]) || (q.v[r] < q.eps[r]));
  return ok;
}

// The node-order part of the score of request q on a node (fu, ca: its R
// future and cap values, `stride` floats apart): (0 + w_lr·lr) +
// w_bal·bal.  It depends on the request and the node only, so rows that
// ask for the same resources share it.
__device__ __forceinline__ float node_score(const Args& a, const RowReq& q, const float* fu,
                                            const float* ca, int stride) {
  float s = 0.f;
  if (a.has_lr) {  // nodeorder.least_requested
    float num = 0.f, cnt = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < a.R) {
        float idle_after = __fsub_rn(fu[r * stride], q.v[r]);
        float frac = __fdiv_rn(fmaxf(idle_after, 0.f), fmaxf(ca[r * stride], 1e-9f));
        float w = q.v[r] > 0.f ? 1.f : 0.f;
        num = __fadd_rn(num, __fmul_rn(frac, w));
        cnt = __fadd_rn(cnt, w);
      }
    }
    float lr = __fmul_rn(__fdiv_rn(num, fmaxf(cnt, 1.f)), MAX_SCORE);
    s = __fadd_rn(s, __fmul_rn(a.w_lr, lr));
  }
  if (a.has_bal) {  // nodeorder.balanced
    float f[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? a.d1 : a.d0;
      float used_after = __fadd_rn(__fsub_rn(ca[r * stride], fu[r * stride]), i ? q.d1 : q.d0);
      float fr = __fdiv_rn(used_after, fmaxf(ca[r * stride], 1e-9f));
      f[i] = fminf(fmaxf(fr, 0.f), 1.f);
    }
    float bal = __fmul_rn(__fsub_rn(1.f, fabsf(__fsub_rn(f[0], f[1]))), MAX_SCORE);
    s = __fadd_rn(s, __fmul_rn(a.w_bal, bal));
  }
  return s;
}

// Row of extra term 0 / 1 that task t reads: t, or its class.
__device__ __forceinline__ const float* extra_row(const float* x, const int32_t* cls, int t,
                                                  int N) {
  return x ? x + (size_t)(cls ? cls[t] : t) * N : nullptr;
}

// The rest of a cell's score: the extra terms e0, e1 (read only where the
// term exists) added in order, NEG_INF where the cell is not feasible,
// the quantum floor.
__device__ __forceinline__ float finish_score(const Args& a, float s, float e0, float e1,
                                              bool feas) {
  if (a.extra0) s = __fadd_rn(s, e0);
  if (a.extra1) s = __fadd_rn(s, e1);
  if (!feas) s = NEG_INF_SCORE;
  if (a.inv_q > 0.f) s = floorf(__fmul_rn(s, a.inv_q));
  return s;
}

// Masked, quantized score of (t, n) for pass 2; sets feas.  `tw` (5·W
// words), thr0 and thr1 are row t's affinity words and thresholds (tw
// null: no test).
template <int W>
__device__ __forceinline__ float masked_score(const Args& a, int t, int n,
                                              const RowReq& q, bool elig,
                                              const NodeRow& nr, const uint32_t* tw,
                                              int thr0, int thr1, const Words<W>& nw,
                                              bool& feas) {
  feas = elig && nr.mask && a.pred[(size_t)t * a.N + n];
  if (feas && a.dyn) feas = a.dyn[(size_t)t * a.N + n] != 0;
  if (W > 0 && feas && tw) feas = words_ok<W>(tw, thr0, thr1, nw);
  feas = feas && fits(a, q, nr.avail, 1);
  float s = 0.f, e0 = 0.f, e1 = 0.f;
  if (feas) {   // the score of a feasible cell only
    s = node_score(a, q, nr.future, nr.cap, 1);
    if (a.extra0) e0 = extra_row(a.extra0, a.cls0, t, a.N)[n];
    if (a.extra1) e1 = extra_row(a.extra1, a.cls1, t, a.N)[n];
  }
  return finish_score(a, s, e0, e1, feas);
}

// (max over feasible, ties at that max) combine
__device__ __forceinline__ void combine(float& m, int& c, float m2, int c2) {
  if (m2 > m) { m = m2; c = c2; }
  else if (m2 == m) { c += c2; }
}

// The answer of a row from its (max, ties, any infeasible cell).
__device__ __forceinline__ void finish_row(const Args& a, int t, float mf, int cf, int inf,
                                           float* best, int32_t* ties, uint8_t* active) {
  float masked = NEG_INF_SCORE;
  if (a.inv_q > 0.f) masked = floorf(__fmul_rn(masked, a.inv_q));
  float b = mf;
  if (inf && masked > b) b = masked;
  best[t] = b;
  ties[t] = (cf > 0 && mf >= b) ? cf : 0;
  active[t] = cf > 0 ? 1 : 0;
}

// -- pass 1: the eligible rows ------------------------------------------------

// Scratch of the two passes (kernels/propose.py · best_scratch_bytes
// computes the same size): count i32 | rows i32[T] | counters i32[groups]
// | partial max f32[P] | ties i32[P] | infeasible u8[P] | chunk max
// f32[T][C] | chunk ties u8[T][C] (u16 for chunks of 256), P = ROWS·(groups + ITEMS_TARGET),
// groups = ceil(T / ROWS), C = ceil(N / CHUNK_N); the chunk summaries are
// indexed by the row's slot in the eligible list.
struct Scratch {
  int32_t* count;
  int32_t* rows;
  int32_t* counters;
  float* pm;
  int32_t* pc;
  uint8_t* pi;
  float* cm;
  ChunkTies* cc;
  int C;
};

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

__host__ __device__ __forceinline__ int chunks(int N) { return (N + CHUNK_N - 1) / CHUNK_N; }

Scratch scratch_layout(void* base, int T, int N) {
  Scratch s;
  const size_t groups = ((size_t)T + ROWS - 1) / ROWS;
  const size_t P = (size_t)ROWS * (groups + ITEMS_TARGET);
  s.C = chunks(N);
  const size_t TC = (size_t)T * s.C;
  uint8_t* p = (uint8_t*)base;
  s.count = (int32_t*)p;
  p += 256;
  s.rows = (int32_t*)p;
  p += align256((size_t)T * 4);
  s.counters = (int32_t*)p;
  p += align256(groups * 4);
  s.pm = (float*)p;
  p += align256(P * 4);
  s.pc = (int32_t*)p;
  p += align256(P * 4);
  s.pi = (uint8_t*)p;
  p += align256(P);
  s.cm = (float*)p;
  p += align256(TC * 4);
  s.cc = (ChunkTies*)p;
  return s;
}

__device__ __forceinline__ int nonzero_bytes(uint32_t w) { return __popc(__vcmpne4(w, 0u)) >> 3; }

// One block: the list of eligible rows (in row order) and its length; the
// split counters of every row group zeroed.
__global__ void __launch_bounds__(COMPACT_THREADS) compact_eligible(
    const uint8_t* __restrict__ eligible, int T, int wide, Scratch sc) {
  __shared__ int warp_sums[COMPACT_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (T + ROWS - 1) / ROWS;
  for (int i = tid; i < groups; i += COMPACT_THREADS) sc.counters[i] = 0;
  const int per = (((T + COMPACT_THREADS - 1) / COMPACT_THREADS) + 15) & ~15;
  const int lo = min(T, tid * per), hi = min(T, lo + per);
  const bool vec = wide && hi - lo == per;
  int n = 0;
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(eligible + lo);
    for (int k = 0; k < per / 16; ++k) {
      const uint4 q = v[k];
      n += nonzero_bytes(q.x) + nonzero_bytes(q.y) + nonzero_bytes(q.z) + nonzero_bytes(q.w);
    }
  } else {
    for (int i = lo; i < hi; ++i) n += eligible[i] != 0;
  }
  int incl = n;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int pos = warp_sums[warp] + incl - n;
  for (int i = lo; i < hi; ++i)
    if (eligible[i]) sc.rows[pos++] = i;
  if (tid == COMPACT_THREADS - 1) *sc.count = pos;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// One staged tile: avail, future, cap [R][TILE_N] (a thread a node reads
// them without bank conflicts), node words [TILE_N][stride], node mask
// [TILE_N].
struct Tile {
  float *av, *fu, *ca;
  uint32_t* words;
  uint8_t* mask;
};

__host__ __device__ __forceinline__ size_t tile_bytes(int R, int stride) {
  return (size_t)TILE_N * (3 * R * 4 + stride * 4) + TILE_N;
}

__device__ __forceinline__ Tile tile_at(uint8_t* smem, int buf, int R, int stride) {
  uint8_t* p = smem + (size_t)buf * tile_bytes(R, stride);
  Tile t;
  t.av = reinterpret_cast<float*>(p);
  t.fu = t.av + TILE_N * R;
  t.ca = t.fu + TILE_N * R;
  t.words = reinterpret_cast<uint32_t*>(t.ca + TILE_N * R);
  t.mask = reinterpret_cast<uint8_t*>(t.words + TILE_N * stride);
  return t;
}

// Start the copies of tile k (nodes [k·TILE_N, ...)) into `t`; the node
// mask byte of this thread's node comes back in a register.
__device__ __forceinline__ uint8_t issue_tile(const Args& a, int k, const Tile& t, bool words) {
  const int n0 = k * TILE_N, cnt = min(TILE_N, a.N - n0);
  const size_t off = (size_t)n0 * a.R;
  for (int i = threadIdx.x; i < cnt * a.R; i += THREADS) {
    const int soa = (i % a.R) * TILE_N + i / a.R;
    cp_async4(t.av + soa, a.avail + off + i);
    cp_async4(t.fu + soa, a.future + off + i);
    cp_async4(t.ca + soa, a.cap + off + i);
  }
  if (words) {
    const int stride = words_stride(a);
    const size_t woff = (size_t)n0 * stride;
    for (int i = threadIdx.x; i < cnt * stride; i += THREADS)
      cp_async4(t.words + i, a.nwd + woff + i);
  }
  cp_async_commit();
  return (int)threadIdx.x < cnt ? a.node_mask[n0 + threadIdx.x] : 0;
}

// 16 bytes of a [T, N] bool row from node n (zero past N).
__device__ __forceinline__ void load_bytes16(const uint8_t* row, int n, int N, int vec,
                                             uint32_t (&w)[4]) {
  if (vec) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + n);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = n + 4 * q + b;
      if (j < N) v |= (uint32_t)row[j] << (8 * b);
    }
    w[q] = v;
  }
}

// 4 floats of a [T, N] row from node n (zero past N).
__device__ __forceinline__ float4 load_f4(const float* row, int n, int N, int vec) {
  if (vec) return *reinterpret_cast<const float4*>(row + n);
  float4 v;
  v.x = n < N ? row[n] : 0.f;
  v.y = n + 1 < N ? row[n + 1] : 0.f;
  v.z = n + 2 < N ? row[n + 2] : 0.f;
  v.w = n + 3 < N ? row[n + 3] : 0.f;
  return v;
}

__device__ __forceinline__ float f4_at(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

template <int W>
__global__ void __launch_bounds__(THREADS) propose_best_kernel(
    Args a, Scratch sc, float* __restrict__ best, int32_t* __restrict__ ties,
    uint8_t* __restrict__ active) {
  extern __shared__ __align__(16) uint8_t smem[];
  // per request class of the item's rows: its node-order score and fit on
  // each node of the tile
  __shared__ float s_base[ROWS][TILE_N];
  __shared__ uint8_t s_fit[ROWS][TILE_N];
  __shared__ RowReq s_creq[ROWS];
  __shared__ int s_class[ROWS];
  __shared__ int s_K;
  __shared__ float s_m[WARPS][ROWS];
  __shared__ int s_c[WARPS][ROWS];
  __shared__ int s_inf[WARPS][ROWS];
  __shared__ float s_tm[WARPS][ROWS];   // a tile's warp partials, for the summaries
  __shared__ int s_tc[WARPS][ROWS];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool words = W > 0 && a.tw;
  const int stride = words ? words_stride(a) : 0;

  // the fixed answer of the rows that are not eligible (of every row
  // when there is no node)
  {
    float masked = NEG_INF_SCORE;
    if (a.inv_q > 0.f) masked = floorf(__fmul_rn(masked, a.inv_q));
    const float fixed = a.N > 0 ? masked : -INFINITY;
    for (int t = blockIdx.x * THREADS + tid; t < a.T; t += gridDim.x * THREADS) {
      if (a.N == 0 || !a.eligible[t]) {
        best[t] = fixed;
        ties[t] = 0;
        active[t] = 0;
      }
    }
  }

  const int E = *sc.count;
  const int G = (E + ROWS - 1) / ROWS;
  const int NT = (a.N + TILE_N - 1) / TILE_N;
  if (G == 0 || NT == 0) return;
  const int S = max(1, min(NT, (ITEMS_TARGET + G - 1) / G));

  // a grid-stride loop over the items (one pass with launch_best's grid)
  for (int item = blockIdx.x; item < G * S; item += gridDim.x) {
    const int g = item / S, s = item % S;
    const int slot = g * ROWS + lane;
    const bool has_row = slot < E;
    const int t = has_row ? sc.rows[slot] : 0;
    RowReq rq;
    load_row(a, t, has_row, rq);
    // Warp 0 sorts the item's rows into request classes: rows whose
    // requests are bitwise equal share one score per node.
    if (warp == 0) {
      unsigned left = __ballot_sync(0xffffffffu, has_row);
      int mine = -1, k = 0;
      while (left) {
        const int leader = __ffs(left) - 1;
        bool same = has_row && mine < 0;
#pragma unroll
        for (int r = 0; r < MAX_R; ++r) {   // every lane takes part in each shuffle
          const float lv = __shfl_sync(0xffffffffu, rq.v[r], leader);
          same = same && __float_as_uint(rq.v[r]) == __float_as_uint(lv);
        }
        const unsigned members = __ballot_sync(0xffffffffu, same);
        if (same) mine = k;
        if (lane == leader) s_creq[k] = rq;
        left &= ~members;
        ++k;
      }
      s_class[lane] = mine;
      if (lane == 0) s_K = k;
    }
    uint32_t tw[W > 0 ? 5 * W : 1];
    int thr0 = 0, thr1 = 0;
    bool test = false;
    if (words && has_row) {
      Words<W> w;
      load_words<W>(a, a.tw, t, w);
      uint32_t any = 0;
#pragma unroll
      for (int j = 0; j < 5 * W; ++j) {
        tw[j] = w.v[j];
        any |= w.v[j];
      }
      test = any != 0;
      thr0 = a.thr[(size_t)t * 2];
      thr1 = a.thr[(size_t)t * 2 + 1];
    }
    const uint8_t* prow = a.pred + (size_t)t * a.N;
    const uint8_t* drow = a.dyn ? a.dyn + (size_t)t * a.N : nullptr;
    const float* x0row = extra_row(a.extra0, a.cls0, t, a.N);
    const float* x1row = extra_row(a.extra1, a.cls1, t, a.N);

    float m = -INFINITY;
    int c = 0, infeas = 0;
    const int k_lo = (int)((long long)NT * s / S), k_hi = (int)((long long)NT * (s + 1) / S);
    uint8_t mreg = issue_tile(a, k_lo, tile_at(smem, k_lo & 1, a.R, stride), words);
    __syncthreads();   // the classes are set
    const int K = s_K;
    const int cls = s_class[lane];
    for (int k = k_lo; k < k_hi; ++k) {
      const Tile tl = tile_at(smem, k & 1, a.R, stride);
      tl.mask[tid] = mreg;
      if (k + 1 < k_hi) {
        mreg = issue_tile(a, k + 1, tile_at(smem, (k + 1) & 1, a.R, stride), words);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int n0 = k * TILE_N;
      // a thread a node: each class's fit and node-order score on it
      if (n0 + tid < a.N) {
        for (int q = 0; q < K; ++q) {
          const RowReq cq = s_creq[q];
          s_fit[q][tid] = fits(a, cq, tl.av + tid, TILE_N);
          s_base[q][tid] = node_score(a, cq, tl.fu + tid, tl.ca + tid, TILE_N);
        }
      }
      __syncthreads();
      // a lane a row: its masks, words and extra terms on each node; the
      // (max, ties) of this warp's WARP_N nodes
      float tm = -INFINITY;
      int tc = 0;
      if (has_row) {
#pragma unroll 1
        for (int gi = 0; gi < WARP_N / GROUP; ++gi) {
          const int l0 = warp * WARP_N + gi * GROUP;   // node of the tile
          const int nb = n0 + l0;
          if (nb >= a.N) break;
          uint32_t pw[4], dw[4] = {0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
          load_bytes16(prow, nb, a.N, a.vec_pred, pw);
          if (drow) load_bytes16(drow, nb, a.N, a.vec_dyn, dw);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
            if (x0row) x0 = load_f4(x0row, nb + 4 * q, a.N, a.vec_x);
            if (x1row) x1 = load_f4(x1row, nb + 4 * q, a.N, a.vec_x);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int ln = l0 + 4 * q + b;
              if (n0 + ln >= a.N) break;
              bool feas = ((pw[q] >> (8 * b)) & 0xffu) && ((dw[q] >> (8 * b)) & 0xffu)
                          && tl.mask[ln] && s_fit[cls][ln];
              if (W > 0 && feas && test) {
                Words<W> nw;
                load_words_at<W>(a, tl.words + (size_t)ln * stride, nw);
                feas = words_ok<W>(tw, thr0, thr1, nw);
              }
              const float sc_ = finish_score(a, s_base[cls][ln], f4_at(x0, b),
                                             f4_at(x1, b), feas);
              if (feas) combine(tm, tc, sc_, 1);
              else infeas = 1;
            }
          }
        }
        combine(m, c, tm, tc);
      }
      s_tm[warp][lane] = tm;
      s_tc[warp][lane] = tc;
      __syncthreads();   // tile k's buffer and the class scores are free
      // The tie summary of each chunk of the tile, for pass 2: a chunk is
      // scored by one block (split row groups need no combine), its
      // warps' partials combined in a fixed order.  The next tile writes
      // s_tm only after its first barrier.
      if (warp < TILE_N / CHUNK_N && has_row) {
        const int j = k * (TILE_N / CHUNK_N) + warp;
        float cm_ = -INFINITY;
        int cc_ = 0;
        for (int w = warp * CHUNK_WARPS; w < (warp + 1) * CHUNK_WARPS; ++w)
          combine(cm_, cc_, s_tm[w][lane], s_tc[w][lane]);
        if (j < sc.C) {
          sc.cm[(size_t)slot * sc.C + j] = cm_;
          sc.cc[(size_t)slot * sc.C + j] = (ChunkTies)cc_;
        }
      }
    }
    // the eight warps' partials of each row
    s_m[warp][lane] = m;
    s_c[warp][lane] = c;
    s_inf[warp][lane] = infeas;
    __syncthreads();
    if (warp == 0) {
      float mf = -INFINITY;
      int cf = 0, inf = 0;
      for (int w = 0; w < WARPS; ++w) {
        combine(mf, cf, s_m[w][lane], s_c[w][lane]);
        inf |= s_inf[w][lane];
      }
      if (S == 1) {
        if (has_row) finish_row(a, t, mf, cf, inf, best, ties, active);
      } else {
        const size_t p = ((size_t)g * S + s) * ROWS + lane;
        sc.pm[p] = mf;
        sc.pc[p] = cf;
        sc.pi[p] = (uint8_t)inf;
        __threadfence();
      }
    }
    if (S > 1) {
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(&sc.counters[g], 1) == S - 1;
      __syncthreads();
      if (s_last && warp == 0 && has_row) {
        __threadfence();
        float mf = -INFINITY;
        int cf = 0, inf = 0;
        for (int q = 0; q < S; ++q) {
          const size_t p = ((size_t)g * S + q) * ROWS + lane;
          combine(mf, cf, __ldcg(sc.pm + p), __ldcg(sc.pc + p));
          inf |= __ldcg(sc.pi + p);
        }
        finish_row(a, t, mf, cf, inf, best, ties, active);
      }
    }
    __syncthreads();   // the classes, s_m, s_c, s_inf and s_last are written again
  }
}

// Pass 2: a warp a listed eligible row (slot blockIdx.x·WARPS + warp of
// pass 1's list); the block's rows of its stride that are not eligible
// get the fixed answer 0 first, and a warp past the list's length has
// nothing more to do.
template <int W>
__global__ void __launch_bounds__(THREADS) propose_pick_kernel(
    Args a, Scratch sc, const float* __restrict__ best, const uint8_t* __restrict__ active,
    const int32_t* __restrict__ kth, int32_t* __restrict__ prop) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = blockIdx.x * THREADS + threadIdx.x; t < a.T; t += gridDim.x * THREADS)
    if (!a.eligible[t]) prop[t] = 0;
  const int slot = blockIdx.x * WARPS + warp;
  if (slot >= *sc.count) return;
  const int t = sc.rows[slot];
  if (!active[t]) {
    if (lane == 0) prop[t] = 0;
    return;
  }
  const float b = best[t];
  int target = kth[t];
  // The chunk that holds the (target+1)-th tie: a chunk's ties count where
  // its max is the row's best (the best is the max over the chunks, and a
  // chunk's max is never above it), summed by a warp prefix.
  const float* cm = sc.cm + (size_t)slot * sc.C;
  const ChunkTies* cc = sc.cc + (size_t)slot * sc.C;
  int chunk = -1;
  for (int j0 = 0; j0 < sc.C; j0 += 32) {
    const int j = j0 + lane;
    const int cnt = j < sc.C && cm[j] == b ? (int)cc[j] : 0;
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (target < total) {
      const int l = __ffs(__ballot_sync(0xffffffffu, incl > target)) - 1;
      target -= __shfl_sync(0xffffffffu, incl - cnt, l);
      chunk = j0 + l;
      break;
    }
    target -= total;
  }
  int chosen = 0;
  if (chunk >= 0) {
    // rescore that chunk's nodes, 32 at a time, with pass 1's functions
    RowReq q;
    load_row(a, t, true, q);
    // the row's affinity words, staged in shared memory for the warp
    __shared__ uint32_t s_tw[WARPS][W > 0 ? 5 * W : 1];
    uint32_t* tw = s_tw[warp];
    int thr0 = 0, thr1 = 0;
    bool test = false;
    if (W > 0 && a.tw) {
      const int stride = words_stride(a);
      for (int j = lane; j < 5 * W; j += 32)
        tw[j] = word_at<W>(a, a.tw + (size_t)t * stride, j / W, j % W);
      __syncwarp();
      thr0 = a.thr[(size_t)t * 2];
      thr1 = a.thr[(size_t)t * 2 + 1];
      uint32_t any = 0;
      for (int j = 0; j < 5 * W; ++j) any |= tw[j];
      test = any != 0;
    }
    const int hi = min(a.N, (chunk + 1) * CHUNK_N);
    for (int n0 = chunk * CHUNK_N; n0 < hi; n0 += 32) {
      const int n = n0 + lane;
      bool tied = false;
      if (n < hi) {
        NodeRow nr;
        load_node(a, n, nr);
        Words<W> nw;
        if (test) load_words<W>(a, a.nwd, n, nw);
        bool feas;
        const float s_ = masked_score<W>(a, t, n, q, true, nr, test ? tw : nullptr, thr0,
                                         thr1, nw, feas);
        tied = feas && s_ >= b;
      }
      unsigned mask = __ballot_sync(0xffffffffu, tied);
      const int pc = __popc(mask);
      if (target < pc) {
        for (int j = 0; j < target; ++j) mask &= mask - 1;
        chosen = n0 + __ffs(mask) - 1;
        break;
      }
      target -= pc;
    }
  }
  if (lane == 0) prop[t] = chosen;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

Args make_args(const uint8_t* pred, const uint8_t* dyn, const float* req,
               const float* avail, const float* eps, const uint8_t* node_mask,
               const uint8_t* eligible, const float* future, const float* cap,
               const float* extra0, const float* extra1, const int32_t* cls0,
               const int32_t* cls1, const uint32_t* tw, const int32_t* thr,
               const uint32_t* nwd, int KW, int K2W, int T, int N, int R, int has_lr,
               float w_lr, int has_bal, float w_bal, int d0, int d1, float inv_q) {
  Args a;
  a.tw = tw; a.thr = thr; a.nwd = nwd; a.KW = KW; a.K2W = K2W;
  a.pred = pred; a.dyn = dyn; a.req = req; a.avail = avail; a.eps = eps;
  a.node_mask = node_mask; a.eligible = eligible; a.future = future; a.cap = cap;
  a.extra0 = extra0; a.extra1 = extra1; a.cls0 = cls0; a.cls1 = cls1; a.T = T; a.N = N; a.R = R;
  a.has_lr = has_lr; a.w_lr = w_lr; a.has_bal = has_bal; a.w_bal = w_bal;
  a.d0 = d0; a.d1 = d1; a.inv_q = inv_q;
  a.vec_pred = N % 16 == 0 && aligned16(pred);
  a.vec_dyn = N % 16 == 0 && (!dyn || aligned16(dyn));
  // a lane reads a row's extras in groups of 16 cells, so as for the
  // masks every group must lie inside the row (a class row cls[t]·N is
  // as aligned as row t·N)
  a.vec_x = N % 16 == 0 && (!extra0 || aligned16(extra0)) && (!extra1 || aligned16(extra1));
  return a;
}

// Word count W of the instantiation a call takes (0: no words).
int words_case(const Args& a) { return affinity_words::words_case(a.tw != nullptr, a.KW, a.K2W); }

template <int W>
int launch_best(const Args& a, const Scratch& sc, float* best, int32_t* ties,
                uint8_t* active, cudaStream_t stream) {
  const int stride = a.tw ? 3 * a.KW + 2 * a.K2W : 0;
  const size_t smem = 2 * tile_bytes(a.R, stride);
  // static and dynamic shared memory above 48 KB need the opt-in: set once
  // for the largest ring (R = MAX_R, 8 words a vocabulary)
  static const int optin = (int)cudaFuncSetAttribute(
      propose_best_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(2 * tile_bytes(MAX_R, 5 * 8)));
  if (optin) return optin;
  // a block for each work item there can be: with G row groups listed,
  // G·S is G when G >= ITEMS_TARGET, else below G + ITEMS_TARGET; the
  // blocks past this call's items exit after their share of the fixed
  // answers
  const int groups = (a.T + ROWS - 1) / ROWS;
  const int split = (groups < ITEMS_TARGET ? groups : ITEMS_TARGET - 1) + ITEMS_TARGET - 1;
  const int grid = groups > split ? groups : split;
  propose_best_kernel<W><<<grid, THREADS, smem, stream>>>(a, sc, best, ties, active);
  return 0;
}

}  // namespace

// scratch: best_scratch_bytes(T, N) bytes (kernels/propose.py), any
// contents; pass 1 leaves the eligible list and the tie summaries in it.
extern "C" int kb_propose_best(
    const uint8_t* pred, const uint8_t* dyn, const float* req, const float* avail,
    const float* eps, const uint8_t* node_mask, const uint8_t* eligible,
    const float* future, const float* cap, const float* extra0, const float* extra1,
    const int32_t* cls0, const int32_t* cls1,
    const uint32_t* tw, const int32_t* thr, const uint32_t* nwd, int KW, int K2W,
    int T, int N, int R, int has_lr, float w_lr, int has_bal, float w_bal, int d0,
    int d1, float inv_q, float* best, int32_t* ties, uint8_t* active, void* scratch,
    cudaStream_t stream) {
  if (R > MAX_R || KW > 8 || K2W > 8) return -1;
  if (T == 0) return 0;
  Args a = make_args(pred, dyn, req, avail, eps, node_mask, eligible, future, cap,
                     extra0, extra1, cls0, cls1, tw, thr, nwd, KW, K2W, T, N, R, has_lr, w_lr,
                     has_bal, w_bal, d0, d1, inv_q);
  const Scratch sc = scratch_layout(scratch, T, N);
  compact_eligible<<<1, COMPACT_THREADS, 0, stream>>>(eligible, T, aligned16(eligible), sc);
  int err = 0;
  switch (words_case(a)) {
    case 0: err = launch_best<0>(a, sc, best, ties, active, stream); break;
    case 1: err = launch_best<1>(a, sc, best, ties, active, stream); break;
    case 2: err = launch_best<2>(a, sc, best, ties, active, stream); break;
    default: err = launch_best<8>(a, sc, best, ties, active, stream);
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

// scratch: the one pass 1 of this round filled.
extern "C" int kb_propose_pick(
    const uint8_t* pred, const uint8_t* dyn, const float* req, const float* avail,
    const float* eps, const uint8_t* node_mask, const uint8_t* eligible,
    const float* future, const float* cap, const float* extra0, const float* extra1,
    const int32_t* cls0, const int32_t* cls1,
    const uint32_t* tw, const int32_t* thr, const uint32_t* nwd, int KW, int K2W,
    int T, int N, int R, int has_lr, float w_lr, int has_bal, float w_bal, int d0,
    int d1, float inv_q, const float* best, const uint8_t* active, const int32_t* kth,
    int32_t* prop, void* scratch, cudaStream_t stream) {
  if (R > MAX_R || KW > 8 || K2W > 8) return -1;
  if (T == 0) return 0;
  Args a = make_args(pred, dyn, req, avail, eps, node_mask, eligible, future, cap,
                     extra0, extra1, cls0, cls1, tw, thr, nwd, KW, K2W, T, N, R, has_lr, w_lr,
                     has_bal, w_bal, d0, d1, inv_q);
  const Scratch sc = scratch_layout(scratch, T, N);
  // a warp for each row the list can hold: the host does not read its length
  const unsigned blocks = (T + WARPS - 1) / WARPS;
  switch (words_case(a)) {
    case 0: propose_pick_kernel<0><<<blocks, THREADS, 0, stream>>>(a, sc, best, active, kth, prop); break;
    case 1: propose_pick_kernel<1><<<blocks, THREADS, 0, stream>>>(a, sc, best, active, kth, prop); break;
    case 2: propose_pick_kernel<2><<<blocks, THREADS, 0, stream>>>(a, sc, best, active, kth, prop); break;
    default: propose_pick_kernel<8><<<blocks, THREADS, 0, stream>>>(a, sc, best, active, kth, prop);
  }
  return (int)cudaGetLastError();
}
