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
// Bound on this card: pass 1 must read the bool[T, N] predicate mask once
// (0.54 GB at the flagship shapes) plus any additive [T, N] score term;
// the per-node inputs ([N, R] floats, 128 KB each) stay in L2.  The
// score is recomputed on the fly from node_future / node_cap and never
// stored.  Design: one block of 256 threads takes 8 task rows and walks
// all N nodes; each thread loads a node's [R] rows into registers once
// and scores it against the 8 rows, so node data is read T/8 times from
// L2 instead of T times.  Pass 2 uses one warp per row and stops at the
// chosen tie, reading on average half a row.
//
// The inter-pod affinity predicate comes as a bool[T, N] mask (`dyn`) or,
// as the auction rounds give it, as words (kernel K10's
// kb_affinity_words): each block stages its 8 task rows' words and
// thresholds in shared memory (a warp of pass 2 its row's, in registers),
// each thread holds its node's words in registers, and a cell is tested
// as K10's pass 3 tests it: popcount(aff & Hb) >= thr0, anti & Hb_anti,
// labels & sym and anti_topo & present_now all 0, popcount(aff_topo &
// present) >= thr1.  A row with no word set passes every cell and skips
// the test.  Kernels are instantiated per word count W (words a
// vocabulary takes, 1, 2 or 8; 0 without words), so the words stay in
// registers.
//
// Ties decide placements, so the score must be bit-identical to the
// plain version and to the reference: every multiply, add and divide is
// an explicitly rounded intrinsic, in the reference's order (terms
// ((0 + w*lr) + w*bal) + extras..., resource dims left to right), and the
// file is compiled with --fmad=false.

#include <cstdint>
#include <math.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_R = 8;
constexpr int ROWS = 8;        // task rows per block in pass 1
constexpr int THREADS = 256;
constexpr float NEG_INF_SCORE = -1e30f;
constexpr float MAX_SCORE = 10.0f;

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
  const float* extra0;      // f32[T, N] or null (already weighted)
  const float* extra1;      // f32[T, N] or null
  const uint32_t* tw;       // u32[T, NW] affinity task words or null
  const int32_t* thr;       // i32[T, 2] their thresholds
  const uint32_t* nwd;      // u32[N, NW] affinity node words
  int KW, K2W;              // words of the two vocabularies
  int T, N, R;
  int has_lr, has_bal, d0, d1;
  float w_lr, w_bal, inv_q;  // inv_q == 0: no quantum floor
};

struct NodeRow {
  float avail[MAX_R], future[MAX_R], cap[MAX_R];
  bool mask;
};

// Affinity words of one node or task row, groups [0..5) of W words each
// (node: Hb, Hb_anti, sym, present, present_now; task: aff, anti,
// labels, aff_topo, anti_topo), zero past the vocabulary's words.
template <int W>
struct Words {
  uint32_t v[W > 0 ? 5 * W : 1];
};

template <int W>
__device__ __forceinline__ uint32_t word_at(const Args& a, const uint32_t* row, int g, int w) {
  const bool topo = g >= 3;
  if (w >= (topo ? a.K2W : a.KW)) return 0u;
  return row[topo ? 3 * a.KW + (g - 3) * a.K2W + w : g * a.KW + w];
}

template <int W>
__device__ __forceinline__ void load_words(const Args& a, const uint32_t* base, int row,
                                           Words<W>& out) {
  const uint32_t* p = base + (size_t)row * (3 * a.KW + 2 * a.K2W);
#pragma unroll
  for (int g = 0; g < 5; ++g)
#pragma unroll
    for (int w = 0; w < W; ++w) out.v[g * W + w] = word_at<W>(a, p, g, w);
}

// K10's cell test on a task row's words `tw` (5·W) and its thresholds.
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

__device__ __forceinline__ void load_node(const Args& a, int n, NodeRow& nr) {
  for (int r = 0; r < a.R; ++r) {
    nr.avail[r] = a.avail[(size_t)n * a.R + r];
    nr.future[r] = a.future[(size_t)n * a.R + r];
    nr.cap[r] = a.cap[(size_t)n * a.R + r];
  }
  nr.mask = a.node_mask[n] != 0;
}

// Masked, quantized score of (t, n); sets feas.  `tw` (5·W words), thr0
// and thr1 are row t's affinity words and thresholds (tw null: no test).
template <int W>
__device__ __forceinline__ float masked_score(const Args& a, int t, int n,
                                              const float* req, bool elig,
                                              const NodeRow& nr, const uint32_t* tw,
                                              int thr0, int thr1, const Words<W>& nw,
                                              bool& feas) {
  feas = elig && nr.mask && a.pred[(size_t)t * a.N + n];
  if (feas && a.dyn) feas = a.dyn[(size_t)t * a.N + n] != 0;
  if (W > 0 && feas && tw) feas = words_ok<W>(tw, thr0, thr1, nw);
  if (feas) {
    for (int r = 0; r < a.R; ++r)
      feas = feas && ((req[r] <= nr.avail[r]) || (req[r] < a.eps[r]));
  }
  float s;
  if (feas) {
    s = 0.f;
    if (a.has_lr) {  // nodeorder.least_requested
      float num = 0.f, cnt = 0.f;
      for (int r = 0; r < a.R; ++r) {
        float idle_after = __fsub_rn(nr.future[r], req[r]);
        float frac = __fdiv_rn(fmaxf(idle_after, 0.f), fmaxf(nr.cap[r], 1e-9f));
        float w = req[r] > 0.f ? 1.f : 0.f;
        num = __fadd_rn(num, __fmul_rn(frac, w));
        cnt = __fadd_rn(cnt, w);
      }
      float lr = __fmul_rn(__fdiv_rn(num, fmaxf(cnt, 1.f)), MAX_SCORE);
      s = __fadd_rn(s, __fmul_rn(a.w_lr, lr));
    }
    if (a.has_bal) {  // nodeorder.balanced
      float f[2];
      int dims[2] = {a.d0, a.d1};
      for (int i = 0; i < 2; ++i) {
        int r = dims[i];
        float used_after = __fadd_rn(__fsub_rn(nr.cap[r], nr.future[r]), req[r]);
        float fr = __fdiv_rn(used_after, fmaxf(nr.cap[r], 1e-9f));
        f[i] = fminf(fmaxf(fr, 0.f), 1.f);
      }
      float bal = __fmul_rn(__fsub_rn(1.f, fabsf(__fsub_rn(f[0], f[1]))), MAX_SCORE);
      s = __fadd_rn(s, __fmul_rn(a.w_bal, bal));
    }
    if (a.extra0) s = __fadd_rn(s, a.extra0[(size_t)t * a.N + n]);
    if (a.extra1) s = __fadd_rn(s, a.extra1[(size_t)t * a.N + n]);
  } else {
    s = NEG_INF_SCORE;
  }
  if (a.inv_q > 0.f) s = floorf(__fmul_rn(s, a.inv_q));
  return s;
}

// (max over feasible, ties at that max) combine
__device__ __forceinline__ void combine(float& m, int& c, float m2, int c2) {
  if (m2 > m) { m = m2; c = c2; }
  else if (m2 == m) { c += c2; }
}

template <int W>
__global__ void __launch_bounds__(THREADS) propose_best_kernel(
    Args a, float* __restrict__ best, int32_t* __restrict__ ties,
    uint8_t* __restrict__ active) {
  __shared__ float s_req[ROWS][MAX_R];
  __shared__ bool s_elig[ROWS];
  __shared__ uint32_t s_tw[ROWS][W > 0 ? 5 * W : 1];
  __shared__ int32_t s_thr[ROWS][2];
  __shared__ bool s_test[ROWS];   // the row has an affinity word set
  __shared__ float s_m[THREADS / 32][ROWS];
  __shared__ int s_c[THREADS / 32][ROWS];
  __shared__ int s_inf[THREADS / 32][ROWS];
  const int t0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < ROWS) {
    int t = t0 + tid;
    s_elig[tid] = t < a.T && a.eligible[t];
    for (int r = 0; r < a.R; ++r) s_req[tid][r] = t < a.T ? a.req[(size_t)t * a.R + r] : 0.f;
  }
  if (W > 0 && a.tw) {
    const int stride = 3 * a.KW + 2 * a.K2W;
    for (int i = tid; i < ROWS * 5 * W; i += THREADS) {
      const int r = i / (5 * W), g = (i / W) % 5, w = i % W;
      const int t = t0 + r;
      s_tw[r][g * W + w] = t < a.T ? word_at<W>(a, a.tw + (size_t)t * stride, g, w) : 0u;
    }
    if (tid < 2 * ROWS) {
      const int t = t0 + tid / 2;
      s_thr[tid / 2][tid % 2] = t < a.T ? a.thr[(size_t)t * 2 + tid % 2] : 0;
    }
    __syncthreads();
    if (tid < ROWS) {
      uint32_t any = 0;
      for (int j = 0; j < 5 * W; ++j) any |= s_tw[tid][j];
      s_test[tid] = any != 0;
    }
  }
  __syncthreads();
  const bool words = W > 0 && a.tw;

  float m[ROWS];
  int c[ROWS], infeas[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) { m[i] = -INFINITY; c[i] = 0; infeas[i] = 0; }

  for (int n = tid; n < a.N; n += THREADS) {
    NodeRow nr;
    load_node(a, n, nr);
    Words<W> nw;
    if (words) load_words<W>(a, a.nwd, n, nw);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      int t = t0 + i;
      if (t >= a.T) continue;
      bool feas;
      float s = masked_score<W>(a, t, n, s_req[i], s_elig[i], nr,
                                words && s_test[i] ? s_tw[i] : nullptr, s_thr[i][0],
                                s_thr[i][1], nw, feas);
      if (feas) combine(m[i], c[i], s, 1);
      else infeas[i] = 1;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    for (int off = 16; off > 0; off >>= 1) {
      float m2 = __shfl_down_sync(0xffffffffu, m[i], off);
      int c2 = __shfl_down_sync(0xffffffffu, c[i], off);
      int f2 = __shfl_down_sync(0xffffffffu, infeas[i], off);
      combine(m[i], c[i], m2, c2);
      infeas[i] |= f2;
    }
    if (lane == 0) { s_m[warp][i] = m[i]; s_c[warp][i] = c[i]; s_inf[warp][i] = infeas[i]; }
  }
  __syncthreads();
  if (tid < ROWS) {
    int t = t0 + tid;
    if (t < a.T) {
      float mf = -INFINITY;
      int cf = 0, inf = 0;
      for (int w = 0; w < THREADS / 32; ++w) {
        combine(mf, cf, s_m[w][tid], s_c[w][tid]);
        inf |= s_inf[w][tid];
      }
      float masked = NEG_INF_SCORE;
      if (a.inv_q > 0.f) masked = floorf(__fmul_rn(masked, a.inv_q));
      float b = mf;
      if (inf && masked > b) b = masked;
      best[t] = b;
      ties[t] = (cf > 0 && mf >= b) ? cf : 0;
      active[t] = cf > 0 ? 1 : 0;
    }
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS) propose_pick_kernel(
    Args a, const float* __restrict__ best, const uint8_t* __restrict__ active,
    const int32_t* __restrict__ kth, int32_t* __restrict__ prop) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (t >= a.T) return;
  if (!active[t]) {
    if (lane == 0) prop[t] = 0;
    return;
  }
  float req[MAX_R];
  for (int r = 0; r < a.R; ++r) req[r] = a.req[(size_t)t * a.R + r];
  const bool elig = a.eligible[t] != 0;
  const float b = best[t];
  // the row's affinity words, staged in shared memory for the warp
  __shared__ uint32_t s_tw[THREADS / 32][W > 0 ? 5 * W : 1];
  uint32_t* tw = s_tw[threadIdx.x >> 5];
  int thr0 = 0, thr1 = 0;
  bool test = false;
  if (W > 0 && a.tw) {
    const int stride = 3 * a.KW + 2 * a.K2W;
    for (int j = lane; j < 5 * W; j += 32)
      tw[j] = word_at<W>(a, a.tw + (size_t)t * stride, j / W, j % W);
    __syncwarp();
    thr0 = a.thr[(size_t)t * 2];
    thr1 = a.thr[(size_t)t * 2 + 1];
    uint32_t any = 0;
    for (int j = 0; j < 5 * W; ++j) any |= tw[j];
    test = any != 0;
  }
  int target = kth[t];
  int chosen = 0;
  for (int n0 = 0; n0 < a.N; n0 += 32) {
    int n = n0 + lane;
    bool tied = false;
    if (n < a.N) {
      NodeRow nr;
      load_node(a, n, nr);
      Words<W> nw;
      if (test) load_words<W>(a, a.nwd, n, nw);
      bool feas;
      float s = masked_score<W>(a, t, n, req, elig, nr, test ? tw : nullptr, thr0, thr1,
                                nw, feas);
      tied = feas && s >= b;
    }
    unsigned mask = __ballot_sync(0xffffffffu, tied);
    int pc = __popc(mask);
    if (target < pc) {
      for (int j = 0; j < target; ++j) mask &= mask - 1;
      chosen = n0 + __ffs(mask) - 1;
      break;
    }
    target -= pc;
  }
  if (lane == 0) prop[t] = chosen;
}

Args make_args(const uint8_t* pred, const uint8_t* dyn, const float* req,
               const float* avail, const float* eps, const uint8_t* node_mask,
               const uint8_t* eligible, const float* future, const float* cap,
               const float* extra0, const float* extra1, const uint32_t* tw,
               const int32_t* thr, const uint32_t* nwd, int KW, int K2W, int T, int N,
               int R, int has_lr, float w_lr, int has_bal, float w_bal, int d0, int d1,
               float inv_q) {
  Args a;
  a.tw = tw; a.thr = thr; a.nwd = nwd; a.KW = KW; a.K2W = K2W;
  a.pred = pred; a.dyn = dyn; a.req = req; a.avail = avail; a.eps = eps;
  a.node_mask = node_mask; a.eligible = eligible; a.future = future; a.cap = cap;
  a.extra0 = extra0; a.extra1 = extra1; a.T = T; a.N = N; a.R = R;
  a.has_lr = has_lr; a.w_lr = w_lr; a.has_bal = has_bal; a.w_bal = w_bal;
  a.d0 = d0; a.d1 = d1; a.inv_q = inv_q;
  return a;
}

// Word count W of the instantiation a call takes (0: no words).
int words_case(const Args& a) {
  if (!a.tw) return 0;
  const int w = a.KW > a.K2W ? a.KW : a.K2W;
  return w <= 1 ? 1 : (w <= 2 ? 2 : 8);
}

}  // namespace

extern "C" int kb_propose_best(
    const uint8_t* pred, const uint8_t* dyn, const float* req, const float* avail,
    const float* eps, const uint8_t* node_mask, const uint8_t* eligible,
    const float* future, const float* cap, const float* extra0, const float* extra1,
    const uint32_t* tw, const int32_t* thr, const uint32_t* nwd, int KW, int K2W,
    int T, int N, int R, int has_lr, float w_lr, int has_bal, float w_bal, int d0,
    int d1, float inv_q, float* best, int32_t* ties, uint8_t* active,
    cudaStream_t stream) {
  if (R > MAX_R || KW > 8 || K2W > 8) return -1;
  if (T == 0) return 0;
  Args a = make_args(pred, dyn, req, avail, eps, node_mask, eligible, future, cap,
                     extra0, extra1, tw, thr, nwd, KW, K2W, T, N, R, has_lr, w_lr,
                     has_bal, w_bal, d0, d1, inv_q);
  const unsigned blocks = (T + ROWS - 1) / ROWS;
  switch (words_case(a)) {
    case 0: propose_best_kernel<0><<<blocks, THREADS, 0, stream>>>(a, best, ties, active); break;
    case 1: propose_best_kernel<1><<<blocks, THREADS, 0, stream>>>(a, best, ties, active); break;
    case 2: propose_best_kernel<2><<<blocks, THREADS, 0, stream>>>(a, best, ties, active); break;
    default: propose_best_kernel<8><<<blocks, THREADS, 0, stream>>>(a, best, ties, active);
  }
  return (int)cudaGetLastError();
}

extern "C" int kb_propose_pick(
    const uint8_t* pred, const uint8_t* dyn, const float* req, const float* avail,
    const float* eps, const uint8_t* node_mask, const uint8_t* eligible,
    const float* future, const float* cap, const float* extra0, const float* extra1,
    const uint32_t* tw, const int32_t* thr, const uint32_t* nwd, int KW, int K2W,
    int T, int N, int R, int has_lr, float w_lr, int has_bal, float w_bal, int d0,
    int d1, float inv_q, const float* best, const uint8_t* active, const int32_t* kth,
    int32_t* prop, cudaStream_t stream) {
  if (R > MAX_R || KW > 8 || K2W > 8) return -1;
  if (T == 0) return 0;
  Args a = make_args(pred, dyn, req, avail, eps, node_mask, eligible, future, cap,
                     extra0, extra1, tw, thr, nwd, KW, K2W, T, N, R, has_lr, w_lr,
                     has_bal, w_bal, d0, d1, inv_q);
  const int rows_per_block = THREADS / 32;
  const unsigned blocks = (T + rows_per_block - 1) / rows_per_block;
  switch (words_case(a)) {
    case 0: propose_pick_kernel<0><<<blocks, THREADS, 0, stream>>>(a, best, active, kth, prop); break;
    case 1: propose_pick_kernel<1><<<blocks, THREADS, 0, stream>>>(a, best, active, kth, prop); break;
    case 2: propose_pick_kernel<2><<<blocks, THREADS, 0, stream>>>(a, best, active, kth, prop); break;
    default: propose_pick_kernel<8><<<blocks, THREADS, 0, stream>>>(a, best, active, kth, prop);
  }
  return (int)cudaGetLastError();
}
