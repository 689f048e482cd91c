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
  int T, N, R;
  int has_lr, has_bal, d0, d1;
  float w_lr, w_bal, inv_q;  // inv_q == 0: no quantum floor
};

struct NodeRow {
  float avail[MAX_R], future[MAX_R], cap[MAX_R];
  bool mask;
};

__device__ __forceinline__ void load_node(const Args& a, int n, NodeRow& nr) {
  for (int r = 0; r < a.R; ++r) {
    nr.avail[r] = a.avail[(size_t)n * a.R + r];
    nr.future[r] = a.future[(size_t)n * a.R + r];
    nr.cap[r] = a.cap[(size_t)n * a.R + r];
  }
  nr.mask = a.node_mask[n] != 0;
}

// Masked, quantized score of (t, n); sets feas.
__device__ __forceinline__ float masked_score(const Args& a, int t, int n,
                                              const float* req, bool elig,
                                              const NodeRow& nr, bool& feas) {
  feas = elig && nr.mask && a.pred[(size_t)t * a.N + n];
  if (feas && a.dyn) feas = a.dyn[(size_t)t * a.N + n] != 0;
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

__global__ void __launch_bounds__(THREADS) propose_best_kernel(
    Args a, float* __restrict__ best, int32_t* __restrict__ ties,
    uint8_t* __restrict__ active) {
  __shared__ float s_req[ROWS][MAX_R];
  __shared__ bool s_elig[ROWS];
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
  __syncthreads();

  float m[ROWS];
  int c[ROWS], infeas[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) { m[i] = -INFINITY; c[i] = 0; infeas[i] = 0; }

  for (int n = tid; n < a.N; n += THREADS) {
    NodeRow nr;
    load_node(a, n, nr);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      int t = t0 + i;
      if (t >= a.T) continue;
      bool feas;
      float s = masked_score(a, t, n, s_req[i], s_elig[i], nr, feas);
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
  int target = kth[t];
  int chosen = 0;
  for (int n0 = 0; n0 < a.N; n0 += 32) {
    int n = n0 + lane;
    bool tied = false;
    if (n < a.N) {
      NodeRow nr;
      load_node(a, n, nr);
      bool feas;
      float s = masked_score(a, t, n, req, elig, nr, feas);
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
               const float* extra0, const float* extra1, int T, int N, int R,
               int has_lr, float w_lr, int has_bal, float w_bal, int d0, int d1,
               float inv_q) {
  Args a;
  a.pred = pred; a.dyn = dyn; a.req = req; a.avail = avail; a.eps = eps;
  a.node_mask = node_mask; a.eligible = eligible; a.future = future; a.cap = cap;
  a.extra0 = extra0; a.extra1 = extra1; a.T = T; a.N = N; a.R = R;
  a.has_lr = has_lr; a.w_lr = w_lr; a.has_bal = has_bal; a.w_bal = w_bal;
  a.d0 = d0; a.d1 = d1; a.inv_q = inv_q;
  return a;
}

}  // namespace

extern "C" int kb_propose_best(
    const uint8_t* pred, const uint8_t* dyn, const float* req, const float* avail,
    const float* eps, const uint8_t* node_mask, const uint8_t* eligible,
    const float* future, const float* cap, const float* extra0, const float* extra1,
    int T, int N, int R, int has_lr, float w_lr, int has_bal, float w_bal, int d0,
    int d1, float inv_q, float* best, int32_t* ties, uint8_t* active,
    cudaStream_t stream) {
  if (R > MAX_R) return -1;
  if (T == 0) return 0;
  Args a = make_args(pred, dyn, req, avail, eps, node_mask, eligible, future, cap,
                     extra0, extra1, T, N, R, has_lr, w_lr, has_bal, w_bal, d0, d1,
                     inv_q);
  propose_best_kernel<<<(T + ROWS - 1) / ROWS, THREADS, 0, stream>>>(a, best, ties, active);
  return (int)cudaGetLastError();
}

extern "C" int kb_propose_pick(
    const uint8_t* pred, const uint8_t* dyn, const float* req, const float* avail,
    const float* eps, const uint8_t* node_mask, const uint8_t* eligible,
    const float* future, const float* cap, const float* extra0, const float* extra1,
    int T, int N, int R, int has_lr, float w_lr, int has_bal, float w_bal, int d0,
    int d1, float inv_q, const float* best, const uint8_t* active, const int32_t* kth,
    int32_t* prop, cudaStream_t stream) {
  if (R > MAX_R) return -1;
  if (T == 0) return 0;
  Args a = make_args(pred, dyn, req, avail, eps, node_mask, eligible, future, cap,
                     extra0, extra1, T, N, R, has_lr, w_lr, has_bal, w_bal, d0, d1,
                     inv_q);
  const int rows_per_block = THREADS / 32;
  propose_pick_kernel<<<(T + rows_per_block - 1) / rows_per_block, THREADS, 0, stream>>>(
      a, best, active, kth, prop);
  return (int)cudaGetLastError();
}
