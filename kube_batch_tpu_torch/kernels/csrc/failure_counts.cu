// K4 · failure tallies: per task, over the real and ready nodes, the
// nodes its predicates veto, the nodes short on each resource dim, and the
// nodes that fit; one launch per cycle.
//
// Replaces kube_batch_tpu/framework/fit_errors.py · failure_counts, fed
// the predicate mask ANDed with the dynamic predicates (m = pred & dyn):
//   predicate_failed[t] = #{n ok : !m[t, n]}
//   feasible[t]         = #{n ok : m[t, n] && fit(t, n)}
//   insufficient[t, r]  = #{n ok : m[t, n] && !fit(t, n)
//                                  && req[t, r] > idle[n, r] && req[t, r] >= eps[r]}
// with ok = node_mask & node_ready and fit(t, n) = AND_r (req[t, r] <=
// idle[n, r] || req[t, r] < eps[r]); and nodes = #{n ok}.
//
// The dynamic predicate comes as a second bool[T, N] mask (`dyn`), as
// kernel K10's words (`tw`, `thr`, `nwd`: kernels/affinity.py ·
// AffinityWords, tested here with the test kernel K2 uses,
// affinity_words.cuh · words_ok), or not at all.  So the cycle's tallies
// on an affinity world launch no [T, N] mask of K10 and build no AND of
// two masks.
//
// Bound on this card: bytes.  A cell's fit, its shortfalls and its
// affinity test depend only on the task's request (and words) and the
// node, and the tasks of a gang ask for the same resources and carry the
// same terms, so the least work is the bool[T, N] mask read once (0.54 GB
// at the main path's shapes, 0.16 ms), with the words or the second mask
// beside it.  The Triton kernel this replaces recomputed fit and the
// shortfalls for every cell, with R + 2 cross-thread reductions a tile,
// and took 15x that.  Design:
//   * A block takes 32 rows, a lane a row, and warp 0 sorts them into
//     classes of bitwise-equal requests (in the words form also equal
//     words and thresholds), as K2's pass 1 does.
//   * Warp w walks the 32-node chunks w, w + 8, ... of the node axis.  Per
//     chunk a lane is a node first: it reads the node's idle row (and its
//     affinity words) and, for each class, its fit bit, its R shortfall
//     bits (req[r] > idle[r] && req[r] >= eps[r]) and its words test; a
//     ballot packs each into a 32-node word, which every lane holds, and
//     each lane keeps its own row's class's words.  No shared memory
//     traffic per cell, no block barrier.
//   * Then a lane is a row: it turns its row's 32 mask bytes of the chunk
//     (two 16-byte loads where the rows are 16-byte aligned, issued one
//     chunk ahead, so they are in flight during the class work) into 32
//     bits m and adds
//       pf += popc(~m & ok), fe += popc(m & ok & fit),
//       ins[r] += popc(m & ok & ~fit & short_r)
//     to register counters.
//   * The warps' counters of a row are summed once at the end (shared
//     memory atomics) and written once: every row 0 .. T-1, padding rows
//     included.
//   * An instantiation for R = 4 (every world of this repository) holds
//     four dims in registers, the other any R up to 8.
// Every count is an integer sum of popcounts, exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

#include "affinity_words.cuh"

namespace {

using affinity_words::Words;

constexpr int MAX_R = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;     // rows a block, a lane a row
constexpr int CHUNK = 32;    // nodes a warp takes at once, a lane a node

struct Args {
  const uint8_t* pred;       // bool[T, N]
  const uint8_t* dyn;        // bool[T, N] or null
  const uint32_t* tw;        // u32[T, NW] affinity task words or null
  const int32_t* thr;        // i32[T, 2] their thresholds
  const uint32_t* nwd;       // u32[N, NW] affinity node words
  const float* req;          // f32[T, R]
  const float* idle;         // f32[N, R]
  const float* eps;          // f32[R]
  const uint8_t* node_ok;    // bool[N]
  int32_t* pf;               // i32[T]
  int32_t* ins;              // i32[T, R]
  int32_t* fe;               // i32[T]
  int32_t* nodes;            // i32[1]
  int KW, K2W, T, N, R;
  int vec;                   // pred and dyn rows 16-byte aligned
};

// Four bool bytes as four bits (byte b → bit b).
__device__ __forceinline__ uint32_t bits4(uint32_t w) {
  const uint32_t ones = __vcmpne4(w, 0u) & 0x01010101u;
  return ((ones * 0x00204081u) >> 21) & 0xfu;
}

__device__ __forceinline__ uint32_t bits16(const uint4& q) {
  return bits4(q.x) | bits4(q.y) << 4 | bits4(q.z) << 8 | bits4(q.w) << 12;
}

// The 32 cells of a bool row from node n0 (a multiple of 32): raw 16-byte
// loads where the row allows them (`lo`, `hi`: zero past N), else the
// bits read byte by byte into `slow`.
struct Cells {
  uint4 lo, hi;
  uint32_t slow;
};

__device__ __forceinline__ void load_cells(const uint8_t* row, int n0, int N, int vec,
                                           Cells& c) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  c.slow = 0u;
  if (vec) {   // N % 16 == 0: each half lies wholly inside the row or past it
    c.lo = n0 < N ? *reinterpret_cast<const uint4*>(row + n0) : zero;
    c.hi = n0 + 16 < N ? *reinterpret_cast<const uint4*>(row + n0 + 16) : zero;
    return;
  }
  c.lo = c.hi = zero;
  for (int j = 0; j < CHUNK; ++j) {
    const int n = n0 + j;
    if (n < N && row[n]) c.slow |= 1u << j;
  }
}

__device__ __forceinline__ uint32_t cell_bits(const Cells& c, int vec) {
  return vec ? bits16(c.lo) | bits16(c.hi) << 16 : c.slow;
}

// RR: the resource dims the instantiation holds in registers, 4 (R == 4
// exactly, every world of the repository) or MAX_R (any R, loops guarded
// by r < R).  The R == 4 one is worth its own instantiation: at T =
// 65,536, N = 8,192 it takes 0.2959 ms of device time a launch where the
// MAX_R one takes 0.48 (words form 0.6037 against 0.8157; NVIDIA H100
// 80GB HBM3, 700 W; scripts/check_torch_k6_k4.py --k4-only, `this_any_r`).
// W: words a vocabulary in the words form (0: none).
template <int W, int RR>
__global__ void __launch_bounds__(THREADS) failure_counts_kernel(Args a) {
  constexpr int TW = W > 0 ? 5 * W : 1;
  __shared__ float s_creq[ROWS][RR];
  __shared__ uint32_t s_ctw[W > 0 ? ROWS : 1][TW];   // a class's affinity words
  __shared__ int s_cthr[W > 0 ? ROWS : 1][2];
  __shared__ int s_ctest[ROWS];                      // the class has a word set
  __shared__ int s_class[ROWS];
  __shared__ int s_K, s_stage;
  __shared__ int s_sum[ROWS][2 + RR];   // a row's counters, over the warps
  __shared__ int s_nodes;
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x * ROWS + lane;
  const bool has_row = t < a.T;
  const int R = RR == MAX_R ? a.R : RR;
  const bool words = W > 0 && a.tw != nullptr;
  const int stride = affinity_words::row_words(a.KW, a.K2W);

  float eps[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) eps[r] = r < R ? a.eps[r] : 0.f;

  // warp 0: the block's rows into classes of bitwise-equal requests (and,
  // in the words form, equal affinity words and thresholds)
  if (warp == 0) {
    float q[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) q[r] = has_row && r < R ? a.req[(int64_t)t * R + r] : 0.f;
    uint32_t w[TW];
    int th0 = 0, th1 = 0;
    uint32_t any = 0u;
#pragma unroll
    for (int j = 0; j < TW; ++j) w[j] = 0u;
    if (W > 0 && words && has_row) {
      Words<W> tw;
      affinity_words::load_words_at<W>(a.KW, a.K2W, a.tw + (int64_t)t * stride, tw);
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        w[j] = tw.v[j];
        any |= tw.v[j];
      }
      th0 = a.thr[(int64_t)t * 2];
      th1 = a.thr[(int64_t)t * 2 + 1];
    }
    unsigned left = __ballot_sync(full, has_row);
    int mine = -1, k = 0;
    while (left) {
      const int leader = __ffs(left) - 1;
      bool same = has_row && mine < 0;
#pragma unroll
      for (int r = 0; r < RR; ++r) {   // every lane takes part in each shuffle
        const float lv = __shfl_sync(full, q[r], leader);
        same = same && __float_as_uint(q[r]) == __float_as_uint(lv);
      }
      if (W > 0 && words) {   // every lane takes part in each shuffle here too
#pragma unroll
        for (int j = 0; j < TW; ++j) {
          const uint32_t lw = __shfl_sync(full, w[j], leader);
          same = same && w[j] == lw;
        }
        const int l0 = __shfl_sync(full, th0, leader), l1 = __shfl_sync(full, th1, leader);
        same = same && th0 == l0 && th1 == l1;
      }
      const unsigned members = __ballot_sync(full, same);
      if (same) mine = k;
      if (lane == leader) {
#pragma unroll
        for (int r = 0; r < RR; ++r) s_creq[k][r] = q[r];
        if (W > 0) {
#pragma unroll
          for (int j = 0; j < TW; ++j) s_ctw[k][j] = w[j];
          s_cthr[k][0] = th0;
          s_cthr[k][1] = th1;
        }
        s_ctest[k] = any != 0u;
      }
      left &= ~members;
      ++k;
    }
    s_class[lane] = mine;
#pragma unroll
    for (int i = 0; i < 2 + RR; ++i) s_sum[lane][i] = 0;
    const unsigned tested = __ballot_sync(full, has_row && any != 0u);
    if (lane == 0) {
      s_K = k;
      s_stage = tested != 0u;
      s_nodes = 0;
    }
  }
  __syncthreads();
  const int K = s_K;
  const int cls = s_class[lane];
  const bool stage = W > 0 && s_stage;   // some row of the block has a word set

  const uint8_t* prow = a.pred + (int64_t)(has_row ? t : 0) * a.N;
  const uint8_t* drow = a.dyn ? a.dyn + (int64_t)(has_row ? t : 0) * a.N : nullptr;
  int pf = 0, fe = 0, nodes = 0;
  int ins[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) ins[r] = 0;

  // a lane a row: its mask bytes of this warp's next chunk are in flight
  // while it works on the current one
  const int chunks = (a.N + CHUNK - 1) / CHUNK;
  Cells pc, dc;
  if (has_row && warp < chunks) {
    load_cells(prow, warp * CHUNK, a.N, a.vec, pc);
    if (drow) load_cells(drow, warp * CHUNK, a.N, a.vec, dc);
  }
  for (int c = warp; c < chunks; c += WARPS) {
    const int n0 = c * CHUNK;
    Cells npc, ndc;
    if (has_row && c + WARPS < chunks) {
      load_cells(prow, n0 + WARPS * CHUNK, a.N, a.vec, npc);
      if (drow) load_cells(drow, n0 + WARPS * CHUNK, a.N, a.vec, ndc);
    }
    // a lane a node: readiness, and each class's fit, shortfall and
    // affinity words
    const int n = n0 + lane;
    const bool ok = n < a.N && a.node_ok[n];
    float idle[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) idle[r] = ok && r < R ? a.idle[(int64_t)n * R + r] : 0.f;
    Words<W> nw;
    if (stage && ok) affinity_words::load_words_at<W>(a.KW, a.K2W, a.nwd + (int64_t)n * stride, nw);
    const uint32_t okw = __ballot_sync(full, ok);
    nodes += __popc(okw);
    uint32_t fit_w = 0u, dyn_w = full, short_w[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) short_w[r] = 0u;
    for (int q = 0; q < K; ++q) {
      bool fit = true;
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        if (r < R) {
          const float v = s_creq[q][r];
          fit = fit && ((v <= idle[r]) || (v < eps[r]));
          const uint32_t sw = __ballot_sync(full, v > idle[r] && v >= eps[r]);
          if (q == cls) short_w[r] = sw;
        }
      }
      const uint32_t f = __ballot_sync(full, fit);
      if (q == cls) fit_w = f;
      if (stage && s_ctest[q]) {   // block-uniform
        const bool cell = ok && affinity_words::words_ok<W>(s_ctw[q], s_cthr[q][0],
                                                            s_cthr[q][1], nw);
        const uint32_t d = __ballot_sync(full, cell);
        if (q == cls) dyn_w = d;
      }
    }
    // a lane a row: its counters
    if (has_row) {
      uint32_t m = cell_bits(pc, a.vec) & dyn_w;
      if (drow) m &= cell_bits(dc, a.vec);
      const uint32_t mo = m & okw;
      pf += __popc(~m & okw);
      fe += __popc(mo & fit_w);
      const uint32_t unfit = mo & ~fit_w;
#pragma unroll
      for (int r = 0; r < RR; ++r)
        if (r < R) ins[r] += __popc(unfit & short_w[r]);
    }
    pc = npc;
    dc = ndc;
  }

  // the warps' counters of each row, summed once and written once
  if (has_row) {
    atomicAdd(&s_sum[lane][0], pf);
    atomicAdd(&s_sum[lane][1], fe);
#pragma unroll
    for (int r = 0; r < RR; ++r)
      if (r < R) atomicAdd(&s_sum[lane][2 + r], ins[r]);
  }
  if (lane == 0) atomicAdd(&s_nodes, nodes);
  __syncthreads();
  if (warp == 0 && has_row) {
    a.pf[t] = s_sum[lane][0];
    a.fe[t] = s_sum[lane][1];
#pragma unroll
    for (int r = 0; r < RR; ++r)
      if (r < R) a.ins[(int64_t)t * R + r] = s_sum[lane][2 + r];
  }
  if (blockIdx.x == 0 && tid == 0) *a.nodes = s_nodes;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int W>
void launch(const Args& a, unsigned blocks, cudaStream_t s) {
  if (a.R == 4)
    failure_counts_kernel<W, 4><<<blocks, THREADS, 0, s>>>(a);
  else
    failure_counts_kernel<W, MAX_R><<<blocks, THREADS, 0, s>>>(a);
}

}  // namespace

// pf i32[T], ins i32[T, R], fe i32[T], nodes i32[1]: every row written.
// dyn (bool[T, N]) and tw (with thr, nwd, KW, K2W: the words form) are
// each optional, not both; 1 <= R <= MAX_R; KW, K2W <= 8.
extern "C" int kb_failure_counts(const uint8_t* pred, const uint8_t* dyn, const uint32_t* tw,
                                 const int32_t* thr, const uint32_t* nwd, int KW, int K2W,
                                 const float* req, const float* idle, const float* eps,
                                 const uint8_t* node_ok, int T, int N, int R, int32_t* pf,
                                 int32_t* ins, int32_t* fe, int32_t* nodes, void* stream) {
  if (T < 1 || N < 0 || R < 1 || R > MAX_R || KW > 8 || K2W > 8 || (dyn && tw))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.pred = pred; a.dyn = dyn; a.tw = tw; a.thr = thr; a.nwd = nwd;
  a.req = req; a.idle = idle; a.eps = eps; a.node_ok = node_ok;
  a.pf = pf; a.ins = ins; a.fe = fe; a.nodes = nodes;
  a.KW = KW; a.K2W = K2W; a.T = T; a.N = N; a.R = R;
  a.vec = N % 16 == 0 && aligned16(pred) && (!dyn || aligned16(dyn));
  const unsigned blocks = (unsigned)((T + ROWS - 1) / ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  switch (affinity_words::words_case(tw != nullptr, KW, K2W)) {
    case 0: launch<0>(a, blocks, s); break;
    case 1: launch<1>(a, blocks, s); break;
    case 2: launch<2>(a, blocks, s); break;
    default: launch<8>(a, blocks, s);
  }
  return (int)cudaGetLastError();
}
