// K6 · the per-step scans of the preemption loop, two entry points.
//
// Replaces the [T]- and [T, N]-wide reductions of the step body of
// kube_batch_tpu/ops/preemption.py · preemption_rounds (lines 149-260):
//
//   kb_preempt_open (no plan in progress — a preemptor is chosen this step)
//     p_new               argmin of rank over eligible tasks, lowest index
//                         on ties, index 0 when none is eligible (jnp.argmin)
//     any_eligible
//     any_victim_possible ∃ t: allocated in the snapshot and in the live
//                         state, real, not a provisional victim
//     any_direct_fit      ∃ t eligible, n real and ready:
//                         fits(req[t], FutureIdle[n]) — an early-exit
//                         [T, N, R] reduction of fp32 compares
//   kb_preempt_continue (a plan is open on node n) — the continuing
//     step's whole classification (ops/preemption.py lines 241-257)
//     v, any_victim       argmin of sacrifice (= −rank) over candidate
//                         victims on node n, lowest index on ties
//     fit_now             fits(req[p], FutureIdle[n], eps)
//     viable              the preemptor's dynamic row at n (a bool[N] row
//                         and / or the inter-pod affinity row operand,
//                         tested here as kernel K5 tests it); 1 without one
//
// On an opening step the victim on the chosen node comes from K5, which
// already walks that node's victims in sacrifice order; and the direct-fit
// test only matters when no plan is open.  So each step launches one of
// the two kernels, once.
//
// preempt_open uses the whole card.  The earlier design ran one block of
// 1,024 threads (one SM of 132) in which each thread walked whole
// eligible rows against every ready node, reading FutureIdle from global
// memory in the inner loop; most opening steps find no fit and scan every
// cell, so it took about 1.1 ms at T = 8,192, N = 512, slower than the
// plain torch version.  Now a grid of persistent blocks (up to 8 per SM)
// shares the work:
//   * the [T] part — each thread folds its grid-strided rows into a
//     packed key (rank << 32 | t), whose minimum is the argmin with the
//     lowest index on ties, and an OR of the victim test; a block reduces
//     them with warp shuffles and makes one 64-bit atomicMax on the
//     complement of the key (an atomicMin of the key on a word that
//     starts at zero) and one atomicOr;
//   * the [T, N] part — tiles of 64 task rows × 256 nodes.  A block takes
//     tiles in turn; per tile it stages the tile's eligible rows
//     (compacted by a warp ballot) with their requests and "below eps"
//     bits in shared memory, and each thread holds one node's FutureIdle
//     in registers and tests it against every staged row (a broadcast
//     read).  A tile without eligible rows costs one 64-byte read.  A
//     global `found` word in device memory is polled before every tile
//     and set on the first fit, so a step with a fit stops early
//     everywhere;
//   * the last block to finish (a ticket after a __threadfence) writes
//     the four outputs.
// The scratch words (key, found, possible, ticket) follow the outputs in
// one buffer the wrapper allocates per call; kb_preempt_open zeroes them
// with a cudaMemsetAsync on the same stream before the launch, so a call
// is a memset and one launch; the host reads the outputs with the step's
// other flags: no extra host sync.  Every
// output is a minimum or an OR, so none depends on the order in which the
// blocks run.
//
// Bound on this card: bytes when a direct fit is found early (each [T]
// input read once, the eligible rows' requests and the [N, R] FutureIdle);
// operations (2·R compares per cell) when no cell fits and every eligible
// row meets every ready node; at the preempt path's shapes, launch
// latency.
//
// preempt_continue reads p and n on the card (the plan's device scalars),
// so no launch of a continuing step takes the host's copy of n, and the
// step needs no cast, fit test or row launch around it.  One launch of a
// grid of blocks, 4 rows a thread (a block 1,024 rows), so the T scan
// spreads over the SMs: a thread reads its rows' victim bytes as one word,
// task_node only of the victims among them and rank only of those on n; a
// block folds the packed key (T−1−rank) << 32 | t by warp shuffles and
// makes one 64-bit atomicMax on its complement; block 0 meanwhile tests
// fit_now and the row's cell at n (one warp prepares p's words, as K5
// does).  The last block to arrive (a ticket after a fence) writes v and
// any_victim and clears the scratch words, which live past the outputs in
// the buffer the loop's carry keeps (zeroed once when allocated): no
// memset, no allocation, no cast a call.  Bound on this card: launch
// latency; the bytes the function needs (the victims bytes, then 4 bytes
// a candidate and 4 a candidate on n) are under 0.6 MB at 65,536 rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "affinity_row.cuh"

namespace {

constexpr int MAX_R = 8;
constexpr unsigned long long NONE = ~0ull;

__device__ bool allocated(int32_t s) {
  // ALLOCATED, BINDING, BOUND, RUNNING (api/types.py · ALLOCATED_STATUSES)
  return s == 1 || s == 3 || s == 4 || s == 5;
}

// int32 words of the scratch, zeroed before each launch
constexpr int KEY = 0;        // u64: ~(least key), 0 while none is eligible
constexpr int FOUND = 2;
constexpr int POSSIBLE = 3;
constexpr int TICKET = 4;
constexpr int SCRATCH_WORDS = 6;
constexpr int OPEN_THREADS = 256;
constexpr int TILE_ROWS = 64;
constexpr int TILE_NODES = OPEN_THREADS;   // one node per thread
constexpr int BLOCKS_PER_SM = 8;

template <int R>
__global__ void __launch_bounds__(OPEN_THREADS) preempt_open_kernel(
    int T, int N, const int32_t* __restrict__ rank,
    const uint8_t* __restrict__ elig, const int32_t* __restrict__ snap_state,
    const int32_t* __restrict__ live_state, const uint8_t* __restrict__ task_mask,
    const uint8_t* __restrict__ prov, const float* __restrict__ req,
    const float* __restrict__ future, const uint8_t* __restrict__ node_ok,
    const float* __restrict__ eps, int32_t* __restrict__ out,
    int32_t* __restrict__ scratch) {
  __shared__ unsigned long long warp_min[OPEN_THREADS / 32];
  __shared__ float rows[TILE_ROWS][R];
  __shared__ uint32_t small[TILE_ROWS];
  __shared__ int n_rows;
  __shared__ int stop;
  unsigned long long* key_word = reinterpret_cast<unsigned long long*>(scratch + KEY);
  volatile int* found = scratch + FOUND;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // -- the [T] part: argmin of rank over eligible rows, victim test ----
  unsigned long long key = NONE;
  int possible = 0;
  for (int t = blockIdx.x * OPEN_THREADS + threadIdx.x; t < T;
       t += gridDim.x * OPEN_THREADS) {
    if (elig[t]) {
      const unsigned long long k = ((unsigned long long)(uint32_t)rank[t] << 32) | (uint32_t)t;
      key = k < key ? k : key;
    }
    possible |= allocated(snap_state[t]) && allocated(live_state[t]) &&
                task_mask[t] && !prov[t];
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
    key = o < key ? o : key;
  }
  if (lane == 0) warp_min[warp] = key;
  const int any_possible = __syncthreads_or(possible);
  if (threadIdx.x == 0) {
    unsigned long long b = NONE;
    for (int w = 0; w < OPEN_THREADS / 32; ++w) b = warp_min[w] < b ? warp_min[w] : b;
    if (b != NONE) atomicMax(key_word, ~b);
    if (any_possible) atomicOr(scratch + POSSIBLE, 1);
  }

  // -- the [T, N] part: tiles of TILE_ROWS rows × TILE_NODES nodes ------
  float lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r) lim[r] = eps[r];
  const int row_tiles = (T + TILE_ROWS - 1) / TILE_ROWS;
  const int node_tiles = (N + TILE_NODES - 1) / TILE_NODES;
  const long long tiles = (long long)row_tiles * node_tiles;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = (int)(tile / node_tiles) * TILE_ROWS;
    const int n0 = (int)(tile % node_tiles) * TILE_NODES;
    if (warp == 0) {
      // stage the tile's eligible rows, compacted in row order, by warp 0
      int base = 0;
      for (int half = 0; half < TILE_ROWS; half += 32) {
        const int t = t0 + half + lane;
        const bool e = t < T && elig[t];
        const unsigned bal = __ballot_sync(0xffffffffu, e);
        if (e) {
          const int i = base + __popc(bal & ((1u << lane) - 1));
          uint32_t bits = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float q = req[(int64_t)t * R + r];
            rows[i][r] = q;
            bits |= (q < lim[r] ? 1u : 0u) << r;
          }
          small[i] = bits;
        }
        base += __popc(bal);
      }
      if (lane == 0) {
        n_rows = base;
        stop = *found;
      }
    }
    __syncthreads();
    const int n = n_rows;
    if (stop) break;
    const int m = n0 + threadIdx.x;
    if (n > 0 && m < N && node_ok[m]) {
      float f[R];
#pragma unroll
      for (int r = 0; r < R; ++r) f[r] = future[(int64_t)m * R + r];
      for (int i = 0; i < n; ++i) {
        bool ok = true;
#pragma unroll
        for (int r = 0; r < R; ++r) ok = ok && ((rows[i][r] <= f[r]) || ((small[i] >> r) & 1u));
        if (ok) {
          *found = 1;
          break;
        }
      }
    }
    __syncthreads();   // the staged rows are rewritten by the next tile
  }

  // -- the last block to finish writes the outputs ----------------------
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(scratch + TICKET, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const unsigned long long k = ~atomicAdd(key_word, 0ull);
    out[0] = k == NONE ? 0 : (int32_t)(k & 0xffffffffu);
    out[1] = k == NONE ? 0 : 1;
    out[2] = atomicAdd(scratch + POSSIBLE, 0) ? 1 : 0;
    out[3] = *found ? 1 : 0;
  }
}

template <int R>
void launch_open(int blocks, cudaStream_t stream, int T, int N, const int32_t* rank,
                 const uint8_t* elig, const int32_t* snap_state,
                 const int32_t* live_state, const uint8_t* task_mask,
                 const uint8_t* prov, const float* req, const float* future,
                 const uint8_t* node_ok, const float* eps, int32_t* out,
                 int32_t* scratch) {
  preempt_open_kernel<R><<<blocks, OPEN_THREADS, 0, stream>>>(
      T, N, rank, elig, snap_state, live_state, task_mask, prov, req, future,
      node_ok, eps, out, scratch);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// The continuing step's buffer (bytes): v i64 at 0, any_victim, fit_now
// and viable u8 at 8, 9, 10; scratch: the complement of the least key
// (u64, 0 while none) at 16, the arrival ticket (u32) at 24, both zero
// between calls.
constexpr int CONT_THREADS = 256;
constexpr int CONT_ROWS = 4;      // rows a thread
constexpr int CONT_KEY = 16, CONT_TICKET = 24;

struct ContinueArgs {
  const int32_t* rank;       // i32[T] dense ranks; sacrifice T-1-rank
  const uint8_t* victims;    // bool[T] candidate victims
  const int32_t* task_node;  // i32[T]
  const float* req;          // f32[T, R]
  const float* future;       // f32[N, R] FutureIdle
  const float* eps;          // f32[R]
  const int64_t* p;          // the plan's preemptor, on the card
  const int64_t* n;          // the plan's node, on the card
  const uint8_t* dyn;        // bool[N] or null
  affinity_row::Operand row; // p's inter-pod affinity row (task_words null: none)
  int T, R, vec;             // vec: victims read a word (4 rows) at a time
  uint8_t* buf;
};

__global__ void __launch_bounds__(CONT_THREADS) preempt_continue_kernel(ContinueArgs a) {
  __shared__ unsigned long long warp_min[CONT_THREADS / 32];
  __shared__ affinity_row::Shared s_row;
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = (int)*a.n;
  // block 0: fit_now and viable, beside its share of the scan
  if (blockIdx.x == 0) {
    if (a.row.task_words && warp == 0) affinity_row::prepare(a.row, s_row);
    __syncthreads();
    if (threadIdx.x == 0) {
      const int64_t p = *a.p;
      bool fit = true;
      for (int r = 0; r < a.R; ++r) {
        const float q = a.req[p * a.R + r];
        fit = fit && ((q <= a.future[(int64_t)n * a.R + r]) || (q < a.eps[r]));
      }
      bool viable = !a.dyn || a.dyn[n];
      if (a.row.task_words) viable = viable && affinity_row::cell(a.row, s_row, n);
      a.buf[9] = fit ? 1 : 0;
      a.buf[10] = viable ? 1 : 0;
    }
  }
  // the scan: the least (T-1-rank, t) over the victims on n
  unsigned long long key = NONE;
  const int t0 = (blockIdx.x * CONT_THREADS + threadIdx.x) * CONT_ROWS;
  if (t0 < a.T) {
    uint32_t vw = 0u;
    if (a.vec) {
      vw = *reinterpret_cast<const uint32_t*>(a.victims + t0);
    } else {
      for (int j = 0; j < CONT_ROWS; ++j)
        if (t0 + j < a.T && a.victims[t0 + j]) vw |= 0xffu << (8 * j);
    }
    for (int j = 0; vw && j < CONT_ROWS; ++j) {
      const int t = t0 + j;
      if (((vw >> (8 * j)) & 0xffu) && a.task_node[t] == n) {
        const unsigned long long k =
            ((unsigned long long)(uint32_t)(a.T - 1 - a.rank[t]) << 32) | (uint32_t)t;
        key = k < key ? k : key;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
    key = o < key ? o : key;
  }
  if (lane == 0) warp_min[warp] = key;
  __syncthreads();
  unsigned long long* key_word = reinterpret_cast<unsigned long long*>(a.buf + CONT_KEY);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(a.buf + CONT_TICKET);
  if (threadIdx.x == 0) {
    unsigned long long b = NONE;
    for (int w = 0; w < CONT_THREADS / 32; ++w) b = warp_min[w] < b ? warp_min[w] : b;
    if (b != NONE) atomicMax(key_word, ~b);
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  // the last block to arrive: the outputs, and the scratch cleared
  if (last && threadIdx.x == 0) {
    __threadfence();
    const unsigned long long k = ~atomicExch(key_word, 0ull);
    atomicExch(ticket, 0u);
    const int64_t v = k == NONE ? 0 : (int64_t)(k & 0xffffffffu);
    *reinterpret_cast<int64_t*>(a.buf) = v;
    a.buf[8] = k == NONE ? 0 : 1;
  }
}

}  // namespace

// out: i32[4] [p_new, any_eligible, any_victim_possible, any_direct_fit];
// scratch: i32[SCRATCH_WORDS], 8-byte aligned, zeroed here
extern "C" int kb_preempt_open(int T, int N, int R, const int32_t* rank,
                               const uint8_t* elig, const int32_t* snap_state,
                               const int32_t* live_state, const uint8_t* task_mask,
                               const uint8_t* prov, const float* req,
                               const float* future, const uint8_t* node_ok,
                               const float* eps, int32_t* out, int32_t* scratch,
                               cudaStream_t stream) {
  if (R < 1 || R > MAX_R) return -1;
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(int32_t) * SCRATCH_WORDS, stream);
  if (err != cudaSuccess) return (int)err;
  const long long row_tiles = (T + TILE_ROWS - 1) / TILE_ROWS;
  const long long node_tiles = (N + TILE_NODES - 1) / TILE_NODES;
  const long long cap = (long long)BLOCKS_PER_SM * sm_count();
  long long want = row_tiles * node_tiles;
  const long long rows_blocks = (T + OPEN_THREADS - 1) / OPEN_THREADS;
  if (want < rows_blocks) want = rows_blocks;
  const int blocks = (int)(want < 1 ? 1 : want < cap ? want : cap);
  switch (R) {
#define KB_OPEN_CASE(RR)                                                        \
    case RR:                                                                    \
      launch_open<RR>(blocks, stream, T, N, rank, elig, snap_state, live_state, \
                      task_mask, prov, req, future, node_ok, eps, out, scratch); \
      break;
    KB_OPEN_CASE(1) KB_OPEN_CASE(2) KB_OPEN_CASE(3) KB_OPEN_CASE(4)
    KB_OPEN_CASE(5) KB_OPEN_CASE(6) KB_OPEN_CASE(7) KB_OPEN_CASE(8)
#undef KB_OPEN_CASE
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

// buf: the continuing step's buffer (above), 8-byte aligned, its scratch
// words zero (they are again when the launch ends); p and n int64 on the
// card; dyn bool[N] or null; the row operand as affinity_row.cuh takes it.
extern "C" int kb_preempt_continue(int T, int R, const int32_t* rank, const uint8_t* victims,
                                   const int32_t* task_node, const float* req,
                                   const float* future, const float* eps, const int64_t* p,
                                   const int64_t* n, const uint8_t* dyn, KB_ROW_PARAMS,
                                   uint8_t* buf, cudaStream_t stream) {
  if (T < 1 || R < 1 || R > MAX_R || row_K > affinity_row::MAXK2 ||
      row_K2 > affinity_row::MAXK2)
    return (int)cudaErrorInvalidValue;
  KB_ROW_OPERAND;
  ContinueArgs a;
  a.rank = rank; a.victims = victims; a.task_node = task_node; a.req = req;
  a.future = future; a.eps = eps; a.p = p; a.n = n; a.dyn = dyn; a.row = row;
  a.T = T; a.R = R; a.buf = buf;
  a.vec = T % CONT_ROWS == 0 && ((uintptr_t)victims & 3u) == 0;
  const int per_block = CONT_THREADS * CONT_ROWS;
  const int blocks = (T + per_block - 1) / per_block;
  preempt_continue_kernel<<<blocks, CONT_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
