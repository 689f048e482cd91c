// K5 · victim prefix: the node an opening preemption step opens its plan
// on, in one launch: the candidate victims sorted by (node, sacrifice),
// per node the fewest victims whose release fits the preemptor, the
// preemptor's node mask, and the choice.
//
// Replaces kube_batch_tpu/ops/preemption.py · _min_victims_per_node
// (lines 80-112) and choose_node (lines 219-235): the feasible mask
// predicate_mask[p] & node_mask & node_ready & dyn_row & ~excl and the
// argmin node.
//
// kb_victim_choose, one block of 1,024 threads, T <= CTA_MAX_T rows and
// (N + 1)·T <= 2^32:
//   1. the preemptor p is read on the card (a device scalar), with its
//      request row and its predicate row;
//   2. the victims are sorted stably by (node, sacrifice T-1-rank), ties
//      by row, as the reference's stable sort orders them.  Two routes,
//      chosen in the block:
//      * counting (the default): a shared-memory histogram of the
//        victims by node, its exclusive scan, a scatter by atomic cursor
//        of each victim's key (sacrifice·T + row), and then each node's
//        run, which the scatter left in any order, is ordered by its
//        unique keys: a warp a node, each key's place the count of
//        smaller keys in the run.  That is L² / 32 compares a lane for a
//        run of L victims (config 4 holds 10-20 pods a node), so a run
//        longer than LONG_RUN sends the block to the radix route;
//      * radix: the one-block radix sort of cta_sort.cuh (K8's) over every
//        row's code node·T + sacrifice, non-victims at node N, as few
//        8-bit passes as the largest code needs; a node's run is then
//        found by binary search.
//      The counting route does one pass over the rows where the radix
//      route does two or three over all of them (the check script
//      scripts/check_torch_k5_pick.py times both at the preempt path's
//      widest opening step);
//   3. a thread a node: unless the preemptor already fits the node's
//      FutureIdle (k = 0), walk its run in sacrifice order with a float64
//      running release, rounded once to float32 and added to FutureIdle,
//      stopping at the first k whose release fits (BIG_K when none does);
//   4. the node mask pred[p] & node_ok & ~excl (& dyn) (& the
//      preemptor's inter-pod affinity row, when the caller hands the row
//      operand: one warp derives p's thresholds and terms into shared
//      memory in step 1, and each node whose k makes it a candidate is
//      tested from kernel K11's tables in registers — affinity_row.cuh,
//      the test of kernel K10's row form; nothing is written per node)
//      and a block reduction to the lowest-index allowed node with the smallest k, as
//      jnp.argmax(feasible & (kk == min kk)) picks it (node 0 when none
//      is feasible); thread 0 writes that node's first victim (the
//      sacrifice-first one) and whether the preemptor fits it with no
//      victim.
// Above CTA_MAX_T rows the caller sorts with K8's sort_by_segment and
// kb_victim_walk does steps 3 and 4 over the sorted rows.
//
// Precision: the reference takes one global float32 cumsum; the float64
// prefix here is exact for integer-valued requests below 2**53 and rounds
// once, so it agrees with the reference wherever the reference's float32
// sums are exact (ROADMAP §C).
//
// Bound on this card: bytes — the victims mask, each victim's node and
// rank, the requests of the victims walked, FutureIdle and the mask
// inputs read once, k written once: tens of KB, a few µs at most.  What
// the step paid was launches and host time (a where, a subtraction, K8's
// sort, the mask's index and three logical operations, then this
// kernel): one launch now does all of it.

#include <cstdint>
#include <cuda_runtime.h>

#include "affinity_row.cuh"
#include "cta_sort.cuh"

namespace {

constexpr int MAX_R = 8;
constexpr int BIG_K = 0x7fffffff / 4;
constexpr int LONG_RUN = 256;        // longest run the counting route orders
constexpr int ROUTE_AUTO = 0, ROUTE_RADIX = 1;

struct ChooseArgs {
  const uint8_t* victims;    // bool[T] candidate victims
  const int32_t* task_node;  // i32[T] their nodes
  const int32_t* rank;       // i32[T] dense ranks in [0, T); sacrifice T-1-rank
  const float* req;          // f32[T, R]
  const float* future;       // f32[N, R] FutureIdle
  const float* eps;          // f32[R]
  const int64_t* p;          // i64 the preemptor, on the card
  const float* preq_rows;    // f32[P, R]: the preemptor's request is row p
  const uint8_t* pred;       // bool[P, N]: its predicate row is row p
  const uint8_t* node_ok;    // bool[N]
  const uint8_t* excl;       // bool[N] nodes already failed for p
  const uint8_t* dyn;        // bool[N] or null
  affinity_row::Operand row; // p's inter-pod affinity row (task_words null: none)
  int T, N, R, passes, route;
};

// Step 1's share of the row test: p's words, thresholds and terms, by
// warp 0 (the caller's barrier publishes them).
__device__ __forceinline__ void prepare_row(const ChooseArgs& a, affinity_row::Shared& s) {
  if (a.row.task_words && threadIdx.x < 32) affinity_row::prepare(a.row, s);
}

__device__ __forceinline__ bool fits_future(const float* preq, const float* future_n,
                                            const float* eps, int R) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r)
    if (r < R) ok = ok && ((preq[r] <= future_n[r]) || (preq[r] < eps[r]));
  return ok;
}

// The fewest victims of node n, rows row(s) .. row(e - 1) in sacrifice
// order, whose float64 release fits the preemptor: 0 when it fits with
// none, BIG_K when no prefix does.
template <typename Row>
__device__ int min_victims(const ChooseArgs& a, const float* preq, const float* eps,
                           int n, int s, int e, Row row) {
  const float* fu = a.future + (int64_t)n * a.R;
  if (fits_future(preq, fu, eps, a.R)) return 0;
  double prefix[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) prefix[r] = 0.0;
  for (int j = s; j < e; ++j) {
    const int64_t t = row(j);
    bool fit = true;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < a.R) {
        prefix[r] += (double)a.req[t * a.R + r];
        const float avail = __fadd_rn(fu[r], (float)prefix[r]);
        fit = fit && ((preq[r] <= avail) || (preq[r] < eps[r]));
      }
    }
    if (fit) return j - s + 1;
  }
  return BIG_K;
}

// Steps 3 and 4: every node's k into k_out and the choice into out[5].
// run(n, s, e) gives node n's run of sorted positions, row(j) the task
// row at sorted position j.  Every thread of the block calls it.
template <typename Run, typename Row>
__device__ void walk_and_choose(const ChooseArgs& a, const float* preq, const float* eps,
                                int64_t p, Run run, Row row, const affinity_row::Shared& s_row,
                                unsigned long long* s_best, int32_t* __restrict__ k_out,
                                int32_t* __restrict__ out) {
  const uint8_t* pred = a.pred + p * a.N;
  unsigned long long mine = ~0ull;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    int s, e;
    run(n, s, e);
    const int k = min_victims(a, preq, eps, n, s, e, row);
    k_out[n] = k;
    const bool ok = k < BIG_K && pred[n] && a.node_ok[n] && !a.excl[n] &&
                    (!a.dyn || a.dyn[n]) &&
                    (!a.row.task_words || affinity_row::cell(a.row, s_row, n));
    if (ok) {
      const unsigned long long key = ((unsigned long long)k << 32) | (uint32_t)n;
      mine = key < mine ? key : mine;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(FULL, mine, off);
    mine = other < mine ? other : mine;
  }
  if ((threadIdx.x & 31) == 0) s_best[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long b = ~0ull;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) b = s_best[w] < b ? s_best[w] : b;
    const bool any = b != ~0ull;
    const int n = any ? (int)(b & 0xffffffffu) : 0;
    int s, e;
    run(n, s, e);
    out[0] = n;
    out[1] = any ? 1 : 0;
    out[2] = s < e ? (int32_t)row(s) : 0;
    out[3] = s < e ? 1 : 0;
    out[4] = fits_future(preq, a.future + (int64_t)n * a.R, eps, a.R) ? 1 : 0;
  }
}

__device__ __forceinline__ bool is_victim(const ChooseArgs& a, int i, int& node) {
  node = a.task_node[i];
  return a.victims[i] && node >= 0 && node < a.N;
}

// First position in c[0, T) whose code is >= key (c sorted).
__device__ __forceinline__ int lower_bound32(const uint32_t* c, int T, uint32_t key) {
  int lo = 0, hi = T;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Exclusive scan of v[0, n) in place by the block (a thread a contiguous
// run), and the largest value into *max_out.  Every thread calls it.
__device__ void cta_exclusive_in_place(uint32_t* v, int n, uint32_t* warp_sums,
                                       uint32_t* max_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + CTA_THREADS - 1) / CTA_THREADS;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  uint32_t sum = 0, mx = 0;
  for (int i = lo; i < hi; ++i) {
    sum += v[i];
    mx = v[i] > mx ? v[i] : mx;
  }
  mx = __reduce_max_sync(FULL, mx);
  if (lane == 0) atomicMax(max_out, mx);
  uint32_t incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = warp_sums[lane];
    uint32_t wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += t;
    }
    warp_sums[lane] = wi - w;
  }
  __syncthreads();
  uint32_t run = warp_sums[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const uint32_t c = v[i];
    v[i] = run;
    run += c;
  }
  __syncthreads();
}

// Dynamic shared memory of kb_victim_choose: the radix route's rows
// (cta_rows, 12·T bytes), or the counting route's keys u32[T], ordered
// rows u16[T] and node cursors u32[N + 1] (from byte counting_offset).
__host__ __device__ __forceinline__ size_t counting_offset(int T) {
  return ((size_t)T * 6 + 15) & ~(size_t)15;
}
__host__ __device__ __forceinline__ size_t counting_bytes(int T, int N) {
  return counting_offset(T) + (size_t)(N + 1) * 4;
}

__global__ void __launch_bounds__(CTA_THREADS, 1) victim_choose_kernel(
    ChooseArgs a, int32_t* __restrict__ k_out, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ CtaShared sh;
  __shared__ float s_preq[MAX_R], s_eps[MAX_R];
  __shared__ unsigned long long s_best[CTA_WARPS];
  __shared__ uint32_t s_maxrun;
  __shared__ affinity_row::Shared s_row;
  const int T = a.T, N = a.N, tid = threadIdx.x;
  const int64_t p = *a.p;
  prepare_row(a, s_row);
  if (tid < a.R) {
    s_preq[tid] = a.preq_rows[p * a.R + tid];
    s_eps[tid] = a.eps[tid];
  }
  if (tid == 0) {
    s_maxrun = 0;
    sh.all_and = 0xffffffffu;
    sh.any_or = 0u;
  }
  bool radix = a.route == ROUTE_RADIX;
  uint32_t* key = reinterpret_cast<uint32_t*>(smem);
  uint16_t* srt = reinterpret_cast<uint16_t*>(key + T);
  uint32_t* cur = reinterpret_cast<uint32_t*>(smem + counting_offset(T));
  __syncthreads();

  if (!radix) {
    // the histogram of the victims by node, and its scan
    for (int n = tid; n < N; n += CTA_THREADS) cur[n] = 0;
    __syncthreads();
    for (int i = tid; i < T; i += CTA_THREADS) {
      int node;
      if (is_victim(a, i, node)) atomicAdd(&cur[node], 1u);
    }
    __syncthreads();
    cta_exclusive_in_place(cur, N, sh.warp_sums, &s_maxrun);
    radix = s_maxrun > (uint32_t)LONG_RUN;   // the same in every thread
  }

  if (!radix) {
    // each victim's key at its node's cursor: after this cur[n] is the
    // end of node n's run and cur[n - 1] its start
    for (int i = tid; i < T; i += CTA_THREADS) {
      int node;
      if (is_victim(a, i, node)) {
        const uint32_t pos = atomicAdd(&cur[node], 1u);
        key[pos] = (uint32_t)(T - 1 - a.rank[i]) * (uint32_t)T + (uint32_t)i;
      }
    }
    __syncthreads();
    // a warp a node: each key's place in its run is the count of smaller
    // keys (keys are unique: they hold the row)
    const int warp = tid >> 5, lane = tid & 31;
    for (int n = warp; n < N; n += CTA_WARPS) {
      const int s = n ? (int)cur[n - 1] : 0, e = (int)cur[n];
      for (int j = s + lane; j < e; j += 32) {
        const uint32_t kj = key[j];
        int before = 0;
        for (int i = s; i < e; ++i) before += key[i] < kj;
        srt[s + before] = (uint16_t)(kj % (uint32_t)T);
      }
    }
    __syncthreads();
    walk_and_choose(
        a, s_preq, s_eps, p,
        [&](int n, int& s, int& e) { s = n ? (int)cur[n - 1] : 0; e = (int)cur[n]; },
        [&](int j) { return (int64_t)srt[j]; }, s_row, s_best, k_out, out);
    return;
  }

  // the radix route: every row, non-victims at node N
  const CtaRows r = cta_rows(smem, T);
  uint32_t all_and = 0xffffffffu, any_or = 0u;
  for (int i = tid; i < T; i += CTA_THREADS) {
    int node;
    const uint32_t seg = is_victim(a, i, node) ? (uint32_t)node : (uint32_t)N;
    const uint32_t v = seg * (uint32_t)T + (uint32_t)(T - 1 - a.rank[i]);
    r.code[0][i] = v;
    r.id[0][i] = (uint16_t)i;
    all_and &= v;
    any_or |= v;
  }
  const uint32_t varies = cta_varying_bits(all_and, any_or, sh);
  int c = 0;
  for (int q = 0; q < a.passes; ++q) {
    if (!((varies >> (8 * q)) & 0xffu)) continue;   // every row shares this digit
    cta_pass(r.code[c], r.id[c], r.code[c ^ 1], r.id[c ^ 1], T, 8 * q, sh);
    c ^= 1;
  }
  __syncthreads();
  const uint32_t* code = r.code[c];
  const uint16_t* id = r.id[c];
  walk_and_choose(
      a, s_preq, s_eps, p,
      [&](int n, int& s, int& e) {
        s = lower_bound32(code, T, (uint32_t)n * (uint32_t)T);
        e = lower_bound32(code, T, (uint32_t)(n + 1) * (uint32_t)T);
      },
      [&](int j) { return (int64_t)id[j]; }, s_row, s_best, k_out, out);
}

__device__ __forceinline__ int lower_bound64(const int64_t* __restrict__ s, int T,
                                             int64_t key) {
  int lo = 0, hi = T;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Steps 3 and 4 over rows K8 sorted: perm (sorted position → row) and
// s_node (sorted position → node, N for non-victims).
__global__ void __launch_bounds__(CTA_THREADS, 1) victim_walk_kernel(
    ChooseArgs a, const int64_t* __restrict__ perm, const int64_t* __restrict__ s_node,
    int32_t* __restrict__ k_out, int32_t* __restrict__ out) {
  __shared__ float s_preq[MAX_R], s_eps[MAX_R];
  __shared__ unsigned long long s_best[CTA_WARPS];
  __shared__ affinity_row::Shared s_row;
  const int64_t p = *a.p;
  prepare_row(a, s_row);
  if ((int)threadIdx.x < a.R) {
    s_preq[threadIdx.x] = a.preq_rows[p * a.R + threadIdx.x];
    s_eps[threadIdx.x] = a.eps[threadIdx.x];
  }
  __syncthreads();
  const int T = a.T;
  walk_and_choose(
      a, s_preq, s_eps, p,
      [&](int n, int& s, int& e) {
        s = lower_bound64(s_node, T, n);
        e = lower_bound64(s_node, T, (int64_t)n + 1);
      },
      [&](int j) { return perm[j]; }, s_row, s_best, k_out, out);
}

ChooseArgs make_args(const uint8_t* victims, const int32_t* task_node, const int32_t* rank,
                     const float* req, const float* future, const float* eps,
                     const int64_t* p, const float* preq_rows, const uint8_t* pred,
                     const uint8_t* node_ok, const uint8_t* excl, const uint8_t* dyn,
                     const affinity_row::Operand* row, int T, int N, int R) {
  ChooseArgs a;
  a.row = *row;
  a.victims = victims; a.task_node = task_node; a.rank = rank; a.req = req;
  a.future = future; a.eps = eps; a.p = p; a.preq_rows = preq_rows; a.pred = pred;
  a.node_ok = node_ok; a.excl = excl; a.dyn = dyn;
  a.T = T; a.N = N; a.R = R; a.passes = 0; a.route = ROUTE_AUTO;
  return a;
}

}  // namespace

// out: i32[N + 5] — k[N], then [n_best, any_feasible, first victim on
// n_best (0 if none), any victim on n_best, preemptor fits n_best with no
// victim].  One launch: 1 <= T <= CTA_MAX_T, 1 <= N, (N + 1)·T <= 2^32,
// 1 <= R <= MAX_R; `passes` the 8-bit digits of (N + 1)·T - 1; route 0
// lets the block choose, 1 takes the radix route.
extern "C" int kb_victim_choose(const uint8_t* victims, const int32_t* task_node,
                                const int32_t* rank, const float* req, const float* future,
                                const float* eps, const int64_t* p, const float* preq_rows,
                                const uint8_t* pred, const uint8_t* node_ok,
                                const uint8_t* excl, const uint8_t* dyn, KB_ROW_PARAMS, int T,
                                int N, int R, int passes, int route, int32_t* out, void* stream) {
  if (T < 1 || T > CTA_MAX_T || N < 1 || R < 1 || R > MAX_R || passes < 1 || passes > 4 ||
      (uint64_t)(N + 1) * (uint64_t)T > (1ull << 32) || row_K > affinity_row::MAXK2 ||
      row_K2 > affinity_row::MAXK2)
    return (int)cudaErrorInvalidValue;
  KB_ROW_OPERAND;
  // dynamic shared memory: what the opt-in leaves beside the static arrays
  static int limit = -1;
  if (limit < 0) {
    cudaFuncAttributes attr;
    int err = (int)cudaFuncGetAttributes(&attr, victim_choose_kernel);
    int dev = 0, optin = 0;
    if (!err) err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err) return err;
    const int room = optin - (int)attr.sharedSizeBytes;
    err = (int)cudaFuncSetAttribute(victim_choose_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    if (err) return err;
    limit = room;
  }
  const size_t radix_bytes = cta_smem_bytes(T);
  const size_t count_bytes = counting_bytes(T, N);
  if (count_bytes > (size_t)limit) route = ROUTE_RADIX;   // too many nodes to count
  const size_t smem = route == ROUTE_RADIX ? radix_bytes
                      : (radix_bytes > count_bytes ? radix_bytes : count_bytes);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  ChooseArgs a = make_args(victims, task_node, rank, req, future, eps, p, preq_rows, pred,
                           node_ok, excl, dyn, &row, T, N, R);
  a.passes = passes;
  a.route = route;
  victim_choose_kernel<<<1, CTA_THREADS, smem, (cudaStream_t)stream>>>(a, out, out + N);
  return (int)cudaGetLastError();
}

// Steps 3 and 4 after K8's sort_by_segment (the route above CTA_MAX_T
// rows): perm and s_node as it returns them, T >= 1, N >= 1.
extern "C" int kb_victim_walk(const int64_t* perm, const int64_t* s_node, const float* req,
                              const float* future, const float* eps, const int64_t* p,
                              const float* preq_rows, const uint8_t* pred,
                              const uint8_t* node_ok, const uint8_t* excl, const uint8_t* dyn,
                              KB_ROW_PARAMS, int T, int N, int R, int32_t* out, void* stream) {
  if (T < 1 || N < 1 || R < 1 || R > MAX_R || row_K > affinity_row::MAXK2 ||
      row_K2 > affinity_row::MAXK2)
    return (int)cudaErrorInvalidValue;
  KB_ROW_OPERAND;
  ChooseArgs a = make_args(nullptr, nullptr, nullptr, req, future, eps, p, preq_rows, pred,
                           node_ok, excl, dyn, &row, T, N, R);
  victim_walk_kernel<<<1, CTA_THREADS, 0, (cudaStream_t)stream>>>(a, perm, s_node, out,
                                                                   out + N);
  return (int)cudaGetLastError();
}
