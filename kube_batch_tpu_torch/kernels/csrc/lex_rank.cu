// K8 · lex_rank: stable radix sorts for the tiered rank, and the tail of
// the weighted-fair-queueing virtual start times; three entry points.
//
// Replaces kube_batch_tpu/framework/policy.py · rank_fn (its jnp.lexsort
// over the tiered order keys) and virtual_start_times, and
// ops/assignment.py · rank_from_keys / _segment_prefix's (segment, rank)
// sort as vtime uses it.
//
// kb_lex_push_many: m stable least-significant-digit radix sorts, one per
// key, least significant key first, each of key[perm] carrying perm;
// writes the final order and its dense rank (rank[perm_out[i]] = i).  A
// float32 key maps to an order-preserving u32 code: the sign bit of a
// positive key flips, every bit of a negative key flips, -0.0 and +0.0
// share one code and every NaN takes the code above +inf — the order of
// a stable torch.argsort and of jnp.lexsort, which keep equal keys (both
// zeros, all NaNs) in index order.
// kb_sort_by_segment: the same sort of the code seg·T + rank over the
// digits the largest code needs; it writes the sorted segment ids
// (code / T).
//
// Bound on this card: neither bytes nor operations.  A key of 65,536 rows
// is 256 KB and each pass does a few integer operations a row; what the
// sorts cost is launches, so the design cuts them:
//
// * One block for T <= 16,384 rows (cta_lex_kernel, cta_seg_kernel; the
//   pass is cta_sort.cuh's, shared with K5): 1,024
//   threads keep the u32 codes and the u16 row ids of every row in dynamic
//   shared memory, double-buffered (16,384 x 12 B = 192 KB, under the
//   227 KB opt-in), and run every 8-bit pass of every key of the call in
//   one launch.  A pass: warp w owns a run of consecutive rows and counts
//   its digits (rows of one digit find each other with __match_any_sync;
//   warp-private u16 counters, no atomics); four threads a digit turn the
//   32 warps' counts of the digit into warp offsets and a total, and a
//   scan of the totals gives each digit's start; each warp walks its rows again in
//   index order and scatters them.  A row's place among rows of its digit
//   follows its index: the sort is stable.  A pass whose rows all share
//   one digit would move nothing: the AND and OR of the codes, taken as
//   they are made, find it, and it is skipped (small integer keys have
//   constant low bytes).
// * Wider sorts (T = 65,536 on the main path) keep the rows in device
//   memory: one launch codes the key and counts the digits of every pass
//   (wide_prepare), then one launch per pass scatters (wide_scatter).  A
//   block takes its tile in the order blocks start (a ticket), counts its
//   tile's digits and publishes them; it finds the rows of its digit in
//   earlier tiles by looking back over their published counts (a tile
//   that knows its inclusive prefix publishes that, and the walk stops
//   there), so no launch computes per-tile histograms.  Digits are 8 or 9
//   bits, as few passes as the largest code needs: a segment key below
//   2^18 (three segments at 65,536 rows) takes two 9-bit passes.  Within
//   its tile a block places rows in index order as the one-block pass
//   does, 256 rows at a time.  One memset per key zeroes the counts,
//   published prefixes and tickets.
//
// kb_vtime: the weighted-fair-queueing virtual start times of one call of
// framework/policy.py · virtual_start_times, in one launch of one
// 1,024-thread block (cta_vtime_kernel) when T <= 16,384 and the key
// seg·T + rank fits 32 bits.  The block
//   1. makes each row's segment key from valid and seg (valid ? clamp(seg,
//      0, S - 1) : S) and its code key·T + base_rank;
//   2. sorts the codes by the one-block radix of cta_seg_kernel (the same
//      shared-memory rows, passes and skipped constant digits);
//   3. per resource dimension, runs a segmented float64 scan over the
//      sorted rows: each thread owns a run of ceil(T / 1,024) consecutive
//      rows (up to 16; instantiated for 8 and 16), sums its run from its
//      last segment start, and a block scan of the (segment started, sum)
//      pairs gives each run the sum that flows into it; a row's prefix is
//      then the sum of the valid requests of the earlier rows of its
//      segment (rows of segment S, the invalid ones, add 0);
//   4. start = f32(alloc_seg + before), ratio = start / max(denom, 1e-9)
//      (__fdiv_rn) where denom > 0, else 1e30 or 0; the running max over
//      dims stays in the thread's registers and is scattered to
//      out[perm[i]] at the end.
// A thread's run is contiguous, so reading it from the shared sort arrays
// conflicts across banks: each row's id and segment are read there once
// into registers, not once a dimension.  The float64 rows (8,192 x R x 8
// bytes) do not fit in shared memory: a run's requests are read from
// device memory once a dimension, all in flight together.  Bound: neither
// bytes (16,384 rows are under 0.4 MB) nor operations; what the call cost
// before was launches (a where, a clamp, the sort and three tail
// kernels), and this is one.
//
// kb_vtime_sorted, the wider form (T > 16,384, the main path's 65,536
// rows, after kb_sort_by_segment): over rows sorted by (segment, base
// rank), the same prefix and ratio, max over dims, scattered to
// out[perm[i]].  The prefix is global and blocked: vtime_tile_sums adds
// each 1024-row tile's requests, vtime_prefix writes every row's exclusive
// prefix (the earlier tiles' sums plus a block scan), and vtime_finish
// subtracts the prefix at the row's segment start (found by binary
// search).  Like kb_vtime it reads alloc_seg and denom_seg at their
// strides (drf's denominator is one row broadcast over the segments).
//
// Both forms take the float64 rule of api/snapshot.py: for integer-valued
// requests whose column totals stay below 2**53 every partial sum is
// exact, so the segmented scan, the blocked global prefix less the prefix
// at the segment's start, and the plain version's global cumsum less the
// same are equal bit for bit, in any order of addition.
//
// No entry reads anything back on the host or allocates: the caller gives
// the scratch, sized from the shapes alone.

#include <cstdint>
#include <cuda_runtime.h>

#include "cta_sort.cuh"

namespace {

constexpr int MAX_KEYS = 32;   // keys per one-block launch

// wide sorts
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int ITEMS = 8;
constexpr int TILE = BLOCK * ITEMS;
constexpr int MAX_BITS = 9;
constexpr int MAX_RADIX = 1 << MAX_BITS;
constexpr int MAX_PASSES = 8;
static_assert(MAX_RADIX == 2 * BLOCK, "two digits per thread");
constexpr uint32_t FLAG_AGG = 1u << 30;      // a tile's own count
constexpr uint32_t FLAG_PREFIX = 2u << 30;   // the count of it and every earlier tile
constexpr uint32_t COUNT_MASK = FLAG_AGG - 1u;

constexpr int VT_ITEMS = 4;
constexpr int VT_TILE = BLOCK * VT_ITEMS;
constexpr int MAX_R = 8;

__device__ __forceinline__ uint32_t f32_code(float x) {
  if (x != x) return 0xffffffffu;      // every NaN: above +inf
  if (x == 0.0f) return 0x80000000u;   // -0.0 == +0.0
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u ^ 0x80000000u);
}

// -- one-block sorts ----------------------------------------------------------

struct KeyList {
  const float* key[MAX_KEYS];
};

// m keys (least significant first) of the order perm_in (null: identity),
// every pass in one block; writes the order and its dense rank.
__global__ void __launch_bounds__(CTA_THREADS, 1) cta_lex_kernel(
    KeyList keys, int m, const int64_t* perm_in, int T, int64_t* perm_out,
    int32_t* __restrict__ rank_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ CtaShared sh;
  const CtaRows r = cta_rows(smem, T);
  for (int i = threadIdx.x; i < T; i += CTA_THREADS)
    r.id[0][i] = (uint16_t)(perm_in ? perm_in[i] : i);
  int cur = 0;
  for (int k = 0; k < m; ++k) {
    __syncthreads();
    if (threadIdx.x == 0) {
      sh.all_and = 0xffffffffu;
      sh.any_or = 0u;
    }
    __syncthreads();
    const float* key = keys.key[k];
    uint32_t* c = cur ? r.code[1] : r.code[0];
    const uint16_t* id = cur ? r.id[1] : r.id[0];
    uint32_t all_and = 0xffffffffu, any_or = 0u;
    for (int i = threadIdx.x; i < T; i += CTA_THREADS) {
      const uint32_t v = f32_code(key[id[i]]);
      c[i] = v;
      all_and &= v;
      any_or |= v;
    }
    const uint32_t varies = cta_varying_bits(all_and, any_or, sh);
    for (int p = 0; p < 4; ++p) {
      if (!((varies >> (8 * p)) & 0xffu)) continue;   // every row shares this digit
      cta_pass(cur ? r.code[1] : r.code[0], cur ? r.id[1] : r.id[0],
               cur ? r.code[0] : r.code[1], cur ? r.id[0] : r.id[1], T, 8 * p, sh);
      cur ^= 1;
    }
  }
  __syncthreads();
  const uint16_t* id = cur ? r.id[1] : r.id[0];
  for (int i = threadIdx.x; i < T; i += CTA_THREADS) {
    const int v = id[i];
    perm_out[i] = v;
    rank_out[v] = i;
  }
}

// The (segment, rank) sort of T rows with (S + 1)·T <= 2^32 in one block.
__global__ void __launch_bounds__(CTA_THREADS, 1) cta_seg_kernel(
    const int32_t* __restrict__ seg, const int32_t* __restrict__ rank, int T, int passes,
    int64_t* __restrict__ perm_out, int64_t* __restrict__ seg_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ CtaShared sh;
  const CtaRows r = cta_rows(smem, T);
  if (threadIdx.x == 0) {
    sh.all_and = 0xffffffffu;
    sh.any_or = 0u;
  }
  __syncthreads();
  uint32_t all_and = 0xffffffffu, any_or = 0u;
  for (int i = threadIdx.x; i < T; i += CTA_THREADS) {
    const uint32_t v = (uint32_t)seg[i] * (uint32_t)T + (uint32_t)rank[i];
    r.code[0][i] = v;
    r.id[0][i] = (uint16_t)i;
    all_and &= v;
    any_or |= v;
  }
  const uint32_t varies = cta_varying_bits(all_and, any_or, sh);
  int cur = 0;
  for (int p = 0; p < passes; ++p) {
    if (!((varies >> (8 * p)) & 0xffu)) continue;   // every row shares this digit
    cta_pass(cur ? r.code[1] : r.code[0], cur ? r.id[1] : r.id[0],
             cur ? r.code[0] : r.code[1], cur ? r.id[0] : r.id[1], T, 8 * p, sh);
    cur ^= 1;
  }
  __syncthreads();
  const uint32_t* c = cur ? r.code[1] : r.code[0];
  const uint16_t* id = cur ? r.id[1] : r.id[0];
  for (int i = threadIdx.x; i < T; i += CTA_THREADS) {
    perm_out[i] = id[i];
    seg_out[i] = c[i] / (uint32_t)T;
  }
}

// -- vtime in one block -------------------------------------------------------

// A run of sorted rows in the segmented scan: whether a segment starts in
// it, and the sum since its last start (since its first row when none does).
struct SegSum {
  int start;
  double sum;
};

__device__ __forceinline__ SegSum seg_combine(SegSum a, SegSum b) {
  return {a.start | b.start, b.start ? b.sum : a.sum + b.sum};
}

__device__ __forceinline__ SegSum seg_shfl_up(SegSum v, int o) {
  return {__shfl_up_sync(FULL, v.start, o), __shfl_up_sync(FULL, v.sum, o)};
}

// Exclusive segmented scan of one run per thread across the block, in
// thread order.  Every thread of the block calls it.
__device__ SegSum cta_seg_exclusive(SegSum v, SegSum* warp_tot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  SegSum incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const SegSum t = seg_shfl_up(incl, o);
    if (lane >= o) incl = seg_combine(t, incl);
  }
  SegSum excl = seg_shfl_up(incl, 1);
  if (lane == 0) excl = {0, 0.0};
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {   // CTA_WARPS == 32: one warp total a lane
    SegSum wi = warp_tot[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const SegSum t = seg_shfl_up(wi, o);
      if (lane >= o) wi = seg_combine(t, wi);
    }
    SegSum we = seg_shfl_up(wi, 1);
    if (lane == 0) we = {0, 0.0};
    warp_tot[lane] = we;
  }
  __syncthreads();
  const SegSum out = seg_combine(warp_tot[warp], excl);
  __syncthreads();   // warp_tot is written again by the next call
  return out;
}
static_assert(CTA_WARPS == 32, "one warp scans the warp totals");

struct VtimeArgs {
  const int32_t* seg;     // i32[T] segment per task
  const int32_t* rank;    // i32[T] base rank, in [0, T)
  const float* req;       // f32[T, R], contiguous
  const bool* valid;      // bool[T]
  const float* alloc;     // f32[S, R] at strides (alloc_s0, alloc_s1)
  const float* denom;     // f32[S, R] at strides (denom_s0, denom_s1)
  int64_t alloc_s0, alloc_s1, denom_s0, denom_s1;
  int T, R, S, passes;
};

// The virtual start times of T <= PER·CTA_THREADS rows, (S + 1)·T <= 2^32.
// After the sort each thread owns a run of PER or fewer consecutive
// sorted rows and keeps, in registers, their row ids, clamped segments,
// segment-start and valid bits and running max: the shared code and id
// arrays are read once per row (a thread's run is contiguous, so those
// reads conflict across banks, and once is what they cost), and every
// loop over a run is unrolled so that its loads are in flight together.
template <int PER>
__global__ void __launch_bounds__(CTA_THREADS, 1) cta_vtime_kernel(
    VtimeArgs a, float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ CtaShared sh;
  __shared__ SegSum warp_tot[CTA_WARPS];
  const int T = a.T, S = a.S;
  const CtaRows r = cta_rows(smem, T);
  if (threadIdx.x == 0) {
    sh.all_and = 0xffffffffu;
    sh.any_or = 0u;
  }
  __syncthreads();
  uint32_t all_and = 0xffffffffu, any_or = 0u;
  for (int i = threadIdx.x; i < T; i += CTA_THREADS) {
    const int s = a.seg[i];
    const uint32_t key = a.valid[i] ? (uint32_t)(s < 0 ? 0 : (s > S - 1 ? S - 1 : s))
                                    : (uint32_t)S;
    const uint32_t v = key * (uint32_t)T + (uint32_t)a.rank[i];
    r.code[0][i] = v;
    r.id[0][i] = (uint16_t)i;
    all_and &= v;
    any_or |= v;
  }
  const uint32_t varies = cta_varying_bits(all_and, any_or, sh);
  int cur = 0;
  for (int p = 0; p < a.passes; ++p) {
    if (!((varies >> (8 * p)) & 0xffu)) continue;   // every row shares this digit
    cta_pass(cur ? r.code[1] : r.code[0], cur ? r.id[1] : r.id[0],
             cur ? r.code[0] : r.code[1], cur ? r.id[0] : r.id[1], T, 8 * p, sh);
    cur ^= 1;
  }
  __syncthreads();
  const uint32_t* code = cur ? r.code[1] : r.code[0];
  const uint16_t* id = cur ? r.id[1] : r.id[0];
  const int per = (T + CTA_THREADS - 1) / CTA_THREADS;
  const int lo = min(T, (int)threadIdx.x * per), hi = min(T, lo + per);
  // the run: row ids, clamped segments (segment S, the invalid rows, is
  // clamped to S - 1 as the plain version clamps it), and bit j of `head`
  // / `valid` for row lo + j: it starts a segment / it is valid
  int row[PER], seg[PER];
  uint32_t head = 0, valid = 0;
  uint32_t prev = lo > 0 && lo < hi ? code[lo - 1] / (uint32_t)T : 0xffffffffu;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = lo + j;
    row[j] = 0;
    seg[j] = 0;
    if (i < hi) {
      const uint32_t g = code[i] / (uint32_t)T;
      row[j] = id[i];
      seg[j] = g > (uint32_t)(S - 1) ? S - 1 : (int)g;
      head |= (uint32_t)(i == 0 || g != prev) << j;
      valid |= (uint32_t)(g < (uint32_t)S) << j;
      prev = g;
    }
  }
  float mx[PER];
  for (int c = 0; c < a.R; ++c) {
    float x[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j)
      x[j] = (valid >> j) & 1u ? a.req[(size_t)row[j] * a.R + c] : 0.0f;
    SegSum run = {0, 0.0};
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (lo + j < hi) {
        if ((head >> j) & 1u) run = {1, (double)x[j]};
        else run.sum += (double)x[j];
      }
    }
    double before = cta_seg_exclusive(run, warp_tot).sum;
    float al[PER], dn[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      al[j] = lo + j < hi ? a.alloc[seg[j] * a.alloc_s0 + c * a.alloc_s1] : 0.0f;
      dn[j] = lo + j < hi ? a.denom[seg[j] * a.denom_s0 + c * a.denom_s1] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (lo + j < hi) {
        if ((head >> j) & 1u) before = 0.0;
        const float st = (float)((double)al[j] + before);
        const float ratio = dn[j] > 0.0f ? __fdiv_rn(st, fmaxf(dn[j], 1e-9f))
                                         : (st > 0.0f ? 1e30f : 0.0f);
        mx[j] = c == 0 ? ratio : fmaxf(mx[j], ratio);
        before += (double)x[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (lo + j < hi) out[row[j]] = mx[j];
}


// -- wide sorts ---------------------------------------------------------------

// Exclusive prefix of one uint32 per thread across the block.
__device__ uint32_t block_exclusive(uint32_t v, uint32_t* warp_sums) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < WARPS ? warp_sums[lane] : 0;
    uint32_t wi = w;
    for (int o = 1; o < WARPS; o <<= 1) {
      const uint32_t t = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < WARPS) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  const uint32_t out = warp_sums[warp] + incl - v;
  __syncthreads();
  return out;
}

// Codes of one key (key[id]: id from `ids` when ids_given, else from
// perm64 or the row number, and then written to ids) or of the segment
// key, and the digit counts of every pass, added into hist[pass][MAX_RADIX].
template <typename K>
__global__ void __launch_bounds__(BLOCK) wide_prepare(
    const float* __restrict__ key, const int64_t* __restrict__ perm64, bool ids_given,
    const int32_t* __restrict__ seg, const int32_t* __restrict__ rank, int64_t T,
    int bits, int passes, K* __restrict__ code, uint32_t* __restrict__ ids,
    uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[MAX_PASSES][MAX_RADIX];
  const uint32_t radix = 1u << bits;
  for (int i = threadIdx.x; i < passes * MAX_RADIX; i += BLOCK) (&h[0][0])[i] = 0;
  __syncthreads();
  const int64_t tile0 = (int64_t)blockIdx.x * TILE;
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = tile0 + k * BLOCK + threadIdx.x;
    if (i >= T) break;
    K c;
    if (key) {
      uint32_t id;
      if (ids_given) {
        id = ids[i];
      } else {
        id = perm64 ? (uint32_t)perm64[i] : (uint32_t)i;
        ids[i] = id;
      }
      c = (K)f32_code(key[id]);
    } else {
      c = (K)(uint32_t)seg[i] * (K)T + (K)(uint32_t)rank[i];
      ids[i] = (uint32_t)i;
    }
    code[i] = c;
    for (int p = 0; p < passes; ++p)
      atomicAdd(&h[p][(uint32_t)(c >> (p * bits)) & (radix - 1u)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * MAX_RADIX; i += BLOCK) {
    const uint32_t n = (&h[0][0])[i];
    if (n) atomicAdd(&hist[i], n);
  }
}

// One pass of a wide sort over the `bits`-bit digit at `shift`.  The last
// pass also writes perm_out, and rank_out (lex) or seg_out (segments).
template <typename K>
__global__ void __launch_bounds__(BLOCK) wide_scatter(
    const K* __restrict__ code_in, const uint32_t* __restrict__ ids_in, int64_t T,
    int shift, int bits, const uint32_t* __restrict__ hist, uint32_t* status,
    uint32_t* ticket, K* __restrict__ code_out, uint32_t* __restrict__ ids_out,
    int64_t* __restrict__ perm_out, int32_t* __restrict__ rank_out,
    int64_t* __restrict__ seg_out, uint64_t seg_div) {
  __shared__ uint32_t start[MAX_RADIX];
  __shared__ uint32_t cnt[MAX_RADIX];
  __shared__ uint32_t total[MAX_RADIX];
  __shared__ uint16_t wcnt[WARPS][MAX_RADIX];
  __shared__ uint32_t warp_sums[WARPS];
  __shared__ uint32_t tile_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int radix = 1 << bits;
  const uint32_t dmask = (uint32_t)radix - 1u;
  if (tid == 0) tile_sh = atomicAdd(ticket, 1u);
  for (int d = tid; d < radix; d += BLOCK) cnt[d] = 0;
  __syncthreads();
  const uint32_t tile = tile_sh;
  const int64_t tile0 = (int64_t)tile * TILE;
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = tile0 + k * BLOCK + tid;
    if (i < T) atomicAdd(&cnt[(uint32_t)(code_in[i] >> shift) & dmask], 1u);
  }
  // thread tid holds digits 2·tid and 2·tid + 1; block_exclusive's
  // barriers also order the tile counts above
  const int d0 = 2 * tid;
  const uint32_t g0 = d0 < radix ? hist[d0] : 0u;
  const uint32_t g1 = d0 + 1 < radix ? hist[d0 + 1] : 0u;
  const uint32_t gstart = block_exclusive(g0 + g1, warp_sums);
  for (int j = 0; j < 2; ++j) {
    const int d = d0 + j;
    if (d >= radix) break;
    const uint32_t own = cnt[d];
    uint32_t excl = 0;
    uint32_t* mine = status + (size_t)tile * MAX_RADIX + d;
    if (tile == 0) {
      atomicExch(mine, FLAG_PREFIX | own);
    } else {
      atomicExch(mine, FLAG_AGG | own);
      const volatile uint32_t* st = status;
      for (int t = (int)tile - 1; t >= 0; --t) {
        uint32_t v;
        do {
          v = st[(size_t)t * MAX_RADIX + d];
        } while ((v & ~COUNT_MASK) == 0u);
        excl += v & COUNT_MASK;
        if (v & FLAG_PREFIX) break;
      }
      atomicExch(mine, FLAG_PREFIX | (excl + own));
    }
    start[d] = gstart + (j ? g0 : 0u) + excl;
  }
  __syncthreads();
  const uint32_t below = (1u << lane) - 1u;
  for (int k = 0; k < ITEMS; ++k) {
    for (int d = tid; d < radix; d += BLOCK)
      for (int w = 0; w < WARPS; ++w) wcnt[w][d] = 0;
    __syncthreads();
    const int64_t i = tile0 + k * BLOCK + tid;
    const bool ok = i < T;
    K c = 0;
    uint32_t id = 0, d = (uint32_t)radix;   // rows past T share a digit of their own
    if (ok) {
      c = code_in[i];
      id = ids_in[i];
      d = (uint32_t)(c >> shift) & dmask;
    }
    const unsigned peers = __match_any_sync(FULL, d);
    const uint32_t lrank = __popc(peers & below);
    if (ok && lrank == 0) wcnt[warp][d] = (uint16_t)__popc(peers);
    __syncthreads();
    for (int dd = tid; dd < radix; dd += BLOCK) {
      uint32_t run = 0;
      for (int w = 0; w < WARPS; ++w) {
        const uint32_t n = wcnt[w][dd];
        wcnt[w][dd] = (uint16_t)run;
        run += n;
      }
      total[dd] = run;
    }
    __syncthreads();
    if (ok) {
      const uint32_t pos = start[d] + wcnt[warp][d] + lrank;
      code_out[pos] = c;
      ids_out[pos] = id;
      if (perm_out) perm_out[pos] = id;
      if (rank_out) rank_out[id] = (int32_t)pos;
      if (seg_out) seg_out[pos] = (int64_t)((uint64_t)c / seg_div);
    }
    __syncthreads();
    for (int dd = tid; dd < radix; dd += BLOCK) start[dd] += total[dd];
    __syncthreads();
  }
}

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// The wide sorts' scratch: codes K[2T] | ids u32[2T] | the zeroed control
// words: counts u32[passes][MAX_RADIX], published prefixes
// u32[passes][tiles][MAX_RADIX], tickets u32[passes].  kernels/lex_rank.py ·
// wide_scratch_bytes computes the same size.
struct Wide {
  void* codes[2];
  uint32_t* ids[2];
  uint32_t *hist, *status, *ticket;
  size_t ctl_bytes;
  int tiles;
};

Wide wide_layout(void* scratch, int64_t T, size_t code_bytes, int passes) {
  Wide w;
  uint8_t* p = (uint8_t*)scratch;
  w.tiles = (int)((T + TILE - 1) / TILE);
  w.codes[0] = p;
  w.codes[1] = p + T * code_bytes;
  p += align256(2 * T * code_bytes);
  w.ids[0] = (uint32_t*)p;
  w.ids[1] = w.ids[0] + T;
  p += align256(2 * T * 4);
  w.hist = (uint32_t*)p;
  w.status = w.hist + (size_t)passes * MAX_RADIX;
  w.ticket = w.status + (size_t)passes * w.tiles * MAX_RADIX;
  w.ctl_bytes = 4 * ((size_t)passes * MAX_RADIX * (1 + w.tiles) + passes);
  return w;
}

// The passes of one key after wide_prepare: buffer p % 2 to buffer (p + 1) % 2.
template <typename K>
void wide_passes(const Wide& w, int64_t T, int bits, int passes, bool last,
                 int64_t* perm_out, int32_t* rank_out, int64_t* seg_out,
                 uint64_t seg_div, cudaStream_t s) {
  for (int p = 0; p < passes; ++p) {
    const int in = p % 2, out = 1 - in;
    const bool fin = last && p == passes - 1;
    wide_scatter<K><<<w.tiles, BLOCK, 0, s>>>(
        (const K*)w.codes[in], w.ids[in], T, p * bits, bits,
        w.hist + (size_t)p * MAX_RADIX, w.status + (size_t)p * w.tiles * MAX_RADIX,
        w.ticket + p, (K*)w.codes[out], w.ids[out], fin ? perm_out : nullptr,
        fin ? rank_out : nullptr, fin ? seg_out : nullptr, seg_div);
  }
}

// -- vtime ------------------------------------------------------------------

__device__ __forceinline__ double row_req(const int64_t* perm, const float* req,
                                          const bool* valid, int64_t i, int R,
                                          int c) {
  const int64_t p = perm[i];
  return valid[p] ? (double)req[p * R + c] : 0.0;
}

__global__ void vtime_tile_sums(const int64_t* __restrict__ perm,
                                const float* __restrict__ req,
                                const bool* __restrict__ valid, int64_t T,
                                int R, double* __restrict__ tile_sum) {
  __shared__ double part[BLOCK];
  const int64_t row0 = (int64_t)blockIdx.x * VT_TILE + threadIdx.x * VT_ITEMS;
  for (int c = 0; c < R; ++c) {
    double acc = 0.0;
    for (int j = 0; j < VT_ITEMS; ++j)
      if (row0 + j < T) acc += row_req(perm, req, valid, row0 + j, R, c);
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int h = BLOCK / 2; h > 0; h >>= 1) {
      if ((int)threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) tile_sum[(int64_t)blockIdx.x * R + c] = part[0];
    __syncthreads();
  }
}

__global__ void vtime_prefix(const int64_t* __restrict__ perm,
                             const float* __restrict__ req,
                             const bool* __restrict__ valid, int64_t T, int R,
                             const double* __restrict__ tile_sum,
                             double* __restrict__ excl) {
  __shared__ double warp_sums[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row0 = (int64_t)blockIdx.x * VT_TILE + threadIdx.x * VT_ITEMS;
  for (int c = 0; c < R; ++c) {
    double carry = 0.0;
    for (int t = 0; t < (int)blockIdx.x; ++t) carry += tile_sum[(int64_t)t * R + c];
    double v[VT_ITEMS];
    double mine = 0.0;
    for (int j = 0; j < VT_ITEMS; ++j) {
      v[j] = row0 + j < T ? row_req(perm, req, valid, row0 + j, R, c) : 0.0;
      mine += v[j];
    }
    double incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const double w = lane < WARPS ? warp_sums[lane] : 0.0;
      double wi = w;
      for (int o = 1; o < WARPS; o <<= 1) {
        const double t = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += t;
      }
      if (lane < WARPS) warp_sums[lane] = wi - w;
    }
    __syncthreads();
    double run = carry + warp_sums[warp] + (incl - mine);
    for (int j = 0; j < VT_ITEMS; ++j) {
      if (row0 + j < T) excl[(row0 + j) * R + c] = run;
      run += v[j];
    }
    __syncthreads();
  }
}

__global__ void vtime_finish(const int64_t* __restrict__ perm,
                             const int64_t* __restrict__ s_seg, int64_t T, int R,
                             const double* __restrict__ excl,
                             const float* __restrict__ alloc_seg, int64_t alloc_s0,
                             int64_t alloc_s1, const float* __restrict__ denom_seg,
                             int64_t denom_s0, int64_t denom_s1, int S,
                             float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  const int64_t seg = s_seg[i];
  int64_t lo = 0, hi = i;  // first row of this segment
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (s_seg[mid] < seg) lo = mid + 1; else hi = mid;
  }
  const int64_t s = seg < 0 ? 0 : (seg > S - 1 ? S - 1 : seg);
  float m = 0.0f;
  for (int c = 0; c < R; ++c) {
    const double before = excl[i * R + c] - excl[lo * R + c];
    const float st = (float)((double)alloc_seg[s * alloc_s0 + c * alloc_s1] + before);
    const float den = denom_seg[s * denom_s0 + c * denom_s1];
    const float ratio = den > 0.0f ? __fdiv_rn(st, fmaxf(den, 1e-9f))
                                   : (st > 0.0f ? 1e30f : 0.0f);
    m = c == 0 ? ratio : fmaxf(m, ratio);
  }
  out[perm[i]] = m;
}

}  // namespace

// m >= 1 keys, keys[k] f32[T] on the card (the pointer array on the host),
// least significant first, applied to the order perm_in (null: identity).
// scratch: wide_scratch_bytes(T, 4, 4) bytes when T > CTA_MAX_T, else
// unused.  perm_out may equal perm_in.
extern "C" int kb_lex_push_many(const float* const* keys, int m,
                                const int64_t* perm_in, int64_t T, void* scratch,
                                int64_t* perm_out, int32_t* rank_out, void* stream) {
  if (T == 0 || m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= CTA_MAX_T) {
    static const int optin = cta_smem_optin(cta_lex_kernel);
    if (optin) return optin;
    for (int k0 = 0; k0 < m; k0 += MAX_KEYS) {
      KeyList kl;
      const int n = m - k0 < MAX_KEYS ? m - k0 : MAX_KEYS;
      for (int k = 0; k < n; ++k) kl.key[k] = keys[k0 + k];
      cta_lex_kernel<<<1, CTA_THREADS, cta_smem_bytes(T), s>>>(
          kl, n, k0 == 0 ? perm_in : perm_out, (int)T, perm_out, rank_out);
    }
    return (int)cudaGetLastError();
  }
  const Wide w = wide_layout(scratch, T, 4, 4);
  for (int k = 0; k < m; ++k) {
    int err = (int)cudaMemsetAsync(w.hist, 0, w.ctl_bytes, s);
    if (err) return err;
    wide_prepare<uint32_t><<<w.tiles, BLOCK, 0, s>>>(
        keys[k], k == 0 ? perm_in : nullptr, k > 0, nullptr, nullptr, T, 8, 4,
        (uint32_t*)w.codes[0], w.ids[0], w.hist);
    wide_passes<uint32_t>(w, T, 8, 4, k == m - 1, perm_out, rank_out, nullptr, 1, s);
  }
  return (int)cudaGetLastError();
}

// The stable (seg, rank) sort, seg in [0, S] and rank in [0, T): codes of
// code_bytes (4 when (S + 1)·T <= 2^32, else 8) bytes, `passes` digits of
// `bits` bits (the one-block sort: T <= CTA_MAX_T, 4-byte codes, 8 bits).
// scratch: wide_scratch_bytes(T, code_bytes, passes) bytes for a wide sort.
extern "C" int kb_sort_by_segment(const int32_t* seg, const int32_t* rank, int64_t T,
                                  int code_bytes, int bits, int passes, void* scratch,
                                  int64_t* perm_out, int64_t* seg_out, void* stream) {
  if (T == 0) return 0;
  if (passes < 1 || passes > MAX_PASSES || bits < 1 || bits > MAX_BITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= CTA_MAX_T && code_bytes == 4 && bits == 8) {
    static const int optin = cta_smem_optin(cta_seg_kernel);
    if (optin) return optin;
    cta_seg_kernel<<<1, CTA_THREADS, cta_smem_bytes(T), s>>>(seg, rank, (int)T, passes,
                                                              perm_out, seg_out);
    return (int)cudaGetLastError();
  }
  const Wide w = wide_layout(scratch, T, (size_t)code_bytes, passes);
  int err = (int)cudaMemsetAsync(w.hist, 0, w.ctl_bytes, s);
  if (err) return err;
  if (code_bytes == 4) {
    wide_prepare<uint32_t><<<w.tiles, BLOCK, 0, s>>>(
        nullptr, nullptr, false, seg, rank, T, bits, passes, (uint32_t*)w.codes[0], w.ids[0], w.hist);
    wide_passes<uint32_t>(w, T, bits, passes, true, perm_out, nullptr, seg_out,
                          (uint64_t)T, s);
  } else {
    wide_prepare<uint64_t><<<w.tiles, BLOCK, 0, s>>>(
        nullptr, nullptr, false, seg, rank, T, bits, passes, (uint64_t*)w.codes[0], w.ids[0], w.hist);
    wide_passes<uint64_t>(w, T, bits, passes, true, perm_out, nullptr, seg_out,
                          (uint64_t)T, s);
  }
  return (int)cudaGetLastError();
}

// One launch: T <= CTA_MAX_T, (S + 1)·T <= 2^32, `passes` = the 8-bit
// digits of the largest code (S + 1)·T - 1, 1 <= R <= MAX_R, S >= 1.
extern "C" int kb_vtime(const int32_t* seg, const int32_t* rank, const float* req,
                        const bool* valid, const float* alloc, int64_t alloc_s0,
                        int64_t alloc_s1, const float* denom, int64_t denom_s0,
                        int64_t denom_s1, int T, int R, int S, int passes, float* out,
                        void* stream) {
  if (T == 0) return 0;
  if (T > CTA_MAX_T || R < 1 || R > MAX_R || S < 1 || passes < 1 || passes > 4 ||
      (uint64_t)(S + 1) * (uint64_t)T > (1ull << 32))
    return (int)cudaErrorInvalidValue;
  static const int optin8 = cta_smem_optin(cta_vtime_kernel<8>);
  static const int optin16 = cta_smem_optin(cta_vtime_kernel<16>);
  if (optin8) return optin8;
  if (optin16) return optin16;
  VtimeArgs a;
  a.seg = seg; a.rank = rank; a.req = req; a.valid = valid;
  a.alloc = alloc; a.denom = denom;
  a.alloc_s0 = alloc_s0; a.alloc_s1 = alloc_s1; a.denom_s0 = denom_s0; a.denom_s1 = denom_s1;
  a.T = T; a.R = R; a.S = S; a.passes = passes;
  if (T <= 8 * CTA_THREADS)
    cta_vtime_kernel<8><<<1, CTA_THREADS, cta_smem_bytes(T), (cudaStream_t)stream>>>(a, out);
  else
    cta_vtime_kernel<16><<<1, CTA_THREADS, cta_smem_bytes(T), (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}

// The wide form's tail, over rows already sorted by kb_sort_by_segment.
// scratch: (ceil(T / VT_TILE) + T)·R doubles, the tile sums then the
// rows' exclusive prefixes.
extern "C" int kb_vtime_sorted(const int64_t* perm, const int64_t* s_seg,
                               const float* req, const bool* valid, int64_t T, int R,
                               const float* alloc, int64_t alloc_s0, int64_t alloc_s1,
                               const float* denom, int64_t denom_s0, int64_t denom_s1,
                               int S, double* scratch, float* out, void* stream) {
  if (T == 0) return 0;
  if (R > MAX_R) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)((T + VT_TILE - 1) / VT_TILE);
  double* tile_sum = scratch;
  double* excl = scratch + (size_t)tiles * R;
  vtime_tile_sums<<<tiles, BLOCK, 0, s>>>(perm, req, valid, T, R, tile_sum);
  vtime_prefix<<<tiles, BLOCK, 0, s>>>(perm, req, valid, T, R, tile_sum, excl);
  vtime_finish<<<(unsigned)((T + 255) / 256), 256, 0, s>>>(
      perm, s_seg, T, R, excl, alloc, alloc_s0, alloc_s1, denom, denom_s0, denom_s1, S,
      out);
  return (int)cudaGetLastError();
}
