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
// * One block for T <= 16,384 rows (cta_lex_kernel, cta_seg_kernel): 1,024
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
// kb_vtime: over rows sorted by (segment, base rank), before[i] = the
// float64 sum of the valid requests of earlier rows of i's segment, then
// start = f32(alloc_seg + before), ratio = start / max(denom, 1e-9)
// (__fdiv_rn) where denom > 0, else 1e30 or 0, the max over resource
// dims scattered to out[perm[i]].  The prefix is global and blocked:
// vtime_tile_sums adds each 1024-row tile's requests, vtime_prefix writes
// every row's exclusive prefix (the earlier tiles' sums plus a block scan),
// and vtime_finish subtracts the prefix at the row's segment start (found
// by binary search).  For integer-valued requests whose column totals stay
// below 2**53 every partial sum is exact, so this equals the plain
// version's global cumsum bit for bit in any order of addition (the
// float64 rule of api/snapshot.py).  There is no thread-per-segment walk:
// the default conf has three segments over 65,536 rows.
//
// No entry reads anything back on the host or allocates: the caller gives
// the scratch, sized from the shapes alone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// one-block sorts
constexpr int CTA_THREADS = 1024;
constexpr int CTA_WARPS = CTA_THREADS / 32;
constexpr int CTA_MAX_T = 16384;
constexpr int CTA_RADIX = 256;
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

constexpr int CTA_GROUPS = CTA_THREADS / CTA_RADIX;   // warps of a digit, in groups
constexpr int GROUP_WARPS = CTA_WARPS / CTA_GROUPS;

struct CtaShared {
  uint16_t wcnt[CTA_WARPS][CTA_RADIX];    // per warp and digit: count, then offset
  uint32_t gsum[CTA_GROUPS][CTA_RADIX];   // per warp group and digit: count, then offset
  uint32_t warp_sums[CTA_WARPS];
  uint32_t all_and, any_or;               // of the codes: which digits vary
};

// Exclusive prefix over threads 0..CTA_RADIX-1 of one value each (other
// threads pass 0 and get 0).  Every thread of the block calls it.
__device__ uint32_t cta_digit_exclusive(uint32_t v, uint32_t* warp_sums) {
  constexpr int DW = CTA_RADIX / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31 && warp < DW) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < DW ? warp_sums[lane] : 0u;
    uint32_t wi = w;
    for (int o = 1; o < DW; o <<= 1) {
      const uint32_t t = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < DW) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  return warp < DW ? warp_sums[warp] + incl - v : 0u;
}

// One stable pass over the 8-bit digit at `shift`, rows moving from
// (cin, iin) to (cout, iout).
__device__ void cta_pass(const uint32_t* cin, const uint16_t* iin, uint32_t* cout,
                         uint16_t* iout, int T, int shift, CtaShared& sh) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t below = (1u << lane) - 1u;
  const int rows = (((T + CTA_WARPS - 1) / CTA_WARPS) + 31) & ~31;
  const int lo = warp * rows, hi = min(T, lo + rows);
  __syncthreads();   // the rows are in place and the last pass is done with sh
  uint32_t* w0 = reinterpret_cast<uint32_t*>(&sh.wcnt[0][0]);
  for (int i = tid; i < CTA_WARPS * CTA_RADIX / 2; i += CTA_THREADS) w0[i] = 0;
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const uint32_t d = i < hi ? (cin[i] >> shift) & 0xffu : CTA_RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    if (i < hi && (peers & below) == 0)
      sh.wcnt[warp][d] = (uint16_t)(sh.wcnt[warp][d] + __popc(peers));
    __syncwarp();
  }
  __syncthreads();
  // Warp offsets within each digit: thread (g, d) runs over its group's
  // warps, digit threads then over the groups and scan the digit totals.
  const int d = tid & (CTA_RADIX - 1), g = tid / CTA_RADIX;
  uint32_t run = 0;
  for (int w = g * GROUP_WARPS; w < (g + 1) * GROUP_WARPS; ++w) {
    const uint32_t c = sh.wcnt[w][d];
    sh.wcnt[w][d] = (uint16_t)run;
    run += c;
  }
  sh.gsum[g][d] = run;
  __syncthreads();
  uint32_t total = 0;
  if (tid < CTA_RADIX) {
    for (int q = 0; q < CTA_GROUPS; ++q) {
      const uint32_t c = sh.gsum[q][tid];
      sh.gsum[q][tid] = total;
      total += c;
    }
  }
  const uint32_t start = cta_digit_exclusive(total, sh.warp_sums);
  if (tid < CTA_RADIX)
    for (int q = 0; q < CTA_GROUPS; ++q) sh.gsum[q][tid] += start;
  __syncthreads();
  const uint32_t group_start = sh.gsum[g][d];
  for (int w = g * GROUP_WARPS; w < (g + 1) * GROUP_WARPS; ++w)
    sh.wcnt[w][d] = (uint16_t)(sh.wcnt[w][d] + group_start);
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool ok = i < hi;
    uint32_t c = 0, dd = CTA_RADIX;
    uint16_t v = 0;
    if (ok) {
      c = cin[i];
      v = iin[i];
      dd = (c >> shift) & 0xffu;
    }
    const unsigned peers = __match_any_sync(FULL, dd);
    const uint32_t lrank = __popc(peers & below);
    if (ok) {
      const uint32_t pos = sh.wcnt[warp][dd] + lrank;
      cout[pos] = c;
      iout[pos] = v;
    }
    __syncwarp();
    if (ok && lrank == 0) sh.wcnt[warp][dd] = (uint16_t)(sh.wcnt[warp][dd] + __popc(peers));
    __syncwarp();
  }
}

// The bits in which the block's codes differ (AND and OR of every code,
// which each thread passes in over its rows).  A pass whose digit has
// no such bit would move nothing and is skipped.
__device__ uint32_t cta_varying_bits(uint32_t all_and, uint32_t any_or, CtaShared& sh) {
  all_and = __reduce_and_sync(FULL, all_and);
  any_or = __reduce_or_sync(FULL, any_or);
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(&sh.all_and, all_and);
    atomicOr(&sh.any_or, any_or);
  }
  __syncthreads();
  return sh.all_and ^ sh.any_or;
}

struct CtaRows {
  uint32_t* code[2];
  uint16_t* id[2];
};

__device__ __forceinline__ CtaRows cta_rows(uint8_t* smem, int T) {
  CtaRows r;
  r.code[0] = reinterpret_cast<uint32_t*>(smem);
  r.code[1] = r.code[0] + T;
  r.id[0] = reinterpret_cast<uint16_t*>(r.code[1] + T);
  r.id[1] = r.id[0] + T;
  return r;
}

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

size_t cta_smem_bytes(int64_t T) { return (size_t)T * 12; }

template <typename F>
int cta_smem_optin(F* kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)cta_smem_bytes(CTA_MAX_T));
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
                             const float* __restrict__ alloc_seg,
                             const float* __restrict__ denom_seg, int S,
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
    const float st = (float)((double)alloc_seg[s * R + c] + before);
    const float den = denom_seg[s * R + c];
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

extern "C" int kb_vtime(const int64_t* perm, const int64_t* s_seg,
                        const float* req, const bool* valid, int64_t T, int R,
                        const float* alloc_seg, const float* denom_seg, int S,
                        double* tile_sum, double* excl, float* out,
                        void* stream) {
  if (T == 0) return 0;
  if (R > MAX_R) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)((T + VT_TILE - 1) / VT_TILE);
  vtime_tile_sums<<<tiles, BLOCK, 0, s>>>(perm, req, valid, T, R, tile_sum);
  vtime_prefix<<<tiles, BLOCK, 0, s>>>(perm, req, valid, T, R, tile_sum, excl);
  vtime_finish<<<(unsigned)((T + 255) / 256), 256, 0, s>>>(
      perm, s_seg, T, R, excl, alloc_seg, denom_seg, S, out);
  return (int)cudaGetLastError();
}
