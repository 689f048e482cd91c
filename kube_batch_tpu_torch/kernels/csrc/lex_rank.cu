// K8 · lex_rank: stable radix sorts for the tiered rank, and the tail of
// the weighted-fair-queueing virtual start times; three entry points.
//
// Replaces kube_batch_tpu/framework/policy.py · rank_fn (its jnp.lexsort
// over the tiered order keys) and virtual_start_times, and
// ops/assignment.py · rank_from_keys / _segment_prefix's (segment, rank)
// sort as vtime uses it.
//
// kb_lex_push: one stable least-significant-digit radix sort of key[perm]
// carrying perm (= perm[argsort(key[perm], stable)]), which also writes
// the dense rank of the result (rank[perm_out[i]] = i).  A float32 key
// maps to an order-preserving u32 code: the sign bit of a positive key
// flips, every bit of a negative key flips, -0.0 and +0.0 share one code
// and every NaN takes the code above +inf — the order of a stable
// torch.argsort and of jnp.lexsort, which keep equal keys (both zeros,
// all NaNs) in index order.
// kb_sort_by_segment: the same sort on the u64 code seg·T + rank, over
// the 8-bit digits that the largest code needs; it writes the sorted
// segment ids (code / T) in its last pass.
//
// A pass over 8 bits is two launches.  radix_hist counts each tile's
// digits (2048 rows a block, shared-memory counters).  radix_scatter
// recomputes every digit's start for its tile from the histogram
// (digits before it, plus the same digit in earlier tiles), then walks
// its tile in chunks of 256 rows in index order: within a warp, the rows
// of one digit find each other with __match_any_sync and rank themselves
// by lane; across the 8 warps a per-digit exclusive prefix in shared
// memory orders them; the chunk's counts then advance the digit starts.
// Every row's position therefore follows its index among rows of equal
// digit: the scatter is stable, with no atomics on the output.
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
// Bound on this card: bytes.  A 32-bit key is read once and sorted rows
// are written over four passes; the work is a few integer operations per
// row and pass, so every launch is latency-bound at these sizes (65,536
// rows are a few hundred kilobytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int ITEMS = 8;
constexpr int TILE = BLOCK * ITEMS;
constexpr int RADIX = 256;
static_assert(BLOCK == RADIX, "one thread per digit");

constexpr int VT_ITEMS = 4;
constexpr int VT_TILE = BLOCK * VT_ITEMS;
constexpr int MAX_R = 8;

__device__ __forceinline__ uint32_t f32_code(float x) {
  if (x != x) return 0xffffffffu;      // every NaN: above +inf
  if (x == 0.0f) return 0x80000000u;   // -0.0 == +0.0
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u ^ 0x80000000u);
}

__global__ void lex_codes(const float* __restrict__ key,
                          const int64_t* __restrict__ perm, int64_t T,
                          uint32_t* __restrict__ code) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  code[i] = f32_code(key[perm[i]]);
}

__global__ void seg_codes(const int32_t* __restrict__ seg,
                          const int32_t* __restrict__ rank, int64_t T,
                          uint64_t* __restrict__ code) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  code[i] = (uint64_t)(uint32_t)seg[i] * (uint64_t)T + (uint32_t)rank[i];
}

template <typename K>
__global__ void radix_hist(const K* __restrict__ code, int64_t T, int shift,
                           int n_tiles, uint32_t* __restrict__ hist) {
  __shared__ uint32_t cnt[RADIX];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int64_t tile0 = (int64_t)blockIdx.x * TILE;
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = tile0 + k * BLOCK + threadIdx.x;
    if (i < T) atomicAdd(&cnt[(uint32_t)(code[i] >> shift) & 0xffu], 1u);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * n_tiles + blockIdx.x] = cnt[threadIdx.x];
}

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

template <typename K>
__global__ void radix_scatter(const K* __restrict__ code_in,
                              const int64_t* __restrict__ perm_in,  // null: identity
                              int64_t T, int shift, int n_tiles,
                              const uint32_t* __restrict__ hist,
                              K* __restrict__ code_out,
                              int64_t* __restrict__ perm_out,
                              int32_t* __restrict__ rank_out,   // null but last lex pass
                              int64_t* __restrict__ seg_out,    // null but last seg pass
                              uint64_t seg_div) {
  __shared__ uint32_t start[RADIX];
  __shared__ uint32_t wcnt[WARPS][RADIX];
  __shared__ uint32_t total[RADIX];
  __shared__ uint32_t warp_sums[WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  {
    uint32_t before = 0, all = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const uint32_t h = hist[(int64_t)tid * n_tiles + t];
      if (t < (int)blockIdx.x) before += h;
      all += h;
    }
    start[tid] = block_exclusive(all, warp_sums) + before;
  }
  __syncthreads();
  const uint32_t lanes_below = (1u << lane) - 1u;
  const int64_t tile0 = (int64_t)blockIdx.x * TILE;
  for (int k = 0; k < ITEMS; ++k) {
    for (int w = 0; w < WARPS; ++w) wcnt[w][tid] = 0;
    __syncthreads();
    const int64_t i = tile0 + k * BLOCK + tid;
    const bool ok = i < T;
    K c = 0;
    int64_t p = 0;
    uint32_t d = RADIX;  // rows past T share a digit of their own
    if (ok) {
      c = code_in[i];
      p = perm_in ? perm_in[i] : i;
      d = (uint32_t)(c >> shift) & 0xffu;
    }
    const unsigned peers = __match_any_sync(FULL, d);
    const uint32_t lrank = __popc(peers & lanes_below);
    if (ok && lrank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    {
      uint32_t run = 0;
      for (int w = 0; w < WARPS; ++w) {
        const uint32_t n = wcnt[w][tid];
        wcnt[w][tid] = run;
        run += n;
      }
      total[tid] = run;
    }
    __syncthreads();
    if (ok) {
      const uint32_t pos = start[d] + wcnt[warp][d] + lrank;
      code_out[pos] = c;
      perm_out[pos] = p;
      if (rank_out) rank_out[p] = (int32_t)pos;
      if (seg_out) seg_out[pos] = (int64_t)((uint64_t)c / seg_div);
    }
    __syncthreads();
    start[tid] += total[tid];
    __syncthreads();
  }
}

template <typename K>
int radix_sort(K* k0, K* k1, const int64_t* perm_in, int64_t* perm_out,
               int64_t* perm_tmp, int64_t T, int passes, uint32_t* hist,
               int32_t* rank_out, int64_t* seg_out, uint64_t seg_div,
               cudaStream_t s) {
  const int n_tiles = (int)((T + TILE - 1) / TILE);
  const int64_t* pin = perm_in;
  for (int p = 0; p < passes; ++p) {
    K* cin = (p % 2 == 0) ? k0 : k1;
    K* cout = (p % 2 == 0) ? k1 : k0;
    const bool last = p == passes - 1;
    int64_t* pout = ((passes - 1 - p) % 2 == 0) ? perm_out : perm_tmp;
    radix_hist<K><<<n_tiles, BLOCK, 0, s>>>(cin, T, 8 * p, n_tiles, hist);
    radix_scatter<K><<<n_tiles, BLOCK, 0, s>>>(
        cin, pin, T, 8 * p, n_tiles, hist, cout, pout,
        last ? rank_out : nullptr, last ? seg_out : nullptr, seg_div);
    pin = pout;
  }
  return (int)cudaGetLastError();
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

extern "C" int kb_lex_push(const float* key, const int64_t* perm_in,
                           int64_t T, uint32_t* codes /* 2T */,
                           int64_t* perm_tmp, uint32_t* hist,
                           int64_t* perm_out, int32_t* rank_out,
                           void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  lex_codes<<<(unsigned)((T + 255) / 256), 256, 0, s>>>(key, perm_in, T,
                                                        codes);
  return radix_sort<uint32_t>(codes, codes + T, perm_in, perm_out, perm_tmp,
                              T, 4, hist, rank_out, nullptr, 1, s);
}

extern "C" int kb_sort_by_segment(const int32_t* seg, const int32_t* rank,
                                  int64_t T, int passes,
                                  uint64_t* codes /* 2T */, int64_t* perm_tmp,
                                  uint32_t* hist, int64_t* perm_out,
                                  int64_t* seg_out, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  seg_codes<<<(unsigned)((T + 255) / 256), 256, 0, s>>>(seg, rank, T, codes);
  return radix_sort<uint64_t>(codes, codes + T, nullptr, perm_out, perm_tmp,
                              T, passes, hist, nullptr, seg_out,
                              (uint64_t)T, s);
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
