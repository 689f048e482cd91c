// K1 · static predicate mask, bool[T, N], in two launches of one call.
//
// Replaces kube_batch_tpu/plugins/predicates.py · PredicatesPlugin.register
// .predicate (reached through framework/policy.py · predicate_mask), which
// XLA lowers to multi-hot matrix products plus compares:
//   selector   task_sel @ node_labels^T  >= sum(task_sel)
//   taints     sum(node_taints) - task_tol @ node_taints^T <= 0.5
//   host ports task_ports @ node_ports^T <= 0.5
//   readiness, opt-in pressure, volume pin, volume groups
//   (task_vol_groups @ (1 - node_ok_g)^T <= 0.5, node_ok_g = node_labels @
//   vol_group_sel^T > 0.5).
//
// Precondition: every multi-hot table holds only 0 and 1 (the packers
// write 1.0 and nothing else; a CPU test holds them to it).  On such rows
// each product-and-compare is a set test, and that is what this kernel
// computes, on bit words (bit c % 32 of word c / 32: the column is not 0):
//   selector sel ⊆ labels, taints taints ⊆ tol, ports ports ∩ node_ports
//   = ∅, volume groups groups ∩ miss = ∅, with miss the groups none of
//   whose allowed labels the node carries.
// On other values the set tests and the reference's sums may differ.
//
// The pack (pack_kernel, the first launch): a warp packs one row's word
// with one __ballot_sync over 32 columns, for the task tables [T][TW]
// (sel, tol, ports, groups: TW = Lw + Vw + Pw + Gw words) and the node
// tables, word major [NW][N] (labels, taints, ports, miss; NW = TW), the
// node's ready / pressure byte under the flags, and the union of each
// word over the rows that decide it ("used": the task side for selector,
// ports and groups, the node side for taints), folded per block in
// shared memory and then once a word into device memory (straight into
// device memory when the words pass 48 KB, TW > 12,288).  A word whose
// union is 0 passes every cell, and the mask kernel skips it.  Nothing
// here bounds the widths: a vocabulary may be as wide as its tables.
//
// The mask (mask_kernel, the second launch): bound on this card by its
// output, T*N bytes (0.54 GB at 65,536 x 8,192) against a few KB of
// words.  A block of 8 warps owns a strip of 512 nodes and a share of the
// task rows.  It takes the used words of the enabled tests in tiles of up
// to TILE words: it stages a tile's strip words and the strip's ready
// bits in shared memory once (padded one word in 17, so the 32 lanes
// reading their 16 nodes hit 32 banks), then each warp takes one task row
// at a time: lane j tests nodes 16j .. 16j + 15 of the strip as a 16-bit
// mask against the row's words (a broadcast load) and writes them as one
// 16-byte store, a warp writing 512 consecutive bytes.  Every vocabulary
// the packers make so far fits one tile; past it (a label per node, say,
// with selectors naming many of them) each further tile reads back the
// bytes the last one wrote and ANDs its tests in, a block barrier between
// tiles.  When N is not a multiple of 16 the rows are not 16-byte aligned
// and the same lanes load and store byte by byte, guarded at the row's
// end.  No load reads past a table: strip words beyond N are staged as 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int PACK_THREADS = 256;
constexpr int PACK_ROWS = 64;              // rows a pack block takes
constexpr int MASK_THREADS = 256;
constexpr int MASK_WARPS = MASK_THREADS / 32;
constexpr int STRIP = 512;                 // nodes a mask block owns
constexpr int STRIP_PAD = STRIP + STRIP / 16;
constexpr int TILE = 32;                   // used words a mask block stages at once
constexpr int PACK_SHARED_WORDS = 12288;   // used words a pack block folds in shared memory
constexpr int MASK_BLOCKS = 2048;          // blocks a mask launch aims at

enum : int { SEL = 1, TAINTS = 2, PORTS = 4, READY = 8, PRESSURE = 16, VOLUME = 128 };

struct Widths {
  int L, V, P, G;       // columns
  int Lw, Vw, Pw, Gw;   // words
  int TW;               // words a row
};

struct PackArgs {
  const float* task_sel;
  const float* task_tol;
  const float* task_ports;
  const float* task_groups;
  const float* node_labels;
  const float* node_taints;
  const float* node_ports;
  const float* group_sel;      // [G, L]
  const uint8_t* node_ready;
  const float* node_pressure;  // [N, 3]
  Widths w;
  int T, N, flags, task_blocks;
  uint32_t* task_words;        // [T][TW]
  uint32_t* node_words;        // [TW][N]
  uint8_t* node_ok;            // [N]
  uint32_t* used;              // [TW], zeroed by the caller
};

// The bit word of columns 32*word .. of a row of `x` (width W), by the
// warp: one column a lane, one ballot.
__device__ __forceinline__ uint32_t ballot_word(const float* row, int W, int word) {
  const int c = word * 32 + (threadIdx.x & 31);
  return __ballot_sync(FULL, c < W && row[c] != 0.0f);
}

__global__ void __launch_bounds__(PACK_THREADS) pack_kernel(PackArgs a) {
  extern __shared__ uint32_t su_block[];   // [TW] when in_shared
  const Widths& w = a.w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool in_shared = w.TW <= PACK_SHARED_WORDS;
  uint32_t* su = in_shared ? su_block : a.used;   // atomicOr on either space
  if (in_shared) {
    for (int i = threadIdx.x; i < w.TW; i += PACK_THREADS) su[i] = 0u;
    __syncthreads();
  }
  const bool tasks = (int)blockIdx.x < a.task_blocks;
  const int blk = tasks ? blockIdx.x : blockIdx.x - a.task_blocks;
  const int M = tasks ? a.T : a.N;
  const int r0 = blk * PACK_ROWS, r1 = min(M, r0 + PACK_ROWS);
  for (int r = r0 + warp; r < r1; r += PACK_THREADS / 32) {
    if (tasks) {
      uint32_t* out = a.task_words + (int64_t)r * w.TW;
      const float* src[4] = {a.task_sel + (int64_t)r * w.L, a.task_tol + (int64_t)r * w.V,
                             a.task_ports + (int64_t)r * w.P, a.task_groups + (int64_t)r * w.G};
      const int cols[4] = {w.L, w.V, w.P, w.G};
      const int words[4] = {w.Lw, w.Vw, w.Pw, w.Gw};
      int o = 0;
      for (int t = 0; t < 4; ++t) {
        for (int k = 0; k < words[t]; ++k, ++o) {
          const uint32_t v = ballot_word(src[t], cols[t], k);
          if (lane == 0) {
            out[o] = v;
            if (v && t != 1) atomicOr(su + o, v);   // taints: the node side decides
          }
        }
      }
    } else {
      const float* lab = a.node_labels + (int64_t)r * w.L;
      const float* src[3] = {lab, a.node_taints + (int64_t)r * w.V,
                             a.node_ports + (int64_t)r * w.P};
      const int cols[3] = {w.L, w.V, w.P};
      const int words[3] = {w.Lw, w.Vw, w.Pw};
      int o = 0;
      for (int t = 0; t < 3; ++t) {
        for (int k = 0; k < words[t]; ++k, ++o) {
          const uint32_t v = ballot_word(src[t], cols[t], k);
          if (lane == 0) {
            a.node_words[(int64_t)o * a.N + r] = v;
            if (v && t == 1) atomicOr(su + o, v);
          }
        }
      }
      // miss: groups none of whose allowed labels the node carries
      for (int k = 0; k < w.Gw; ++k, ++o) {
        uint32_t miss = 0u;
        for (int g = k * 32; g < min(w.G, k * 32 + 32); ++g) {
          bool hit = false;
          const float* gs = a.group_sel + (int64_t)g * w.L;
          for (int c = lane; c < w.L; c += 32) hit = hit || (lab[c] != 0.0f && gs[c] != 0.0f);
          if (!__any_sync(FULL, hit)) miss |= 1u << (g - k * 32);
        }
        if (lane == 0) a.node_words[(int64_t)o * a.N + r] = miss;
      }
      if (lane == 0) {
        bool ok = !(a.flags & READY) || a.node_ready[r];
        for (int d = 0; d < 3; ++d)
          if (a.flags & (PRESSURE << d)) ok = ok && a.node_pressure[(int64_t)r * 3 + d] <= 0.5f;
        a.node_ok[r] = ok ? 1 : 0;
      }
    }
  }
  if (in_shared) {
    __syncthreads();
    for (int i = threadIdx.x; i < w.TW; i += PACK_THREADS)
      if (su[i]) atomicOr(&a.used[i], su[i]);
  }
}

struct MaskArgs {
  const uint32_t* task_words;
  const uint32_t* node_words;
  const uint8_t* node_ok;
  const uint32_t* used;
  const int32_t* task_vol_node;
  Widths w;
  int T, N, flags, tile;   // tile: words a block stages at once, min(TW, TILE)
  uint8_t* out;
};

// Four bits of m (from `shift`) as four bytes 0 / 1, and back.
__device__ __forceinline__ uint32_t spread4(uint32_t m, int shift) {
  const uint32_t b = (m >> shift) & 0xfu;
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

__device__ __forceinline__ uint32_t gather4(uint32_t x, int shift) {
  return ((x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u)) << shift;
}

// Clear the nodes of `m` whose strip word fails the set test of task
// word tw: kind 0 tw ⊄ node word, 1 node word ⊄ tw, 2 tw ∩ node word ≠ ∅.
template <int KIND>
__device__ __forceinline__ uint32_t test16(uint32_t m, uint32_t tw, const uint32_t* sw) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t nw = sw[i];
    const bool bad = KIND == 0 ? (tw & ~nw) != 0u : KIND == 1 ? (nw & ~tw) != 0u
                                                              : (tw & nw) != 0u;
    if (bad) m &= ~(1u << i);
  }
  return m;
}

// Whether the test that word k belongs to is on.
__device__ __forceinline__ bool enabled(const Widths& w, int flags, int k) {
  const int o_tol = w.Lw, o_ports = o_tol + w.Vw, o_groups = o_ports + w.Pw;
  return k < o_tol ? (flags & SEL) != 0 : k < o_ports ? (flags & TAINTS) != 0
       : k < o_groups ? (flags & PORTS) != 0 : (flags & VOLUME) != 0;
}

template <bool ALIGNED>
__global__ void __launch_bounds__(MASK_THREADS) mask_kernel(MaskArgs a) {
  extern __shared__ uint32_t smem[];
  __shared__ int list[TILE];       // the tile's words, ascending
  __shared__ int bounds[3];        // list ends of the selector and taint words; size
  __shared__ int next;             // the first word the next tile may take
  const Widths& w = a.w;
  const int TW = w.TW;
  uint32_t* nok = smem;                       // [STRIP / 32] ready bits
  uint32_t* sw = nok + STRIP / 32;            // [tile][STRIP_PAD] strip words
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * STRIP;
  for (int i = threadIdx.x; i < STRIP; i += MASK_THREADS) {
    const int n = n0 + i;
    const unsigned ok = __ballot_sync(FULL, n < a.N && a.node_ok[n]);
    if (lane == 0) nok[i >> 5] = ok;
  }
  if (threadIdx.x == 0) next = 0;
  const int base = n0 + 16 * lane;
  const bool live = base < a.N;
  const uint32_t* mine = sw + 17 * lane;      // node 16 * lane of the strip
  const int o_tol = w.Lw, o_ports = o_tol + w.Vw;
  for (bool first = true;; first = false) {
    __syncthreads();   // next is set; the last tile's strip words are read
    if (warp == 0) {
      // the next used words of enabled tests, up to a.tile of them
      int n = 0, k = next;
      while (k < TW && n < a.tile) {
        const int kk = k + lane;
        const bool u = kk < TW && enabled(w, a.flags, kk) && a.used[kk] != 0u;
        const unsigned b = __ballot_sync(FULL, u);
        const int at = n + __popc(b & ((1u << lane) - 1u));
        if (u && at < a.tile) list[at] = kk;
        const unsigned over = __ballot_sync(FULL, u && at == a.tile);
        if (over) {
          k += __ffs(over) - 1;   // the first used word this tile leaves
          n = a.tile;
          break;
        }
        n += __popc(b);
        k += 32;
      }
      const int in_sel = __popc(__ballot_sync(FULL, lane < n && list[lane] < o_tol));
      const int in_tnt = __popc(__ballot_sync(FULL, lane < n && list[lane] < o_ports));
      if (lane == 0) {
        bounds[0] = in_sel;
        bounds[1] = in_tnt;
        bounds[2] = n;
        next = k < TW ? k : TW;
      }
    }
    __syncthreads();
    const int nw = bounds[2];
    if (nw == 0 && !first) break;   // uniform over the block
    for (int e = 0; e < nw; ++e) {
      const int64_t k = list[e];
      for (int i = threadIdx.x; i < STRIP; i += MASK_THREADS) {
        const int n = n0 + i;
        sw[e * STRIP_PAD + i + (i >> 4)] = n < a.N ? a.node_words[k * a.N + n] : 0u;
      }
    }
    __syncthreads();
    const int e_sel = bounds[0], e_tnt = bounds[1];
    if (live) {
      const uint32_t ready16 = (nok[lane >> 1] >> ((lane & 1) * 16)) & 0xffffu;
      const int n_left = min(16, a.N - base);
      for (int t = blockIdx.y * MASK_WARPS + warp; t < a.T; t += gridDim.y * MASK_WARPS) {
        const uint32_t* tw = a.task_words + (int64_t)t * TW;
        uint8_t* row = a.out + (int64_t)t * a.N + base;
        uint32_t m;
        if (first) {
          m = ready16;
          if (a.flags & VOLUME) {
            const int pin = a.task_vol_node[t];
            if (pin != -1) m &= (pin >= base && pin < base + 16) ? 1u << (pin - base) : 0u;
          }
        } else if (ALIGNED) {
          // this lane's own bytes, written by the last tile
          const uint4 x = *reinterpret_cast<const uint4*>(row);
          m = gather4(x.x, 0) | gather4(x.y, 4) | gather4(x.z, 8) | gather4(x.w, 12);
        } else {
          m = 0u;
          for (int i = 0; i < n_left; ++i) m |= (uint32_t)(row[i] & 1u) << i;
        }
        for (int e = 0; e < e_sel; ++e) {
          const uint32_t v = tw[list[e]];
          if (v) m = test16<0>(m, v, mine + e * STRIP_PAD);
        }
        for (int e = e_sel; e < e_tnt; ++e) m = test16<1>(m, tw[list[e]], mine + e * STRIP_PAD);
        for (int e = e_tnt; e < nw; ++e) {   // ports, then volume groups: disjoint
          const uint32_t v = tw[list[e]];
          if (v) m = test16<2>(m, v, mine + e * STRIP_PAD);
        }
        if (ALIGNED) {
          *reinterpret_cast<uint4*>(row) =
              make_uint4(spread4(m, 0), spread4(m, 4), spread4(m, 8), spread4(m, 12));
        } else {
          for (int i = 0; i < n_left; ++i) row[i] = (m >> i) & 1u;
        }
      }
    }
    if (next >= TW) break;   // uniform: read after the barrier that follows its write
  }
}

Widths widths(int L, int V, int P, int G) {
  Widths w;
  w.L = L;
  w.V = V;
  w.P = P;
  w.G = G;
  w.Lw = (L + 31) / 32;
  w.Vw = (V + 31) / 32;
  w.Pw = (P + 31) / 32;
  w.Gw = (G + 31) / 32;
  w.TW = w.Lw + w.Vw + w.Pw + w.Gw;
  return w;
}

int tile_of(const Widths& w) { return w.TW < TILE ? w.TW : TILE; }

size_t mask_smem(const Widths& w) {
  return sizeof(uint32_t) * (STRIP / 32 + (size_t)tile_of(w) * STRIP_PAD);
}

}  // namespace

// flags: 1 selector, 2 taints, 4 host ports, 8 node ready, 16/32/64
// pressure dims 0..2, 128 volume binding (pin; groups when G > 0).
// `words` holds T*TW + TW*N + ceil(N / 4) + TW int32 words: the task words,
// the node words, the node_ok bytes and the used words, in that order.
extern "C" int kb_predicate_mask(
    const float* task_sel, const float* node_labels, int L,
    const float* task_tol, const float* node_taints, int V,
    const float* task_ports, const float* node_ports, int P,
    const uint8_t* node_ready, const float* node_pressure,
    const int32_t* task_vol_node, const float* task_vol_groups,
    const float* vol_group_sel, int G, int T, int N, int flags, uint32_t* words,
    uint8_t* out, void* stream) {
  if (T < 1 || N < 1 || L < 0 || V < 0 || P < 0 || G < 0) return (int)cudaErrorInvalidValue;
  const Widths w = widths(L, V, P, G);
  static bool attributes = false;
  if (!attributes) {   // a full tile's strip words pass the 48 KB default
    const int most = (int)(sizeof(uint32_t) * (STRIP / 32 + TILE * STRIP_PAD));
    int err = (int)cudaFuncSetAttribute(mask_kernel<true>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (!err) err = (int)cudaFuncSetAttribute(mask_kernel<false>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err) return err;
    attributes = true;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  uint32_t* task_words = words;
  uint32_t* node_words = task_words + (int64_t)T * w.TW;
  uint8_t* node_ok = reinterpret_cast<uint8_t*>(node_words + (int64_t)w.TW * N);
  uint32_t* used = reinterpret_cast<uint32_t*>(node_ok) + (N + 3) / 4;
  if (w.TW) {
    const int err = (int)cudaMemsetAsync(used, 0, sizeof(uint32_t) * w.TW, s);
    if (err) return err;
  }
  PackArgs pa;
  pa.task_sel = task_sel;
  pa.task_tol = task_tol;
  pa.task_ports = task_ports;
  pa.task_groups = task_vol_groups;
  pa.node_labels = node_labels;
  pa.node_taints = node_taints;
  pa.node_ports = node_ports;
  pa.group_sel = vol_group_sel;
  pa.node_ready = node_ready;
  pa.node_pressure = node_pressure;
  pa.w = w;
  pa.T = T;
  pa.N = N;
  pa.flags = flags;
  pa.task_blocks = w.TW ? (T + PACK_ROWS - 1) / PACK_ROWS : 0;
  pa.task_words = task_words;
  pa.node_words = node_words;
  pa.node_ok = node_ok;
  pa.used = used;
  const int node_blocks = (N + PACK_ROWS - 1) / PACK_ROWS;
  const size_t pack_smem = w.TW <= PACK_SHARED_WORDS ? sizeof(uint32_t) * w.TW : 0;
  pack_kernel<<<pa.task_blocks + node_blocks, PACK_THREADS, pack_smem, s>>>(pa);
  int err = (int)cudaGetLastError();
  if (err) return err;
  MaskArgs ma;
  ma.task_words = task_words;
  ma.node_words = node_words;
  ma.node_ok = node_ok;
  ma.used = used;
  ma.task_vol_node = task_vol_node;
  ma.w = w;
  ma.T = T;
  ma.N = N;
  ma.flags = flags;
  ma.tile = tile_of(w);
  ma.out = out;
  const int strips = (N + STRIP - 1) / STRIP;
  int gy = MASK_BLOCKS / strips;
  const int most = (T + MASK_WARPS - 1) / MASK_WARPS;
  gy = gy < 1 ? 1 : (gy > most ? most : gy);
  const dim3 grid(strips, gy);
  if (N % 16 == 0)
    mask_kernel<true><<<grid, MASK_THREADS, mask_smem(w), s>>>(ma);
  else
    mask_kernel<false><<<grid, MASK_THREADS, mask_smem(w), s>>>(ma);
  return (int)cudaGetLastError();
}
