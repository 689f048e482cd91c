// K13 · podaff_score: nodeorder's pod-affinity score as one row per
// class of preference rows.
//
// Replaces kube_batch_tpu/plugins/nodeorder.py · pod_affinity_score,
// which XLA lowers to two [T, K] @ [K, N] float32 products of the
// unpacked resident tables and three [T, N] elementwise passes (the
// division by the row's weight total, × MAX_SCORE, × the plugin weight):
//   raw[t, n] = Σ_k pref[t, k]·Hb[n, k] + Σ_k2 pref_topo[t, k2]·present[n, k2]
//   present[n, k2] = Hd[node_key_domain[n, term_key[k2]], term_label[k2]]
//   score[t, n] = w · ((raw / max(Σ pref + Σ pref_topo, 1e-9)) · 10)
// The score depends on a task only through its preference row, and the
// tasks of a gang share one: the cycle's setup groups the rows into C
// classes (plugins/nodeorder.py · podpref_classes; C = 17 on the
// affinity path, where T = 65,536) and lists each class's nonzero
// weights (kernels/podaff_score.py · class_lists), and this kernel
// writes the weighted table out[C, N] that kernel K2 reads at row cls[t].
//
// Bound on this card: bytes.  The class rows are read once (C·(K + K2)
// floats), K11's packed node words Hb [N, words(K)] and domain words
// Hd [D, words(K)] once, node_key_domain's rows once, the table written
// once: 0.6 MB at the affinity path's shapes, 0.2 µs at 3.35 TB/s, well
// under the card's launch floor of a few µs, so at those shapes the goal
// is a launch whose own work is one round of global loads, not the bound.
// The arithmetic is a bit test and an add for each nonzero weight.
// Design:
//   * Every global load of a block is in flight at once (cp.async, one
//     wait): the block stages Hd (when it fits, see below), its nodes'
//     domains (node_key_domain's rows), its classes' lists and counts
//     and the terms, packed as key · NODES | label << 20, in shared
//     memory; each thread loads its node's Hb words.  No global load
//     depends on another.  A present bit is then
//     s_hd[s_nkd[key][node] · words(K) + label / 32], shared-memory reads
//     only, four terms a 16-byte broadcast read, 32 terms unrolled.
//   * Route: Hd is staged when its D · words(K) words fit 16 KB and the
//     block's shared memory stays within the 48 KB default (1 KB at
//     D = 256); a larger Hd is read from global memory, one
//     independent read-only load per term, as K11 sends tables too large
//     for its shared memory to the global atomics.  Both routes compute
//     the same bits.
//   * The card is filled: a thread a node, NODES nodes a block (grid x),
//     and the classes split across grid y into chunks of CC, CC chosen
//     so that the grid holds at least twice as many blocks as the card
//     has SMs (C = 17, N = 8,192: 4 classes a block, 320 blocks), and at
//     most as many classes as the lists' shared memory holds (C = T:
//     64 classes a block, 65,536 blocks).
//   * The lists are built once a cycle, not by each block each round:
//     a class's nonzero (k, w) entries in ascending k, its node-level part
//     at [0, K) and its topology part at [K, K + K2), each filled with
//     (k, +0) past its count.  Every thread walks them for its node (the
//     same entry for all threads: a broadcast read), ILP classes at once
//     to the longest list of the group (a fill entry adds +0, which leaves
//     a sum that starts at +0 as it was: such a sum is never -0), and the
//     stores of one class are coalesced across the block.  Where K and K2
//     are at most 32 (the affinity path) a node's words sit in registers.
//   * The sums follow the reference's order for one cell: the node-level
//     terms in ascending k, the topology terms in ascending k2 as a sum of
//     their own, then node + topo (topo only when K2 > 0), the division,
//     × 10, × w, each an explicitly rounded intrinsic, and the file is
//     compiled with --fmad=false.  A weight of zero is skipped where the
//     plain version adds +0: both are the same float.  Kernel and plain
//     version agree bit for bit; with the reference's products they agree
//     wherever the float32 sums are exact (every world of this repository:
//     weights 1.0, 0.5, small integers).
//   * Any C: classes past the grid's y limit are taken by a block's loop
//     over chunks; C = T gives the [T, N] score.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NODES = 128;               // nodes a block, a thread each
constexpr int MAX_WORDS = 8;             // words of a vocabulary: K, K2 <= 256
constexpr int MAX_CC = 64;               // classes a block
constexpr int LIST_BYTES = 32768;        // shared memory of the class lists
constexpr int HD_BYTES = 16384;          // the largest Hd staged in shared memory
constexpr int SMEM_DEFAULT = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr int SMEM_MAX = 232448;         // 227 KB, the opt-in limit
constexpr int MAX_GRID_Y = 65535;
constexpr int ILP = 4;                   // classes a thread sums at once
constexpr float MAX_SCORE = 10.0f;

struct Entry {
  int k;
  float w;
};

struct Dims {
  int C, N, K, K2, D, TK, KW, K2W, CC, chunks;
  float w;
};

struct Plan {
  int cc, chunks, gx, gy, one, hd_smem;
  size_t smem;
};

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

// Shared memory, in this order (every part a multiple of 4 bytes; the
// terms first, 128 bytes a word of them, for their 16-byte reads, then the
// 8-byte entries and counts):
//   term  i32[K2W · 32]       term k2 packed as key · NODES | label << 20,
//                             padded with 0 (key 0, label 0)
//   list  Entry[CC][K + K2]   the chunk's class lists
//   cnt   int2[CC]            their counts (node-level, topology)
//   den   f32[CC]             their denominators
//   hb    u32[KW][NODES]      the nodes' Hb words (not when `one`)
//   pr    u32[K2W][NODES]     the nodes' present bits (not when `one`)
//   nkd   i32[TK][NODES]      the nodes' domains (K2 > 0)
//   hd    u32[D · KW]         Hd (the shared route)
size_t smem_rest(const Dims& d, int cc, bool one) {
  return (size_t)d.K2W * 32 * 4 + (size_t)cc * (d.K + d.K2) * sizeof(Entry)
         + (size_t)cc * 3 * 4 + (one ? 0 : (size_t)(d.KW + d.K2W) * NODES * 4)
         + (d.K2 ? (size_t)d.TK * NODES * 4 : 0);
}

Plan make_plan(const Dims& d, int sms) {
  Plan p;
  const int stride = d.K + d.K2;
  int cc_max = stride > 0 ? LIST_BYTES / (stride * (int)sizeof(Entry)) : MAX_CC;
  cc_max = cc_max < 1 ? 1 : (cc_max > MAX_CC ? MAX_CC : cc_max);
  p.gx = (d.N + NODES - 1) / NODES;
  const int want = (2 * sms + p.gx - 1) / p.gx;   // chunks for twice the SMs in blocks
  const int cc = (d.C + want - 1) / want;
  p.cc = cc < 1 ? 1 : (cc > cc_max ? cc_max : cc);
  p.chunks = (d.C + p.cc - 1) / p.cc;
  p.gy = p.chunks < MAX_GRID_Y ? p.chunks : MAX_GRID_Y;
  p.one = d.KW <= 1 && d.K2W <= 1;
  const size_t rest = smem_rest(d, p.cc, p.one);
  const size_t hd = (size_t)d.D * d.KW * 4;
  p.hd_smem = d.K2 > 0 && hd <= (size_t)HD_BYTES && rest + hd <= (size_t)SMEM_DEFAULT;
  p.smem = rest + (p.hd_smem ? hd : 0);
  return p;
}

struct Smem {
  int* term;
  Entry* list;
  int2* cnt;
  float* den;
  uint32_t *hb, *pr;
  int* nkd;
  uint32_t* hd;
};

template <bool ONE>
__device__ __forceinline__ Smem carve(uint8_t* base, const Dims& d) {
  Smem s;
  s.term = reinterpret_cast<int*>(base);
  s.list = reinterpret_cast<Entry*>(s.term + d.K2W * 32);
  s.cnt = reinterpret_cast<int2*>(s.list + d.CC * (d.K + d.K2));
  s.den = reinterpret_cast<float*>(s.cnt + d.CC);
  s.hb = reinterpret_cast<uint32_t*>(s.den + d.CC);
  s.pr = s.hb + (ONE ? 0 : d.KW * NODES);
  s.nkd = reinterpret_cast<int*>(s.pr + (ONE ? 0 : d.K2W * NODES));
  s.hd = reinterpret_cast<uint32_t*>(s.nkd + (d.K2 ? d.TK * NODES : 0));
  return s;
}

// Copies from global to shared memory that do not wait for their loads
// (cp.async): a block issues every load of a phase before the first one
// lands, then waits once (copies_land).
template <int BYTES>
__device__ __forceinline__ void copy(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void copies_land() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Classes [c0, c0 + cc): their lists (contiguous rows of K + K2 entries),
// counts and denominators.
__device__ __forceinline__ void stage_classes(const Smem& s, const Entry* __restrict__ lists,
                                              const int2* __restrict__ counts,
                                              const float* __restrict__ denom, const Dims& d,
                                              int c0, int cc) {
  const int tid = threadIdx.x;
  const Entry* src = lists + (size_t)c0 * (d.K + d.K2);
  for (int i = tid; i < cc * (d.K + d.K2); i += NODES) copy<8>(s.list + i, src + i);
  if (tid < cc) {
    copy<8>(s.cnt + tid, counts + c0 + tid);
    copy<4>(s.den + tid, denom + c0 + tid);
  }
}

// Bit k of this thread's node: from the register word when every
// vocabulary is one word (ONE), else from its column of `words`.
template <bool ONE>
__device__ __forceinline__ uint32_t bit(uint32_t reg, const uint32_t* words, int k, int tid) {
  if (ONE) return (reg >> k) & 1u;
  return (words[(k >> 5) * NODES + tid] >> (k & 31)) & 1u;
}

template <bool ONE, bool HD_SMEM>
__global__ void __launch_bounds__(NODES) podaff_kernel(
    const Entry* __restrict__ lists, const int2* __restrict__ counts,
    const float* __restrict__ denom, const uint32_t* __restrict__ hb,
    const uint32_t* __restrict__ hd, const int32_t* __restrict__ nkd,
    const int32_t* __restrict__ term_key, const int32_t* __restrict__ term_label,
    float* __restrict__ out, const Dims d) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Smem s = carve<ONE>(smem, d);
  const int tid = threadIdx.x;
  const int n = blockIdx.x * NODES + tid;
  const bool live = n < d.N;
  const int stride = d.K + d.K2;

  // 1. the block's loads, all in flight at once: the domain table, this
  //    thread's node, the first chunk's classes, the terms
  if (HD_SMEM)
    for (int i = tid; i < d.D * d.KW; i += NODES) copy<4>(s.hd + i, hd + i);
  uint32_t hb0 = 0;
  if (ONE) {
    hb0 = live && d.KW ? hb[n] : 0u;
  } else {
    for (int w = 0; w < d.KW; ++w) {
      if (live) copy<4>(s.hb + w * NODES + tid, hb + (size_t)n * d.KW + w);
      else s.hb[w * NODES + tid] = 0u;
    }
  }
  if (d.K2) {
    for (int t = 0; t < d.TK; ++t) {
      if (live) copy<4>(s.nkd + t * NODES + tid, nkd + (size_t)n * d.TK + t);
      else s.nkd[t * NODES + tid] = 0;
    }
  }
  int cb = blockIdx.y;
  stage_classes(s, lists, counts, denom, d, cb * d.CC, min(d.CC, d.C - cb * d.CC));
  for (int i = tid; i < d.K2W * 32; i += NODES)
    s.term[i] = i < d.K2 ? term_key[i] * NODES | term_label[i] << 20 : 0;
  copies_land();

  // 2. this node's present bits, term k2 at bit k2 % 32 of word k2 / 32
  uint32_t pr0 = 0;
  if (d.K2 && live) {
    for (int w2 = 0; w2 < d.K2W; ++w2) {
      const int4* terms = reinterpret_cast<const int4*>(s.term) + w2 * 8;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int4 t4 = terms[q];
        const int t[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int dom = s.nkd[(t[r] & 0xfffff) + tid];
          const int lab = t[r] >> 20;
          const uint32_t hw = HD_SMEM ? s.hd[dom * d.KW + (lab >> 5)]
                                      : hd[(size_t)dom * d.KW + (lab >> 5)];
          word |= ((hw >> (lab & 31)) & 1u) << (4 * q + r);
        }
      }
      const int left = d.K2 - w2 * 32;   // padded terms cleared
      if (left < 32) word &= (1u << left) - 1u;
      if (ONE) pr0 = word;
      else s.pr[w2 * NODES + tid] = word;
    }
  }

  // 3. each chunk of classes: ILP classes at a time, each its own chain
  //    of rounded adds in ascending k, so that their latencies overlap
  for (;;) {
    const int c0 = cb * d.CC;
    const int cc = min(d.CC, d.C - c0);
    for (int j0 = 0; live && j0 < cc; j0 += ILP) {
      const Entry* list[ILP];
      float raw[ILP], topo[ILP];
      int most_n = 0, most_t = 0;
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int j = min(j0 + u, cc - 1);   // past the chunk: its last class again
        list[u] = s.list + j * stride;
        most_n = max(most_n, s.cnt[j].x);
        most_t = max(most_t, s.cnt[j].y);
        raw[u] = topo[u] = 0.f;
      }
      for (int e = 0; e < most_n; ++e) {
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          const Entry x = list[u][e];
          if (bit<ONE>(hb0, s.hb, x.k, tid)) raw[u] = __fadd_rn(raw[u], x.w);
        }
      }
      for (int e = 0; e < most_t; ++e) {
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          const Entry x = list[u][d.K + e];
          if (bit<ONE>(pr0, s.pr, x.k, tid)) topo[u] = __fadd_rn(topo[u], x.w);
        }
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        if (j0 + u < cc) {
          const float r = d.K2 ? __fadd_rn(raw[u], topo[u]) : raw[u];
          const float sc = __fmul_rn(__fdiv_rn(r, s.den[j0 + u]), MAX_SCORE);
          out[(size_t)(c0 + j0 + u) * d.N + n] = __fmul_rn(d.w, sc);
        }
      }
    }
    cb += gridDim.y;
    if (cb >= d.chunks) break;
    __syncthreads();   // this chunk's lists are read
    stage_classes(s, lists, counts, denom, d, cb * d.CC, min(d.CC, d.C - cb * d.CC));
    copies_land();
  }
}

Dims make_dims(int C, int N, int K, int K2, int D, int TK, float w) {
  Dims d;
  d.C = C; d.N = N; d.K = K; d.K2 = K2; d.D = D; d.TK = TK; d.w = w;
  d.KW = (K + 31) / 32;
  d.K2W = (K2 + 31) / 32;
  d.CC = d.chunks = 0;
  return d;
}

}  // namespace

// The launch `kb_podaff_score` makes at these sizes on the current card:
// plan[0..6] = classes a block, chunks, grid x, grid y, node words in
// registers (0/1), Hd in shared memory (0/1), dynamic shared memory bytes.
extern "C" int kb_podaff_plan(int C, int N, int K, int K2, int D, int TK, int* plan) {
  const Plan p = make_plan(make_dims(C, N, K, K2, D, TK, 0.f), sm_count());
  const int v[7] = {p.cc, p.chunks, p.gx, p.gy, p.one, p.hd_smem, (int)p.smem};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return 0;
}

// lists: i32[C, K + K2, 2] of (k, w's float32 bits), counts: i32[C, 2]
// (kernels/podaff_score.py · class_lists), both 8-byte aligned; out:
// f32[C, N], every cell written.  Returns -1 for a vocabulary past
// MAX_WORDS words, a term key past the packed 20 bits or a block past
// SMEM_MAX bytes of shared memory, else cudaGetLastError() after the
// launch.
extern "C" int kb_podaff_score(const int32_t* lists, const int32_t* counts, const float* denom,
                               const uint32_t* hb, const uint32_t* hd, const int32_t* nkd,
                               const int32_t* term_key, const int32_t* term_label, int C,
                               int N, int K, int K2, int D, int TK, float w, float* out,
                               cudaStream_t stream) {
  Dims d = make_dims(C, N, K, K2, D, TK, w);
  if (d.KW > MAX_WORDS || d.K2W > MAX_WORDS || (K2 > 0 && (TK < 1 || D < 1))
      || TK > (1 << 20) / NODES)
    return -1;
  if (C == 0 || N == 0) return 0;
  const Plan p = make_plan(d, sm_count());
  if (p.smem > (size_t)SMEM_MAX) return -1;
  d.CC = p.cc;
  d.chunks = p.chunks;
  void (*kernel)(const Entry*, const int2*, const float*, const uint32_t*, const uint32_t*,
                 const int32_t*, const int32_t*, const int32_t*, float*, const Dims) =
      p.one ? (p.hd_smem ? &podaff_kernel<true, true> : &podaff_kernel<true, false>)
            : (p.hd_smem ? &podaff_kernel<false, true> : &podaff_kernel<false, false>);
  if (p.smem > (size_t)SMEM_DEFAULT) {   // many topology keys: opt in past 48 KB
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err) return err;
  }
  kernel<<<dim3(p.gx, p.gy), NODES, p.smem, stream>>>(
      reinterpret_cast<const Entry*>(lists), reinterpret_cast<const int2*>(counts), denom, hb,
      hd, nkd, term_key, term_label, out, d);
  return (int)cudaGetLastError();
}
