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
// affinity path, where T = 65,536), and this kernel writes the weighted
// table out[C, N] that kernel K2 reads at row cls[t].
//
// Bound on this card: bytes.  The class rows are read once (C·(K + K2)
// floats), K11's packed node words Hb [N, words(K)] and domain words
// Hd [D, words(K)] once, node_key_domain's rows once, the table written
// once: 0.6 MB at the affinity path's shapes, against 4.3 GB for the two
// [T, N] float32 tensors the plain products wrote and read per round.
// The arithmetic is a bit test and an add for each nonzero weight.
// Design:
//   * A thread a node, NODES nodes a block (grid x), CC classes a block
//     (grid y).  A thread builds its node's words once into shared
//     memory: Hb's row as it is, and the present bits of the K2
//     topology-scoped terms from Hd through node_key_domain.
//   * The block's classes are staged in shared memory as lists of their
//     nonzero (k, w) entries in ascending k, compacted by a warp a class
//     with ballots; every thread then walks them for its node (the same
//     entry for all threads: a broadcast read), class after class, and
//     the stores of one class are coalesced across the block.
//   * The sums follow the reference's order for one cell: the node-level
//     terms in ascending k, the topology terms in ascending k2 as a sum of
//     their own, then node + topo (topo only when K2 > 0), the division,
//     × 10, × w, each an explicitly rounded intrinsic, and the file is
//     compiled with --fmad=false.  A weight of zero is skipped where the
//     plain version adds +0: a sum that starts at +0 is never -0, so both
//     are the same float.  Kernel and plain version agree bit for bit;
//     with the reference's products they agree wherever the float32 sums
//     are exact (every world of this repository: weights 1.0, 0.5, small
//     integers).
//   * Any C: classes past CC go to further blocks along y (a block loops
//     when C / CC passes the grid's y limit); C = T gives the [T, N] score.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NODES = 128;               // nodes a block, a thread each
constexpr int WARPS = NODES / 32;
constexpr int MAX_WORDS = 8;             // words of a vocabulary: K, K2 <= 256
constexpr int MAX_CC = 64;               // classes a block
constexpr int LIST_BYTES = 32768;        // shared memory of the staged lists
constexpr int MAX_GRID_Y = 65535;
constexpr float MAX_SCORE = 10.0f;

struct Entry {
  int k;
  float w;
};

struct Args {
  const float* rows;        // f32[C, K] node-level preference weights
  const float* rows_topo;   // f32[C, K2] topology-scoped ones (null: K2 = 0)
  const float* denom;       // f32[C] max(Σ w, 1e-9)
  const uint32_t* hb;       // u32[N, KW] K11's node words (future residents)
  const uint32_t* hd;       // u32[D, KW] K11's domain words (null: K2 = 0)
  const int32_t* nkd;       // i32[N, TK] node_key_domain
  const int32_t* term_key;  // i32[K2]
  const int32_t* term_label;  // i32[K2]
  float* out;               // f32[C, N]
  int C, N, K, K2, KW, K2W, TK, CC;
  float w;
};

// Classes a block takes: as many as fit LIST_BYTES of entries, at most
// MAX_CC and at most C.
int classes_per_block(int C, int K, int K2) {
  const int per = (K + K2) * (int)sizeof(Entry);
  int cc = per > 0 ? LIST_BYTES / per : MAX_CC;
  cc = cc < 1 ? 1 : (cc > MAX_CC ? MAX_CC : cc);
  return cc < C ? cc : C;
}

size_t smem_bytes(const Args& a) {
  return (size_t)NODES * (a.KW + a.K2W) * 4 + (size_t)a.CC * 2 * 4
         + (size_t)a.CC * (a.K + a.K2) * sizeof(Entry);
}

// Warp `lane` of a warp: the nonzero entries of `src[0, n)` in ascending
// order into `dst`; returns their count (every lane).
__device__ __forceinline__ int compact(const float* src, int n, Entry* dst, int lane) {
  int cnt = 0;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int k = k0 + lane;
    const float v = k < n ? src[k] : 0.f;
    const bool nz = v != 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, nz);
    if (nz) dst[cnt + __popc(m & ((1u << lane) - 1u))] = Entry{k, v};
    cnt += __popc(m);
  }
  return cnt;
}

__device__ __forceinline__ bool bit_at(const uint32_t* words, int k, int tid) {
  return (words[(k >> 5) * NODES + tid] >> (k & 31)) & 1u;
}

__global__ void __launch_bounds__(NODES) podaff_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_hb = reinterpret_cast<uint32_t*>(smem);       // [KW][NODES]
  uint32_t* s_pr = s_hb + (size_t)a.KW * NODES;              // [K2W][NODES]
  int* s_nn = reinterpret_cast<int*>(s_pr + (size_t)a.K2W * NODES);   // [CC]
  int* s_nt = s_nn + a.CC;                                    // [CC]
  Entry* s_list = reinterpret_cast<Entry*>(s_nt + a.CC);     // [CC][K + K2]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x * NODES + tid;
  const bool live = n < a.N;

  // this thread's node: its Hb words and the present bits of the terms
  for (int w = 0; w < a.KW; ++w) s_hb[w * NODES + tid] = live ? a.hb[(size_t)n * a.KW + w] : 0u;
  for (int w2 = 0; w2 < a.K2W; ++w2) {
    uint32_t word = 0;
    if (live) {
      for (int b = 0; b < 32; ++b) {
        const int k2 = w2 * 32 + b;
        if (k2 >= a.K2) break;
        const int d = a.nkd[(size_t)n * a.TK + a.term_key[k2]];
        const int lab = a.term_label[k2];
        word |= ((a.hd[(size_t)d * a.KW + (lab >> 5)] >> (lab & 31)) & 1u) << b;
      }
    }
    s_pr[w2 * NODES + tid] = word;
  }

  const int chunks = (a.C + a.CC - 1) / a.CC;
  const int stride = a.K + a.K2;
  for (int cb = blockIdx.y; cb < chunks; cb += gridDim.y) {
    const int c0 = cb * a.CC;
    const int cc = min(a.CC, a.C - c0);
    __syncthreads();   // the node words are in; the last chunk's lists are read
    for (int j = warp; j < cc; j += WARPS) {
      Entry* list = s_list + (size_t)j * stride;
      const int nn = compact(a.rows + (size_t)(c0 + j) * a.K, a.K, list, lane);
      const int nt = a.K2 ? compact(a.rows_topo + (size_t)(c0 + j) * a.K2, a.K2,
                                    list + a.K, lane) : 0;
      if (lane == 0) {
        s_nn[j] = nn;
        s_nt[j] = nt;
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cc; ++j) {
      const Entry* list = s_list + (size_t)j * stride;
      float raw = 0.f;
      const int nn = s_nn[j];
      for (int e = 0; e < nn; ++e)
        if (bit_at(s_hb, list[e].k, tid)) raw = __fadd_rn(raw, list[e].w);
      if (a.K2) {
        float topo = 0.f;
        const int nt = s_nt[j];
        for (int e = 0; e < nt; ++e)
          if (bit_at(s_pr, list[a.K + e].k, tid)) topo = __fadd_rn(topo, list[a.K + e].w);
        raw = __fadd_rn(raw, topo);
      }
      const float s = __fmul_rn(__fdiv_rn(raw, a.denom[c0 + j]), MAX_SCORE);
      a.out[(size_t)(c0 + j) * a.N + n] = __fmul_rn(a.w, s);
    }
  }
}

}  // namespace

// out: f32[C, N], every cell written.  Returns -1 for a vocabulary past
// MAX_WORDS words, else cudaGetLastError() after the launch.
extern "C" int kb_podaff_score(const float* rows, const float* rows_topo, const float* denom,
                               const uint32_t* hb, const uint32_t* hd, const int32_t* nkd,
                               const int32_t* term_key, const int32_t* term_label, int C,
                               int N, int K, int K2, int TK, float w, float* out,
                               cudaStream_t stream) {
  Args a;
  a.rows = rows; a.rows_topo = rows_topo; a.denom = denom; a.hb = hb; a.hd = hd;
  a.nkd = nkd; a.term_key = term_key; a.term_label = term_label; a.out = out;
  a.C = C; a.N = N; a.K = K; a.K2 = K2; a.TK = TK; a.w = w;
  a.KW = (K + 31) / 32;
  a.K2W = (K2 + 31) / 32;
  if (a.KW > MAX_WORDS || a.K2W > MAX_WORDS) return -1;
  if (C == 0 || N == 0) return 0;
  a.CC = classes_per_block(C, K, K2);
  const int chunks = (C + a.CC - 1) / a.CC;
  const dim3 grid((N + NODES - 1) / NODES, chunks < MAX_GRID_Y ? chunks : MAX_GRID_Y);
  podaff_kernel<<<grid, NODES, smem_bytes(a), stream>>>(a);
  return (int)cudaGetLastError();
}
