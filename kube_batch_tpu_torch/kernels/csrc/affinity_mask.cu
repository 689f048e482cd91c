// K10 · the inter-pod affinity predicate: bool[T, N] mask and bool[N] row.
//
// Replaces kube_batch_tpu/plugins/predicates.py · _topo_feasibility,
// _affinity_candidate_ok, pod_affinity_predicate and pod_affinity_row,
// which XLA lowers to f32 matrix products of 0/1 operands against the
// resident tables (kernel K11) and compares:
//   have  = aff @ Hb^T           aff_ok = have + bootstrap >= need
//   anti  = anti @ Hb_anti^T     sym = labels @ Ab_anti^T
//   (topology terms) have2 = aff_topo @ present^T, anti2 = anti_topo @
//   present_now^T, sym2 = sum over keys of labels @ Ad_now[domain]^T,
//   where present[n, j] = Hd[node_key_domain[n, key[j]], label[j]].
// A cell is feasible when aff_ok, no anti or symmetry hit, and the same
// for the topology terms.
//
// Bound on this card: bytes, the T*N output (one byte a cell: 0.54 GB at
// the flagship shapes); each cell needs a few dozen bit operations.
// Design: every operand is 0/1, so each count is a popcount of 32-bit
// words and is exact, and kernel and plain version agree bit for bit.
//   pass 1, one thread per node: the node's words — Hb, Hb_anti, the
//     symmetry mask (Ab_anti, OR'ed over every topology-key column of
//     Ad_now through node_key_domain), present and present_now — and
//     the term-exists words (Hb.any(0)) by atomicOr;
//   pass 2, one thread per task (or the one task of the row form, read
//     from device memory so the caller never waits): the task's words —
//     aff, anti, labels, aff_topo, anti_topo — and its two thresholds
//     need - bootstrap, with the bootstrap waiver read from the exists
//     words;
//   pass 3, 2-D tiles of 32 nodes x 32 tasks as K1's: both sides' words
//     staged in shared memory, one byte written per cell, each warp
//     writing 32 consecutive bytes of one row (the row form: one thread
//     per node).
// Padded vocabulary columns are zero on the task side, so they never
// count; padded nodes and padded topology-key columns (the dead domain)
// are evaluated by the same formula as the plain version.
//
// kb_affinity_words is the form the auction rounds take: passes 1 and 2
// only, nothing written per cell.  Kernel K2 (propose.cu) applies pass
// 3's cell test inside its own tiles.  The task words read nothing but
// the snapshot, so the caller keeps them for the snapshot's life and a
// round builds only the node words and the thresholds
// (affinity_thresholds_kernel, from the kept words and the term-exists
// words): at the flagship shapes 160 KB of node words and 512 KB of
// thresholds a round, where the mask was 0.54 GB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXW = 8;    // words per vocabulary: K, K2 <= 256
constexpr int TILE = 32;
constexpr int ROWS = 4;

struct Dims {
  int T, N, K, K2, TK, KW, K2W;
  __host__ __device__ int nw() const { return 3 * KW + 2 * K2W; }
};

// node words: [Hb | Hb_anti | sym | present | present_now]
__global__ void affinity_nodes_kernel(
    Dims d, const uint8_t* __restrict__ Hb, const uint8_t* __restrict__ Hba,
    const uint8_t* __restrict__ Aba, const uint8_t* __restrict__ Hd,
    const uint8_t* __restrict__ Hd_now, const uint8_t* __restrict__ Ad_now,
    const int32_t* __restrict__ nkd, const int32_t* __restrict__ term_key,
    const int32_t* __restrict__ term_label, uint32_t* __restrict__ node_words,
    uint32_t* __restrict__ exists) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= d.N) return;
  uint32_t* out = node_words + (size_t)n * d.nw();
  const int* dom = nkd + (size_t)n * d.TK;
  for (int w = 0; w < d.KW; ++w) {
    uint32_t hb = 0, hba = 0, sym = 0;
    for (int b = 0; b < 32; ++b) {
      int k = w * 32 + b;
      if (k >= d.K) break;
      size_t i = (size_t)n * d.K + k;
      if (Hb[i]) hb |= 1u << b;
      if (Hba[i]) hba |= 1u << b;
      bool s = Aba[i] != 0;
      if (d.K2)
        for (int tk = 0; tk < d.TK; ++tk) s = s || Ad_now[(size_t)dom[tk] * d.K + k];
      if (s) sym |= 1u << b;
    }
    out[w] = hb;
    out[d.KW + w] = hba;
    out[2 * d.KW + w] = sym;
    if (hb) atomicOr(exists + w, hb);
  }
  for (int w = 0; w < d.K2W; ++w) {
    uint32_t pres = 0, now = 0;
    for (int b = 0; b < 32; ++b) {
      int j = w * 32 + b;
      if (j >= d.K2) break;
      size_t i = (size_t)dom[term_key[j]] * d.K + term_label[j];
      if (Hd[i]) pres |= 1u << b;
      if (Hd_now[i]) now |= 1u << b;
    }
    out[3 * d.KW + w] = pres;
    out[3 * d.KW + d.K2W + w] = now;
  }
}

__device__ __forceinline__ uint32_t bits(const float* row, int w, int width) {
  uint32_t v = 0;
  for (int b = 0; b < 32; ++b) {
    int k = w * 32 + b;
    if (k >= width) break;
    if (row[k] > 0.f) v |= 1u << b;
  }
  return v;
}

// task words: [aff | anti | labels | aff_topo | anti_topo], thresholds
// thr[0] = need - bootstrap (node terms), thr[1] = the same for topo terms.
// `row` (device int64) selects one task for the row form, else all tasks.
__global__ void affinity_tasks_kernel(
    Dims d, const float* __restrict__ aff, const float* __restrict__ anti,
    const float* __restrict__ labels, const float* __restrict__ aff_topo,
    const float* __restrict__ anti_topo, const int32_t* __restrict__ term_label,
    const uint32_t* __restrict__ exists, const int64_t* __restrict__ row,
    uint32_t* __restrict__ task_words, int32_t* __restrict__ thr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int count = row ? 1 : d.T;
  if (i >= count) return;
  const int t = row ? (int)row[0] : i;
  uint32_t* out = task_words + (size_t)i * d.nw();
  int need = 0, boot = 0;
  for (int w = 0; w < d.KW; ++w) {
    uint32_t a = bits(aff + (size_t)t * d.K, w, d.K);
    uint32_t l = bits(labels + (size_t)t * d.K, w, d.K);
    out[w] = a;
    out[d.KW + w] = bits(anti + (size_t)t * d.K, w, d.K);
    out[2 * d.KW + w] = l;
    need += __popc(a);
    boot += __popc(a & l & ~exists[w]);
  }
  int need2 = 0, boot2 = 0;
  for (int w = 0; w < d.K2W; ++w) {
    uint32_t a = bits(aff_topo + (size_t)t * d.K2, w, d.K2);
    uint32_t own = 0, gone = 0;
    for (int b = 0; b < 32; ++b) {
      int j = w * 32 + b;
      if (j >= d.K2) break;
      int lab = term_label[j];
      if (labels[(size_t)t * d.K + lab] > 0.f) own |= 1u << b;
      if (!((exists[lab >> 5] >> (lab & 31)) & 1u)) gone |= 1u << b;
    }
    out[3 * d.KW + w] = a;
    out[3 * d.KW + d.K2W + w] = bits(anti_topo + (size_t)t * d.K2, w, d.K2);
    need2 += __popc(a);
    boot2 += __popc(a & own & gone);
  }
  thr[2 * i] = need - boot;
  thr[2 * i + 1] = need2 - boot2;
}

// thresholds from kept task words: the same need - bootstrap as
// affinity_tasks_kernel, the labels read from the task's label words
__global__ void affinity_thresholds_kernel(Dims d, const uint32_t* __restrict__ task_words,
                                           const int32_t* __restrict__ term_label,
                                           const uint32_t* __restrict__ exists,
                                           int32_t* __restrict__ thr) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= d.T) return;
  const uint32_t* tw = task_words + (size_t)t * d.nw();
  int need = 0, boot = 0;
  for (int w = 0; w < d.KW; ++w) {
    const uint32_t a = tw[w];
    need += __popc(a);
    boot += __popc(a & tw[2 * d.KW + w] & ~exists[w]);
  }
  int need2 = 0, boot2 = 0;
  for (int w = 0; w < d.K2W; ++w) {
    const uint32_t a = tw[3 * d.KW + w];
    uint32_t own = 0, gone = 0;
    for (int b = 0; b < 32; ++b) {
      const int j = w * 32 + b;
      if (j >= d.K2) break;
      const int lab = term_label[j];
      if ((tw[2 * d.KW + (lab >> 5)] >> (lab & 31)) & 1u) own |= 1u << b;
      if (!((exists[lab >> 5] >> (lab & 31)) & 1u)) gone |= 1u << b;
    }
    need2 += __popc(a);
    boot2 += __popc(a & own & gone);
  }
  thr[2 * t] = need - boot;
  thr[2 * t + 1] = need2 - boot2;
}

__device__ __forceinline__ bool cell(const Dims& d, const uint32_t* tw, const int32_t* th,
                                     const uint32_t* nw) {
  int have = 0;
  uint32_t hit = 0;
  for (int w = 0; w < d.KW; ++w) {
    have += __popc(tw[w] & nw[w]);
    hit |= (tw[d.KW + w] & nw[d.KW + w]) | (tw[2 * d.KW + w] & nw[2 * d.KW + w]);
  }
  bool ok = have >= th[0];
  if (d.K2W) {
    int have2 = 0;
    for (int w = 0; w < d.K2W; ++w) {
      have2 += __popc(tw[3 * d.KW + w] & nw[3 * d.KW + w]);
      hit |= tw[3 * d.KW + d.K2W + w] & nw[3 * d.KW + d.K2W + w];
    }
    ok = ok && have2 >= th[1];
  }
  return ok && hit == 0;
}

__global__ void affinity_cells_kernel(Dims d, const uint32_t* __restrict__ task_words,
                                      const int32_t* __restrict__ thr,
                                      const uint32_t* __restrict__ node_words,
                                      uint8_t* __restrict__ out) {
  __shared__ uint32_t tws[TILE][5 * MAXW];
  __shared__ int32_t ths[TILE][2];
  __shared__ uint32_t nws[TILE][5 * MAXW + 1];
  const int nw = d.nw();
  const int n0 = blockIdx.x * TILE, t0 = blockIdx.y * TILE;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < TILE * nw; i += nthreads) {
    int r = i / nw, w = i % nw;
    tws[r][w] = (t0 + r < d.T) ? task_words[(size_t)(t0 + r) * nw + w] : 0u;
    nws[r][w] = (n0 + r < d.N) ? node_words[(size_t)(n0 + r) * nw + w] : 0u;
  }
  for (int i = tid; i < TILE * 2; i += nthreads)
    ths[i / 2][i % 2] = (t0 + i / 2 < d.T) ? thr[(size_t)t0 * 2 + i] : 0;
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (n >= d.N) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    int r = threadIdx.y + i * blockDim.y;
    int t = t0 + r;
    if (t >= d.T) continue;
    out[(size_t)t * d.N + n] = cell(d, tws[r], ths[r], nws[threadIdx.x]) ? 1 : 0;
  }
}

__global__ void affinity_row_kernel(Dims d, const uint32_t* __restrict__ task_words,
                                    const int32_t* __restrict__ thr,
                                    const uint32_t* __restrict__ node_words,
                                    uint8_t* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= d.N) return;
  out[n] = cell(d, task_words, thr, node_words + (size_t)n * d.nw()) ? 1 : 0;
}

Dims make_dims(int T, int N, int K, int K2, int TK) {
  Dims d{T, N, K, K2, TK, (K + 31) / 32, (K2 + 31) / 32};
  return d;
}

int prepare(const Dims& d, const uint8_t* Hb, const uint8_t* Hba, const uint8_t* Aba,
            const uint8_t* Hd, const uint8_t* Hd_now, const uint8_t* Ad_now,
            const int32_t* nkd, const int32_t* term_key, const int32_t* term_label,
            const float* aff, const float* anti, const float* labels, const float* aff_topo,
            const float* anti_topo, const int64_t* row, uint32_t* node_words,
            uint32_t* exists, uint32_t* task_words, int32_t* thr, cudaStream_t stream) {
  if (d.KW > MAXW || d.K2W > MAXW) return (int)cudaErrorInvalidValue;
  affinity_nodes_kernel<<<(d.N + 127) / 128, 128, 0, stream>>>(
      d, Hb, Hba, Aba, Hd, Hd_now, Ad_now, nkd, term_key, term_label, node_words, exists);
  int err = (int)cudaGetLastError();
  if (err) return err;
  int count = row ? 1 : d.T;
  affinity_tasks_kernel<<<(count + 127) / 128, 128, 0, stream>>>(
      d, aff, anti, labels, aff_topo, anti_topo, term_label, exists, row, task_words, thr);
  return (int)cudaGetLastError();
}

}  // namespace

// The mask: out u8[T, N].  Scratch from the caller: node_words u32[N, NW],
// task_words u32[T, NW], thr i32[T, 2], exists u32[KW] zeroed, with
// NW = 3 ceil(K/32) + 2 ceil(K2/32).  Domain tables may be null when
// K2 == 0.
extern "C" int kb_affinity_mask(
    const float* aff, const float* anti, const float* labels, const float* aff_topo,
    const float* anti_topo, const int32_t* term_key, const int32_t* term_label,
    const int32_t* nkd, const uint8_t* Hb, const uint8_t* Hba, const uint8_t* Aba,
    const uint8_t* Hd, const uint8_t* Hd_now, const uint8_t* Ad_now, int T, int N, int K,
    int K2, int TK, uint32_t* node_words, uint32_t* exists, uint32_t* task_words,
    int32_t* thr, uint8_t* out, cudaStream_t stream) {
  if (T == 0 || N == 0) return 0;
  Dims d = make_dims(T, N, K, K2, TK);
  int err = prepare(d, Hb, Hba, Aba, Hd, Hd_now, Ad_now, nkd, term_key, term_label, aff,
                    anti, labels, aff_topo, anti_topo, nullptr, node_words, exists,
                    task_words, thr, stream);
  if (err) return err;
  dim3 block(TILE, TILE / ROWS);
  dim3 grid((N + TILE - 1) / TILE, (T + TILE - 1) / TILE);
  affinity_cells_kernel<<<grid, block, 0, stream>>>(d, task_words, thr, node_words, out);
  return (int)cudaGetLastError();
}

// The row of task *p (device int64): out u8[N].  Scratch as above, with
// task_words u32[1, NW] and thr i32[1, 2].
extern "C" int kb_affinity_row(
    const float* aff, const float* anti, const float* labels, const float* aff_topo,
    const float* anti_topo, const int32_t* term_key, const int32_t* term_label,
    const int32_t* nkd, const uint8_t* Hb, const uint8_t* Ab, const uint8_t* Hd,
    const uint8_t* Ad, const int64_t* p, int T, int N, int K, int K2, int TK,
    uint32_t* node_words, uint32_t* exists, uint32_t* task_words, int32_t* thr,
    uint8_t* out, cudaStream_t stream) {
  if (N == 0) return 0;
  Dims d = make_dims(T, N, K, K2, TK);
  int err = prepare(d, Hb, Hb, Ab, Hd, Hd, Ad, nkd, term_key, term_label, aff, anti,
                    labels, aff_topo, anti_topo, p, node_words, exists, task_words, thr,
                    stream);
  if (err) return err;
  affinity_row_kernel<<<(N + 127) / 128, 128, 0, stream>>>(d, task_words, thr, node_words,
                                                          out);
  return (int)cudaGetLastError();
}

// The words form: node_words u32[N, NW] and thr i32[T, 2] of this round,
// and task_words u32[T, NW], built here when build_task_words is set and
// read (kept from an earlier call on the same snapshot) otherwise.
// exists u32[KW] is scratch, zeroed here.
extern "C" int kb_affinity_words(
    const float* aff, const float* anti, const float* labels, const float* aff_topo,
    const float* anti_topo, const int32_t* term_key, const int32_t* term_label,
    const int32_t* nkd, const uint8_t* Hb, const uint8_t* Hba, const uint8_t* Aba,
    const uint8_t* Hd, const uint8_t* Hd_now, const uint8_t* Ad_now, int T, int N, int K,
    int K2, int TK, int build_task_words, uint32_t* node_words, uint32_t* exists,
    uint32_t* task_words, int32_t* thr, cudaStream_t stream) {
  if (T == 0 || N == 0) return 0;
  Dims d = make_dims(T, N, K, K2, TK);
  if (d.KW > MAXW || d.K2W > MAXW) return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(exists, 0, sizeof(uint32_t) * (d.KW ? d.KW : 1), stream);
  if (err) return err;
  if (build_task_words)
    return prepare(d, Hb, Hba, Aba, Hd, Hd_now, Ad_now, nkd, term_key, term_label, aff,
                   anti, labels, aff_topo, anti_topo, nullptr, node_words, exists,
                   task_words, thr, stream);
  affinity_nodes_kernel<<<(d.N + 127) / 128, 128, 0, stream>>>(
      d, Hb, Hba, Aba, Hd, Hd_now, Ad_now, nkd, term_key, term_label, node_words, exists);
  affinity_thresholds_kernel<<<(d.T + 127) / 128, 128, 0, stream>>>(d, task_words,
                                                                     term_label, exists, thr);
  return (int)cudaGetLastError();
}
