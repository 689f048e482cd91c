// K1 · static predicate mask, bool[T, N].
//
// Replaces kube_batch_tpu/plugins/predicates.py · PredicatesPlugin.register
// .predicate (reached through framework/policy.py · predicate_mask), which
// XLA lowers to multi-hot matrix products plus compares:
//   selector   task_sel @ node_labels^T  >= sum(task_sel)
//   taints     sum(node_taints) - task_tol @ node_taints^T <= 0.5
//   host ports task_ports @ node_ports^T <= 0.5
//   readiness, opt-in pressure, volume pin, volume groups
//   (task_vol_groups @ (1 - node_ok_g)^T <= 0.5).
//
// Bound on this card: the output.  The multi-hot widths are small (tens),
// so a cell costs a few dozen adds while its result is one byte: at the
// flagship shapes the kernel must write T*N bytes (0.54 GB) and read only
// kilobytes of vocabulary rows.  Design: one thread per (task, node)
// cell in 2-D tiles (32 nodes x 32 tasks per block); the tile's task and
// node rows are staged through shared memory in 32-column chunks, so each
// row is read from device memory once per tile, and each warp writes 32
// consecutive bytes of one output row.  The inputs are 0/1, so every
// count is an exact integer in float32 whatever the order, and the
// compares are the reference's own (>=, <= 0.5).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;   // nodes (x) and tasks (y) per block
constexpr int ROWS = 4;    // task rows per thread (blockDim.y = TILE / ROWS)

// acc[i] += A[t_i, :] . B[n, :] over width W; optionally also the row sums
// of A (sumA[i]) or of B (sumB).
__device__ void tile_dot(const float* __restrict__ A, const float* __restrict__ B,
                         int W, int T, int N, int t0, int n0,
                         float acc[ROWS], float sumA[ROWS], float* sumB,
                         float (*As)[TILE + 1], float (*Bs)[TILE + 1]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int k0 = 0; k0 < W; k0 += TILE) {
    // cooperative loads: 32 x 32 of A (task rows) and of B (node rows)
    for (int r = ty; r < TILE; r += blockDim.y) {
      int t = t0 + r, k = k0 + tx, n = n0 + r;
      As[r][tx] = (t < T && k < W) ? A[(size_t)t * W + k] : 0.f;
      Bs[r][tx] = (n < N && k < W) ? B[(size_t)n * W + k] : 0.f;
    }
    __syncthreads();
    int kmax = min(TILE, W - k0);
    for (int k = 0; k < kmax; ++k) {
      float b = Bs[tx][k];
      if (sumB) *sumB += b;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float a = As[ty + i * blockDim.y][k];
        acc[i] += a * b;
        if (sumA) sumA[i] += a;
      }
    }
    __syncthreads();
  }
}

__global__ void predicate_mask_kernel(
    const float* __restrict__ task_sel, const float* __restrict__ node_labels, int L,
    const float* __restrict__ task_tol, const float* __restrict__ node_taints, int V,
    const float* __restrict__ task_ports, const float* __restrict__ node_ports, int P,
    const uint8_t* __restrict__ node_ready, const float* __restrict__ node_pressure,
    const int32_t* __restrict__ task_vol_node,
    const float* __restrict__ task_vol_groups, const float* __restrict__ node_miss_g, int G,
    int T, int N, int flags, uint8_t* __restrict__ out) {
  __shared__ float As[TILE][TILE + 1];
  __shared__ float Bs[TILE][TILE + 1];
  const int n0 = blockIdx.x * TILE, t0 = blockIdx.y * TILE;
  const int n = n0 + threadIdx.x;
  bool ok[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) ok[i] = true;

  if (flags & 1) {  // selector
    float have[ROWS] = {0}, want[ROWS] = {0};
    tile_dot(task_sel, node_labels, L, T, N, t0, n0, have, want, nullptr, As, Bs);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) ok[i] = ok[i] && (have[i] >= want[i]);
  }
  if (flags & 2) {  // taints
    float tolerated[ROWS] = {0}, total = 0.f;
    tile_dot(task_tol, node_taints, V, T, N, t0, n0, tolerated, nullptr, &total, As, Bs);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) ok[i] = ok[i] && (total - tolerated[i] <= 0.5f);
  }
  if (flags & 4) {  // host ports
    float clash[ROWS] = {0};
    tile_dot(task_ports, node_ports, P, T, N, t0, n0, clash, nullptr, nullptr, As, Bs);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) ok[i] = ok[i] && (clash[i] <= 0.5f);
  }
  if ((flags & 128) && G > 0) {  // volume groups
    float miss[ROWS] = {0};
    tile_dot(task_vol_groups, node_miss_g, G, T, N, t0, n0, miss, nullptr, nullptr, As, Bs);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) ok[i] = ok[i] && (miss[i] <= 0.5f);
  }
  if (n >= N) return;
  bool node_ok = true;
  if (flags & 8) node_ok = node_ok && node_ready[n];
  for (int d = 0; d < 3; ++d)
    if (flags & (16 << d)) node_ok = node_ok && (node_pressure[(size_t)n * 3 + d] <= 0.5f);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    int t = t0 + threadIdx.y + i * blockDim.y;
    if (t >= T) continue;
    bool v = ok[i] && node_ok;
    if (flags & 128) {
      int pin = task_vol_node[t];
      v = v && (pin == -1 || pin == n);
    }
    out[(size_t)t * N + n] = v ? 1 : 0;
  }
}

}  // namespace

// flags: 1 selector, 2 taints, 4 host ports, 8 node ready, 16/32/64
// pressure dims 0..2, 128 volume binding (pin; groups when G > 0).
extern "C" int kb_predicate_mask(
    const float* task_sel, const float* node_labels, int L,
    const float* task_tol, const float* node_taints, int V,
    const float* task_ports, const float* node_ports, int P,
    const uint8_t* node_ready, const float* node_pressure,
    const int32_t* task_vol_node, const float* task_vol_groups,
    const float* node_miss_g, int G, int T, int N, int flags, uint8_t* out,
    cudaStream_t stream) {
  if (T == 0 || N == 0) return 0;
  dim3 block(TILE, TILE / ROWS);
  dim3 grid((N + TILE - 1) / TILE, (T + TILE - 1) / TILE);
  predicate_mask_kernel<<<grid, block, 0, stream>>>(
      task_sel, node_labels, L, task_tol, node_taints, V, task_ports, node_ports, P,
      node_ready, node_pressure, task_vol_node, task_vol_groups, node_miss_g, G, T, N,
      flags, out);
  return (int)cudaGetLastError();
}
