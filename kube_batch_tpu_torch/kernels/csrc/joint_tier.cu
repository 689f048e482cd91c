// K12 · tier control of the joint single-solve cycle.
//
// Replaces kube_batch_tpu/ops/joint.py · _haswork_fn and advance (and
// the tier_done test of the loop body), which XLA lowers to [T]-wide
// mask reductions, a request sum and a scatter into node_future under a
// lax.cond on the phase register:
//   auction tier  work = pending & eligible; has_work = any(work)
//                 [& any(evict_code > 0) for the gated admission tier]
//   evict tier    work = pending & starving[job] & job >= 0 & eligible &
//                 ~tried; has_work = any(work) | plan open
//   tier_done     = ~progressed | step >= max_steps | ~has_work
//   advance       Discard of an open plan (its provisional victims back to
//                 their snapshot status, their codes cleared, the plan's
//                 request sum given back to node_future[prov_n]), tried /
//                 prov / excl reset, phase += 1.
//
// It is fed by the step it follows, and feeds the next one:
//   * in: the last step's output — nothing at a tier's first call, an
//     auction round's accept mask (progressed = any accepted; the count
//     is taken here), or an evict step's i64[7] flag vector (the carry
//     [progressed, plan open, plan node] is its first three entries);
//   * out: `work` (bool[T]), the next step's pending & eligible set, so
//     the step does not compute the tier's masks again (void when the
//     tier is done); and one i64[10] read buffer — the step's flags
//     (the accepted count, or the evict flags), then [done, has_work,
//     phase] — that the host reads once per step.
//
// Bound on this card: bytes — one pass over a handful of [T] masks and
// the work mask written: at the preempt path's T = 8,192 about 100 KB,
// at T = 65,536 under 1 MB, so one launch costs its launch latency.
// Design: one block of 1024 threads walks the rows with a stride (right
// for any T; one SM streams the 100 KB in about a microsecond, and a
// grid of blocks would need a second launch or a grid-wide barrier to
// combine the any() tests before the advance, for nothing at these
// sizes), reduces the two any() tests with __syncthreads_or and the
// accepted count with a warp-shuffle sum, and when the tier is done
// applies the advance in place in the same launch.  The plan's request
// sum is float64 per thread, combined in a fixed tree and rounded once
// to float32 (exact on integer-valued requests, as the preemption
// loop's prov_req_sum); node_future[prov_n] then loses it with
// __fsub_rn, as the reference's float32 scatter-add.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_R = 8;
constexpr int STEP_FLAGS = 7;      // the evict step's flag vector
constexpr int READ = STEP_FLAGS + 3;

__global__ void __launch_bounds__(THREADS) joint_tier_kernel(
    int kind, int gated, int step_kind, int step, int max_steps, int T, int N, int R, int J,
    const void* __restrict__ step_out, int32_t* __restrict__ task_state,
    const int32_t* __restrict__ snap_state, const uint8_t* __restrict__ task_mask,
    const uint8_t* __restrict__ elig, const uint8_t* __restrict__ starving,
    const int32_t* __restrict__ task_job, uint8_t* __restrict__ tried,
    uint8_t* __restrict__ prov, int32_t* __restrict__ code,
    const float* __restrict__ task_req, float* __restrict__ node_future,
    uint8_t* __restrict__ excl, int32_t* __restrict__ phase, uint8_t* __restrict__ work,
    int64_t* __restrict__ read) {
  __shared__ double part[MAX_R][THREADS / 32];
  __shared__ long long counts[THREADS / 32];
  const int tid = threadIdx.x;
  const uint8_t* accept = step_kind == 1 ? (const uint8_t*)step_out : nullptr;
  const int64_t* flags = step_kind == 2 ? (const int64_t*)step_out : nullptr;
  int any_work = 0, any_code = 0;
  long long accepted = 0;
  for (int t = tid; t < T; t += THREADS) {
    bool e = task_state[t] == 0 && task_mask[t] && elig[t];
    if (kind == 1) {
      int j = task_job[t];
      int jc = j < 0 ? 0 : (j > J - 1 ? J - 1 : j);
      e = e && starving[jc] && j >= 0 && !tried[t];
    }
    work[t] = e;
    any_work |= e;
    if (gated) any_code |= code[t] > 0;
    if (accept) accepted += accept[t];
  }
  any_work = __syncthreads_or(any_work);
  any_code = __syncthreads_or(any_code);
  if (accept) {
    for (int off = 16; off > 0; off >>= 1) accepted += __shfl_down_sync(0xffffffffu, accepted, off);
    if ((tid & 31) == 0) counts[tid >> 5] = accepted;
    __syncthreads();
    if (tid == 0)
      for (int w = 1; w < THREADS / 32; ++w) counts[0] += counts[w];
    __syncthreads();
    accepted = counts[0];
  }
  const bool progressed = accept ? accepted > 0 : (flags ? flags[0] != 0 : true);
  const bool prov_active = flags && flags[1] != 0;
  const int prov_n = flags ? (int)flags[2] : 0;
  const bool has_work = kind == 0 ? (any_work && (!gated || any_code))
                                  : (any_work || prov_active);
  const bool done = !progressed || step >= max_steps || !has_work;
  if (done) {
    if (prov_active) {
      double acc[MAX_R];
      for (int r = 0; r < R; ++r) acc[r] = 0.0;
      for (int t = tid; t < T; t += THREADS) {
        if (!prov[t]) continue;
        task_state[t] = snap_state[t];
        code[t] = 0;
        for (int r = 0; r < R; ++r) acc[r] += (double)task_req[(size_t)t * R + r];
      }
      for (int r = 0; r < R; ++r) {
        double v = acc[r];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if ((tid & 31) == 0) part[r][tid >> 5] = v;
      }
      __syncthreads();
      if (tid == 0) {
        for (int r = 0; r < R; ++r) {
          double s = 0.0;
          for (int w = 0; w < THREADS / 32; ++w) s += part[r][w];
          float* f = node_future + (size_t)prov_n * R + r;
          *f = __fsub_rn(*f, (float)s);
        }
      }
      __syncthreads();
    }
    for (int t = tid; t < T; t += THREADS) {
      tried[t] = 0;
      prov[t] = 0;
    }
    for (int n = tid; n < N; n += THREADS) excl[n] = 0;
  }
  if (tid < STEP_FLAGS) read[tid] = flags ? flags[tid] : (tid == 0 ? accepted : 0);
  if (tid == 0) {
    if (done) phase[0] += 1;
    read[STEP_FLAGS] = done;
    read[STEP_FLAGS + 1] = has_work;
    read[STEP_FLAGS + 2] = phase[0];
  }
}

}  // namespace

// kind 0 = auction tier, 1 = evict tier; step_kind 0 = no step yet in
// this tier (step_out null), 1 = an auction round (step_out u8 accept[T]),
// 2 = an evict step (step_out i64 flags[7]); starving may be null for an
// auction tier.  Out: work u8[T], read i64[10].
extern "C" int kb_joint_tier(
    int kind, int gated, int step_kind, int step, int max_steps, int T, int N, int R, int J,
    const void* step_out, int32_t* task_state, const int32_t* snap_state,
    const uint8_t* task_mask, const uint8_t* elig, const uint8_t* starving,
    const int32_t* task_job, uint8_t* tried, uint8_t* prov, int32_t* code,
    const float* task_req, float* node_future, uint8_t* excl, int32_t* phase,
    uint8_t* work, int64_t* read, cudaStream_t stream) {
  if (R > MAX_R || (kind == 1 && (starving == nullptr || J <= 0)) ||
      (step_kind != 0 && step_out == nullptr))
    return (int)cudaErrorInvalidValue;
  joint_tier_kernel<<<1, THREADS, 0, stream>>>(
      kind, gated, step_kind, step, max_steps, T, N, R, J, step_out, task_state, snap_state,
      task_mask, elig, starving, task_job, tried, prov, code, task_req, node_future, excl,
      phase, work, read);
  return (int)cudaGetLastError();
}
