// K12 · tier control of the joint single-solve cycle.
//
// Replaces kube_batch_tpu/ops/joint.py · _haswork_fn and advance (and
// the tier_done test of the loop body), which XLA lowers to [T]-wide
// mask reductions, a request sum and a scatter into node_future under a
// lax.cond on the phase register:
//   auction tier  has_work = any(pending & eligible) [& any(evict_code > 0)
//                 for the gated admission tier]
//   evict tier    has_work = any(pending & starving[job] & job >= 0 &
//                 eligible & ~tried) | plan open
//   tier_done     = ~progressed | step >= max_steps | ~has_work
//   advance       Discard of an open plan (its provisional victims back to
//                 their snapshot status, their codes cleared, the plan's
//                 request sum given back to node_future[prov_n]), tried /
//                 prov / excl reset, phase += 1.
//
// Bound on this card: bytes — one pass over a handful of [T] masks; at
// the preempt path's T = 8,192 that is tens of kilobytes, so one launch
// costs its launch latency.  Design: one block of 1024 threads reads the
// masks once, reduces the two any() tests with __syncthreads_or, and when
// the tier is done applies the advance in place in the same launch, so a
// step needs no second launch and the host reads one flag vector.  The
// plan's request sum is float64 per thread, combined in a fixed tree and
// rounded once to float32 (exact on integer-valued requests, as the
// preemption loop's prov_req_sum); node_future[prov_n] then loses it in
// float32, as the reference's scatter-add.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_R = 8;

__global__ void joint_tier_kernel(
    int kind, int gated, int step, int max_steps, int T, int N, int R, int J,
    const int32_t* __restrict__ carry, int32_t* __restrict__ task_state,
    const int32_t* __restrict__ snap_state, const uint8_t* __restrict__ task_mask,
    const uint8_t* __restrict__ elig, const uint8_t* __restrict__ starving,
    const int32_t* __restrict__ task_job, uint8_t* __restrict__ tried,
    uint8_t* __restrict__ prov, int32_t* __restrict__ code,
    const float* __restrict__ task_req, float* __restrict__ node_future,
    uint8_t* __restrict__ excl, int32_t* __restrict__ phase, int32_t* __restrict__ flags) {
  __shared__ double part[MAX_R][THREADS / 32];
  const int tid = threadIdx.x;
  const int progressed = carry[0], prov_active = carry[1], prov_n = carry[2];
  int work = 0, any_code = 0;
  for (int t = tid; t < T; t += THREADS) {
    bool e = task_state[t] == 0 && task_mask[t] && elig[t];
    if (kind == 1) {
      int j = task_job[t];
      int jc = j < 0 ? 0 : (j > J - 1 ? J - 1 : j);
      e = e && starving[jc] && j >= 0 && !tried[t];
    }
    work |= e;
    if (gated) any_code |= code[t] > 0;
  }
  work = __syncthreads_or(work);
  any_code = __syncthreads_or(any_code);
  const bool has_work = kind == 0 ? (work && (!gated || any_code))
                                  : (work || prov_active);
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
  if (tid == 0) {
    if (done) phase[0] += 1;
    flags[0] = done;
    flags[1] = has_work;
    flags[2] = phase[0];
  }
}

}  // namespace

// kind 0 = auction tier, 1 = evict tier; carry = [progressed,
// plan open, plan node] of the last step; starving may be null for an
// auction tier.  flags out: [done, has_work, phase after].
extern "C" int kb_joint_tier(
    int kind, int gated, int step, int max_steps, int T, int N, int R, int J,
    const int32_t* carry, int32_t* task_state, const int32_t* snap_state,
    const uint8_t* task_mask, const uint8_t* elig, const uint8_t* starving,
    const int32_t* task_job, uint8_t* tried, uint8_t* prov, int32_t* code,
    const float* task_req, float* node_future, uint8_t* excl, int32_t* phase,
    int32_t* flags, cudaStream_t stream) {
  if (R > MAX_R || (kind == 1 && (starving == nullptr || J <= 0)))
    return (int)cudaErrorInvalidValue;
  joint_tier_kernel<<<1, THREADS, 0, stream>>>(
      kind, gated, step, max_steps, T, N, R, J, carry, task_state, snap_state, task_mask,
      elig, starving, task_job, tried, prov, code, task_req, node_future, excl, phase,
      flags);
  return (int)cudaGetLastError();
}
