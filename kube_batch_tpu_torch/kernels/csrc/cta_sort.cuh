// One-block stable radix sort of up to CTA_MAX_T rows in shared memory,
// shared by K8 (csrc/lex_rank.cu: cta_lex_kernel, cta_seg_kernel,
// cta_vtime_kernel) and K5 (csrc/victim_prefix.cu: its radix route).
// kernels/build.py hashes this header with every source that includes it.
//
// 1,024 threads keep the u32 codes and the u16 row ids of every row in
// dynamic shared memory, double-buffered (cta_rows: 16,384 x 12 B = 192 KB,
// under the 227 KB opt-in).  A pass (cta_pass): warp w owns a run of
// consecutive rows and counts its digits (rows of one digit find each
// other with __match_any_sync; warp-private u16 counters, no atomics);
// four threads a digit turn the 32 warps' counts of the digit into warp
// offsets and a total, and a scan of the totals gives each digit's start;
// each warp walks its rows again in index order and scatters them.  A
// row's place among rows of its digit follows its index: the sort is
// stable.  A pass whose rows all share one digit would move nothing: the
// AND and OR of the codes (cta_varying_bits) find it, and it is skipped.
//
// Every definition sits in an anonymous namespace: each source that
// includes the header gets its own copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// one-block sorts
constexpr int CTA_THREADS = 1024;
constexpr int CTA_WARPS = CTA_THREADS / 32;
constexpr int CTA_MAX_T = 16384;
constexpr int CTA_RADIX = 256;
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

size_t cta_smem_bytes(int64_t T) { return (size_t)T * 12; }

template <typename F>
int cta_smem_optin(F* kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)cta_smem_bytes(CTA_MAX_T));
}

}  // namespace
