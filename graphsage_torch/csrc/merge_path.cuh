// The merge-path walk over a CSR and the L2 hints of its column panels:
// shared by spmm_mean.cu (kernel 3, the CSR mean) and segment_max.cu (the
// CSR max).
//
// Both kernels cut the N + E merge items (row ends and edges, in CSR order)
// into equal chunks, one warp each, and find where a chunk starts with
// merge_search. A table larger than L2 is walked once per column panel
// (ops/spmm.py:panels): the panel's rows are loaded with an L2 evict-last
// policy (load_kept), and what streams past them (the indptr and edge-id
// windows, outputs, carries) is read and written evict-first.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "rows.cuh"

namespace merge_path {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLine = 128;  // bytes of an L2 line: a panel is a whole number of them a row

// An L2 policy that keeps the lines it loads ahead of others (the panel's
// rows, against the streams of a pass).
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, %1;" : "=l"(policy) : "f"(1.0f));
  return policy;
}

// 16 bytes of a panel's row under `policy`, not kept in L1 (rows are rarely
// read twice by one SM).
__device__ __forceinline__ uint4 load_kept(const void* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// VEC f32 values rounded to T and written in 16-byte pieces, evict-first.
template <typename T, int VEC>
__device__ __forceinline__ void store_streaming(T* p, const float* v) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static_assert(VEC % kPer == 0);
#pragma unroll
  for (int i = 0; i < VEC / kPer; ++i) {
    alignas(16) T e[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = rows::from_f32<T>(v[i * kPer + j]);
    __stcs(reinterpret_cast<uint4*>(p) + i, *reinterpret_cast<const uint4*>(e));
  }
}

// The first x in [lo, hi) with ptr[x+1-base] > d - x - 1, else hi: the row
// coordinate where diagonal d of the merge path crosses indptr (ptr holds
// indptr from row `base` on). The predicate is monotone in x, so each round
// the block's threads (or one warp's lanes) probe evenly spaced points and
// the count of probes below the path narrows the range.
template <int kProbes>
__device__ __forceinline__ int merge_search(const int32_t* ptr, int base, int d,
                                            int lo, int hi, int* s_count) {
  const int t = kProbes == kWarp ? threadIdx.x % kWarp : threadIdx.x;
  while (lo < hi) {  // uniform: every probe sees the same lo and hi
    const int step = (hi - lo + kProbes - 1) / kProbes;
    const int p = lo + t * step;
    const bool below = p < hi && ptr[p + 1 - base] <= d - p - 1;
    int m = __popc(__ballot_sync(kFull, below));
    if constexpr (kProbes > kWarp) {  // sum the warps' counts
      if (t % kWarp == 0) s_count[t / kWarp] = m;
      __syncthreads();
      m = 0;
#pragma unroll
      for (int w = 0; w < kProbes / kWarp; ++w) m += s_count[w];
      __syncthreads();
    }
    if (m == 0) return lo;
    const int last = lo + (m - 1) * step;  // the last probe below the path
    lo = last + 1;
    hi = min(last + step, hi);
  }
  return lo;
}

}  // namespace merge_path
