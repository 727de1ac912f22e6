// Masked gather-mean with asynchronous row copies for Hopper (sm_90a).
//
// Replaces graphsage_tpu/ops/pallas_gather.py:_gather_mean_kernel, reached
// through _gather_mean_impl / gather_mean and the "dma" route of
// graphsage_tpu/ops/aggregate.py:gather_mean.
//
//   out[b, :] = sum_j mask[b, j] * X[idx[b, j], :] / max(sum_j mask[b, j], 1)
//
// X f32 [N, F]; idx int32 [B, k]; mask bool [B, k]; out f32 [B, F]. Rows with
// no valid slot are 0. The same function as gather_mean.cu; its backward is
// scatter_mean.cu.
//
// What bounds it on the H100: bytes, as for gather_mean.cu: one add per 4
// bytes read, so the least time is the distinct rows read plus idx, mask and
// out over the memory rate.
//
// Design, carried over from the TPU kernel: each neighbour row is streamed
// from device memory into on-chip memory by an asynchronous copy, two stages
// deep, and the mean is accumulated there. One warp per output row owns a
// ring of two row slots and an F-wide accumulator in shared memory. While
// the warp adds the row in one slot into the accumulator, the copy of the
// next valid slot's row into the other slot is in flight (cp.async, one
// commit group per row, cp.async.wait_group 1 before each add). Unlike the
// TPU kernel, which copies the aligned 8-row window around each row, a copy
// moves exactly one row: 16-byte pieces (cp.async.cg) when F is a multiple
// of 4 and the table is 16-byte aligned, 4-byte pieces (cp.async.ca)
// otherwise, as at F=1433 and F=500 mean-first; the table is never padded or
// copied. Each lane copies, adds and stores only its own columns, so a lane
// waits only on its own copies. The valid slots are listed by ballots over
// 32 slots at a time and their ids broadcast by shuffles, so a masked slot is
// never read, whatever id it holds; every loop bound is uniform across the
// warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxSharedBytes = 227 * 1024;  // per block on sm_90
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one commit group of this thread is still in flight.
__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Walks the valid slots of one row: next() gives the row id of the next
// valid slot (the same value in every lane), or -1 after the last.
struct ValidSlots {
  const int32_t* idx;
  const uint8_t* mask;
  int k, lane;
  int s0 = -kWarp;
  unsigned todo = 0;
  int my_row = 0;

  __device__ ValidSlots(const int32_t* i, const uint8_t* m, int k_, int l)
      : idx(i), mask(m), k(k_), lane(l) {}

  __device__ __forceinline__ int next() {
    while (todo == 0) {  // todo is uniform across the warp
      s0 += kWarp;
      if (s0 >= k) return -1;
      const int s = s0 + lane;
      const bool valid = s < k && mask[s] != 0;
      my_row = valid ? idx[s] : 0;
      todo = __ballot_sync(kFull, valid);
    }
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    return __shfl_sync(kFull, my_row, j);
  }
};

template <int VEC>
__device__ __forceinline__ void copy_row(float* slot, const float* x, int r, int F,
                                         int lane) {
  const float* src = x + static_cast<size_t>(r) * F;
  for (int c = lane * VEC; c < F; c += kWarp * VEC) copy_async<VEC>(slot + c, src + c);
}

template <int VEC>
__global__ void gather_mean_dma_kernel(const float* __restrict__ x,
                                       const int32_t* __restrict__ idx,
                                       const uint8_t* __restrict__ mask,
                                       float* __restrict__ out, int B, int k, int F) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (b >= B) return;  // uniform across the warp
  float* ring = smem + static_cast<size_t>(warp) * 3 * F;  // two row slots
  float* acc = ring + 2 * F;
  const int32_t* row_idx = idx + b * k;
  const uint8_t* row_mask = mask + b * k;

  int cnt = 0;
  for (int s0 = 0; s0 < k; s0 += kWarp) {
    const int s = s0 + lane;
    cnt += __popc(__ballot_sync(kFull, s < k && row_mask[s] != 0));
  }
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  for (int c = lane * VEC; c < F; c += kWarp * VEC)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[c + i] = 0.f;

  ValidSlots slots(row_idx, row_mask, k, lane);
  int cur = slots.next();
  if (cur >= 0) copy_row<VEC>(ring, x, cur, F, lane);
  commit_group();
  int stage = 0;
  while (cur >= 0) {
    const int nxt = slots.next();
    if (nxt >= 0) copy_row<VEC>(ring + (stage ^ 1) * F, x, nxt, F, lane);
    commit_group();  // possibly empty, so that one group is always pending
    wait_all_but_one();  // the row in `stage` has landed
    const float* row = ring + stage * F;
    for (int c = lane * VEC; c < F; c += kWarp * VEC)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[c + i] += row[c + i];
    __syncwarp();
    stage ^= 1;
    cur = nxt;
  }
  float* o = out + static_cast<size_t>(b) * F;
  for (int c = lane * VEC; c < F; c += kWarp * VEC)
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[c + i] = acc[c + i] / denom;
}

template <int VEC>
int launch(const void* x, const void* idx, const void* mask, void* out, int B,
           int k, int F, void* stream) {
  const size_t per_warp = static_cast<size_t>(3) * F * sizeof(float);
  int warps = static_cast<int>(kMaxSharedBytes / per_warp);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);  // F too wide
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  const size_t bytes = per_warp * warps;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_mean_dma_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + warps - 1) / warps;
  gather_mean_dma_kernel<VEC>
      <<<blocks, warps * kWarp, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const int32_t*>(idx),
          static_cast<const uint8_t*>(mask), static_cast<float*>(out), B, k, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 16-byte copies need every row start 16-byte aligned: F % 4 == 0 and an
// aligned table. Shared-memory slots are then 16-byte aligned as well.
extern "C" int gsage_gather_mean_dma_f32(const void* x, const void* idx,
                                         const void* mask, void* out, int B, int k,
                                         int F, void* stream) {
  if (F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<4>(x, idx, mask, out, B, k, F, stream);
  return launch<1>(x, idx, mask, out, B, k, F, stream);
}
