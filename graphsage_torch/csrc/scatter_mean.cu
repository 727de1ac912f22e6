// Masked scatter-mean (the gather-mean backward) for Hopper (sm_90a).
//
// Replaces graphsage_tpu/ops/pallas_onehot.py:_scatter_kernel, reached through
// _onehot_scatter_mean_grad from the backward of
// graphsage_tpu/ops/aggregate.py:gather_mean (_gather_mean_bwd).
//
//   dX[idx[b, j], :] += g[b, :] / max(sum_j mask[b, j], 1)   for each valid (b, j)
//
// g f32 [B, F]; idx int32 [B, k]; mask bool [B, k]; dX f32 [N, F], zeroed by
// the caller. Repeated ids sum. Ids in masked slots are never read.
//
// What bounds it on the H100: bytes. Each valid slot adds one F-wide row of
// g into dX (one add per 4 bytes moved), far below the ridge point; the
// least time is g, idx and mask read once and dX written once over the
// memory rate. The read-modify-writes of the atomics resolve in L2, which
// holds dX whole at the training shapes (10 MB at Pubmed, F=128). The TPU
// kernel built transposed one-hot tiles and ran the scatter as an O(N*B*F)
// product on the MXU; on Hopper that is wasted work, so this kernel adds
// each row where it belongs: O(B*k*F) work.
//
// Design: one warp per gradient row b. Lane s holds slot s's mask and id
// (slots beyond 32 are taken 32 at a time); a ballot gives the valid slots
// and their count. For each column chunk every lane loads its 16-byte piece
// of g[b] once, divides it by the count, and adds it into dX[idx[b, j]] for
// each valid slot j (the id broadcast by a shuffle) with one float4
// atomicAdd (sm_90), or scalar atomics when F is not a multiple of 4 or a
// pointer is not 16-byte aligned. The atomics make the order of the sums
// change from run to run. Every loop bound is uniform across the warp, so
// the shuffles and ballots always see all 32 lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void add(float* p, const float* v) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_mean_kernel(const float* __restrict__ g, const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask, float* __restrict__ dx,
                    int B, int k, int F) {
  const int lane = threadIdx.x % kWarp;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (b >= B) return;  // uniform across the warp
  const int32_t* row_idx = idx + b * k;
  const uint8_t* row_mask = mask + b * k;

  int cnt = 0;
  for (int s0 = 0; s0 < k; s0 += kWarp) {
    const int s = s0 + lane;
    cnt += __popc(__ballot_sync(kFull, s < k && row_mask[s] != 0));
  }
  if (cnt == 0) return;  // uniform: nothing to add
  const float denom = static_cast<float>(cnt);

  for (int c0 = 0; c0 < F; c0 += kWarp * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < F;  // F % VEC == 0, so the whole vector fits
    float v[VEC];
    if (active) {
      load<VEC>(g + static_cast<size_t>(b) * F + col, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] /= denom;
    }
    for (int s0 = 0; s0 < k; s0 += kWarp) {
      const int s = s0 + lane;
      const bool valid = s < k && row_mask[s] != 0;
      const int my_row = valid ? row_idx[s] : 0;
      unsigned todo = __ballot_sync(kFull, valid);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int r = __shfl_sync(kFull, my_row, j);
        if (active) add<VEC>(dx + static_cast<size_t>(r) * F + col, v);
      }
    }
  }
}

template <int VEC>
int launch(const void* g, const void* idx, const void* mask, void* dx, int B,
           int k, int F, void* stream) {
  const int threads = kWarp * kWarpsPerBlock;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  scatter_mean_kernel<VEC><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<float*>(dx), B, k, F);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// 16-byte pieces where F and both row bases allow them, else single floats.
extern "C" int gsage_scatter_mean_f32(const void* g, const void* idx,
                                      const void* mask, void* dx, int B, int k,
                                      int F, void* stream) {
  if (F % 4 == 0 && aligned(g, 16) && aligned(dx, 16))
    return launch<4>(g, idx, mask, dx, B, k, F, stream);
  return launch<1>(g, idx, mask, dx, B, k, F, stream);
}
