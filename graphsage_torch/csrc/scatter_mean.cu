// Masked scatter-mean (the gather-mean backward) for Hopper (sm_90a).
//
// Replaces graphsage_tpu/ops/pallas_onehot.py:_scatter_kernel, reached through
// _onehot_scatter_mean_grad from the backward of
// graphsage_tpu/ops/aggregate.py:gather_mean (_gather_mean_bwd).
//
//   dX[idx[b, j], :] += g[b, :] / max(sum_j mask[b, j], 1)   for each valid (b, j)
//
// or, with normalize = 0 (the sum mode), g taken as already divided and
// added once for each valid slot (unit weights): the owner side of the
// node-sharded feature store's backward
// (graphsage_torch/parallel/feature_store.py), where the requester divided by
// its own valid count before the cotangent rows were gathered.
//
// g f32 [B, F]; idx int32 [B, k]; mask bool [B, k]; dX f32 [N, F], written
// whole by the entry point (zeros first, then the sums), so the caller
// allocates it uninitialised. Repeated ids sum. Ids in masked slots are never
// read.
//
// What bounds it on the H100: bytes. Each valid slot adds one F-wide row of
// g into dX (one add per 4 bytes moved), far below the ridge point; the
// least time is the live rows of g, the mask, the valid slots' ids and dX
// written once over the memory rate, and dX's zeros are most of it (10.1 MB
// of 12.8 at the Pubmed frontier). The read-modify-writes of the atomics
// resolve in L2, which holds dX whole at the training shapes. The TPU kernel
// built transposed one-hot tiles and ran the scatter as an O(N*B*F) product
// on the MXU; on Hopper that is wasted work, so this kernel adds each row
// where it belongs: O(B*k*F) work. In practice it is bound by the latency of
// each warp's dependent loads (mask, then g and ids), not by bandwidth: the
// fill takes 3.4 of the 10.3 us at the Pubmed frontier, and the atomics
// themselves under 2.
//
// Design: one warp per gradient row, which measured fastest on the H100.
// Lane s reads slot s's mask byte once, and its id only when the slot is
// valid; one ballot gives the valid slots and their count (rows of more than
// 32 slots: a counting pass, then ids 32 at a time). For each column chunk
// every lane loads its 16-byte piece of g[b] once, divides it by the count
// and adds it into the dX row of each valid slot (the id broadcast by a
// shuffle) with one vector atomic (a float4 atomicAdd, red.global.add.v4.f32
// on sm_90), or scalar atomics when F is not a multiple of 4 or g or dX is
// not 16-byte aligned. Serving up to 32 / k rows
// per warp from one ballot (the recommended redesign), a ring of g rows fed
// by TMA with up to 12 rows per warp, and batches of live rows found by a
// lane per row were all slower at every frontier: fewer, longer warps hide
// less of the load latency than 25600 short ones, most of which leave after
// one mask load.
//
// dX is written whole inside the one call of the entry point (so the caller
// allocates it uninitialised): a zeroing kernel (16-byte stores), then the
// scatter kernel. Against it on the H100, cudaMemsetAsync was slower, and so
// was one cooperative launch that zeroes, meets at a grid-wide barrier and
// scatters (PERF.md); neither is kept.
// The atomics make the order of the sums change from run to run. Every loop
// bound is uniform across the warp, so shuffles and ballots see all 32 lanes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
    // Its result unused, sm_90 compiles this to one vector reduction.
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Gradient row b: its slots' mask bytes read once, by lane s for slot s
// (32 slots at a time), and ids only for valid slots; a ballot gives the
// valid slots and their count. For each column chunk every lane loads its
// 16-byte piece (or single float) of g[b] once, divides it by the count and
// adds it into the dX row of each valid slot (the id broadcast by a
// shuffle). More than 32 slots take a counting pass first, and their ids are
// read 32 at a time for each chunk.
template <int VEC>
__device__ __forceinline__ void scatter_row(const float* __restrict__ g,
                                            const int32_t* __restrict__ idx,
                                            const uint8_t* __restrict__ mask,
                                            float* __restrict__ dx, long long b, int k, int F,
                                            int normalize, int lane) {
  const int32_t* r_idx = idx + b * k;
  const uint8_t* r_mask = mask + b * k;
  const bool short_row = k <= kWarp;  // uniform: one ballot holds every slot
  int my_id = 0;
  unsigned bits = 0;
  int cnt = 0;
  if (short_row) {
    const bool valid = lane < k && r_mask[lane] != 0;
    my_id = valid ? r_idx[lane] : 0;
    bits = __ballot_sync(kFull, valid);
    cnt = __popc(bits);
  } else {
    for (int s0 = 0; s0 < k; s0 += kWarp) {
      const int s = s0 + lane;
      cnt += __popc(__ballot_sync(kFull, s < k && r_mask[s] != 0));
    }
  }
  if (cnt == 0) return;  // uniform: nothing to add
  const float denom = normalize ? static_cast<float>(cnt) : 1.f;
  for (int c0 = 0; c0 < F; c0 += kWarp * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < F;  // F % VEC == 0, so the whole vector fits
    float v[VEC];
    if (active) {
      load<VEC>(g + b * F + col, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] /= denom;
    }
    for (int s0 = 0; s0 < k; s0 += kWarp) {
      unsigned todo = bits;
      int id = my_id;
      if (!short_row) {
        const int s = s0 + lane;
        const bool valid = s < k && r_mask[s] != 0;
        id = valid ? r_idx[s] : 0;
        todo = __ballot_sync(kFull, valid);
      }
      while (todo) {  // uniform: from a ballot
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int to = __shfl_sync(kFull, id, j);
        if (active) add<VEC>(dx + static_cast<size_t>(to) * F + col, v);
      }
    }
  }
}

// dX's zeros: 16-byte stores, grid-stride, the last n % 4 floats singly.
__global__ void zero_kernel(float* __restrict__ p, size_t n) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n / 4;
       i += stride)
    p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (blockIdx.x == 0 && threadIdx.x < n % 4) p[n - 1 - threadIdx.x] = 0.f;
}

// One warp per gradient row.
template <int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_mean_kernel(const float* __restrict__ g, const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask, float* __restrict__ dx, int B, int k,
                    int F, int normalize) {
  const long long b = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (b < B) scatter_row<VEC>(g, idx, mask, dx, b, k, F, normalize, threadIdx.x % kWarp);
}

// dX must be 16-byte aligned (the wrapper allocates it).
template <int VEC>
int launch(const void* g, const void* idx, const void* mask, void* dx, int N, int B, int k,
           int F, int normalize, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(N) * F;
  // About four 16-byte stores per thread.
  zero_kernel<<<static_cast<int>(std::max<size_t>(1, (n / 4 + 1023) / 1024)), 256, 0,
                stream>>>(static_cast<float*>(dx), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_mean_kernel<VEC><<<(B + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarp * kWarpsPerBlock,
                             0, stream>>>(static_cast<const float*>(g),
                                          static_cast<const int32_t*>(idx),
                                          static_cast<const uint8_t*>(mask),
                                          static_cast<float*>(dx), B, k, F, normalize);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// 16-byte pieces where F and both row bases allow them, else single floats.
// normalize: 1 for the mean's backward, 0 for the sum mode.
extern "C" int gsage_scatter_mean_f32(const void* g, const void* idx, const void* mask,
                                      void* dx, int N, int B, int k, int F, int normalize,
                                      void* stream) {
  if (!aligned(dx, 16)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 4 == 0 && aligned(g, 16))
    return launch<4>(g, idx, mask, dx, N, B, k, F, normalize, s);
  return launch<1>(g, idx, mask, dx, N, B, k, F, normalize, s);
}
