// Masked gather-mean by bulk row copies (TMA) for Hopper (sm_90a).
//
// Replaces graphsage_tpu/ops/pallas_gather.py:_gather_mean_kernel, reached
// through _gather_mean_impl / gather_mean and the "dma" route of
// graphsage_tpu/ops/aggregate.py:gather_mean.
//
//   out[b, :] = sum_j mask[b, j] * X[idx[b, j], :] / max(sum_j mask[b, j], 1)
//
// X f32 or bf16 [N, F]; idx int32 [B, k]; mask bool [B, k]; out f32 [B, F],
// summed in f32. Rows with no valid slot are 0. The same function as
// gather_mean.cu; its backward is scatter_mean.cu. (The TPU kernel cast X to
// f32 first; here bf16 rows land in the ring as they are, half the bytes.)
//
// What bounds it on the H100: bytes, as for gather_mean.cu: one add per 4
// bytes read, so the least time is the distinct rows read plus idx, mask and
// out over the memory rate.
//
// What held the earlier design back: one warp per output row (82% of the
// Pubmed frontier's rows have no valid slot, and each still zeroed and wrote
// a shared-memory accumulator), the sum kept in shared memory (a load and a
// store per add), one row in flight per warp, and Ampere's per-lane cp.async,
// as many instructions as plain loads.
//
// Design: the TPU kernel streamed each neighbour row into VMEM by DMA; here
// Hopper's DMA engine does it. One warp serves R consecutive output rows (R
// = 32 / k once the batch is large, fewer for small batches, 1 when k > 32;
// the wrapper decides, as it does S below). Lane s reads flat slot s of those
// rows, row-major: its mask byte, and its id only when the slot is valid, so
// a masked slot is never read and its id may be anything. One ballot gives
// the valid slots; the mask is not read again. Each warp owns a ring of S
// stages in shared memory, each with an mbarrier. Lane 0 starts one bulk copy
// (cp.async.bulk ... mbarrier::complete_tx::bytes, armed by
// mbarrier.arrive.expect_tx) per valid slot's row, S ahead of the warp's sum;
// the warp waits on the stage's barrier parity (mbarrier.try_wait.parity),
// every lane adds its columns of the landed row into registers, and once all
// lanes have read the stage lane 0 reuses it for the next copy. A row is
// written, scaled, when the walk passes its last slot, and a row with no
// valid slot is written as zeros; a warp none of whose rows has a valid slot
// writes its zeros and leaves before it sets up a ring (at the Pubmed
// frontier, over half of the warps). Slots are added in order: bitwise
// repeatable. S is about 2 KB of stages per warp (f32: 4 at F=128, 2 at
// F=500 and 1433; bf16: 8 at F=128, 2 at F=602): most warps hold few valid
// slots, and this ring was as fast as an 8 KB one or faster at every width
// timed (f32).
//
// Bound on the H100: by the latency of each warp's chain (mask, ids, then a
// bulk copy and its barrier), not by bandwidth. A bulk copy's round trip is
// slower than a plain load's where the rows sit in L2 (Cora's table: kernel
// 1 is faster there); with wide rows (F=500, 1433) one instruction moves
// 2-6 KB and the kernel is faster than kernel 1 and F.embedding_bag. More
// rows per warp (up to 128 / k, the ring running across their boundaries)
// and one row per warp were both slower at the Pubmed frontier.
//
// A bulk copy needs a 16-byte-aligned source, destination and size. When a
// row is a multiple of 16 bytes (F a multiple of 4 in f32, of 8 in bf16) and
// X is 16-byte aligned, a copy moves the row itself. Otherwise (F=1433 and
// F=45, bf16 at Reddit's F=602, or a view of X at an odd offset) it moves the
// 16-byte-aligned envelope of the row, and the lanes read from the row's
// offset in it, as the TPU kernel copied the aligned 8-row window around a
// row. The table is never padded or copied, so where an envelope would reach
// before X's first byte or past its last, that row is read by the lanes
// directly from device memory instead (its stage's barrier is completed by
// a plain arrive). Rows wider than the 2048 columns the registers hold (64
// f32 sums a lane, whatever the table's type: 8 KB of f32 or 4 KB of bf16
// per stage) are taken in slabs of 2048, each a pass over the slots. Every loop bound is
// uniform across the warp, so shuffles and ballots see all 32 lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxStages = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arm `bar` for `bytes` and start the bulk copy whose arrival completes them.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// What one copy moves for columns [c0, c0 + width) of row r: the segment
// itself (VEC == 4: row starts are 16-byte aligned) or its 16-byte-aligned
// envelope, the segment's offset in it (elements), and whether the envelope
// lies inside the table.
template <typename T>
struct Segment {
  const T* src;
  uint32_t bytes;
  int off;
  bool inside;
};

template <typename T, int VEC>
__device__ __forceinline__ Segment<T> segment(const T* x, size_t table_bytes, int r,
                                              int F, int c0, int width) {
  constexpr uintptr_t kSize = sizeof(T);
  const T* start = x + static_cast<size_t>(r) * F + c0;
  if constexpr (VEC == 4) {
    return {start, static_cast<uint32_t>(width * kSize), 0, true};
  } else {
    const uintptr_t base = reinterpret_cast<uintptr_t>(x);
    const uintptr_t s = reinterpret_cast<uintptr_t>(start);
    const uintptr_t lo = s & ~uintptr_t{15};
    const uintptr_t hi = (s + static_cast<uintptr_t>(width) * kSize + 15) & ~uintptr_t{15};
    return {reinterpret_cast<const T*>(lo), static_cast<uint32_t>(hi - lo),
            static_cast<int>((s - lo) / kSize), lo >= base && hi <= base + table_bytes};
  }
}

// Columns of a pass: lane l holds 4 * NC of them: VEC == 4: pieces of four
// elements q * 128 + 4 * l + i (16 bytes of f32, 8 of bf16); VEC == 1:
// q * 32 + l, so that scalar reads of a stage are free of bank conflicts and
// scalar stores coalesce.
template <typename T, int VEC, int NC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gather_mean_dma_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                       const uint8_t* __restrict__ mask, float* __restrict__ out,
                       size_t table_bytes, int B, int k, int F, int rows_per_warp,
                       int stages, int stage_bytes) {
  constexpr int kCols = 4 * NC;            // per lane per pass
  constexpr int kSlab = kWarp * kCols;     // per pass
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp) * rows_per_warp;
  if (b0 >= B) return;  // uniform across the warp
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_warp), B - b0));
  const int slots = rows * k;  // this warp's flat slots, row-major
  const int32_t* w_idx = idx + b0 * k;
  const uint8_t* w_mask = mask + b0 * k;
  const bool one_group = slots <= kWarp;

  // Flat slots s0 .. s0+31: lane s's id (valid slots only) and the ballot.
  int my_id = 0;
  unsigned valid_bits = 0;
  auto load_group = [&](int s0) {
    const int s = s0 + lane;
    const bool valid = s < slots && w_mask[s] != 0;
    my_id = valid ? w_idx[s] : 0;
    valid_bits = __ballot_sync(kFull, valid);
  };
  if (one_group) {
    load_group(0);
    if (valid_bits == 0) {  // uniform: the rows are zeros, and no ring is needed
      float* o = out + b0 * F;  // the warp's rows are contiguous
      const long long n = static_cast<long long>(rows) * F;
      if constexpr (VEC == 4) {
        for (long long i = lane; i < n / 4; i += kWarp)
          reinterpret_cast<float4*>(o)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (long long i = lane; i < n; i += kWarp) o[i] = 0.f;
      }
      return;
    }
  }

  const int bar_bytes = (kWarpsPerBlock * stages * 8 + 15) & ~15;
  const uint32_t bars = smem_addr(smem) + warp * stages * 8;
  unsigned char* ring = smem + bar_bytes + static_cast<size_t>(warp) * stages * stage_bytes;
  if (lane == 0)
    for (int s = 0; s < stages; ++s) bar_init(bars + 8 * s);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();

  unsigned issued = 0, consumed = 0;  // copies started and rows summed, uniform
  for (int c0 = 0; c0 < F; c0 += kSlab) {
    const int width = min(kSlab, F - c0);
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
    int cur = 0, cnt = 0;  // the row being summed and its valid slots so far

    // Write row cur (all its slots are summed) and move to the next.
    auto flush = [&]() {
      const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
      float* o = out + static_cast<size_t>(b0 + cur) * F + c0;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        if constexpr (VEC == 4) {
          const int col = q * kWarp * 4 + lane * 4;
          if (col < width)
            *reinterpret_cast<float4*>(o + col) =
                make_float4(acc[4 * q] / denom, acc[4 * q + 1] / denom,
                            acc[4 * q + 2] / denom, acc[4 * q + 3] / denom);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = (4 * q + i) * kWarp + lane;
            if (col < width) o[col] = acc[4 * q + i] / denom;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
      ++cur;
      cnt = 0;
    };

    for (int s0 = 0; s0 < slots; s0 += kWarp) {
      if (!one_group) load_group(s0);
      unsigned to_copy = valid_bits, todo = valid_bits;
      // Start the copy of the next valid slot's row into the next stage.
      auto issue = [&]() {
        const int j = __ffs(to_copy) - 1;
        to_copy &= to_copy - 1;
        const int r = __shfl_sync(kFull, my_id, j);
        if (lane == 0) {
          const int st = static_cast<int>(issued % stages);
          const uint32_t bar = bars + 8 * st;
          const Segment<T> seg = segment<T, VEC>(x, table_bytes, r, F, c0, width);
          if (seg.inside)
            bulk_copy(smem_addr(ring + static_cast<size_t>(st) * stage_bytes), seg.src,
                      seg.bytes, bar);
          else
            bar_arrive(bar);  // read directly below
        }
        ++issued;
      };
      for (int i = 0; i < stages && to_copy; ++i) issue();

      while (todo) {  // uniform: todo came from a ballot
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int r = __shfl_sync(kFull, my_id, j);
        while (cur < (s0 + j) / k) flush();  // rows this slot has passed
        const int st = static_cast<int>(consumed % stages);
        bar_wait(bars + 8 * st, (consumed / stages) & 1u);
        const Segment<T> seg = segment<T, VEC>(x, table_bytes, r, F, c0, width);
        const T* row =
            reinterpret_cast<const T*>(ring + static_cast<size_t>(st) * stage_bytes) + seg.off;
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          if constexpr (VEC == 4) {
            const int col = q * kWarp * 4 + lane * 4;
            if (col < width) rows::Vec<T, 4>::add(rows::Vec<T, 4>::load(row + col), acc + 4 * q);
          } else {
            const T* direct = x + static_cast<size_t>(r) * F + c0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = (4 * q + i) * kWarp + lane;
              if (col < width) acc[4 * q + i] += rows::to_f32(seg.inside ? row[col] : direct[col]);
            }
          }
        }
        ++consumed;
        ++cnt;
        __syncwarp();  // every lane has read the stage before it is reused
        if (to_copy) issue();
      }
    }
    while (cur < rows) flush();
  }
}

template <typename T, int VEC, int NC>
int launch(const void* x, const void* idx, const void* mask, void* out, size_t table_bytes,
           int B, int k, int F, int rows_per_warp, int stages, int stage_bytes,
           cudaStream_t stream) {
  const auto kernel = gather_mean_dma_kernel<T, VEC, NC>;
  const size_t bytes = static_cast<size_t>((kWarpsPerBlock * stages * 8 + 15) & ~15) +
                       static_cast<size_t>(kWarpsPerBlock) * stages * stage_bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long warps = (static_cast<long long>(B) + rows_per_warp - 1) / rows_per_warp;
  const int blocks = static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  kernel<<<blocks, kWarp * kWarpsPerBlock, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), table_bytes, B, k, F,
      rows_per_warp, stages, stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_chunks(const void* x, const void* idx, const void* mask, void* out,
                  size_t table_bytes, int B, int k, int F, int rows_per_warp, int chunks,
                  int stages, int stage_bytes, cudaStream_t stream) {
  switch (chunks) {
    case 1:
      return launch<T, VEC, 1>(x, idx, mask, out, table_bytes, B, k, F, rows_per_warp,
                               stages, stage_bytes, stream);
    case 4:
      return launch<T, VEC, 4>(x, idx, mask, out, table_bytes, B, k, F, rows_per_warp,
                               stages, stage_bytes, stream);
    case 16:
      return launch<T, VEC, 16>(x, idx, mask, out, table_bytes, B, k, F, rows_per_warp,
                                stages, stage_bytes, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch plan (rows_per_warp, chunks of 128 columns per pass, stages and
// the bytes of one stage) comes from the wrapper (ops/gather_dma.py:plan).
// Whole-row copies need every row start 16-byte aligned: rows of a multiple
// of 16 bytes and an aligned table; otherwise envelopes, which need 16 bytes
// more per stage.
template <typename T>
int launch_checked(const void* x, const void* idx, const void* mask, void* out, int N,
                   int B, int k, int F, int rows_per_warp, int chunks, int stages,
                   int stage_bytes, void* stream) {
  constexpr int kSize = sizeof(T);
  const bool whole = (F * kSize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int width = min(F, 128 * chunks);
  const int need = whole ? width * kSize : ((width * kSize + 15) & ~15) + 16;
  if (rows_per_warp < 1 || (rows_per_warp > 1 && rows_per_warp * k > kWarp) ||
      stages < 1 || stages > kMaxStages || stage_bytes % 16 != 0 || stage_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t table_bytes = static_cast<size_t>(N) * F * kSize;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whole)
    return launch_chunks<T, 4>(x, idx, mask, out, table_bytes, B, k, F, rows_per_warp,
                               chunks, stages, stage_bytes, s);
  return launch_chunks<T, 1>(x, idx, mask, out, table_bytes, B, k, F, rows_per_warp,
                             chunks, stages, stage_bytes, s);
}

}  // namespace

extern "C" int gsage_gather_mean_dma_f32(const void* x, const void* idx, const void* mask,
                                         void* out, int N, int B, int k, int F,
                                         int rows_per_warp, int chunks, int stages,
                                         int stage_bytes, void* stream) {
  return launch_checked<float>(x, idx, mask, out, N, B, k, F, rows_per_warp, chunks,
                               stages, stage_bytes, stream);
}

extern "C" int gsage_gather_mean_dma_bf16(const void* x, const void* idx, const void* mask,
                                          void* out, int N, int B, int k, int F,
                                          int rows_per_warp, int chunks, int stages,
                                          int stage_bytes, void* stream) {
  return launch_checked<__nv_bfloat16>(x, idx, mask, out, N, B, k, F, rows_per_warp,
                                       chunks, stages, stage_bytes, stream);
}
