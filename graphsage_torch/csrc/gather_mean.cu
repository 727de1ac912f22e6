// Masked gather-mean for Hopper (sm_90a), slot-parallel.
//
// Replaces graphsage_tpu/ops/pallas_onehot.py:_kernel, reached through
// _onehot_gather_mean_impl / onehot_gather_mean and the "auto" and
// "onehot_pallas" routes of graphsage_tpu/ops/aggregate.py:gather_mean.
//
//   out[b, :] = sum_j mask[b, j] * X[idx[b, j], :] / max(sum_j mask[b, j], 1)
//
// or, with normalize = 0 (the sum mode), the same sums undivided: the owner
// side of the node-sharded feature store's exchange
// (graphsage_torch/parallel/feature_store.py), whose requester divides by
// its full valid count after the cross-rank reduction.
//
// X is f32 or bf16 [N, F]; idx int32 [B, k]; mask bool [B, k]; out f32 [B, F],
// accumulated in f32. Rows with no valid slot are 0 (quirks Q4, Q8). An int8
// table (graphsage_tpu/ops/quantize.py:gather_mean_dequant, which JAX leaves
// to XLA) is the same sum with each slot weighted by its row's scale,
//   out[b, :] = sum_j mask[b, j] * scale[idx[b, j]] * Q[idx[b, j], :] / max(sum_j mask[b, j], 1),
// forward only: an int8 table (the frozen features or the layer-0 cache)
// has no gradient.
//
// What bounds it on the H100: bytes. Each valid slot reads one F-wide row
// and does one add per element read (a quarter or half an operation per
// byte), far below the ridge point, so the least time is the bytes of the
// distinct rows read plus the mask, the valid slots' ids and out over the
// memory rate; at the Pubmed frontier the output (13.1 MB) is most of it.
// The TPU kernel traded the gather for an O(B*N*F) one-hot product on the
// MXU; on Hopper that product is wasted work, so rows are gathered directly.
//
// What held the earlier design back: one output row per warp, the mask read
// twice (a ballot pass for the count, again in the column loop), and the
// valid slots walked one at a time, so one row load was in flight per warp
// and every warp, most of them for rows with no valid slot, paid the whole
// chain of dependent loads (3.3x the bound at the Pubmed frontier).
//
// Design: one warp serves R consecutive output rows: R = 32 / k when the
// batch has enough rows to give the card about 8192 warps that way (B =
// 25600, k = 10: R = 3), fewer otherwise (B = 2560: R = 1), and 1 when
// k > 32, with the slots taken 32 at a time. Lane s reads flat slot s of
// those rows, row-major: its mask byte, and its id only when the slot is
// valid, so a masked slot is never read and its id may be anything. One
// ballot gives the valid slots of all R rows, and the mask is not read again.
// The warp walks the valid slots in order: each lane issues its piece of
// the slot's row (up to 16 bytes per lane: four f32, eight bf16 or sixteen
// int8; narrower when the width is not a multiple of those counts, as bf16
// at Reddit's F=602 takes pairs, or when a row would leave lanes idle, as
// int8 at F=256 and bf16 at F=128 take 8 bytes; single elements only when
// F is odd, as at F=1433; rows.cuh converts), writes the rows that the slot has passed
// while the load is in flight (scaled; rows with no valid slot as 0), then
// adds it. With one row per warp no row ends inside the slot loop, and a
// separate instance without that step lets the compiler overlap the loads
// of successive slots (the general loop was slower at F=1433). The
// kernel is bound by latency, not by bandwidth: blocks of 4 warps and few
// registers keep more warps resident on each SM, which hid more of it than
// batching the loads of 2 slots into separate registers did (slower on
// every graph and width timed). Fixed summation order: bitwise repeatable.
// Every loop bound is uniform across the warp, so shuffles and ballots see
// all 32 lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rows.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// kOneRow: rows_per_warp == 1, so no row ends inside the slot loop. An int8
// table (T = int8_t) weighs each slot's row by scale[id].
template <typename T, int VEC, bool kOneRow>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gather_mean_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const int32_t* __restrict__ idx, const uint8_t* __restrict__ mask,
                   float* __restrict__ out, int B, int k, int F, int rows_per_warp,
                   int normalize) {
  using V = rows::Vec<T, VEC>;
  constexpr bool kScaled = std::is_same_v<T, int8_t>;
  const int lane = threadIdx.x % kWarp;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp) *
      rows_per_warp;
  if (b0 >= B) return;  // uniform across the warp
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_warp), B - b0));
  const int slots = rows * k;  // this warp's flat slots, row-major
  const int32_t* w_idx = idx + b0 * k;
  const uint8_t* w_mask = mask + b0 * k;
  const bool one_group = slots <= kWarp;

  // Flat slots s0 .. s0+31: lane s's id and scale (valid slots only) and
  // the ballot.
  int my_row = 0;
  float my_scale = 0.f;
  unsigned valid_bits = 0;
  auto load_group = [&](int s0) {
    const int s = s0 + lane;
    const bool valid = s < slots && w_mask[s] != 0;
    my_row = valid ? w_idx[s] : 0;
    if constexpr (kScaled) my_scale = valid ? scale[my_row] : 0.f;
    valid_bits = __ballot_sync(kFull, valid);
  };
  if (one_group) load_group(0);

  for (int c0 = 0; c0 < F; c0 += kWarp * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < F;  // F % VEC == 0, so the whole vector fits
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    int cur = 0, cnt = 0;  // the row being summed and its valid slots so far

    // Write row cur (all its slots are summed) and move to the next.
    auto flush = [&]() {
      if (active) {
        const float denom = normalize ? static_cast<float>(cnt > 1 ? cnt : 1) : 1.f;
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          v[i] = acc[i] / denom;
          acc[i] = 0.f;
        }
        rows::store<float, VEC>(out + static_cast<size_t>(b0 + cur) * F + col, v);
      }
      ++cur;
      cnt = 0;
    };

    for (int s0 = 0; s0 < slots; s0 += kWarp) {
      if (!one_group) load_group(s0);
      unsigned todo = valid_bits;
      while (todo) {  // uniform: valid_bits came from a ballot
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int r = __shfl_sync(kFull, my_row, j);
        float w = 1.f;
        if constexpr (kScaled) w = __shfl_sync(kFull, my_scale, j);
        typename V::Raw v;
        if (active) v = V::load(x + static_cast<size_t>(r) * F + col);
        // Write the rows this slot has passed while the load is in flight.
        if constexpr (!kOneRow) {
          while (cur < (s0 + j) / k) flush();
        }
        if (active) {
          if constexpr (kScaled) V::add(v, w, acc);
          else V::add(v, acc);
        }
        ++cnt;
      }
    }
    while (cur < rows) flush();
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* scale, const void* idx, const void* mask,
           void* out, int B, int k, int F, int normalize, void* stream) {
  // Enough warps to fill the card first (about 8192), then up to 32 / k
  // rows per warp.
  const int rows_per_warp =
      k > kWarp ? 1 : max(1, min(kWarp / (k > 1 ? k : 1), B / 8192));
  const long long warps = (static_cast<long long>(B) + rows_per_warp - 1) / rows_per_warp;
  const int threads = kWarp * kWarpsPerBlock;
  const int blocks = static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto kernel = rows_per_warp == 1 ? gather_mean_kernel<T, VEC, true>
                                         : gather_mean_kernel<T, VEC, false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), B, k, F, rows_per_warp, normalize);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The vector width: the widest load (16 bytes at most) that every row start
// permits, so it divides F and the base address (a row starts at x + r*F
// elements), narrowed until F gives each of the 32 lanes a piece of the row
// where F allows it. Int8 at F=256 thus takes 8-byte loads on all 32 lanes,
// not 16-byte loads on 16 of them.
template <typename T>
int launch_widest(const void* x, const void* scale, const void* idx,
                  const void* mask, void* out, int B, int k, int F, int normalize,
                  void* stream) {
  constexpr int kMax = 16 / static_cast<int>(sizeof(T));
  int vec = 0;
  for (int v = kMax; v >= 1; v /= 2) {
    if (F % v != 0 || !aligned(x, v * sizeof(T))) continue;
    vec = v;
    if (F >= kWarp * v) break;
  }
  switch (vec) {
    case 16:
      if constexpr (kMax >= 16) return launch<T, 16>(x, scale, idx, mask, out, B, k, F, normalize, stream);
      break;
    case 8:
      if constexpr (kMax >= 8) return launch<T, 8>(x, scale, idx, mask, out, B, k, F, normalize, stream);
      break;
    case 4:
      return launch<T, 4>(x, scale, idx, mask, out, B, k, F, normalize, stream);
    case 2:
      return launch<T, 2>(x, scale, idx, mask, out, B, k, F, normalize, stream);
  }
  return launch<T, 1>(x, scale, idx, mask, out, B, k, F, normalize, stream);
}

}  // namespace

// scale: nullptr for the f32 and bf16 tables; an int8 table's per-row
// scales (gather_mean_dequant: row id's elements times scale[id]).
// normalize: 1 for the mean, 0 for the sum mode.
extern "C" int gsage_gather_mean_f32(const void* x, const void* scale, const void* idx,
                                     const void* mask, void* out, int B, int k, int F,
                                     int normalize, void* stream) {
  return launch_widest<float>(x, scale, idx, mask, out, B, k, F, normalize, stream);
}

extern "C" int gsage_gather_mean_bf16(const void* x, const void* scale, const void* idx,
                                      const void* mask, void* out, int B, int k, int F,
                                      int normalize, void* stream) {
  return launch_widest<__nv_bfloat16>(x, scale, idx, mask, out, B, k, F, normalize, stream);
}

extern "C" int gsage_gather_mean_int8(const void* q, const void* scale, const void* idx,
                                      const void* mask, void* out, int B, int k, int F,
                                      int normalize, void* stream) {
  return launch_widest<int8_t>(q, scale, idx, mask, out, B, k, F, normalize, stream);
}
