// Masked gather-mean for Hopper (sm_90a), slot-parallel.
//
// Replaces graphsage_tpu/ops/pallas_onehot.py:_kernel, reached through
// _onehot_gather_mean_impl / onehot_gather_mean and the "auto" and
// "onehot_pallas" routes of graphsage_tpu/ops/aggregate.py:gather_mean.
//
//   out[b, :] = sum_j mask[b, j] * X[idx[b, j], :] / max(sum_j mask[b, j], 1)
//
// X is f32 or bf16 [N, F]; idx int32 [B, k]; mask bool [B, k]; out f32 [B, F],
// accumulated in f32. Rows with no valid slot are 0 (quirks Q4, Q8).
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
// the slot's row (16 bytes per lane: float4, eight bf16, or four bf16 when
// the width is a multiple of 4 but not 8; single elements when F is not a
// multiple of 4, as at F=1433), writes the rows that the slot has passed
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

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void add(const Raw& r, float* acc) {
    acc[0] += r.x;
    acc[1] += r.y;
    acc[2] += r.z;
    acc[3] += r.w;
  }
};

template <>
struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return *p; }
  static __device__ __forceinline__ void add(const Raw& r, float* acc) {
    acc[0] += r;
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void add(const Raw& r, float* acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ void add(const Raw& r, float* acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return *p; }
  static __device__ __forceinline__ void add(const Raw& r, float* acc) {
    acc[0] += __bfloat162float(r);
  }
};

// out[col .. col+VEC) of one row: 16-byte stores where the width allows
// (F % VEC == 0 and out is 16-byte aligned, so col * 4 bytes is too).
template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

// kOneRow: rows_per_warp == 1, so no row ends inside the slot loop.
template <typename T, int VEC, bool kOneRow>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gather_mean_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   int B, int k, int F, int rows_per_warp) {
  using V = Vec<T, VEC>;
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

  // Flat slots s0 .. s0+31: lane s's id (valid slots only) and the ballot.
  int my_row = 0;
  unsigned valid_bits = 0;
  auto load_group = [&](int s0) {
    const int s = s0 + lane;
    const bool valid = s < slots && w_mask[s] != 0;
    my_row = valid ? w_idx[s] : 0;
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
        const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          v[i] = acc[i] / denom;
          acc[i] = 0.f;
        }
        store<VEC>(out + static_cast<size_t>(b0 + cur) * F + col, v);
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
        typename V::Raw v;
        if (active) v = V::load(x + static_cast<size_t>(r) * F + col);
        // Write the rows this slot has passed while the load is in flight.
        if constexpr (!kOneRow) {
          while (cur < (s0 + j) / k) flush();
        }
        if (active) V::add(v, acc);
        ++cnt;
      }
    }
    while (cur < rows) flush();
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* idx, const void* mask, void* out, int B,
           int k, int F, void* stream) {
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
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), B, k, F,
      rows_per_warp);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// The widest vector load that every row start permits: a row starts at
// x + r*F elements, so the width must divide F and the base address.
extern "C" int gsage_gather_mean_f32(const void* x, const void* idx,
                                     const void* mask, void* out, int B, int k,
                                     int F, void* stream) {
  if (F % 4 == 0 && aligned(x, 16))
    return launch<float, 4>(x, idx, mask, out, B, k, F, stream);
  return launch<float, 1>(x, idx, mask, out, B, k, F, stream);
}

extern "C" int gsage_gather_mean_bf16(const void* x, const void* idx,
                                      const void* mask, void* out, int B, int k,
                                      int F, void* stream) {
  if (F % 8 == 0 && aligned(x, 16))
    return launch<__nv_bfloat16, 8>(x, idx, mask, out, B, k, F, stream);
  if (F % 4 == 0 && aligned(x, 8))
    return launch<__nv_bfloat16, 4>(x, idx, mask, out, B, k, F, stream);
  return launch<__nv_bfloat16, 1>(x, idx, mask, out, B, k, F, stream);
}
