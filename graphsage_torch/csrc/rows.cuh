// Row pieces of f32, bf16 or int8 tables, read into f32 sums and written
// back: shared by gather_mean.cu, spmm_mean.cu and gather_mean_dma.cu.
//
// Vec<T, VEC> moves VEC consecutive elements of T with the widest loads that
// their byte count allows (16 bytes at most per load, so 8 f32 take two),
// converts each element to f32 (exactly: bf16 and int8 values are f32
// values) and adds it to a sum, optionally times a weight (an int8 row's
// scale). store<T, VEC> rounds f32 values to T (round to nearest even, as
// PyTorch's .to(torch.bfloat16)) and writes them the same way. The caller
// guarantees the alignment: VEC * sizeof(T) bytes, or 16 when that is more;
// load_bf16_pair and store_elems need only that of one element.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rows {

template <int kBytes>
struct Piece;
template <>
struct Piece<1> { using type = uint8_t; };
template <>
struct Piece<2> { using type = uint16_t; };
template <>
struct Piece<4> { using type = uint32_t; };
template <>
struct Piece<8> { using type = uint2; };
template <>
struct Piece<16> { using type = uint4; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct Vec {
  static constexpr int kBytes = static_cast<int>(sizeof(T)) * VEC;
  static constexpr int kPieceBytes = kBytes < 16 ? kBytes : 16;
  static constexpr int kPieces = kBytes / kPieceBytes;
  using P = typename Piece<kPieceBytes>::type;
  struct Raw {
    P p[kPieces];
  };

  static __device__ __forceinline__ Raw load(const T* x) {
    Raw r;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) r.p[i] = reinterpret_cast<const P*>(x)[i];
    return r;
  }
  static __device__ __forceinline__ void add(const Raw& r, float* acc) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += to_f32(e[i]);
  }
  static __device__ __forceinline__ void add(const Raw& r, float w, float* acc) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += w * to_f32(e[i]);
  }
};

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* v) {
  using V = Vec<T, VEC>;
  constexpr int kPer = V::kPieceBytes / static_cast<int>(sizeof(T));
#pragma unroll
  for (int i = 0; i < V::kPieces; ++i) {
    alignas(16) T e[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = from_f32<T>(v[i * kPer + j]);
    reinterpret_cast<typename V::P*>(p)[i] = *reinterpret_cast<const typename V::P*>(e);
  }
}

// Two bf16 elements at any 2-byte-aligned address p, as the one 4-byte piece
// of Vec<__nv_bfloat16, 2>: one 4-byte load where p is 4-byte aligned, else
// the two aligned words around the pair, funnel-shifted (every other row of
// an odd-width table starts 2 bytes into a word). With `pair` false (the
// last element of an odd width) only p[0] is read and the other half is 0.
__device__ __forceinline__ Vec<__nv_bfloat16, 2>::Raw load_bf16_pair(
    const __nv_bfloat16* p, bool pair) {
  Vec<__nv_bfloat16, 2>::Raw r;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (!pair) {
    r.p[0] = *reinterpret_cast<const uint16_t*>(p);
  } else if (a % 4 == 0) {
    r.p[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a - 2);
    r.p[0] = __funnelshift_r(w[0], w[1], 16);  // the high half of w[0], then w[1]'s low
  }
  return r;
}

// The first n (<= VEC) of v rounded to T and written one element at a time:
// any address aligned to T.
template <typename T, int VEC>
__device__ __forceinline__ void store_elems(T* p, const float* v, int n) {
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (i < n) p[i] = from_f32<T>(v[i]);
}

}  // namespace rows
