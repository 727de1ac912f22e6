// CSR mean-SpMM for Hopper (sm_90a), balanced over edges (merge path).
//
// Replaces graphsage_tpu/ops/pallas_spmm.py:_kernel, reached through
// _spmm_impl / spmm_mean_vmem (forward, and with normalize=False its
// symmetric backward) and the "pallas_vmem" route of
// graphsage_tpu/ops/aggregate.py:spmm_mean.
//
//   out[v, :] = scale(v) * sum_{e in [indptr[v], indptr[v+1])} X[edge_dst[e], :]
//   scale(v)  = 1 / max(deg v, 1) when normalize, else 1
//
// X f32 or bf16 [N, F]; indptr int32 [N+1]; edge_dst int32 [E_pad]; out
// [N, F] in X's type, summed in f32 and rounded once (bf16: the table tier's
// refresh and the layer-0 cache of the bf16 presets; the TPU kernel cast X to
// f32 first).
//
// What bounds it on the H100: bytes. Each edge reads one F-wide row and adds
// it (a quarter of an operation per byte read), far below the ridge point;
// the least time is X read once, out written once, indptr and the used edge
// ids read once, over the memory rate. The table (10 MB at Pubmed, 128 wide)
// stays resident in the 50 MB L2, so repeated neighbour rows are L2 hits.
//
// What held the earlier design back: one warp per CSR row, so a hub row of
// 949 edges was walked by a single warp, one 512-byte row load in flight at a
// time, while the rest of the card sat idle (30x the bound on a heavy-tailed
// Pubmed-sized graph, 13x its time on a graph of degree 15).
//
// Design: merge-path SpMM (Merrill & Garland, SC 2016). The N + E merge
// items (row ends and edges, in CSR order) are cut into equal chunks of
// `chunk` items, one warp per chunk, whatever the degrees; the wrapper picks
// `chunk` so that about 4096 warps run (ops/spmm.py:chunking). There is no
// host-side schedule: the 256 threads of a block find where the block's 8
// chunks start with one 256-way search of indptr (two rounds at N = 20000),
// copy the indptr and edge_dst windows that those chunks can touch into
// shared memory, and each warp then finds its own chunk's start and end
// there. Lanes own 16-byte column pieces (four f32 or eight bf16; bf16 pairs
// when F is even but not a multiple of 8, as Reddit's 602; single f32
// elements when an f32 width is not a multiple of 4). An odd bf16 width (or
// X at a 2-byte offset) still takes pairs: every other row starts 2 bytes
// into a 4-byte word, so there a lane reads the two words around its pair
// and funnel-shifts them, the width's last element is read alone, and the
// rows are written one element at a time (kOdd); a warp issues the row loads of
// kDepth edges before it adds them. Few registers matter more than deep
// batches: the kernel is bound by the latency of each warp's chain of
// dependent loads, and more resident warps hide more of it. A row that ends
// inside the chunk is written directly, scaled. A row cut by a chunk
// boundary is finished by spmm_mean_kernel_fixup: the piece at a chunk's end
// goes to that chunk's carry row in the scratch buffer, the piece at a row's
// end to that chunk's head row, both f32, and the fix-up adds the carries in
// chunk order, then the head, scales and rounds once. No atomics: the result
// is bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rows.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kDepth = 4;  // row loads in flight per warp
constexpr unsigned kFull = 0xffffffffu;

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

// carry and head: one f32 row per chunk each, ld floats apart (F rounded up
// to even, so kOdd's f32 pairs stay aligned); carry_row: the row each
// chunk's carry belongs to, or -1. kOdd: bf16 pairs read from any 2-byte
// address, rows written per element (see above).
template <typename T, int VEC, bool kOdd>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_mean_kernel(const T* __restrict__ x, const int32_t* __restrict__ indptr,
                 const int32_t* __restrict__ edge_dst, T* __restrict__ out,
                 float* __restrict__ carry, float* __restrict__ head,
                 int32_t* __restrict__ carry_row, int N, int F, int ld, int normalize,
                 int chunk, int num_chunks) {
  using V = rows::Vec<T, VEC>;
  static_assert(!kOdd || (std::is_same_v<T, __nv_bfloat16> && VEC == 2));
  constexpr int kThreads = kWarp * kWarpsPerBlock;
  extern __shared__ int32_t smem[];  // window of indptr, then of edge_dst
  __shared__ int s_count[kWarpsPerBlock];
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int E = indptr[N];
  const int total = N + E;
  // The block's kWarpsPerBlock consecutive chunks: span items from diagonal D0.
  const int span = kWarpsPerBlock * chunk;
  const int D0 = blockIdx.x * span;
  if (D0 >= total) {  // chunks past the last item (E_pad > E)
    if (lane == 0 && c < num_chunks) carry_row[c] = -1;
    return;  // uniform across the block
  }
  const int I0 = merge_search<kThreads>(indptr, 0, D0, max(D0 - E, 0), min(D0, N),
                                        s_count);
  const int J0 = D0 - I0;
  // Rows I0 .. I0+rows and edges J0 .. J0+edges cover every row end and edge
  // of the block (at most span items); copy both windows to shared memory.
  const int rows = min(N - I0, span);
  const int edges = min(E - J0, span);
  int32_t* s_ptr = smem;               // s_ptr[i] = indptr[I0 + i], i <= rows
  int32_t* s_dst = smem + span + 1;    // s_dst[i] = edge_dst[J0 + i], i < edges
  for (int i = threadIdx.x; i <= rows; i += kThreads) s_ptr[i] = indptr[I0 + i];
  for (int i = threadIdx.x; i < edges; i += kThreads) s_dst[i] = edge_dst[J0 + i];
  __syncthreads();

  const int d0 = c * chunk;
  if (c >= num_chunks) return;
  if (d0 >= total) {
    if (lane == 0) carry_row[c] = -1;
    return;
  }
  const int d1 = d0 + min(chunk, total - d0);  // no int overflow near 2^31
  const int row_hi = I0 + rows;  // the window's last row
  const int i0 = merge_search<kWarp>(s_ptr, I0, d0, max(I0, d0 - E),
                                     min(min(d0, N), row_hi), nullptr);
  const int j0 = d0 - i0;
  const int i1 = merge_search<kWarp>(s_ptr, I0, d1, max(i0, d1 - E),
                                     min(min(d1, N), min(row_hi, i0 + (d1 - d0))),
                                     nullptr);
  const int j1 = d1 - i1;
  // Rows i0..i1-1 end in this chunk; row i1 (if < N) is open at its end.
  // Only row i0 can have begun in an earlier chunk (i0 < N since d0 < total).
  const int first_start = s_ptr[i0 - I0];
  const bool first_cut = first_start < j0;
  bool carries = false;  // row i1 has begun: the next chunk finds it cut

  for (int c0 = 0; c0 < F; c0 += kWarp * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < F;  // F % VEC == 0, or kOdd's last element alone
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    int r = i0, rstart = first_start;
    auto load = [&](const T* p) {
      if constexpr (kOdd) return rows::load_bf16_pair(p, col + 1 < F);
      else return V::load(p);
    };

    // Write row r (its end item lies in this chunk) and move to row r + 1.
    auto flush = [&]() {
      const int rend = s_ptr[r + 1 - I0];
      if (active) {
        if (r == i0 && first_cut) {  // the fix-up adds the carries and scales
          rows::store<float, VEC>(head + static_cast<size_t>(c) * ld + col, acc);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
        } else {
          const float denom = normalize ? static_cast<float>(max(rend - rstart, 1)) : 1.f;
          float v[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            v[i] = acc[i] / denom;
            acc[i] = 0.f;
          }
          T* o = out + static_cast<size_t>(r) * F + col;
          if constexpr (kOdd) rows::store_elems<T, VEC>(o, v, min(VEC, F - col));
          else rows::store<T, VEC>(o, v);
        }
      }
      rstart = rend;
      ++r;
    };

    for (int e0 = j0; e0 < j1; e0 += kDepth) {
      const int n = min(kDepth, j1 - e0);
      typename V::Raw v[kDepth];
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        if (t < n && active) {
          const int src = s_dst[e0 + t - J0];
          v[t] = load(x + static_cast<size_t>(src) * F + col);
        }
      }
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        if (t < n) {
          // Edge e0+t belongs to row i1 at the latest, so r + 1 - I0 stays
          // inside the window while this loop reads it.
          while (e0 + t >= s_ptr[r + 1 - I0]) flush();
          if (active) V::add(v[t], acc);
        }
      }
    }
    while (r < i1) flush();
    carries = i1 < N && rstart < j1;  // here r == i1 and rstart == indptr[i1]
    if (carries && active) rows::store<float, VEC>(carry + static_cast<size_t>(c) * ld + col, acc);
  }
  if (lane == 0) carry_row[c] = carries ? i1 : -1;
}

// One warp per chunk; the first chunk that carries row r sums the carries of
// r in chunk order, adds the head piece of the chunk where r ends (the first
// after the run that does not carry r), scales and writes row r.
template <typename T, int VEC, bool kOdd>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_mean_kernel_fixup(const int32_t* __restrict__ indptr, T* __restrict__ out,
                       const float* __restrict__ carry, const float* __restrict__ head,
                       const int32_t* __restrict__ carry_row, int F, int ld, int normalize,
                       int num_chunks) {
  using V = rows::Vec<float, VEC>;
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (c >= num_chunks) return;
  const int r = carry_row[c];
  if (r < 0 || (c > 0 && carry_row[c - 1] == r)) return;
  // The chunks carrying r are consecutive: find where the run ends.
  int c_end = c + 1;
  for (;;) {
    const int q = c_end + lane;
    const unsigned same = __ballot_sync(kFull, q < num_chunks && carry_row[q] == r);
    const int run = same == kFull ? kWarp : __ffs(~same) - 1;
    c_end += run;
    if (run < kWarp) break;
  }
  const float denom = normalize
      ? static_cast<float>(max(indptr[r + 1] - indptr[r], 1)) : 1.f;
  for (int c0 = 0; c0 < F; c0 += kWarp * VEC) {
    const int col = c0 + lane * VEC;
    if (col >= F) break;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int q0 = c; q0 < c_end; q0 += kDepth) {  // kDepth loads in flight
      typename V::Raw v[kDepth];
#pragma unroll
      for (int t = 0; t < kDepth; ++t)
        if (q0 + t < c_end) v[t] = V::load(carry + static_cast<size_t>(q0 + t) * ld + col);
#pragma unroll
      for (int t = 0; t < kDepth; ++t)
        if (q0 + t < c_end) V::add(v[t], acc);
    }
    V::add(V::load(head + static_cast<size_t>(c_end) * ld + col), acc);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] /= denom;
    T* o = out + static_cast<size_t>(r) * F + col;
    if constexpr (kOdd) rows::store_elems<T, VEC>(o, acc, min(VEC, F - col));
    else rows::store<T, VEC>(o, acc);
  }
}

template <typename T, int VEC, bool kOdd = false>
int launch(const void* x, const void* indptr, const void* edge_dst, void* out,
           void* scratch, int N, int F, int normalize, int chunk, int num_chunks,
           void* stream) {
  const int ld = F + F % 2;  // scratch row stride, as the wrapper sizes it
  const int threads = kWarp * kWarpsPerBlock;
  const int blocks = (num_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* carry = static_cast<float*>(scratch);
  float* head = carry + static_cast<size_t>(num_chunks) * ld;
  int32_t* carry_row = reinterpret_cast<int32_t*>(head + static_cast<size_t>(num_chunks) * ld);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const size_t smem = (2 * static_cast<size_t>(kWarpsPerBlock) * chunk + 1) * sizeof(int32_t);
  spmm_mean_kernel<T, VEC, kOdd><<<blocks, threads, smem, s>>>(
      static_cast<const T*>(x), ip, static_cast<const int32_t*>(edge_dst),
      static_cast<T*>(out), carry, head, carry_row, N, F, ld, normalize, chunk,
      num_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_mean_kernel_fixup<T, VEC, kOdd><<<blocks, threads, 0, s>>>(
      ip, static_cast<T*>(out), carry, head, carry_row, F, ld, normalize, num_chunks);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// scratch: 2 * num_chunks * ld floats of carry and head rows (ld = F rounded
// up to even), then num_chunks int32 row ids; chunk * num_chunks >= N + indptr[N] (the
// wrapper sizes both). out has X's type; the widest load that every row
// start permits.
extern "C" int gsage_spmm_mean_f32(const void* x, const void* indptr,
                                   const void* edge_dst, void* out, void* scratch,
                                   int N, int F, int normalize, int chunk,
                                   int num_chunks, void* stream) {
  if (F % 4 == 0 && aligned(x, 16))
    return launch<float, 4>(x, indptr, edge_dst, out, scratch, N, F, normalize, chunk,
                            num_chunks, stream);
  return launch<float, 1>(x, indptr, edge_dst, out, scratch, N, F, normalize, chunk,
                          num_chunks, stream);
}

extern "C" int gsage_spmm_mean_bf16(const void* x, const void* indptr,
                                    const void* edge_dst, void* out, void* scratch,
                                    int N, int F, int normalize, int chunk,
                                    int num_chunks, void* stream) {
  if (F % 8 == 0 && aligned(x, 16))
    return launch<__nv_bfloat16, 8>(x, indptr, edge_dst, out, scratch, N, F, normalize,
                                    chunk, num_chunks, stream);
  if (F % 2 == 0 && aligned(x, 4))
    return launch<__nv_bfloat16, 2>(x, indptr, edge_dst, out, scratch, N, F, normalize,
                                    chunk, num_chunks, stream);
  // An odd width, or X at a 2-byte offset: pairs from any 2-byte address.
  return launch<__nv_bfloat16, 2, true>(x, indptr, edge_dst, out, scratch, N, F,
                                        normalize, chunk, num_chunks, stream);
}
