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
// ids read once, over the memory rate. In practice each edge's row is read
// again, so the rate at which rows arrive sets the time. While the table
// fits the 50 MB L2 (10 MB at Pubmed, 128 wide), repeated neighbour rows are
// L2 hits: at degree 492 rows arrive at 7.2-7.4 TB/s up to a 51 MB f32
// table. Past L2 they miss more and more: 6.3 TB/s at 67 MB, 4.9 at 102 MB,
// 4.6 at the published Reddit model's f32 [232965, 128] (119 MB, 2.4x the
// cache; 114.6M edges, 58.7 GB of rows a call, 12.8 ms).
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
// batches: within L2 the kernel is bound by the latency of each warp's chain
// of dependent loads, and more resident warps hide more of it. A row that ends
// inside the chunk is written directly, scaled. A row cut by a chunk
// boundary is finished by spmm_mean_kernel_fixup: the piece at a chunk's end
// goes to that chunk's carry row in the scratch buffer, the piece at a row's
// end to that chunk's head row, both f32, and the fix-up adds the carries in
// chunk order, then the head, scales and rounds once. No atomics: the result
// is bitwise repeatable.
//
// Column panels, for a table larger than L2: the wrapper (ops/spmm.py:panels)
// cuts the columns into P panels of whole 128-byte L2 lines a row, the fewest
// whose rows fit a share of L2 (Reddit's f32 rows: 4 panels of 32 columns,
// 29.8 MB each), and keeps P = 1 where the table fits L2, where not even one
// line a row fits, or where rows are not line-aligned. The panel is the
// grid's slowest dimension, so the blocks of panel p run before those of
// p + 1 and one panel is live in L2 at a time; each pass walks the merge path
// again, so indptr and the edge ids are read P times (1.8 GB at Reddit,
// against 58.7 GB of rows now served from L2). Row loads carry an L2
// evict-last policy; the indptr and edge-id windows, the output and the
// carries stream past with evict-first loads and stores, so that they do not
// push the panel out. In a panel of one line, groups of 8 lanes take one
// edge's 128 bytes each, 4 edges a load instruction (kGroups; 2 groups of 16
// lanes in a panel of two lines), so a warp keeps kDepth x 512 bytes in
// flight as over whole rows: group g adds the edges g, g + kGroups, ... of
// the warp's chunk, and where a row ends the groups' sums meet in xor
// shuffles, in a fixed order (the result stays bitwise repeatable, and
// differs from one pass's in rounding only). At Reddit the rows arrive at
// 7.2 TB/s again: 8.0-8.2 ms a call.
//
// Live columns: given `live`, a column count on the card (null: all), the
// panels that start at or past it return at once and the fix-up leaves their
// columns, which stay unwritten. The segment max's backward
// (segment_max.cu) sums its full ties' columns, compacted to the front on
// the card, without reading their number back to the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "merge_path.cuh"
#include "rows.cuh"

namespace {

using merge_path::evict_last_policy;
using merge_path::kFull;
using merge_path::kLine;
using merge_path::kWarp;
using merge_path::load_kept;
using merge_path::merge_search;
using merge_path::store_streaming;

constexpr int kWarpsPerBlock = 8;
constexpr int kDepth = 4;  // row loads in flight per lane

// One pass over columns [blockIdx.y * panel_cols, + panel_cols) (all of
// them when panel_cols = F). carry and head: one f32 row per chunk each, ld
// floats apart (F rounded up to even, so kOdd's f32 pairs stay aligned),
// each panel writing its columns; carry_row: the row each chunk's carry
// belongs to, or -1 (written by the first panel). kOdd: bf16 pairs read
// from any 2-byte address, rows written per element (see above). kGroups:
// edges a warp loads at once, one per group of kWarp / kGroups lanes.
// kPanels: the cache hints of a panel pass (16-byte pieces only).
template <typename T, int VEC, bool kOdd, int kGroups, bool kPanels>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_mean_kernel(const T* __restrict__ x, const int32_t* __restrict__ indptr,
                 const int32_t* __restrict__ edge_dst, T* __restrict__ out,
                 float* __restrict__ carry, float* __restrict__ head,
                 int32_t* __restrict__ carry_row, int N, int F, int ld, int normalize,
                 int chunk, int num_chunks, int panel_cols, const int32_t* __restrict__ live) {
  using V = rows::Vec<T, VEC>;
  static_assert(!kOdd || (std::is_same_v<T, __nv_bfloat16> && VEC == 2));
  static_assert(!kPanels || (!kOdd && V::kBytes == 16));
  static_assert(kGroups == 1 || kPanels);
  constexpr int kThreads = kWarp * kWarpsPerBlock;
  constexpr int kLanes = kWarp / kGroups;  // lanes on one edge's row piece
  extern __shared__ int32_t smem[];  // window of indptr, then of edge_dst
  __shared__ int s_count[kWarpsPerBlock];
  // A panel past the live columns does nothing (uniform across the block).
  if (live != nullptr && static_cast<int>(blockIdx.y) * panel_cols >= *live) return;
  const int lane = threadIdx.x % kWarp;
  const int group = lane / kLanes;
  const bool first_panel = blockIdx.y == 0;
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int E = indptr[N];
  const int total = N + E;
  // The block's kWarpsPerBlock consecutive chunks: span items from diagonal D0.
  const int span = kWarpsPerBlock * chunk;
  const int D0 = blockIdx.x * span;
  if (D0 >= total) {  // chunks past the last item (E_pad > E)
    if (first_panel && lane == 0 && c < num_chunks) carry_row[c] = -1;
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
  auto window = [](const int32_t* p) {
    if constexpr (kPanels) return __ldcs(p);
    else return *p;
  };
  for (int i = threadIdx.x; i <= rows; i += kThreads) s_ptr[i] = window(indptr + I0 + i);
  for (int i = threadIdx.x; i < edges; i += kThreads) s_dst[i] = window(edge_dst + J0 + i);
  __syncthreads();

  const int d0 = c * chunk;
  if (c >= num_chunks) return;
  if (d0 >= total) {
    if (first_panel && lane == 0) carry_row[c] = -1;
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
  [[maybe_unused]] uint64_t policy = 0;
  if constexpr (kPanels) policy = evict_last_policy();

  const int col_end = min(F, (static_cast<int>(blockIdx.y) + 1) * panel_cols);
  for (int c0 = blockIdx.y * panel_cols; c0 < col_end; c0 += kLanes * VEC) {
    const int col = c0 + lane % kLanes * VEC;
    const bool active = col < col_end;  // F % VEC == 0, or kOdd's last element alone
    const bool writes = active && group == 0;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    int r = i0, rstart = first_start;
    auto load = [&](const T* p) {
      if constexpr (kOdd) {
        return rows::load_bf16_pair(p, col + 1 < F);
      } else if constexpr (kPanels) {
        typename V::Raw v;
        v.p[0] = load_kept(p, policy);
        return v;
      } else {
        return V::load(p);
      }
    };
    // The groups' sums of the row so far, in every lane (a fixed order).
    auto reduce = [&]() {
#pragma unroll
      for (int m = kLanes; m < kWarp; m *= 2)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], m);
    };
    auto store_f32 = [&](float* p) {
      if constexpr (kPanels) store_streaming<float, VEC>(p, acc);
      else rows::store<float, VEC>(p, acc);
    };

    // Write row r (its end item lies in this chunk) and move to row r + 1.
    auto flush = [&]() {
      const int rend = s_ptr[r + 1 - I0];
      reduce();
      if (writes) {
        if (r == i0 && first_cut) {  // the fix-up adds the carries and scales
          store_f32(head + static_cast<size_t>(c) * ld + col);
        } else {
          const float denom = normalize ? static_cast<float>(max(rend - rstart, 1)) : 1.f;
          float v[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] = acc[i] / denom;
          T* o = out + static_cast<size_t>(r) * F + col;
          if constexpr (kOdd) rows::store_elems<T, VEC>(o, v, min(VEC, F - col));
          else if constexpr (kPanels) store_streaming<T, VEC>(o, v);
          else rows::store<T, VEC>(o, v);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      rstart = rend;
      ++r;
    };

    // Each step t loads edges e0 + t * kGroups .. + kGroups - 1, one a group.
    for (int e0 = j0; e0 < j1; e0 += kGroups * kDepth) {
      typename V::Raw v[kDepth];
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        const int e = e0 + t * kGroups + group;
        if (e < j1 && active) {
          const int src = s_dst[e - J0];
          v[t] = load(x + static_cast<size_t>(src) * F + col);
        }
      }
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        const int b = e0 + t * kGroups;
        if (b < j1) {
          const int e = b + group, b_end = min(b + kGroups, j1);
          // Edge b_end - 1 belongs to row i1 at the latest, so r + 1 - I0
          // stays inside the window while this loop reads it.
          while (s_ptr[r + 1 - I0] < b_end) {  // row r ends before edge b_end
            if constexpr (kGroups > 1)
              if (active && e >= rstart && e < s_ptr[r + 1 - I0]) V::add(v[t], acc);
            flush();
          }
          if (active && (kGroups == 1 || (e >= rstart && e < b_end))) V::add(v[t], acc);
        }
      }
    }
    while (r < i1) flush();
    carries = i1 < N && rstart < j1;  // here r == i1 and rstart == indptr[i1]
    if (carries) {
      reduce();
      if (writes) store_f32(carry + static_cast<size_t>(c) * ld + col);
    }
  }
  if (first_panel && lane == 0) carry_row[c] = carries ? i1 : -1;
}

// One warp per chunk; the first chunk that carries row r sums the carries of
// r in chunk order, adds the head piece of the chunk where r ends (the first
// after the run that does not carry r), scales and writes row r: its columns
// up to the end of the last live panel.
template <typename T, int VEC, bool kOdd>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_mean_kernel_fixup(const int32_t* __restrict__ indptr, T* __restrict__ out,
                       const float* __restrict__ carry, const float* __restrict__ head,
                       const int32_t* __restrict__ carry_row, int F, int ld, int normalize,
                       int num_chunks, int panel_cols, const int32_t* __restrict__ live) {
  using V = rows::Vec<float, VEC>;
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int f_end =
      live == nullptr ? F : min(F, (*live + panel_cols - 1) / panel_cols * panel_cols);
  if (c >= num_chunks || f_end == 0) return;  // no live panel wrote carry_row
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
  for (int c0 = 0; c0 < f_end; c0 += kWarp * VEC) {
    const int col = c0 + lane * VEC;
    if (col >= f_end) break;
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

template <typename T, int VEC, bool kOdd = false, int kGroups = 1, bool kPanels = false>
int launch(const void* x, const void* indptr, const void* edge_dst, void* out,
           void* scratch, int N, int F, int normalize, int chunk, int num_chunks,
           int panels, const void* live, void* stream) {
  const int ld = F + F % 2;  // scratch row stride, as the wrapper sizes it
  const int threads = kWarp * kWarpsPerBlock;
  const int blocks = (num_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* carry = static_cast<float*>(scratch);
  float* head = carry + static_cast<size_t>(num_chunks) * ld;
  int32_t* carry_row = reinterpret_cast<int32_t*>(head + static_cast<size_t>(num_chunks) * ld);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const size_t smem = (2 * static_cast<size_t>(kWarpsPerBlock) * chunk + 1) * sizeof(int32_t);
  // The panel is the slowest grid dimension: panel p's blocks start first.
  spmm_mean_kernel<T, VEC, kOdd, kGroups, kPanels><<<dim3(blocks, panels), threads, smem, s>>>(
      static_cast<const T*>(x), ip, static_cast<const int32_t*>(edge_dst),
      static_cast<T*>(out), carry, head, carry_row, N, F, ld, normalize, chunk,
      num_chunks, F / panels, static_cast<const int32_t*>(live));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_mean_kernel_fixup<T, VEC, kOdd><<<blocks, threads, 0, s>>>(
      ip, static_cast<T*>(out), carry, head, carry_row, F, ld, normalize, num_chunks,
      F / panels, static_cast<const int32_t*>(live));
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// panels > 1 column panels of whole lines of a line-aligned X (as the
// wrapper plans them; anything else is refused), 16-byte pieces (VEC of T).
template <typename T, int VEC>
int launch_panels(const void* x, const void* indptr, const void* edge_dst, void* out,
                  void* scratch, int N, int F, int normalize, int chunk, int num_chunks,
                  int panels, const void* live, void* stream) {
  static_assert(VEC * sizeof(T) == 16);
  const size_t bytes = static_cast<size_t>(F) * sizeof(T) / panels;  // a panel's row
  if (F % panels != 0 || bytes % kLine != 0 || !aligned(x, kLine))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes == kLine)
    return launch<T, VEC, false, 4, true>(x, indptr, edge_dst, out, scratch, N, F, normalize,
                                          chunk, num_chunks, panels, live, stream);
  if (bytes == 2 * kLine)
    return launch<T, VEC, false, 2, true>(x, indptr, edge_dst, out, scratch, N, F, normalize,
                                          chunk, num_chunks, panels, live, stream);
  return launch<T, VEC, false, 1, true>(x, indptr, edge_dst, out, scratch, N, F, normalize,
                                        chunk, num_chunks, panels, live, stream);
}

}  // namespace

// scratch: 2 * num_chunks * ld floats of carry and head rows (ld = F rounded
// up to even), then num_chunks int32 row ids; chunk * num_chunks >= N + indptr[N] (the
// wrapper sizes both). out has X's type. panels: 1 for one pass over whole
// rows, with the widest load that every row start permits; more for column
// panels (see above). live: an int32 column count on the card, or null for
// all columns (see above).
extern "C" int gsage_spmm_mean_f32(const void* x, const void* indptr,
                                   const void* edge_dst, void* out, void* scratch,
                                   int N, int F, int normalize, int chunk,
                                   int num_chunks, int panels, const void* live,
                                   void* stream) {
  if (panels != 1)
    return panels > 1 ? launch_panels<float, 4>(x, indptr, edge_dst, out, scratch, N, F,
                                                normalize, chunk, num_chunks, panels, live,
                                                stream)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (F % 4 == 0 && aligned(x, 16))
    return launch<float, 4>(x, indptr, edge_dst, out, scratch, N, F, normalize, chunk,
                            num_chunks, 1, live, stream);
  return launch<float, 1>(x, indptr, edge_dst, out, scratch, N, F, normalize, chunk,
                          num_chunks, 1, live, stream);
}

extern "C" int gsage_spmm_mean_bf16(const void* x, const void* indptr,
                                    const void* edge_dst, void* out, void* scratch,
                                    int N, int F, int normalize, int chunk,
                                    int num_chunks, int panels, const void* live,
                                    void* stream) {
  if (panels != 1)
    return panels > 1 ? launch_panels<__nv_bfloat16, 8>(x, indptr, edge_dst, out, scratch,
                                                        N, F, normalize, chunk, num_chunks,
                                                        panels, live, stream)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (F % 8 == 0 && aligned(x, 16))
    return launch<__nv_bfloat16, 8>(x, indptr, edge_dst, out, scratch, N, F, normalize,
                                    chunk, num_chunks, 1, live, stream);
  if (F % 2 == 0 && aligned(x, 4))
    return launch<__nv_bfloat16, 2>(x, indptr, edge_dst, out, scratch, N, F, normalize,
                                    chunk, num_chunks, 1, live, stream);
  // An odd width, or X at a 2-byte offset: pairs from any 2-byte address.
  return launch<__nv_bfloat16, 2, true>(x, indptr, edge_dst, out, scratch, N, F,
                                        normalize, chunk, num_chunks, 1, live, stream);
}
