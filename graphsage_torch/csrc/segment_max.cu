// CSR segment max for Hopper (sm_90a): the max-pooling aggregator's
// full-graph reduction, forward and backward, with no per-edge tensor.
//
// Replaces no Pallas kernel: the JAX package's full-graph max-pool runs
// graphsage_tpu/ops/aggregate.py:segment_max_csr, an XLA scatter-max over a
// per-edge gather of the pooled rows. At Reddit's size that gather alone is
// [114.6M, 512] f32, 234.7 GB, three times the card's memory; the port's
// plain route (the same function) fails there with an out-of-memory error.
//
//   out[v, c] = max_{e in [indptr[v], indptr[v+1])} X[edge_dst[e], c]  (0 where deg v = 0)
//   rec[v, c] = u >= 0  the one neighbour u whose row holds the max
//             = -k      k >= 2 edge slots of the row tie at the max
//             = -1      the row has no edge
//
// X f32 or bf16 [N, F]; out [N, F] in X's type; rec int32 [N, F]; indptr
// int32 [N+1], edge_dst int32 [E_pad] (only edge_dst[:indptr[N]] is read).
// The max is exact, so out equals the per-edge scatter-max bitwise. X is a
// ReLU output (the pooling MLP's), whose zeros take no gradient (ReLU's
// backward drops it), so an entry whose max is 0 records -1 and its
// gradient, which could only reach zeros, is not sent: where a pooled column
// is 0 for most nodes (a ReLU unit off), every row ties there, and the tie
// pass would otherwise walk every edge of that column with an atomic add
// apiece.
//
// Forward. Each edge reads one F-wide row and compares it; this kernel walks
// the CSR as kernel 3 (spmm_mean.cu) does: merge path over the N + E row
// ends and edges, one warp per equal chunk (ops/spmm.py:chunking), so a hub
// of 10^5 edges is shared by hundreds of warps; column panels of whole L2
// lines a row, the fewest whose rows fit a share of L2 (ops/spmm.py:panels:
// Reddit's pooled f32 [232965, 512], 477 MB, goes in 16 panels of 32
// columns, 29.8 MB each), with the panel's rows kept in L2 (evict-last) and
// the rest streamed past. A lane keeps, for each of its columns, the largest
// value so far, the chunk slot that first held it and the count of slots
// that hold it (visit), and turns them into a state in rec's encoding (-1:
// no edge; u; -k) once a row piece ends. The lanes' partial results over
// disjoint edges combine exactly (the larger value wins; equal values add
// their counts), so where groups of lanes share a warp's edges (panels of
// one or two lines) and where a chunk boundary cuts a row (the carry and
// head pieces, finished by segment_max_fixup in chunk order) the result does
// not depend on the split: no atomics, bitwise repeatable.
//
// What bounds the forward: L2's rate for rows. With a branchy update of the
// state, the path of a step in which no row ends ran 25.6 instructions
// an (edge, column), 10.6 on the ALU pipe (SASS of the 1-line-panel
// instance), and the kernel read Reddit's pooled rows at 4.1 TB/s on an
// H100, where kernel 3's walk reads its rows at 7.2. visit puts 3 of its 6
// instructions on the FMA pipe, and a step whose edges all lie in the open
// row skips the row-end and range tests: 9.1 instructions an (edge,
// column), 4.1 on the ALU pipe, and the rows arrive at 7.1 TB/s.

// Backward (the even split of the scatter-max's gradient): dX[u, c] +=
// g[v, c] where rec[v, c] = u, and g[v, c] / k to each of the k tied slots
// where rec[v, c] = -k; rows without an edge send nothing. dX is summed in
// f32 with atomics (order changes the rounding of a sum only) and rounded
// once by the wrapper. segment_max_scatter reads g and rec once, coalesced,
// sends each untied entry to its neighbour's row and flags the rows that
// hold a tie. segment_max_ties then revisits only flagged rows: fixed pieces
// of `piece` edge slots, one warp each (a tied hub is shared), whose lanes
// take 4 columns each and skip blocks of columns without a tie, compare
// X[u, c] with out[v, c] at the tied ones and send g / k where they match,
// one vector atomic add a lane. Its cost follows the ties: on random ReLU
// rows a few dozen rows tie; in training (Reddit, H100: layer 0's units die
// within 10 Adam steps) whole pooled columns read one value on every node,
// and every row ties with all of its neighbours there: 6.1e9 (edge, column)
// hits a call, 170-190 ms of atomics, varying with the seed. So with a
// symmetric adjacency a full tie (k = deg v) is left to the wrapper, which
// adds A (g / deg) over the columns that hold one with kernel 3: a CSR sum,
// no atomics. segment_max_full_cols moves those columns to the front (in
// the order of a stable sort of their flags, made by the wrapper on the
// card) as g / deg at the full ties and 0 elsewhere, kernel 3 sums them,
// reading their count on the card and passing over the panels past it, and
// segment_max_full_cols adds the sums back to their columns of dX: the host
// reads nothing back. Each pass touches only the live columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

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
constexpr int kEmpty = -1;  // rec's state of a row (or a piece of one) with no edge

// Adds one edge slot (value x, at slot `at` of the chunk) to a column's
// running (best, slot, count): the max so far, the first slot that held it
// and how many slots hold it. From best = -inf and count = 0 the first edge
// always wins, so there is no test for an empty state and no branch. slot
// and count are small whole numbers, exact in f32 (a lane sees the slots of
// one chunk, at most ops/spmm.py:MAX_CHUNK), so with the compares' 0 or 1
// they update by FMAs: two compares and a max run on the ALU pipe, three
// operations on the FMA pipe. Exact for finite values (a ReLU output's).
__device__ __forceinline__ void visit(float& best, float& slot, float& count, float x,
                                      float at) {
  const float le = x <= best ? 1.f : 0.f;  // 0 where x is a new max
  count = fmaf(count, le, x >= best ? 1.f : 0.f);
  slot = fmaf(le, slot - at, at);
  best = fmaxf(best, x);
}

// A running (slot, count) in rec's encoding: -1 for no edge, the neighbour
// at the slot (dst: the chunk's edge ids) alone, -k for k tied slots.
__device__ __forceinline__ int32_t state_of(float slot, float count, const int32_t* dst) {
  const int32_t k = static_cast<int32_t>(count);
  return k > 1 ? -k : k == 1 ? dst[static_cast<int32_t>(slot)] : kEmpty;
}

// Combines (best, state) with another partial result over disjoint edges.
// Symmetric, so two lanes that swap their partials agree on the result.
__device__ __forceinline__ void combine(float& best, int32_t& state, float ob, int32_t os) {
  if (os == kEmpty) return;
  if (state == kEmpty || ob > best) {
    best = ob;
    state = os;
  } else if (ob == best) {
    state = -((state >= 0 ? 1 : -state) + (os >= 0 ? 1 : -os));
  }
}

// A row's finished (best, state) as out's value and rec's entry: 0 and -1
// for a row without an edge; -1 for a max of 0 (a ReLU output's zeros).
__device__ __forceinline__ void final_entry(float best, int32_t state, float& v, int32_t& s) {
  const bool none = state == kEmpty || best == 0.f;
  v = state == kEmpty ? 0.f : best;
  s = none ? kEmpty : state;
}

// VEC int32 values, in 16-byte pieces where VEC allows, evict-first in a
// panel pass.
template <int VEC, bool kStream>
__device__ __forceinline__ void store_i32(int32_t* p, const int32_t* s) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const int4 w = make_int4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      if constexpr (kStream) __stcs(reinterpret_cast<int4*>(p) + i, w);
      else reinterpret_cast<int4*>(p)[i] = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = s[i];
  }
}

// One pass over columns [blockIdx.y * panel_cols, + panel_cols) (all of
// them when panel_cols = F), as spmm_mean_kernel walks them. carry_*, head_*:
// one row of F per chunk each, the partial result of the row open at the
// chunk's end and of the row cut at its start; carry_row: the row each
// chunk's carry belongs to, or -1 (written by the first panel). kGroups:
// edges a warp loads at once, one per group of kWarp / kGroups lanes.
template <typename T, int VEC, int kGroups, bool kPanels>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_max_kernel(const T* __restrict__ x, const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ edge_dst, T* __restrict__ out,
                   int32_t* __restrict__ rec, float* __restrict__ carry_v,
                   int32_t* __restrict__ carry_s, float* __restrict__ head_v,
                   int32_t* __restrict__ head_s, int32_t* __restrict__ carry_row, int N, int F,
                   int chunk, int num_chunks, int panel_cols) {
  using V = rows::Vec<T, VEC>;
  static_assert(!kPanels || V::kBytes == 16);
  static_assert(kGroups == 1 || kPanels);
  constexpr int kThreads = kWarp * kWarpsPerBlock;
  constexpr int kLanes = kWarp / kGroups;  // lanes on one edge's row piece
  extern __shared__ int32_t smem[];  // window of indptr, then of edge_dst
  __shared__ int s_count[kWarpsPerBlock];
  const int lane = threadIdx.x % kWarp;
  const int group = lane / kLanes;
  const bool first_panel = blockIdx.y == 0;
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int E = indptr[N];
  const int total = N + E;
  const int span = kWarpsPerBlock * chunk;
  const int D0 = blockIdx.x * span;
  if (D0 >= total) {  // chunks past the last item (E_pad > E)
    if (first_panel && lane == 0 && c < num_chunks) carry_row[c] = -1;
    return;  // uniform across the block
  }
  const int I0 = merge_search<kThreads>(indptr, 0, D0, max(D0 - E, 0), min(D0, N),
                                        s_count);
  const int J0 = D0 - I0;
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
  const int d1 = d0 + min(chunk, total - d0);
  const int row_hi = I0 + rows;
  const int i0 = merge_search<kWarp>(s_ptr, I0, d0, max(I0, d0 - E),
                                     min(min(d0, N), row_hi), nullptr);
  const int j0 = d0 - i0;
  const int i1 = merge_search<kWarp>(s_ptr, I0, d1, max(i0, d1 - E),
                                     min(min(d1, N), min(row_hi, i0 + (d1 - d0))),
                                     nullptr);
  const int j1 = d1 - i1;
  // Rows i0..i1-1 end in this chunk; row i1 (if < N) is open at its end.
  const int first_start = s_ptr[i0 - I0];
  const bool first_cut = first_start < j0;
  bool carries = false;
  [[maybe_unused]] uint64_t policy = 0;
  if constexpr (kPanels) policy = evict_last_policy();

  const int col_end = min(F, (static_cast<int>(blockIdx.y) + 1) * panel_cols);
  for (int c0 = blockIdx.y * panel_cols; c0 < col_end; c0 += kLanes * VEC) {
    const int col = c0 + lane % kLanes * VEC;
    const bool active = col < col_end;
    const bool writes = active && group == 0;
    float best[VEC], slot[VEC], count[VEC];
    auto open_row = [&]() {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        best[i] = -CUDART_INF_F;
        slot[i] = 0.f;
        count[i] = 0.f;
      }
    };
    open_row();
    int r = i0, rstart = first_start;
    auto load = [&](int32_t u) {  // neighbour u's piece of the row
      const T* p = x + static_cast<size_t>(u) * F + col;
      if constexpr (kPanels) {
        typename V::Raw v;
        v.p[0] = load_kept(p, policy);
        return v;
      } else {
        return V::load(p);
      }
    };
    // The values of the edge at slot `at` of the chunk (edge j0 + at).
    auto add = [&](const typename V::Raw& v, float at) {
      const T* p = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) visit(best[i], slot[i], count[i], rows::to_f32(p[i]), at);
    };
    // The piece of the row so far as (value, state in rec's encoding), the
    // groups' partial results combined, in every lane.
    auto reduce = [&](float* v, int32_t* s) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[i] = best[i];
        s[i] = state_of(slot[i], count[i], s_dst + (j0 - J0));
      }
#pragma unroll
      for (int m = kLanes; m < kWarp; m *= 2)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float ob = __shfl_xor_sync(kFull, v[i], m);
          const int32_t os = __shfl_xor_sync(kFull, s[i], m);
          combine(v[i], s[i], ob, os);
        }
    };
    auto store_piece = [&](float* pv, int32_t* ps, const float* v, const int32_t* s) {
      if constexpr (kPanels) store_streaming<float, VEC>(pv, v);
      else rows::store<float, VEC>(pv, v);
      store_i32<VEC, kPanels>(ps, s);
    };

    // Write row r (its end item lies in this chunk) and move to row r + 1.
    auto flush = [&]() {
      const int rend = s_ptr[r + 1 - I0];
      float v[VEC];
      int32_t s[VEC];
      reduce(v, s);
      if (writes) {
        if (r == i0 && first_cut) {  // the fix-up combines it with the carries
          const size_t at = static_cast<size_t>(c) * F + col;
          store_piece(head_v + at, head_s + at, v, s);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) final_entry(v[i], s[i], v[i], s[i]);
          const size_t at = static_cast<size_t>(r) * F + col;
          if constexpr (kPanels) store_streaming<T, VEC>(out + at, v);
          else rows::store<T, VEC>(out + at, v);
          store_i32<VEC, kPanels>(rec + at, s);
        }
      }
      open_row();
      rstart = rend;
      ++r;
    };

    // Each step t loads edges e0 + t * kGroups .. + kGroups - 1, one a group.
    constexpr int kStep = kGroups * kDepth;
    for (int e0 = j0; e0 < j1; e0 += kStep) {
      typename V::Raw v[kDepth];
      if (min(s_ptr[r + 1 - I0], j1) >= e0 + kStep) {
        // Every edge of the step lies in row r, the open row (most steps:
        // Reddit's rows average 492 slots): no row end and no group's range
        // of edges to test.
        if (active) {
#pragma unroll
          for (int t = 0; t < kDepth; ++t) v[t] = load(s_dst[e0 + t * kGroups + group - J0]);
          const float at = static_cast<float>(e0 + group - j0);
#pragma unroll
          for (int t = 0; t < kDepth; ++t) add(v[t], at + static_cast<float>(t * kGroups));
        }
        continue;
      }
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        const int e = e0 + t * kGroups + group;
        if (e < j1 && active) v[t] = load(s_dst[e - J0]);
      }
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        const int b = e0 + t * kGroups;
        if (b < j1) {
          const int e = b + group, b_end = min(b + kGroups, j1);
          const float at = static_cast<float>(e - j0);
          while (s_ptr[r + 1 - I0] < b_end) {  // row r ends before edge b_end
            if constexpr (kGroups > 1)
              if (active && e >= rstart && e < s_ptr[r + 1 - I0]) add(v[t], at);
            flush();
          }
          if (active && (kGroups == 1 || (e >= rstart && e < b_end))) add(v[t], at);
        }
      }
    }
    while (r < i1) flush();
    carries = i1 < N && rstart < j1;  // here r == i1 and rstart == indptr[i1]
    if (carries) {
      float v[VEC];
      int32_t s[VEC];
      reduce(v, s);
      if (writes) {
        const size_t at = static_cast<size_t>(c) * F + col;
        store_piece(carry_v + at, carry_s + at, v, s);
      }
    }
  }
  if (first_panel && lane == 0) carry_row[c] = carries ? i1 : -1;
}

// One warp per chunk and block of 32 columns (gridDim.y); the first chunk
// that carries row r combines the carries of r in chunk order, kDepth loads
// in flight, and the head piece of the chunk where r ends (the first after
// the run), and writes its columns of row r. A hub's run of hundreds of
// carries is shared by F / 32 warps.
template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_max_fixup(const int32_t* __restrict__ carry_row, const float* __restrict__ carry_v,
                  const int32_t* __restrict__ carry_s, const float* __restrict__ head_v,
                  const int32_t* __restrict__ head_s, T* __restrict__ out,
                  int32_t* __restrict__ rec, int F, int num_chunks) {
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (c >= num_chunks) return;
  const int r = carry_row[c];
  if (r < 0 || (c > 0 && carry_row[c - 1] == r)) return;
  int c_end = c + 1;
  for (;;) {
    const int q = c_end + lane;
    const unsigned same = __ballot_sync(kFull, q < num_chunks && carry_row[q] == r);
    const int run = same == kFull ? kWarp : __ffs(~same) - 1;
    c_end += run;
    if (run < kWarp) break;
  }
  const int col = blockIdx.y * kWarp + lane;
  if (col >= F) return;
  float best = 0.f;
  int32_t state = kEmpty;
  for (int q0 = c; q0 < c_end; q0 += kDepth) {
    float v[kDepth];
    int32_t st[kDepth];
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      if (q0 + t < c_end) {
        const size_t at = static_cast<size_t>(q0 + t) * F + col;
        v[t] = carry_v[at];
        st[t] = carry_s[at];
      }
    }
#pragma unroll
    for (int t = 0; t < kDepth; ++t)
      if (q0 + t < c_end) combine(best, state, v[t], st[t]);
  }
  const size_t at = static_cast<size_t>(c_end) * F + col;
  combine(best, state, head_v[at], head_s[at]);
  const size_t o = static_cast<size_t>(r) * F + col;
  float v;
  int32_t st;
  final_entry(best, state, v, st);
  out[o] = rows::from_f32<T>(v);
  rec[o] = st;
}

template <typename T, int VEC, int kGroups = 1, bool kPanels = false>
int launch(const void* x, const void* indptr, const void* edge_dst, void* out, void* rec,
           void* scratch, int N, int F, int chunk, int num_chunks, int panels,
           void* stream) {
  const int threads = kWarp * kWarpsPerBlock;
  const int blocks = (num_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t piece = static_cast<size_t>(num_chunks) * F;
  float* carry_v = static_cast<float*>(scratch);
  float* head_v = carry_v + piece;
  int32_t* carry_s = reinterpret_cast<int32_t*>(head_v + piece);
  int32_t* head_s = carry_s + piece;
  int32_t* carry_row = head_s + piece;
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const size_t smem = (2 * static_cast<size_t>(kWarpsPerBlock) * chunk + 1) * sizeof(int32_t);
  // The panel is the slowest grid dimension: panel p's blocks start first.
  segment_max_kernel<T, VEC, kGroups, kPanels><<<dim3(blocks, panels), threads, smem, s>>>(
      static_cast<const T*>(x), ip, static_cast<const int32_t*>(edge_dst),
      static_cast<T*>(out), static_cast<int32_t*>(rec), carry_v, carry_s, head_v, head_s,
      carry_row, N, F, chunk, num_chunks, F / panels);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_max_fixup<T><<<dim3(blocks, (F + kWarp - 1) / kWarp), threads, 0, s>>>(
      carry_row, carry_v, carry_s, head_v, head_s, static_cast<T*>(out),
      static_cast<int32_t*>(rec), F, num_chunks);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// One pass with 16-byte pieces (VEC of T) where every row start allows them,
// else one element a lane; panels > 1: column panels of whole lines of a
// line-aligned X, as the wrapper plans them (anything else is refused).
template <typename T, int VEC>
int forward(const void* x, const void* indptr, const void* edge_dst, void* out, void* rec,
            void* scratch, int N, int F, int chunk, int num_chunks, int panels,
            void* stream) {
  static_assert(VEC * sizeof(T) == 16);
  if (panels == 1) {
    if (F % VEC == 0 && aligned(x, 16))
      return launch<T, VEC>(x, indptr, edge_dst, out, rec, scratch, N, F, chunk, num_chunks,
                            1, stream);
    return launch<T, 1>(x, indptr, edge_dst, out, rec, scratch, N, F, chunk, num_chunks, 1,
                        stream);
  }
  const size_t bytes = static_cast<size_t>(F) * sizeof(T) / panels;  // a panel's row
  if (panels < 1 || F % panels != 0 || bytes % kLine != 0 || !aligned(x, kLine))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes == kLine)
    return launch<T, VEC, 4, true>(x, indptr, edge_dst, out, rec, scratch, N, F, chunk,
                                   num_chunks, panels, stream);
  if (bytes == 2 * kLine)
    return launch<T, VEC, 2, true>(x, indptr, edge_dst, out, rec, scratch, N, F, chunk,
                                   num_chunks, panels, stream);
  return launch<T, VEC, 1, true>(x, indptr, edge_dst, out, rec, scratch, N, F, chunk,
                                 num_chunks, panels, stream);
}

// A tie the tie pass leaves to the wrapper: with a symmetric adjacency, a
// tie of every edge slot of row r (k = deg r) sends g / k to each of r's
// neighbours, which is A (g / k) in that column, a CSR sum.
__device__ __forceinline__ bool full_tie(int32_t state, int deg, int symmetric) {
  return symmetric && -state == deg;
}

// One warp a row, lanes over its columns: each untied entry's gradient to
// its neighbour's row of dX; rows that hold a tie for the tie pass are
// flagged in `tied`, columns that hold a full tie in `full_cols`.
template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_max_scatter(const T* __restrict__ g, const int32_t* __restrict__ rec,
                    const int32_t* __restrict__ indptr, float* __restrict__ dx,
                    int32_t* __restrict__ tied, int32_t* __restrict__ full_cols, int N, int F,
                    int symmetric) {
  const int lane = threadIdx.x % kWarp;
  const int warps = gridDim.x * kWarpsPerBlock;
  for (int r = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp; r < N; r += warps) {
    const int deg = indptr[r + 1] - indptr[r];
    bool tie = false;
    for (int col = lane; col < F; col += kWarp) {
      const size_t at = static_cast<size_t>(r) * F + col;
      const int32_t s = rec[at];
      if (s >= 0) {
        atomicAdd(dx + static_cast<size_t>(s) * F + col, rows::to_f32(g[at]));
      } else if (s < kEmpty) {
        if (full_tie(s, deg, symmetric)) full_cols[col] = 1;
        else tie = true;
      }
    }
    if (__any_sync(kFull, tie) && lane == 0) tied[r] = 1;
  }
}

// One warp per piece of `piece` edge slots: for each flagged row with edges
// in the piece, lanes take kTieVec consecutive columns each (a warp 128 at a
// time) and skip a block of columns without a tie; for each of the row's
// edges in the piece, a lane whose columns hold a tie reads X[u] at them and
// sends g / k where a value equals the max, with one vector atomic add of
// its kTieVec columns where F allows (sm_90). Realistic training ties a
// whole column at once (a pooled unit that reads the same value on most
// nodes), so a tied row often ties with most of its neighbours.
constexpr int kTieVec = 4;  // make_float4 below

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_max_ties(const T* __restrict__ x, const T* __restrict__ out, const T* __restrict__ g,
                 const int32_t* __restrict__ rec, const int32_t* __restrict__ tied,
                 const int32_t* __restrict__ indptr, const int32_t* __restrict__ edge_dst,
                 float* __restrict__ dx, int N, int F, int piece, int num_pieces,
                 int symmetric) {
  const int lane = threadIdx.x % kWarp;
  const int w = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (w >= num_pieces) return;
  const int E = indptr[N];
  const int e_lo = w * piece;
  if (e_lo >= E) return;
  const int e_hi = min(e_lo + piece, E);
  const bool vector = F % kTieVec == 0;  // dx + u * F + col is 16-byte aligned
  // The row holding edge e_lo: the last r with indptr[r] <= e_lo (r < N).
  int lo = 0, hi = N - 1;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (indptr[mid] <= e_lo) lo = mid;
    else hi = mid - 1;
  }
  for (int r = lo; r < N;) {
    // The next flagged row among r .. r + 31 with edges in the piece.
    const int q = r + lane;
    const bool found = q < N && indptr[q] < e_hi && tied[q];
    const unsigned m = __ballot_sync(kFull, found);
    if (m == 0) {
      if (r + kWarp >= N || indptr[r + kWarp] >= e_hi) break;
      r += kWarp;
      continue;
    }
    r += __ffs(m) - 1;
    const int a = max(indptr[r], e_lo), b = min(indptr[r + 1], e_hi);
    const int deg = indptr[r + 1] - indptr[r];
    for (int c0 = 0; c0 < F; c0 += kWarp * kTieVec) {
      const int col = c0 + lane * kTieVec;
      float best[kTieVec], share[kTieVec];
      bool on[kTieVec], any = false;
#pragma unroll
      for (int i = 0; i < kTieVec; ++i) {
        const size_t at = static_cast<size_t>(r) * F + col + i;
        const int32_t st = col + i < F ? rec[at] : kEmpty;
        on[i] = st < kEmpty && !full_tie(st, deg, symmetric);
        best[i] = on[i] ? rows::to_f32(out[at]) : 0.f;
        share[i] = on[i] ? rows::to_f32(g[at]) / static_cast<float>(-st) : 0.f;
        any |= on[i];
      }
      if (!__any_sync(kFull, any) || !any) continue;  // no tie in the warp's, or the lane's
#pragma unroll 4
      for (int e = a; e < b; ++e) {
        const size_t xu = static_cast<size_t>(edge_dst[e]) * F + col;
        bool hit[kTieVec], some = false;
#pragma unroll
        for (int i = 0; i < kTieVec; ++i) {
          hit[i] = on[i] && rows::to_f32(x[xu + i]) == best[i];
          some |= hit[i];
        }
        if (!some) continue;
        if (vector) {
          atomicAdd(reinterpret_cast<float4*>(dx + xu),
                    make_float4(hit[0] ? share[0] : 0.f, hit[1] ? share[1] : 0.f,
                                hit[2] ? share[2] : 0.f, hit[3] ? share[3] : 0.f));
        } else {
#pragma unroll
          for (int i = 0; i < kTieVec; ++i)
            if (hit[i]) atomicAdd(dx + xu + i, share[i]);
        }
      }
    }
    ++r;
  }
}

template <typename T>
int backward(const void* g, const void* x, const void* out, const void* rec,
             const void* indptr, const void* edge_dst, void* dx, void* tied, void* full_cols,
             int N, int F, int piece, int num_pieces, int symmetric, void* stream) {
  const int threads = kWarp * kWarpsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = std::min((N + kWarpsPerBlock - 1) / kWarpsPerBlock, 1 << 16);
  segment_max_scatter<T><<<std::max(row_blocks, 1), threads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(rec),
      static_cast<const int32_t*>(indptr), static_cast<float*>(dx),
      static_cast<int32_t*>(tied), static_cast<int32_t*>(full_cols), N, F, symmetric);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int piece_blocks = (num_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_max_ties<T><<<std::max(piece_blocks, 1), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(out), static_cast<const T*>(g),
      static_cast<const int32_t*>(rec), static_cast<const int32_t*>(tied),
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(edge_dst),
      static_cast<float*>(dx), N, F, piece, num_pieces, symmetric);
  return static_cast<int>(cudaGetLastError());
}

// The full ties' columns and kernel 3 (see above), one warp a row, its
// lanes over the live columns: order (int64 [F]) lists the columns that hold
// a full tie first, live (on the card) counts them. kGather: share[v, j] =
// g[v, order[j]] / deg v where (v, order[j]) is a full tie, else 0, for j up
// to the end of the last live panel of panel_cols columns (kernel 3 reads
// those). Else dX[v, order[j]] += total[v, j] for j < live (one entry a
// thread: no atomics).
template <typename T, bool kGather>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_max_full_cols(const T* __restrict__ g, const int32_t* __restrict__ rec,
                      const int32_t* __restrict__ indptr, const int64_t* __restrict__ order,
                      const int32_t* __restrict__ live, float* __restrict__ share,
                      const float* __restrict__ total, float* __restrict__ dx, int N, int F,
                      int panel_cols) {
  const int n_live = *live;
  const int end =
      kGather ? min(F, (n_live + panel_cols - 1) / panel_cols * panel_cols) : n_live;
  const int lane = threadIdx.x % kWarp;
  const int warps = gridDim.x * kWarpsPerBlock;
  for (int v = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp; v < N && end > 0;
       v += warps) {
    const int deg = indptr[v + 1] - indptr[v];
    const size_t row = static_cast<size_t>(v) * F;
    for (int j = lane; j < end; j += kWarp) {
      if constexpr (kGather) {
        float sh = 0.f;
        if (j < n_live) {
          const size_t at = row + order[j];
          const int32_t st = rec[at];
          if (st < kEmpty && full_tie(st, deg, 1))
            sh = rows::to_f32(g[at]) / static_cast<float>(deg);
        }
        share[row + j] = sh;
      } else {
        dx[row + order[j]] += total[row + j];
      }
    }
  }
}

template <typename T>
int full_cols(const void* g, const void* rec, const void* indptr, const void* order,
              const void* live, void* share, const void* total, void* dx, int N, int F,
              int panel_cols, int gather, void* stream) {
  const int blocks = std::min((N + kWarpsPerBlock - 1) / kWarpsPerBlock, 1 << 16);
  const auto args = [&](auto kernel) {
    kernel<<<std::max(blocks, 1), kWarp * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), static_cast<const int32_t*>(rec),
        static_cast<const int32_t*>(indptr), static_cast<const int64_t*>(order),
        static_cast<const int32_t*>(live), static_cast<float*>(share),
        static_cast<const float*>(total), static_cast<float*>(dx), N, F, panel_cols);
  };
  if (gather) args(segment_max_full_cols<T, true>);
  else args(segment_max_full_cols<T, false>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: 4 * num_chunks * F words (the carry and head pieces' values, f32,
// then their states, int32), then num_chunks int32 row ids; chunk *
// num_chunks >= N + indptr[N] (the wrapper sizes both). panels: 1 for one
// pass over whole rows, more for column panels (see above). X is a ReLU
// output (see above).
extern "C" int gsage_segment_max_f32(const void* x, const void* indptr, const void* edge_dst,
                                     void* out, void* rec, void* scratch, int N, int F,
                                     int chunk, int num_chunks, int panels, void* stream) {
  return forward<float, 4>(x, indptr, edge_dst, out, rec, scratch, N, F, chunk, num_chunks,
                           panels, stream);
}

extern "C" int gsage_segment_max_bf16(const void* x, const void* indptr, const void* edge_dst,
                                      void* out, void* rec, void* scratch, int N, int F,
                                      int chunk, int num_chunks, int panels, void* stream) {
  return forward<__nv_bfloat16, 8>(x, indptr, edge_dst, out, rec, scratch, N, F, chunk,
                                   num_chunks, panels, stream);
}

// dx: f32 [rows of X, F], zeroed; tied: int32 [N], zeroed; full_cols:
// int32 [F], zeroed; g and out [N, F] in X's type; num_pieces * piece >=
// indptr[N]; symmetric: the adjacency equals its transpose, and full ties
// are left to the wrapper (flagged in full_cols).
extern "C" int gsage_segment_max_backward_f32(const void* g, const void* x, const void* out,
                                              const void* rec, const void* indptr,
                                              const void* edge_dst, void* dx, void* tied,
                                              void* full_cols, int N, int F, int piece,
                                              int num_pieces, int symmetric, void* stream) {
  return backward<float>(g, x, out, rec, indptr, edge_dst, dx, tied, full_cols, N, F, piece,
                         num_pieces, symmetric, stream);
}

extern "C" int gsage_segment_max_backward_bf16(const void* g, const void* x, const void* out,
                                               const void* rec, const void* indptr,
                                               const void* edge_dst, void* dx, void* tied,
                                               void* full_cols, int N, int F, int piece,
                                               int num_pieces, int symmetric, void* stream) {
  return backward<__nv_bfloat16>(g, x, out, rec, indptr, edge_dst, dx, tied, full_cols, N, F,
                                 piece, num_pieces, symmetric, stream);
}

// The full ties' columns moved to the front for kernel 3 (gather = 1: share,
// f32 [N, F], written up to the end of the last live panel of panel_cols
// columns) and its sums added back to dx (gather = 0: total, f32 [N, F],
// read for the live columns); order: int64 [F], the columns that hold a full
// tie first; live: int32 [1], their count. g and rec as for the backward.
extern "C" int gsage_segment_max_full_cols_f32(const void* g, const void* rec,
                                               const void* indptr, const void* order,
                                               const void* live, void* share,
                                               const void* total, void* dx, int N, int F,
                                               int panel_cols, int gather, void* stream) {
  return full_cols<float>(g, rec, indptr, order, live, share, total, dx, N, F, panel_cols,
                          gather, stream);
}

extern "C" int gsage_segment_max_full_cols_bf16(const void* g, const void* rec,
                                                const void* indptr, const void* order,
                                                const void* live, void* share,
                                                const void* total, void* dx, int N, int F,
                                                int panel_cols, int gather, void* stream) {
  return full_cols<__nv_bfloat16>(g, rec, indptr, order, live, share, total, dx, N, F,
                                  panel_cols, gather, stream);
}
