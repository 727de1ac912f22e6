// Native graph partitioner for graphsage_tpu: community LPA + balanced
// packing and BFS ordering.
//
// The reference has no partitioner at all (single device; reference
// graphsage/model.py); the framework's halo-exchange plan
// (graphsage_tpu/parallel/halo.py) needs one per graph, and the numpy
// label-propagation implementation costs O(E log E) lexsorts per sweep —
// minutes at the 20M-edge BASELINE #4 scale. This library implements the
// same algorithms in C++ (per-node counting sweeps, no global sorts):
//
//   * gsp_lpa_assign — community label propagation (mode of neighbor
//                      labels, ties to the LARGEST label — matching the
//                      numpy oracle's stable-lexsort tie-break) followed by
//                      largest-first balanced packing into shards.
//   * gsp_bfs_order  — per-level BFS with sorted-unique frontiers
//                      (identical order to parallel.halo.bfs_order).
//
// Exposed through a plain C ABI, consumed via ctypes
// (graphsage_tpu/parallel/native_partition.py). Semantics are pinned by
// parity tests against the numpy implementations (tests/test_native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Synchronous LPA sweep: new label of v = most frequent label among v's
// neighbors (previous iteration's labels); ties -> largest label; isolated
// nodes keep their label. Returns number of changed nodes.
int64_t lpa_sweep(const int64_t* indptr, const int32_t* edge_dst, int64_t n,
                  const std::vector<int64_t>& lab,
                  std::vector<int64_t>& out) {
  int64_t changed = 0;
  std::vector<int64_t> scratch;
  for (int64_t v = 0; v < n; ++v) {
    const int64_t lo = indptr[v], hi = indptr[v + 1];
    if (lo == hi) {
      out[v] = lab[v];
      continue;
    }
    scratch.clear();
    scratch.reserve(hi - lo);
    for (int64_t e = lo; e < hi; ++e) scratch.push_back(lab[edge_dst[e]]);
    std::sort(scratch.begin(), scratch.end());
    // best = (count, label) maximized lexicographically -> ties to the
    // largest label (scan runs in ascending label order, >= keeps later).
    int64_t best_lab = scratch[0], best_cnt = 0;
    int64_t run_lab = scratch[0], run_cnt = 0;
    for (size_t i = 0; i < scratch.size(); ++i) {
      if (scratch[i] == run_lab) {
        ++run_cnt;
      } else {
        run_lab = scratch[i];
        run_cnt = 1;
      }
      if (run_cnt >= best_cnt) {
        best_cnt = run_cnt;
        best_lab = run_lab;
      }
    }
    out[v] = best_lab;
    if (best_lab != lab[v]) ++changed;
  }
  return changed;
}

}  // namespace

extern "C" {

// Community LPA + balanced packing. indptr [n+1] (int64), edge_dst [E]
// (int32, full CSR). Writes the shard id per node into out_assign [n].
// Returns 0 on success.
int gsp_lpa_assign(const int64_t* indptr, const int32_t* edge_dst, int64_t n,
                   int64_t num_shards, int64_t iters, double slack,
                   int32_t* out_assign) {
  if (n <= 0 || num_shards <= 0) return 1;
  const int64_t num_edges = indptr[n];

  // Phase 1: label propagation to communities.
  std::vector<int64_t> lab(n), next(n);
  for (int64_t v = 0; v < n; ++v) lab[v] = v;
  const int64_t stop = std::max<int64_t>(1, n / 1000);
  for (int64_t it = 0; it < iters; ++it) {
    const int64_t changed = lpa_sweep(indptr, edge_dst, n, lab, next);
    lab.swap(next);
    if (changed < stop) break;
  }

  // Community ranks: sorted unique labels (matches np.unique/comm_inv).
  std::vector<int64_t> uniq(lab);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  const int64_t c_count = static_cast<int64_t>(uniq.size());
  std::vector<int64_t> comm_inv(n);
  for (int64_t v = 0; v < n; ++v) {
    comm_inv[v] = std::lower_bound(uniq.begin(), uniq.end(), lab[v]) -
                  uniq.begin();
  }

  // Per-community members in ascending node id (stable grouping) + edge
  // weights.
  std::vector<int64_t> comm_edges(c_count, 0), comm_size(c_count, 0);
  for (int64_t v = 0; v < n; ++v) {
    comm_edges[comm_inv[v]] += indptr[v + 1] - indptr[v];
    comm_size[comm_inv[v]] += 1;
  }
  std::vector<int64_t> starts(c_count + 1, 0);
  for (int64_t c = 0; c < c_count; ++c) starts[c + 1] = starts[c] + comm_size[c];
  std::vector<int64_t> members(n), fill(starts.begin(), starts.end() - 1);
  for (int64_t v = 0; v < n; ++v) members[fill[comm_inv[v]]++] = v;

  // Largest-first (stable on ties — matches argsort(-w, kind="stable")).
  std::vector<int64_t> order(c_count);
  for (int64_t c = 0; c < c_count; ++c) order[c] = c;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return comm_edges[a] > comm_edges[b];
  });

  const double cap =
      slack * static_cast<double>(std::max<int64_t>(num_edges, 1)) /
      static_cast<double>(num_shards);
  std::vector<double> load(num_shards, 0.0);
  auto argmin_load = [&]() {
    int64_t t = 0;
    for (int64_t s = 1; s < num_shards; ++s)
      if (load[s] < load[t]) t = s;
    return t;
  };

  for (int64_t oc = 0; oc < c_count; ++oc) {
    const int64_t c = order[oc];
    const int64_t* nodes = &members[starts[c]];
    const int64_t len = comm_size[c];
    const double w = static_cast<double>(comm_edges[c]);
    const int64_t tmin = argmin_load();
    if (w <= std::max(cap - load[tmin], cap * 0.5)) {
      for (int64_t i = 0; i < len; ++i)
        out_assign[nodes[i]] = static_cast<int32_t>(tmin);
      load[tmin] += w;
    } else {
      // Split an oversized community by cumulative degree (lower_bound on
      // the running prefix — matches np.searchsorted side="left").
      std::vector<double> cw(len);
      double acc = 0.0;
      for (int64_t i = 0; i < len; ++i) {
        acc += static_cast<double>(indptr[nodes[i] + 1] - indptr[nodes[i]]);
        cw[i] = acc;
      }
      int64_t pos = 0;
      while (pos < len) {
        const int64_t t = argmin_load();
        const double room = std::max(cap - load[t], cap * 0.1);
        const double prev = pos ? cw[pos - 1] : 0.0;
        int64_t end =
            std::lower_bound(cw.begin(), cw.end(), prev + room) - cw.begin();
        end = std::max(end, pos + 1);
        double moved = cw[end - 1] - prev;
        for (int64_t i = pos; i < end; ++i)
          out_assign[nodes[i]] = static_cast<int32_t>(t);
        load[t] += moved;
        pos = end;
      }
    }
  }
  return 0;
}

// BFS node order with per-level sorted-unique frontiers; identical output
// to graphsage_tpu.parallel.halo.bfs_order. Writes out_order [n].
int gsp_bfs_order(const int64_t* indptr, const int32_t* edge_dst, int64_t n,
                  int32_t* out_order) {
  if (n <= 0) return 1;
  std::vector<uint8_t> visited(n, 0);
  std::vector<int64_t> frontier, nxt;
  int64_t pos = 0, next_seed = 0;
  while (pos < n) {
    while (next_seed < n && visited[next_seed]) ++next_seed;
    frontier.assign(1, next_seed);
    visited[next_seed] = 1;
    while (!frontier.empty()) {
      for (int64_t v : frontier) out_order[pos++] = static_cast<int32_t>(v);
      nxt.clear();
      for (int64_t v : frontier) {
        for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
          const int64_t u = edge_dst[e];
          if (!visited[u]) nxt.push_back(u);
        }
      }
      std::sort(nxt.begin(), nxt.end());
      nxt.erase(std::unique(nxt.begin(), nxt.end()), nxt.end());
      for (int64_t u : nxt) visited[u] = 1;
      frontier.swap(nxt);
    }
  }
  return 0;
}

}  // extern "C"
