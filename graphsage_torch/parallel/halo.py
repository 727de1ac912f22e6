"""Halo-exchange full-graph aggregation: the counterpart of
``graphsage_tpu/parallel/halo.py``.

The edge-partitioned path (:mod:`graphsage_torch.parallel.distributed`) sums
whole ``[N, F]`` partials over the axis every layer. Here the nodes are
partitioned: rank ``s`` owns a contiguous range of an internal node order
(``Np`` rows, padded) and receives only the *boundary* rows its edges read,
by three levers fixed in a host-built plan (:func:`build_node_partition`):

1. **Node order** (``order=``): input order, :func:`bfs_order`,
   :func:`lpa_assign`'s communities, an explicit permutation, or ``"auto"``
   (:func:`auto_partition_plan` sweeps order x hub threshold x sizing and
   keeps the least traffic).
2. **Hub replication** (``hub_threshold=``): rows of degree at least the
   threshold travel once, by one all-gather per layer, instead of in every
   pairwise list.
3. **Sizing**: ``"global"`` ships ``halo_chunks`` all-to-all chunks, every
   pair padded to the worst pair; ``"per_offset"`` ships ``S - 1`` rounds
   (receiver ``s`` gets from ``(s + o) % S`` in round ``o``), each padded to
   its own worst pair.

The plan's arrays are JAX's, stacked over the shards, on the host
(:class:`NodePartition`). :meth:`NodePartition.local` gives one rank's slice
on its device (:class:`HaloShard`). Its edges are regrouped into **one CSR**
over a combined source buffer::

    [h_local (Np) | hub all-gather (S * hub_k) | chunk c's or round o's rows, in order]

(only valid edges enter it; a column is its group's slot plus the group's
offset in the buffer), and its transpose for the backward. Each layer the
rank gathers every row it sends in one ``index_select`` (its backward is
Hopper kernel 2's sum mode, skipping the padded send slots), exchanges them
through the autograd collectives of :mod:`graphsage_torch.parallel.
collectives`, concatenates the buffer, and aggregates it in one call: the
mean is one launch of Hopper kernel 3 (f32 sums, divided by ``max(deg, 1)``,
rounded once, as JAX's f32 running sum is), whose backward is kernel 3 again
over the transposed CSR on ``g / deg`` (rounded to the table's dtype, as the
single-device backward rounds it); the max is
:func:`graphsage_torch.ops.aggregate.segment_max_csr` over the same edges
(guarded empty rows, quirk Q4). JAX leaves the overlap of the rounds with
the aggregation to XLA's scheduler; here the rounds run before it.

Every rank of the axis calls the functions below together (SPMD), as JAX's
``shard_map`` runs one program on every chip.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from graphsage_torch.data.graph import Graph, reject_lazy_descriptor, relabel_graph
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.ops.aggregate import gather, segment_max_csr
from graphsage_torch.ops.quantize import dense_host_view, is_quantized
from graphsage_torch.ops.scatter_mean import scatter_mean
from graphsage_torch.ops.spmm import spmm_block_sum
from graphsage_torch.parallel import collectives, native_partition
from graphsage_torch.parallel.mesh import axis_index


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _host_csr(graph: Graph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(indptr int64, edge_dst int64, edge_src int64)`` of the valid
    edges, on the host."""
    e = graph.num_edges
    return (graph.indptr.cpu().numpy().astype(np.int64),
            graph.edge_dst[:e].cpu().numpy().astype(np.int64),
            graph.edge_src[:e].cpu().numpy().astype(np.int64))


# --------------------------------------------------------------------------
# The plan (host side, numpy)
# --------------------------------------------------------------------------

class OffsetRound(NamedTuple):
    """One per-offset boundary round. Arrays lead with the shard dim;
    ``size`` is this round's own 8-padded worst pair."""

    offset: int
    size: int
    send: np.ndarray  # [S, size] local row ids shard t sends to (t - offset) % S
    edge_row: np.ndarray  # [S, E_o] destination rows
    edge_slot: np.ndarray  # [S, E_o] index into this round's [size] receive buffer
    edge_mask: np.ndarray  # [S, E_o]


class NodePartition(NamedTuple):
    """Static halo-exchange plan, every array stacked with a leading shard
    dim (JAX's fields; ``h0`` is a CPU tensor in the table's dtype, the rest
    numpy). Edges are grouped: *local* (rank-resident rows), optional *hub*
    (slots into the all-gathered hub rows) and *boundary*: ``halo_chunks``
    all-to-all chunks (``sizing="global"``) or per-offset ``rounds``."""

    num_shards: int
    nodes_per_shard: int  # Np (padded)
    halo_size: int  # pairwise rows: global m, or the sum of per-offset sizes
    halo_chunks: int  # C, the all-to-all chunks (global sizing)
    chunk_sizes: tuple  # per-chunk boundary rows (global sizing; 8-padded)
    sizes: np.ndarray  # [S] true range sizes
    node_order: np.ndarray  # [N] global id at each stacked position
    h0: torch.Tensor  # [S, Np, F] features in stacked order, zero-padded
    labels: np.ndarray  # [S, Np] int32
    node_mask: np.ndarray  # [S, Np] bool (True on real nodes)
    edge_local_row: np.ndarray  # [S, E0] local destination row
    edge_local_slot: np.ndarray  # [S, E0] resident-row index
    edge_local_mask: np.ndarray  # [S, E0]
    edge_halo_row: np.ndarray  # [S, C, Eh] (global sizing; [S, 1, 1] otherwise)
    edge_halo_slot: np.ndarray  # [S, C, Eh] index into chunk c's receive buffer
    edge_halo_mask: np.ndarray  # [S, C, Eh]
    send_plan: np.ndarray  # [S_owner, S_dest, M] local row ids (global sizing)
    stacked_index: np.ndarray  # [N] position of global node v in the stacked layout
    rounds: Optional[tuple] = None  # tuple[OffsetRound] (per-offset sizing)
    hub_k: int = 0  # hub rows per shard (8-padded max; 0 = no hub lever)
    hub_send: Optional[np.ndarray] = None  # [S, hub_k] local row ids
    edge_hub_row: Optional[np.ndarray] = None  # [S, Eh2]
    edge_hub_slot: Optional[np.ndarray] = None  # [S, Eh2] into [S * hub_k]
    edge_hub_mask: Optional[np.ndarray] = None  # [S, Eh2]

    def comm_stats(self) -> dict:
        """Boundary-exchange rows per shard and layer against the psum of
        whole ``[N, F]`` partials (JAX's counts)."""
        s, np_ = self.num_shards, self.nodes_per_shard
        n = int(self.stacked_index.shape[0])
        if self.rounds is not None:
            pairwise = sum(r.size for r in self.rounds)
        else:
            pairwise = (s - 1) * self.halo_size
        total = pairwise + (s - 1) * self.hub_k  # each hub row crosses once
        return {
            "num_shards": s,
            "nodes_per_shard": np_,
            "halo_rows_per_pair": self.halo_size,
            "hub_rows_per_shard": self.hub_k,
            "rows_exchanged_per_shard": total,
            "rows_psum_equivalent": n,
            "comm_reduction_vs_psum": n / max(total, 1),
        }

    def local(self, rank: int, device) -> "HaloShard":
        """Rank ``rank``'s slice on ``device`` (:class:`HaloShard`)."""
        return _local_shard(self, rank, device)


def bfs_order(graph: Graph) -> np.ndarray:
    """Breadth-first node order (one numpy pass per BFS level). Contiguous
    slices of it keep neighbourhoods together, which shrinks the cross-shard
    request lists on graphs with locality."""
    indptr, edge_dst, _ = _host_csr(graph)
    n = graph.num_nodes
    deg = indptr[1:] - indptr[:-1]
    visited = np.zeros(n, dtype=bool)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    next_seed = 0
    while pos < n:
        while next_seed < n and visited[next_seed]:
            next_seed += 1
        frontier = np.array([next_seed], dtype=np.int64)
        visited[next_seed] = True
        while len(frontier):
            out[pos: pos + len(frontier)] = frontier
            pos += len(frontier)
            counts = deg[frontier]
            total = int(counts.sum())
            if not total:
                break
            within = np.arange(total) - np.repeat(
                np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
            neigh = edge_dst[np.repeat(indptr[frontier], counts) + within]
            fresh = np.unique(neigh[~visited[neigh]])
            visited[fresh] = True
            frontier = fresh
    return out


def lpa_assign(graph: Graph, num_shards: int, iters: int = 10,
               slack: float = 1.05) -> np.ndarray:
    """Label propagation, then balanced packing: the ``[N]`` shard of each
    node.

    Phase 1: every node starts as its own community and adopts the most
    frequent community among its neighbours (ties to the largest label),
    until fewer than ``max(1, N // 1000)`` nodes change. Phase 2: the
    communities go largest-first to the least-loaded shard (edge counts,
    ``slack`` headroom); an oversized one is split by cumulative degree."""
    indptr, edge_dst, edge_src = _host_csr(graph)
    n = graph.num_nodes
    degrees = indptr[1:] - indptr[:-1]

    lab = np.arange(n, dtype=np.int64)
    for _ in range(iters):
        lv = lab[edge_dst]
        order = np.lexsort((lv, edge_src))
        s_s, l_s = edge_src[order], lv[order]
        new_run = np.empty(len(order), bool)
        if len(order):
            new_run[0] = True
            np.logical_or(s_s[1:] != s_s[:-1], l_s[1:] != l_s[:-1], out=new_run[1:])
        run_id = np.cumsum(new_run) - 1
        run_count = np.bincount(run_id)
        run_src, run_lab = s_s[new_run], l_s[new_run]
        ro = np.lexsort((run_count, run_src))
        rs = run_src[ro]
        last = np.empty(len(rs), bool)
        if len(rs):
            last[-1] = True
            np.not_equal(rs[1:], rs[:-1], out=last[:-1])
        new_lab = lab.copy()
        new_lab[rs[last]] = run_lab[ro][last]
        changed = int((new_lab != lab).sum())
        lab = new_lab
        if changed < max(1, n // 1000):
            break

    _, comm_inv = np.unique(lab, return_inverse=True)
    comm_edges = np.bincount(comm_inv, weights=degrees)
    cap = slack * max(graph.num_edges, 1) / num_shards
    shard_load = np.zeros(num_shards)
    assign = np.empty(n, np.int64)
    node_order = np.argsort(comm_inv, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(comm_inv))]).astype(np.int64)
    for c in np.argsort(-comm_edges, kind="stable"):
        nodes = node_order[starts[c]: starts[c + 1]]
        w = comm_edges[c]
        if w <= max(cap - shard_load.min(), cap * 0.5):
            t = int(np.argmin(shard_load))
            assign[nodes] = t
            shard_load[t] += w
        else:
            cw = np.cumsum(degrees[nodes])
            pos = 0
            while pos < len(nodes):
                t = int(np.argmin(shard_load))
                room = max(cap - shard_load[t], cap * 0.1)
                prev = cw[pos - 1] if pos else 0
                end = max(int(np.searchsorted(cw, prev + room)), pos + 1)
                assign[nodes[pos:end]] = t
                shard_load[t] += degrees[nodes[pos:end]].sum()
                pos = end
    return assign


def _resolve_order(graph: Graph, num_shards: int, order) -> tuple[np.ndarray, list | None]:
    """``(order array, lpa bounds or None)`` for an order spec (``None`` or
    ``"input"``, ``"bfs"``, ``"lpa"``, or a permutation). BFS and LPA run
    natively when the library builds, else in numpy
    (:data:`native_partition.last_impl` records which)."""
    n = graph.num_nodes
    if order is None or (isinstance(order, str) and order == "input"):
        return np.arange(n, dtype=np.int64), None
    if isinstance(order, str) and order == "bfs":
        nat = native_partition.bfs_order_native(graph)
        native_partition.last_impl["bfs"] = "numpy" if nat is None else "native"
        return (bfs_order(graph) if nat is None else nat), None
    if isinstance(order, str) and order == "lpa":
        # The shards are the LPA groups themselves, not an edge-balanced
        # re-split that would cut across communities.
        assign = native_partition.lpa_assign_native(graph, num_shards)
        native_partition.last_impl["lpa"] = "numpy" if assign is None else "native"
        if assign is None:
            assign = lpa_assign(graph, num_shards)
        counts = np.bincount(assign, minlength=num_shards)
        return np.argsort(assign, kind="stable"), [0] + list(np.cumsum(counts).astype(int))
    order = np.asarray(order, dtype=np.int64)
    if len(order) != n or len(np.unique(order)) != n:
        raise ValueError("order must be a permutation of all node ids")
    return order, None


def locality_relabel(graph: Graph, num_groups: int, order="auto") -> tuple[Graph, np.ndarray]:
    """Permute the node ids by a locality order: ``(relabeled graph,
    perm[old] = new)``, so that every id-range ownership rule (the
    node-sharded store's ranges, ``bounds="equal_nodes"`` plans) sees
    structure-aware shards.

    ``order="auto"`` ranks input, bfs and lpa by :func:`partition_comm_rows`
    with equal-node bounds and keeps the winner, ties within 2% going to the
    simplest; when input order wins the graph comes back unchanged with the
    identity permutation."""
    if isinstance(order, str) and order == "auto":
        ranked = []
        for i, o in enumerate(("input", "bfs", "lpa")):
            stats = partition_comm_rows(graph, num_groups, order=o, bounds="equal_nodes")
            ranked.append((stats["rows_exchanged_per_shard"], i, o))
        best_rows = min(r for r, _, _ in ranked)
        order = min((c for c in ranked if c[0] <= best_rows * 1.02), key=lambda c: c[1])[2]
        if order == "input":
            return graph, np.arange(graph.num_nodes, dtype=np.int64)
    order_arr, _ = _resolve_order(graph, num_groups, order)
    return relabel_graph(graph, order_arr)


def _edge_balanced_bounds(graph: Graph, order: np.ndarray, num_shards: int) -> list[int]:
    """Contiguous position ranges over ``order`` balanced by edge count."""
    n = graph.num_nodes
    degrees = graph.degrees.cpu().numpy().astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(degrees[order])])
    target = graph.num_edges / num_shards
    bounds = [0]
    for s in range(1, num_shards):
        b = int(np.searchsorted(cum, s * target, side="left"))
        bounds.append(min(max(b, bounds[-1]), n))
    bounds.append(n)
    return bounds


def _bounds(graph: Graph, num_shards: int, order: np.ndarray, lpa_bounds, bounds: str):
    """``(bounds, rows)``: the shards' position ranges and, for equal-node
    bounds, their fixed stride."""
    if bounds == "equal_nodes":
        rows = _round_up(max(-(-graph.num_nodes // num_shards), 1), 8)
        return np.minimum(np.arange(num_shards + 1) * rows, graph.num_nodes), rows
    if lpa_bounds is not None:
        return lpa_bounds, None
    return _edge_balanced_bounds(graph, order, num_shards), None


def partition_comm_rows(graph: Graph, num_shards: int, order=None, sizing: str = "global",
                        hub_threshold: int | None = None, _resolved: tuple | None = None,
                        bounds: str = "edges") -> dict:
    """A candidate partition's boundary rows per shard, the count
    :meth:`NodePartition.comm_stats` reports, without building the plan
    (one O(E log E) pass). ``_resolved`` is a resolved ``(order, lpa
    bounds)`` pair; ``bounds="equal_nodes"`` counts fixed equal-node ranges,
    the plan after :func:`locality_relabel`."""
    n = graph.num_nodes
    s_num = num_shards
    _, edge_dst, edge_src = _host_csr(graph)
    degrees = graph.degrees.cpu().numpy().astype(np.int64)
    order_arr, lpa_bounds = (_resolved if _resolved is not None
                             else _resolve_order(graph, num_shards, order))
    bnd, _ = _bounds(graph, num_shards, order_arr, lpa_bounds, bounds)
    pos_of = np.empty(n, dtype=np.int64)
    pos_of[order_arr] = np.arange(n)
    owner_of = (np.searchsorted(bnd, np.arange(n), side="right") - 1)[pos_of]

    hub_k = 0
    is_hub = np.zeros(n, dtype=bool)
    if hub_threshold is not None:
        is_hub = degrees >= int(hub_threshold)
        if is_hub.any():
            hub_k = _round_up(int(np.bincount(owner_of[is_hub], minlength=s_num).max()), 8)

    src_o, dst_o = owner_of[edge_src], owner_of[edge_dst]
    bmask = (src_o != dst_o) & ~is_hub[edge_dst]
    # Unique (requesting shard, dst node) pairs -> per-(s, t) request counts.
    uniq = np.unique(src_o[bmask] * np.int64(n) + edge_dst[bmask])
    us = uniq // n
    ud = owner_of[uniq - us * n]
    cnt = np.bincount(us * s_num + ud, minlength=s_num * s_num).reshape(s_num, s_num)
    if sizing == "global":
        pairwise = (s_num - 1) * _round_up(max(int(cnt.max()), 1) if cnt.size else 1, 8)
    else:
        pairwise = sum(
            _round_up(max(max(int(cnt[s, (s + o) % s_num]) for s in range(s_num)), 1), 8)
            for o in range(1, s_num))
    return {
        "order": order if isinstance(order, str) or order is None else "explicit",
        "sizing": sizing,
        "hub_threshold": hub_threshold,
        "hub_rows_per_shard": hub_k,
        "rows_exchanged_per_shard": pairwise + (s_num - 1) * hub_k,
        "rows_psum_equivalent": n,
    }


def auto_partition_plan(graph: Graph, num_shards: int, orders: tuple = ("input", "bfs", "lpa"),
                        hub_quantiles: tuple = (None, 0.999),
                        sizings: tuple = ("global", "per_offset"),
                        tie_tolerance: float = 0.02) -> dict:
    """Sweep order x hub threshold x sizing and pick the least traffic;
    candidates within ``tie_tolerance`` of the best go to the simplest
    (input before bfs before lpa, no hub before hub, global before per
    offset), so a structureless graph gets the plain input-order plan.
    Returns ``{"order", "sizing", "hub_threshold", "stats", "candidates"}``."""
    degrees = graph.degrees.cpu().numpy()
    hubs: list[int | None] = []
    for q in hub_quantiles:
        if q is None:
            hubs.append(None)
            continue
        thr = int(np.quantile(degrees, q))
        # A hub lever pays only for a small, genuinely heavy set.
        if thr > max(8, int(np.median(degrees)) * 4) and (degrees >= thr).any():
            if thr not in hubs:
                hubs.append(thr)
    if not hubs:
        hubs = [None]
    rank_of = {"order": {o: i for i, o in enumerate(orders)},
               "sizing": {s: i for i, s in enumerate(sizings)}}
    # Resolve each order once (BFS and LPA are whole-graph passes).
    resolved = {o: _resolve_order(graph, num_shards, o) for o in orders}
    candidates = []
    for o in orders:
        for hub in hubs:
            for sz in sizings:
                stats = partition_comm_rows(graph, num_shards, order=o, sizing=sz,
                                            hub_threshold=hub, _resolved=resolved[o])
                rank = (rank_of["order"].get(o, 99), 0 if hub is None else 1,
                        rank_of["sizing"].get(sz, 99))
                candidates.append((stats["rows_exchanged_per_shard"], rank, o, sz, hub, stats))
    best_rows = min(c[0] for c in candidates)
    viable = [c for c in candidates if c[0] <= best_rows * (1 + tie_tolerance)]
    viable.sort(key=lambda c: (c[1], c[0]))
    _, _, o, sz, hub, stats = viable[0]
    return {"order": o, "sizing": sz, "hub_threshold": hub, "stats": stats,
            "candidates": [c[5] for c in sorted(candidates, key=lambda c: c[0])]}


def build_node_partition(graph: Graph, num_shards: int, halo_chunks: int = 4,
                         sizing: str = "global", hub_threshold: int | None = None,
                         order=None, bounds: str = "edges") -> NodePartition:
    """The halo-exchange plan, built on the host (numpy), equal array for
    array to JAX's.

    ``sizing``: ``"global"`` (chunked all-to-all, every pair padded to the
    worst) or ``"per_offset"`` (``S - 1`` rounds, each padded to its own
    worst pair). ``hub_threshold``: nodes of degree at least this travel by
    one all-gather. ``order``: ``None``/``"input"``, ``"bfs"``, ``"lpa"``, a
    permutation, or ``"auto"`` (:func:`auto_partition_plan`, whose winners
    override ``sizing`` and ``hub_threshold``). ``bounds``: ``"edges"``
    (edge-balanced ranges) or ``"equal_nodes"`` (``round_up(ceil(N / S),
    8)``-node ranges in input order, the node-sharded store's ownership; it
    requires input order). An int8 table is dequantized here, once."""
    if bounds not in ("edges", "equal_nodes"):
        raise ValueError(f"unknown bounds {bounds!r}")
    reject_lazy_descriptor(
        graph.features,
        "build_node_partition (the halo h0 payload would stack N*F zeros; "
        "the full-graph/halo paths need eagerly loaded features)")
    if bounds == "equal_nodes" and not (order is None or (isinstance(order, str)
                                                          and order == "input")):
        raise ValueError(
            "bounds='equal_nodes' requires input order — ownership is "
            "id-range based (feature-store compatibility)")
    if isinstance(order, str) and order == "auto":
        plan = auto_partition_plan(graph, num_shards)
        order, sizing, hub_threshold = plan["order"], plan["sizing"], plan["hub_threshold"]
    if sizing not in ("global", "per_offset"):
        raise ValueError(f"unknown sizing {sizing!r}")
    indptr, edge_dst, _ = _host_csr(graph)
    n = graph.num_nodes
    degrees = indptr[1:] - indptr[:-1]

    order, lpa_bounds = _resolve_order(graph, num_shards, order)
    pos_of = np.empty(n, dtype=np.int64)
    pos_of[order] = np.arange(n)
    bounds, rows = _bounds(graph, num_shards, order, lpa_bounds, bounds)
    sizes = np.diff(bounds).astype(np.int32)
    np_pad = rows if rows is not None else _round_up(max(int(sizes.max()), 1), 8)
    owner_of_pos = np.searchsorted(bounds, np.arange(n), side="right") - 1
    owner_of = owner_of_pos[pos_of]  # global id -> shard
    local_of = (pos_of - np.asarray(bounds)[owner_of_pos][pos_of]).astype(np.int64)

    # Hubs: high-degree rows exchanged once by the all-gather.
    hub_k = 0
    hub_send = None
    hub_slot_of = None
    is_hub = np.zeros(n, dtype=bool)
    if hub_threshold is not None:
        is_hub = degrees >= int(hub_threshold)
        if is_hub.any():
            hub_ids = np.flatnonzero(is_hub)
            per_shard_hubs = [hub_ids[owner_of[hub_ids] == s] for s in range(num_shards)]
            hub_k = _round_up(max(len(h) for h in per_shard_hubs), 8)
            hub_send = np.zeros((num_shards, hub_k), dtype=np.int32)
            hub_slot_of = np.zeros(n, dtype=np.int64)
            for s, ids in enumerate(per_shard_hubs):
                hub_send[s, : len(ids)] = local_of[ids]
                hub_slot_of[ids] = s * hub_k + np.arange(len(ids))

    # Each shard's edges (a CSR gather over its rows).
    shard_edges = []
    for s in range(num_shards):
        rows_g = order[bounds[s]: bounds[s + 1]]
        counts = degrees[rows_g]
        total = int(counts.sum())
        row_local = np.repeat(np.arange(len(rows_g)), counts)
        within = np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                                              counts)
        shard_edges.append((row_local, edge_dst[np.repeat(indptr[rows_g], counts) + within]))

    # Pairwise boundary request sets (hubs excluded: they ride the all-gather).
    need: list[dict[int, np.ndarray]] = []
    for s in range(num_shards):
        dst = shard_edges[s][1]
        owners = owner_of[dst]
        boundary = (~is_hub[dst]) & (owners != s)
        need.append({t: np.unique(dst[boundary & (owners == t)])
                     for t in range(num_shards) if t != s})

    rounds_meta = None
    if sizing == "global":
        m = _round_up(max([1] + [len(v) for d in need for v in d.values()]), 8)
        q = m // 8
        chunks = max(1, min(int(halo_chunks), q))
        chunk_sizes = tuple(8 * (q // chunks + (1 if i < q % chunks else 0))
                            for i in range(chunks))
        chunk_starts = np.concatenate([[0], np.cumsum(chunk_sizes)]).astype(np.int64)
        send_plan = np.zeros((num_shards, num_shards, m), dtype=np.int32)
        for s in range(num_shards):
            for t, uniq in need[s].items():
                send_plan[t, s, : len(uniq)] = local_of[uniq]
    else:
        chunks, chunk_sizes, chunk_starts, m = 0, (), None, 0
        send_plan = np.zeros((num_shards, num_shards, 1), dtype=np.int32)
        rounds_meta = []
        for o in range(1, num_shards):
            m_o = _round_up(max([1] + [len(need[s][(s + o) % num_shards])
                                       for s in range(num_shards)]), 8)
            send_o = np.zeros((num_shards, m_o), dtype=np.int32)
            for t in range(num_shards):
                uniq = need[(t - o) % num_shards][t]
                send_o[t, : len(uniq)] = local_of[uniq]
            rounds_meta.append({"offset": o, "size": m_o, "send": send_o})
            m += m_o

    # Each edge's group (-1 local, -2 hub, else its chunk or round) and slot.
    local_lists, hub_lists, halo_lists = [], [], []
    round_lists = [[] for _ in rounds_meta] if rounds_meta is not None else []
    for s in range(num_shards):
        rows_l, dst = shard_edges[s]
        cnt = len(rows_l)
        owners = owner_of[dst]
        slots = np.zeros(cnt, dtype=np.int64)
        group = np.full(cnt, -1, dtype=np.int64)
        hub_sel = is_hub[dst] & (owners != s)
        local_sel = (owners == s) & ~hub_sel
        slots[local_sel] = local_of[dst[local_sel]]
        group[hub_sel] = -2
        if hub_slot_of is not None:
            slots[hub_sel] = hub_slot_of[dst[hub_sel]]
        for t in range(num_shards):
            if t == s:
                continue
            sel = (owners == t) & ~hub_sel & ~local_sel
            if not sel.any():
                continue
            p = np.searchsorted(need[s][t], dst[sel])
            if sizing == "global":
                c = np.searchsorted(chunk_starts, p, side="right") - 1
                group[sel] = c
                slots[sel] = t * np.asarray(chunk_sizes)[c] + (p - chunk_starts[c])
            else:
                group[sel] = (t - s) % num_shards - 1  # this pair's round
                slots[sel] = p
        local_lists.append((rows_l[group == -1], slots[group == -1]))
        hub_lists.append((rows_l[group == -2], slots[group == -2]))
        if sizing == "global":
            halo_lists.append([(rows_l[group == c], slots[group == c]) for c in range(chunks)])
        else:
            for i in range(len(rounds_meta)):
                round_lists[i].append((rows_l[group == i], slots[group == i]))

    def pack(pairs, pad_to=128):
        e = _round_up(max(1, max(len(r) for r, _ in pairs)), pad_to)
        row = np.zeros((num_shards, e), dtype=np.int32)
        slot = np.zeros((num_shards, e), dtype=np.int32)
        mask = np.zeros((num_shards, e), dtype=bool)
        for s, (r, sl) in enumerate(pairs):
            row[s, : len(r)] = r
            slot[s, : len(r)] = sl
            mask[s, : len(r)] = True
        return row, slot, mask

    edge_local_row, edge_local_slot, edge_local_mask = pack(local_lists)
    if sizing == "global":
        eh = _round_up(max(1, max(len(r) for per in halo_lists for r, _ in per)), 128)
        edge_halo_row = np.zeros((num_shards, chunks, eh), dtype=np.int32)
        edge_halo_slot = np.zeros((num_shards, chunks, eh), dtype=np.int32)
        edge_halo_mask = np.zeros((num_shards, chunks, eh), dtype=bool)
        for s in range(num_shards):
            for c, (r, sl) in enumerate(halo_lists[s]):
                edge_halo_row[s, c, : len(r)] = r
                edge_halo_slot[s, c, : len(r)] = sl
                edge_halo_mask[s, c, : len(r)] = True
        rounds = None
    else:
        edge_halo_row = np.zeros((num_shards, 1, 1), dtype=np.int32)
        edge_halo_slot = np.zeros((num_shards, 1, 1), dtype=np.int32)
        edge_halo_mask = np.zeros((num_shards, 1, 1), dtype=bool)
        rounds = tuple(OffsetRound(meta["offset"], meta["size"], meta["send"], *pack(per))
                       for meta, per in zip(rounds_meta, round_lists))

    hub_arrays = dict(hub_send=None, edge_hub_row=None, edge_hub_slot=None, edge_hub_mask=None)
    if hub_send is not None:
        ehub = pack(hub_lists)
        hub_arrays = dict(hub_send=hub_send, edge_hub_row=ehub[0], edge_hub_slot=ehub[1],
                          edge_hub_mask=ehub[2])

    feats = graph.features
    feats = (torch.from_numpy(dense_host_view(feats)) if is_quantized(feats)
             else feats.detach().cpu())
    labels = graph.labels.cpu().numpy()
    h0 = torch.zeros((num_shards, np_pad, graph.num_features), dtype=feats.dtype)
    lab = np.zeros((num_shards, np_pad, *labels.shape[1:]), labels.dtype)
    node_mask = np.zeros((num_shards, np_pad), bool)
    stacked_index = np.zeros(n, np.int64)
    for s in range(num_shards):
        rows_g = order[bounds[s]: bounds[s + 1]]
        sz = len(rows_g)
        h0[s, :sz] = feats[torch.from_numpy(rows_g)]
        lab[s, :sz] = labels[rows_g]
        node_mask[s, :sz] = True
        stacked_index[rows_g] = s * np_pad + np.arange(sz)

    return NodePartition(
        num_shards=num_shards, nodes_per_shard=np_pad, halo_size=m,
        halo_chunks=chunks if sizing == "global" else 0, chunk_sizes=chunk_sizes,
        sizes=sizes, node_order=order.astype(np.int32), h0=h0, labels=lab,
        node_mask=node_mask, edge_local_row=edge_local_row,
        edge_local_slot=edge_local_slot, edge_local_mask=edge_local_mask,
        edge_halo_row=edge_halo_row, edge_halo_slot=edge_halo_slot,
        edge_halo_mask=edge_halo_mask, send_plan=send_plan,
        stacked_index=stacked_index.astype(np.int32), rounds=rounds, hub_k=hub_k,
        **hub_arrays)


# --------------------------------------------------------------------------
# One rank's slice
# --------------------------------------------------------------------------

class Segment(NamedTuple):
    """One collective's part of a rank's combined source buffer."""

    kind: str  # "hub" (all-gather), "chunk" (all-to-all) or "round" (ppermute)
    rows: int  # the rows it adds to the buffer
    sent: int  # the rows this rank sends for it
    offset: int = 0  # a round's ppermute offset


@dataclasses.dataclass(frozen=True)
class HaloShard:
    """Rank ``rank``'s part of a :class:`NodePartition` on its device.

    The combined source buffer has ``width`` rows: the ``Np`` local rows,
    then one :class:`Segment` per collective, in order. ``send_idx`` holds
    the local rows this rank sends, the segments' send lists back to back (a
    chunk's ``S`` blocks, one per destination), and ``send_mask`` marks the
    slots a receiver's edge reads (padding and unread hub rows are False).
    ``indptr``/``cols`` is the CSR of the valid edges over the buffer (the
    degrees are the valid counts), ``edge_rows`` each edge's row,
    ``t_indptr``/``t_cols`` its transpose over the buffer's rows."""

    rank: int
    num_shards: int
    nodes_per_shard: int
    width: int
    segments: tuple
    h0: torch.Tensor
    labels: torch.Tensor
    node_mask: torch.Tensor
    send_idx: torch.Tensor  # [T, 1] int32 (kernel 2's layout)
    send_mask: torch.Tensor  # [T, 1] bool
    indptr: torch.Tensor
    cols: torch.Tensor
    edge_rows: torch.Tensor
    t_indptr: torch.Tensor
    t_cols: torch.Tensor
    count: torch.Tensor  # [Np] f32 valid count


def _used(slots: np.ndarray, mask: np.ndarray, size: int) -> np.ndarray:
    """``[size]`` bool: the slots some valid edge reads."""
    used = np.zeros(size, bool)
    used[slots[mask]] = True
    return used


def _local_shard(part: NodePartition, s: int, device) -> HaloShard:
    S, np_ = part.num_shards, part.nodes_per_shard
    groups = [(part.edge_local_row[s], part.edge_local_slot[s], part.edge_local_mask[s])]
    segments, sends, masks = [], [], []
    width = np_
    if part.hub_k:
        k = part.hub_k
        groups.append((part.edge_hub_row[s], part.edge_hub_slot[s] + width,
                       part.edge_hub_mask[s]))
        used = np.zeros(S * k, bool)
        for r in range(S):
            used |= _used(part.edge_hub_slot[r], part.edge_hub_mask[r], S * k)
        segments.append(Segment("hub", S * k, k))
        sends.append(part.hub_send[s])
        masks.append(used[s * k:(s + 1) * k])
        width += S * k
    if part.rounds is None:
        start = 0
        for c, mc in enumerate(part.chunk_sizes):
            groups.append((part.edge_halo_row[s, c], part.edge_halo_slot[s, c] + width,
                           part.edge_halo_mask[s, c]))
            # Receiver d reads owner s's block at its slots s * mc + p.
            used = np.stack([_used(part.edge_halo_slot[d, c], part.edge_halo_mask[d, c],
                                   S * mc)[s * mc:(s + 1) * mc] for d in range(S)])
            segments.append(Segment("chunk", S * mc, S * mc))
            sends.append(part.send_plan[s][:, start:start + mc].reshape(-1))
            masks.append(used.reshape(-1))
            start += mc
            width += S * mc
    else:
        for r in part.rounds:
            groups.append((r.edge_row[s], r.edge_slot[s] + width, r.edge_mask[s]))
            d = (s - r.offset) % S  # the receiver of this rank's rows
            segments.append(Segment("round", r.size, r.size, r.offset))
            sends.append(r.send[s])
            masks.append(_used(r.edge_slot[d], r.edge_mask[d], r.size))
            width += r.size
    rows = np.concatenate([g[0][g[2]] for g in groups]).astype(np.int64)
    cols = np.concatenate([g[1][g[2]] for g in groups]).astype(np.int64)
    by_row = np.argsort(rows, kind="stable")
    by_col = np.argsort(cols, kind="stable")
    deg = np.bincount(rows, minlength=np_)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    t_indptr = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=width))])
    send_ids = np.concatenate(sends).astype(np.int64) if sends else np.zeros(0, np.int64)
    send_mask = np.concatenate(masks) if masks else np.zeros(0, bool)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return HaloShard(
        rank=s, num_shards=S, nodes_per_shard=np_, width=width,
        segments=tuple(segments),
        h0=part.h0[s].to(device), labels=torch.from_numpy(part.labels[s]).to(device),
        node_mask=torch.from_numpy(part.node_mask[s]).to(device),
        send_idx=put(send_ids[:, None], torch.int32),
        send_mask=put(send_mask[:, None], torch.bool),
        indptr=put(indptr, torch.int32), cols=put(cols[by_row], torch.int32),
        edge_rows=put(rows[by_row], torch.int64),
        t_indptr=put(t_indptr, torch.int32), t_cols=put(rows[by_col], torch.int32),
        count=put(deg, torch.float32))


# --------------------------------------------------------------------------
# The exchange
# --------------------------------------------------------------------------

class _SendRows(torch.autograd.Function):
    """``h[send_ids]``, every row the rank sends; the backward adds the
    returned cotangents into ``h``'s gradient with Hopper kernel 2's sum mode,
    skipping the unread (padded) slots."""

    @staticmethod
    def forward(ctx, h, shard):
        ctx.shard, ctx.num_rows, ctx.dtype = shard, h.shape[0], h.dtype
        return h.index_select(0, shard.send_idx[:, 0])

    @staticmethod
    def backward(ctx, g):
        sh = ctx.shard
        d = scatter_mean(g.to(torch.float32).contiguous(), sh.send_idx, sh.send_mask,
                         ctx.num_rows, normalize=False)
        return d.to(ctx.dtype), None


def exchange_buffer(h: torch.Tensor, shard: HaloShard, group) -> torch.Tensor:
    """The combined source buffer ``[width, F]``: ``h``'s rows, then what the
    hub all-gather, the all-to-all chunks or the ppermute rounds bring.
    Differentiable in ``h``."""
    parts = [h]
    if shard.segments:
        sent = _SendRows.apply(h, shard)
        for seg, piece in zip(shard.segments,
                              torch.split(sent, [seg.sent for seg in shard.segments])):
            if seg.kind == "hub":
                parts.append(collectives.AllGatherRows.apply(piece, group))
            elif seg.kind == "chunk":
                parts.append(collectives.AllToAllRows.apply(piece, group))
            else:
                parts.append(collectives.PermuteRows.apply(piece, group, seg.offset))
    return torch.cat(parts)


class _BufferMean(torch.autograd.Function):
    """The guarded mean of each local row's edges over the buffer: kernel 3
    (``normalize=True``), f32 sums rounded once to the buffer's dtype. The
    backward divides ``g`` by ``max(deg, 1)`` in f32, rounds it to the
    buffer's dtype (as the single-device SpMM's backward does, so a bf16
    model moves bf16 rows both ways) and runs kernel 3 unnormalised over the
    transposed CSR (f32 sums, rounded once)."""

    @staticmethod
    def forward(ctx, buf, shard):
        ctx.shard = shard
        return spmm_block_sum(buf.contiguous(), shard.indptr, shard.cols, normalize=True)

    @staticmethod
    def backward(ctx, g):
        sh = ctx.shard
        gs = (g.to(torch.float32) / sh.count.clamp(min=1.0)[:, None]).to(g.dtype)
        return spmm_block_sum(gs.contiguous(), sh.t_indptr, sh.t_cols), None


def halo_spmm_mean(shard: HaloShard, h_local: torch.Tensor, group
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Halo-exchanged mean aggregation: ``(mean [Np, F] in h's dtype, valid
    count [Np] f32)``."""
    return _BufferMean.apply(exchange_buffer(h_local, shard, group), shard), shard.count


def halo_segment_max(shard: HaloShard, h_local: torch.Tensor, group) -> torch.Tensor:
    """Halo-exchanged guarded segment max ``[Np, F]`` (rows without a valid
    edge give 0)."""
    buf = exchange_buffer(h_local, shard, group)
    return segment_max_csr(gather(buf, shard.cols), shard.edge_rows,
                           torch.ones_like(shard.edge_rows, dtype=torch.bool),
                           shard.nodes_per_shard)


@dataclasses.dataclass(frozen=True)
class _LocalView:
    """What :meth:`GraphSAGE.forward_full_graph` reads of a graph when both
    aggregations are overridden: the rank's rows."""

    features: torch.Tensor


def halo_full_graph_logits(model: GraphSAGE, part: NodePartition, mesh, axis: str = "graph",
                           h0: torch.Tensor | None = None, return_embeddings: bool = False,
                           stacked: bool = False, shard: HaloShard | None = None
                           ) -> torch.Tensor:
    """Full-graph logits with halo-exchanged aggregation, equal (allclose) to
    :meth:`GraphSAGE.forward_full_graph` for mean and maxpool models and
    every combine mode.

    ``h0`` overrides the rank's ``[Np, F]`` rows; ``shard`` is its
    :class:`HaloShard` (built on the model's device when not given).
    ``return_embeddings`` skips the head. ``stacked=True`` returns this
    rank's ``[Np, ·]`` rows (global node ``v`` sits at position
    ``part.stacked_index[v] - rank * Np`` of rank ``stacked_index[v] //
    Np``); otherwise the rows are all-gathered and reordered to ``[N, ·]`` on
    every rank, differentiable as a replicated result (each rank's own rows
    take their gradient from its own cotangent)."""
    if model.aggregator == "lstm":
        raise ValueError(
            "halo full-graph execution supports mean and maxpool only — an "
            "LSTM over neighbor sequences is not a per-edge segment "
            "reduction the boundary exchange can carry; train lstm models "
            "on the sampled paths"
        )
    group = mesh.get_group(axis)
    if shard is None:
        shard = part.local(axis_index(mesh, axis), model.device)
    h = shard.h0 if h0 is None else h0
    out = model.forward_full_graph(
        _LocalView(features=h), return_embeddings=return_embeddings,
        spmm_override=lambda x: halo_spmm_mean(shard, x, group),
        segmax_override=lambda p: halo_segment_max(shard, p, group))
    if stacked:
        return out
    flat = collectives.AllGatherRows.apply(out, group, True)
    return flat[torch.from_numpy(part.stacked_index.astype(np.int64)).to(flat.device)]

