"""Static-shape graph container: the PyTorch counterpart of
``graphsage_tpu/data/graph.py``.

Two adjacency views, with the same padding rules as the JAX package so that
every array is identical from the same edges:

* **ELL / padded rows** — ``neighbors[N, W]``, the sampler's fast path. ``W``
  is the max degree rounded up to ``degree_pad_multiple`` and capped at
  ``ell_width_cap``. When the cap truncates (``ell_covers_all == False``) the
  sampler resolves slots through CSR instead.
* **CSR** — ``indptr[N+1]`` + ``edge_dst[E_pad]`` (+ ``edge_src`` as COO rows
  and ``edge_mask``). Always complete; padded to ``edge_pad_multiple`` with
  ``edge_src=N-1``, ``edge_dst=0``, ``edge_mask=False``. Feeds the full-graph
  CSR SpMM.

:func:`with_cached_layer0` attaches the precomputed full-neighborhood feature
means behind ``GraphSAGE(layer0="cached")``; :func:`quantize_graph` swaps the
feature table for an int8 :class:`~graphsage_torch.ops.quantize.QuantizedTable`;
:func:`disjoint_union` puts several graphs side by side in one;
:func:`induced_subgraph` keeps the part of a graph on some of its nodes;
:func:`relabel_graph` permutes its node ids; :func:`row_block` cuts the CSR
rows the full-graph loss reads, with their whole neighbour lists.

A lazy graph (``load_*_lazy``) carries a zero-strided feature descriptor
instead of a table (:func:`is_lazy_descriptor`); every function here that
would read the table refuses it (:func:`reject_lazy_descriptor`).

Indices are int32 throughout, as in the JAX ``Graph``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, Sequence

import numpy as np
import torch

from graphsage_torch._device import resolve_device
from graphsage_torch.ops.quantize import (
    QuantizedTable,
    dense_host_view,
    dequantize,
    is_quantized,
    quantize_features,
    quantize_rows,
)
from graphsage_torch.ops.spmm import spmm_mean
from graphsage_torch.utils import profiling


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded graph of tensors plus static metadata."""

    neighbors: torch.Tensor  # int32 [num_nodes, ell_width], padded with 0
    degrees: torch.Tensor  # int32 [num_nodes], TRUE degrees (CSR row lengths)
    indptr: torch.Tensor  # int32 [num_nodes + 1]
    edge_dst: torch.Tensor  # int32 [num_edges_pad] (CSR column indices)
    edge_src: torch.Tensor  # int32 [num_edges_pad] (COO row per edge)
    edge_mask: torch.Tensor  # bool  [num_edges_pad] (False on padding)
    features: torch.Tensor | QuantizedTable  # float or int8 [num_nodes, num_features]
    labels: torch.Tensor  # int32 [num_nodes], or int8 multi-hot [num_nodes, C]

    num_nodes: int
    num_features: int
    num_classes: int
    max_degree: int  # = ELL width
    num_edges: int  # directed edge slots in use
    # True when the ELL width covers every row's full neighbor list.
    ell_covers_all: bool = True
    # True when the adjacency is symmetric (built undirected, no truncation).
    symmetric: bool = True
    # with_cached_layer0's [N, F] table of full-neighborhood feature means
    # (dense or int8), and whether it folds each node in (the self_loop flavor).
    layer0_cache: torch.Tensor | QuantizedTable | None = None
    layer0_cache_self_loop: bool = False

    def __repr__(self) -> str:
        return (
            f"Graph(N={self.num_nodes}, F={self.num_features}, "
            f"C={self.num_classes}, E={self.num_edges}, "
            f"max_deg={self.max_degree}, device={self.device})"
        )

    @property
    def device(self) -> torch.device:
        return self.features.device

    @property
    def on_host(self) -> bool:
        """True when the graph lies on the CPU: the graphs the node-sharded
        trainers cut their ranks' rows from (the JAX package's host
        graphs)."""
        return self.device.type == "cpu"

    def _tables(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), (torch.Tensor, QuantizedTable))}

    def to(self, device) -> "Graph":
        """A copy with every tensor (and int8 table) on ``device`` (metadata
        unchanged). A lazy graph's descriptor moves to no other device."""
        if torch.device("cuda" if device is None else device) != self.device:
            reject_lazy_descriptor(self.features, "Graph.to (it would place N*F zeros)")
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{name: t.to(dev) for name, t in self._tables().items()})

    @property
    def nbytes(self) -> int:
        """Device bytes of every array the graph holds (int8 tables count
        their scales)."""
        return sum(t.nbytes for t in self._tables().values())


def is_lazy_descriptor(features) -> bool:
    """True for the zero-strided feature placeholder of a lazy graph
    (``load_*_lazy``): a 2-D tensor or array of shape ``[N, F]`` (``N >
    1``) whose rows all alias one row of zeros, ``O(F)`` real bytes: a shape
    and dtype descriptor, never feature data."""
    if isinstance(features, torch.Tensor):
        return features.dim() == 2 and features.shape[0] > 1 and features.stride(0) == 0
    return (isinstance(features, np.ndarray) and features.ndim == 2
            and features.shape[0] > 1 and features.strides[0] == 0)


def reject_lazy_descriptor(features, what: str) -> None:
    """Raise when a lazy graph's descriptor is about to be read as data:
    training or serving on ``N*F`` zeros without an error is the failure the
    lazy path must never have."""
    if is_lazy_descriptor(features):
        raise ValueError(
            f"this graph's features are a LAZY descriptor (load_*_lazy) — "
            f"{what} would silently read N*F zeros. Build the sharded "
            "store with shard_features_from_loader(row_loader, ...) and "
            "pass it as feature_store=, or load eagerly instead"
        )


@dataclasses.dataclass(frozen=True)
class RowBlock:
    """Some rows of a graph's CSR adjacency, each with its whole neighbour
    list in the graph's order (so its degree and mean are the graph's), the
    rows the full-graph loss reads (:func:`row_block`). On a symmetric graph
    it carries the CSR of its transpose ``A[:, rows]``: every node's
    neighbours among ``rows``, as local ids, which sends a gradient of the
    block's rows back to the table's."""

    rows: torch.Tensor  # int64 [R], ascending
    degrees: torch.Tensor  # int32 [R]
    indptr: torch.Tensor  # int32 [R + 1]
    edge_dst: torch.Tensor  # int32 [num_edges] (global ids)
    edge_src: torch.Tensor  # int32 [num_edges] (local row per edge)
    edge_mask: torch.Tensor  # bool [num_edges], all True (no padding)
    num_edges: int
    # (indptr [N + 1], local ids [num_edges]) of A[:, rows], or None.
    transpose: tuple[torch.Tensor, torch.Tensor] | None

    @property
    def num_rows(self) -> int:
        return self.rows.numel()


def row_block(graph: Graph, rows: torch.Tensor) -> RowBlock:
    """The :class:`RowBlock` of ``graph`` over the distinct ascending node ids
    ``rows``, built on the graph's device by masking its edge list in CSR
    order (no sort); the transpose only where ``graph.symmetric``."""
    dev, n, e = graph.indptr.device, graph.num_nodes, graph.num_edges
    rows = rows.to(dev, torch.int64)
    is_row = torch.zeros(n, dtype=torch.bool, device=dev)
    is_row[rows] = True
    local = torch.full((n,), -1, dtype=torch.int32, device=dev)
    local[rows] = torch.arange(rows.numel(), dtype=torch.int32, device=dev)
    src, dst = graph.edge_src[:e], graph.edge_dst[:e]
    keep = is_row[src]
    degrees = graph.degrees[rows]
    indptr = torch.zeros(rows.numel() + 1, dtype=torch.int32, device=dev)
    torch.cumsum(degrees, 0, dtype=torch.int32, out=indptr[1:])
    edge_src = local[src[keep]]
    num_edges = edge_src.numel()
    transpose = None
    if graph.symmetric:
        hit = is_row[dst]
        ends = torch.zeros(e + 1, dtype=torch.int32, device=dev)
        torch.cumsum(hit, 0, dtype=torch.int32, out=ends[1:])
        transpose = (ends[graph.indptr], local[dst[hit]])
    return RowBlock(rows=rows, degrees=degrees, indptr=indptr, edge_dst=dst[keep],
                    edge_src=edge_src,
                    edge_mask=torch.ones(num_edges, dtype=torch.bool, device=dev),
                    num_edges=num_edges, transpose=transpose)


def quantize_graph(graph: Graph) -> Graph:
    """A copy of ``graph`` whose feature table is an int8
    :class:`~graphsage_torch.ops.quantize.QuantizedTable` (a quarter of the
    f32 bytes, int8 deepest-hop gathers), on the graph's device.

    Valid because the table is frozen (quirk Q12): quantization happens once,
    here. Idempotent. A layer-0 cache built from the dense features would no
    longer be the mean of these rows: it is dropped, with a warning, and the
    trainer rebuilds it (int8) from the quantized table.
    """
    if is_quantized(graph.features):
        return graph
    reject_lazy_descriptor(graph.features,
                           "quantize_graph (use shard_features_from_loader(quantize=True))")
    if graph.layer0_cache is not None:
        warnings.warn(
            "quantize_graph: dropping the pre-built layer0_cache (it was "
            "computed from the un-quantized features); the trainer will "
            "rebuild it int8; quantize first to pay the build once",
            stacklevel=2,
        )
    return dataclasses.replace(
        graph, features=quantize_features(graph.features), layer0_cache=None,
        layer0_cache_self_loop=False,
    )


def with_cached_layer0(graph: Graph, self_loop: bool = False, dtype=None,
                       quantize: bool = False, edge_block: int = 2_000_000) -> Graph:
    """A copy of ``graph`` carrying ``layer0_cache``: ``M = D^-1 A X``, or
    ``(A X + X) / (D + 1)`` with ``self_loop``; zero-degree rows are 0
    (``X`` with ``self_loop``).

    The feature table is frozen (quirk Q12) and the mean is linear, so the
    deepest hop's full-neighborhood aggregate is a constant per node: the
    cache is what sampling that hop estimates (the reference's
    ``num_sample=None``, quirk Q7, at the input-closest layer).

    On the card it is the CSR SpMM, Hopper kernel 3 (bf16 rows read as they
    are, f32 sums, no per-edge transient, so ``edge_block`` has nothing to
    bound there): normalised by the kernel, or summed and then folded with
    ``X`` for ``self_loop``; an int8 table is dequantized into one f32
    transient first. On the CPU it is built in node-range blocks whose CSR
    span is at most ``edge_block`` edges (a node wider than that gets a
    block of its own), each block's neighbour rows gathered, dequantized
    when int8, and summed in f32 (:func:`_host_layer0_means`): the transient
    is ``edge_block x F`` f32, not ``E x F``.

    ``dtype`` defaults to the dense features' dtype (bf16 features keep a
    bf16 cache; an int8 table gives an f32 one); ``quantize=True`` stores
    the cache as an int8 ``QuantizedTable`` instead. Idempotent for the same
    flavor and kind; a cache of the other flavor or kind raises.
    """
    if graph.layer0_cache is not None:
        if graph.layer0_cache_self_loop != bool(self_loop):
            raise ValueError(
                "graph already carries a layer0_cache with self_loop="
                f"{graph.layer0_cache_self_loop}; rebuild from the base graph "
                "(dataclasses.replace(graph, layer0_cache=None)) to switch "
                "flavors"
            )
        if bool(quantize) != is_quantized(graph.layer0_cache):
            kind = "quantized" if is_quantized(graph.layer0_cache) else "dense"
            raise ValueError(
                f"graph already carries a {kind} layer0_cache but "
                f"quantize={quantize} was requested; rebuild from the base "
                "graph (dataclasses.replace(graph, layer0_cache=None)) to switch"
            )
        return graph
    reject_lazy_descriptor(graph.features, "with_cached_layer0")
    quantized = is_quantized(graph.features)
    if dtype is None:
        dtype = torch.float32 if quantized else graph.features.dtype
    if graph.on_host:
        cache = torch.from_numpy(_host_layer0_means(graph, self_loop, edge_block))
    else:
        x = dequantize(graph.features) if quantized else graph.features
        with torch.no_grad():
            if self_loop:
                summed = spmm_mean(x, graph.indptr, graph.edge_dst, normalize=False)
                deg = graph.degrees.to(torch.float32)[:, None]
                cache = (summed.to(torch.float32) + x.to(torch.float32)) / (deg + 1.0)
            else:
                cache = spmm_mean(x, graph.indptr, graph.edge_dst)
    cache = quantize_rows(cache) if quantize else cache.to(dtype)
    return dataclasses.replace(
        graph, layer0_cache=cache, layer0_cache_self_loop=bool(self_loop))


def _host_layer0_means(graph: Graph, self_loop: bool, edge_block: int) -> np.ndarray:
    """The layer-0 means ``[N, F]`` f32 of a CPU graph, built as the JAX
    package's host build is: node ranges ``[r0, r1)`` whose CSR span is at
    most ``edge_block`` edges (``searchsorted(..., side="right") - 1``, the
    last node whose span still fits, and at least one node), each block's
    rows summed per node with ``np.add.reduceat`` in f32. The rows of a block
    are gathered into one reused buffer, the transient of the build."""
    feats = graph.features
    if is_quantized(feats):
        q, scale = feats.q.numpy(), feats.scale.numpy()

        def rows(idx, out=None):
            return np.multiply(q[idx], scale[idx], out=out, dtype=np.float32)
    elif feats.dtype == torch.float32:
        x = feats.detach().numpy()

        def rows(idx, out=None):
            # mode="clip": "raise" would buffer the output (the ids are in range)
            return x[idx] if out is None else np.take(x, idx, axis=0, out=out, mode="clip")
    else:  # bf16 has no numpy dtype: widen the block's rows in torch
        def rows(idx, out=None):
            sel = idx if isinstance(idx, slice) else torch.from_numpy(idx).long()
            block = feats[sel].to(torch.float32).numpy()
            if out is None:
                return block
            out[:] = block
            return out

    n, f = graph.num_nodes, graph.num_features
    indptr = graph.indptr.numpy().astype(np.int64)
    edge_dst = graph.edge_dst.numpy()
    deg = graph.degrees.numpy().astype(np.float32)
    out = np.zeros((n, f), np.float32)
    buf = np.empty((min(edge_block, graph.num_edges) + 1, f), np.float32)
    r0 = 0
    while r0 < n:
        r1 = int(np.searchsorted(indptr, indptr[r0] + edge_block, side="right")) - 1
        r1 = max(min(r1, n), r0 + 1)
        s0, s1 = int(indptr[r0]), int(indptr[r1])
        if buf.shape[0] < s1 - s0 + 1:  # one node wider than edge_block
            block = buf = None
            buf = np.empty((s1 - s0 + 1, f), np.float32)
        # One zero row past the block's rows keeps the empty trailing
        # segments in range; reduceat gives an empty segment its start row,
        # which the zero-degree rows below overwrite.
        block = buf[:s1 - s0 + 1]
        rows(edge_dst[s0:s1], out=block[:-1])
        block[-1] = 0.0
        starts = np.minimum(indptr[r0:r1] - s0, len(block) - 1)
        sums = np.add.reduceat(block, starts, axis=0)
        blk_deg = deg[r0:r1]
        sums[blk_deg == 0] = 0.0
        if self_loop:
            np.add(sums, rows(slice(r0, r1)), out=sums)
            np.divide(sums, blk_deg[:, None] + 1.0, out=out[r0:r1])
        else:
            np.divide(sums, np.maximum(blk_deg[:, None], 1.0), out=out[r0:r1])
        r0 = r1
    return out


def sorted_unique_edges(
    num_nodes: int,
    edges: np.ndarray,
    undirected: bool = True,
) -> np.ndarray:
    """Deduplicated directed edge array [E, 2], sorted by (src, dst).

    Self-loops are kept only if present in the input, duplicates collapse,
    and ``undirected=True`` mirrors every edge.
    """
    with profiling.phase("ingest.sort"):
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if not len(edges):
            return np.zeros((0, 2), dtype=np.int64)
        n = np.int64(num_nodes)
        k1 = edges[:, 0] * n
        k1 += edges[:, 1]
        if undirected:
            k2 = edges[:, 1] * n
            k2 += edges[:, 0]
            keys = np.concatenate([k1, k2])
        else:
            keys = k1
        keys.sort(kind="stable")
        mask = np.empty(len(keys), bool)
        mask[0] = True
        np.not_equal(keys[1:], keys[:-1], out=mask[1:])
        uniq = keys[mask]
        src = uniq // n
        dst = uniq - src * n
        return np.stack([src, dst], axis=1)


def adjacency_from_edges(num_nodes: int, edges: np.ndarray,
                         undirected: bool = True) -> list[np.ndarray]:
    """Per-row sorted neighbor lists (small-graph and test convenience)."""
    e = sorted_unique_edges(num_nodes, edges, undirected=undirected)
    counts = np.bincount(e[:, 0], minlength=num_nodes)
    return np.split(e[:, 1], np.cumsum(counts)[:-1])


def build_graph(
    features: np.ndarray,
    labels: np.ndarray,
    edges: np.ndarray | Iterable[Sequence[int]],
    num_classes: int | None = None,
    undirected: bool = True,
    max_degree: int | None = None,
    degree_pad_multiple: int = 8,
    edge_pad_multiple: int = 128,
    feature_dtype: torch.dtype = torch.float32,
    ell_width_cap: int = 256,
    device=None,
) -> Graph:
    """Construct a :class:`Graph` from host-side numpy data on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``).

    ``max_degree`` hard-truncates the graph in both views; ``ell_width_cap``
    bounds only the ELL table's width (rows longer than the cap keep their
    full neighbor lists in CSR). ``labels`` are class ids ``[N]`` or
    multi-hot rows ``[N, C]`` (kept 2-D as int8; ``num_classes`` must then
    equal ``C``). A lazy descriptor (:func:`is_lazy_descriptor`) stays one:
    a zero-strided ``[N, F]`` view of one row of zeros in ``feature_dtype``,
    on the CPU only.

    Its set-up spans (:func:`graphsage_torch.utils.profiling.phase`):
    ``ingest.build_graph`` around ``ingest.sort`` (inside
    :func:`sorted_unique_edges`), ``ingest.layout`` (degrees, ELL, CSR and
    padding on the host) and ``ingest.to_device`` (every copy to ``dev``).
    """
    dev = resolve_device(device)
    with profiling.phase("ingest.build_graph"):
        features = np.asarray(features)
        labels = np.asarray(labels)
        if labels.ndim == 2 and labels.shape[1] > 1:
            # Multi-hot [N, C] rows (multilabel / PPI family): kept 2-D, int8.
            labels = (labels != 0).astype(np.int8)
            if num_classes is None:
                num_classes = labels.shape[1]
            elif num_classes != labels.shape[1]:
                raise ValueError(
                    f"num_classes ({num_classes}) != multi-hot label width "
                    f"({labels.shape[1]})"
                )
        else:
            labels = labels.reshape(-1).astype(np.int32)
        num_nodes, num_features = features.shape
        if labels.shape[0] != num_nodes:
            raise ValueError(f"labels ({labels.shape[0]}) != num_nodes ({num_nodes})")
        if num_classes is None:
            num_classes = int(labels.max()) + 1 if num_nodes else 0

        edges = np.asarray(list(edges) if not isinstance(edges, np.ndarray) else edges)
        e = sorted_unique_edges(num_nodes, edges, undirected=undirected)
        with profiling.phase("ingest.layout"):
            src, dst = e[:, 0], e[:, 1]
            counts = np.bincount(src, minlength=num_nodes)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            rank = np.arange(len(src), dtype=np.int64) - starts[src]  # slot within row

            if max_degree is not None:
                trunc = max(
                    _round_up(max(max_degree, 1), degree_pad_multiple), degree_pad_multiple
                )
                keep = rank < trunc
                src, dst, rank = src[keep], dst[keep], rank[keep]
                counts = np.minimum(counts, trunc)
            true_degrees = counts.astype(np.int32)
            graph_max_deg = int(true_degrees.max()) if num_nodes and len(src) else 0

            ell_width = max(
                _round_up(max(min(graph_max_deg, ell_width_cap), 1), degree_pad_multiple),
                degree_pad_multiple,
            )
            ell_covers_all = ell_width >= graph_max_deg

            ell = np.zeros((num_nodes, ell_width), dtype=np.int32)
            in_ell = rank < ell_width
            ell[src[in_ell], rank[in_ell]] = dst[in_ell]

            indptr = np.zeros(num_nodes + 1, dtype=np.int32)
            np.cumsum(true_degrees, out=indptr[1:])
            num_edges = int(indptr[-1])
            e_pad = max(_round_up(max(num_edges, 1), edge_pad_multiple), edge_pad_multiple)
            edge_dst = np.zeros(e_pad, dtype=np.int32)
            edge_src = np.zeros(e_pad, dtype=np.int32)
            edge_mask = np.zeros(e_pad, dtype=bool)
            edge_dst[:num_edges] = dst
            edge_src[:num_edges] = src
            edge_mask[:num_edges] = True
            # Padding edges point at node 0 with src num_nodes-1 so segment ops stay in range.
            if num_edges < e_pad and num_nodes:
                edge_src[num_edges:] = num_nodes - 1

        def put(a):
            return torch.from_numpy(a).to(dev)

        if is_lazy_descriptor(features) and dev.type != "cpu":
            reject_lazy_descriptor(features, f"build_graph(device={str(dev)!r})")
        with profiling.phase("ingest.to_device"):
            if is_lazy_descriptor(features):
                feats = torch.zeros((1, num_features), dtype=feature_dtype).expand(
                    num_nodes, num_features)
            else:
                feats = torch.from_numpy(np.asarray(features, dtype=np.float32)).to(
                    device=dev, dtype=feature_dtype)
            return Graph(
                neighbors=put(ell),
                degrees=put(true_degrees),
                indptr=put(indptr),
                edge_dst=put(edge_dst),
                edge_src=put(edge_src),
                edge_mask=put(edge_mask),
                features=feats,
                labels=put(labels),
                num_nodes=num_nodes,
                num_features=num_features,
                num_classes=int(num_classes),
                max_degree=ell_width,
                num_edges=num_edges,
                ell_covers_all=bool(ell_covers_all),
                # Per-row truncation drops (u,v) without dropping (v,u).
                symmetric=bool(undirected and max_degree is None),
            )

def induced_subgraph(graph: Graph, nodes, device=None, **build_kwargs) -> Graph:
    """The subgraph induced on ``nodes``, ids relabeled to ``0..len-1`` in
    the order given: the inductive protocol's primitive (train on the
    subgraph, then run the same model on the grown graph; the parameters do
    not depend on the graph).

    An edge is kept when both its ends are in ``nodes``. The graph's edge
    list is already mirrored where it is symmetric, so it is rebuilt
    directed (``build_kwargs`` forward to :func:`build_graph`), and a
    symmetric graph's subgraph is symmetric again. Features go through
    :func:`~graphsage_torch.ops.quantize.dense_host_view`: an int8 table is
    dequantized and a bf16 one widened, and both come back f32 unless
    ``feature_dtype`` says otherwise, as in the JAX package. The subgraph
    lies on the graph's device unless ``device`` says otherwise.
    """
    reject_lazy_descriptor(graph.features, "induced_subgraph")
    nodes = np.asarray(nodes).reshape(-1)
    feats = dense_host_view(graph.features)[nodes]
    labels = graph.labels.cpu().numpy()[nodes]
    e = graph.num_edges
    src = graph.edge_src[:e].cpu().numpy().astype(np.int64)
    dst = graph.edge_dst[:e].cpu().numpy().astype(np.int64)
    inv = -np.ones(graph.num_nodes, np.int64)
    inv[nodes] = np.arange(len(nodes))
    keep = (inv[src] >= 0) & (inv[dst] >= 0)
    edges = np.stack([inv[src[keep]], inv[dst[keep]]], axis=1)
    build_kwargs.setdefault("undirected", False)
    sub = build_graph(feats, labels, edges, num_classes=graph.num_classes,
                      device=graph.device if device is None else device, **build_kwargs)
    if graph.symmetric and build_kwargs.get("max_degree") is None:
        sub = dataclasses.replace(sub, symmetric=True)
    return sub


def disjoint_union(graphs: Sequence[Graph], device=None, **build_kwargs) -> Graph:
    """One :class:`Graph` holding every input graph side by side, node ids
    offset so that no edge crosses inputs: the multigraph-training
    primitive of the inductive (PPI-style) protocol. Train one model over
    the union (message passing never leaks across components), then
    evaluate it on each held-out graph.

    All inputs must agree on feature width, label layout and
    ``num_classes``. The inputs' arrays are taken to the host and rebuilt
    with :func:`build_graph` (``build_kwargs`` forward to it; an int8 table
    is dequantized); the union lies on the first input's device unless
    ``device`` says otherwise. A union of symmetric graphs is symmetric.
    """
    if not graphs:
        raise ValueError("disjoint_union of no graphs")
    g0 = graphs[0]
    for g in graphs:
        reject_lazy_descriptor(g.features, "disjoint_union")
        if g.num_features != g0.num_features:
            raise ValueError("feature widths differ across graphs")
        if g.num_classes != g0.num_classes:
            raise ValueError("num_classes differs across graphs")
        if g.labels.dim() != g0.labels.dim():
            raise ValueError("label layouts differ across graphs")
    feats = np.concatenate([dense_host_view(g.features) for g in graphs])
    labels = np.concatenate([g.labels.cpu().numpy() for g in graphs])
    parts, offset = [], 0
    for g in graphs:
        e = g.num_edges
        src = g.edge_src[:e].cpu().numpy().astype(np.int64) + offset
        dst = g.edge_dst[:e].cpu().numpy().astype(np.int64) + offset
        parts.append(np.stack([src, dst], axis=1))
        offset += g.num_nodes
    # The inputs' edge lists are already mirrored where symmetric, so build
    # directed; the offsets move both directions of an edge together, so a
    # union of symmetric graphs is symmetric again.
    build_kwargs.setdefault("undirected", False)
    union = build_graph(feats, labels, np.concatenate(parts), num_classes=g0.num_classes,
                        device=g0.device if device is None else device, **build_kwargs)
    if all(g.symmetric for g in graphs) and build_kwargs.get("max_degree") is None:
        union = dataclasses.replace(union, symmetric=True)
    return union


def relabel_graph(graph: Graph, order, device=None) -> tuple[Graph, np.ndarray]:
    """Rebuild ``graph`` with its node ids permuted: old node ``order[i]``
    becomes new id ``i``. Returns ``(relabeled graph, perm)`` with
    ``perm[old] = new``. Features, labels and edges all move and the edge
    set is unchanged, so every order-invariant computation (the full-graph
    forward included) gives the same rows permuted: ``logits_new[perm[v]] ==
    logits_old[v]``. A symmetric graph is rebuilt from its upper triangle
    and mirrored again, so it stays symmetric. The table keeps its dtype;
    the result lies on the graph's device unless ``device`` says otherwise.

    The locality preprocessing of id-range ownership
    (:func:`graphsage_torch.parallel.halo.locality_relabel` is the one-call
    version)."""
    order = np.asarray(order, dtype=np.int64).reshape(-1)
    n = graph.num_nodes
    if order.shape[0] != n or len(np.unique(order)) != n:
        raise ValueError("order must be a permutation of all node ids")
    reject_lazy_descriptor(graph.features, "relabel_graph")
    if is_quantized(graph.features):
        raise ValueError(
            "relabel before quantizing: per-row scales move with their rows, "
            "so quantize_graph(relabel_graph(dense_graph, order)[0]) is "
            "identical and keeps this function simple"
        )
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n, dtype=np.int64)
    feats = graph.features.detach().cpu()[torch.from_numpy(order)]
    labels = graph.labels.cpu().numpy()[order]
    e = graph.num_edges
    src = perm[graph.edge_src[:e].cpu().numpy().astype(np.int64)]
    dst = perm[graph.edge_dst[:e].cpu().numpy().astype(np.int64)]
    if graph.symmetric:
        keep = src <= dst
        edges, undirected = np.stack([src[keep], dst[keep]], axis=1), True
    else:
        edges, undirected = np.stack([src, dst], axis=1), False
    relabeled = build_graph(
        feats.to(torch.float32).numpy(), labels, edges, num_classes=graph.num_classes,
        undirected=undirected, feature_dtype=feats.dtype,
        device=graph.device if device is None else device)
    return relabeled, perm
