"""Multi-layer supervised GraphSAGE with explicit per-hop frontiers: the
counterpart of ``graphsage_tpu/models/graphsage.py``.

  1. ``sample``  — build hop frontiers seeds -> hop1 -> ... -> hopL with the
     fixed-fanout sampler (``sampling``: ``"floyd"``, ``"topk"`` or
     ``"windowed"``). Frontiers are flat ``[B * prod(k)]`` tensors; no
     deduplication.
  2. ``forward`` — layer 0, then the upper layers fold inward: reshape to
     ``[parents, k, d]``, aggregate, project, ReLU (the last layer stays
     linear under ``final_activation="linear"``, the unsupervised model's:
     every path asks :meth:`GraphSAGE.layer_activation`).
  3. a linear classification head; ``loss`` is its mean softmax
     cross-entropy, the training objective (with ``multilabel``, the mean
     sigmoid BCE over multi-hot labels).

Layer 0 runs in one of three modes (``layer0``):

* ``"sampled"`` — the deepest hop is sampled like the others. With the mean
  aggregator it is the fused masked gather-mean (Hopper kernel 1 on the
  card); maxpool and lstm gather the raw feature rows of the deepest hop.
* ``"full"`` — layer 0 runs once per step over every node with complete
  neighborhoods (:meth:`GraphSAGE.layer0_full_table`: the CSR mean-SpMM,
  Hopper kernel 3, forward and backward, or the CSR segment max), and
  the upper layers gather its rows; the deepest hop is not sampled.
* ``"cached"`` — mean only: the full-neighborhood feature means are a
  constant per node (the features are frozen), built once by
  :func:`graphsage_torch.data.graph.with_cached_layer0` and gathered at the
  hop layer 1 consumes; the deepest hop is not sampled.

Hop ``h`` is built with the fanout of layer ``L-h`` (0-based): the top
layer's fanout governs the first expansion. With ``concat_self`` or
``self_loop`` each frontier row carries the parent in column 0.

``forward_full_graph`` runs the same layers over every node with complete
neighborhoods (the mean through the CSR mean-SpMM, maxpool through the CSR
segment max, lstm over the ELL rows in adjacency order) — the
deterministic inference path behind the serving table tier and evaluation
with ``eval_fanouts=None``. With ``rows`` (a row block of the graph, the
rows the full-graph loss reads) its last layer and the head compute those
rows alone.

Reduced precision follows the JAX model cast for cast: ``compute_dtype``
(``torch.bfloat16``) runs the products in bf16 with the weights kept f32
and cast at use; the layers with an aggregation step return f32
activations, layer 0's project-first and full-graph tables stay in the
compute dtype, and logits are f32. The feature table may be an int8
:class:`~graphsage_torch.ops.quantize.QuantizedTable`
(``data.graph.quantize_graph``): its gathers dispatch on the table's type
(kernel 1's int8 route for the masked mean), project-first contracts the
raw int8 values (``project_table``), and the other paths dequantize.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graphsage_torch._device import resolve_device
from graphsage_torch.data.graph import Graph, RowBlock
from graphsage_torch.models.layers import (
    AGGREGATORS,
    SAGELayer,
    apply_full_graph_maxpool_layer,
    apply_full_graph_mean_layer,
    glorot_uniform,
    split_mean_weight,
)
from graphsage_torch.ops.aggregate import SPMM_IMPLS, gather, gather_mean, spmm_mean
from graphsage_torch.ops.quantize import (
    dequantize,
    gather_dequant,
    gather_mean_dequant,
    is_quantized,
    project_table,
)
from graphsage_torch.ops.sampling import METHODS as SAMPLING_METHODS
from graphsage_torch.ops.sampling import sample_neighbors
from graphsage_torch.ops.segment_max import segment_max, segment_max_bytes
from graphsage_torch.ops.spmm import spmm_mean_bytes
from graphsage_torch.utils import profiling


def _walked(graph: Graph, rows: RowBlock | None):
    """The CSR a full-graph aggregation walks, its row count, and the ops'
    keywords for it: ``graph``'s, or its row block's."""
    if rows is None:
        return graph, graph.num_nodes, {}
    return rows, rows.num_rows, dict(subset=True, transpose=rows.transpose)


class Frontier(NamedTuple):
    """Flattened hop frontiers. ``ids[0]`` is the seed batch; ``ids[h]`` has
    ``ids[h-1].numel() * k_h`` entries (``k_h + 1`` with a self column)."""

    ids: tuple[torch.Tensor, ...]
    masks: tuple[torch.Tensor, ...]

    @property
    def num_hops(self) -> int:
        return len(self.ids) - 1

    def to(self, device) -> "Frontier":
        return Frontier(
            ids=tuple(i.to(device) for i in self.ids),
            masks=tuple(m.to(device) for m in self.masks),
        )


LAYER0_MODES = ("sampled", "full", "cached")
# ModelConfig.compute_dtype names.
COMPUTE_DTYPES = {None: None, "bfloat16": torch.bfloat16}
# The sampled layer 0's order rule (GraphSAGE.sampled_layer0_project_first):
# on the H100 at Reddit's widths (602 -> 128, bf16) the two orders cost the
# same device time at about 2.5 slots per table row, between the 2.2 and 4.4
# measured, which puts this ratio between 1.7 and 3.5; 2 sits at the
# interpolated crossover.
LAYER0_ORDER_KAPPA = 2.0


class GraphSAGE(nn.Module):
    """Supervised GraphSAGE holding its parameters: one :class:`SAGELayer`
    per entry of ``hidden_dims`` and a ``[hidden[-1], num_classes]`` head.

    Parameters are glorot-initialised on the CPU from ``generator`` (seed 0
    when omitted) and then placed on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``). They stay f32 under any ``compute_dtype``.
    """

    def __init__(
        self,
        in_dim: int,
        num_classes: int,
        hidden_dims: Sequence[int] = (128, 128),
        fanouts: Sequence[int | None] = (10, 10),
        *,
        aggregator: str = "mean",
        concat_self: bool = False,
        self_loop: bool = False,
        pool_dim: int | None = None,
        layer0: str = "sampled",
        sampling: str = "floyd",
        compute_dtype: torch.dtype | None = None,
        multilabel: bool = False,
        final_activation: str = "relu",
        gather_impl: str = "auto",
        spmm_impl: str = "auto",
        project_first: bool | str = "auto",
        generator: torch.Generator | None = None,
        device=None,
    ):
        super().__init__()
        if len(hidden_dims) != len(fanouts):
            raise ValueError("hidden_dims and fanouts must have one entry per layer")
        if self_loop and concat_self:
            raise ValueError("self_loop and concat_self are mutually exclusive")
        if aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {aggregator!r}")
        if layer0 not in LAYER0_MODES:
            raise ValueError(f"unknown layer0 mode {layer0!r}")
        if aggregator == "lstm" and layer0 == "full":
            raise ValueError(
                "layer0='full' supports the mean and maxpool aggregators only: "
                "the shared-table build is a segment reduction over the CSR "
                "edge list, and an LSTM over every node's full neighbor "
                "sequence has no such form"
            )
        if layer0 == "cached" and aggregator != "mean":
            raise ValueError(
                "layer0='cached' requires the mean aggregator: the cache is "
                "exact only because the mean is linear in the frozen features"
            )
        if compute_dtype is not None and not (
                isinstance(compute_dtype, torch.dtype) and compute_dtype.is_floating_point):
            raise ValueError(f"compute_dtype must be a floating torch dtype, got "
                             f"{compute_dtype!r}")
        if sampling not in SAMPLING_METHODS:
            raise ValueError(f"unknown sampling method {sampling!r}")
        if final_activation not in ("relu", "linear"):
            raise ValueError(f"unknown final_activation {final_activation!r}")
        if spmm_impl not in SPMM_IMPLS:
            raise ValueError(f"unknown spmm_impl {spmm_impl!r}")
        dev = resolve_device(device)
        self.in_dim = in_dim
        self.num_classes = num_classes
        self.hidden_dims = tuple(hidden_dims)
        self.fanouts = tuple(fanouts)
        self.aggregator = aggregator
        self.concat_self = concat_self
        self.self_loop = self_loop
        self.pool_dim = pool_dim
        self.layer0 = layer0
        self.sampling = sampling
        self.multilabel = multilabel
        self.final_activation = final_activation
        self.compute_dtype = compute_dtype
        self.gather_impl = gather_impl
        self.spmm_impl = spmm_impl
        self.project_first = project_first
        with profiling.phase("model.init"):
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            layers, d_in = [], in_dim
            for d_out in self.hidden_dims:
                layers.append(SAGELayer(d_in, d_out, concat_self, generator=generator,
                                        aggregator=aggregator, pool_dim=pool_dim))
                d_in = d_out
            self.layers = nn.ModuleList(layers)
            self.head = nn.Parameter(glorot_uniform((d_in, num_classes), generator))
            self.to(dev)

    @classmethod
    def from_config(cls, cfg, in_dim: int, num_classes: int, **kwargs) -> "GraphSAGE":
        """Build from a :class:`graphsage_torch.train.config.ModelConfig`
        (``quantize_features`` is the graph's: ``run_preset`` applies it)."""
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
        return cls(
            in_dim, num_classes, cfg.hidden_dims, cfg.fanouts,
            aggregator=cfg.aggregator, concat_self=cfg.concat_self,
            self_loop=cfg.self_loop, pool_dim=cfg.pool_dim, layer0=cfg.layer0,
            sampling=cfg.sampling, final_activation=cfg.final_activation,
            compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype], gather_impl=cfg.gather_impl,
            spmm_impl=cfg.spmm_impl, project_first=cfg.project_first, **kwargs,
        )

    @property
    def num_layers(self) -> int:
        return len(self.hidden_dims)

    @property
    def device(self) -> torch.device:
        return self.head.device

    def layer_activation(self, layer: int):
        """Layer ``layer``'s output nonlinearity: ReLU, or ``None`` (linear)
        on the last layer under ``final_activation="linear"``. Every forward
        path asks here, so that the modes agree with each other."""
        if self.final_activation == "linear" and layer == self.num_layers - 1:
            return None
        return torch.relu

    def use_project_first(self, layer: int, d_in: int) -> bool:
        """Whether full-graph layer ``layer`` aggregates after projecting.
        ``"auto"`` projects whenever the layer shrinks its width (``d_in >
        d_out``), so the SpMM moves ``d_out``-wide rows: a full-graph layer
        multiplies all N rows either way. Only the mean is linear, so
        maxpool and lstm never project first."""
        if self.aggregator != "mean":
            return False
        if self.project_first == "auto":
            return d_in > self.hidden_dims[layer]
        return bool(self.project_first)

    def injected_layer0_project_first(self, quantized: bool) -> bool:
        """JAX's project-first rule for a node-sharded table's lookups (the
        ``hub_cache_rows`` check and ``sharded_comm_stats`` read it): the
        width rule (``d_in > d_out``, or ``project_first`` when it is not
        ``"auto"``) for a dense table; for an int8 table the bytes, since a
        raw row is ``F + 4`` bytes (int8 values and the scale) against a
        projected row's ``4 * d_out``."""
        if self.aggregator != "mean":
            return False
        if self.project_first != "auto":
            return bool(self.project_first)
        if not quantized:
            return self.in_dim > self.hidden_dims[0]
        return 4 * self.hidden_dims[0] < self.in_dim + 4

    def sampled_layer0_project_first(self, num_nodes: int, slots: int,
                                     exchanged_rows: int = 0, quantized: bool = False,
                                     exchanged_row_bytes: int | None = None) -> bool:
        """Whether the sampled layer 0 projects the whole ``num_nodes``-row
        table before gathering ``slots`` neighbour rows. ``"auto"`` does
        when :meth:`injected_layer0_project_first` does (the layer shrinks
        its width; over an int8 table, a projected f32 row is smaller than
        the int8 row with its scale) and

            slots * (d_in - d_out) + exchanged_rows * (row - d_out)
                >= LAYER0_ORDER_KAPPA * num_nodes * d_in:

        projecting first pays a fixed pass over the table (the product and
        its dW read all N rows of ``d_in``, and the backward scatters into
        the ``[N, d_out]`` table); aggregating first gathers ``d_in - d_out``
        more columns for each slot. ``LAYER0_ORDER_KAPPA`` is the ratio of
        the two costs per column, measured on the H100 (``PERF.md`` §5).
        A node-sharded step counts its rank's shard rows and slots, and
        ``exchanged_rows``: the layer's rows that cross to other ranks, each
        ``row = exchanged_row_bytes / 4`` f32 columns wide when aggregating
        first (``d_in`` by default; an int8 answer row is ``F + 4`` bytes),
        counted as gathered slots (a lower bound on their cost; 0 in a world
        of one, where the rule is the single device's)."""
        d_in, d_out = self.in_dim, self.hidden_dims[0]
        row = d_in if exchanged_row_bytes is None else exchanged_row_bytes / 4
        return self.injected_layer0_project_first(quantized) and (
            self.project_first != "auto"
            or slots * (d_in - d_out) + exchanged_rows * (row - d_out)
            >= LAYER0_ORDER_KAPPA * num_nodes * d_in)

    # -------------------------------------------------------------- sample
    def sample(
        self,
        generator: torch.Generator,
        graph: Graph,
        seeds: torch.Tensor,
        fanouts: Sequence[int | None] | None = None,
    ) -> Frontier:
        """Expand seed nodes into per-hop frontiers (static shapes).
        ``fanouts`` overrides the model's own (serving's ``eval_fanouts``).
        With ``layer0="full"`` or ``"cached"`` the deepest hop is skipped:
        layer 0 reads a per-node table there. Counts ``sample.hops`` and
        ``sample.slots`` (each hop's parents times its width)."""
        fanouts = self.fanouts if fanouts is None else tuple(fanouts)
        seeds = seeds.reshape(-1)
        ids = [seeds]
        masks = [torch.ones(seeds.shape, dtype=torch.bool, device=seeds.device)]
        L = self.num_layers
        hops = L - 1 if self.layer0 in ("full", "cached") else L
        for h in range(1, hops + 1):
            parent_ids, parent_mask = ids[-1], masks[-1]
            nids, nmask = sample_neighbors(
                generator, graph.neighbors, graph.degrees, parent_ids,
                fanouts[L - h], method=self.sampling,
                indptr=graph.indptr, edge_dst=graph.edge_dst,
                ell_covers_all=graph.ell_covers_all,
            )
            if profiling.recording():
                profiling.count("sample.hops", 1)
                profiling.count("sample.slots", nids.numel())
            nmask = nmask & parent_mask[:, None]
            if self.concat_self or self.self_loop:
                # Column 0 carries the parent: concat_self splits it off for
                # the concat branch; self_loop leaves it inside the mean.
                nids = torch.cat([parent_ids[:, None].to(nids.dtype), nids], dim=1)
                nmask = torch.cat([parent_mask[:, None], nmask], dim=1)
            ids.append(nids.reshape(-1))
            masks.append(nmask.reshape(-1))
        return Frontier(ids=tuple(ids), masks=tuple(masks))

    # ---------------------------------------------------- layer-0 tables
    def _spmm(self, graph: Graph, rows: RowBlock | None = None):
        """The full-graph mean over ``graph``'s CSR: ``x -> (mean, degrees)``;
        with ``rows``, over that block of it (the rows' means and degrees)."""
        csr, n, subset = _walked(graph, rows)

        def spmm(x):
            with profiling.span("agg.spmm_mean", device=x.device):
                if profiling.recording():
                    profiling.count("agg.spmm_mean.bytes", spmm_mean_bytes(
                        x.shape[0], x.shape[1], x.element_size(), csr.num_edges, n))
                mean = spmm_mean(
                    x, csr.edge_src, csr.edge_dst, csr.edge_mask, n,
                    indptr=csr.indptr, impl=self.spmm_impl,
                    symmetric=graph.symmetric, num_edges=csr.num_edges, **subset,
                )
            return mean, csr.degrees
        return spmm

    @staticmethod
    def _segmax(graph: Graph, rows: RowBlock | None = None):
        """The full-graph guarded max over ``graph``'s CSR (with ``rows``,
        over that block of it):
        :func:`graphsage_torch.ops.segment_max.segment_max`, which picks its
        route from the device (``pooled`` is a ReLU output, so a max of 0
        sends no gradient)."""
        csr, n, subset = _walked(graph, rows)

        def segmax(pooled):
            with profiling.span("agg.segment_max", device=pooled.device):
                if profiling.recording():
                    profiling.count("agg.segment_max.bytes", segment_max_bytes(
                        pooled.shape[0], pooled.shape[1], pooled.element_size(),
                        csr.num_edges, n))
                return segment_max(pooled, csr.indptr, csr.edge_dst,
                                   symmetric=graph.symmetric, **subset)
        return segmax

    def layer0_full_table(self, features, graph: Graph | None, *, spmm=None,
                          segmax=None) -> torch.Tensor:
        """The shared layer-0 table of ``layer0="full"``: layer 0 over every
        node with complete neighborhoods, ``[N, hidden[0]]`` in the compute
        dtype.

        ``spmm`` (``x -> (neighbor mean, valid count)``) and ``segmax``
        (``pooled -> guarded per-node max``) replace the ones over
        ``graph``'s CSR: the node-sharded trainers pass closures over the
        rank's own rows (an all-gather or a halo exchange first), with
        ``features`` the rank's ``[Np, F]`` rows, and get the rank's
        ``[Np, hidden[0]]`` slice of the table."""
        if self.layer0 != "full":
            raise ValueError("layer0_full_table requires layer0='full'")
        if graph is None and (spmm if self.aggregator == "mean" else segmax) is None:
            raise ValueError(
                "layer0='full' needs forward(..., graph=...): the full-graph "
                "layer 0 reads the CSR adjacency"
            )
        layer0 = self.layers[0]
        if self.aggregator != "mean":
            return apply_full_graph_maxpool_layer(
                layer0, self._dense(features),
                self._segmax(graph) if segmax is None else segmax,
                self_loop=self.self_loop, activation=self.layer_activation(0))
        spmm = self._spmm(graph) if spmm is None else spmm
        pf = self.use_project_first(0, self.in_dim)
        if not (is_quantized(features) and pf):
            return apply_full_graph_mean_layer(
                layer0, self._dense(features), spmm,
                self_loop=self.self_loop, project_first=pf,
                activation=self.layer_activation(0),
            )
        # Project-first over an int8 table: the raw values against each
        # weight slice (no dense [N, F] transient), then the same SpMM.
        h_dtype = self.compute_dtype or layer0.weight.dtype
        w_self, w_neigh = split_mean_weight(
            layer0.weight.to(h_dtype), self.in_dim, self.concat_self)
        hp = project_table(features, w_neigh).to(h_dtype)
        mean, cnt = spmm(hp)
        pre = mean.to(torch.float32)
        if self.self_loop:
            c = cnt.to(torch.float32)[:, None]
            pre = (pre * c + hp.to(torch.float32)) / (c + 1.0)
        if self.concat_self:
            pre = pre + project_table(features, w_self)
        return self._activate(0, pre).to(h_dtype)

    def _activate(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        act = self.layer_activation(layer)
        return x if act is None else act(x)

    def _dense(self, features) -> torch.Tensor:
        """The feature table as dense rows in the compute dtype (an int8
        table dequantized into a transient)."""
        if is_quantized(features):
            features = dequantize(features, self.compute_dtype or torch.float32)
        return features if self.compute_dtype is None else features.to(self.compute_dtype)

    @staticmethod
    def _gather_rows(table, ids: torch.Tensor, mask: torch.Tensor | None = None
                     ) -> torch.Tensor:
        """Row lookup, dispatched on the table's type: a dense table computed
        inside a quantized forward (the layer-0 table, the projected
        self-table) is gathered as it is. ``mask`` is the slots' validity,
        which only an injected lookup reads (the compact exchange routes
        masked slots apart)."""
        return gather_dequant(table, ids) if is_quantized(table) else gather(table, ids)

    def _gather_mean(self, table, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The fused masked mean ``[B, F]`` f32, dispatched on the table's
        type (kernel 1's int8 route, or ``gather_impl``'s)."""
        if is_quantized(table):
            return gather_mean_dequant(table, idx, mask)
        return gather_mean(table, idx, mask, impl=self.gather_impl)

    def check_layer0_cache(self, graph: Graph | None) -> torch.Tensor:
        """``graph``'s layer-0 cache, after checking that it is there and of
        this model's ``self_loop`` flavor."""
        if graph is None or graph.layer0_cache is None:
            raise ValueError(
                "layer0='cached' needs the precomputed aggregate table: pass "
                "forward(..., graph=...) where graph was built with "
                "with_cached_layer0(graph)"
            )
        if graph.layer0_cache_self_loop != self.self_loop:
            raise ValueError(
                "graph.layer0_cache was built with self_loop="
                f"{graph.layer0_cache_self_loop} but the model has self_loop="
                f"{self.self_loop}; rebuild the cache with the matching flavor"
            )
        return graph.layer0_cache

    # ------------------------------------------------------------- forward
    def forward(
        self,
        features: torch.Tensor,
        frontier: Frontier,
        return_embeddings: bool = False,
        *,
        graph: Graph | None = None,
        gather_fn=None,
        gather_mean_fn=None,
        layer0_table=None,
        layer0_out: torch.Tensor | None = None,
        exchange_ranks: int = 1,
        exchange_row_bytes: int | None = None,
    ) -> torch.Tensor:
        """Logits ``[B, num_classes]`` for the frontier's seed batch (or the
        pre-head representations with ``return_embeddings``). ``graph``
        supplies the adjacency (``layer0="full"``) or the cache
        (``layer0="cached"``); the sampled mode ignores it.

        The sharded trainers (:mod:`graphsage_torch.parallel`) inject their
        own lookups, as the JAX model's ``gather_fn``/``gather_mean_fn`` do:
        ``gather_fn(table, ids, mask)`` (rows) and ``gather_mean_fn(table, idx,
        mask)`` (the fused masked mean) replace the local ones, so that
        ``features`` may be this rank's node-range shard, and
        ``layer0_table`` replaces the graph's cache (``"cached"``) or the
        shared table (``"full"``: the rank's slice, built by the caller).
        ``exchange_ranks`` is the number of ranks those lookups exchange
        rows over, and ``exchange_row_bytes`` the bytes of a row they move
        when layer 0 aggregates first (default ``4 * in_dim``), which the
        sampled mean layer 0's order rule counts
        (:meth:`sampled_layer0_project_first`). ``layer0_out`` is layer 0's
        output at hop ``L - 1``, computed by the caller (the
        tensor-parallel layer 0): only the upper layers and the head run."""
        L, cd = self.num_layers, self.compute_dtype
        rows = gather_fn or self._gather_rows
        start = 1
        if layer0_out is not None:
            h = layer0_out
        elif self.layer0 == "cached":
            ids = frontier.ids[L - 1]
            cache = layer0_table if layer0_table is not None else self.check_layer0_cache(graph)
            mask = frontier.masks[L - 1]
            agg = rows(cache, ids, mask)
            self_h = rows(features, ids, mask) if self.concat_self else None
            h = self.layers[0](self_h, None, None, precomputed_agg=agg, compute_dtype=cd,
                               activation=self.layer_activation(0))
        elif self.layer0 == "full":
            table = (layer0_table if layer0_table is not None
                     else self.layer0_full_table(features, graph))
            h = rows(table, frontier.ids[L - 1], frontier.masks[L - 1])
        elif self.aggregator == "mean":
            h = self._sampled_mean_layer0(features, frontier, rows,
                                          gather_mean_fn or self._gather_mean,
                                          exchange_ranks, exchange_row_bytes)
        else:  # maxpool and lstm read the deepest hop's raw rows
            h = rows(features, frontier.ids[L], frontier.masks[L])
            if cd is not None:
                h = h.to(cd)
            start = 0
        for l in range(start, L):
            hop_in = L - l  # activations currently live at this hop
            n_out = frontier.ids[hop_in - 1].shape[0]
            k_cols = frontier.ids[hop_in].shape[0] // n_out
            h3 = h.reshape(n_out, k_cols, h.shape[-1])
            m3 = frontier.masks[hop_in].reshape(n_out, k_cols)
            if self.concat_self:
                self_h, neigh, nm = h3[:, 0], h3[:, 1:], m3[:, 1:]
            else:
                self_h, neigh, nm = None, h3, m3
            h = self.layers[l](self_h, neigh, nm, compute_dtype=cd,
                               activation=self.layer_activation(l))
        return self._head(h, return_embeddings)

    def _head(self, h: torch.Tensor, return_embeddings: bool) -> torch.Tensor:
        """f32 representations, or f32 logits of the head product in ``h``'s
        dtype."""
        if return_embeddings:
            return h.to(torch.float32)
        return (h @ self.head.to(h.dtype)).to(torch.float32)

    def _sampled_mean_layer0(self, features, frontier: Frontier, rows, gather_mean_fn,
                             exchange_ranks: int, exchange_row_bytes: int | None = None
                             ) -> torch.Tensor:
        """Layer 0 of the sampled mean model: the fused gather-mean over the
        deepest hop, projecting first or aggregating first. Over
        ``exchange_ranks`` ranks each lookup's output rows cross ``S - 1``
        links forward, and again backward under autograd (the ring
        reduce-scatter and all-gather of the node-sharded exchange)."""
        L, cd = self.num_layers, self.compute_dtype
        n_out = frontier.ids[L - 1].shape[0]
        k_cols = frontier.ids[L].shape[0] // n_out
        ids2 = frontier.ids[L].reshape(n_out, k_cols)
        m2 = frontier.masks[L].reshape(n_out, k_cols)
        if self.concat_self:
            ids2, m2 = ids2[:, 1:], m2[:, 1:]
        neigh_ids, neigh_mask = ids2.contiguous(), m2.contiguous()
        layer0 = self.layers[0]
        self_ids = frontier.ids[L - 1]
        lookups = 2 if self.concat_self else 1
        passes = 2 if torch.is_grad_enabled() else 1
        exchanged = passes * lookups * (exchange_ranks - 1) * n_out
        if self.sampled_layer0_project_first(features.shape[0], neigh_ids.numel(), exchanged,
                                             is_quantized(features), exchange_row_bytes):
            # Project the whole table to d_out once, then gather-mean narrow
            # rows (exact: the mean is linear); an int8 table is contracted
            # raw and scaled after.
            w0 = layer0.weight if cd is None else layer0.weight.to(cd)
            w_self, w_neigh = split_mean_weight(w0, self.in_dim, self.concat_self)
            if is_quantized(features):
                project = lambda w: project_table(features, w)  # noqa: E731
            else:
                feats = features.to(w0.dtype)
                project = lambda w: feats @ w  # noqa: E731
            pre = gather_mean_fn(project(w_neigh), neigh_ids, neigh_mask)
            if self.concat_self:
                pre = pre + rows(project(w_self), self_ids, frontier.masks[L - 1])
            return self._activate(0, pre).to(w0.dtype)
        self_h = (rows(features, self_ids, frontier.masks[L - 1]) if self.concat_self
                  else None)
        return layer0(self_h, None, None, compute_dtype=cd,
                      precomputed_agg=gather_mean_fn(features, neigh_ids, neigh_mask),
                      activation=self.layer_activation(0))

    def apply_sampled(
        self, generator: torch.Generator, graph: Graph, seeds: torch.Tensor
    ) -> torch.Tensor:
        """``sample`` + ``forward`` in one call: logits ``[B, C]`` (the JAX
        model's ``apply``; the name ``apply`` stays ``nn.Module``'s)."""
        return self(graph.features, self.sample(generator, graph, seeds), graph=graph)

    def embed(
        self, generator: torch.Generator, graph: Graph, seeds: torch.Tensor
    ) -> torch.Tensor:
        """Sampled node representations ``[B, hidden[-1]]`` (what the head
        consumes); :meth:`embed_full_graph` gives deterministic ones."""
        return self(graph.features, self.sample(generator, graph, seeds),
                    return_embeddings=True, graph=graph)

    # ----------------------------------------------------------------- loss
    def loss(
        self, features: torch.Tensor, frontier: Frontier, labels: torch.Tensor,
        *, graph: Graph | None = None, **injected,
    ) -> torch.Tensor:
        """Mean softmax cross-entropy of the frontier's seeds against their
        integer ``labels`` (reference model.py:35-37), or mean sigmoid BCE
        over multi-hot labels under ``multilabel=True``. ``injected`` are
        :meth:`forward`'s lookups of the sharded trainers."""
        return self.classification_loss(
            self(features, frontier, graph=graph, **injected), labels).mean()

    def classification_loss(
        self, logits: torch.Tensor, labels: torch.Tensor
    ) -> torch.Tensor:
        """Per-example loss ``[B]``, the one head objective every trainer
        uses: softmax cross-entropy on integer labels, or under
        ``multilabel`` the mean over classes of sigmoid BCE on multi-hot
        ``[B, C]`` labels (the GraphSAGE paper's PPI objective; optax's
        ``sigmoid_binary_cross_entropy``)."""
        if self.multilabel:
            if labels.dim() != 2:
                raise ValueError(
                    f"multilabel=True needs multi-hot [B, C] labels, got "
                    f"shape {tuple(labels.shape)} — build the graph with 2-D labels"
                )
            return F.binary_cross_entropy_with_logits(
                logits, labels.to(logits.dtype), reduction="none").mean(dim=-1)
        return F.cross_entropy(logits, labels.reshape(-1).long(), reduction="none")

    # --------------------------------------------------------- full graph
    def forward_full_graph(
        self, graph: Graph, return_embeddings: bool = False, spmm_override=None,
        segmax_override=None, rows: RowBlock | None = None,
    ) -> torch.Tensor:
        """Deterministic logits for every node, using complete neighborhoods
        (the reference with ``num_sample=None``, quirk Q7). The LSTM reads
        each node's ELL row in adjacency order (the parent first with
        ``self_loop``), the order covering-fanout sampling gives, so it needs
        an ELL table that covers every neighbor.

        ``spmm_override`` (``x -> (neighbor mean, valid count)``) replaces
        the mean aggregator's SpMM and ``segmax_override`` (``pooled ->
        guarded per-node max``) maxpool's segment max, as the
        edge-partitioned path
        (:func:`graphsage_torch.parallel.distributed.distributed_full_graph_logits`)
        does; lstm rejects both.

        ``rows`` (a :class:`~graphsage_torch.data.graph.RowBlock` of
        ``graph``): the logits of those rows alone, ``[R, C]``, in row order.
        The layers before the last run over every node (the rows'
        neighbours); the last layer's aggregation runs over the block (its
        backward over the block's transpose) and it and the head map the
        ``R`` rows. The lstm computes every row and keeps the block's."""
        if rows is not None and (spmm_override is not None or segmax_override is not None):
            raise ValueError("forward_full_graph takes rows= or an override, not both")
        if self.aggregator == "lstm" and (spmm_override is not None
                                          or segmax_override is not None):
            raise ValueError(
                "the edge-partitioned/halo full-graph paths support mean and "
                "maxpool only — an LSTM over neighbor sequences is not a "
                "per-edge segment reduction"
            )
        if self.aggregator == "lstm" and not graph.ell_covers_all:
            raise ValueError(
                "full-graph forward with aggregator='lstm' needs the ELL table "
                "to cover every neighbor (this graph is hub-capped); evaluate "
                "with sampled neighborhoods (eval_fanouts) instead"
            )
        h = graph.features
        if is_quantized(h):
            h = dequantize(h, self.compute_dtype or torch.float32)
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        spmm = self._spmm(graph) if spmm_override is None else spmm_override
        segmax = self._segmax(graph) if segmax_override is None else segmax_override
        for l, layer in enumerate(self.layers):
            block = rows if l == self.num_layers - 1 else None
            keep = None if block is None else block.rows
            if self.aggregator == "mean":
                h = apply_full_graph_mean_layer(
                    layer, h, spmm if block is None else self._spmm(graph, block),
                    self_loop=self.self_loop,
                    project_first=self.use_project_first(l, h.shape[-1]),
                    activation=self.layer_activation(l), rows=keep,
                )
            elif self.aggregator == "maxpool":
                h = apply_full_graph_maxpool_layer(
                    layer, h, segmax if block is None else self._segmax(graph, block),
                    self_loop=self.self_loop, activation=self.layer_activation(l),
                    rows=keep)
            else:
                h = layer(h if self.concat_self else None,
                          *self._ell_sequences(graph, h),
                          activation=self.layer_activation(l))
                if block is not None:
                    h = h[keep]
        return self._head(h, return_embeddings)

    def _ell_sequences(self, graph: Graph, h: torch.Tensor):
        """Every node's neighbor rows in ELL order ``[N, W, d]`` and their
        mask; with ``self_loop`` the node's own row comes first."""
        width = graph.neighbors.shape[-1]
        slots = torch.arange(width, device=h.device)
        mask = slots[None, :] < graph.degrees.clamp(max=width)[:, None]
        seq = gather(h, graph.neighbors)
        if self.self_loop:
            seq = torch.cat([h[:, None, :], seq], dim=1)
            mask = torch.cat([mask.new_ones((h.shape[0], 1)), mask], dim=1)
        return seq, mask

    def embed_full_graph(self, graph: Graph) -> torch.Tensor:
        """Deterministic embeddings ``[N, hidden[-1]]`` for every node."""
        return self.forward_full_graph(graph, return_embeddings=True)

    def predictions(self, logits) -> np.ndarray:
        """Host-side class decisions from logits: argmax (single-label,
        reference model.py:105) or per-class ``logit > 0`` multi-hot int8
        rows (``multilabel``: the sigmoid's 0.5 threshold)."""
        if isinstance(logits, torch.Tensor):
            logits = logits.detach().cpu().numpy()
        logits = np.asarray(logits)
        if self.multilabel:
            return (logits > 0).astype(np.int8)
        return logits.argmax(axis=-1)
