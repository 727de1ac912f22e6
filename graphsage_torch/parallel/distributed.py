"""Distributed execution: the counterpart of
``graphsage_tpu/parallel/distributed.py``.

* **Edge-partitioned full-graph aggregation** (:func:`sharded_spmm_mean`,
  :func:`sharded_segment_max`, :func:`distributed_full_graph_logits`): each
  rank of the ``graph`` axis owns a contiguous CSR edge block
  (:mod:`graphsage_torch.parallel.partition`), reduces it into ``[N, F]``
  partial sums (Hopper kernel 3 with ``normalize=False`` over the block's
  own rows) or partial maxima, and the partials are summed (or maxed) over
  the axis. The input is replicated, so its gradient is each rank's block
  transpose summed over the axis.
* **DP + TP sampled training** (:class:`ShardedTrainer`): the seed batch
  splits over ``data``; the feature table's columns and the matching rows of
  layer 0's weight (and of the max-pool MLP's and the LSTM's input product)
  over ``model``. Layer 0's partial product is summed over ``model`` once;
  every deeper layer and the head are replicated, and gradients are
  averaged over ``data``.

Every rank samples the whole batch's frontier with the same generator and
seed and keeps its ``data`` slice, so a sharded step computes the
single-device :class:`~graphsage_torch.train.trainer.Trainer` step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from graphsage_torch.data.graph import Graph
from graphsage_torch.models.graphsage import Frontier, GraphSAGE
from graphsage_torch.models.layers import lstm_recurrence, split_mean_weight
from graphsage_torch.ops.aggregate import masked_max
from graphsage_torch.ops.quantize import QuantizedTable, is_quantized, project_table
from graphsage_torch.ops.spmm import spmm_block_sum, spmm_transpose_plain
from graphsage_torch.parallel import collectives
from graphsage_torch.parallel.mesh import axis_index, axis_size, has_axis
from graphsage_torch.parallel.multihost import is_primary
from graphsage_torch.parallel.partition import EdgePartition, partition_edges
from graphsage_torch.train.config import TrainConfig
from graphsage_torch.train.trainer import Trainer


# --------------------------------------------------------------------------
# Edge-partitioned aggregation
# --------------------------------------------------------------------------

class EdgeBlock(NamedTuple):
    """One rank's edge block on its device: the valid edges' global source
    rows ``src`` and ``edge_dst``, and a CSR ``indptr [R + 1]`` over the
    ``R`` rows ``row0 .. row0 + R - 1`` that the block's edges leave (the
    edges are sorted by source)."""

    row0: int
    indptr: torch.Tensor
    edge_dst: torch.Tensor
    src: torch.Tensor


def edge_block(part: EdgePartition, index: int, device) -> EdgeBlock:
    """Block ``index`` of ``part`` as an :class:`EdgeBlock` on ``device``."""
    mask = part.edge_mask[index]
    src = part.edge_src[index][mask].astype(np.int64)
    dst = part.edge_dst[index][mask].astype(np.int32)
    if src.size == 0:
        row0, indptr = 0, np.zeros(1, np.int32)
    else:
        row0 = int(src[0])
        indptr = np.searchsorted(src, np.arange(row0, int(src[-1]) + 2)).astype(np.int32)
    return EdgeBlock(row0=row0,
                     indptr=torch.from_numpy(indptr).to(device),
                     edge_dst=torch.from_numpy(dst).to(device),
                     src=torch.from_numpy(src).to(device))


class _EdgeBlockSum(torch.autograd.Function):
    """``(sums [N, F] f32, counts [N] f32)`` of the whole graph from every
    rank's block: the block's rows summed by kernel 3 (``normalize=False``),
    placed at their rows with their degrees in one extra column, and the
    ``[N, F + 1]`` partials summed over the axis in one all-reduce. A row
    split between two blocks has a partial on each.

    Backward: the cotangent of a replicated output is the same on every
    rank, so the sum passes it back unchanged; each rank applies its block's
    transpose (``index_add_``: a block of a symmetric graph is not
    symmetric) and the input's gradient, replicated, is summed over the
    axis."""

    @staticmethod
    def forward(ctx, x, block, num_nodes, group):
        xf = x.detach().to(torch.float32).contiguous()
        part = spmm_block_sum(xf, block.indptr, block.edge_dst)
        rows = part.shape[0]
        acc = xf.new_zeros((num_nodes, xf.shape[1] + 1))
        acc[block.row0:block.row0 + rows, :-1] = part
        acc[block.row0:block.row0 + rows, -1] = (block.indptr[1:] - block.indptr[:-1]).float()
        acc = collectives.all_reduce(acc, group)
        ctx.block, ctx.group, ctx.num_rows, ctx.dtype = block, group, x.shape[0], x.dtype
        counts = acc[:, -1].contiguous()
        ctx.mark_non_differentiable(counts)
        return acc[:, :-1], counts

    @staticmethod
    def backward(ctx, g, _g_counts):
        block = ctx.block
        rows = block.indptr.numel() - 1
        g_block = g[block.row0:block.row0 + rows].to(torch.float32).contiguous()
        dx = spmm_transpose_plain(g_block, block.indptr, block.edge_dst, ctx.num_rows)
        return collectives.all_reduce(dx, ctx.group).to(ctx.dtype), None, None, None


def sharded_spmm_mean(
    mesh: DeviceMesh,
    axis: str,
    features: torch.Tensor,  # [N, F] replicated
    part: EdgePartition,  # one block per rank of ``axis``
    num_nodes: int,
    block: EdgeBlock | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-graph mean aggregation with the edges sharded over ``axis``:
    ``(mean [N, F] in the features' dtype, valid count [N])``, both
    replicated. Partial sums and the cross-rank sum are f32; the mean is the
    guarded one (quirk Q4: a row without edges is 0). ``block`` is this
    rank's :func:`edge_block` of ``part``, built here when not given.
    Differentiable in ``features``."""
    if block is None:
        block = edge_block(part, axis_index(mesh, axis), features.device)
    summed, count = _EdgeBlockSum.apply(features, block, num_nodes, mesh.get_group(axis))
    mean = summed / count.clamp(min=1.0)[:, None]
    return mean.to(features.dtype), count


class _EdgeBlockMax(torch.autograd.Function):
    """The guarded per-node max ``[N, pd]`` of every rank's block: block
    maxima (identity ``finfo.min``) maxed over the axis, rows without a
    valid edge anywhere set to 0 by the valid count summed over the axis.
    Backward: the subgradient goes to the maxima, a tie split evenly among
    its edges on every rank (as a single device's ``scatter_reduce`` splits
    it), and the replicated input's gradient is summed over the axis."""

    @staticmethod
    def forward(ctx, pooled, block, num_nodes, group):
        vals = pooled.detach()[block.edge_dst.long()]
        src = block.src[:, None].expand_as(vals)
        neg = torch.finfo(vals.dtype).min
        maxed = vals.new_full((num_nodes, vals.shape[1]), neg).scatter_reduce(
            0, src, vals, "amax", include_self=True)
        maxed = collectives.all_reduce(maxed, group, op=dist.ReduceOp.MAX)
        valid = collectives.all_reduce(
            torch.zeros(num_nodes, dtype=torch.float32, device=vals.device).index_add_(
                0, block.src, torch.ones_like(block.src, dtype=torch.float32)), group)
        ctx.save_for_backward(vals, maxed)
        ctx.block, ctx.group, ctx.num_rows = block, group, pooled.shape[0]
        ctx.mark_non_differentiable(valid)
        return torch.where((valid > 0)[:, None], maxed, torch.zeros_like(maxed)), valid

    @staticmethod
    def backward(ctx, g, _g_valid):
        vals, maxed = ctx.saved_tensors
        block, group = ctx.block, ctx.group
        src = block.src
        hit = (vals == maxed[src]).to(torch.float32)
        ties = collectives.all_reduce(
            torch.zeros(maxed.shape, dtype=torch.float32, device=g.device).index_add_(
                0, src, hit), group)
        per_edge = hit * g.to(torch.float32)[src] / ties[src].clamp(min=1.0)
        d = torch.zeros((ctx.num_rows, vals.shape[1]), dtype=torch.float32,
                        device=g.device).index_add_(0, block.edge_dst.long(), per_edge)
        return collectives.all_reduce(d, group).to(vals.dtype), None, None, None


def sharded_segment_max(
    mesh: DeviceMesh,
    axis: str,
    pooled: torch.Tensor,  # [N, pd] replicated (after the pooling MLP)
    part: EdgePartition,
    num_nodes: int,
    block: EdgeBlock | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge-partitioned guarded segment max, the max-pool counterpart of
    :func:`sharded_spmm_mean`: ``(max [N, pd], valid count [N])``, both
    replicated, rows without neighbours 0 (quirk Q4). Differentiable in
    ``pooled``: the subgradient goes to the argmax."""
    if block is None:
        block = edge_block(part, axis_index(mesh, axis), pooled.device)
    out, valid = _EdgeBlockMax.apply(pooled, block, num_nodes, mesh.get_group(axis))
    return out, valid.to(torch.int32)


def distributed_full_graph_logits(
    model: GraphSAGE,
    graph: Graph,
    mesh: DeviceMesh,
    axis: str = "graph",
    part: EdgePartition | None = None,
) -> torch.Tensor:
    """Full-graph logits ``[N, C]`` with every aggregation edge-partitioned
    over ``axis``: :meth:`GraphSAGE.forward_full_graph` with the sharded
    SpMM and segment max in place of the local ones (mean and maxpool; the
    graph replicated on every rank)."""
    if model.aggregator == "lstm":
        raise ValueError(
            "edge-partitioned full-graph execution supports mean and "
            "maxpool only — an LSTM over neighbor sequences is not a "
            "per-edge segment reduction; train lstm models on the sampled "
            "paths"
        )
    if part is None:
        part = partition_edges(graph, axis_size(mesh, axis))
    n = graph.num_nodes
    block = edge_block(part, axis_index(mesh, axis), graph.device)
    return model.forward_full_graph(
        graph,
        spmm_override=lambda x: sharded_spmm_mean(mesh, axis, x, part, n, block),
        segmax_override=lambda p: sharded_segment_max(mesh, axis, p, part, n, block)[0],
    )


# --------------------------------------------------------------------------
# What both sharded trainers share
# --------------------------------------------------------------------------

def slice_frontier(frontier: Frontier, index: int, parts: int) -> Frontier:
    """The subtree of seed block ``index`` of ``parts``: frontiers are
    seed-major and every hop has a fixed number of columns per seed, so each
    hop splits into ``parts`` equal blocks."""
    if parts == 1:
        return frontier
    return Frontier(ids=tuple(t.chunk(parts)[index] for t in frontier.ids),
                    masks=tuple(t.chunk(parts)[index] for t in frontier.masks))


class ShardedLoop:
    """Mixed into the sharded trainers: rank 0 alone writes checkpoints, and
    a step's loss is the mean of the ranks' batch means."""

    def write_checkpoint(self, path: str) -> str | None:
        written = super().write_checkpoint(path) if is_primary() else None
        dist.barrier()
        return written

    @staticmethod
    def _mean_over(loss: torch.Tensor, group, size: int) -> torch.Tensor:
        return collectives.all_reduce(loss.detach(), group) / size

    def _transient_full_graph(self) -> Graph:
        """The whole graph on this rank's device, for the deterministic
        full-graph evaluation (``eval_fanouts=None``): built from the host
        copy and freed when the caller drops it."""
        return self._source_graph.to(self.device)


# --------------------------------------------------------------------------
# DP + TP sampled training
# --------------------------------------------------------------------------

def _split(size: int, parts: int, index: int) -> tuple[int, int]:
    """``[lo, hi)`` of block ``index`` when ``size`` splits into ``parts``
    nearly equal contiguous blocks (``torch.tensor_split``'s rule)."""
    base, extra = divmod(size, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def _columns(table, c0: int, c1: int):
    """Columns ``[c0, c1)`` of a dense table, or of an int8 table's ``q``
    with its ``[N, 1]`` scales whole (JAX's ``graph_shardings`` replicates
    them)."""
    if is_quantized(table):
        return QuantizedTable(q=table.q[:, c0:c1].contiguous(), scale=table.scale)
    return table[:, c0:c1].contiguous()


class ShardedTrainer(ShardedLoop, Trainer):
    """Sampled training over a mesh with data parallelism and, when the
    mesh has a ``model`` axis, tensor parallelism in layer 0.

    Each rank keeps the columns ``[c0, c1)`` of the feature table (and of a
    ``layer0="cached"`` cache) that its ``model`` coordinate owns, and uses
    the matching rows of layer 0's weight (the max-pool MLP's and the
    LSTM's input product too; the neighbour rows of a max-pool or lstm
    layer's weight, which contract the pooled or hidden width, split the
    same way over that width). Layer 0's partial product goes through one
    ``model``-axis sum (:class:`collectives.SumOverAxis`). The parameters
    are kept whole on every rank: a rank's gradient of layer 0's weight
    fills only its own rows, and the gradient sum over ``model`` assembles
    them; every gradient is then averaged over ``data``. Layer 0 under
    tensor parallelism is the sampled mean (either product order, the
    single-device trainer's rule), the cached mean, the sampled max-pool
    layer, the sampled lstm (the input-gate products of every slot summed
    over ``model`` once, then the recurrence on every rank), or
    ``layer0="full"``'s table (each rank's columns' partial product summed,
    Hopper kernel 3 over the whole CSR, in the layer's order; the max-pool
    table's segment max); without a ``model`` axis every model trains as on
    one device. An int8 table splits its ``q`` columns and keeps its scales
    whole on every rank.

    The trainer re-slices the graph its parent prepared (with the layer-0
    cache the parent built), not the argument."""

    def __init__(self, model: GraphSAGE, graph: Graph, config: TrainConfig,
                 mesh: DeviceMesh, data_axis: str = "data",
                 model_axis: str | None = "model"):
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis if has_axis(mesh, model_axis) else None
        super().__init__(model, graph, config)
        d = axis_size(mesh, data_axis)
        if config.batch_size % d:
            raise ValueError(
                f"batch_size {config.batch_size} must divide over data axis "
                f"size {d}"
            )
        self._data_group = mesh.get_group(data_axis)
        self._num_data = d
        self._data_index = axis_index(mesh, data_axis)
        prepared = self.graph
        if self.model_axis is not None:
            self._source_graph = prepared.to("cpu")
            m, parts = axis_index(mesh, self.model_axis), axis_size(mesh, self.model_axis)
            self._model_group = mesh.get_group(self.model_axis)
            self._cols = _split(model.in_dim, parts, m)
            layer0 = model.layers[0]
            if model.aggregator != "mean":  # the pooled or the LSTM's hidden width
                width = (layer0.pool_weight.shape[1] if model.aggregator == "maxpool"
                         else layer0.lstm_wh.shape[0])
                self._pool_cols = _split(width, parts, m)
            c0, c1 = self._cols
            cache = prepared.layer0_cache
            self.graph = dataclasses.replace(
                prepared, features=_columns(prepared.features, c0, c1),
                layer0_cache=None if cache is None else _columns(cache, c0, c1))

    # ------------------------------------------------------------------- step
    def step(self, seeds: np.ndarray) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(seeds, dtype=np.int32)).to(self.device)
        frontier = slice_frontier(self.model.sample(self.generator, self.graph, ids),
                                  self._data_index, self._num_data)
        labels = self.graph.labels[frontier.ids[0].long()]
        if self.model_axis is None:
            loss = self.model.loss(self.graph.features, frontier, labels, graph=self.graph)
        else:
            loss = self.model.loss(None, frontier, labels,
                                   layer0_out=self._tp_layer0(frontier))
        return self._mean_over(self._update(loss), self._data_group, self._num_data)

    def _reduce_gradients(self) -> None:
        if self.model_axis is not None:
            collectives.average_gradients(self._sliced_params(), self._model_group, 1)
        collectives.average_gradients(self.model.parameters(), self._data_group,
                                      self._num_data)

    def _sliced_params(self) -> list[torch.nn.Parameter]:
        """Layer 0's parameters whose rows split over ``model``."""
        layer0, agg = self.model.layers[0], self.model.aggregator
        return [layer0.weight] + ([layer0.pool_weight] if agg == "maxpool" else
                                  [layer0.lstm_wx] if agg == "lstm" else [])

    # ------------------------------------------------------ tensor parallel
    def _tp_layer0(self, fr: Frontier, slots_scale: int | None = None) -> torch.Tensor:
        """Layer 0's output at hop ``L - 1`` from this rank's feature
        columns and weight rows, summed over ``model``. ``slots_scale``
        (default: the ``data`` axis size) turns the rank's layer-0 slots
        into the batch's, so that the product order is the one the
        single-device trainer picks for the same batch."""
        model, g = self.model, self.graph
        L, cd, F = model.num_layers, model.compute_dtype, model.in_dim
        layer0 = model.layers[0]
        c0, c1 = self._cols
        act = model.layer_activation(0) or (lambda x: x)
        w = layer0.weight if cd is None else layer0.weight.to(cd)
        feats = g.features
        if model.layer0 == "full":
            return model._gather_rows(self._tp_full_table(), fr.ids[L - 1])
        if model.layer0 == "cached":
            ids = fr.ids[L - 1]
            w_self, w_neigh = split_mean_weight(w, F, model.concat_self)
            parts = [model._gather_rows(g.layer0_cache, ids)]
            rows = [w_neigh[c0:c1]]
            if model.concat_self:
                parts.insert(0, model._gather_rows(feats, ids))
                rows.insert(0, w_self[c0:c1])
            return act(self._total(self._product(parts, rows, cd)))
        if model.aggregator == "mean":
            n_out = fr.ids[L - 1].shape[0]
            ids2 = fr.ids[L].reshape(n_out, -1)
            m2 = fr.masks[L].reshape(n_out, -1)
            if model.concat_self:
                ids2, m2 = ids2[:, 1:], m2[:, 1:]
            ids2, m2 = ids2.contiguous(), m2.contiguous()
            self_ids = fr.ids[L - 1]
            w_self, w_neigh = split_mean_weight(w, F, model.concat_self)
            scale = self._num_data if slots_scale is None else slots_scale
            quantized = is_quantized(feats)
            if model.sampled_layer0_project_first(g.num_nodes, ids2.numel() * scale,
                                                  quantized=quantized):
                if quantized:  # the raw int8 values, scaled after
                    project = lambda wr: project_table(feats, wr)  # noqa: E731
                else:
                    table = feats.to(w.dtype)
                    project = lambda wr: table @ wr  # noqa: E731
                pre = model._gather_mean(project(w_neigh[c0:c1]), ids2, m2)
                if model.concat_self:
                    pre = pre + model._gather_rows(project(w_self[c0:c1]), self_ids)
                return act(self._total(pre)).to(w.dtype)
            parts = [model._gather_mean(feats, ids2, m2)]
            rows = [w_neigh[c0:c1]]
            if model.concat_self:
                parts.insert(0, model._gather_rows(feats, self_ids))
                rows.insert(0, w_self[c0:c1])
            return act(self._total(self._product(parts, rows, cd)))
        # maxpool and lstm: the aggregator's partial input product, summed,
        # then the max or the recurrence on every rank.
        n_out = fr.ids[L - 1].shape[0]
        x = model._gather_rows(feats, fr.ids[L])
        if cd is not None:
            x = x.to(cd)
        x3 = x.reshape(n_out, -1, x.shape[-1])
        m3 = fr.masks[L].reshape(n_out, -1)
        neigh, nm = (x3[:, 1:], m3[:, 1:]) if model.concat_self else (x3, m3)
        if model.aggregator == "maxpool":
            pdt = cd or layer0.weight.dtype
            wp = layer0.pool_weight[c0:c1].to(pdt).to(torch.float32)
            pooled = torch.relu(self._total(neigh.to(torch.float32) @ wp)
                                + layer0.pool_bias.to(pdt)).to(neigh.dtype)
            agg = masked_max(pooled, nm)
        else:
            xg = (neigh @ layer0.lstm_wx[c0:c1].to(neigh.dtype)).to(torch.float32)
            agg = lstm_recurrence(self._total(xg), layer0.lstm_wh, layer0.lstm_b,
                                  nm).to(neigh.dtype)
        parts, rows = self._split_aggregate(agg, w)
        if model.concat_self:
            parts.insert(0, x3[:, 0])
            rows.insert(0, w[c0:c1])
        return act(self._total(self._product(parts, rows, cd)))

    def _total(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.SumOverAxis.apply(x, self._model_group)

    def _split_aggregate(self, agg: torch.Tensor, w: torch.Tensor) -> tuple[list, list]:
        """``([this rank's columns of agg], [their weight rows])``: a max-pool
        or lstm aggregate is replicated, and its product with the weight's
        neighbour rows splits over its width (the backward sums the ranks'
        cotangents of ``agg``)."""
        p0, p1 = self._pool_cols
        agg_rows = w[self.model.in_dim:] if self.model.concat_self else w
        return ([collectives.CopyToAxis.apply(agg, self._model_group)[:, p0:p1]],
                [agg_rows[p0:p1]])

    def _tp_full_table(self) -> torch.Tensor:
        """``layer0="full"``'s ``[N, hidden[0]]`` table from this rank's
        feature columns: :meth:`GraphSAGE.layer0_full_table`'s layer with
        each product split over ``model`` and summed once. Hopper kernel 3
        runs over the whole CSR on the summed projection (project-first) or
        on the rank's columns (mean first); the max-pool table sums the
        pooling MLP's product, takes the segment max on every rank and
        splits its product with the weight over the pooled width."""
        model, g = self.model, self.graph
        F, layer0 = model.in_dim, model.layers[0]
        c0, c1 = self._cols
        act = model.layer_activation(0) or (lambda x: x)
        feats = g.features
        h = model._dense(feats)
        w = layer0.weight.to(h.dtype)
        if model.aggregator == "maxpool":
            wp = layer0.pool_weight[c0:c1].to(h.dtype).to(torch.float32)
            pooled = torch.relu(self._total(h.to(torch.float32) @ wp)
                                + layer0.pool_bias.to(h.dtype)).to(h.dtype)
            agg = model._segmax(g)(pooled).to(h.dtype)
            if model.self_loop:
                agg = torch.maximum(agg, pooled)
            parts, rows = self._split_aggregate(agg, w)
            if model.concat_self:
                parts.insert(0, h)
                rows.insert(0, w[c0:c1])
            return act(self._total(torch.cat(parts, dim=-1) @ torch.cat(rows, dim=0)))
        spmm = model._spmm(g)
        w_self, w_neigh = split_mean_weight(w, F, model.concat_self)
        if model.use_project_first(0, F):
            if is_quantized(feats):  # the raw int8 values, scaled after
                project = lambda wr: project_table(feats, wr)  # noqa: E731
            else:
                project = lambda wr: h @ wr  # noqa: E731
            hp = self._total(project(w_neigh[c0:c1])).to(h.dtype)
            mean, cnt = spmm(hp)
            pre = mean.to(torch.float32)
            if model.self_loop:
                c = cnt.to(torch.float32)[:, None]
                pre = (pre * c + hp.to(torch.float32)) / (c + 1.0)
            if model.concat_self:
                pre = pre + self._total(project(w_self[c0:c1])).to(torch.float32)
            return act(pre).to(h.dtype)
        mean, cnt = spmm(h)
        if model.self_loop:
            c = cnt.to(mean.dtype)[:, None]
            mean = (mean * c + h) / (c + 1.0)
        parts, rows = [mean], [w_neigh[c0:c1]]
        if model.concat_self:
            parts.insert(0, h)
            rows.insert(0, w_self[c0:c1])
        return act(self._total(torch.cat(parts, dim=-1) @ torch.cat(rows, dim=0)))

    @staticmethod
    def _product(parts: list[torch.Tensor], rows: list[torch.Tensor], cd) -> torch.Tensor:
        """``cat(parts) @ cat(rows)``, the parts cast to the compute dtype
        ``cd`` when there is one, in the wider dtype of the two, returned f32
        (as ``apply_sage_layer`` combines)."""
        if cd is not None:
            parts = [p.to(cd) for p in parts]
        combined = torch.cat(parts, dim=-1)
        w = torch.cat(rows, dim=0)
        dt = torch.promote_types(combined.dtype, w.dtype)
        return (combined.to(dt) @ w.to(dt)).to(torch.float32)

    # ------------------------------------------------------------------- eval
    @torch.no_grad()
    def predict(self, nodes: np.ndarray) -> np.ndarray:
        """As :meth:`Trainer.predict`; the sampled evaluation runs the
        tensor-parallel layer 0 over every node on every rank, the
        full-graph one a transient whole-graph copy on this device."""
        nodes = np.asarray(nodes)
        if self.model_axis is None:
            return super().predict(nodes)
        if self.cfg.eval_fanouts is None:
            full = self._transient_full_graph()
            return self.model.predictions(self.model.forward_full_graph(full))[nodes]
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 7)
        ids = torch.from_numpy(nodes.astype(np.int32)).to(self.device)
        frontier = self.model.sample(gen, self.graph, ids, self.cfg.eval_fanouts)
        h0 = self._tp_layer0(frontier, slots_scale=1)
        return self.model.predictions(self.model(None, frontier, layer0_out=h0))
