"""The node-sharded feature store, its dense part: the counterpart of
``graphsage_tpu/parallel/feature_store.py`` (``NodeShardedFeatures``,
``shard_features``, ``sharded_row_gather``, ``make_sharded_gather_fns(mode=
"dense")`` and ``ShardedFeatureTrainer``).

The ``[N, F]`` table is split on the node dimension: rank ``s`` of the axis
owns rows ``[s * Np, (s + 1) * Np)`` with ``Np = round_up(ceil(N / S), 8)``;
padding rows are zero and ownership is ``id // Np``. Only a rank's own rows
reach its device: the shard is cut from a host copy of the table.

The exchange (:class:`_OwnerExchange`) computes what JAX's dense exchange
computes, the requested rows' masked sums, without shipping a zero row for
every request a rank does not own:

* every rank's requests (id, or -1 for a masked slot: 4 bytes a slot) are
  all-gathered;
* each owner sums the rows it owns for every rank's requests, Hopper kernel
  1 in its sum mode, ``[S * B, F]`` partial sums;
* one reduce-scatter returns each rank its own ``[B, F]`` sums, and the rank
  divides by its full valid count (the guarded mean, quirk Q4).

The backward all-gathers the requesters' ``g / count`` and each owner adds
them into its ``[Np, F]`` gradient with Hopper kernel 2 in its sum mode.
A row lookup is the same exchange with one slot per request. With
project-first each owner projects its own shard first, so the exchanged
rows are ``d``-wide; the sampled mean layer 0 picks its order by the
single device's rule over the rank's shard and slots, with the rows the
exchange moves counted (``GraphSAGE.sampled_layer0_project_first``).

Not ported yet, each raising with the ROADMAP Queue 1 sub-item that brings
it: the compact exchange and the hub cache (14b), ``layer0="full"`` and
int8 tables (14e), and a prebuilt loader ``feature_store`` (item 15).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from graphsage_torch.data.graph import Graph, with_cached_layer0
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.ops.gather_mean import gather_mean
from graphsage_torch.ops.quantize import is_quantized
from graphsage_torch.ops.scatter_mean import scatter_mean
from graphsage_torch.parallel import collectives
from graphsage_torch.parallel.distributed import ShardedLoop, slice_frontier
from graphsage_torch.parallel.mesh import axis_index, axis_size
from graphsage_torch.train.trainer import Trainer


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class NodeShardedFeatures:
    """A rank's node range of the ``[N, F]`` table: ``shard [Np, F]``, rows
    ``[s * Np, (s + 1) * Np)`` on rank ``s``, zero past ``num_nodes``."""

    shard: torch.Tensor
    num_shards: int
    rows_per_shard: int
    num_nodes: int

    def memory_stats(self) -> dict:
        """Bytes per rank against a replicated table, as JAX's."""
        row = int(self.shard.shape[-1]) * self.shard.element_size()
        return {
            "num_shards": self.num_shards,
            "rows_per_shard": self.rows_per_shard,
            "feature_bytes_per_chip": self.rows_per_shard * row,
            "feature_bytes_replicated": self.num_nodes * row,
            "memory_reduction": self.num_nodes / max(self.rows_per_shard, 1),
        }


def shard_features(features: torch.Tensor, num_shards: int, index: int,
                   device=None) -> NodeShardedFeatures:
    """Rank ``index``'s node range of ``features [N, F]`` on ``device``
    (default: the table's), cut from a host copy: no full-table buffer is
    made on the device."""
    if is_quantized(features):
        raise NotImplementedError(
            "an int8 node-sharded table is not ported yet (ROADMAP Queue 1 item 14e)")
    host = features.detach().cpu()
    n, f = host.shape
    rows = _round_up(max(-(-n // num_shards), 1), 8)
    lo, hi = min(index * rows, n), min((index + 1) * rows, n)
    shard = torch.zeros((rows, f), dtype=host.dtype)
    shard[:hi - lo] = host[lo:hi]
    return NodeShardedFeatures(
        shard=shard.to(features.device if device is None else device),
        num_shards=num_shards, rows_per_shard=rows, num_nodes=n)


class _OwnerExchange(torch.autograd.Function):
    """``apply(table, idx [B, k], mask [B, k], group, normalize)``: the masked
    sums (or means) ``[B, F]`` f32 of this rank's requests over the
    node-sharded table whose local shard is ``table [Np, F]`` (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, table, idx, mask, group, normalize):
        np_ = table.shape[0]
        requests = collectives.all_gather_rows(
            torch.where(mask, idx, torch.full_like(idx, -1)), group)
        local = requests - dist.get_rank(group) * np_
        own = (requests >= 0) & (local >= 0) & (local < np_)
        local = torch.where(own, local, torch.zeros_like(local)).contiguous()
        partial = gather_mean(table.detach().contiguous(), local, own, normalize=False)
        sums = collectives.reduce_scatter_rows(partial, group)
        count = mask.sum(dim=1, keepdim=True).clamp(min=1).to(torch.float32)
        ctx.save_for_backward(local, own, count)
        ctx.group, ctx.normalize, ctx.num_rows, ctx.dtype = group, normalize, np_, table.dtype
        return sums / count if normalize else sums

    @staticmethod
    def backward(ctx, g):
        local, own, count = ctx.saved_tensors
        g = g.to(torch.float32)
        if ctx.normalize:
            g = g / count
        every = collectives.all_gather_rows(g, ctx.group)
        d = scatter_mean(every, local, own, ctx.num_rows, normalize=False)
        return d.to(ctx.dtype), None, None, None, None


def sharded_gather_mean(mesh: DeviceMesh, axis: str, table_local: torch.Tensor,
                        idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked gather-mean ``[B, F]`` f32 of this rank's ``idx``/``mask``
    (global node ids) over the node-sharded table; differentiable in the
    local shard."""
    return _OwnerExchange.apply(table_local, idx.to(torch.int32).contiguous(),
                                mask.contiguous(), mesh.get_group(axis), True)


def sharded_row_gather(mesh: DeviceMesh, axis: str, table_local: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """Rows ``[..., F]`` (the table's dtype) of the global node ids ``ids``
    over the node-sharded table; its gradient is a scatter-add into the
    owners' shards."""
    flat = ids.reshape(-1, 1).to(torch.int32).contiguous()
    rows = _OwnerExchange.apply(table_local, flat, torch.ones_like(flat, dtype=torch.bool),
                                mesh.get_group(axis), False)
    return rows.to(table_local.dtype).reshape(*ids.shape, table_local.shape[-1])


def make_sharded_gather_fns(mesh: DeviceMesh, axis: str, mode: str = "dense"):
    """``(gather_fn, gather_mean_fn)`` for :meth:`GraphSAGE.forward` where
    the table argument is this rank's node-range shard."""
    if mode == "compact":
        raise NotImplementedError(
            "the compact sharded gather is not ported yet (ROADMAP Queue 1 item 14b)")
    if mode != "dense":
        raise ValueError(f"unknown sharded gather mode {mode!r}")

    def gather_fn(table_local, ids, mask=None):
        return sharded_row_gather(mesh, axis, table_local, ids)

    def gather_mean_fn(table_local, idx, mask):
        return sharded_gather_mean(mesh, axis, table_local, idx, mask)

    return gather_fn, gather_mean_fn


class ShardedFeatureTrainer(ShardedLoop, Trainer):
    """Sampled training whose feature table is node-sharded over ``axis``,
    which also carries data parallelism: each rank trains on its ``B / S``
    seeds and serves the rows it owns to every rank.

    Sampling is replicated: every rank samples the whole batch's frontier
    from the same generator and seed on the replicated adjacency, then
    keeps its seed slice, so a step computes the single-device
    :class:`~graphsage_torch.train.trainer.Trainer` step. The loss is the
    mean of the ranks' batch means and every gradient is averaged over the
    axis. ``layer0="cached"`` shards the frozen aggregate table like the
    features (same ``Np``, same padding), built once on the rank's device.

    Pass the graph on the CPU: the device then holds the adjacency, the
    labels and this rank's ``Np`` rows (a graph on the device works too, but
    its table stays where the caller keeps it). Evaluation with
    ``eval_fanouts`` runs through the sharded gather; with ``None`` it is the
    full-graph forward over a transient device copy of the graph, freed on
    return. Rank 0 alone writes checkpoints."""

    def __init__(self, model: GraphSAGE, graph: Graph, config, mesh: DeviceMesh,
                 axis: str = "data", gather_mode: str = "dense", feature_store=None,
                 hub_cache_rows: int = 0):
        if gather_mode not in ("dense", "compact"):
            raise ValueError(f"unknown gather_mode {gather_mode!r}")
        if gather_mode == "compact" or hub_cache_rows:
            raise NotImplementedError(
                "the compact exchange and hub_cache_rows are not ported yet "
                "(ROADMAP Queue 1 item 14b); the dense exchange is exact for "
                "any skew")
        if model.layer0 == "full":
            raise NotImplementedError(
                "layer0='full' under the node-sharded store is not ported yet "
                "(ROADMAP Queue 1 item 14e)")
        if feature_store is not None:
            raise NotImplementedError(
                "a prebuilt feature_store (shard_features_from_loader) is not "
                "ported yet (ROADMAP Queue 1 item 15)")
        self.mesh, self.axis = mesh, axis
        self.num_shards = axis_size(mesh, axis)
        self.shard_index = axis_index(mesh, axis)
        self._group = mesh.get_group(axis)
        if config.batch_size % self.num_shards:
            raise ValueError(
                f"batch_size {config.batch_size} must be divisible by the "
                f"{axis!r} axis size {self.num_shards}"
            )
        super().__init__(model, graph, config)
        self._gather_fn, self._gather_mean_fn = make_sharded_gather_fns(mesh, axis)

    def _prepare_graph(self, model: GraphSAGE, graph: Graph) -> Graph:
        """Shard the table (and a cached model's cache) from a host copy,
        and return the device graph without them: the adjacency and the
        labels, with a one-row placeholder table. A cache the graph lacks is
        built on the model's device (Hopper kernel 3 on a card) from a
        transient copy of the graph, freed once the host copy is made."""
        if is_quantized(graph.features):
            raise NotImplementedError(
                "ShardedFeatureTrainer over an int8 feature table is not "
                "ported yet (ROADMAP Queue 1 item 14e)")
        if model.layer0 == "cached" and graph.layer0_cache is None:
            graph = with_cached_layer0(graph.to(model.device), self_loop=model.self_loop)
        host = graph.to("cpu")
        del graph
        if model.layer0 == "cached":
            model.check_layer0_cache(host)
        self._source_graph = host
        s, i, dev = self.num_shards, self.shard_index, model.device
        self.features = shard_features(host.features, s, i, dev)
        self._cache_store = (None if host.layer0_cache is None or model.layer0 != "cached"
                             else shard_features(host.layer0_cache, s, i, dev))
        blank = torch.zeros((1, host.num_features), dtype=host.features.dtype)
        return dataclasses.replace(host, features=blank, layer0_cache=None).to(dev)

    def _injected(self) -> dict:
        cache = self._cache_store
        return dict(gather_fn=self._gather_fn, gather_mean_fn=self._gather_mean_fn,
                    layer0_table=None if cache is None else cache.shard,
                    exchange_ranks=self.num_shards)

    # ------------------------------------------------------------------- step
    def step(self, seeds: np.ndarray) -> torch.Tensor:
        """One optimizer step on the batch ``seeds`` (the same on every
        rank); returns the mean of the ranks' losses, a 0-d tensor."""
        ids = torch.from_numpy(np.asarray(seeds, dtype=np.int32)).to(self.device)
        frontier = slice_frontier(self.model.sample(self.generator, self.graph, ids),
                                  self.shard_index, self.num_shards)
        loss = self.model.loss(self.features.shard, frontier,
                               self.graph.labels[frontier.ids[0].long()], **self._injected())
        return self._mean_over(self._update(loss), self._group, self.num_shards)

    def _reduce_gradients(self) -> None:
        collectives.average_gradients(self.model.parameters(), self._group, self.num_shards)

    # ------------------------------------------------------------------- eval
    @torch.no_grad()
    def predict(self, nodes: np.ndarray) -> np.ndarray:
        """Sampled evaluation through the sharded gather when
        ``eval_fanouts`` is set (``nodes`` padded to a multiple of S, each
        rank scoring its slice); otherwise the full-graph forward over a
        transient device copy of the graph."""
        nodes = np.asarray(nodes)
        if self.cfg.eval_fanouts is None:
            full = self._transient_full_graph()
            return self.model.predictions(self.model.forward_full_graph(full))[nodes]
        s = self.num_shards
        seeds = np.concatenate([nodes, np.zeros((-len(nodes)) % s, nodes.dtype)])
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 7)
        ids = torch.from_numpy(seeds.astype(np.int32)).to(self.device)
        frontier = slice_frontier(
            self.model.sample(gen, self.graph, ids, self.cfg.eval_fanouts),
            self.shard_index, s)
        logits = self.model(self.features.shard, frontier, **self._injected())
        every = collectives.all_gather_rows(logits, self._group)
        return self.model.predictions(every)[: len(nodes)]

    def memory_stats(self) -> dict:
        """The per-rank layout (JAX's keys) and, on a card, the measured live
        device bytes (``utils.memory.live_device_bytes``): the largest live
        block below the full table's bytes shows that no rank holds it."""
        stats = {**self.features.memory_stats(), "hub_cache_rows": 0,
                 "hub_cache_bytes_per_chip": 0}
        if self._cache_store is not None:
            cm = self._cache_store.memory_stats()
            stats["layer0_cache_bytes_per_chip"] = cm["feature_bytes_per_chip"]
            stats["feature_bytes_per_chip"] += cm["feature_bytes_per_chip"]
            stats["feature_bytes_replicated"] += cm["feature_bytes_replicated"]
        measured = {"total_bytes": None, "largest_buffer_bytes": None,
                    "per_device_bytes": None}
        if self.device.type == "cuda":
            from graphsage_torch.utils.memory import live_device_bytes

            measured = live_device_bytes(device=self.device)
        stats.update(measured_total_device_bytes=measured["total_bytes"],
                     measured_largest_buffer_bytes=measured["largest_buffer_bytes"],
                     measured_per_device_bytes=measured["per_device_bytes"])
        return stats
