"""The node-sharded feature store: the counterpart of
``graphsage_tpu/parallel/feature_store.py`` (``NodeShardedFeatures``,
``shard_features``, ``shard_features_from_loader``, the dense and compact
cross-rank gathers, the hub cache,
the layer-0 table build of ``layer0="full"``, ``ShardedFeatureTrainer``, the
sharded adjacency with its distributed sampler, and ``FullyShardedTrainer``).

The ``[N, F]`` table is split on the node dimension: rank ``s`` of the axis
owns rows ``[s * Np, (s + 1) * Np)`` with ``Np = round_up(ceil(N / S), 8)``;
padding rows are zero and ownership is ``id // Np``. Only a rank's own rows
reach its device: the shard is cut from a host copy of the table. An int8
:class:`~graphsage_torch.ops.quantize.QuantizedTable` shards the same way,
its ``q`` rows and ``[N, 1]`` scales cut on the same ranges (padding rows
keep scale 1).

**The dense exchange** (:class:`_OwnerExchange`) computes what JAX's dense
exchange computes, the requested rows' masked sums, without shipping a zero
row for every request a rank does not own:

* every rank's requests (id, or -1 for a masked slot: 4 bytes a slot) are
  all-gathered;
* each owner sums the rows it owns for every rank's requests, Hopper kernel
  1 in its sum mode (its int8 route over an int8 table), ``[S * B, F]``
  partial sums in f32;
* one reduce-scatter returns each rank its own ``[B, F]`` sums, and the rank
  divides by its full valid count (the guarded mean, quirk Q4).

The backward all-gathers the requesters' ``g / count`` and each owner adds
them into its ``[Np, F]`` gradient with Hopper kernel 2 in its sum mode.

**The compact exchange** routes each request to its owner in buckets of a
fixed ``capacity`` per rank pair (:func:`route_buckets`: a counting rank up to
``_RANK_SORT_MIN_SHARDS`` shards, a stable sort above; masked slots spread
round-robin to ``(i % S) * Np`` and take bucket room, sent as -1): one
all-to-all ships
the ids out, each owner answers with its rows (an ``index_select``), a second
all-to-all ships them back into the requester's answer buffer ``[S * cap (+
H), F]``, and the requester reads it at ``take`` (each request's bucket
slot): Hopper kernel 1 (mean mode) for a masked mean, an ``index_select`` for
rows. The backward is kernel 2 (mean mode) into the buffer's gradient, the
reverse all-to-all, and kernel 2's sum mode (one slot per answered row) into
the owner's ``[Np, F]`` gradient; a frozen table skips it. An int8 table
answers with its ``q`` rows and, in a second all-to-all, their scales: ``F +
4`` bytes a row, as JAX's; the requester's mean is kernel 1's int8 route
over the int8 answer buffer. A bucket that overflows its capacity clips
rows: the trainers check every call site first
(:meth:`ShardedFeatureTrainer._local_sites_violated`), apply nothing on an
overflow and redo the step on the same frontier at doubled slack.

**The hub cache** (:func:`build_hub_cache`) replicates the ``H``
highest-degree rows of a frozen table on every rank; hub requests enter the
route as masked slots and read the answer buffer's last ``H`` rows, so one
kernel-1 call (or one ``index_select``) serves routed and hub slots.

**The layer-0 table of ``layer0="full"``** is built per step over the
rank's own rows (:meth:`GraphSAGE.layer0_full_table` with the closures of
:func:`make_sharded_spmm` and :func:`make_sharded_segmax`): every rank's
(projected) rows are all-gathered into an ``[S * Np, d]`` buffer and Hopper
kernel 3 aggregates the rank's CSR over it (:class:`LocalCSR`: local rows,
buffer columns), its backward kernel 3 again over the transposed CSR; or
(``layer0_exchange="halo"``) only the boundary rows travel, through the halo
plan of :mod:`graphsage_torch.parallel.halo` over the store's own node
ranges. The one gather site then reads ``d0``-wide rows of the rank's table
slice, which depends on the parameters: the compact exchange's owner
backward (kernel 2's sum mode) carries its gradient.

**Fully sharded training** shards the adjacency too (:func:`shard_adjacency`)
and samples each hop at the owners (:func:`sharded_sample_neighbors`, routed
like the compact gather). Each rank draws from its own generator,
:func:`owner_generator` (seeded from the seed, the step and the rank, as
JAX's draws are keyed by ``fold_in(step key, axis_index)``): the streams
differ from JAX's, and from the single device's, wherever sampling is random.

With project-first each owner projects its own shard first, so the exchanged
rows are ``d``-wide; the sampled mean layer 0 picks its order by the single
device's rule over the rank's shard and slots, with the rows the exchange
moves counted (``GraphSAGE.sampled_layer0_project_first``).

**Lazy ingestion**: :func:`shard_features_from_loader` builds a rank's
store from a row loader (``load_*_lazy``), reading its own rows only, and
the trainers take it as ``feature_store=``; the graph's feature leaf is then
a descriptor that no path reads, so the full-graph evaluation and the hub
cache, which need the whole table, are refused at construction.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from graphsage_torch._device import resolve_device
from graphsage_torch.data.graph import Graph, reject_lazy_descriptor, with_cached_layer0
from graphsage_torch.models.graphsage import Frontier, GraphSAGE
from graphsage_torch.ops.aggregate import gather, segment_max_csr
from graphsage_torch.ops.gather_mean import gather_mean, gather_mean_int8
from graphsage_torch.ops.quantize import (
    QuantizedTable,
    gather_dequant,
    is_quantized,
    quantize_features,
)
from graphsage_torch.ops.sampling import sample_neighbors
from graphsage_torch.ops.scatter_mean import scatter_mean
from graphsage_torch.parallel import collectives
from graphsage_torch.parallel.halo import _BufferMean, build_node_partition, halo_segment_max
from graphsage_torch.parallel.halo import halo_spmm_mean
from graphsage_torch.parallel.distributed import ShardedLoop, slice_frontier
from graphsage_torch.parallel.mesh import axis_index, axis_size
from graphsage_torch.train.trainer import Trainer


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _rows_per_shard(num_nodes: int, num_shards: int) -> int:
    return _round_up(max(-(-num_nodes // num_shards), 1), 8)


@dataclasses.dataclass(frozen=True)
class NodeShardedFeatures:
    """A rank's node range of the ``[N, F]`` table: ``shard [Np, F]`` (a
    tensor or an int8 ``QuantizedTable``), rows ``[s * Np, (s + 1) * Np)``
    on rank ``s``, zero past ``num_nodes``."""

    shard: torch.Tensor | QuantizedTable
    num_shards: int
    rows_per_shard: int
    num_nodes: int

    def memory_stats(self) -> dict:
        """Bytes per rank against a replicated table, as JAX's (an int8 row
        counts its 4-byte scale)."""
        row = int(self.shard.shape[-1]) * _itemsize(self.shard.dtype)
        row += 4 if is_quantized(self.shard) else 0
        return {
            "num_shards": self.num_shards,
            "rows_per_shard": self.rows_per_shard,
            "feature_bytes_per_chip": self.rows_per_shard * row,
            "feature_bytes_replicated": self.num_nodes * row,
            "memory_reduction": self.num_nodes / max(self.rows_per_shard, 1),
        }


def _cut_rows(host: torch.Tensor, rows: int, index: int, fill=0) -> torch.Tensor:
    """Rows ``[index * rows, (index + 1) * rows)`` of ``host``, padded with
    ``fill`` past its end."""
    n = host.shape[0]
    lo, hi = min(index * rows, n), min((index + 1) * rows, n)
    shard = torch.full((rows, *host.shape[1:]), fill, dtype=host.dtype)
    shard[:hi - lo] = host[lo:hi]
    return shard


def shard_features(features, num_shards: int, index: int, device=None) -> NodeShardedFeatures:
    """Rank ``index``'s node range of ``features [N, F]`` on ``device``
    (default: the table's), cut from a host copy: no full-table buffer is
    made on the device. An int8 ``QuantizedTable`` gives one: ``q`` and
    ``scale`` cut on the same ranges, padding rows of scale 1."""
    reject_lazy_descriptor(features, "shard_features (the shards would be all-zero copies)")
    n = features.shape[0]
    rows = _rows_per_shard(n, num_shards)
    dev = features.device if device is None else device
    if is_quantized(features):
        shard = QuantizedTable(q=_cut_rows(features.q.cpu(), rows, index).to(dev),
                               scale=_cut_rows(features.scale.cpu(), rows, index, 1).to(dev))
    else:
        shard = _cut_rows(features.detach().cpu(), rows, index).to(dev)
    return NodeShardedFeatures(shard=shard, num_shards=num_shards, rows_per_shard=rows,
                               num_nodes=n)


def shard_features_from_loader(row_loader, num_nodes: int, num_feats: int, num_shards: int,
                               index: int, device=None, dtype=torch.float32,
                               quantize: bool = False) -> NodeShardedFeatures:
    """Rank ``index``'s node range of the table, read through ``row_loader(lo,
    hi) -> np.ndarray [hi - lo, F]`` (e.g. :func:`~graphsage_torch.data.
    loaders.load_cora_lazy`'s) and placed on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``): no process ever holds the ``[N, F]``
    table. The loader is asked for this rank's rows only, once, with the
    ownership rule of :func:`shard_features` (padding rows are zero and never
    asked for); the store equals ``shard_features(table, num_shards, index)``
    in ``dtype``.

    ``quantize=True`` quantizes the rank's block by rows (the scales are per
    row, so the owner alone can do it): the store is bitwise
    ``shard_features(quantize_features(table), num_shards, index)``, its
    padding rows at scale 1."""
    rows = _rows_per_shard(num_nodes, num_shards)
    lo, hi = min(index * rows, num_nodes), min((index + 1) * rows, num_nodes)
    block = torch.zeros((rows, num_feats), dtype=torch.float32)
    if hi > lo:
        block[:hi - lo] = torch.from_numpy(np.asarray(row_loader(lo, hi), np.float32))
    dev = resolve_device(device)
    # An all-zero padding row quantizes to scale 1, shard_features' fill.
    shard = (quantize_features(block) if quantize else block.to(dtype)).to(dev)
    return NodeShardedFeatures(shard=shard, num_shards=num_shards, rows_per_shard=rows,
                               num_nodes=num_nodes)


# --------------------------------------------------------------------------
# The dense exchange
# --------------------------------------------------------------------------

class _OwnerExchange(torch.autograd.Function):
    """``apply(table, idx [B, k], mask [B, k], group, normalize)``: the masked
    sums (or means) ``[B, F]`` f32 of this rank's requests over the
    node-sharded table whose local shard is ``table [Np, F]`` (see the
    module docstring). Over an int8 table the owners' sums are kernel 1's
    int8 route and the reduce-scatter moves them in f32: ``4F`` bytes per
    seed row, where JAX's ``sharded_row_gather`` moves ``(F + 4) * k``
    (int8 partial rows and scales for each of the ``k`` slots)."""

    @staticmethod
    def forward(ctx, table, idx, mask, group, normalize):
        np_ = table.shape[0]
        requests = collectives.all_gather_rows(
            torch.where(mask, idx, torch.full_like(idx, -1)), group)
        local = requests - dist.get_rank(group) * np_
        own = (requests >= 0) & (local >= 0) & (local < np_)
        local = torch.where(own, local, torch.zeros_like(local)).contiguous()
        if is_quantized(table):  # a frozen int8 table: its sums, no backward
            partial = gather_mean_int8(table.q, table.scale, local, own, normalize=False)
        else:
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


def sharded_row_gather(mesh: DeviceMesh, axis: str, table_local, ids: torch.Tensor
                       ) -> torch.Tensor:
    """Rows ``[..., F]`` (the table's dtype; f32 for an int8
    :class:`~graphsage_torch.ops.quantize.QuantizedTable`) of the ids
    ``ids`` over a table whose rank ``s`` holds rows ``[s * Np, (s + 1) *
    Np)`` as ``table_local [Np, F]`` (the stride is the local table's row
    count: the node-sharded store's ranges, or a halo plan's stacked
    positions). Its gradient is a scatter-add into the owners' shards."""
    flat = ids.reshape(-1, 1).to(torch.int32).contiguous()
    rows = _OwnerExchange.apply(table_local, flat, torch.ones_like(flat, dtype=torch.bool),
                                mesh.get_group(axis), False)
    if not is_quantized(table_local):
        rows = rows.to(table_local.dtype)
    return rows.reshape(*ids.shape, table_local.shape[-1])


# --------------------------------------------------------------------------
# The compact exchange
# --------------------------------------------------------------------------

# Counting-rank bucketing pays O(q·S) work and a 4·q·S-byte transient; the
# stable sort pays O(q log q). Both give the same buckets; JAX switches at
# 32 shards.
_RANK_SORT_MIN_SHARDS = 32


def request_capacity(q_local: int, num_shards: int, slack: float = 1.5) -> int:
    """Static per-pair request capacity for the compact exchange."""
    base = -(-q_local // num_shards)
    return _round_up(max(int(base * slack), 8), 8)


def _spread_owners(flat_ids: torch.Tensor, valid: torch.Tensor | None, num_shards: int,
                   rows_per_shard: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ids, owner)``: invalid slots moved to ``(i % S) * Np`` (round-robin
    over the owners, so padding cannot pile onto rank 0), and each id's
    owner ``id // Np`` (int64)."""
    if valid is not None:
        spread = (torch.arange(flat_ids.shape[0], dtype=torch.int32,
                               device=flat_ids.device) % num_shards) * rows_per_shard
        flat_ids = torch.where(valid.reshape(-1), flat_ids, spread)
    return flat_ids, (flat_ids // rows_per_shard).long()


def route_buckets(flat_ids: torch.Tensor, num_shards: int, rows_per_shard: int,
                  capacity: int, valid: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket requests ``flat_ids [q]`` (int32 global ids) by owner, with no
    collective: ``(req [S, capacity] int32, take [q] int64, violated)``.
    ``req[d]`` holds, in request order, the ids this rank asks rank ``d``
    for; request ``i`` sits at flat slot ``take[i] = owner * capacity +
    rank_within_owner``. ``violated`` (0-d bool) is set when a bucket
    overflowed: its extra requests were clipped to the last slot. JAX's
    ``_route_requests`` without its all-to-all, but for one thing: a masked
    slot (routed to its spread owner) and an unused one hold -1 where JAX's
    hold the spread id and 0. The owner answers them with its first row,
    the spread id's, and leaves them out of the backward, where JAX's add
    their zero cotangents onto that row."""
    s = num_shards
    flat, owner = _spread_owners(flat_ids.to(torch.int32), valid, s, rows_per_shard)
    q = flat.shape[0]
    dev = flat.device
    if s <= _RANK_SORT_MIN_SHARDS:
        onehot = owner[:, None] == torch.arange(s, device=dev)[None, :]
        within = torch.cumsum(onehot.to(torch.int32), dim=0, dtype=torch.int32)
        rank = within.gather(1, owner[:, None])[:, 0].long() - 1
    else:
        order = torch.argsort(owner, stable=True)
        sorted_owner = owner[order]
        starts = torch.searchsorted(sorted_owner, torch.arange(s, device=dev))
        sorted_rank = torch.arange(q, device=dev) - starts[sorted_owner]
        rank = torch.empty_like(sorted_rank).scatter_(0, order, sorted_rank)
    violated = (rank >= capacity).any()
    take = owner * capacity + rank.clamp(max=capacity - 1)
    req = torch.full((s * capacity,), -1, dtype=torch.int32, device=dev)
    req[take] = flat if valid is None else torch.where(valid.reshape(-1), flat, -1)
    return req.view(s, capacity), take, violated


class _OwnerRows(torch.autograd.Function):
    """``apply(table [Np, F], loc [S * cap], live [S * cap])``: the owner's
    answer rows ``table[loc]`` (an ``index_select``, JAX's ``take``); the
    backward adds each live slot's cotangent into the shard's gradient,
    Hopper kernel 2 in its sum mode with one slot per row."""

    @staticmethod
    def forward(ctx, table, loc, live):
        ctx.save_for_backward(loc, live)
        ctx.num_rows, ctx.dtype = table.shape[0], table.dtype
        return table.index_select(0, loc.long())

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        loc, live = ctx.saved_tensors
        d = scatter_mean(g.to(torch.float32).contiguous(), loc.view(-1, 1),
                         live.view(-1, 1), ctx.num_rows, normalize=False)
        return d.to(ctx.dtype), None, None


def _compact_lookup(mesh: DeviceMesh, axis: str, table_local: torch.Tensor,
                    flat_ids: torch.Tensor, valid: torch.Tensor | None, capacity: int,
                    hub=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(buffer [S * cap + H, F], take [q])``: the answer buffer of this
    rank's requests ``flat_ids`` and, for each request, its row there. With
    ``hub = (lookup [N], rows [H, F])`` hub requests enter the route masked
    and point at the buffer's last ``H`` rows, a copy of ``rows``. Over an
    int8 table (and its int8 hub rows) the buffer is a ``QuantizedTable``:
    the ``q`` answers and their scales, routed apart."""
    group = mesh.get_group(axis)
    s, np_ = axis_size(mesh, axis), table_local.shape[0]
    flat = flat_ids.reshape(-1).to(torch.int32)
    routed = valid
    if hub is not None:
        lookup, hub_rows = hub
        hub_rank = lookup[flat.long()]
        is_hub = hub_rank >= 0
        routed = ~is_hub if valid is None else valid.reshape(-1) & ~is_hub
    req, take, _ = route_buckets(flat, s, np_, capacity, routed)
    recv = collectives.RouteIds.apply(req, group).reshape(-1)
    loc = (recv - dist.get_rank(group) * np_).clamp_(0, np_ - 1)

    def route(answers, tail):
        return collectives.RouteAnswers.apply(answers.view(s, capacity, -1), group, tail)

    if is_quantized(table_local):
        rows = loc.long()
        buffer = QuantizedTable(
            q=route(table_local.q.index_select(0, rows), None if hub is None else hub_rows.q),
            scale=route(table_local.scale.index_select(0, rows),
                        None if hub is None else hub_rows.scale))
    else:
        buffer = route(_OwnerRows.apply(table_local, loc, recv >= 0),
                       None if hub is None else hub_rows)
    if hub is not None:
        take = torch.where(is_hub, s * capacity + hub_rank.long(), take)
    return buffer, take


def sharded_row_gather_compact(mesh: DeviceMesh, axis: str, table_local: torch.Tensor,
                               ids: torch.Tensor, capacity: int,
                               valid_mask: torch.Tensor | None = None,
                               hub=None) -> torch.Tensor:
    """Rows ``[..., F]`` (the table's dtype; f32 for an int8 table, read
    from the int8 answer buffer) of ``ids`` through the compact exchange
    (see the module docstring); a masked slot's row is that of the id its
    slot was spread to, as JAX's. ``capacity`` must cover every bucket; the
    trainers check it before the call."""
    buffer, take = _compact_lookup(mesh, axis, table_local, ids, valid_mask, capacity, hub)
    rows = gather_dequant(buffer, take) if is_quantized(buffer) else gather(buffer, take)
    return rows.reshape(*ids.shape, buffer.shape[-1])


def sharded_gather_mean_compact(mesh: DeviceMesh, axis: str, table_local: torch.Tensor,
                                idx: torch.Tensor, mask: torch.Tensor, capacity: int,
                                hub=None) -> torch.Tensor:
    """The masked gather-mean ``[B, F]`` f32 of ``idx``/``mask`` through the
    compact exchange: Hopper kernel 1 (mean mode) over the answer buffer, its
    backward kernel 2 (mean mode) into the buffer's gradient; kernel 1's
    int8 route over an int8 answer buffer and its scales."""
    b, k = idx.shape
    buffer, take = _compact_lookup(mesh, axis, table_local, idx, mask, capacity, hub)
    slots = take.to(torch.int32).view(b, k)
    if is_quantized(buffer):
        return gather_mean_int8(buffer.q, buffer.scale, slots, mask.contiguous())
    return gather_mean(buffer, slots, mask.contiguous())


def make_sharded_gather_fns(mesh: DeviceMesh, axis: str, mode: str = "dense",
                            slack: float = 1.5, hub=None):
    """``(gather_fn, gather_mean_fn)`` for :meth:`GraphSAGE.forward` where
    the table argument is this rank's node-range shard. ``mode="dense"`` is
    exact for any id distribution; ``mode="compact"`` routes requests, each
    call site's per-pair capacity :func:`request_capacity` of its request
    count with ``slack``, and ``hub`` (``(lookup, rows)`` on the device,
    compact only) serves the hub rows locally."""
    if mode == "dense":
        def gather_fn(table_local, ids, mask=None):
            return sharded_row_gather(mesh, axis, table_local, ids)

        def gather_mean_fn(table_local, idx, mask):
            return sharded_gather_mean(mesh, axis, table_local, idx, mask)

        return gather_fn, gather_mean_fn
    if mode != "compact":
        raise ValueError(f"unknown sharded gather mode {mode!r}")
    s = axis_size(mesh, axis)

    def gather_fn(table_local, ids, mask=None):
        cap = request_capacity(ids.numel(), s, slack)
        return sharded_row_gather_compact(mesh, axis, table_local, ids, cap, mask, hub)

    def gather_mean_fn(table_local, idx, mask):
        cap = request_capacity(idx.numel(), s, slack)
        return sharded_gather_mean_compact(mesh, axis, table_local, idx, mask, cap, hub)

    return gather_fn, gather_mean_fn


def compact_sites(model: GraphSAGE, frontier: Frontier, fanouts=None) -> list:
    """``(ids, mask)`` of each table lookup of ``model``'s forward on
    ``frontier`` (``fanouts`` overrides the model's, as an evaluation's do):
    what the compact exchange routes, so that the capacity check and the
    traffic count see exactly its requests."""
    L = model.num_layers
    if model.layer0 in ("full", "cached"):
        sites = [(frontier.ids[L - 1], frontier.masks[L - 1])]
        if model.layer0 == "cached" and model.concat_self:
            sites.append((frontier.ids[L - 1], frontier.masks[L - 1]))
        return sites
    if model.aggregator != "mean":
        return [(frontier.ids[L], frontier.masks[L])]
    n_out = frontier.ids[L - 1].shape[0]
    k = (model.fanouts if fanouts is None else tuple(fanouts))[0]
    if k is not None:
        k_eff = k + 1 if (model.concat_self or model.self_loop) else k
        if frontier.ids[L].shape[0] != n_out * k_eff:
            raise ValueError(
                f"frontier hop {L} has {frontier.ids[L].shape[0]} slots but the "
                f"model's layout (fanout {k}, concat_self={model.concat_self}, "
                f"self_loop={model.self_loop}) requires {n_out} x {k_eff} — the "
                "frontier does not come from this model's sample()")
    ids2 = frontier.ids[L].reshape(n_out, -1)
    m2 = frontier.masks[L].reshape(n_out, -1)
    if model.concat_self:
        return [(ids2[:, 1:], m2[:, 1:]), (frontier.ids[L - 1], frontier.masks[L - 1])]
    return [(ids2, m2)]


def _frontier_slot_sizes(model: GraphSAGE, b_local: int) -> list[int]:
    """Slots per hop of a ``b_local``-seed frontier, from the fanouts alone
    (integer fanouts only)."""
    L = model.num_layers
    hops = L - 1 if model.layer0 in ("full", "cached") else L
    sizes = [b_local]
    for h in range(1, hops + 1):
        k = model.fanouts[L - h]
        if k is None:
            raise ValueError(
                "comm stats need integer fanouts (fanout=None means "
                "full-neighborhood width, which the sharded sampled "
                "trainers do not run)")
        k_eff = k + 1 if (model.concat_self or model.self_loop) else k
        sizes.append(sizes[-1] * k_eff)
    return sizes


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def sharded_comm_stats(
    model: GraphSAGE,
    batch_size: int,
    num_shards: int,
    feature_dtype=torch.float32,
    slack: float = 1.5,
    fully_sharded: bool = False,
    num_nodes: int | None = None,
    layer0_partition=None,
    quantized: bool = False,
) -> dict:
    """Bytes each rank sends per step in the sharded trainers' exchanges,
    from the shapes alone, JAX's numbers: the dense and compact feature
    gathers per call site and, with ``fully_sharded``, the sampling hops
    (ids out, sampled ids and masks back). The exchanged rows are
    ``hidden_dims[0]``-wide f32 when a mean layer 0 projects first by the
    JAX package's rule for injected gathers
    (:meth:`GraphSAGE.injected_layer0_project_first`; this port's trainers
    decide per batch, by :meth:`GraphSAGE.sampled_layer0_project_first`),
    ``F + 4`` bytes for a ``quantized`` (int8) table's rows. With
    ``layer0="full"`` and ``num_nodes`` the layer-0 table build's all-gather
    is counted too, and the halo plan's boundary rows given
    ``layer0_partition`` (a :class:`~graphsage_torch.parallel.halo.
    NodePartition` of ``bounds="equal_nodes"``)."""
    if batch_size % num_shards:
        raise ValueError("batch_size must be divisible by num_shards")
    s = num_shards
    sizes = _frontier_slot_sizes(model, batch_size // s)
    fr = Frontier(ids=tuple(torch.zeros(n, dtype=torch.int32) for n in sizes),
                  masks=tuple(torch.ones(n, dtype=torch.bool) for n in sizes))
    if model.layer0 == "full":
        row_bytes = model.hidden_dims[0] * _itemsize(model.compute_dtype or feature_dtype)
    elif model.layer0 == "cached":
        row_bytes = model.in_dim + 4 if quantized else model.in_dim * _itemsize(feature_dtype)
    elif model.injected_layer0_project_first(quantized):
        row_bytes = model.hidden_dims[0] * 4
    elif quantized:
        row_bytes = model.in_dim + 4
    else:
        row_bytes = model.in_dim * _itemsize(feature_dtype)
    dense = compact = 0
    site_detail = []
    for ids, _ in compact_sites(model, fr):
        q = ids.numel()
        cap = request_capacity(q, s, slack)
        d = (s - 1) * q * (row_bytes + 4)
        c = (s - 1) * cap * (row_bytes + 4)
        dense += d
        compact += c
        site_detail.append({"q_local": q, "capacity": cap, "dense_bytes": d,
                            "compact_bytes": c})
    out = {
        "num_shards": s,
        "per_chip_frontier_slots": sizes[-1],
        "gather_dense_bytes_per_chip_step": dense,
        "gather_compact_bytes_per_chip_step": compact,
        "gather_compact_vs_dense": dense / max(compact, 1),
        "sites": site_detail,
    }
    if model.layer0 == "full" and num_nodes is not None:
        # The table build all-gathers every rank's [Np, d] rows once a step
        # (the backward's reduce-scatter moves as much again).
        np_ = _rows_per_shard(num_nodes, s)
        d_proj = (model.hidden_dims[0] if model.use_project_first(0, model.in_dim)
                  else model.in_dim)
        itemsize = _itemsize(model.compute_dtype or feature_dtype)
        out["layer0_allgather_bytes_per_chip_step"] = (s - 1) * np_ * d_proj * itemsize
        if layer0_partition is not None:
            rows = layer0_partition.comm_stats()["rows_exchanged_per_shard"]
            out["layer0_halo_bytes_per_chip_step"] = rows * d_proj * itemsize
    if fully_sharded:
        samp = 0
        hop_detail = []
        L = model.num_layers
        for h in range(1, len(sizes)):
            q_h, k = sizes[h - 1], model.fanouts[L - h]
            cap = request_capacity(q_h, s, slack)
            v = (s - 1) * cap * (4 + k * 5)
            samp += v
            hop_detail.append({"hop": h, "q_local": q_h, "capacity": cap, "bytes": v})
        out["sampling_bytes_per_chip_step"] = samp
        out["sampling_hops"] = hop_detail
        out["total_compact_bytes_per_chip_step"] = compact + samp
    return out


# --------------------------------------------------------------------------
# The hub cache
# --------------------------------------------------------------------------

def hub_request_fraction(degrees: torch.Tensor, num_hub_rows: int) -> float:
    """The share of sampled requests a ``num_hub_rows``-row hub cache serves
    locally: a uniform neighbour draw lands on ``v`` once per incident edge,
    so it is the top-``H`` nodes' share of the total ``degrees``."""
    deg = degrees.cpu().numpy().astype(np.float64)
    total = deg.sum()
    if total <= 0:
        return 0.0
    top = np.sort(deg)[::-1][:int(num_hub_rows)]
    return float(top.sum() / total)


def build_hub_cache(features, degrees: torch.Tensor, num_hub_rows: int):
    """``(lookup [N] int32, rows [H, F])``: the ``num_hub_rows``
    highest-degree nodes (a stable sort, ties by id) of a frozen table,
    ``lookup`` each node's hub rank or -1, ``rows`` their rows, on the
    table's device. Exact for ever: the table is frozen. Over an int8
    ``QuantizedTable`` the rows stay int8, a ``QuantizedTable`` of their
    ``q`` rows and scales that rides at the tail of the int8 answer buffer;
    dequantized they are bitwise JAX's f32 ``q * scale`` rows."""
    deg = degrees.cpu().numpy()
    n = deg.shape[0]
    h = int(num_hub_rows)
    if not 0 < h <= n:
        raise ValueError(f"num_hub_rows must be in (0, {n}], got {h}")
    top = np.argsort(-deg, kind="stable")[:h].astype(np.int32)
    lookup = np.full(n, -1, np.int32)
    lookup[top] = np.arange(h, dtype=np.int32)
    pick = torch.from_numpy(top.astype(np.int64)).to(features.device)
    if is_quantized(features):
        rows = QuantizedTable(q=features.q[pick].contiguous(),
                              scale=features.scale[pick].contiguous())
    else:
        rows = features[pick].contiguous()
    return torch.from_numpy(lookup).to(features.device), rows


# --------------------------------------------------------------------------
# The layer-0 table of layer0="full" over the node-sharded store
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardEdgeSlices:
    """A rank's COO edge slice for the sharded layer-0 table: the edges whose
    source (the aggregating node) lies in its node range, ``edge_src [Em]``
    local rows, ``edge_dst [Em]`` global neighbour ids (rows of the
    all-gathered buffer), ``edge_mask [Em]`` and the true ``degrees [Np]``
    of its rows; ``Em`` is the largest range's edge count rounded up to
    128."""

    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_mask: torch.Tensor
    degrees: torch.Tensor
    num_shards: int
    rows_per_shard: int


def shard_edge_slices(graph: Graph, num_shards: int, index: int,
                      device=None) -> ShardEdgeSlices:
    """Rank ``index``'s slice of ``graph``'s CSR edges (the ownership rule of
    :func:`shard_features`), cut on the host and placed on ``device``
    (default: the graph's): JAX's ``shard_edge_slices(...)`` at ``index``."""
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    edge_dst = graph.edge_dst.cpu().numpy()
    edge_mask = graph.edge_mask.cpu().numpy()
    deg = graph.degrees.cpu().numpy()
    n = graph.num_nodes
    rows = _rows_per_shard(n, num_shards)
    e_max = _round_up(max([1] + [int(indptr[min(s * rows + rows, n)] - indptr[min(s * rows, n)])
                                 for s in range(num_shards)]), 128)
    lo, hi = min(index * rows, n), min(index * rows + rows, n)
    e = int(indptr[hi] - indptr[lo])
    src = np.zeros(e_max, np.int32)
    dst = np.zeros(e_max, np.int32)
    msk = np.zeros(e_max, bool)
    deg_s = np.zeros(rows, np.int32)
    deg_s[:hi - lo] = deg[lo:hi]
    src[:e] = np.repeat(np.arange(hi - lo), np.diff(indptr[lo:hi + 1]))
    dst[:e] = edge_dst[indptr[lo]:indptr[hi]]
    msk[:e] = edge_mask[indptr[lo]:indptr[hi]]
    dev = graph.device if device is None else device
    place = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return ShardEdgeSlices(edge_src=place(src), edge_dst=place(dst), edge_mask=place(msk),
                           degrees=place(deg_s), num_shards=num_shards, rows_per_shard=rows)


def local_edges_from_adjacency(indptr_local: torch.Tensor, edge_dst_local: torch.Tensor,
                               rows_per_shard: int
                               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(e_src, e_dst, e_mask)``, the COO slice of a :class:`ShardedAdjacency`
    shard's local CSR (``e_src`` local rows, ``e_dst`` its ``edge_dst``
    itself, global ids), as JAX's: derived, not a second copy of the
    edges."""
    pos = torch.arange(edge_dst_local.shape[0], dtype=indptr_local.dtype,
                       device=indptr_local.device)
    e_src = (torch.searchsorted(indptr_local, pos, right=True) - 1).clamp(
        0, rows_per_shard - 1).to(torch.int32)
    return e_src, edge_dst_local, pos < indptr_local[rows_per_shard]


class LocalCSR(NamedTuple):
    """A rank's edges as kernel 3 reads them over an exchanged buffer (the
    fields ``halo._BufferMean`` reads of a halo shard): ``indptr [Np + 1]``
    over ``cols`` (each edge's buffer row, by local row), the transpose
    ``t_indptr [width + 1]`` over ``t_cols`` (each edge's local row, by
    buffer row) for the backward, and ``count [Np]`` f32, the rows' edge
    counts."""

    indptr: torch.Tensor
    cols: torch.Tensor
    t_indptr: torch.Tensor
    t_cols: torch.Tensor
    count: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def local_csr(indptr: np.ndarray, cols: np.ndarray, width: int, device) -> LocalCSR:
    """The :class:`LocalCSR` of a host CSR ``indptr [R + 1]`` over ``cols``
    (read up to ``indptr[R]``) into a ``width``-row buffer, on ``device``."""
    indptr = np.asarray(indptr, np.int64)
    cols = np.asarray(cols[:int(indptr[-1])], np.int64)
    rows = np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))
    by_col = np.argsort(cols, kind="stable")
    t_indptr = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=width))])

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return LocalCSR(indptr=put(indptr, torch.int32), cols=put(cols, torch.int32),
                    t_indptr=put(t_indptr, torch.int32), t_cols=put(rows[by_col], torch.int32),
                    count=put(np.diff(indptr), torch.float32))


def slices_csr(slices: ShardEdgeSlices, device) -> LocalCSR:
    """The :class:`LocalCSR` of an edge slice's valid edges, into the
    ``[S * Np]``-row all-gathered buffer."""
    mask = slices.edge_mask.cpu().numpy()
    src = slices.edge_src.cpu().numpy()[mask]
    dst = slices.edge_dst.cpu().numpy()[mask]
    order = np.argsort(src, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=slices.rows_per_shard))])
    return local_csr(indptr, dst[order], slices.num_shards * slices.rows_per_shard, device)


def make_sharded_spmm(mesh: DeviceMesh, axis: str, csr: LocalCSR):
    """The ``spmm`` closure of :meth:`GraphSAGE.layer0_full_table` over the
    node-sharded store: every rank's (projected) ``[Np, d]`` rows
    all-gathered into the ``[S * Np, d]`` buffer (backward: the sum
    reduce-scatter), then Hopper kernel 3 over the rank's CSR, the guarded
    mean, and over the transposed CSR on ``g / max(deg, 1)`` (rounded to the
    buffer's dtype) in the backward (``halo._BufferMean``). Returns ``(mean
    [Np, d], count [Np])``."""
    group = mesh.get_group(axis)

    def spmm(x_local):
        buf = collectives.AllGatherRows.apply(x_local, group)
        return _BufferMean.apply(buf, csr), csr.count

    return spmm


def make_sharded_segmax(mesh: DeviceMesh, axis: str, edge_src: torch.Tensor,
                        edge_dst: torch.Tensor, edge_mask: torch.Tensor, rows_per_shard: int):
    """The max-pool counterpart of :func:`make_sharded_spmm` (the ``segmax``
    closure): the pooled ``[Np, pd]`` rows all-gathered, then the guarded
    segment max of the rank's edge slice (a PyTorch op, as on one
    device)."""
    group = mesh.get_group(axis)

    def segmax(pooled_local):
        buf = collectives.AllGatherRows.apply(pooled_local, group)
        return segment_max_csr(gather(buf, edge_dst), edge_src, edge_mask, rows_per_shard)

    return segmax


# --------------------------------------------------------------------------
# ShardedFeatureTrainer
# --------------------------------------------------------------------------

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

    ``gather_mode="compact"`` routes the lookups in buckets of
    ``capacity_slack`` times the even share (:func:`request_capacity`). A
    step whose buckets would overflow on any rank is not applied: the
    parameters, the optimizer and the step count stay, the generator is
    rewound, and the same frontier is redone at twice the slack (a warning
    each time), up to 8 times the configured slack; then it raises.
    ``hub_cache_rows`` (compact only, frozen tables only) replicates that
    many highest-degree rows (:func:`build_hub_cache`).

    The table may be int8 (a ``QuantizedTable``; a cached model's cache is
    then built int8 too). ``layer0="full"`` builds the rank's ``[Np, d0]``
    slice of the layer-0 table every step (see the module docstring):
    ``layer0_exchange="allgather"`` moves every rank's projected rows,
    ``"halo"`` only the boundary rows, through the halo plan of
    ``build_node_partition(graph, S, bounds="equal_nodes",
    **layer0_halo_kwargs)`` (``sizing``, ``hub_threshold``, ``halo_chunks``).

    Pass the graph on the CPU: the device then holds the adjacency, the
    labels and this rank's ``Np`` rows (a graph on the device works too, but
    its table stays where the caller keeps it). Evaluation with
    ``eval_fanouts`` runs through the sharded gather (a compact batch that
    would overflow goes through the dense exchange, with a warning); with
    ``None`` it is the full-graph forward over a transient device copy of
    the graph, freed on return. Rank 0 alone writes checkpoints.

    ``feature_store`` is a prebuilt store of this rank's rows
    (:func:`shard_features_from_loader` over a ``load_*_lazy`` row loader):
    the graph's feature leaf is then a descriptor that is never read, so
    evaluation must be sampled (``eval_fanouts``), a cached model needs the
    graph's prebuilt cache, and ``hub_cache_rows`` is refused, each at
    construction, as in the JAX package."""

    # Overflow retry ladder: capacity_slack * 2**i for i < _SLACK_RETRIES.
    _SLACK_RETRIES = 4

    # FullyShardedTrainer reads layer 0's edges off its sharded adjacency.
    _layer0_edges_from_adjacency = False

    def __init__(self, model: GraphSAGE, graph: Graph, config, mesh: DeviceMesh,
                 axis: str = "data", gather_mode: str = "dense",
                 capacity_slack: float = 1.5, layer0_exchange: str = "allgather",
                 layer0_halo_kwargs: dict | None = None, feature_store=None,
                 hub_cache_rows: int = 0):
        if gather_mode not in ("dense", "compact"):
            raise ValueError(f"unknown gather_mode {gather_mode!r}")
        if layer0_exchange not in ("allgather", "halo"):
            raise ValueError(f"unknown layer0_exchange {layer0_exchange!r}")
        if layer0_exchange == "halo" and self._layer0_edges_from_adjacency:
            raise ValueError(
                "layer0_exchange='halo' is ShardedFeatureTrainer-only: the "
                "halo plan is a second edge copy, which FullyShardedTrainer "
                "exists to avoid (it derives layer-0 edges from its sharded "
                "adjacency)")
        self.layer0_exchange = layer0_exchange
        self.layer0_halo_kwargs = dict(layer0_halo_kwargs or {})
        self.mesh, self.axis = mesh, axis
        self.gather_mode = gather_mode
        self.capacity_slack = capacity_slack
        self.num_shards = axis_size(mesh, axis)
        self.shard_index = axis_index(mesh, axis)
        self._group = mesh.get_group(axis)
        if config.batch_size % self.num_shards:
            raise ValueError(
                f"batch_size {config.batch_size} must be divisible by the "
                f"{axis!r} axis size {self.num_shards}"
            )
        if feature_store is not None:
            self._check_feature_store(feature_store, model, graph, config)
        self._external_store = feature_store
        self.hub_cache_rows = int(hub_cache_rows)
        if self.hub_cache_rows:
            _check_hub_cache(model, gather_mode, graph, external_store=feature_store is not None)
        super().__init__(model, graph, config)

    def _check_feature_store(self, store: NodeShardedFeatures, model: GraphSAGE,
                             graph: Graph, config) -> None:
        """JAX's construction checks of a prebuilt store: a cached model
        needs the graph's prebuilt cache (no process holds the table to build
        one), the store must cover the graph's nodes on this axis's shards,
        and evaluation must be sampled (``run`` ends in it, and the
        ``eval_fanouts=None`` full-graph forward needs the table)."""
        if model.layer0 == "cached" and graph.layer0_cache is None:
            raise ValueError(
                "layer0='cached' needs the full feature table to build "
                "the aggregate cache, but this trainer was given a "
                "loader feature_store (no host ever held the full "
                "[N, F] array) — precompute the cache offline and "
                "attach it to the graph, or use layer0='sampled'")
        if store.num_nodes != graph.num_nodes:
            raise ValueError(
                f"feature_store covers {store.num_nodes} nodes, graph has {graph.num_nodes}")
        if store.num_shards != self.num_shards:
            raise ValueError(
                f"feature_store has {store.num_shards} shards, mesh axis "
                f"{self.axis!r} has {self.num_shards}")
        if config.eval_fanouts is None:
            raise ValueError(
                "feature_store trainers have no full feature table, so "
                "the eval_fanouts=None full-graph eval cannot run — set "
                "TrainConfig(eval_fanouts=...) to evaluate through the "
                "sharded gather")

    def _prepare_graph(self, model: GraphSAGE, graph: Graph) -> Graph:
        """Shard the table (and a cached model's cache) from a host copy,
        and return the device graph without them: the adjacency and the
        labels, with a one-row placeholder table. A cache the graph lacks is
        built on the model's device (Hopper kernel 3 on a card) from a
        transient copy of the graph, freed once the host copy is made (int8
        over an int8 table). The hub cache comes from the table the lookups
        read; ``layer0="full"``'s edges (:meth:`_layer0_closures`) from the
        host copy."""
        if model.layer0 == "cached" and graph.layer0_cache is None:
            graph = with_cached_layer0(graph.to(model.device), self_loop=model.self_loop,
                                       quantize=is_quantized(graph.features))
        host = graph.to("cpu")
        del graph
        if model.layer0 == "cached":
            model.check_layer0_cache(host)
        self._source_graph = host
        s, i, dev = self.num_shards, self.shard_index, model.device
        store = self._external_store
        if store is None:
            self.features = shard_features(host.features, s, i, dev)
        else:  # the caller's store, on the model's device
            self.features = (store if store.shard.device == dev
                             else dataclasses.replace(store, shard=store.shard.to(dev)))
        self._cache_store = (None if host.layer0_cache is None or model.layer0 != "cached"
                             else shard_features(host.layer0_cache, s, i, dev))
        self._hub = None
        if self.hub_cache_rows:
            table = host.layer0_cache if model.layer0 == "cached" else host.features
            lookup, rows = build_hub_cache(table, host.degrees, self.hub_cache_rows)
            self._hub = (lookup.to(dev), rows.to(dev))
        device_graph = self._device_graph(host, dev)
        self._layer0_edge_bytes, self._layer0_halo = 0, None
        self._layer0_fns = self._layer0_closures(model, host) if model.layer0 == "full" else None
        return device_graph

    def _layer0_closures(self, model: GraphSAGE, host: Graph) -> dict:
        """``layer0="full"``'s ``spmm`` or ``segmax`` closure over this rank's
        rows (:meth:`GraphSAGE.layer0_full_table`), built once: the halo
        plan's shard, or the rank's edge slice (as a :class:`LocalCSR` for
        kernel 3, or as it is for the max-pool layer's segment max). Sets
        ``_layer0_edge_bytes``, their device bytes."""
        s, i, dev = self.num_shards, self.shard_index, model.device
        np_ = self.features.rows_per_shard
        group = self._group
        if self.layer0_exchange == "halo":
            # The store holds the rank's rows: the plan is built without the
            # table (its h0 is zero columns wide).
            featureless = dataclasses.replace(host, features=torch.zeros((host.num_nodes, 0)),
                                              num_features=0)
            part = build_node_partition(featureless, s, bounds="equal_nodes",
                                        **self.layer0_halo_kwargs)
            if part.nodes_per_shard != np_:
                raise AssertionError(f"halo plan rows {part.nodes_per_shard} != store rows {np_}")
            self._layer0_part = part
            shard = self._layer0_halo = part.local(i, dev)
            self._layer0_edge_bytes = sum(
                t.numel() * t.element_size() for t in vars(shard).values()
                if isinstance(t, torch.Tensor))
            return dict(spmm=lambda x: halo_spmm_mean(shard, x, group),
                        segmax=lambda p: halo_segment_max(shard, p, group))
        slices = shard_edge_slices(host, s, i, "cpu")
        if model.aggregator == "mean":
            csr = slices_csr(slices, dev)
            self._layer0_edge_bytes = csr.nbytes
            return dict(spmm=make_sharded_spmm(self.mesh, self.axis, csr))
        e_src, e_dst, e_mask = (t.to(dev) for t in (slices.edge_src, slices.edge_dst,
                                                    slices.edge_mask))
        self._layer0_edge_bytes = sum(t.numel() * t.element_size() for t in (e_src, e_dst, e_mask))
        return dict(segmax=make_sharded_segmax(self.mesh, self.axis, e_src, e_dst, e_mask, np_))

    def _device_graph(self, host: Graph, device) -> Graph:
        blank = torch.zeros((1, host.num_features), dtype=host.features.dtype)
        return dataclasses.replace(host, features=blank, layer0_cache=None).to(device)

    def _injected(self, slack: float | None = None, mode: str | None = None) -> dict:
        """:meth:`GraphSAGE.forward`'s injected lookups over the store, and
        its ``layer0_table``: the cache's shard, or ``layer0="full"``'s table
        slice built here (under autograd when the caller is)."""
        mode = mode or self.gather_mode
        gather_fn, gather_mean_fn = make_sharded_gather_fns(
            self.mesh, self.axis, mode,
            slack=self.capacity_slack if slack is None else slack,
            hub=self._hub if mode == "compact" else None)
        shard = self.features.shard
        if self._layer0_fns is not None:
            table = self.model.layer0_full_table(shard, None, **self._layer0_fns)
        else:
            table = None if self._cache_store is None else self._cache_store.shard
        # A compact int8 answer row is F + 4 bytes; the dense exchange's 4F.
        row_bytes = (shard.shape[-1] + 4 if mode == "compact" and is_quantized(shard)
                     else None)
        return dict(gather_fn=gather_fn, gather_mean_fn=gather_mean_fn, layer0_table=table,
                    exchange_ranks=self.num_shards, exchange_row_bytes=row_bytes)

    # ------------------------------------------------------------ capacity
    def _local_sites_violated(self, frontier: Frontier, slack: float | None = None,
                              fanouts=None) -> torch.Tensor:
        """0-d bool: whether a lookup of this rank's ``frontier`` would
        overflow a compact bucket at ``slack`` (the trainer's by default):
        the sites, the spread of masked slots and the hub rows as the
        compact gather routes them."""
        s, np_ = self.num_shards, self.features.rows_per_shard
        slack = self.capacity_slack if slack is None else slack
        violated = torch.zeros((), dtype=torch.bool, device=self.device)
        for ids, mask in compact_sites(self.model, frontier, fanouts):
            cap = request_capacity(ids.numel(), s, slack)
            flat = ids.reshape(-1).to(torch.int32)
            valid = mask.reshape(-1)
            if self._hub is not None:
                valid = valid & (self._hub[0][flat.long()] < 0)
            _, owner = _spread_owners(flat, valid, s, np_)
            violated = violated | (torch.bincount(owner, minlength=s).max() > cap)
        return violated

    def _violated_anywhere(self, violated: torch.Tensor) -> bool:
        """Whether any rank's flag is set: one all-reduce and one host read."""
        return bool(collectives.all_reduce(violated.to(torch.int32), self._group,
                                           op=dist.ReduceOp.MAX))

    def _with_retries(self, attempt, what: str = "sharded request capacity"):
        """Run ``attempt(slack)`` at the configured slack, then doubled, up to
        ``_SLACK_RETRIES`` slacks, until it returns something else than
        ``None`` (``None``: a bucket would have overflowed and nothing was
        applied); the generator is rewound before each retry."""
        slacks = [float(self.capacity_slack) * 2.0 ** i for i in range(self._SLACK_RETRIES)]
        for i, slack in enumerate(slacks):
            state = self.generator.get_state()
            out = attempt(slack)
            if out is not None:
                return out
            self.generator.set_state(state)
            if i + 1 < len(slacks):
                warnings.warn(
                    f"{what} exceeded at slack={slack} (step NOT applied); redoing "
                    f"the same batch with slack={slacks[i + 1]}; set "
                    "capacity_slack higher to avoid it")
        raise ValueError(
            f"{what} still exceeded after retries up to slack={slacks[-1]}: a "
            "per-pair request bucket overflowed (rows would be clipped). Raise "
            "capacity_slack explicitly (ShardedFeatureTrainer alternatively "
            "supports gather_mode='dense'; the fully sharded trainer is "
            "compact-only).")

    # ------------------------------------------------------------------- step
    def step(self, seeds: np.ndarray) -> torch.Tensor:
        """One optimizer step on the batch ``seeds`` (the same on every
        rank); returns the mean of the ranks' losses, a 0-d tensor. In the
        compact mode a step that would overflow is redone (see the class
        docstring)."""
        ids = torch.from_numpy(np.asarray(seeds, dtype=np.int32)).to(self.device)
        if self.gather_mode == "dense":
            return self._attempt(ids, self.capacity_slack)
        return self._with_retries(lambda slack: self._attempt(ids, slack))

    def _attempt(self, ids: torch.Tensor, slack: float) -> torch.Tensor | None:
        frontier = slice_frontier(self.model.sample(self.generator, self.graph, ids),
                                  self.shard_index, self.num_shards)
        if self.gather_mode == "compact" and self._violated_anywhere(
                self._local_sites_violated(frontier, slack)):
            return None
        loss = self.model.loss(self.features.shard, frontier,
                               self.graph.labels[frontier.ids[0].long()],
                               **self._injected(slack))
        return self._mean_over(self._update(loss), self._group, self.num_shards)

    def _reduce_gradients(self) -> None:
        collectives.average_gradients(self.model.parameters(), self._group, self.num_shards)

    # ------------------------------------------------------------------- eval
    def _padded(self, nodes: np.ndarray) -> torch.Tensor:
        """``nodes`` padded with node 0 to a multiple of S, on the device."""
        pad = np.zeros((-len(nodes)) % self.num_shards, np.int32)
        return torch.from_numpy(np.concatenate([np.asarray(nodes, np.int32), pad])).to(
            self.device)

    def _sampled_eval(self, nodes: np.ndarray, return_embeddings: bool = False
                      ) -> torch.Tensor:
        """Every rank's sampled forward of its slice of ``nodes`` (padded to
        a multiple of S) at ``eval_fanouts`` from a generator seeded ``seed +
        7``, gathered: ``[len(nodes), C]`` logits (or embeddings). A compact
        batch that would overflow at the configured slack goes through the
        dense exchange instead, with a warning."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 7)
        frontier = slice_frontier(
            self.model.sample(gen, self.graph, self._padded(nodes), self.cfg.eval_fanouts),
            self.shard_index, self.num_shards)
        mode = self.gather_mode
        if mode == "compact" and self._violated_anywhere(
                self._local_sites_violated(frontier, fanouts=self.cfg.eval_fanouts)):
            warnings.warn(
                "compact sharded-gather capacity exceeded during eval; falling "
                "back to the dense exchange for this batch — increase "
                "capacity_slack to keep eval on the compact path")
            mode = "dense"
        out = self.model(self.features.shard, frontier, return_embeddings,
                         **self._injected(mode=mode))
        return collectives.all_gather_rows(out, self._group)[:len(nodes)]

    def _transient_full_graph(self) -> Graph:
        self._require_full_table("the eval_fanouts=None full-graph eval")
        return super()._transient_full_graph()

    def _require_full_table(self, what: str) -> None:
        """A loader-built store has no full table anywhere: the graph's
        feature leaf is a descriptor, and ``what`` would read zeros."""
        if self._external_store is not None:
            raise ValueError(
                f"{what} needs the full feature table, but this trainer "
                "was built from a feature_store (no host ever held the "
                "full [N, F] array); set eval_fanouts to evaluate through "
                "the sharded gather instead")

    @torch.no_grad()
    def predict(self, nodes: np.ndarray) -> np.ndarray:
        """Sampled evaluation through the sharded gather when
        ``eval_fanouts`` is set; otherwise the full-graph forward over a
        transient device copy of the graph."""
        nodes = np.asarray(nodes)
        if self.cfg.eval_fanouts is None:
            full = self._transient_full_graph()
            return self.model.predictions(self.model.forward_full_graph(full))[nodes]
        return self.model.predictions(self._sampled_eval(nodes))

    # The memory_stats key of layer0="full"'s edge arrays: the rank's CSR
    # and its transpose, the halo shard's, or the edge slice.
    _layer0_edge_key = "layer0_edge_bytes_per_chip"

    def memory_stats(self) -> dict:
        """The per-rank layout (JAX's keys) and, on a card, the measured live
        device bytes (``utils.memory.live_device_bytes``): the largest live
        block below the full table's bytes shows that no rank holds it. A
        ``layer0="full"`` run adds its edge arrays' bytes."""
        hub_bytes = 0 if self._hub is None else sum(t.nbytes for t in self._hub)
        stats = {**self.features.memory_stats(), "hub_cache_rows": self.hub_cache_rows,
                 "hub_cache_bytes_per_chip": hub_bytes}
        if self._cache_store is not None:
            cm = self._cache_store.memory_stats()
            stats["layer0_cache_bytes_per_chip"] = cm["feature_bytes_per_chip"]
            stats["feature_bytes_per_chip"] += cm["feature_bytes_per_chip"]
            stats["feature_bytes_replicated"] += cm["feature_bytes_replicated"]
        if self._layer0_fns is not None:
            stats[self._layer0_edge_key] = self._layer0_edge_bytes
        measured = {"total_bytes": None, "largest_buffer_bytes": None,
                    "per_device_bytes": None}
        if self.device.type == "cuda":
            from graphsage_torch.utils.memory import live_device_bytes

            measured = live_device_bytes(device=self.device)
        stats.update(measured_total_device_bytes=measured["total_bytes"],
                     measured_largest_buffer_bytes=measured["largest_buffer_bytes"],
                     measured_per_device_bytes=measured["per_device_bytes"])
        return stats


def _check_hub_cache(model: GraphSAGE, gather_mode: str, graph: Graph,
                     external_store: bool = False) -> None:
    """JAX's construction checks for ``hub_cache_rows``: the compact mode, the
    full table (not a loader store) to copy the rows from, and a frozen table
    behind every lookup the cache would answer (JAX's
    project-first rule for the store's lookups, the bytes rule over an int8
    table; a dense cache, since hub rows of an int8 cache are not
    supported)."""
    if gather_mode != "compact":
        raise ValueError(
            "hub_cache_rows only affects the compact exchange "
            "(the dense psum_scatter is exact for any skew)")
    if external_store:
        raise ValueError(
            "hub_cache_rows needs the full feature table; this "
            "trainer was built from a loader feature_store")
    quantized = is_quantized(graph.features)
    if model.layer0 == "full" or (model.layer0 != "cached"
                                  and model.injected_layer0_project_first(quantized)):
        raise ValueError(
            "hub_cache_rows requires a frozen gather table: the "
            "injected project-first and layer0='full' modes gather "
            "from params-DEPENDENT tables a frozen hub cache "
            "cannot track (set project_first=False or skip the "
            "cache)")
    if model.layer0 == "cached":
        if model.concat_self:
            raise ValueError(
                "hub_cache_rows with layer0='cached' supports the "
                "pure-mean mode only: concat_self adds a raw "
                "self-feature gather site that shares the exchange "
                "closure with the cache-row site — one hub table "
                "cannot serve both (drop concat_self or the cache)")
        cache = graph.layer0_cache
        if is_quantized(cache) if cache is not None else quantized:
            raise ValueError(
                "hub_cache_rows with a QUANTIZED layer0 cache is "
                "unsupported (hub rows would need their own scale "
                "plumbing) — build the cache unquantized or skip "
                "the hub cache")


# --------------------------------------------------------------------------
# Fully sharded training: the adjacency sharded too, each hop sampled at
# the owners. Per rank: E/S edges, N/S x F features, B/S seeds.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedAdjacency:
    """A rank's node range of the adjacency: its ELL rows ``ell [Np, W]``,
    ``degrees [Np]``, a local CSR ``indptr [Np + 1]`` over ``edge_dst
    [E_max]`` (``E_max`` the largest range's edge count rounded up to 128).
    Neighbour ids stay global."""

    ell: torch.Tensor
    degrees: torch.Tensor
    indptr: torch.Tensor
    edge_dst: torch.Tensor
    num_shards: int
    rows_per_shard: int
    ell_covers_all: bool

    def memory_stats(self) -> dict:
        per_chip = sum(t.numel() * t.element_size()
                       for t in (self.ell, self.degrees, self.indptr, self.edge_dst))
        return {"adjacency_bytes_per_chip": per_chip,
                "adjacency_bytes_replicated_approx": per_chip * self.num_shards}


def shard_adjacency(graph: Graph, num_shards: int, index: int,
                    device=None) -> ShardedAdjacency:
    """Rank ``index``'s node range of ``graph``'s ELL and CSR views (the
    ownership rule of :func:`shard_features`), cut from a host copy and
    placed on ``device`` (default: the graph's). Rank ``index``'s arrays are
    JAX's ``shard_adjacency(...)[index]``."""
    ell = graph.neighbors.cpu().numpy()
    deg = graph.degrees.cpu().numpy()
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    edge_dst = graph.edge_dst.cpu().numpy()
    n = graph.num_nodes
    rows = _rows_per_shard(n, num_shards)
    e_max = max(int(indptr[min(s * rows + rows, n)] - indptr[min(s * rows, n)])
                for s in range(num_shards))
    e_max = _round_up(max(e_max, 1), 128)
    lo, hi = min(index * rows, n), min(index * rows + rows, n)
    size = hi - lo
    ell_s = np.zeros((rows, ell.shape[1]), np.int32)
    deg_s = np.zeros(rows, np.int32)
    ind_s = np.zeros(rows + 1, np.int32)
    dst_s = np.zeros(e_max, np.int32)
    ell_s[:size], deg_s[:size] = ell[lo:hi], deg[lo:hi]
    local = indptr[lo:hi + 1] - indptr[lo]
    ind_s[:size + 1] = local
    ind_s[size + 1:] = local[-1] if size else 0
    dst_s[:int(indptr[hi] - indptr[lo])] = edge_dst[indptr[lo]:indptr[hi]]
    dev = graph.device if device is None else device
    place = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return ShardedAdjacency(ell=place(ell_s), degrees=place(deg_s), indptr=place(ind_s),
                            edge_dst=place(dst_s), num_shards=num_shards,
                            rows_per_shard=rows, ell_covers_all=graph.ell_covers_all)


def owner_generator(device, seed: int, step: int, rank: int) -> torch.Generator:
    """Rank ``rank``'s sampling stream at step ``step``: a ``torch.Generator``
    on ``device`` seeded with 64 bits of numpy's ``SeedSequence((seed, step,
    rank))``. The counterpart of JAX's ``fold_in(step key, axis_index)``: a
    function of the run's seed, the step and the rank alone, so a redone step
    and a resumed run draw what the first attempt drew."""
    hi, lo = np.random.SeedSequence((seed, step, rank)).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def sharded_sample_neighbors(
    mesh: DeviceMesh,
    axis: str,
    adj: ShardedAdjacency,
    ids: torch.Tensor,
    fanout: int | None,
    generator: torch.Generator,
    capacity: int,
    valid_mask: torch.Tensor | None = None,
    method: str = "floyd",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One distributed sampling hop: ``ids [q]`` (global; this rank's
    parents) route to their owners, each owner samples its requests from its
    ELL and CSR rows with ``generator`` (this rank's stream), and the
    sampled global ids come back (one all-to-all of ids, masked slots sent as
    -1 and returned as 0). Returns ``(ids [q, k] int32, mask [q, k] bool,
    violated)``. At covering fanouts or ``fanout=None`` the result is the
    single-device sampler's for Floyd; windowed sampling is random at any
    fanout."""
    group = mesh.get_group(axis)
    s, np_ = adj.num_shards, adj.rows_per_shard
    flat = ids.reshape(-1).to(torch.int32)
    req, take, violated = route_buckets(flat, s, np_, capacity, valid_mask)
    recv = collectives.RouteIds.apply(req, group)
    local = (recv.reshape(-1) - dist.get_rank(group) * np_).clamp_(0, np_ - 1)
    nids, nmask = sample_neighbors(
        generator, adj.ell, adj.degrees, local, fanout, method=method,
        indptr=adj.indptr, edge_dst=adj.edge_dst, ell_covers_all=adj.ell_covers_all)
    k = nids.shape[-1]
    answers = torch.where(nmask, nids.to(torch.int32), torch.full_like(nids, -1,
                                                                       dtype=torch.int32))
    back = collectives.all_to_all_rows(answers.view(s, capacity, k), group)[take]
    mask = back >= 0
    if valid_mask is not None:
        mask = mask & valid_mask.reshape(-1)[:, None]
    return back.clamp_(min=0), mask, violated


def sharded_random_walk(
    mesh: DeviceMesh,
    axis: str,
    adj: ShardedAdjacency,
    starts: torch.Tensor,
    length: int,
    generator: torch.Generator,
    slack: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed uniform random walks: each of the ``length`` steps is one
    :func:`sharded_sample_neighbors` round with ``fanout=1``. The semantics
    of :func:`graphsage_torch.ops.walks.random_walk` (a walk at a sink stays
    there, masked from then on); equal to it where a step is deterministic
    (out-degree 1). Returns ``(walks [b, length+1], valid [b, length+1],
    violated)``."""
    cur = starts.reshape(-1).to(torch.int32)
    cap = request_capacity(cur.shape[0], adj.num_shards, slack)
    alive = torch.ones(cur.shape, dtype=torch.bool, device=cur.device)
    steps, flags = [cur], [alive]
    violated = torch.zeros((), dtype=torch.bool, device=cur.device)
    for _ in range(length):
        nids, nmask, viol = sharded_sample_neighbors(mesh, axis, adj, cur, 1, generator,
                                                     cap, valid_mask=alive)
        violated = violated | viol
        alive = alive & nmask[:, 0]
        cur = torch.where(alive, nids[:, 0], cur)
        steps.append(cur)
        flags.append(alive)
    return torch.stack(steps, dim=-1), torch.stack(flags, dim=-1), violated


def sharded_sample_frontier(
    mesh: DeviceMesh,
    axis: str,
    model: GraphSAGE,
    adj: ShardedAdjacency,
    seeds_local: torch.Tensor,
    generator: torch.Generator,
    slack: float,
    fanouts=None,
) -> tuple[Frontier, torch.Tensor]:
    """This rank's frontier of ``seeds_local``, as :meth:`GraphSAGE.sample`
    builds it (``fanouts`` overrides the model's), with every hop sampled at
    the owners; and the overflow flag of its hops."""
    fanouts = model.fanouts if fanouts is None else tuple(fanouts)
    seeds_local = seeds_local.reshape(-1).to(torch.int32)
    ids = [seeds_local]
    masks = [torch.ones(seeds_local.shape, dtype=torch.bool, device=seeds_local.device)]
    violated = torch.zeros((), dtype=torch.bool, device=seeds_local.device)
    L = model.num_layers
    hops = L - 1 if model.layer0 in ("full", "cached") else L
    for h in range(1, hops + 1):
        parent_ids, parent_mask = ids[-1], masks[-1]
        cap = request_capacity(parent_ids.shape[0], adj.num_shards, slack)
        nids, nmask, viol = sharded_sample_neighbors(
            mesh, axis, adj, parent_ids, fanouts[L - h], generator, cap,
            valid_mask=parent_mask, method=model.sampling)
        violated = violated | viol
        if model.concat_self or model.self_loop:
            nids = torch.cat([parent_ids[:, None], nids], dim=1)
            nmask = torch.cat([parent_mask[:, None], nmask], dim=1)
        ids.append(nids.reshape(-1))
        masks.append(nmask.reshape(-1))
    return Frontier(ids=tuple(ids), masks=tuple(masks)), violated


class FullyShardedTrainer(ShardedFeatureTrainer):
    """Sampled training with nothing graph-sized replicated: the adjacency,
    the feature table and the seed batch all shard over one axis. Each hop
    is sampled at the owners (:func:`sharded_sample_frontier`) and the
    lookups go through the compact exchange; per rank the device holds
    ``E/S`` edges, ``N/S x F`` features (and a cached model's cache shard),
    the labels and the batch slice.

    Each rank samples from :func:`owner_generator` of the run's seed, the
    step and its rank, so losses equal the single-device trainer's only
    where sampling is deterministic (Floyd at covering fanouts or
    ``fanout=None``). An overflow in a sampling hop or a lookup redoes the
    step as :class:`ShardedFeatureTrainer`'s compact mode does; the owners'
    draws are laid out by bucket slot, so a retry at another capacity draws
    afresh where sampling is random (as JAX's does). Evaluation is
    distributed too, at ``eval_fanouts`` or the model's (no replicated
    fallback), with the same retries.

    ``layer0="full"`` builds the rank's table slice over its adjacency
    shard's own CSR (``indptr``/``edge_dst``, global ids into the
    all-gathered buffer), so the forward holds no second edge copy; the
    backward's transposed CSR, built once at construction, is the port's
    one extra edge array (``memory_stats()["layer0_transpose_bytes_per_chip"]``;
    JAX derives its edges inside the trace). The max-pool layer derives its
    edge slice per call (:func:`local_edges_from_adjacency`).
    ``layer0_exchange="halo"`` is refused, as JAX's."""

    _layer0_edges_from_adjacency = True
    _layer0_edge_key = "layer0_transpose_bytes_per_chip"

    def __init__(self, model, graph, config, mesh, axis: str = "data",
                 capacity_slack: float = 1.5, layer0_exchange: str = "allgather",
                 feature_store=None, hub_cache_rows: int = 0):
        if model.sampling == "topk":
            raise ValueError(
                "FullyShardedTrainer samples through the owner-side CSR "
                "slice; method='topk' is ELL-only — use 'floyd' (exact) "
                "or 'windowed'")
        super().__init__(model, graph, config, mesh, axis=axis, gather_mode="compact",
                         capacity_slack=capacity_slack, layer0_exchange=layer0_exchange,
                         feature_store=feature_store, hub_cache_rows=hub_cache_rows)

    def _layer0_closures(self, model: GraphSAGE, host: Graph) -> dict:
        """``layer0="full"``'s closure over the adjacency shard (see the class
        docstring)."""
        adj, dev = self.adjacency, model.device
        np_ = adj.rows_per_shard
        if model.aggregator == "mean":
            # Only the transpose is new: the forward reads the shard's CSR.
            csr = local_csr(adj.indptr.cpu().numpy(), adj.edge_dst.cpu().numpy(),
                            self.num_shards * np_, dev)._replace(indptr=adj.indptr,
                                                                 cols=adj.edge_dst)
            self._layer0_edge_bytes = sum(t.numel() * t.element_size()
                                          for t in (csr.t_indptr, csr.t_cols, csr.count))
            return dict(spmm=make_sharded_spmm(self.mesh, self.axis, csr))

        def segmax(pooled):
            e_src, e_dst, e_mask = local_edges_from_adjacency(adj.indptr, adj.edge_dst, np_)
            return make_sharded_segmax(self.mesh, self.axis, e_src, e_dst, e_mask,
                                       np_)(pooled)

        return dict(segmax=segmax)

    def _device_graph(self, host: Graph, device) -> Graph:
        """Shard the adjacency; the device graph keeps the labels only."""
        self.adjacency = shard_adjacency(host, self.num_shards, self.shard_index, device)
        blank = dict(
            features=torch.zeros((1, host.num_features), dtype=host.features.dtype),
            neighbors=torch.zeros((1, 1), dtype=torch.int32),
            degrees=torch.zeros(1, dtype=torch.int32),
            indptr=torch.zeros(2, dtype=torch.int32),
            edge_dst=torch.zeros(1, dtype=torch.int32),
            edge_src=torch.zeros(1, dtype=torch.int32),
            edge_mask=torch.zeros(1, dtype=torch.bool),
            layer0_cache=None)
        return dataclasses.replace(host, **blank).to(device)

    def _generator(self, eval_: bool = False) -> torch.Generator:
        if eval_:
            return owner_generator(self.device, self.cfg.seed + 7, 0, self.shard_index)
        return owner_generator(self.device, self.cfg.seed, self.step_count, self.shard_index)

    def _local_seeds(self, ids: torch.Tensor) -> torch.Tensor:
        return ids.chunk(self.num_shards)[self.shard_index]

    def _frontier(self, seeds_local, generator, slack, fanouts=None):
        """This rank's distributed frontier and whether it, or a lookup on
        it, would overflow on any rank."""
        frontier, violated = sharded_sample_frontier(
            self.mesh, self.axis, self.model, self.adjacency, seeds_local, generator,
            slack, fanouts)
        violated = violated | self._local_sites_violated(frontier, slack, fanouts)
        return frontier, self._violated_anywhere(violated)

    # ------------------------------------------------------------------- step
    def step(self, seeds: np.ndarray) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(seeds, dtype=np.int32)).to(self.device)
        return self._with_retries(lambda slack: self._attempt(ids, slack))

    def _attempt(self, ids: torch.Tensor, slack: float) -> torch.Tensor | None:
        seeds_local = self._local_seeds(ids)
        frontier, violated = self._frontier(seeds_local, self._generator(), slack)
        if violated:
            return None
        loss = self.model.loss(self.features.shard, frontier,
                               self.graph.labels[seeds_local.long()], **self._injected(slack))
        return self._mean_over(self._update(loss), self._group, self.num_shards)

    # ------------------------------------------------------------------- eval
    def _distributed_eval(self, nodes: np.ndarray, return_embeddings: bool = False
                          ) -> torch.Tensor:
        """Every rank's distributed forward of its slice of ``nodes`` (padded
        to a multiple of S) at ``eval_fanouts`` or the model's, gathered:
        ``[len(nodes), C]`` (or embeddings). Sampling uses a stream seeded
        ``seed + 7``; an overflow retries at doubled slack."""
        seeds_local = self._local_seeds(self._padded(nodes))
        fanouts = self.cfg.eval_fanouts or self.model.fanouts

        def attempt(slack):
            frontier, violated = self._frontier(seeds_local, self._generator(eval_=True),
                                                slack, fanouts)
            if violated:
                return None
            return self.model(self.features.shard, frontier, return_embeddings,
                              **self._injected(slack))

        out = self._with_retries(attempt, "distributed eval request capacity")
        return collectives.all_gather_rows(out, self._group)[:len(nodes)]

    @torch.no_grad()
    def predict(self, nodes: np.ndarray) -> np.ndarray:
        """Distributed sampled evaluation: the adjacency stays ``E/S`` and
        the features ``N/S x F`` per rank through evaluation too. Covering
        fanouts (Floyd) give the replicated trainer's deterministic
        predictions."""
        return self.model.predictions(self._distributed_eval(np.asarray(nodes)))

    def memory_stats(self) -> dict:
        return {**super().memory_stats(), **self.adjacency.memory_stats()}
