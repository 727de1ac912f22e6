"""Edge partitioning: the counterpart of
``graphsage_tpu/parallel/partition.py``.

The CSR edge list is sorted by source node (``data/graph.py:build_graph``),
so equal contiguous blocks give each rank a contiguous node range; rows
whose edges straddle a block boundary have a partial sum on each block,
which the cross-rank sum in :mod:`graphsage_torch.parallel.distributed`
combines. The blocks are host (numpy) arrays, padded as the JAX package
pads them: ``src = N-1``, ``dst = 0``, ``mask = False``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from graphsage_torch.data.graph import Graph


class EdgePartition(NamedTuple):
    """Edge arrays reshaped to ``[num_shards, edges_per_shard]``."""

    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray

    @property
    def num_shards(self) -> int:
        return self.edge_src.shape[0]


def partition_edges(graph: Graph, num_shards: int) -> EdgePartition:
    """Split the padded edge arrays into ``num_shards`` equal blocks, padded
    with masked edges so that every block has the same length."""
    src = graph.edge_src.cpu().numpy()
    e_pad = src.shape[0]
    per = -(-e_pad // num_shards)
    pad = per * num_shards - e_pad

    def pad_to(x, fill):
        return np.pad(x, (0, pad), constant_values=fill) if pad else x

    return EdgePartition(
        edge_src=pad_to(src, graph.num_nodes - 1).reshape(num_shards, per),
        edge_dst=pad_to(graph.edge_dst.cpu().numpy(), 0).reshape(num_shards, per),
        edge_mask=pad_to(graph.edge_mask.cpu().numpy(), False).reshape(num_shards, per),
    )


def partition_stats(graph: Graph, num_shards: int) -> dict:
    """Partition quality: edges per block, and ``boundary_partials``, every
    extra (row, block) partial beyond the first (a row whose edges span
    ``k`` blocks adds ``k - 1``, the partial sums the cross-rank reduction
    merges)."""
    part = partition_edges(graph, num_shards)
    per = part.edge_src.shape[1]
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    deg = indptr[1:] - indptr[:-1]
    nz = deg > 0
    spans = (indptr[1:][nz] - 1) // per - indptr[:-1][nz] // per
    edges_per_shard = part.edge_mask.sum(axis=1)
    return {
        "num_shards": num_shards,
        "edges_per_shard_min": int(edges_per_shard.min()),
        "edges_per_shard_max": int(edges_per_shard.max()),
        "boundary_rows": int((spans > 0).sum()),
        "boundary_partials": int(spans.sum()),
    }
