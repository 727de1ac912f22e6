"""Serving engine: the counterpart of ``graphsage_tpu/serve.py`` on one device.

* ``mode="table"`` (default) — the **embedding-table** tier: one
  deterministic full-graph forward (complete neighborhoods, quirk Q7; one
  CSR mean-SpMM per layer) refreshes an ``[N, d_L]`` embedding table per
  parameter update, and every request after that is a row gather plus the
  ``[d_L, C]`` head product. Every aggregator goes through
  ``forward_full_graph`` (maxpool's segment max, lstm's ELL rows).
* ``mode="sampled"`` — the reference-observable stochastic forward (the
  reference samples at eval time too); each request re-seeds its generator
  with ``seed + 7``, so identical requests return identical answers. Layer 0
  runs in the model's ``layer0`` mode (a ``"cached"`` model needs a graph
  built by ``with_cached_layer0``).

Requests pad to a small set of static batch **buckets** (the smallest that
fits, or a multiple of the largest) with node 0, so the work per request
takes a few fixed shapes. Everything runs under ``torch.no_grad()``.

With ``mesh=`` the table tier is **sharded** over the mesh's ``axis``: the
refresh runs the halo-exchange full-graph forward
(:func:`~graphsage_torch.parallel.halo.halo_full_graph_logits`, ``stacked``)
over a node partition, so each rank keeps only its ``[Np, d_L]`` rows (int8
too), and a request remaps its ids through the partition's
``stacked_index`` and gathers the rows from their owners with the dense
owner exchange (:func:`~graphsage_torch.parallel.feature_store.
sharded_row_gather`: position ``s * Np + r`` is row ``r`` of rank ``s``).
Every rank of the axis serves the same requests together (SPMD), as JAX's
one program does.

``quantize_table=True`` (table tier only) keeps the refreshed table as an
int8 :class:`~graphsage_torch.ops.quantize.QuantizedTable` (a quarter of the
f32 bytes); a request dequantizes its rows before the head. bf16 models
(``compute_dtype``) serve through both tiers; their representations and
logits are f32.
"""

from __future__ import annotations

import numpy as np
import torch

from graphsage_torch._device import resolve_device
from graphsage_torch.data.graph import Graph, reject_lazy_descriptor
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.ops.quantize import gather_dequant, is_quantized, quantize_rows
from graphsage_torch.parallel.halo import build_node_partition, halo_full_graph_logits
from graphsage_torch.parallel.mesh import axis_index, axis_size
from graphsage_torch.utils import profiling


class ServingEngine:
    """Request path over a trained model. See module docstring.

    Parameters
    ----------
    model, graph : the trained model (holding its parameters) and the
        serving-time graph; both are placed on ``device``.
    mode : ``"table"`` or ``"sampled"``.
    batch_buckets : static request sizes; a request pads to the smallest
        bucket that fits (or to a multiple of the largest).
    eval_fanouts : sampled mode only — override the model's fanouts for
        serving (``None`` entries mean full neighborhoods).
    seed : sampled mode only — fixes the sampling stream per request.
    device : ``cuda`` unless the caller passes ``device="cpu"``.
    mesh, axis, partition : table mode only — shard the tier over
        ``mesh``'s ``axis`` (module docstring). ``partition`` is a prebuilt
        :class:`~graphsage_torch.parallel.halo.NodePartition` of ``graph``;
        by default one is built with ``order="auto"``. The graph then stays
        where it lies.
    quantize_table : table mode only — store the refreshed ``[N, d_L]``
        table as int8 rows and per-row f32 scales; logits move by at most
        the quantization error of the representations (half a scale step
        per element).
    """

    def __init__(
        self,
        model: GraphSAGE,
        graph: Graph,
        *,
        mode: str = "table",
        batch_buckets: tuple[int, ...] = (256, 1024),
        eval_fanouts: tuple[int | None, ...] | None = None,
        seed: int = 0,
        device=None,
        quantize_table: bool = False,
        mesh=None,
        axis: str = "graph",
        partition=None,
    ):
        if mode not in ("table", "sampled"):
            raise ValueError(f"unknown serving mode {mode!r}")
        if mesh is not None and mode != "table":
            raise ValueError(
                "sharded serving is table-mode only (sampled serving at "
                "scale is FullyShardedTrainer.predict)"
            )
        if quantize_table and mode != "table":
            raise ValueError("quantize_table requires mode='table'")
        if not batch_buckets or any(b <= 0 for b in batch_buckets):
            raise ValueError("batch_buckets must be positive ints")
        if eval_fanouts is not None and len(eval_fanouts) != model.num_layers:
            raise ValueError("eval_fanouts needs one entry per layer")
        reject_lazy_descriptor(graph.features, "ServingEngine (it would serve N*F zeros)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mesh, self.axis = mesh, axis
        if mesh is None:
            self.graph = graph.to(self.device)
        else:
            self.graph = graph
            self.partition = (partition if partition is not None else
                              build_node_partition(graph, axis_size(mesh, axis), order="auto"))
            self._shard = self.partition.local(axis_index(mesh, axis), self.device)
        self.mode = mode
        self.quantize_table = quantize_table
        self.buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self.eval_fanouts = None if eval_fanouts is None else tuple(eval_fanouts)
        self.seed = seed
        self._table = None
        self.refresh()

    # ------------------------------------------------------------- refresh
    @torch.no_grad()
    def refresh(self, state_dict: dict | None = None) -> None:
        """Install new parameters (a ``state_dict`` of the model, or the
        model's current ones) — one full-graph forward in table mode, the
        per-model-update cost; free in sampled mode."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        if self.mesh is not None:
            table = halo_full_graph_logits(self.model, self.partition, self.mesh, self.axis,
                                           return_embeddings=True, stacked=True,
                                           shard=self._shard)
            self._table = quantize_rows(table) if self.quantize_table else table
        elif self.mode == "table":
            table = self.model.embed_full_graph(self.graph)
            self._table = quantize_rows(table) if self.quantize_table else table

    @property
    def table(self):
        """The current ``[N, d_L]`` embedding table (table mode; a
        ``QuantizedTable`` under ``quantize_table``); under ``mesh``, this
        rank's ``[Np, d_L]`` rows (global node ``v`` at flat position
        ``partition.stacked_index[v]`` of the ranks' tables stacked)."""
        return self._table

    # ------------------------------------------------------------ requests
    def _pad(self, nodes) -> tuple[np.ndarray, int]:
        ids = np.asarray(nodes).reshape(-1)
        n = ids.shape[0]
        if n == 0:
            raise ValueError("empty request")
        if ids.min() < 0 or ids.max() >= self.graph.num_nodes:
            raise ValueError(
                f"request ids must lie in [0, {self.graph.num_nodes}), got "
                f"[{ids.min()}, {ids.max()}]"
            )
        for b in self.buckets:
            if n <= b:
                padded = b
                break
        else:
            big = self.buckets[-1]
            padded = -(-n // big) * big
        out = np.zeros(padded, np.int32)
        out[:n] = ids
        return out, n

    @torch.no_grad()
    def _logits(self, nodes) -> tuple[torch.Tensor, torch.Tensor, int]:
        """The padded request's representations and logits, and its length;
        spans ``serve.pad``, ``serve.copy_in``, ``serve.sample`` (sampled
        mode) and ``serve.forward`` (the rows, the head included)."""
        dev = self.device
        with profiling.span("serve.pad"):
            ids_np, n = self._pad(nodes)
        with profiling.span("serve.copy_in", device=dev):
            ids = torch.from_numpy(ids_np).to(dev)
        if self.mode == "sampled":
            with profiling.span("serve.sample", device=dev):
                gen = torch.Generator(device=dev).manual_seed(self.seed + 7)
                frontier = self.model.sample(gen, self.graph, ids, self.eval_fanouts)
        with profiling.span("serve.forward", device=dev):
            if self.mesh is not None:
                # (feature_store imports the trainers, which import this module.)
                from graphsage_torch.parallel.feature_store import sharded_row_gather

                pos = torch.from_numpy(self.partition.stacked_index[ids_np]).to(dev)
                rows = sharded_row_gather(self.mesh, self.axis, self._table, pos)
            elif self.mode == "table":
                rows = (gather_dequant(self._table, ids) if is_quantized(self._table)
                        else self._table[ids.long()])
            else:
                rows = self.model.forward(
                    self.graph.features, frontier, return_embeddings=True,
                    graph=self.graph,
                )
            return rows, rows @ self.model.head, n

    def memory_stats(self) -> dict:
        """Capacity-planning numbers: the resident table's bytes per rank and,
        sharded, what a replicated table would take and the refresh's
        boundary-exchange rows per layer (``NodePartition.comm_stats``)."""
        out = {"mode": self.mode, "buckets": self.buckets}
        if self._table is not None:
            out["table_bytes_per_chip"] = self._table.nbytes
            if self.mesh is not None:
                out["table_bytes_replicated_equiv"] = (self._table.nbytes
                                                       * self.partition.num_shards)
                out["refresh_comm"] = self.partition.comm_stats()
        return out

    def logits(self, nodes) -> np.ndarray:
        """``[B, C]`` class scores for the requested nodes; the span
        ``serve.logits`` holds :meth:`_logits`'s spans and ``serve.copy_out``."""
        with profiling.span("serve.logits", device=self.device):
            _, logits, n = self._logits(nodes)
            with profiling.span("serve.copy_out", device=self.device):
                return logits[:n].cpu().numpy()

    def predict(self, nodes) -> np.ndarray:
        """``[B]`` class predictions (argmax), or ``[B, C]`` multi-hot rows
        under ``model.multilabel``."""
        _, logits, n = self._logits(nodes)
        return self.model.predictions(logits[:n])

    def embed(self, nodes) -> np.ndarray:
        """``[B, d_L]`` node representations."""
        rows, _, n = self._logits(nodes)
        return rows[:n].to(torch.float32).cpu().numpy()
