"""Full-graph (non-sampled) training: the counterpart of
``graphsage_tpu/train/full_graph.py`` on one device.

Transductive full-batch training: every step runs the deterministic
full-neighborhood forward (the reference's ``num_sample=None``, quirk Q7)
and takes the classification loss weighted by the train split's mask. Its
layers before the last run over every node; the last layer and the head
run over the rows the mask weights (``data.graph.row_block``, built once:
the CSR of those rows and, on a symmetric graph, of its transpose), since
every other row's loss is multiplied by 0 and sends back a gradient of
exactly 0. The loss, every gradient and the update are those of the
weighted loss over every node. A mean model's full-graph SpMM is kernel 3
on the card (``ops/spmm.py``), forward and, on a symmetric graph,
backward, and a max-pool model's segment max is ``ops/segment_max.py``;
each op picks its route from the device. The counter ``step.loss_rows``
counts the rows the last layer computed, each step.

With ``mesh=`` the same loss runs through the halo exchange
(:mod:`graphsage_torch.parallel.halo`) over the mesh's ``axis``: each rank
keeps its node range of a :class:`~graphsage_torch.parallel.halo.
NodePartition` (by default ``build_node_partition(graph, S,
order="auto")``), takes the loss over its own train rows divided by the
global train count (the single device's mean over all N), and the parameters'
gradients are summed over the axis. Evaluation all-gathers the ranks' logits.

The model holds its parameters, as with :class:`~graphsage_torch.train.
trainer.Trainer`, and the run loop, checkpoints and resume are its
(:class:`~graphsage_torch.train.trainer.TrainLoop`; the state has no
generator: nothing is sampled).
"""

from __future__ import annotations

import numpy as np
import torch

from graphsage_torch.data.graph import Graph, reject_lazy_descriptor, row_block
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.parallel import collectives
from graphsage_torch.parallel.halo import build_node_partition, halo_full_graph_logits
from graphsage_torch.parallel.mesh import axis_index, axis_size
from graphsage_torch.parallel.multihost import is_primary
from graphsage_torch.train.config import TrainConfig
from graphsage_torch.train.trainer import TrainLoop, make_optimizer, reference_splits
from graphsage_torch.utils import profiling
from graphsage_torch.utils.metrics import macro_f1, micro_f1


class FullGraphTrainer(TrainLoop):
    """Transductive full-batch training of ``model`` on ``graph`` (both on
    the same device), or, with ``mesh``, halo-distributed over its ``axis``
    (``partition``: a prebuilt plan for ``graph``; the graph may then lie
    anywhere, the rank's rows go to the model's device)."""

    def __init__(self, model: GraphSAGE, graph: Graph, config: TrainConfig, mesh=None,
                 axis: str = "graph", partition=None):
        reject_lazy_descriptor(graph.features, "FullGraphTrainer (it would train on N*F zeros)")
        with profiling.phase("trainer.init"):
            if mesh is None and model.device != graph.device:
                raise ValueError(
                    f"the model lies on {model.device} and the graph on {graph.device}"
                )
            self.model = model
            self.graph = graph
            self.cfg = config
            self.mesh = mesh
            self.device = model.device
            self.optimizer = make_optimizer(model.parameters(), config)
            self.test_nodes, self.val_nodes, self.train_nodes = reference_splits(
                graph.num_nodes, config.seed, config.test_size, config.val_size
            )
            weight = torch.zeros(graph.num_nodes, dtype=torch.float32)
            weight[torch.from_numpy(self.train_nodes).long()] = 1.0
            self._train_count = float(weight.sum())
            if mesh is not None:
                if model.aggregator == "lstm":
                    raise ValueError(
                        "FullGraphTrainer's halo mesh path supports mean and "
                        "maxpool only (lstm aggregation is not a per-edge "
                        "segment reduction); use the sampled trainers for lstm"
                    )
                self.axis = axis
                self._group = mesh.get_group(axis)
                self.partition = (partition if partition is not None else
                                  build_node_partition(graph, axis_size(mesh, axis), order="auto"))
                self.shard = self.partition.local(axis_index(mesh, axis), self.device)
                # The rank's train weights in stacked order (0 on padding rows).
                np_ = self.partition.nodes_per_shard
                stacked = torch.zeros(self.partition.num_shards * np_)
                stacked[torch.from_numpy(self.partition.stacked_index.astype(np.int64))] = weight
                self._train_weight = stacked[self.shard.rank * np_:][:np_].to(self.device)
                return
            self._train_weight = weight.to(self.device)
            # The rows the loss reads; none when that is every node.
            rows = torch.nonzero(self._train_weight).reshape(-1)
            self._rows = row_block(graph, rows) if rows.numel() < graph.num_nodes else None

    def _logits(self, stacked: bool = False) -> torch.Tensor:
        """Full-graph logits ``[N, C]`` under the current parameters (with
        ``stacked`` on a mesh: this rank's ``[Np, C]`` rows)."""
        if self.mesh is None:
            return self.model.forward_full_graph(self.graph)
        return halo_full_graph_logits(self.model, self.partition, self.mesh, self.axis,
                                      stacked=stacked, shard=self.shard)

    def _loss(self) -> torch.Tensor:
        """The classification loss over every node, weighted by the train
        split's mask over the train count (on a mesh: this rank's part of
        it). On one device the logits are those of the rows the mask had at
        construction; the others' losses enter as 0, in their places, so the
        sum is the weighted one over every node, term for term, under the
        mask as it is now."""
        if self.mesh is None and self._rows is not None:
            rows = self._rows.rows
            per_row = self.model.classification_loss(
                self.model.forward_full_graph(self.graph, rows=self._rows),
                self.graph.labels[rows])
            per_node = per_row.new_zeros(self.graph.num_nodes).index_copy(0, rows, per_row)
        elif self.mesh is None:
            per_node = self.model.classification_loss(self._logits(), self.graph.labels)
        else:
            per_node = self.model.classification_loss(self._logits(stacked=True),
                                                      self.shard.labels)
        return (per_node * self._train_weight).sum() / self._train_count

    def step(self) -> torch.Tensor:
        """One full-batch optimizer step; returns the loss as a 0-d tensor on
        the device (reading it waits for the step). Spans: ``step`` around
        ``step.forward`` (the logits and the loss), ``step.backward`` and
        ``step.optimizer``; the counter ``step.loss_rows`` (one device)."""
        if self.mesh is None and profiling.recording():
            profiling.count("step.loss_rows", self.graph.num_nodes if self._rows is None
                            else self._rows.num_rows)
        with profiling.span("step", device=self.device):
            with profiling.span("step.forward", device=self.device):
                loss = self._loss()
            loss = self._update(loss)
            return loss if self.mesh is None else collectives.all_reduce(loss, self._group)

    def _reduce_gradients(self) -> None:
        if self.mesh is not None:
            collectives.average_gradients(self.model.parameters(), self._group, 1)

    def write_checkpoint(self, path: str) -> str | None:
        if self.mesh is None:
            return super().write_checkpoint(path)
        written = super().write_checkpoint(path) if is_primary() else None
        torch.distributed.barrier(self._group)
        return written

    def _steps(self):
        while True:
            yield self.step

    @torch.no_grad()
    def predict(self, nodes: np.ndarray) -> np.ndarray:
        """Full-graph predictions for ``nodes`` (on a mesh every rank calls
        it, and every rank gets them)."""
        return self.model.predictions(self._logits())[np.asarray(nodes)]

    def evaluate(self, nodes: np.ndarray) -> dict[str, float]:
        """Micro- and macro-F1 of the full-graph predictions on ``nodes``."""
        nodes = np.asarray(nodes)
        preds = self.predict(nodes)
        truth = self.graph.labels.cpu().numpy()[nodes]
        return {
            "micro_f1": micro_f1(truth, preds),
            "macro_f1": macro_f1(truth, preds, self.graph.num_classes),
        }
