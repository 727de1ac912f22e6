"""Full-graph (non-sampled) training: the counterpart of
``graphsage_tpu/train/full_graph.py`` on one device.

Transductive full-batch training: every step runs the deterministic
full-neighborhood forward over all nodes (the reference's
``num_sample=None``, quirk Q7) and takes the classification loss over every
node, weighted by the train split's mask. A mean model's full-graph SpMM is
kernel 3 on the card (``ops/spmm.py``), forward and, on a symmetric graph,
backward; ``spmm_impl="bucketed_ell"`` runs the degree-bucketed PyTorch pass
(``ops/bucketed_spmm.py``) instead. The JAX package's ``"auto"`` picks the
bucketed pass from TPU measurements; here ``"auto"`` stays kernel 3.

The model holds its parameters, as with :class:`~graphsage_torch.train.
trainer.Trainer`, and the run loop, checkpoints and resume are its
(:class:`~graphsage_torch.train.trainer.TrainLoop`; the state has no
generator: nothing is sampled). The halo mesh path comes with ROADMAP Queue
1 item 14d.
"""

from __future__ import annotations

import numpy as np
import torch

from graphsage_torch.data.graph import Graph
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.ops.bucketed_spmm import make_spmm_mean_bucketed, plan_bucketed_spmm
from graphsage_torch.train.config import TrainConfig
from graphsage_torch.train.trainer import TrainLoop, make_optimizer, reference_splits
from graphsage_torch.utils.metrics import macro_f1, micro_f1


class FullGraphTrainer(TrainLoop):
    """Transductive full-batch training of ``model`` on ``graph`` (both on
    the same device)."""

    def __init__(self, model: GraphSAGE, graph: Graph, config: TrainConfig, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "FullGraphTrainer(mesh=...), the halo-exchange path, is not "
                "ported yet (ROADMAP Queue 1 item 14d)"
            )
        if model.device != graph.device:
            raise ValueError(
                f"the model lies on {model.device} and the graph on {graph.device}"
            )
        self.model = model
        self.graph = graph
        self.cfg = config
        self.device = graph.device
        self.optimizer = make_optimizer(model.parameters(), config)
        self.test_nodes, self.val_nodes, self.train_nodes = reference_splits(
            graph.num_nodes, config.seed, config.test_size, config.val_size
        )
        weight = torch.zeros(graph.num_nodes, dtype=torch.float32)
        weight[torch.from_numpy(self.train_nodes).long()] = 1.0
        self._train_weight = weight.to(self.device)
        self._spmm_override = None
        if model.aggregator == "mean" and model.spmm_impl == "bucketed_ell":
            if not graph.symmetric:
                # The bucketed backward relies on A == A^T.
                raise ValueError(
                    "spmm_impl='bucketed_ell' requires symmetric adjacency "
                    "(graph.symmetric is False, e.g. built with max_degree "
                    "truncation); use spmm_impl='auto' or 'xla'"
                )
            bucketed = make_spmm_mean_bucketed(plan_bucketed_spmm(graph))
            self._spmm_override = lambda x: (bucketed(x), graph.degrees)

    def _logits(self) -> torch.Tensor:
        """Full-graph logits ``[N, C]`` under the current parameters."""
        return self.model.forward_full_graph(self.graph, spmm_override=self._spmm_override)

    def _loss(self) -> torch.Tensor:
        """The classification loss over every node, weighted by the train
        split's mask."""
        per_node = self.model.classification_loss(self._logits(), self.graph.labels)
        w = self._train_weight
        return (per_node * w).sum() / w.sum()

    def step(self) -> torch.Tensor:
        """One full-batch optimizer step; returns the loss as a 0-d tensor on
        the device (reading it waits for the step)."""
        return self._update(self._loss())

    def _steps(self):
        while True:
            yield self.step

    @torch.no_grad()
    def evaluate(self, nodes: np.ndarray) -> dict[str, float]:
        """Micro- and macro-F1 of the full-graph predictions on ``nodes``."""
        nodes = np.asarray(nodes)
        preds = self.model.predictions(self._logits())[nodes]
        truth = self.graph.labels.cpu().numpy()[nodes]
        return {
            "micro_f1": micro_f1(truth, preds),
            "macro_f1": macro_f1(truth, preds, self.graph.num_classes),
        }
