"""Unsupervised training on one device: the counterpart of
``graphsage_tpu/train/unsupervised.py:UnsupervisedTrainer``.

The supervised trainer's machinery (splits, batches, checkpoints, resume)
with the loss swapped for :func:`~graphsage_torch.models.unsupervised.
unsupervised_loss` and evaluation swapped for the paper's protocol: freeze
the embeddings, fit a linear probe on the train split, report its F1.
Labels reach the probe only, never the training gradient: the head gets no
gradient, so the optimizer never moves it.

The JAX package's sharded subclasses (``UnsupervisedShardedTrainer``,
``UnsupervisedFullyShardedTrainer``) come with ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import numpy as np
import torch

from graphsage_torch.data.graph import Graph
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.models.unsupervised import linear_probe_predict, unsupervised_loss
from graphsage_torch.ops.walks import negative_cdf
from graphsage_torch.train.config import TrainConfig
from graphsage_torch.train.trainer import Trainer


class UnsupervisedTrainer(Trainer):
    """Self-supervised training with the graph-context loss; predictions
    come from a linear probe on the frozen embeddings."""

    objective = "unsupervised"

    def __init__(self, model: GraphSAGE, graph: Graph, config: TrainConfig):
        _require_linear(model)
        super().__init__(model, graph, config)
        # The [N] negative table, built on the host once and kept on the
        # graph's device.
        self.neg_cdf = torch.from_numpy(
            negative_cdf(self.graph.degrees.cpu().numpy(), config.neg_power)
        ).to(self.device)

    def step(self, seeds: np.ndarray) -> torch.Tensor:
        """One optimizer step on the graph-context loss of ``seeds``'
        groups; returns the loss as a 0-d tensor on the device."""
        ids = torch.from_numpy(np.asarray(seeds, dtype=np.int32)).to(self.device)
        return self._update(unsupervised_loss(
            self.model, self.graph, self.generator, ids, self.neg_cdf,
            walk_length=self.cfg.walk_length, num_negatives=self.cfg.num_negatives,
        ))

    @torch.no_grad()
    def embeddings(self, nodes: np.ndarray) -> torch.Tensor:
        """Unit-norm embeddings ``[len(nodes), d]`` of ``nodes`` (``norm +
        1e-8``, as JAX's probe has it; the loss keeps its own guard): the
        deterministic full-graph forward by default (one SpMM per layer, kernel
        3 on the card), or the sampled forward at ``eval_fanouts`` from a
        generator seeded ``seed + 7``."""
        ids = torch.from_numpy(np.asarray(nodes, dtype=np.int64)).to(self.device)
        if self.cfg.eval_fanouts is None:
            emb = self.model.embed_full_graph(self.graph)[ids]
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 7)
            frontier = self.model.sample(gen, self.graph, ids.to(torch.int32),
                                         self.cfg.eval_fanouts)
            emb = self.model(self.graph.features, frontier, return_embeddings=True,
                             graph=self.graph)
        return emb / (emb.norm(dim=-1, keepdim=True) + 1e-8)

    def predict(self, nodes: np.ndarray) -> np.ndarray:
        """Linear-probe predictions for ``nodes``: the probe is fitted on the
        train split's embeddings at every call (300 full-batch Adam steps).
        The train split and ``nodes`` are embedded together, in one forward
        (the JAX package's order for its sampled forward)."""
        nodes = np.asarray(nodes)
        n_train = len(self.train_nodes)
        emb = self.embeddings(np.concatenate([self.train_nodes, nodes]))
        labels = torch.from_numpy(self._labels[self.train_nodes]).to(self.device)
        preds = linear_probe_predict(emb[:n_train], labels, emb[n_train:],
                                     self.graph.num_classes)
        return preds.cpu().numpy()


def _require_linear(model: GraphSAGE) -> None:
    if model.final_activation != "linear":
        raise ValueError(
            "unsupervised training needs final_activation='linear': "
            "with a ReLU last layer every embedding dot is >= 0, the Q "
            "negative log-sigmoid terms dominate, and the objective "
            "collapses to the all-zero fixed point (loss pinned at "
            "(1+Q)*log 2; test-pinned)"
        )
