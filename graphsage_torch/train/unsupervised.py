"""Unsupervised training: the counterpart of
``graphsage_tpu/train/unsupervised.py``.

The supervised trainers' machinery (splits, batches, checkpoints, resume)
with the loss swapped for the graph-context loss
(:mod:`graphsage_torch.models.unsupervised`) and evaluation swapped for the
paper's protocol: freeze the embeddings, fit a linear probe on the train
split, report its F1. Labels reach the probe only, never the training
gradient: the head gets no gradient, so the optimizer never moves it.

Three tiers, as in the JAX package:

* :class:`UnsupervisedTrainer` — one device.
* :class:`UnsupervisedShardedTrainer` — the node-sharded feature store:
  walks, negatives and the frontier are drawn replicated (the single
  device's stream, so a step is the single-device step), the seed-major
  ``(u, v, n_1..n_Q)`` groups split over the ranks on whole groups, and
  their rows come through the sharded exchange, dense or compact.
* :class:`UnsupervisedFullyShardedTrainer` — nothing graph-sized
  replicated: the walks run at the owners (``sharded_random_walk``), the
  negatives come from the replicated ``[N]`` CDF, the frontier is sampled at
  the owners and the rows come through the compact exchange; the probe is
  fitted on distributed embeddings.

The sharded tiers sum the ranks' losses, each its groups' numerator over
the count of kept pairs of the whole batch (one all-reduce before the
forward), and sum their gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from graphsage_torch.data.graph import Graph
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.models.unsupervised import (
    context_group_scores,
    context_groups,
    linear_probe_predict,
    unsupervised_loss,
)
from graphsage_torch.ops.walks import negative_cdf, pick_positive_step, sample_from_cdf
from graphsage_torch.parallel import collectives
from graphsage_torch.parallel.distributed import slice_frontier
from graphsage_torch.parallel.feature_store import (
    FullyShardedTrainer,
    ShardedFeatureTrainer,
    sharded_random_walk,
    sharded_sample_frontier,
)
from graphsage_torch.train.config import TrainConfig
from graphsage_torch.train.trainer import Trainer


class _LinearProbe:
    """Evaluation by the paper's protocol over the trainer's
    ``embeddings(nodes)``."""

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


def _unit(emb: torch.Tensor) -> torch.Tensor:
    return emb / (emb.norm(dim=-1, keepdim=True) + 1e-8)


class UnsupervisedTrainer(_LinearProbe, Trainer):
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
        return _unit(emb)


class _ShardedUnsupervised(_LinearProbe):
    """What both sharded unsupervised trainers share: the negative table,
    the groups' loss over the ranks and the summed gradients."""

    objective = "unsupervised"

    def _negatives(self, config: TrainConfig) -> None:
        self.neg_cdf = torch.from_numpy(negative_cdf(
            self._source_graph.degrees.numpy(), config.neg_power)).to(self.device)

    def _context_step(self, frontier, pair_local: torch.Tensor, slack: float
                      ) -> torch.Tensor:
        """One update on the graph-context loss of this rank's groups;
        returns the batch's loss (the ranks' sum)."""
        den = collectives.all_reduce(pair_local.to(torch.float32).sum(),
                                     self._group).clamp(min=1.0)
        z = self.model(self.features.shard, frontier, return_embeddings=True,
                       **self._injected(slack))
        per_seed, kept = context_group_scores(z, pair_local, self.cfg.num_negatives)
        loss = self._update((per_seed * kept).sum() / den)
        return collectives.all_reduce(loss, self._group)

    def _reduce_gradients(self) -> None:
        collectives.average_gradients(self.model.parameters(), self._group, 1)


class UnsupervisedShardedTrainer(_ShardedUnsupervised, ShardedFeatureTrainer):
    """Unsupervised training through the node-sharded feature store (see
    the module docstring); keyword arguments are
    :class:`ShardedFeatureTrainer`'s (``gather_mode``, ``capacity_slack``,
    ``hub_cache_rows``). Its step is the single-device
    :class:`UnsupervisedTrainer`'s step."""

    def __init__(self, model: GraphSAGE, graph: Graph, config: TrainConfig, mesh,
                 **kwargs):
        _require_linear(model)
        super().__init__(model, graph, config, mesh, **kwargs)
        self._negatives(config)

    def _attempt(self, ids: torch.Tensor, slack: float) -> torch.Tensor | None:
        group_seeds, pair_mask = context_groups(
            self.generator, self.graph, ids, self.neg_cdf,
            walk_length=self.cfg.walk_length, num_negatives=self.cfg.num_negatives)
        frontier = slice_frontier(self.model.sample(self.generator, self.graph, group_seeds),
                                  self.shard_index, self.num_shards)
        if self.gather_mode == "compact" and self._violated_anywhere(
                self._local_sites_violated(frontier, slack)):
            return None
        return self._context_step(frontier, pair_mask.chunk(self.num_shards)[self.shard_index],
                                  slack)

    @torch.no_grad()
    def embeddings(self, nodes: np.ndarray) -> torch.Tensor:
        """Unit-norm embeddings of ``nodes`` on every rank: the full-graph
        forward over a transient device copy of the graph by default, or the
        sampled forward at ``eval_fanouts`` through the sharded gather."""
        if self.cfg.eval_fanouts is None:
            ids = torch.from_numpy(np.asarray(nodes, dtype=np.int64)).to(self.device)
            return _unit(self.model.embed_full_graph(self._transient_full_graph())[ids])
        return _unit(self._sampled_eval(np.asarray(nodes), return_embeddings=True))


class UnsupervisedFullyShardedTrainer(_ShardedUnsupervised, FullyShardedTrainer):
    """Unsupervised training with nothing graph-sized replicated (see the
    module docstring); keyword arguments are :class:`FullyShardedTrainer`'s.
    ``capacity_slack`` defaults to 4.0: the degree^0.75 negatives skew the
    owners' buckets by design. Each rank draws its walks' steps, positives,
    negatives and frontier from its own stream (``owner_generator``)."""

    def __init__(self, model: GraphSAGE, graph: Graph, config: TrainConfig, mesh,
                 **kwargs):
        _require_linear(model)
        kwargs.setdefault("capacity_slack", 4.0)
        super().__init__(model, graph, config, mesh, **kwargs)
        self._negatives(config)

    def _attempt(self, ids: torch.Tensor, slack: float) -> torch.Tensor | None:
        gen = self._generator()
        seeds = self._local_seeds(ids)
        q = self.cfg.num_negatives
        walks, valid, violated = sharded_random_walk(
            self.mesh, self.axis, self.adjacency, seeds, self.cfg.walk_length, gen, slack)
        u = torch.rand(seeds.shape, generator=gen, device=self.device)
        pos, pair_mask = pick_positive_step(u, walks, valid, seeds)
        negs = sample_from_cdf(gen, self.neg_cdf, (seeds.shape[0], q))
        groups = torch.cat([seeds[:, None], pos[:, None], negs], dim=1).reshape(-1)
        frontier, hops_violated = sharded_sample_frontier(
            self.mesh, self.axis, self.model, self.adjacency, groups, gen, slack)
        violated = violated | hops_violated | self._local_sites_violated(frontier, slack)
        if self._violated_anywhere(violated):
            return None
        return self._context_step(frontier, pair_mask, slack)

    @torch.no_grad()
    def embeddings(self, nodes: np.ndarray) -> torch.Tensor:
        """Unit-norm embeddings of ``nodes`` on every rank, from the
        distributed sampled forward."""
        return _unit(self._distributed_eval(np.asarray(nodes), return_embeddings=True))


def _require_linear(model: GraphSAGE) -> None:
    if model.final_activation != "linear":
        raise ValueError(
            "unsupervised training needs final_activation='linear': "
            "with a ReLU last layer every embedding dot is >= 0, the Q "
            "negative log-sigmoid terms dominate, and the objective "
            "collapses to the all-zero fixed point (loss pinned at "
            "(1+Q)*log 2; test-pinned)"
        )
