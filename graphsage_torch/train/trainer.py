"""Training loop: the counterpart of ``graphsage_tpu/train/trainer.py`` for
sampled supervised training.

PyTorch runs eagerly, so a step is a Python function: sample the seeds'
frontier on the graph's device, forward, softmax cross-entropy, backward
(layer 0's gather-mean backward is the scatter-mean kernel on the card) and
one optimizer update. There is no ``jit`` or ``scan``: the loop dispatches
one step at a time, and ``TrainConfig.steps_per_dispatch`` has no meaning
here.

Batching modes (``TrainConfig.batching``):

* ``"epoch"``     — shuffled epochs over the train split (sane default).
* ``"reference"`` — the reference's scheme (quirk Q5): each batch is the head
  of the *previous* iteration's shuffle.

Splits replicate the reference: a ``RandomState(seed)`` permutation, first
1000 test (computed but never evaluated there, quirk Q6), next 500
validation, the rest training (model.py:84-87). Splits and batches come from
the same numpy and Python random streams as the JAX package's, so the seed
arrays are equal array for array; sampling uses a ``torch.Generator``, whose
stream differs from ``jax.random``'s.
"""

from __future__ import annotations

import random as _pyrandom
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from graphsage_torch.data.graph import Graph
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.train.config import TrainConfig
from graphsage_torch.utils.metrics import macro_f1, micro_f1


def make_optimizer(
    params: Iterable[torch.nn.Parameter], config: TrainConfig
) -> torch.optim.Optimizer:
    """Optimizer from config with optax's semantics; plain SGD lr=0.7
    reproduces the reference.

    ``"momentum"`` is ``optax.sgd(lr, momentum=m)``: ``t = g + m t``,
    ``p -= lr t``, which is ``torch.optim.SGD`` without dampening or
    Nesterov. ``"adam"`` is ``optax.adam(lr)`` with its defaults
    (``b1=0.9, b2=0.999, eps=1e-8``), the same update as ``torch.optim.Adam``.
    """
    lr = config.learning_rate
    if config.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if config.optimizer == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=config.momentum)
    if config.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer {config.optimizer!r}")


def reference_splits(
    num_nodes: int, seed: int = 1, test_size: int = 1000, val_size: int = 500
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(test, val, train) node-id arrays, matching reference model.py:84-87."""
    perm = np.random.RandomState(seed).permutation(num_nodes)
    return (
        perm[:test_size],
        perm[test_size : test_size + val_size],
        perm[test_size + val_size :],
    )


class Trainer:
    """Sampled supervised training of ``model`` (which holds its parameters)
    on ``graph``; both must lie on the same device. Sampling draws from a
    ``torch.Generator`` on that device, seeded from ``config.seed``."""

    def __init__(self, model: GraphSAGE, graph: Graph, config: TrainConfig):
        if config.objective != "supervised":
            raise NotImplementedError(
                f"objective={config.objective!r} is not ported yet (ROADMAP "
                "Queue 1 item 11)"
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
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.test_nodes, self.val_nodes, self.train_nodes = reference_splits(
            graph.num_nodes, config.seed, config.test_size, config.val_size
        )
        if len(self.train_nodes) == 0:
            raise ValueError(
                f"empty train split: graph has {graph.num_nodes} nodes but "
                f"test_size={config.test_size} + val_size={config.val_size} "
                f"consume them all"
            )
        self._labels = graph.labels.cpu().numpy()

    # ------------------------------------------------------------------- step
    def step(self, seeds: np.ndarray) -> torch.Tensor:
        """One optimizer step on the seed ids ``seeds``; returns the batch
        loss as a 0-d tensor on the device (reading it waits for the step)."""
        ids = torch.from_numpy(np.asarray(seeds, dtype=np.int32)).to(self.device)
        frontier = self.model.sample(self.generator, self.graph, ids)
        loss = self.model.loss(self.graph.features, frontier,
                               self.graph.labels[ids.long()])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    # ---------------------------------------------------------------- batches
    def batches(self, start_step: int = 0):
        """Yield seed-id arrays of static ``batch_size`` indefinitely.

        ``start_step`` skips ahead in the stream: epoch mode seeds each
        epoch's shuffle from ``(seed, epoch)``, so skipping is O(1); reference
        mode's order is sequential (quirk Q5), so it replays the shuffles
        only.
        """
        cfg = self.cfg
        train = np.asarray(self.train_nodes).copy()
        if cfg.batching == "reference":
            rng = _pyrandom.Random(cfg.seed)
            pool = list(train)
            for _ in range(start_step):
                rng.shuffle(pool)
            while True:
                yield np.asarray(pool[: cfg.batch_size], dtype=np.int32)
                rng.shuffle(pool)
        elif cfg.batching == "epoch":
            bpe = -(-len(train) // cfg.batch_size)  # batches per epoch
            epoch = start_step // bpe
            start_i = (start_step % bpe) * cfg.batch_size
            while True:
                shuffled = train.copy()
                np.random.default_rng((cfg.seed, epoch)).shuffle(shuffled)
                # wrap around so every batch keeps the static size
                padded = np.concatenate([shuffled, shuffled[: cfg.batch_size]])
                for i in range(start_i, len(train), cfg.batch_size):
                    yield padded[i : i + cfg.batch_size].astype(np.int32)
                start_i = 0
                epoch += 1
        else:
            raise ValueError(f"unknown batching mode {cfg.batching!r}")

    # ------------------------------------------------------------------- eval
    @torch.no_grad()
    def predict(self, nodes: np.ndarray) -> np.ndarray:
        """Class predictions for ``nodes``.

        Default: the deterministic full-graph forward (complete
        neighborhoods, quirk Q7). With ``eval_fanouts`` set: the sampled
        forward at those fanouts, from a generator seeded ``seed + 7`` (the
        reference samples at eval time too).
        """
        nodes = np.asarray(nodes)
        if self.cfg.eval_fanouts is None:
            logits = self.model.forward_full_graph(self.graph)
            return self.model.predictions(logits)[nodes]
        fanouts = self.cfg.eval_fanouts or self.model.fanouts
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 7)
        ids = torch.from_numpy(nodes.astype(np.int32)).to(self.device)
        frontier = self.model.sample(gen, self.graph, ids, fanouts)
        return self.model.predictions(self.model(self.graph.features, frontier))

    def evaluate(self, nodes: np.ndarray) -> dict[str, float]:
        nodes = np.asarray(nodes)
        preds = self.predict(nodes)
        truth = self._labels[nodes]
        return {
            "micro_f1": micro_f1(truth, preds),
            "macro_f1": macro_f1(truth, preds, self.graph.num_classes),
        }

    # -------------------------------------------------------------------- run
    def run(
        self,
        log: Callable[[str], None] | None = print,
        initial_state=None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
    ) -> dict[str, Any]:
        """Train for ``num_steps`` batches; return losses, step times and
        validation F1.

        Prints the reference driver's lines (model.py:100-106): ``"{step}
        {loss}"`` every ``log_every`` steps, then ``Validation F1:`` and
        ``Average batch time:`` (seconds on the host clock, each step ending
        when its loss is read; the first step is left out of the mean).
        Checkpoints and resuming are not ported yet.
        """
        if initial_state is not None or checkpoint_path or checkpoint_every:
            raise NotImplementedError(
                "checkpoints and resuming are not ported yet (ROADMAP Queue 1 "
                "item 12)"
            )
        cfg = self.cfg
        batch_iter = self.batches()
        losses: list[float] = []
        times: list[float] = []
        for step in range(cfg.num_steps):
            seeds = next(batch_iter)
            t0 = time.perf_counter()
            loss = float(self.step(seeds))
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            if log and cfg.log_every and step % cfg.log_every == 0:
                log(f"{step} {loss}")

        val = self.evaluate(self.val_nodes)
        steady = times[1:] if len(times) > 1 else times
        result = {
            "losses": losses,
            "val_micro_f1": val["micro_f1"],
            "val_macro_f1": val["macro_f1"],
            "mean_step_time": float(np.mean(steady)) if steady else 0.0,
            "step_times": times,
        }
        if log:
            log(f"Validation F1: {val['micro_f1']}")
            log(f"Average batch time: {result['mean_step_time']}")
        return result
