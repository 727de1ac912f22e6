"""Training loop: the counterpart of ``graphsage_tpu/train/trainer.py`` for
sampled supervised training.

PyTorch runs eagerly, so a step is a Python function: sample the seeds'
frontier on the graph's device, forward, softmax cross-entropy, backward
(the sampled mean layer 0's gather-mean backward is the scatter-mean kernel
on the card; ``layer0="full"``'s is the SpMM kernel again) and one optimizer
update. A ``layer0="cached"`` model gets its graph's cache built at
construction when the graph has none (int8 for an int8 graph). There is no
``jit`` or ``scan``: the loop dispatches
one step at a time, and ``TrainConfig.steps_per_dispatch`` has no meaning
here.

A trainer's state (:meth:`TrainLoop.state_dict`) is what a checkpoint holds:
the parameters, the optimizer's state, the sampler's generator and the
step. ``run(initial_state=...)`` resumes from one and continues the batch
stream where it stopped; ``checkpoint_every`` writes one periodically
(:mod:`graphsage_torch.utils.checkpoint`).

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

import functools
import random as _pyrandom
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from graphsage_torch.data.graph import Graph, reject_lazy_descriptor, with_cached_layer0
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.ops.quantize import is_quantized
from graphsage_torch.train.config import TrainConfig
from graphsage_torch.utils import profiling
from graphsage_torch.utils.checkpoint import save_checkpoint
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


def _optimizer_slots(optimizer: torch.optim.Optimizer,
                     p: torch.nn.Parameter) -> dict[str, torch.Tensor]:
    """``p``'s optimizer state, or, before its first update, the state the
    update would start from (Adam: step 0 and zero moments; momentum: a zero
    buffer; plain SGD: none): the same entries either way, so that a fresh
    trainer's state is a template for any checkpoint of its run. Starting
    from the zeros is the same update as starting from nothing."""
    state = {k: v for k, v in optimizer.state.get(p, {}).items()
             if isinstance(v, torch.Tensor)}
    if state:
        return state
    if isinstance(optimizer, torch.optim.Adam):
        return {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
    if optimizer.defaults.get("momentum"):
        return {"momentum_buffer": torch.zeros_like(p)}
    return {}


class TrainLoop:
    """What every trainer shares: its state (``state_dict``,
    ``load_state_dict``), the optimizer update and the ``run`` loop.
    Subclasses set ``model``, ``optimizer``, ``cfg``, ``val_nodes`` and,
    when they sample, ``generator``; they define ``_steps`` and
    ``evaluate``."""

    generator: torch.Generator | None = None
    step_count = 0  # optimizer steps taken (restored by load_state_dict)

    # ------------------------------------------------------------------ state
    def state_dict(self) -> dict[str, torch.Tensor]:
        """The trainer's state as a flat dict of tensors: the parameters
        under the JAX ``SAGEParams`` field names (``params|layers|0|weight``,
        ``params|head``), the optimizer's state per parameter
        (``opt_state|<index>|<slot>``), the generator's state (``key``) and
        the step. A fresh trainer's is the template of its checkpoints."""
        out = {"params|" + name.replace(".", "|"): p.detach()
               for name, p in self.model.named_parameters()}
        for i, p in enumerate(self.model.parameters()):
            for slot, t in _optimizer_slots(self.optimizer, p).items():
                out[f"opt_state|{i}|{slot}"] = t
        if self.generator is not None:
            out["key"] = self.generator.get_state()
        out["step"] = torch.tensor(self.step_count, dtype=torch.int64)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        """Install ``state`` (as :meth:`state_dict` gives it, e.g. restored
        from a checkpoint): each entry goes where this trainer keeps its
        own. The optimizer's state restores by parameter order, so the
        trainer must be built over the same model; the generator's state
        replaces the seed it was constructed with."""
        own = self.state_dict()
        if set(state) != set(own):
            raise KeyError(f"state entries differ from this trainer's: "
                           f"{sorted(set(state) ^ set(own))[:5]}")
        state = {k: v.to(own[k].device) for k, v in state.items()}
        for name, p in self.model.named_parameters():
            p.copy_(state["params|" + name.replace(".", "|")])
        groups = self.optimizer.state_dict()["param_groups"]
        slots = {i: {} for i in range(len(list(self.model.parameters())))}
        for key, t in state.items():
            if key.startswith("opt_state|"):
                _, i, slot = key.split("|")
                slots[int(i)][slot] = t.clone()
        self.optimizer.load_state_dict({"state": slots, "param_groups": groups})
        if self.generator is not None:
            self.generator.set_state(state["key"])
        self.step_count = int(state["step"])

    # ------------------------------------------------------------------- step
    def _update(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward and one optimizer update from ``loss``; returns it
        detached. Under ``torch.autograd.set_detect_anomaly`` (the CLI's
        ``--debug-nans``) a loss that is not finite raises
        ``FloatingPointError`` first (reading it waits for the step).

        Spans: ``step.backward`` (the gradients set to ``None``, which
        launches nothing, then the backward) and ``step.optimizer`` (the
        gradients' reduction across ranks and the update)."""
        if torch.is_anomaly_enabled() and not bool(torch.isfinite(loss)):
            raise FloatingPointError(
                f"loss is {float(loss.detach())} at step {self.step_count} (--debug-nans)")
        with profiling.span("step.backward", device=loss.device):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with profiling.span("step.optimizer", device=loss.device):
            self._reduce_gradients()
            self.optimizer.step()
        self.step_count += 1
        return loss.detach()

    def _reduce_gradients(self) -> None:
        """Combine the parameters' gradients across ranks before the update:
        nothing on one device; the sharded trainers average them."""

    def write_checkpoint(self, path: str) -> str | None:
        """Write :meth:`state_dict` to ``path``; returns the file written
        (``None`` on a sharded trainer's ranks other than the first, which
        write nothing)."""
        return save_checkpoint(path, self.state_dict())

    def _steps(self) -> Iterator[Callable[[], torch.Tensor]]:
        """One zero-argument step after another, from ``step_count`` on (a
        sampled trainer's batch is drawn before its step's clock starts)."""
        raise NotImplementedError

    # -------------------------------------------------------------------- run
    def run(
        self,
        log: Callable[[str], None] | None = print,
        initial_state: dict[str, torch.Tensor] | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
    ) -> dict[str, Any]:
        """Train for ``num_steps`` steps; return losses, step times and
        validation F1.

        Prints the reference's lines (model.py:100-106): ``"{step}
        {loss}"`` every ``log_every`` steps, then ``Validation F1:`` and
        ``Average batch time:`` (seconds on the host clock, each step ending
        when its loss is read; the first step is left out of the mean).

        ``initial_state`` (a restored checkpoint) is installed first; the
        run continues from the trainer's step, so a resumed run takes the
        batches an uninterrupted one would have, and ``num_steps`` counts
        the additional steps. ``checkpoint_every > 0`` writes the state to
        ``checkpoint_path`` whenever that many steps of this run complete.
        """
        if checkpoint_every > 0 and not checkpoint_path:
            raise ValueError(
                "checkpoint_every > 0 needs checkpoint_path — without it "
                "no snapshot would ever be written"
            )
        if initial_state is not None:
            self.load_state_dict(initial_state)
        cfg = self.cfg
        steps = self._steps()
        losses: list[float] = []
        times: list[float] = []
        for done in range(cfg.num_steps):
            step = next(steps)
            t0 = time.perf_counter()
            loss = float(step())
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            if log and cfg.log_every and done % cfg.log_every == 0:
                log(f"{done} {loss}")
            if checkpoint_every > 0 and (done + 1) % checkpoint_every == 0:
                self.write_checkpoint(checkpoint_path)

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


class Trainer(TrainLoop):
    """Sampled supervised training of ``model`` (which holds its parameters)
    on ``graph``; both must lie on the same device. Sampling draws from a
    ``torch.Generator`` on that device, seeded from ``config.seed``.

    An ``objective="unsupervised"`` config trains with
    :class:`~graphsage_torch.train.unsupervised.UnsupervisedTrainer`, a
    subclass; this class raises on one."""

    objective = "supervised"

    def __init__(self, model: GraphSAGE, graph: Graph, config: TrainConfig):
        if config.objective != self.objective:
            raise ValueError(
                f"{type(self).__name__} trains objective={self.objective!r}, the "
                f"config asks for {config.objective!r}: objective='unsupervised' "
                "trains with UnsupervisedTrainer (run_preset dispatches to it)"
            )
        with profiling.phase("trainer.init"):
            graph = self._prepare_graph(model, graph)
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

    def _prepare_graph(self, model: GraphSAGE, graph: Graph) -> Graph:
        """The graph this trainer samples from: ``graph``, with its layer-0
        cache built when a ``layer0="cached"`` model needs one (int8 for an
        int8 graph) and checked against the model's flavor. A lazy graph's
        descriptor is refused: it would train on ``N*F`` zeros."""
        reject_lazy_descriptor(graph.features, "Trainer (it would train on N*F zeros)")
        if model.layer0 == "cached":
            if graph.layer0_cache is None:
                # An int8 graph keeps an int8 cache: a dense one would be
                # four times the table that quantize_graph shrank.
                graph = with_cached_layer0(graph, self_loop=model.self_loop,
                                           quantize=is_quantized(graph.features))
            model.check_layer0_cache(graph)
        return graph

    # ------------------------------------------------------------------- step
    def step(self, seeds: np.ndarray) -> torch.Tensor:
        """One optimizer step on the seed ids ``seeds``; returns the batch
        loss as a 0-d tensor on the device (reading it waits for the step).
        Spans: ``step`` around ``step.sample``, ``step.forward`` (the
        logits and the loss), ``step.backward`` and ``step.optimizer``."""
        with profiling.span("step", device=self.device):
            with profiling.span("step.sample", device=self.device):
                ids = torch.from_numpy(np.asarray(seeds, dtype=np.int32)).to(self.device)
                frontier = self.model.sample(self.generator, self.graph, ids)
            with profiling.span("step.forward", device=self.device):
                loss = self.model.loss(self.graph.features, frontier,
                                       self.graph.labels[ids.long()], graph=self.graph)
            return self._update(loss)

    def _steps(self):
        for seeds in self.batches(start_step=self.step_count):
            yield functools.partial(self.step, seeds)

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
        return self.model.predictions(
            self.model(self.graph.features, frontier, graph=self.graph))

    def evaluate(self, nodes: np.ndarray) -> dict[str, float]:
        nodes = np.asarray(nodes)
        preds = self.predict(nodes)
        truth = self._labels[nodes]
        return {
            "micro_f1": micro_f1(truth, preds),
            "macro_f1": macro_f1(truth, preds, self.graph.num_classes),
        }
