"""Reference-compatible experiment drivers: the counterpart of
``graphsage_tpu/train/experiments.py`` for sampled supervised training.

``run_cora()`` / ``run_pubmed()`` reproduce the observable surface of the
reference's entry points (reference graphsage/model.py:65-106, 137-178):
load the dataset from the original file formats, train the preset config,
print per-batch loss lines and finally ``Validation F1`` and ``Average batch
time``. ``run_preset`` is the general driver behind them and the CLI
(``python -m graphsage_torch.train``). Everything runs on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from graphsage_torch.data.graph import Graph
from graphsage_torch.data.loaders import load_cora, load_pubmed
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.train.config import PRESETS, ExperimentConfig
from graphsage_torch.train.trainer import Trainer

# Training modes of the JAX package that the port does not run yet, and the
# ROADMAP Queue 1 item that brings each.
_NOT_PORTED_MODES = {"full-graph": 10, "sharded": 14, "fully-sharded": 14}


def load_dataset(name: str, data_root: str | None = None, device=None) -> Graph:
    """The preset's dataset as a :class:`Graph` on ``device``."""
    if name == "cora":
        return load_cora(data_root or "cora", device=device)
    if name == "pubmed":
        return load_pubmed(data_root or "pubmed-data", device=device)
    if name in ("powerlaw", "powerlaw_1m", "reddit"):
        raise NotImplementedError(
            f"the presets on dataset {name!r} (a power_law_graph) train in "
            "bfloat16, which is not ported yet (ROADMAP Queue 1 item 8)"
        )
    raise ValueError(f"unknown dataset {name!r}")


def build_model(config: ExperimentConfig, graph: Graph) -> GraphSAGE:
    """The preset's model on the graph's device, initialised from
    ``config.train.seed``."""
    return GraphSAGE.from_config(
        config.model, graph.num_features, graph.num_classes,
        generator=torch.Generator().manual_seed(config.train.seed),
        device=graph.device,
    )


def preset_config(name: str, overrides: dict[str, Any] | None = None) -> ExperimentConfig:
    """``PRESETS[name]`` with ``overrides`` applied to whichever of its train
    and model fields they name."""
    config = PRESETS[name]
    if not overrides:
        return config
    train_over = {k: v for k, v in overrides.items()
                  if k in {f.name for f in dataclasses.fields(config.train)}}
    model_over = {k: v for k, v in overrides.items()
                  if k in {f.name for f in dataclasses.fields(config.model)}}
    return dataclasses.replace(
        config,
        train=dataclasses.replace(config.train, **train_over),
        model=dataclasses.replace(config.model, **model_over),
    )


def run_preset(
    name: str,
    data_root: str | None = None,
    log: Callable[[str], None] | None = print,
    overrides: dict[str, Any] | None = None,
    mode: str = "sampled",
    device=None,
) -> dict[str, Any]:
    """Train one of the presets end to end (``mode="sampled"``, minibatch
    neighbor sampling, the reference's scheme): load its dataset, build its
    model and trainer, run. The result holds the losses, step times,
    validation F1 and the ``trainer`` (with the trained model)."""
    if mode in _NOT_PORTED_MODES:
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (ROADMAP Queue 1 item "
            f"{_NOT_PORTED_MODES[mode]}); the port trains mode='sampled'"
        )
    if mode != "sampled":
        raise ValueError(f"unknown mode {mode!r}")
    config = preset_config(name, overrides)
    graph = load_dataset(config.dataset, data_root, device)
    trainer = Trainer(build_model(config, graph), graph, config.train)
    result = trainer.run(log=log)
    result["trainer"] = trainer
    return result


def run_cora(data_root: str | None = None, **kwargs) -> dict[str, Any]:
    """The reference's `run_cora` surface (model.py:65-106): 100 x 256-node
    batches, SGD lr 0.7, per-batch loss lines, final val micro-F1."""
    return run_preset("cora", data_root=data_root, **kwargs)


def run_pubmed(data_root: str | None = None, **kwargs) -> dict[str, Any]:
    """The reference's `run_pubmed` surface (model.py:137-178)."""
    return run_preset("pubmed", data_root=data_root, **kwargs)


# Flags of the JAX package's CLI that the port does not take yet: the
# ROADMAP Queue 1 item that brings each, or why it has no counterpart.
_NOT_PORTED_FLAGS = {
    "checkpoint": 12,
    "checkpoint_every": 12,
    "resume": 12,
    "eval_only": 12,
    "log_jsonl": 12,
    "diagnostics_dir": 12,
    "sampling": 9,
    "layer0": 6,
    "quantize_features": 8,
    "hub_cache_rows": 14,
    "debug_nans": "the port has no NaN-checking mode yet",
    "compilation_cache": "the port compiles no XLA programs",
    "no_compilation_cache": "the port compiles no XLA programs",
}


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m graphsage_torch.train",
        description="Train GraphSAGE with the PyTorch/CUDA port (presets "
        "mirror the reference's run_cora/run_pubmed).",
    )
    parser.add_argument("--preset", default="cora", choices=sorted(PRESETS))
    parser.add_argument(
        "--mode", default="sampled",
        choices=("sampled", "full-graph", "sharded", "fully-sharded"),
    )
    parser.add_argument("--data-root", default=None,
                        help="dataset directory (cora/ or pubmed-data/ layout)")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--batching", choices=("epoch", "reference"), default=None)
    parser.add_argument("--test-size", type=int, default=None)
    parser.add_argument("--val-size", type=int, default=None)
    parser.add_argument("--quiet", action="store_true", help="suppress per-step loss")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda or cpu)")
    for flag in _NOT_PORTED_FLAGS:
        opt = "--" + flag.replace("_", "-")
        if flag in ("eval_only", "debug_nans", "quantize_features",
                    "no_compilation_cache"):
            parser.add_argument(opt, action="store_true", help="not ported yet")
        else:
            parser.add_argument(opt, default=None, help="not ported yet")
    args = parser.parse_args(argv)

    for flag, why in _NOT_PORTED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            reason = (f"not ported yet (ROADMAP Queue 1 item {why})"
                      if isinstance(why, int) else f"not ported: {why}")
            raise NotImplementedError(f"--{flag.replace('_', '-')} is {reason}")

    overrides: dict[str, Any] = {}
    for flag, field in (("steps", "num_steps"), ("batch_size", "batch_size"),
                        ("lr", "learning_rate"), ("seed", "seed"),
                        ("batching", "batching"), ("test_size", "test_size"),
                        ("val_size", "val_size")):
        if getattr(args, flag) is not None:
            overrides[field] = getattr(args, flag)
    if args.quiet:
        overrides["log_every"] = 0
    run_preset(args.preset, data_root=args.data_root, overrides=overrides or None,
               mode=args.mode, device=args.device)
