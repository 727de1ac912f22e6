"""Reference-compatible experiment drivers: the counterpart of
``graphsage_tpu/train/experiments.py`` for supervised training, sampled or
full-graph.

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

from graphsage_torch.data.graph import Graph, quantize_graph
from graphsage_torch.data.loaders import load_cora, load_pubmed
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.models.graphsage import GraphSAGE
from graphsage_torch.train.config import PRESETS, ExperimentConfig
from graphsage_torch.train.full_graph import FullGraphTrainer
from graphsage_torch.train.trainer import Trainer

# Training modes of the JAX package that the port does not run yet, and the
# ROADMAP Queue 1 item that brings each.
_NOT_PORTED_MODES = {"sharded": 14, "fully-sharded": 14}


# The synthetic power-law datasets: JAX's sizes (its train/experiments.py),
# homophily 0.8 so that a model which sees only neighbour means can learn the
# labels. ``reddit`` has the real dataset's shape (232965 nodes, 602
# features, 41 classes; about 11.6M directed edge slots), ``powerlaw_1m``
# 1M nodes and about 20M slots; both keep bf16 features.
POWER_LAW_DATASETS = {
    "powerlaw": dict(num_nodes=100_000, num_edges=2_000_000, num_feats=256,
                     num_classes=16),
    "reddit": dict(num_nodes=232_965, num_edges=5_800_000, num_feats=602,
                   num_classes=41, feature_dtype=torch.bfloat16),
    "powerlaw_1m": dict(num_nodes=1_000_000, num_edges=10_000_000, num_feats=256,
                        num_classes=32, feature_dtype=torch.bfloat16),
}


def load_dataset(name: str, data_root: str | None = None, device=None) -> Graph:
    """The preset's dataset as a :class:`Graph` on ``device``: the Cora and
    Pubmed files, or a seeded ``power_law_graph`` stand-in."""
    if name == "cora":
        return load_cora(data_root or "cora", device=device)
    if name == "pubmed":
        return load_pubmed(data_root or "pubmed-data", device=device)
    if name in POWER_LAW_DATASETS:
        return power_law_graph(**POWER_LAW_DATASETS[name], homophily=0.8, device=device)
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
    """Train one of the presets end to end: load its dataset, build its
    model and trainer, run. ``mode="sampled"`` trains on minibatches with
    neighbor sampling (the reference's scheme), ``mode="full-graph"``
    full-batch over complete neighborhoods (:class:`FullGraphTrainer`, the
    model built with every fanout ``None``). The result holds the losses,
    step times, validation F1 and the ``trainer`` (with the trained model).
    ``quantize_features`` in the preset (or the overrides) quantizes the
    loaded graph's feature table to int8 first."""
    if mode in _NOT_PORTED_MODES:
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (ROADMAP Queue 1 item "
            f"{_NOT_PORTED_MODES[mode]}); the port trains mode='sampled' and "
            "'full-graph'"
        )
    if mode not in ("sampled", "full-graph"):
        raise ValueError(f"unknown mode {mode!r}")
    config = preset_config(name, overrides)
    graph = load_dataset(config.dataset, data_root, device)
    if config.model.quantize_features:
        graph = quantize_graph(graph)
        if log:
            log(f"feature table quantized to int8: {graph.features.nbytes} B resident")
    if mode == "full-graph":
        fanouts = tuple(None for _ in config.model.fanouts)
        config = dataclasses.replace(
            config, model=dataclasses.replace(config.model, fanouts=fanouts))
        trainer = FullGraphTrainer(build_model(config, graph), graph, config.train)
    else:
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
    parser.add_argument("--sampling", choices=("floyd", "topk", "windowed"),
                        default=None,
                        help="neighbor sampler: floyd (exact uniform, "
                        "default) | topk (the same, by key sort) | windowed "
                        "(one 128-slot CSR window per parent, unbiased-mean "
                        "semantics)")
    parser.add_argument("--layer0", choices=("sampled", "full", "cached"),
                        default=None,
                        help="layer-0 formulation: sampled (the reference's "
                        "estimator) | full (one full-graph pass per step) | "
                        "cached (a frozen aggregate table built once)")
    parser.add_argument("--quantize-features", action="store_true",
                        help="int8-quantize the frozen feature table at load "
                        "time (per-row scales)")
    for flag in _NOT_PORTED_FLAGS:
        opt = "--" + flag.replace("_", "-")
        if flag in ("eval_only", "debug_nans", "no_compilation_cache"):
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
                        ("val_size", "val_size"), ("layer0", "layer0"),
                        ("sampling", "sampling")):
        if getattr(args, flag) is not None:
            overrides[field] = getattr(args, flag)
    if args.quantize_features:
        overrides["quantize_features"] = True
    if args.quiet:
        overrides["log_every"] = 0
    run_preset(args.preset, data_root=args.data_root, overrides=overrides or None,
               mode=args.mode, device=args.device)
