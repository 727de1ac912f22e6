"""Reference-compatible experiment drivers: the counterpart of
``graphsage_tpu/train/experiments.py``: supervised training, sampled,
full-graph, node-sharded or fully sharded, unsupervised training
(``objective="unsupervised"``: sampled or either sharded mode), checkpoints
and resume.

``run_cora()`` / ``run_pubmed()`` reproduce the observable surface of the
reference's entry points (reference graphsage/model.py:65-106, 137-178):
load the dataset from the original file formats, train the preset config,
print per-batch loss lines and finally ``Validation F1`` and ``Average batch
time``. ``run_preset`` is the general driver behind them and the CLI
(``python -m graphsage_torch.train``). Everything runs on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
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
from graphsage_torch.train.unsupervised import UnsupervisedTrainer
from graphsage_torch.utils import profiling
from graphsage_torch.utils.checkpoint import restore_checkpoint
from graphsage_torch.utils.diagnostics import diagnose
from graphsage_torch.utils.logging import MetricsLogger

MODES = ("sampled", "full-graph", "sharded", "fully-sharded")
_SHARDED_MODES = ("sharded", "fully-sharded")


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


def build_model(config: ExperimentConfig, graph: Graph, device=None) -> GraphSAGE:
    """The preset's model on ``device`` (default: the graph's), initialised
    from ``config.train.seed``."""
    return GraphSAGE.from_config(
        config.model, graph.num_features, graph.num_classes,
        generator=torch.Generator().manual_seed(config.train.seed),
        device=graph.device if device is None else device,
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
    checkpoint_path: str | None = None,
    mode: str = "sampled",
    resume_path: str | None = None,
    eval_only: bool = False,
    checkpoint_every: int = 0,
    device=None,
    hub_cache_rows: int = 0,
) -> dict[str, Any]:
    """Train one of the presets end to end: load its dataset, build its
    model and trainer, run. ``mode="sampled"`` trains on minibatches with
    neighbor sampling (the reference's scheme), ``mode="full-graph"``
    full-batch over complete neighborhoods (:class:`FullGraphTrainer`, the
    model built with every fanout ``None``), ``mode="sharded"`` sampled
    over every rank of the process group with the feature table
    node-sharded (:class:`~graphsage_torch.parallel.feature_store.
    ShardedFeatureTrainer`; a plain process is a world of one, ``torchrun
    --nproc-per-node=S`` gives S ranks, and only rank 0 logs and writes
    checkpoints), ``mode="fully-sharded"`` the same with the adjacency
    sharded too and each hop sampled at its owner (:class:`~graphsage_torch.
    parallel.feature_store.FullyShardedTrainer`). An
    ``objective="unsupervised"`` preset trains with
    :class:`UnsupervisedTrainer`, or in the sharded modes with
    ``UnsupervisedShardedTrainer`` and ``UnsupervisedFullyShardedTrainer``.
    ``hub_cache_rows`` (sharded modes only) replicates that many
    highest-degree rows; in ``mode="sharded"`` it selects the compact
    exchange (``gather_mode="compact"``), as in the JAX package. The result
    holds the losses, step times, validation F1 and the ``trainer`` (with
    the trained model). ``quantize_features`` in the preset (or the
    overrides) quantizes the loaded graph's feature table to int8 first.

    ``resume_path`` restores a checkpoint into the new trainer and
    continues from it; ``checkpoint_path`` receives the final state (and a
    snapshot every ``checkpoint_every`` steps); ``eval_only`` evaluates the
    restored state on the validation and test splits without training."""
    if hub_cache_rows and mode not in _SHARDED_MODES:
        raise ValueError(
            "hub_cache_rows is a sharded-trainer lever (the single-table "
            f"modes gather locally); got mode={mode!r} — drop the flag or "
            "use mode='sharded'/'fully-sharded'"
        )
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    config = preset_config(name, overrides)
    model_device = None
    if mode in _SHARDED_MODES:
        from graphsage_torch.parallel import multihost

        info = multihost.initialize(device=device)
        s = info["process_count"]
        if config.train.batch_size % s:
            raise ValueError(
                f"batch_size {config.train.batch_size} is not divisible by "
                f"the {s} visible devices; pass --batch-size"
            )
        if not multihost.is_primary():
            log = None
        # The graph stays on the host: each rank's shard is cut from it.
        model_device, device = multihost.device(), "cpu"
    graph = load_dataset(config.dataset, data_root, device)
    if config.model.quantize_features:
        graph = quantize_graph(graph)
        if log:
            log(f"feature table quantized to int8: {graph.features.nbytes} B resident")
    sharded_kw = {}
    if hub_cache_rows:
        sharded_kw["hub_cache_rows"] = hub_cache_rows
        if mode == "sharded":
            sharded_kw["gather_mode"] = "compact"
    if config.train.objective == "unsupervised":
        if mode == "full-graph":
            raise ValueError(
                "objective='unsupervised' supports mode='sampled', the "
                "node-sharded mode='sharded', and the everything-sharded "
                f"mode='fully-sharded' (got mode={mode!r})"
            )
        if mode == "sampled":
            trainer = UnsupervisedTrainer(build_model(config, graph), graph, config.train)
        else:
            from graphsage_torch.parallel.mesh import make_mesh
            from graphsage_torch.train.unsupervised import (
                UnsupervisedFullyShardedTrainer,
                UnsupervisedShardedTrainer,
            )

            cls = (UnsupervisedShardedTrainer if mode == "sharded"
                   else UnsupervisedFullyShardedTrainer)
            trainer = cls(build_model(config, graph, model_device), graph, config.train,
                          make_mesh({"data": s}), **sharded_kw)
    elif mode == "full-graph":
        fanouts = tuple(None for _ in config.model.fanouts)
        config = dataclasses.replace(
            config, model=dataclasses.replace(config.model, fanouts=fanouts))
        trainer = FullGraphTrainer(build_model(config, graph), graph, config.train)
    elif mode in _SHARDED_MODES:
        from graphsage_torch.parallel.feature_store import (
            FullyShardedTrainer,
            ShardedFeatureTrainer,
        )
        from graphsage_torch.parallel.mesh import make_mesh

        cls = ShardedFeatureTrainer if mode == "sharded" else FullyShardedTrainer
        trainer = cls(build_model(config, graph, model_device), graph, config.train,
                      make_mesh({"data": s}), **sharded_kw)
        if log:
            stats = trainer.memory_stats()
            log(f"{mode} over {s} device(s): "
                f"{stats['feature_bytes_per_chip']} feature B/chip "
                f"(replicated would be {stats['feature_bytes_replicated']})")
    else:
        trainer = Trainer(build_model(config, graph), graph, config.train)
    initial_state = None
    if resume_path:
        initial_state = restore_checkpoint(resume_path, trainer.state_dict(),
                                           map_location=trainer.device)
        if log:
            log(f"resumed from {resume_path} at step {int(initial_state['step'])}")
    if eval_only:
        if initial_state is None:
            raise ValueError("eval_only requires resume_path (a trained state)")
        if checkpoint_path:
            raise ValueError(
                "eval_only does not train — combining it with checkpoint_path "
                "would silently write nothing; drop one of the two"
            )
        trainer.load_state_dict(initial_state)
        val = trainer.evaluate(trainer.val_nodes)
        test = trainer.evaluate(trainer.test_nodes)
        if log:
            log(f"Validation F1: {val['micro_f1']}")
            log(f"Test F1: {test['micro_f1']}")
        return {
            "losses": [],
            "val_micro_f1": val["micro_f1"],
            "val_macro_f1": val["macro_f1"],
            "test_micro_f1": test["micro_f1"],
            "test_macro_f1": test["macro_f1"],
            "mean_step_time": 0.0,
            "trainer": trainer,
        }
    result = trainer.run(log=log, initial_state=initial_state,
                         checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every)
    if checkpoint_path:
        written = trainer.write_checkpoint(checkpoint_path)
        if log:
            log(f"checkpoint written: {written}")
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
        "--mode", default="sampled", choices=MODES,
        help="sampled | full-graph | sharded (the feature table node-sharded "
        "over the process group's ranks) | fully-sharded (the adjacency too)",
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
    parser.add_argument("--hub-cache-rows", type=int, default=0,
                        help="sharded modes: replicate this many highest-degree "
                        "feature rows on every rank (selects the compact "
                        "exchange under --mode sharded)")
    parser.add_argument("--quantize-features", action="store_true",
                        help="int8-quantize the frozen feature table at load "
                        "time (per-row scales)")
    parser.add_argument("--checkpoint", default=None,
                        help="write the final state here (.pt appended)")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="also snapshot --checkpoint every N steps "
                        "(checkpoint-restart)")
    parser.add_argument("--resume", default=None,
                        help="restore this checkpoint and continue training")
    parser.add_argument("--eval-only", action="store_true",
                        help="evaluate a --resume checkpoint (validation and "
                        "test F1; the reference computes its test split but "
                        "never evaluates it, quirk Q6) without training")
    parser.add_argument("--log-jsonl", default=None,
                        help="append structured metrics records to this file")
    parser.add_argument("--diagnostics-dir", default=None,
                        help="collect fault and hang stack traces here during "
                        "the run (faulthandler)")
    parser.add_argument("--spans", default=None, metavar="PATH",
                        help="record the program's spans and counters "
                        "(utils/profiling.py) and write them to PATH at the "
                        "end, a Chrome trace (a sharded run's ranks other "
                        "than 0 write PATH.rank<r>)")
    parser.add_argument("--debug-nans", action="store_true",
                        help="fail fast on NaN: autograd anomaly detection, "
                        "and a FloatingPointError when a step's loss is not "
                        "finite (checks less than the JAX package's "
                        "jax_debug_nans, which checks every op's output)")
    for flag in _NOT_PORTED_FLAGS:
        opt = "--" + flag.replace("_", "-")
        if flag == "no_compilation_cache":
            parser.add_argument(opt, action="store_true", help="not ported")
        else:
            parser.add_argument(opt, default=None, help="not ported")
    args = parser.parse_args(argv)

    for flag, why in _NOT_PORTED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not ported: {why}")

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

    if args.spans:
        profiling.enable()
    with contextlib.ExitStack() as scope:
        if args.debug_nans:
            scope.enter_context(torch.autograd.set_detect_anomaly(True))
        if args.diagnostics_dir:
            scope.enter_context(diagnose(stack_trace_dir=args.diagnostics_dir))
        result = run_preset(
            args.preset, data_root=args.data_root, overrides=overrides or None,
            checkpoint_path=args.checkpoint, mode=args.mode,
            resume_path=args.resume, eval_only=args.eval_only,
            checkpoint_every=args.checkpoint_every, device=args.device,
            hub_cache_rows=args.hub_cache_rows,
        )
    spans_path = args.spans
    if args.mode in _SHARDED_MODES:
        import torch.distributed as dist

        if spans_path and dist.get_rank():
            spans_path += f".rank{dist.get_rank()}"
        dist.destroy_process_group()
    if spans_path:
        profiling.export(spans_path)
    if args.log_jsonl:
        with MetricsLogger(args.log_jsonl, stdout=False, run_name=args.preset) as ml:
            for i, loss in enumerate(result["losses"]):
                ml.log("step", step=i, loss=loss)
            ml.log("eval", val_micro_f1=result["val_micro_f1"],
                   val_macro_f1=result["val_macro_f1"],
                   mean_step_time=result["mean_step_time"])
