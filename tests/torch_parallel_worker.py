"""One rank of the multi-process jobs behind ``tests/test_torch_parallel.py``.

Run as ``python tests/torch_parallel_worker.py JOB RANK WORLD PORT OUT_DIR
[CORA_ROOT]``: the rank joins a gloo process group of ``WORLD`` ranks on
``127.0.0.1:PORT``, runs every check of job ``JOB`` (``"two"`` or
``"four"``) on the CPU and writes what it computed to ``OUT_DIR/rankR.pt``
(numpy arrays, numbers and error messages), which the tests compare with
JAX's results and with the single-device port. It imports torch and the
port only, never JAX. The graphs, weights and batches are made here from
the seeds below, which the tests use too.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

# tests/test_distributed.py's and tests/test_feature_store.py's graphs.
DIST_GRAPH = dict(num_nodes=200, num_edges=800, num_feats=16, num_classes=4, seed=3)
FS_GRAPH = dict(num_nodes=200, num_edges=800, num_feats=48, num_classes=5, seed=7,
                homophily=0.8)
TRAIN = dict(batch_size=32, num_steps=3, learning_rate=0.5, test_size=40, val_size=40,
             log_every=0)
# distributed_full_graph_logits' cases: (aggregator, self_loop).
FULL_GRAPH_CASES = [("mean", False), ("mean", True), ("maxpool", False), ("maxpool", True)]
# ShardedFeatureTrainer against the single-device Trainer (fanouts 4, 4):
# model keywords (tests/test_feature_store.py's modes and the cached layer
# 0). The first two also against JAX's trainer at fanouts None (every
# neighbour: deterministic frontiers).
FEATURE_CASES = {
    "sampled": {},
    "cached": dict(layer0="cached"),
    "concat_self": dict(concat_self=True),
    "self_loop": dict(self_loop=True),
    "maxpool": dict(aggregator="maxpool", pool_dim=8, concat_self=True),
}
JAX_FEATURE_CASES = ["sampled", "cached"]
# ShardedTrainer on a {"data": 2, "model": 2} mesh: model keywords (fanouts
# 4, 4 against the single-device Trainer; each also at fanouts None against
# JAX's ShardedTrainer on a 2 x 2 mesh).
TP_CASES = {
    "mean": dict(hidden_dims=(16, 16), fanouts=(4, 4)),
    "cached": dict(hidden_dims=(8, 8), fanouts=(4, 4), layer0="cached"),
    "maxpool": dict(hidden_dims=(8, 8), fanouts=(4, 4), aggregator="maxpool", pool_dim=6,
                    concat_self=True),
}
GATHER_REQUESTS = 16  # row ids each rank requests in the row-gather case


def draw_params(model, seed: int) -> dict:
    """Numpy parameters for ``model`` (the convert.py tree), drawn from
    ``seed``: the same weights for the port and for JAX."""
    from graphsage_torch.convert import LAYER_FIELDS

    rng = np.random.default_rng(seed)

    def draw(p):
        return (rng.normal(size=tuple(p.shape)) * 0.3).astype(np.float32)

    return {"layers": [{f: (draw(getattr(layer, f)) if hasattr(layer, f) else None)
                        for f in LAYER_FIELDS} for layer in model.layers],
            "head": draw(model.head)}


def spmm_weights(num_nodes: int, num_feats: int) -> np.ndarray:
    """The cotangent of the sharded SpMM's output in its gradient case."""
    return np.random.default_rng(1).normal(size=(num_nodes, num_feats)).astype(np.float32)


def gather_ids(world: int, num_nodes: int) -> np.ndarray:
    """``[world, GATHER_REQUESTS]`` row ids (repeats, every owner)."""
    return np.random.default_rng(0).integers(0, num_nodes, (world, GATHER_REQUESTS)).astype(
        np.int32)


def _model(graph, seed=0, **kw):
    from graphsage_torch import GraphSAGE, params_from_numpy

    model = GraphSAGE(graph.num_features, graph.num_classes, device="cpu", **kw)
    return params_from_numpy(model, draw_params(model, seed))


def _params(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _steps(trainer, n: int) -> list[float]:
    it = trainer.batches()
    return [float(trainer.step(next(it))) for _ in range(n)]


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def spmm_case(world: int, rank: int) -> dict:
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.distributed import sharded_spmm_mean
    from graphsage_torch.parallel.mesh import make_mesh
    from graphsage_torch.parallel.partition import partition_edges

    graph = power_law_graph(device="cpu", **DIST_GRAPH)
    mesh = make_mesh({"graph": world})
    x = graph.features.clone().requires_grad_(True)
    mean, count = sharded_spmm_mean(mesh, "graph", x, partition_edges(graph, world),
                                    graph.num_nodes)
    (mean * torch.from_numpy(spmm_weights(*x.shape))).sum().backward()
    return {"mean": mean.detach().numpy(), "count": count.numpy(), "grad": x.grad.numpy()}


def full_graph_cases(world: int) -> dict:
    """Logits of each case, and the parameters' gradients of their sum of
    squares against the single-device forward's."""
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.distributed import distributed_full_graph_logits
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **DIST_GRAPH)
    mesh = make_mesh({"graph": world})
    out = {}
    for i, (agg, self_loop) in enumerate(FULL_GRAPH_CASES):
        kw = dict(hidden_dims=(8, 8), fanouts=(None, None), aggregator=agg,
                  self_loop=self_loop)
        if agg == "maxpool":
            kw.update(pool_dim=8, concat_self=not self_loop)
        model = _model(graph, seed=10 + i, **kw)
        got = distributed_full_graph_logits(model, graph, mesh)
        (got ** 2).sum().backward()
        grads = {n: p.grad.clone().numpy() for n, p in model.named_parameters()}
        model.zero_grad()
        want = model.forward_full_graph(graph)
        (want ** 2).sum().backward()
        out[(agg, self_loop)] = {
            "logits": got.detach().numpy(), "local": want.detach().numpy(),
            "grads": grads,
            "local_grads": {n: p.grad.numpy() for n, p in model.named_parameters()}}
    return out


def row_gather_case(world: int, rank: int) -> dict:
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.feature_store import shard_features, sharded_row_gather
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **FS_GRAPH)
    mesh = make_mesh({"data": world})
    store = shard_features(graph.features, world, rank)
    shard = store.shard.clone().requires_grad_(True)
    ids = torch.from_numpy(gather_ids(world, graph.num_nodes)[rank])
    rows = sharded_row_gather(mesh, "data", shard, ids)
    ((rows * rows).sum() / 2).backward()
    return {"rows": rows.detach().numpy(), "grad": shard.grad.numpy(),
            "shard_rows": int(store.shard.shape[0]), "memory_stats": store.memory_stats()}


def feature_trainer_cases(world: int) -> dict:
    from graphsage_torch import ShardedFeatureTrainer, TrainConfig, Trainer
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **FS_GRAPH)
    mesh = make_mesh({"data": world})
    cfg = TrainConfig(**TRAIN)
    out = {}
    for name, case in FEATURE_CASES.items():
        for fanouts in ((4, 4),) + (((None, None),) if name in JAX_FEATURE_CASES else ()):
            kw = dict(hidden_dims=(8, 8), fanouts=fanouts, **case)
            sharded = ShardedFeatureTrainer(_model(graph, **kw), graph, cfg, mesh)
            rec = {"losses": _steps(sharded, cfg.num_steps), "params": _params(sharded.model),
                   "shard_rows": int(sharded.features.shard.shape[0]),
                   "cache_rows": (None if sharded._cache_store is None
                                  else int(sharded._cache_store.shard.shape[0])),
                   "memory_stats": {k: v for k, v in sharded.memory_stats().items()
                                    if not k.startswith("measured")}}
            single = Trainer(_model(graph, **kw), graph, cfg)
            rec["single_losses"] = _steps(single, cfg.num_steps)
            rec["single_params"] = _params(single.model)
            out[(name, fanouts)] = rec
    # A bf16 table and bf16 compute (the sampled layer 0).
    bf16 = power_law_graph(device="cpu", feature_dtype=torch.bfloat16, **FS_GRAPH)
    kw = dict(hidden_dims=(8, 8), fanouts=(4, 4), compute_dtype=torch.bfloat16)
    sharded = ShardedFeatureTrainer(_model(bf16, **kw), bf16, cfg, mesh)
    single = Trainer(_model(bf16, **kw), bf16, cfg)
    out["bf16"] = {"losses": _steps(sharded, cfg.num_steps), "params": _params(sharded.model),
                   "single_losses": _steps(single, cfg.num_steps),
                   "single_params": _params(single.model),
                   "shard_dtype": str(sharded.features.shard.dtype)}
    return out


def errors_two(world: int, cora_root: str) -> dict:
    from graphsage_torch import ShardedFeatureTrainer, TrainConfig, quantize_graph
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.feature_store import shard_features_from_loader
    from graphsage_torch.parallel.mesh import make_mesh
    from graphsage_torch.train.experiments import run_preset

    graph = power_law_graph(device="cpu", **FS_GRAPH)
    mesh = make_mesh({"data": world})
    cfg = TrainConfig(**TRAIN)

    def build(model_kw=None, cfg=cfg, g=graph, **kw):
        return lambda: ShardedFeatureTrainer(_model(g, **(model_kw or {})), g, cfg, mesh, **kw)

    return {
        "indivisible": build(cfg=TrainConfig(**{**TRAIN, "batch_size": 31})),
        # JAX's hub_cache_rows errors: the dense exchange, and a lookup of a
        # table that depends on the parameters (layer 0 projects first).
        "compact": build(hub_cache_rows=8),
        "hub_cache_rows": build(model_kw=dict(hidden_dims=(8, 8)), gather_mode="compact",
                                hub_cache_rows=8),
        # JAX's layer0_exchange check, and its hub_cache_rows check of a
        # layer0='full' table over an int8 store.
        "layer0_full": build(model_kw=dict(layer0="full"), layer0_exchange="ring"),
        "int8": build(model_kw=dict(layer0="full"), g=quantize_graph(graph),
                      gather_mode="compact", hub_cache_rows=8),
        # JAX's check of a prebuilt store against the graph.
        "feature_store": build(feature_store=shard_features_from_loader(
            lambda lo, hi: np.zeros((hi - lo, graph.num_features), np.float32),
            graph.num_nodes - 1, graph.num_features, world, 0, device="cpu")),
        "run_preset_indivisible": lambda: run_preset(
            "cora", cora_root, log=None, mode="sharded", device="cpu",
            overrides={"batch_size": 31, "test_size": 100, "val_size": 80}),
    }


def run_preset_case(cora_root: str) -> dict:
    from graphsage_torch.train.experiments import run_preset

    over = {"num_steps": 4, "batch_size": 32, "test_size": 100, "val_size": 80}
    sharded = run_preset("cora", cora_root, log=None, mode="sharded", device="cpu",
                         overrides=over)
    single = run_preset("cora", cora_root, log=None, device="cpu", overrides=over)
    return {"losses": sharded["losses"], "single_losses": single["losses"],
            "val": sharded["val_micro_f1"], "single_val": single["val_micro_f1"],
            "params": _params(sharded["trainer"].model),
            "single_params": _params(single["trainer"].model)}


def tp_cases(world: int) -> dict:
    from graphsage_torch import ShardedTrainer, TrainConfig, Trainer
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **DIST_GRAPH)
    mesh = make_mesh({"data": 2, "model": world // 2})
    cfg = TrainConfig(**TRAIN)
    out = {}
    for name, kw in TP_CASES.items():
        sharded = ShardedTrainer(_model(graph, **kw), graph, cfg, mesh)
        rec = {"losses": _steps(sharded, cfg.num_steps), "params": _params(sharded.model),
               "cache": sharded.graph.layer0_cache is not None,
               "feature_cols": int(sharded.graph.features.shape[1])}
        single = Trainer(_model(graph, **kw), graph, cfg)
        rec["single_losses"] = _steps(single, cfg.num_steps)
        rec["single_params"] = _params(single.model)
        rec["single_val"] = single.evaluate(single.val_nodes)["micro_f1"]
        rec["val"] = sharded.evaluate(sharded.val_nodes)["micro_f1"]
        out[name] = rec
        covering = {**kw, "fanouts": (None, None)}
        out[(name, (None, None))] = _steps(
            ShardedTrainer(_model(graph, **covering), graph, cfg, mesh), cfg.num_steps)
    out["indivisible"] = _error(lambda: ShardedTrainer(
        _model(graph, **TP_CASES["mean"]), graph,
        TrainConfig(**{**TRAIN, "batch_size": 31}), mesh))
    return out


def main(job: str, rank: int, world: int, port: int, out_dir: str, cora_root: str = "") -> None:
    from graphsage_torch.parallel import multihost

    info = multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = {"info": info, "primary": multihost.is_primary(),
           "spmm": spmm_case(world, rank)}
    if job == "two":
        res["full_graph"] = full_graph_cases(world)
        res["row_gather"] = row_gather_case(world, rank)
        res["feature_trainer"] = feature_trainer_cases(world)
        res["errors"] = {k: _error(fn) if callable(fn) else fn
                         for k, fn in errors_two(world, cora_root).items()}
        res["run_preset"] = run_preset_case(cora_root)
    else:
        res["tp"] = tp_cases(world)
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
         *sys.argv[6:])
