"""One rank of the multi-process jobs behind ``tests/test_torch_fully_sharded.py``.

Run as ``python tests/torch_fully_sharded_worker.py JOB RANK WORLD PORT
OUT_DIR``: the rank joins a gloo process group of ``WORLD`` ranks on
``127.0.0.1:PORT``, runs the checks of job ``JOB`` (``"two"`` or ``"four"``)
on the CPU and writes what it computed to ``OUT_DIR/rankR.pt``, which the
tests compare with JAX's results and with the port's other trainers. It
imports torch and the port only, never JAX; graphs, weights and inputs come
from the seeds here and in ``tests/torch_parallel_worker.py``.
"""

from __future__ import annotations

import sys
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_parallel_worker import FS_GRAPH, TRAIN, _error, _model, _params, _steps  # noqa: E402

torch.set_num_threads(1)

GATHER_ROWS, GATHER_K = 12, 5  # each rank's [B, k] requests in the gather cases
HUB_ROWS = 8
SLACK = 8.0  # the fully sharded cases' capacity slack (JAX's test uses 8)
# The matching of tests/test_unsupervised.py's deterministic walk: 16 nodes,
# pairs (0, 1) .. (12, 13), nodes 14 and 15 isolated.
WALK_EDGES = np.array([[2 * i, 2 * i + 1] for i in range(7)])
WALK_LENGTH = 4
UNSUP = dict(batch_size=16, optimizer="adam", learning_rate=0.01, objective="unsupervised",
             test_size=40, val_size=40, log_every=0)
UNSUP_STEPS = 3
UNSUP_TRAIN_STEPS = 12  # the fully sharded unsupervised run, which must learn


def gather_inputs(world: int, num_nodes: int, num_feats: int):
    """Per rank ``idx [B, k]`` int32, ``mask [B, k]`` (row 0 all masked) and
    the cotangent ``w [B, F]``, stacked ``[world, ...]``."""
    rng = np.random.default_rng(4)
    idx = rng.integers(0, num_nodes, (world, GATHER_ROWS, GATHER_K)).astype(np.int32)
    mask = rng.random((world, GATHER_ROWS, GATHER_K)) < 0.8
    mask[:, 0] = False
    w = rng.normal(size=(world, GATHER_ROWS, num_feats)).astype(np.float32)
    return idx, mask, w


def covering_fanout(graph) -> int:
    """The ELL width: every row's neighbours in their order, no draw."""
    return int(graph.neighbors.shape[1])


def compact_cases(world: int, rank: int) -> dict:
    """The compact mean and rows (and their gradients: of ``sum(mean * w)``
    and of half the valid rows' sum of squares), the dense mean, and the
    hub-cache values, on this rank's requests."""
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.feature_store import (
        build_hub_cache,
        request_capacity,
        shard_features,
        sharded_gather_mean,
        sharded_gather_mean_compact,
        sharded_row_gather_compact,
    )
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **FS_GRAPH)
    mesh = make_mesh({"data": world})
    idx, mask, w = (torch.from_numpy(a[rank])
                    for a in gather_inputs(world, graph.num_nodes, graph.num_features))
    cap = request_capacity(idx.numel(), world, 1.5)
    shard = lambda: shard_features(graph.features, world, rank).shard.requires_grad_(True)  # noqa: E731
    out = {}
    t = shard()
    mean = sharded_gather_mean_compact(mesh, "data", t, idx, mask, cap)
    (mean * w).sum().backward()
    out["mean"], out["mean_grad"] = mean.detach().numpy(), t.grad.numpy()
    t = shard()
    rows = sharded_row_gather_compact(mesh, "data", t, idx, cap, mask)
    ((rows * rows * mask[..., None]).sum() / 2).backward()
    out["rows"], out["rows_grad"] = rows.detach().numpy(), t.grad.numpy()
    t = shard()
    dense = sharded_gather_mean(mesh, "data", t, idx, mask)
    (dense * w).sum().backward()
    out["dense_mean"], out["dense_grad"] = dense.detach().numpy(), t.grad.numpy()
    hub = build_hub_cache(graph.features, graph.degrees, HUB_ROWS)
    with torch.no_grad():
        table = shard_features(graph.features, world, rank).shard
        out["hub_mean"] = sharded_gather_mean_compact(mesh, "data", table, idx, mask, cap,
                                                      hub).numpy()
        out["hub_rows"] = sharded_row_gather_compact(mesh, "data", table, idx, cap, mask,
                                                     hub).numpy()
    return out


def fully_sharded_cases(world: int) -> dict:
    """At covering fanouts: FullyShardedTrainer against
    ShardedFeatureTrainer (losses, parameters, evaluation), sampled and
    cached; the compact ShardedFeatureTrainer against the single device at
    fanouts (4, 4)."""
    from graphsage_torch import FullyShardedTrainer, ShardedFeatureTrainer, TrainConfig, Trainer
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **FS_GRAPH)
    mesh = make_mesh({"data": world})
    cover = covering_fanout(graph)
    out = {}
    for name, kw in (("sampled", {}), ("cached", dict(layer0="cached"))):
        model_kw = dict(hidden_dims=(8, 8), fanouts=(cover, cover), **kw)
        cfg = TrainConfig(**TRAIN, eval_fanouts=(cover, cover))
        fully = FullyShardedTrainer(_model(graph, **model_kw), graph, cfg, mesh,
                                    capacity_slack=SLACK)
        node = ShardedFeatureTrainer(_model(graph, **model_kw), graph, cfg, mesh)
        out[name] = {
            "losses": _steps(fully, cfg.num_steps), "params": _params(fully.model),
            "node_losses": _steps(node, cfg.num_steps), "node_params": _params(node.model),
            "preds": fully.predict(fully.val_nodes), "node_preds": node.predict(node.val_nodes),
            "memory_stats": {k: v for k, v in fully.memory_stats().items()
                             if not k.startswith("measured")},
            "adjacency_rows": int(fully.adjacency.ell.shape[0]),
        }
    cfg = TrainConfig(**TRAIN)
    kw = dict(hidden_dims=(8, 8), fanouts=(4, 4), concat_self=True)
    compact = ShardedFeatureTrainer(_model(graph, **kw), graph, cfg, mesh, gather_mode="compact")
    single = Trainer(_model(graph, **kw), graph, cfg)
    out["compact"] = {"losses": _steps(compact, cfg.num_steps),
                      "single_losses": _steps(single, cfg.num_steps),
                      "params": _params(compact.model), "single_params": _params(single.model)}
    return out


def ladder_case(world: int) -> dict:
    """The compact trainer at slack 0.25 (every step overflows twice before
    it fits) against the same at the default slack."""
    from graphsage_torch import ShardedFeatureTrainer, TrainConfig
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **FS_GRAPH)
    mesh = make_mesh({"data": world})
    cfg = TrainConfig(**TRAIN)
    kw = dict(hidden_dims=(8, 8), fanouts=(4, 4))
    low = ShardedFeatureTrainer(_model(graph, **kw), graph, cfg, mesh, gather_mode="compact",
                                capacity_slack=0.25)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses = _steps(low, cfg.num_steps)
    ref = ShardedFeatureTrainer(_model(graph, **kw), graph, cfg, mesh, gather_mode="compact")
    return {"losses": losses, "ref_losses": _steps(ref, cfg.num_steps),
            "warnings": [str(w.message) for w in caught if "capacity" in str(w.message)],
            "params": _params(low.model), "ref_params": _params(ref.model),
            "step_count": low.step_count}


def walk_case(world: int, rank: int) -> dict:
    from graphsage_torch.data.graph import build_graph
    from graphsage_torch.ops.walks import random_walk
    from graphsage_torch.parallel.feature_store import (
        owner_generator,
        shard_adjacency,
        sharded_random_walk,
    )
    from graphsage_torch.parallel.mesh import make_mesh

    g = build_graph(np.zeros((16, 4), np.float32), np.zeros(16), WALK_EDGES, num_classes=1,
                    device="cpu")
    mesh = make_mesh({"data": world})
    starts = torch.arange(16, dtype=torch.int32)
    walks, valid, violated = sharded_random_walk(
        mesh, "data", shard_adjacency(g, world, rank), starts.chunk(world)[rank], WALK_LENGTH,
        owner_generator("cpu", 3, 0, rank), 4.0)
    want_w, want_v = random_walk(torch.Generator().manual_seed(9), g, starts, WALK_LENGTH)
    return {"walks": walks.numpy(), "valid": valid.numpy(), "violated": bool(violated),
            "want_walks": want_w.chunk(world)[rank].numpy(),
            "want_valid": want_v.chunk(world)[rank].numpy()}


def unsupervised_cases(world: int) -> dict:
    from graphsage_torch import TrainConfig
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.mesh import make_mesh
    from graphsage_torch.train.unsupervised import (
        UnsupervisedFullyShardedTrainer,
        UnsupervisedShardedTrainer,
        UnsupervisedTrainer,
    )

    graph = power_law_graph(device="cpu", **FS_GRAPH)
    mesh = make_mesh({"data": world})
    kw = dict(hidden_dims=(8, 8), fanouts=(4, 4), final_activation="linear")
    cfg = TrainConfig(**UNSUP, num_steps=UNSUP_STEPS)
    out = {"single": _steps(UnsupervisedTrainer(_model(graph, **kw), graph, cfg), UNSUP_STEPS)}
    for mode in ("dense", "compact"):
        tr = UnsupervisedShardedTrainer(_model(graph, **kw), graph, cfg, mesh, gather_mode=mode)
        out[mode] = _steps(tr, UNSUP_STEPS)
    out["sharded_preds"] = tr.predict(tr.val_nodes)
    fully = UnsupervisedFullyShardedTrainer(_model(graph, **kw), graph, cfg, mesh)
    out["fully"] = _steps(fully, UNSUP_TRAIN_STEPS)
    out["fully_slack"] = fully.capacity_slack
    out["fully_preds"] = fully.predict(fully.val_nodes)
    return out


def errors_two(world: int) -> dict:
    from graphsage_torch import FullyShardedTrainer, TrainConfig
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **FS_GRAPH)
    mesh = make_mesh({"data": world})
    cfg = TrainConfig(**TRAIN)
    return {
        "topk": _error(lambda: FullyShardedTrainer(
            _model(graph, hidden_dims=(8, 8), fanouts=(4, 4), sampling="topk"), graph, cfg,
            mesh)),
        "layer0_full": _error(lambda: FullyShardedTrainer(
            _model(graph, hidden_dims=(8, 8), fanouts=(4, 4), layer0="full"), graph, cfg,
            mesh, layer0_exchange="halo")),
    }


def main(job: str, rank: int, world: int, port: int, out_dir: str) -> None:
    from graphsage_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = {"compact": compact_cases(world, rank), "fully": fully_sharded_cases(world)}
    if job == "two":
        res["ladder"] = ladder_case(world)
        res["walk"] = walk_case(world, rank)
        res["unsup"] = unsupervised_cases(world)
        res["errors"] = errors_two(world)
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
