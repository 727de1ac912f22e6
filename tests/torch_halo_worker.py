"""One rank of the multi-process jobs behind ``tests/test_torch_halo.py``.

Run as ``python tests/torch_halo_worker.py RANK WORLD PORT OUT_DIR``: the
rank joins a gloo process group of ``WORLD`` ranks on ``127.0.0.1:PORT``,
runs the halo exchange's cases for that world size on the CPU and writes
what it computed to ``OUT_DIR/rankR.pt`` (numpy arrays, numbers and error
messages), which the tests compare with JAX's single-device
``forward_full_graph`` and with the port's single-device trainer and
serving engine. It imports torch and the port only, never JAX; the graph,
weights and cotangents come from the seeds here, which the tests use too.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_parallel_worker import _error, _model, _params  # noqa: E402

torch.set_num_threads(1)

# tests/test_halo.py's graph, with locality so that the orders differ.
HALO_GRAPH = dict(num_nodes=300, num_edges=1500, num_feats=16, num_classes=4, seed=9,
                  homophily=0.8)
HUB = 12  # the hub threshold of the hub cases (about 30 of the 300 nodes)
# Model keywords of each exchange case; every one runs on every plan.
MODELS = {
    "mean": dict(hidden_dims=(8, 8)),
    "maxpool": dict(hidden_dims=(8, 8), aggregator="maxpool", pool_dim=8, concat_self=True),
    "concat_self": dict(hidden_dims=(8,), concat_self=True),
    "self_loop": dict(hidden_dims=(8, 8), self_loop=True),
    "bf16": dict(hidden_dims=(8, 8), compute_dtype=torch.bfloat16),
}
# The plans of each world size (build_node_partition keywords). S = 3 runs
# per-offset rounds, where a wrong inverse permutation shows (at S = 2 offset
# 1 is its own inverse).
PLANS = {
    1: {"global": {}, "hub": dict(hub_threshold=HUB)},
    2: {"chunks3": dict(halo_chunks=3), "per_offset_hub": dict(sizing="per_offset",
                                                               hub_threshold=HUB),
        "bfs": dict(order="bfs")},
    3: {"per_offset": dict(sizing="per_offset"), "global_hub": dict(hub_threshold=HUB),
        "lpa": dict(order="lpa", sizing="per_offset")},
}
TRAIN = dict(num_steps=3, learning_rate=0.5, test_size=40, val_size=40, log_every=0)
SERVE_REQUEST = 40  # node ids of the serving case


def cotangent(num_nodes: int, num_classes: int) -> np.ndarray:
    """``W``: each case differentiates ``sum(logits * W)``."""
    return np.random.default_rng(5).normal(size=(num_nodes, num_classes)).astype(np.float32)


def model_seed(name: str) -> int:
    return 20 + list(MODELS).index(name)


def exchange_cases(rank: int, world: int) -> dict:
    """Per plan and model: the all-gathered logits ``[N, C]``, and the
    gradients of ``sum(logits * W)``: the parameters' (summed over the
    ranks) and this rank's feature rows' (stacked order)."""
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel import collectives
    from graphsage_torch.parallel.halo import build_node_partition, halo_full_graph_logits
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **HALO_GRAPH)
    mesh = make_mesh({"graph": world})
    group = mesh.get_group("graph")
    w = torch.from_numpy(cotangent(graph.num_nodes, graph.num_classes))
    out = {}
    for plan_name, plan_kw in PLANS[world].items():
        part = build_node_partition(graph, world, **plan_kw)
        shard = part.local(rank, "cpu")
        # The cotangent's rows of this rank's nodes, in stacked order.
        w_local = torch.zeros((part.nodes_per_shard, graph.num_classes))
        mine = np.flatnonzero(part.stacked_index // part.nodes_per_shard == rank)
        w_local[part.stacked_index[mine] - rank * part.nodes_per_shard] = w[mine]
        rec = {"comm_stats": part.comm_stats(), "stacked_index": part.stacked_index,
               "nodes_per_shard": part.nodes_per_shard}
        for name, kw in MODELS.items():
            model = _model(graph, seed=model_seed(name), fanouts=(None,) * len(kw["hidden_dims"]),
                           **kw)
            h0 = shard.h0.clone().requires_grad_(True)
            with torch.no_grad():
                logits = halo_full_graph_logits(model, part, mesh, shard=shard)
            local = halo_full_graph_logits(model, part, mesh, h0=h0, stacked=True, shard=shard)
            (local * w_local).sum().backward()
            grads = {}
            for n, p in model.named_parameters():
                grads[n] = collectives.all_reduce(p.grad, group).numpy()
            rec[name] = {"logits": logits.numpy(), "grads": grads, "h0_grad": h0.grad.numpy()}
        out[plan_name] = rec
    return out


def caller_cases(rank: int, world: int, out_dir: Path) -> dict:
    """``FullGraphTrainer(mesh=)`` (the default ``order="auto"`` plan) and
    the single-device trainer, 3 steps each; a resume from the state after
    2; the checkpoint's writer; ``ServingEngine(mesh=)`` against the
    single-device table tier (f32 and int8 tables) and its memory_stats;
    the errors."""
    from graphsage_torch import FullGraphTrainer, ServingEngine, TrainConfig
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.halo import build_node_partition, halo_full_graph_logits
    from graphsage_torch.parallel.mesh import make_mesh

    graph = power_law_graph(device="cpu", **HALO_GRAPH)
    mesh = make_mesh({"graph": world})
    cfg = TrainConfig(**TRAIN)
    out = {}
    for name in ("mean", "maxpool"):
        kw = dict(MODELS[name], fanouts=(None, None))
        halo = FullGraphTrainer(_model(graph, seed=model_seed(name), **kw), graph, cfg, mesh)
        res = halo.run(log=None)
        single = FullGraphTrainer(_model(graph, seed=model_seed(name), **kw), graph, cfg)
        want = single.run(log=None)
        out[f"train {name}"] = {
            "losses": res["losses"], "single_losses": want["losses"],
            "params": _params(halo.model), "single_params": _params(single.model),
            "val": res["val_micro_f1"], "single_val": want["val_micro_f1"],
            "predict": halo.predict(np.arange(graph.num_nodes)),
            "single_predict": single.predict(np.arange(graph.num_nodes))}
    kw = dict(MODELS["mean"], fanouts=(None, None))
    part = build_node_partition(graph, world, sizing="per_offset")
    first = FullGraphTrainer(_model(graph, seed=1, **kw), graph,
                             TrainConfig(**dict(TRAIN, num_steps=2)), mesh, partition=part)
    first.run(log=None)
    written = first.write_checkpoint(str(out_dir / "halo_ck"))
    resumed = FullGraphTrainer(_model(graph, seed=2, **kw), graph,
                               TrainConfig(**dict(TRAIN, num_steps=1)), mesh, partition=part)
    straight = FullGraphTrainer(_model(graph, seed=1, **kw), graph, cfg, mesh, partition=part)
    out["resume"] = {
        "written": written,
        "resumed": resumed.run(log=None, initial_state=first.state_dict())["losses"],
        "straight": straight.run(log=None)["losses"]}

    ids = np.random.default_rng(3).integers(0, graph.num_nodes, SERVE_REQUEST)
    for quantize in (False, True):
        model = _model(graph, seed=7, **kw)
        sharded = ServingEngine(model, graph, device="cpu", mesh=mesh, quantize_table=quantize,
                                batch_buckets=(16, 32))
        single = ServingEngine(model, graph, device="cpu", quantize_table=quantize,
                               batch_buckets=(16, 32))
        out[f"serve quantize={quantize}"] = {
            "logits": sharded.logits(ids), "single_logits": single.logits(ids),
            "embed": sharded.embed(ids), "single_embed": single.embed(ids),
            "predict": sharded.predict(ids), "single_predict": single.predict(ids),
            "memory_stats": sharded.memory_stats(),
            "single_memory_stats": single.memory_stats()}

    lstm = _model(graph, hidden_dims=(8,), fanouts=(None,), aggregator="lstm")
    mean = _model(graph, **kw)
    out["errors"] = {
        "logits lstm": _error(lambda: halo_full_graph_logits(lstm, part, mesh)),
        "trainer lstm": _error(lambda: FullGraphTrainer(lstm, graph, cfg, mesh)),
        "serve sampled": _error(lambda: ServingEngine(mean, graph, mode="sampled",
                                                      device="cpu", mesh=mesh)),
    }
    return out


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from graphsage_torch.parallel import multihost

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    multihost.initialize(device="cpu")
    out = Path(out_dir)
    rec = {"exchange": exchange_cases(rank, world), "callers": caller_cases(rank, world, out)}
    torch.save(rec, out / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
