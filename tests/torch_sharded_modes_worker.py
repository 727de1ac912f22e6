"""One rank of the multi-process jobs behind ``tests/test_torch_sharded_modes.py``.

Run as ``python tests/torch_sharded_modes_worker.py JOB RANK WORLD PORT
OUT_DIR``: the rank joins a gloo process group of ``WORLD`` ranks on
``127.0.0.1:PORT``, runs the checks of job ``JOB`` (``"two"``: the
node-sharded ``layer0="full"`` modes, the fully sharded ``full`` trainer, the
int8 store, resume and multilabel; ``"four"``: ``ShardedTrainer`` on a
``{"data": 2, "model": 2}`` mesh) on the CPU and writes what it computed to
``OUT_DIR/rankR.pt``, which the tests compare with JAX's results and with the
port's single-device trainer. It imports torch and the port only, never JAX;
graphs, weights and batches come from the seeds here and in
``tests/torch_parallel_worker.py``.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_parallel_worker import _model, _params, _steps  # noqa: E402

torch.set_num_threads(1)

# tests/test_layer0_full.py's graph and training settings.
GRAPH = dict(num_nodes=300, num_edges=1200, num_feats=24, num_classes=5, seed=2,
             homophily=0.8)
TRAIN = dict(batch_size=32, num_steps=3, learning_rate=0.5, test_size=60, val_size=60,
             log_every=0)
COVER = (None, None)  # every neighbour: deterministic frontiers, JAX's too
FULL = dict(hidden_dims=(8, 8), layer0="full")
MAXPOOL = dict(aggregator="maxpool", pool_dim=8, self_loop=True)
# tests/test_layer0_full.py's sharded modes: (model keywords, trainer keywords).
FULL_CASES = {
    "dense": ({}, dict(gather_mode="dense")),
    "compact": ({}, dict(gather_mode="compact")),
    "maxpool": (MAXPOOL, dict(gather_mode="compact")),
    "halo": ({}, dict(gather_mode="dense", layer0_exchange="halo")),
    "halo_maxpool": (MAXPOOL, dict(gather_mode="compact", layer0_exchange="halo")),
    "halo_hub": ({}, dict(gather_mode="compact", layer0_exchange="halo",
                          layer0_halo_kwargs={"sizing": "per_offset", "hub_threshold": 8})),
}
# tests/test_quantize.py's int8 twins: a 32-feature graph quantized up front.
INT8_GRAPH = dict(GRAPH, num_feats=32)
INT8_MODEL = dict(hidden_dims=(16, 16), fanouts=(4, 4))
INT8_TRAIN = dict(TRAIN, eval_fanouts=(8, 8))
INT8_SLACK = 8.0
HUB_ROWS = 8
# ShardedTrainer on {"data": 2, "model": 2}: model keywords (fanouts 4, 4
# against the single-device Trainer, and at COVER against JAX's; "int8*"
# on the int8 graph against its dense twin).
TP_CASES = {
    "full": dict(FULL),
    "full_mean_first": dict(hidden_dims=(32, 8), layer0="full", concat_self=True,
                            self_loop=False),
    "full_maxpool": dict(FULL, aggregator="maxpool", pool_dim=8, concat_self=True),
    "lstm": dict(hidden_dims=(8, 8), aggregator="lstm", pool_dim=8, concat_self=True),
    "int8": dict(INT8_MODEL),
    "int8_full": dict(FULL),
}
RESUME_STEPS = 3
PPI = dict(num_graphs=2, num_nodes=150, num_feats=50, num_classes=12, seed=0)


def graph():
    from graphsage_torch.data.synthetic import power_law_graph

    return power_law_graph(device="cpu", **GRAPH)


def int8_graphs():
    """``(int8 graph, dense twin)``: the twin's features are the int8
    table's values, so the two train on the same numbers."""
    from graphsage_torch import quantize_graph
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.ops.quantize import dequantize

    quant = quantize_graph(power_law_graph(device="cpu", **INT8_GRAPH))
    return quant, dataclasses.replace(quant, features=dequantize(quant.features))


def _record(trainer, steps: int) -> dict:
    return {"losses": _steps(trainer, steps), "params": _params(trainer.model)}


def full_cases(mesh) -> dict:
    """Each mode at COVER (against JAX's single-device trainer) and at
    fanouts (4, 4) (against the port's); the fully sharded ``full`` trainer
    at COVER, its predictions against the node-sharded trainer's."""
    from graphsage_torch import FullyShardedTrainer, ShardedFeatureTrainer, TrainConfig, Trainer

    g = graph()
    cfg = TrainConfig(**TRAIN)
    out, single = {}, {}
    for name, (model_kw, kw) in FULL_CASES.items():
        rec = {}
        for fanouts in (COVER, (4, 4)):
            mk = dict(FULL, fanouts=fanouts, **model_kw)
            rec[fanouts] = _record(ShardedFeatureTrainer(_model(g, **mk), g, cfg, mesh, **kw),
                                   cfg.num_steps)
            key = (tuple(sorted(model_kw)), fanouts)
            if key not in single:
                single[key] = _record(Trainer(_model(g, **mk), g, cfg), cfg.num_steps)
            rec[("single", fanouts)] = single[key]
        out[name] = rec
    ecfg = TrainConfig(**TRAIN, eval_fanouts=COVER)
    fully = FullyShardedTrainer(_model(g, **FULL, fanouts=COVER), g, ecfg, mesh,
                                capacity_slack=INT8_SLACK)
    node = ShardedFeatureTrainer(_model(g, **FULL, fanouts=COVER), g, ecfg, mesh)
    out["fully"] = dict(_record(fully, cfg.num_steps),
                        node=_record(node, cfg.num_steps),
                        preds=fully.predict(np.arange(48)), node_preds=node.predict(np.arange(48)),
                        memory_stats={k: v for k, v in fully.memory_stats().items()
                                      if not k.startswith("measured")})
    mk = dict(FULL, fanouts=COVER, **MAXPOOL)
    out["fully_maxpool"] = _record(FullyShardedTrainer(_model(g, **mk), g, cfg, mesh,
                                                       capacity_slack=INT8_SLACK),
                                   cfg.num_steps)
    return out


def int8_cases(mesh) -> dict:
    """The int8 store against its dense twin: the dense and compact
    exchanges and the fully sharded trainer (losses and predictions); the
    compact exchange with the hub cache against it without; the cached
    layer 0 over an int8 cache against the single device's."""
    from graphsage_torch import FullyShardedTrainer, ShardedFeatureTrainer, TrainConfig, Trainer

    quant, twin = int8_graphs()
    cfg = TrainConfig(**INT8_TRAIN)
    out = {}
    for name, cls, kw in (("dense", ShardedFeatureTrainer, dict(gather_mode="dense")),
                          ("compact", ShardedFeatureTrainer, dict(gather_mode="compact")),
                          ("fully", FullyShardedTrainer, {})):
        rec = {}
        for label, g in (("int8", quant), ("twin", twin)):
            tr = cls(_model(g, **INT8_MODEL), g, cfg, mesh, capacity_slack=INT8_SLACK, **kw)
            rec[label] = dict(_record(tr, cfg.num_steps), preds=tr.predict(np.arange(32)))
        rec["shard_dtype"] = str(tr.features.shard.dtype)
        out[name] = rec
    hub = ShardedFeatureTrainer(_model(quant, **INT8_MODEL), quant, cfg, mesh,
                                gather_mode="compact", capacity_slack=INT8_SLACK,
                                hub_cache_rows=HUB_ROWS)
    out["hub"] = dict(_record(hub, cfg.num_steps),
                      hub_bytes=hub.memory_stats()["hub_cache_bytes_per_chip"])
    mk = dict(INT8_MODEL, layer0="cached")
    cached = ShardedFeatureTrainer(_model(quant, **mk), quant, cfg, mesh, gather_mode="compact")
    out["cached"] = dict(_record(cached, cfg.num_steps),
                         single=_record(Trainer(_model(quant, **mk), quant, cfg), cfg.num_steps),
                         cache_quantized=type(cached._cache_store.shard).__name__)
    out["memory_stats"] = {k: v for k, v in cached.memory_stats().items()
                           if not k.startswith("measured")}
    return out


def resume_cases(mesh, out_dir: Path) -> dict:
    """``RESUME_STEPS`` steps, a checkpoint (rank 0 writes it), a fresh
    trainer restored from it and ``RESUME_STEPS`` more, against ``2 *
    RESUME_STEPS`` steps straight."""
    from graphsage_torch import FullyShardedTrainer, ShardedFeatureTrainer, TrainConfig
    from graphsage_torch.utils.checkpoint import restore_checkpoint

    g = graph()
    mk = dict(hidden_dims=(8, 8), fanouts=(4, 4))
    out = {}
    for name, cls, kw in (("sharded", ShardedFeatureTrainer, dict(gather_mode="compact")),
                          ("fully", FullyShardedTrainer, {})):
        def make(n, cls=cls, kw=kw):
            return cls(_model(g, **mk), g, TrainConfig(**{**TRAIN, "num_steps": n}), mesh, **kw)

        straight = make(2 * RESUME_STEPS)
        want = straight.run(log=None)["losses"]
        path = out_dir / f"ck_{name}"
        head = make(RESUME_STEPS).run(log=None, checkpoint_path=path,
                                      checkpoint_every=RESUME_STEPS)["losses"]
        second = make(RESUME_STEPS)
        state = restore_checkpoint(path, second.state_dict())
        tail = second.run(log=None, initial_state=state)["losses"]
        out[name] = dict(straight=want, resumed=head + tail, step=int(state["step"]),
                         params=_params(second.model), straight_params=_params(straight.model))
    return out


def multilabel_case(mesh) -> dict:
    """A multilabel model on the union of two ``synthetic_ppi_graphs``,
    node-sharded (compact) against the single device."""
    from graphsage_torch import GraphSAGE, ShardedFeatureTrainer, TrainConfig, Trainer
    from graphsage_torch import params_from_numpy
    from graphsage_torch.data.graph import disjoint_union
    from graphsage_torch.data.synthetic import synthetic_ppi_graphs
    from torch_parallel_worker import draw_params

    g = disjoint_union(synthetic_ppi_graphs(device="cpu", **PPI), device="cpu")
    cfg = TrainConfig(**{**TRAIN, "learning_rate": 0.05})

    def model():
        m = GraphSAGE(g.num_features, PPI["num_classes"], hidden_dims=(16, 16), fanouts=(4, 4),
                      multilabel=True, concat_self=True, device="cpu")
        return params_from_numpy(m, draw_params(m, 0))

    sharded = ShardedFeatureTrainer(model(), g, cfg, mesh, gather_mode="compact")
    single = Trainer(model(), g, cfg)
    return dict(_record(sharded, cfg.num_steps), single=_record(single, cfg.num_steps),
                val=sharded.evaluate(sharded.val_nodes)["micro_f1"],
                single_val=single.evaluate(single.val_nodes)["micro_f1"])


def tp_cases(mesh) -> dict:
    """``ShardedTrainer`` on ``{"data": 2, "model": 2}``: each case at
    fanouts (4, 4) with the single-device Trainer's run beside it, and at
    COVER (against JAX's, or the int8 cases against their dense twin)."""
    from graphsage_torch import ShardedTrainer, TrainConfig, Trainer

    g = graph()
    quant = int8_graphs()
    cfg = TrainConfig(**TRAIN)
    out = {}
    for name, kw in TP_CASES.items():
        graphs = {"": g} if not name.startswith("int8") else {"": quant[0], "twin": quant[1]}
        rec = {}
        for label, gr in graphs.items():
            for fanouts in ((4, 4), COVER):
                mk = dict(kw, fanouts=fanouts)
                tr = ShardedTrainer(_model(gr, **mk), gr, cfg, mesh)
                rec[(label, fanouts)] = _record(tr, cfg.num_steps)
            rec[(label, "single")] = _record(Trainer(_model(gr, **dict(kw, fanouts=(4, 4))), gr,
                                                     cfg), cfg.num_steps)
        rec["feature_cols"] = int(tr.graph.features.shape[1])
        out[name] = rec
    return out


def main(job: str, rank: int, world: int, port: int, out_dir: str) -> None:
    from graphsage_torch.parallel import multihost
    from graphsage_torch.parallel.mesh import make_mesh

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    if job == "two":
        mesh = make_mesh({"data": world})
        res = {"full": full_cases(mesh), "int8": int8_cases(mesh),
               "resume": resume_cases(mesh, Path(out_dir)), "multilabel": multilabel_case(mesh)}
    else:
        res = {"tp": tp_cases(make_mesh({"data": 2, "model": world // 2}))}
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
