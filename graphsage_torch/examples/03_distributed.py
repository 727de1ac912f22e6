"""Distributed training over ``torch.distributed``.

    python -m graphsage_torch.examples.03_distributed [--device cpu]
    torchrun --nproc-per-node=4 -m graphsage_torch.examples.03_distributed

One process per device (NCCL on cards, gloo on the CPU); without torchrun
it is a world of one. Of the three sampled tiers (ShardedTrainer: data
parallel, optionally tensor parallel; ShardedFeatureTrainer: the
node-sharded feature table, N/S*F per device), this runs the third,
FullyShardedTrainer: adjacency, features and batch all sharded.
"""

import sys

import numpy as np

import graphsage_torch as gt
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.examples._common import parse_args
from graphsage_torch.parallel import multihost


def main(argv=None):
    args = parse_args(argv, steps=20)
    s = multihost.initialize(device=args.device)["process_count"]
    mesh = gt.make_mesh({"data": s})
    # A CPU graph: each rank cuts its N/S rows from it, and no device ever
    # holds the full table.
    graph = power_law_graph(num_nodes=2048, num_edges=8192, num_feats=64, num_classes=7,
                            seed=0, homophily=0.8, device="cpu")
    model = gt.GraphSAGE(in_dim=64, num_classes=7, hidden_dims=(64, 64), fanouts=(5, 5),
                         device=multihost.device())
    cfg = gt.TrainConfig(batch_size=32 * s, num_steps=args.steps, log_every=5,
                         eval_fanouts=(5, 5))
    trainer = gt.FullyShardedTrainer(model, graph, cfg, mesh, capacity_slack=4.0)
    result = trainer.run()
    stats = trainer.memory_stats()
    print(f"devices: {s}  val F1: {result['val_micro_f1']:.4f}")
    print(f"feature bytes/chip: {stats['feature_bytes_per_chip']} "
          f"(replicated would be {stats['feature_bytes_replicated']})")
    assert np.isfinite(result["losses"]).all()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
