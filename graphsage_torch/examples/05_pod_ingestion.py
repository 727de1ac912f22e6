"""Lazy ingestion: no process ever materializes the full feature table.

    python -m graphsage_torch.examples.05_pod_ingestion [--device cpu]
    torchrun --nproc-per-node=4 -m graphsage_torch.examples.05_pod_ingestion

load_cora_lazy records byte offsets instead of parsing feature columns (the
graph's feature leaf is a zero-strided descriptor); shard_features_from_loader
asks the row loader only for the rows THIS rank owns (the native C++ range
parser when it builds). With S ranks each parses N/S rows.
"""

import sys

import graphsage_torch as gt
from graphsage_torch.examples._common import cora_root, parse_args
from graphsage_torch.parallel import multihost


def main(argv=None):
    args = parse_args(argv, steps=10, data_root=True)
    graph, row_loader = gt.load_cora_lazy(cora_root(args.data_root))
    print(f"graph: {graph.num_nodes} nodes; feature leaf is a descriptor "
          f"(strides {graph.features.stride()})")

    info = multihost.initialize(device=args.device)
    s, rank = info["process_count"], info["process_index"]
    mesh = gt.make_mesh({"data": s})
    store = gt.shard_features_from_loader(row_loader, graph.num_nodes, graph.num_features,
                                          s, rank, device=multihost.device())
    model = gt.GraphSAGE(in_dim=graph.num_features, num_classes=graph.num_classes,
                         hidden_dims=(64, 64), fanouts=(5, 5), device=multihost.device())
    cfg = gt.TrainConfig(batch_size=8 * s, num_steps=args.steps, log_every=5,
                         eval_fanouts=(5, 5))
    trainer = gt.ShardedFeatureTrainer(model, graph, cfg, mesh, feature_store=store)
    result = trainer.run()
    print(f"val F1: {result['val_micro_f1']:.4f}  "
          f"(feature bytes/chip: {trainer.memory_stats()['feature_bytes_per_chip']})")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
