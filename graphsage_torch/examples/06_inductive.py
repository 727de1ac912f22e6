"""Inductive inference: apply trained parameters to nodes that did not
exist at training time — the GraphSAGE paper's headline capability.

    python -m graphsage_torch.examples.06_inductive [--device cpu]

Parameters are graph-independent (the forward takes the graph as an
argument), so the deploy loop for a growing graph is: train on today's
graph, serve tomorrow's. The reference cannot express this — its layers
bind the adjacency at construction.
"""

import sys

import numpy as np

import graphsage_torch as gt
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.examples._common import parse_args
from graphsage_torch.utils.metrics import micro_f1


def main(argv=None):
    args = parse_args(argv, steps=120)
    full = power_law_graph(num_nodes=600, num_edges=2400, num_feats=48, num_classes=5,
                           seed=4, homophily=0.9, device=args.device)
    n_seen = 420  # the last 180 nodes "arrive after training"
    today = gt.induced_subgraph(full, np.arange(n_seen))

    model = gt.GraphSAGE(in_dim=48, num_classes=5, hidden_dims=(32, 32), fanouts=(5, 5),
                         device=args.device)
    trainer = gt.Trainer(model, today, gt.TrainConfig(batch_size=64, num_steps=args.steps,
                                                      test_size=60, val_size=60,
                                                      log_every=0))
    batches = trainer.batches()
    for _ in range(args.steps):
        trainer.step(next(batches))

    # Tomorrow: the same parameters, the GROWN graph, the new nodes.
    engine = gt.ServingEngine(model, full, mode="table", batch_buckets=(256,),
                              device=args.device)
    new_nodes = np.arange(n_seen, full.num_nodes)
    preds = engine.predict(new_nodes)
    f1 = micro_f1(full.labels.cpu().numpy()[new_nodes], preds)
    print(f"micro-F1 on {len(new_nodes)} nodes the model never saw: {f1:.3f} "
          f"(chance 0.200)")
    return f1


if __name__ == "__main__":
    main(sys.argv[1:])
