"""Request serving: the table tier.

    python -m graphsage_torch.examples.04_serving [--device cpu]

Train briefly, stand up a ServingEngine, serve requests. Table mode
refreshes an [N, d_L] embedding table once per parameter update; each
request is one row gather + head matmul (no sampling on the request path).
"""

import sys

import numpy as np

import graphsage_torch as gt
from graphsage_torch.examples._common import cora_root, parse_args


def main(argv=None):
    args = parse_args(argv, steps=40, data_root=True)
    graph = gt.load_cora(cora_root(args.data_root), device=args.device)
    model = gt.GraphSAGE(in_dim=graph.num_features, num_classes=graph.num_classes,
                         hidden_dims=(128, 128), fanouts=(10, 10), device=args.device)
    trainer = gt.Trainer(model, graph, gt.TrainConfig(num_steps=args.steps, log_every=0))
    batches = trainer.batches()
    for _ in range(args.steps):
        trainer.step(next(batches))

    engine = gt.ServingEngine(model, graph, mode="table", batch_buckets=(256,),
                              device=args.device)
    nodes = np.arange(10)
    print("predictions:", engine.predict(nodes))
    print("embedding shape:", engine.embed(nodes).shape)
    # New parameters? One refresh call re-embeds the graph.
    engine.refresh(model.state_dict())
    return engine


if __name__ == "__main__":
    main(sys.argv[1:])
