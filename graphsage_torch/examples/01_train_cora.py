"""Supervised GraphSAGE on Cora: the reference's run_cora on the port.

    python -m graphsage_torch.examples.01_train_cora [--data-root cora/] [--device cpu]

Without --data-root a full-shape synthetic Cora is generated (the real LINQS
files drop in unchanged). Mirrors reference graphsage/model.py run_cora:
2-layer mean aggregator, fanout 10/10, SGD lr 0.7, 100x256.
"""

import sys

import graphsage_torch as gt
from graphsage_torch.examples._common import cora_root, parse_args


def main(argv=None):
    args = parse_args(argv, steps=100, data_root=True)
    graph = gt.load_cora(cora_root(args.data_root), device=args.device)
    model = gt.GraphSAGE(in_dim=graph.num_features, num_classes=graph.num_classes,
                         hidden_dims=(128, 128), fanouts=(10, 10), device=args.device)
    trainer = gt.Trainer(model, graph,
                         gt.TrainConfig(num_steps=args.steps, batch_size=256, log_every=20))
    result = trainer.run()
    print(f"validation micro-F1: {result['val_micro_f1']:.4f}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
