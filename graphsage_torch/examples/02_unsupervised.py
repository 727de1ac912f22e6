"""Unsupervised GraphSAGE: the paper's graph-context loss + linear probe.

    python -m graphsage_torch.examples.02_unsupervised [--steps 60] [--device cpu]

Random-walk positive pairs, degree^0.75 negatives, L2-normalized
embeddings; labels only ever reach the probe (never the gradient).
The reference trains supervised-only — this is the paper's other mode.
"""

import sys

import graphsage_torch as gt
from graphsage_torch.examples._common import cora_root, parse_args


def main(argv=None):
    args = parse_args(argv, steps=60, data_root=True)
    graph = gt.load_cora(cora_root(args.data_root), device=args.device)
    model = gt.GraphSAGE(
        in_dim=graph.num_features, num_classes=graph.num_classes,
        hidden_dims=(128, 128), fanouts=(10, 10),
        final_activation="linear",  # required: see GraphSAGE's docstring
        device=args.device,
    )
    trainer = gt.UnsupervisedTrainer(
        model, graph,
        gt.TrainConfig(objective="unsupervised", optimizer="adam", learning_rate=0.01,
                       num_steps=args.steps, batch_size=256, walk_length=3,
                       num_negatives=10, log_every=10),
    )
    result = trainer.run()
    print(f"linear-probe validation micro-F1: {result['val_micro_f1']:.4f}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
