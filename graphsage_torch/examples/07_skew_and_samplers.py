"""Levers for skewed graphs: windowed sampling + the hub cache.

    python -m graphsage_torch.examples.07_skew_and_samplers [--device cpu]

Power-law graphs stress two different walls:

* deep-hop SAMPLING pays one CSR fetch per sampled slot —
  ``GraphSAGE(sampling="windowed")`` cuts it to one fetch per PARENT
  (unbiased for the mean aggregation);
* the compact sharded gather's per-pair buckets overflow on hub-skewed
  request lists — ``hub_cache_rows`` replicates the top-degree rows
  (frozen table, so exact forever) so those requests never route.

This example trains the same graph three ways and prints the final losses
and the hub cache's planning numbers.
"""

import sys

import graphsage_torch as gt
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.examples._common import parse_args
from graphsage_torch.parallel import multihost


def main(argv=None):
    args = parse_args(argv, steps=30)
    g = power_law_graph(num_nodes=5000, num_edges=50000, num_feats=32, num_classes=8,
                        seed=0, homophily=0.8, device="cpu")
    cfg = gt.TrainConfig(batch_size=64, num_steps=args.steps, log_every=0,
                         learning_rate=0.5, eval_fanouts=(5, 5))

    # 1) Exact floyd vs windowed sampling, one device.
    for sampling in ("floyd", "windowed"):
        model = gt.GraphSAGE(in_dim=32, num_classes=8, hidden_dims=(32, 32), fanouts=(5, 5),
                             sampling=sampling, device=args.device)
        res = gt.Trainer(model, g.to(args.device), cfg).run(log=None)
        print(f"{sampling:9s}: final loss {res['losses'][-1]:.4f}  "
              f"val micro-F1 {res['val_micro_f1']:.3f}")

    # 2) Node-sharded compact exchange with the frozen hub cache. The
    # coverage fraction says how many requests the cache absorbs; its real
    # job is removing the heavy-tail head from the worst per-pair bucket so
    # capacity_slack can stay small.
    s = multihost.initialize(device=args.device)["process_count"]
    frac = gt.hub_request_fraction(g.degrees, 64)
    print(f"hub cache: top-64 rows cover {frac:.1%} of expected requests")
    model = gt.GraphSAGE(in_dim=32, num_classes=8, hidden_dims=(32, 32), fanouts=(5, 5),
                         device=multihost.device())
    trainer = gt.ShardedFeatureTrainer(model, g, cfg, gt.make_mesh({"data": s}),
                                       gather_mode="compact", hub_cache_rows=64)
    res = trainer.run(log=None)
    stats = trainer.memory_stats()
    print(f"sharded+hub over {s} device(s): final loss "
          f"{res['losses'][-1]:.4f}  val micro-F1 {res['val_micro_f1']:.3f}  "
          f"(hub bytes/chip {stats['hub_cache_bytes_per_chip']})")


if __name__ == "__main__":
    main(sys.argv[1:])
