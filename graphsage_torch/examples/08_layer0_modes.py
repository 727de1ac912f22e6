"""The three layer-0 modes: sampled, full, cached — and when each wins.

    python -m graphsage_torch.examples.08_layer0_modes [--device cpu]

Layer 0 is the only layer that reads the raw feature table, and the table
is FROZEN (reference model.py:70-71) — that one fact opens three exact-or-
better formulations of the same model:

* ``layer0="sampled"`` (default) — the reference's estimator: gather
  ``B·∏fanouts`` sampled rows every step. Unbiased, pays the deepest hop.
* ``layer0="full"``    — run layer 0 once per step over ALL nodes (one
  CSR pass), upper layers gather from the ``[N, d0]`` table. The
  reference's ``set.union`` dedup semantics; wins when ``E < B·∏k``.
* ``layer0="cached"``  — the mean aggregator is linear and the table
  frozen, so the full-neighborhood aggregate ``D⁻¹AX`` is a per-node
  CONSTANT: ``with_cached_layer0(graph)`` builds it once and every step
  just gathers hop-(L−1) rows from it. The deepest sampling hop, its
  gather and its backward scatter vanish.

All three train the same function class; full/cached compute the sampled
estimator's exact expectation at the input-closest layer (the reference's
own ``num_sample=None`` mode, quirk Q7). This example trains one graph all
three ways and prints losses, val F1, and the per-step work each pays.
"""

import sys
import time

import graphsage_torch as gt
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.examples._common import parse_args


def main(argv=None):
    args = parse_args(argv, steps=40)
    g = power_law_graph(num_nodes=5000, num_edges=50000, num_feats=32, num_classes=8,
                        seed=0, homophily=0.8, device=args.device)
    cfg = gt.TrainConfig(batch_size=256, num_steps=args.steps, log_every=0,
                         learning_rate=0.5, eval_fanouts=(5, 5))

    t0 = time.time()
    gc = gt.with_cached_layer0(g)
    build = time.time() - t0
    b_prod_k = 256 * 5 * 5

    for mode, graph in (("sampled", g), ("full", g), ("cached", gc)):
        model = gt.GraphSAGE(in_dim=32, num_classes=8, hidden_dims=(32, 32), fanouts=(5, 5),
                             layer0=mode, device=args.device)
        res = gt.Trainer(model, graph, cfg).run(log=None)
        per_step = {
            "sampled": f"{b_prod_k} sampled rows gathered + scattered",
            "full": f"{g.num_edges} edge slots aggregated (E vs B·∏k={b_prod_k})",
            "cached": f"{256 * 5} cache rows gathered (deepest hop gone)",
        }[mode]
        print(f"layer0={mode:8s}: final loss {res['losses'][-1]:.4f}  "
              f"val micro-F1 {res['val_micro_f1']:.3f}  — {per_step}")

    print(f"cache build (once, amortized): {build*1e3:.0f} ms for "
          f"[{gc.layer0_cache.shape[0]}, {gc.layer0_cache.shape[1]}] "
          f"{gc.layer0_cache.dtype}")
    print("rule of thumb: sampled when E >> B*prod(k); full when E < B*prod(k); "
          "cached whenever the extra [N, F] residency fits")


if __name__ == "__main__":
    main(sys.argv[1:])
