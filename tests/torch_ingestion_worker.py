"""One rank of the multi-process job behind ``tests/test_torch_ingestion.py``.

Run as ``python tests/torch_ingestion_worker.py RANK WORLD PORT OUT_DIR
CORA_ROOT``: the rank joins a gloo process group of ``WORLD`` ranks on
``127.0.0.1:PORT``, loads ``CORA_ROOT`` lazily, builds its node-sharded store
through ``shard_features_from_loader`` with a loader that records every range
it is asked for, trains ``ShardedFeatureTrainer(feature_store=)`` for a few
steps in each case of :data:`CASES`, and writes the calls, the losses and
the predictions to ``OUT_DIR/rankR.pt``. It imports torch and the port only.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

MODEL = dict(hidden_dims=(16, 16), fanouts=(5, 5))
TRAIN = dict(batch_size=32, num_steps=3, learning_rate=0.5, log_every=0, eval_fanouts=(5, 5),
             test_size=100, val_size=80)
# Trainer keywords and whether the store is int8, per case.
CASES = {"dense": (dict(), False), "compact_int8": (dict(gather_mode="compact"), True)}


def run_cases(graph, row_loader, mesh, rank: int, world: int) -> dict:
    """Per case: the loader's calls, the losses of ``num_steps`` steps and
    the validation predictions."""
    from graphsage_torch import GraphSAGE, ShardedFeatureTrainer, TrainConfig
    from graphsage_torch.parallel.feature_store import shard_features_from_loader

    out = {}
    for name, (kw, quantize) in CASES.items():
        calls = []

        def loader(lo, hi):
            calls.append((lo, hi))
            return row_loader(lo, hi)

        store = shard_features_from_loader(loader, graph.num_nodes, graph.num_features, world,
                                           rank, device="cpu", quantize=quantize)
        model = GraphSAGE(graph.num_features, graph.num_classes, device="cpu",
                          generator=torch.Generator().manual_seed(3), **MODEL)
        tr = ShardedFeatureTrainer(model, graph, TrainConfig(**TRAIN), mesh,
                                   feature_store=store, **kw)
        batches = tr.batches()
        losses = [float(tr.step(next(batches))) for _ in range(TRAIN["num_steps"])]
        out[name] = {"calls": calls, "losses": np.asarray(losses),
                     "predict": tr.predict(tr.val_nodes)}
    return out


def main(rank: int, world: int, port: int, out_dir: str, cora_root: str) -> None:
    from graphsage_torch.data.loaders import load_cora_lazy
    from graphsage_torch.parallel import multihost
    from graphsage_torch.parallel.mesh import make_mesh

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    graph, row_loader = load_cora_lazy(cora_root)
    res = run_cases(graph, row_loader, make_mesh({"data": world}), rank, world)
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
