"""Inductive subgraphs and the run utilities of the port, on the CPU.

``induced_subgraph`` is held to the JAX package's array for array (f32,
bf16 and int8 tables); the inductive protocol of ``tests/test_inductive.py``
(train on the subgraph of the first 70% of nodes, evaluate the same model
on the held-out 30% of the full graph) runs through the port with that
file's bars. The utilities (``utils/profiling.py``: its trace and the span
recorder's file; ``utils/memory.py``) are held to their CPU contract.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data.graph import induced_subgraph as jax_induced_subgraph
from graphsage_tpu.data.graph import quantize_graph as jax_quantize_graph
from graphsage_tpu.data.synthetic import power_law_graph as jax_power_law_graph
from graphsage_torch import (
    GraphSAGE,
    ServingEngine,
    Trainer,
    TrainConfig,
    UnsupervisedTrainer,
    induced_subgraph,
    quantize_graph,
)
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.models.unsupervised import linear_probe_predict
from graphsage_torch.utils import memory, profiling
from graphsage_torch.utils.metrics import micro_f1

torch.set_num_threads(1)

FIELDS = ("neighbors", "degrees", "indptr", "edge_dst", "edge_src", "edge_mask", "labels")


@pytest.mark.parametrize("table", ["f32", "bf16", "int8"])
def test_induced_subgraph_equals_jax(table):
    kw = dict(num_nodes=300, num_edges=1500, num_feats=12, num_classes=4, seed=2)
    if table == "bf16":
        tg = power_law_graph(feature_dtype=torch.bfloat16, device="cpu", **kw)
        jg = jax_power_law_graph(feature_dtype=jnp.bfloat16, **kw)
    else:
        tg, jg = power_law_graph(device="cpu", **kw), jax_power_law_graph(**kw)
    if table == "int8":
        tg, jg = quantize_graph(tg), jax_quantize_graph(jg)
    nodes = np.random.default_rng(0).permutation(300)[:170]  # relabeled in this order
    got, want = induced_subgraph(tg, nodes), jax_induced_subgraph(jg, nodes)
    assert got.device == torch.device("cpu") and got.features.dtype == torch.float32
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.features.numpy(), np.asarray(want.features))
    for f in ("num_nodes", "num_edges", "max_degree", "ell_covers_all", "symmetric",
              "num_classes"):
        assert getattr(got, f) == getattr(want, f), f
    assert 0 < got.num_edges < tg.num_edges and got.symmetric


# ---------------------------------------------------------------- protocol
@pytest.fixture(scope="module")
def setup():
    """``tests/test_inductive.py``'s setup: a 600-node homophilous
    power-law graph, trained on the subgraph of its first 420 nodes."""
    full = power_law_graph(num_nodes=600, num_edges=2400, num_feats=48, num_classes=5,
                           seed=4, homophily=0.9, device="cpu")
    n_train = 420
    train_graph = induced_subgraph(full, np.arange(n_train))
    model = GraphSAGE(48, 5, (32, 32), (5, 5), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    cfg = TrainConfig(batch_size=64, num_steps=120, learning_rate=0.5, test_size=60,
                      val_size=60, log_every=0)
    Trainer(model, train_graph, cfg).run(log=None)
    return full, model, n_train


def test_inductive_unseen_nodes_beat_chance(setup):
    full, model, n_train = setup
    unseen = np.arange(n_train, full.num_nodes)
    truth = full.labels.numpy()
    with torch.no_grad():
        preds = model.forward_full_graph(full).argmax(-1).numpy()
        s_preds = model.apply_sampled(torch.Generator().manual_seed(0), full,
                                      torch.from_numpy(unseen.astype(np.int32)))
    assert micro_f1(truth[:n_train], preds[:n_train]) > 0.9
    assert micro_f1(truth[unseen], preds[unseen]) > 0.75  # chance = 0.2
    assert micro_f1(truth[unseen], s_preds.argmax(-1).numpy()) > 0.7


def test_inductive_serving_engine_on_the_grown_graph(setup):
    full, model, n_train = setup
    eng = ServingEngine(model, full, batch_buckets=(256,), device="cpu")
    unseen = np.arange(n_train, full.num_nodes)
    assert micro_f1(full.labels.numpy()[unseen], eng.predict(unseen)) > 0.75


def test_unsupervised_embeddings_transfer(setup):
    full, _, n_train = setup
    train_graph = induced_subgraph(full, np.arange(n_train))
    model = GraphSAGE(48, 5, (32, 32), (5, 5), final_activation="linear", device="cpu",
                      generator=torch.Generator().manual_seed(0))
    cfg = TrainConfig(batch_size=64, num_steps=150, optimizer="adam", learning_rate=0.01,
                      objective="unsupervised", walk_length=3, num_negatives=8,
                      test_size=60, val_size=60, log_every=0)
    UnsupervisedTrainer(model, train_graph, cfg).run(log=None)
    with torch.no_grad():
        emb = model.embed_full_graph(full)
    emb = emb / (emb.norm(dim=-1, keepdim=True) + 1e-8)
    truth = full.labels
    preds = linear_probe_predict(emb[:n_train], truth[:n_train], emb[n_train:], 5)
    assert micro_f1(truth[n_train:].numpy(), preds.numpy()) > 0.6  # chance = 0.2


# --------------------------------------------------------------- utilities
def test_profiling_trace_and_span_export(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    profiling.reset()
    profiling.enable()
    try:
        with profiling.span("outer"):
            profiling.count("rows", 8)
        written = profiling.export(str(tmp_path / "spans.json"))
    finally:
        profiling.disable()
        profiling.reset()
    with open(tmp_path / "spans.json") as f:
        assert json.load(f) == written
    names = [e["name"] for e in written["traceEvents"]]
    assert names[-2:] == ["outer", "rows"] and "import.graphsage_torch" in names


def test_memory_accounting_refuses_the_cpu():
    for fn in (memory.live_device_bytes, memory.max_live_buffer_bytes):
        with pytest.raises(ValueError, match="CPU"):
            fn(device="cpu")
    with pytest.raises(ValueError, match="CPU"):
        memory.assert_no_buffer_at_least(1, device="cpu")
