"""The port's multilabel head against the JAX package on the CPU: sigmoid
BCE over multi-hot labels (loss and parameter gradients on a JAX
``Frontier``), predictions thresholded at 0, and the inductive PPI protocol
of ``tests/test_multilabel.py`` (train on a disjoint union of graphs,
evaluate on one never seen) with its bars, sampled and full-graph, and
through ``ServingEngine``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data.synthetic import synthetic_ppi_graphs as jax_ppi
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_torch import (
    FullGraphTrainer,
    GraphSAGE,
    ServingEngine,
    Trainer,
    TrainConfig,
    disjoint_union,
    params_from_numpy,
)
from graphsage_torch.convert import LAYER_FIELDS
from graphsage_torch.data.synthetic import synthetic_ppi_graphs
from graphsage_torch.models.graphsage import Frontier
from graphsage_torch.utils.metrics import micro_f1

torch.set_num_threads(1)

C = 24  # labels per node at the test's size


def _ppi(num_graphs=4, num_nodes=400):
    return synthetic_ppi_graphs(num_graphs=num_graphs, num_nodes=num_nodes, num_feats=50,
                                num_classes=C, seed=0, device="cpu")


def _model(**kw):
    kw.setdefault("hidden_dims", (64, 64))
    kw.setdefault("fanouts", (10, 10))
    return GraphSAGE(50, C, multilabel=True, concat_self=True, device="cpu", **kw)


# -------------------------------------------------------------------- loss
def test_loss_and_gradients_equal_jax_on_a_jax_frontier():
    jg = jax_ppi(num_graphs=1, num_nodes=300, num_feats=50, num_classes=C, seed=1)[0]
    tg = synthetic_ppi_graphs(num_graphs=1, num_nodes=300, num_feats=50, num_classes=C,
                              seed=1, device="cpu")[0]
    common = dict(hidden_dims=(16, 12), fanouts=(5, 4), concat_self=True, multilabel=True)
    jm = JaxGraphSAGE(in_dim=50, num_classes=C, matmul_precision="highest",
                      gather_impl="take", **common)
    tm = GraphSAGE(50, C, device="cpu", **common)
    rng = np.random.default_rng(0)
    tree = {"layers": [{f: ((rng.normal(size=tuple(getattr(layer, f).shape)) * 0.3)
                            .astype(np.float32) if hasattr(layer, f) else None)
                        for f in LAYER_FIELDS} for layer in tm.layers],
            "head": (rng.normal(size=tuple(tm.head.shape)) * 0.3).astype(np.float32)}
    params_from_numpy(tm, tree)
    params = SAGEParams(
        layers=tuple(SAGELayerParams(**{f: None if v is None else jnp.asarray(v)
                                        for f, v in p.items()}) for p in tree["layers"]),
        head=jnp.asarray(tree["head"]))
    seeds = jnp.arange(0, 120, 3, dtype=jnp.int32)
    fr = jax.jit(jm.sample)(jax.random.PRNGKey(2), jg, seeds)
    labels = jg.labels[seeds]
    assert labels.shape == (40, C)

    def jax_loss(p):
        return jm.loss(p, jg.features, fr, labels, graph=jg)

    want, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    frontier = Frontier(ids=tuple(torch.from_numpy(np.array(i)) for i in fr.ids),
                        masks=tuple(torch.from_numpy(np.array(m)) for m in fr.masks))
    got = tm.loss(tg.features, frontier, tg.labels[torch.from_numpy(np.array(seeds)).long()],
                  graph=tg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for i, layer in enumerate(tm.layers):
        np.testing.assert_allclose(layer.weight.grad.numpy(),
                                   np.asarray(want_grads.layers[i].weight), atol=1e-6)
    np.testing.assert_allclose(tm.head.grad.numpy(), np.asarray(want_grads.head), atol=1e-6)


def test_loss_matches_hand_bce_and_rejects_1d_labels():
    model = _model()
    z = np.random.default_rng(0).normal(size=(16, C))
    y = (np.random.default_rng(1).random((16, C)) < 0.25).astype(np.int8)
    got = model.classification_loss(torch.from_numpy(z.astype(np.float32)),
                                    torch.from_numpy(y))
    hand = (np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))).mean(axis=-1)
    np.testing.assert_allclose(got.numpy(), hand, rtol=1e-5)
    with pytest.raises(ValueError, match="multi-hot"):
        model.classification_loss(torch.zeros(4, C), torch.zeros(4, dtype=torch.int32))


def test_predictions_threshold_and_argmax():
    logits = np.array([[1.0, -1.0, 0.5], [-2.0, 3.0, -0.1]], np.float32)
    multi = GraphSAGE(50, 3, (8,), (2,), multilabel=True, device="cpu")
    for given in (logits, torch.from_numpy(logits)):
        got = multi.predictions(given)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, [[1, 0, 1], [0, 1, 0]])
    single = GraphSAGE(50, 3, (8,), (2,), device="cpu")
    np.testing.assert_array_equal(single.predictions(logits), [0, 1])


# ------------------------------------------------- training + inductive
def _trivial(truth):
    return max(micro_f1(truth, np.ones_like(truth)), micro_f1(truth, np.zeros_like(truth)))


def test_ppi_inductive_training_beats_trivial_baselines():
    """Trained on the disjoint union of 3 graphs, evaluated on a 4th: the
    bars of the JAX package's test."""
    gs = _ppi()
    train_g, test_g = disjoint_union(gs[:3]), gs[3]
    model = _model()
    cfg = TrainConfig(batch_size=256, num_steps=120, log_every=0, learning_rate=0.01,
                      optimizer="adam", test_size=0, val_size=200)
    losses = Trainer(model, train_g, cfg).run(log=None)["losses"]
    assert losses[-1] < 0.25 * losses[0]
    ev = Trainer(model, test_g, TrainConfig(batch_size=64, num_steps=1, test_size=0,
                                            val_size=64)).evaluate(np.arange(test_g.num_nodes))
    truth = test_g.labels.numpy()
    assert ev["micro_f1"] > _trivial(truth) + 0.2
    assert ev["micro_f1"] > 0.75
    # The table tier serves multi-hot rows equal to the full-graph
    # predictions the evaluation scored (the head's product runs at another
    # batch size there: a logit within 1e-4 of 0 may round either way).
    preds = ServingEngine(model, test_g, device="cpu").predict(np.arange(test_g.num_nodes))
    assert preds.shape == (test_g.num_nodes, C) and preds.dtype == np.int8
    with torch.no_grad():
        logits = model.forward_full_graph(test_g).numpy()
    decided = np.abs(logits) > 1e-4
    np.testing.assert_array_equal(preds[decided], model.predictions(logits)[decided])
    assert (~decided).sum() <= 2


def test_multilabel_full_graph_trainer():
    g = _ppi(num_graphs=1)[0]
    model = _model(fanouts=(None, None))
    cfg = TrainConfig(num_steps=60, log_every=0, learning_rate=0.01, optimizer="adam",
                      test_size=0, val_size=80)
    tr = FullGraphTrainer(model, g, cfg)
    losses = tr.run(log=None)["losses"]
    assert losses[-1] < 0.3 * losses[0]
    assert tr.evaluate(np.arange(g.num_nodes))["micro_f1"] > 0.75


def test_multilabel_sampled_eval_and_serving():
    """``eval_fanouts`` routes prediction through the sampled forward; it
    and the sampled serving tier give multi-hot rows."""
    g = _ppi(num_graphs=2)[0]
    model = _model()
    cfg = TrainConfig(batch_size=128, num_steps=80, log_every=0, learning_rate=0.01,
                      optimizer="adam", test_size=0, val_size=80, eval_fanouts=(10, 10))
    tr = Trainer(model, g, cfg)
    tr.run(log=None)
    preds = tr.predict(np.arange(100))
    assert preds.shape == (100, C)
    assert micro_f1(g.labels.numpy()[:100], preds) > 0.6
    served = ServingEngine(model, g, mode="sampled", device="cpu").predict(np.arange(100))
    assert served.shape == (100, C) and set(np.unique(served)) <= {0, 1}
