"""The port's training slice against the JAX package on the CPU: loss and
parameter gradients on the same frontier and parameters, the optimizers'
updates, splits and batches array for array, the metrics, the trainer on
synthetic Cora (the bar of ``tests/test_train_e2e.py``) and the CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphsage_tpu.data.synthetic import synthetic_cora_graph as jax_synthetic_cora
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.train.config import TrainConfig as JaxTrainConfig
from graphsage_tpu.train.trainer import Trainer as JaxTrainer
from graphsage_tpu.train.trainer import make_optimizer as jax_make_optimizer
from graphsage_tpu.train.trainer import reference_splits as jax_reference_splits
from graphsage_tpu.utils.metrics import macro_f1 as jax_macro_f1
from graphsage_tpu.utils.metrics import micro_f1 as jax_micro_f1
from graphsage_torch import GraphSAGE, Trainer, load_cora, params_from_numpy
from graphsage_torch.data.synthetic import synthetic_cora_graph
from graphsage_torch.models.graphsage import Frontier
from graphsage_torch.train import TrainConfig, make_optimizer, reference_splits
from graphsage_torch.train.experiments import load_dataset, main, run_cora
from graphsage_torch.utils.metrics import accuracy, macro_f1, micro_f1

torch.set_num_threads(1)

# f32 products and sums in other orders; JAX at matmul_precision="highest".
TOL = dict(rtol=1e-4, atol=1e-5)
MODES = {
    "shipped": {},
    "concat_self": dict(concat_self=True),
    "self_loop": dict(self_loop=True),
}
GRAPH = dict(num_nodes=160, num_feats=40, num_edges=420, num_classes=4, seed=4)


@pytest.fixture(scope="module")
def graphs():
    return jax_synthetic_cora(**GRAPH), synthetic_cora_graph(device="cpu", **GRAPH)


def _tree(params) -> dict:
    return {"layers": [{"weight": np.asarray(p.weight)} for p in params.layers],
            "head": np.asarray(params.head)}


def _models(mode="shipped", project_first="auto"):
    common = dict(hidden_dims=(16, 12), fanouts=(4, 3), project_first=project_first,
                  **MODES[mode])
    jm = JaxGraphSAGE(in_dim=GRAPH["num_feats"], num_classes=GRAPH["num_classes"],
                      matmul_precision="highest", gather_impl="take", **common)
    params = jm.init(jax.random.PRNGKey(3))
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], device="cpu", **common)
    params_from_numpy(tm, _tree(params))
    return jm, params, tm


def _frontier(jm, jg, batch=30):
    fr = jm.sample(jax.random.PRNGKey(9), jg, jnp.arange(0, 3 * batch, 3, dtype=jnp.int32))
    return fr, Frontier(ids=tuple(torch.from_numpy(np.array(i)) for i in fr.ids),
                        masks=tuple(torch.from_numpy(np.array(m)) for m in fr.masks))


def _port_grads(tm) -> dict:
    return _tree_of(lambda p: p.grad, tm)


def _tree_of(get, tm) -> dict:
    return {"layers": [{"weight": get(layer.weight).numpy()} for layer in tm.layers],
            "head": get(tm.head).numpy()}


def _assert_trees_close(got: dict, want: dict):
    for g, w in zip(got["layers"], want["layers"]):
        np.testing.assert_allclose(g["weight"], w["weight"], **TOL)
    np.testing.assert_allclose(got["head"], want["head"], **TOL)


@pytest.mark.parametrize("project_first", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_loss_and_gradients_match_jax_on_jax_frontier(graphs, mode, project_first):
    jg, tg = graphs
    jm, params, tm = _models(mode, project_first)
    jfr, tfr = _frontier(jm, jg)
    labels = jnp.take(jg.labels, jfr.ids[0])
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jm.loss(p, jg.features, jfr, labels))(params)
    loss = tm.loss(tg.features, tfr, tg.labels[tfr.ids[0].long()])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    _assert_trees_close(_port_grads(tm), _tree(want_grads))


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_optimizer_steps_match_optax(graphs, optimizer):
    """Two steps on one frontier from fresh optimizer state (SGD: one)."""
    jg, tg = graphs
    jm, params, tm = _models()
    jfr, tfr = _frontier(jm, jg)
    labels = jnp.take(jg.labels, jfr.ids[0])
    lr = 0.7 if optimizer == "sgd" else 0.05
    jcfg = JaxTrainConfig(optimizer=optimizer, learning_rate=lr)
    tx = jax_make_optimizer(jcfg)
    opt_state = tx.init(params)
    opt = make_optimizer(tm.parameters(), TrainConfig(optimizer=optimizer, learning_rate=lr))
    for _ in range(1 if optimizer == "sgd" else 2):
        grads = jax.grad(lambda p: jm.loss(p, jg.features, jfr, labels))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad(set_to_none=True)
        tm.loss(tg.features, tfr, tg.labels[tfr.ids[0].long()]).backward()
        opt.step()
    _assert_trees_close(_tree_of(lambda p: p.detach(), tm), _tree(params))
    with pytest.raises(ValueError):
        make_optimizer(tm.parameters(), TrainConfig(optimizer="rmsprop"))


def test_classification_loss_matches_jax(graphs):
    jm, _, tm = _models()
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(13, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, 13).astype(np.int32)
    want = jm.classification_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tm.classification_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.shape == (13,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_and_embed_on_the_ports_own_frontier(graphs):
    _, tg = graphs
    _, _, tm = _models()
    seeds = torch.arange(0, 60, 2, dtype=torch.int32)
    with torch.no_grad():
        logits = tm.apply_sampled(torch.Generator().manual_seed(1), tg, seeds)
        emb = tm.embed(torch.Generator().manual_seed(1), tg, seeds)
        fr = tm.sample(torch.Generator().manual_seed(1), tg, seeds)
        torch.testing.assert_close(logits, tm(tg.features, fr))
        torch.testing.assert_close(emb, tm(tg.features, fr, return_embeddings=True))
    assert logits.shape == (30, 4) and emb.shape == (30, 12)


def test_module_apply_is_nn_modules():
    # ``apply(fn)`` keeps its torch meaning: fn on every submodule.
    _, _, tm = _models()
    seen = []
    assert tm.apply(seen.append) is tm
    assert seen[-1] is tm and all(any(s is l for s in seen) for l in tm.layers)


@pytest.mark.parametrize("seed", [1, 7])
def test_reference_splits_equal_jax(seed):
    for got, want in zip(reference_splits(2708, seed), jax_reference_splits(2708, seed)):
        np.testing.assert_array_equal(got, want)
    test, val, train = reference_splits(300, seed, test_size=50, val_size=30)
    assert (len(test), len(val), len(train)) == (50, 30, 220)


@pytest.mark.parametrize("start_step", [0, 5])
@pytest.mark.parametrize("batching", ["epoch", "reference"])
def test_batches_equal_jax_trainer(graphs, batching, start_step):
    jg, tg = graphs
    jm, _, tm = _models()
    kw = dict(batch_size=32, test_size=40, val_size=20, batching=batching, seed=3)
    jt = JaxTrainer(jm, jg, JaxTrainConfig(**kw))
    tt = Trainer(tm, tg, TrainConfig(**kw))
    for a, b in zip((tt.test_nodes, tt.val_nodes, tt.train_nodes),
                    (jt.test_nodes, jt.val_nodes, jt.train_nodes)):
        np.testing.assert_array_equal(a, b)
    got, want = tt.batches(start_step), jt.batches(start_step)
    for _ in range(9):  # 100 train nodes, 4 batches per epoch: wraps twice
        a, b = next(got), next(want)
        assert a.dtype == np.int32 and a.shape == (32,)
        np.testing.assert_array_equal(a, b)


def test_metrics_equal_jax():
    rng = np.random.default_rng(0)
    y, p = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
    assert micro_f1(y, p) == jax_micro_f1(y, p) == accuracy(y, p)
    assert macro_f1(y, p, 5) == jax_macro_f1(y, p, 5)
    assert macro_f1(y, p) == jax_macro_f1(y, p)
    ym, pm = rng.random((50, 6)) < 0.3, rng.random((50, 6)) < 0.3
    assert micro_f1(ym, pm) == jax_micro_f1(ym, pm)
    assert macro_f1(ym, pm) == jax_macro_f1(ym, pm)
    assert accuracy([], []) == 0.0


def test_trainer_learns_synthetic_cora(synth_cora_root):
    """The JAX test's configuration and bar (tests/test_train_e2e.py)."""
    graph = load_cora(synth_cora_root, device="cpu")
    model = GraphSAGE(graph.num_features, graph.num_classes, hidden_dims=(32, 32),
                      fanouts=(5, 5), device="cpu")
    cfg = TrainConfig(batch_size=64, num_steps=30, learning_rate=0.5,
                      test_size=100, val_size=80, log_every=0)
    result = Trainer(model, graph, cfg).run(log=None)
    losses = result["losses"]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, f"loss did not decrease: {losses[0]} -> {losses[-1]}"
    assert result["val_micro_f1"] > 0.5, result["val_micro_f1"]
    assert 0.0 <= result["val_macro_f1"] <= 1.0
    assert len(result["step_times"]) == 30 and result["mean_step_time"] > 0


def test_trainer_sampled_evaluation_is_seeded(graphs):
    _, tg = graphs
    _, _, tm = _models()
    tr = Trainer(tm, tg, TrainConfig(batch_size=16, test_size=40, val_size=20,
                                     eval_fanouts=(3, 2)))
    tr.step(next(tr.batches()))
    np.testing.assert_array_equal(tr.predict(tr.val_nodes), tr.predict(tr.val_nodes))
    full = Trainer(tm, tg, TrainConfig(test_size=40, val_size=20))
    with torch.no_grad():
        want = tm.forward_full_graph(tg).argmax(-1).numpy()[full.val_nodes]
    np.testing.assert_array_equal(full.predict(full.val_nodes), want)


def test_trainer_rejects_what_is_not_ported(graphs):
    _, tg = graphs
    _, _, tm = _models()
    with pytest.raises(ValueError, match="empty train split"):
        Trainer(tm, tg, TrainConfig(test_size=100, val_size=60))
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        Trainer(tm, tg, TrainConfig(objective="unsupervised"))
    tr = Trainer(tm, tg, TrainConfig(test_size=40, val_size=20))
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tr.run(log=None, checkpoint_path="ckpt")
    with pytest.raises(ValueError):
        next(Trainer(tm, tg, TrainConfig(test_size=40, val_size=20,
                                         batching="nope")).batches())


def test_cli_trains_and_prints_the_reference_lines(synth_cora_root, capsys):
    main(["--preset", "cora", "--data-root", str(synth_cora_root), "--device", "cpu",
          "--steps", "3", "--test-size", "100", "--val-size", "80"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines[:3]] == ["0", "1", "2"]
    assert all(np.isfinite(float(ln.split()[1])) for ln in lines[:3])
    assert lines[3].startswith("Validation F1: ")
    assert lines[4].startswith("Average batch time: ")


def test_run_cora_quiet(synth_cora_root, capsys):
    result = run_cora(str(synth_cora_root), device="cpu", log=None,
                      overrides={"num_steps": 2, "test_size": 100, "val_size": 80})
    assert capsys.readouterr().out == ""
    assert len(result["losses"]) == 2 and isinstance(result["trainer"], Trainer)


@pytest.mark.parametrize("argv,match", [
    (["--checkpoint", "ckpt"], "Queue 1 item 12"),
    (["--layer0", "full"], "Queue 1 item 6"),
    (["--debug-nans"], "not ported"),
    (["--mode", "full-graph"], "Queue 1 item 10"),
])
def test_cli_rejects_what_is_not_ported(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        main(["--device", "cpu", *argv])


def test_load_dataset_names():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        load_dataset("reddit")
    with pytest.raises(ValueError):
        load_dataset("citeseer")
