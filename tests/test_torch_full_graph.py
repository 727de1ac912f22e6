"""The port's full-batch training against the JAX package on the CPU: the
port's full-graph SpMM against JAX's degree-bucketed pass (forward and
gradient), ``FullGraphTrainer`` on kernel 3's route (five steps from the
same parameters give the loss trajectory of JAX's trainer, whose SpMM is
the bucketed pass on a symmetric graph: full-batch training samples
nothing, so the whole path is deterministic), and ``mode="full-graph"``
through ``run_preset`` and the CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphsage_torch.ops.spmm as sp
from graphsage_tpu.data.graph import build_graph as jax_build_graph
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_tpu.ops.bucketed_spmm import make_spmm_mean_bucketed as jax_make_bucketed
from graphsage_tpu.ops.bucketed_spmm import plan_bucketed_spmm as jax_plan
from graphsage_tpu.train.config import TrainConfig as JaxTrainConfig
from graphsage_tpu.train.full_graph import FullGraphTrainer as JaxFullGraphTrainer
from graphsage_torch import FullGraphTrainer, GraphSAGE, TrainConfig, params_from_numpy
from graphsage_torch.convert import LAYER_FIELDS
from graphsage_torch.data.graph import build_graph
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.train.experiments import main, run_preset
from graphsage_torch.utils.metrics import macro_f1, micro_f1

torch.set_num_threads(1)

# Power-law degrees (hubs above the small hub caps below); the fixture
# appends isolated nodes.
GRAPH = dict(num_nodes=160, num_edges=900, num_feats=24, num_classes=4, seed=3)
ISOLATED = 4


def _edges_and_payload():
    base = power_law_graph(device="cpu", **GRAPH)
    e = base.num_edges
    edges = np.stack([base.edge_src[:e].numpy(), base.edge_dst[:e].numpy()], axis=1)
    rng = np.random.default_rng(2)
    feats = np.concatenate([base.features.numpy(),
                            rng.normal(size=(ISOLATED, GRAPH["num_feats"]))]).astype(np.float32)
    labels = np.concatenate([base.labels.numpy(), rng.integers(0, 4, ISOLATED)])
    return edges, feats, labels


@pytest.fixture(scope="module")
def graphs():
    """``{"symmetric": (jax, torch), "directed": (jax, torch)}``: the same
    arrays in both packages; the directed graph keeps only ``u < v``."""
    edges, feats, labels = _edges_and_payload()
    out = {}
    for name, e, undirected in (("symmetric", edges, True),
                                ("directed", edges[edges[:, 0] < edges[:, 1]], False)):
        kw = dict(num_classes=GRAPH["num_classes"], undirected=undirected)
        out[name] = (jax_build_graph(feats, labels, e, **kw),
                     build_graph(feats, labels, e, device="cpu", **kw))
    assert out["symmetric"][1].symmetric and not out["directed"][1].symmetric
    return out


# ------------------------------------------------------------ the pass
@pytest.mark.parametrize("hub_cap", [16, 256])
def test_bucketed_forward_and_gradient_equal_jax_and_spmm(graphs, hub_cap):
    """JAX's degree-bucketed pass (its ``"auto"`` full-graph SpMM) against the
    port's full-graph SpMM (kernel 3's plain version on the CPU), forward and
    gradient."""
    jg, tg = graphs["symmetric"]
    rng = np.random.default_rng(hub_cap)
    x = rng.normal(size=(tg.num_nodes, 7)).astype(np.float32)
    w = rng.normal(size=(tg.num_nodes, 7)).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(jax_make_bucketed(jax_plan(jg, hub_cap=hub_cap))),
                        jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(w))
    xs = torch.from_numpy(x).requires_grad_(True)
    out = sp.spmm_mean(xs, tg.indptr, tg.edge_dst)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    assert not out[-ISOLATED:].any()  # isolated rows aggregate to 0


def test_bucketed_bf16_within_a_rounding_of_f32_and_near_jax(graphs):
    """bf16 rows: the port's SpMM sums in f32 and rounds once, so the result
    is the f32 SpMM rounded to bf16, within one bf16 step of 2**-8 of its
    largest entry; JAX sums its ELL buckets in bf16, the port's documented
    bf16 divergence, held at 2e-2 of the largest entry."""
    jg, tg = graphs["symmetric"]
    x32 = np.random.default_rng(5).normal(size=(tg.num_nodes, 9)).astype(np.float32)
    x = torch.from_numpy(x32).to(torch.bfloat16)
    got = sp.spmm_mean(x, tg.indptr, tg.edge_dst)
    assert got.dtype == torch.bfloat16
    want = sp.spmm_mean(x.float(), tg.indptr, tg.edge_dst)
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 2.0**-8 * scale
    jax_out = jax.jit(jax_make_bucketed(jax_plan(jg, hub_cap=16)))(
        jnp.asarray(x32, dtype=jnp.bfloat16))
    diff = np.abs(got.float().numpy() - np.asarray(jax_out, dtype=np.float32))
    assert diff.max() <= 2e-2 * scale


# ----------------------------------------------------------------- trainer
def _models(jax_spmm_impl, **kw):
    """JAX's model, on its ``jax_spmm_impl`` route, and the port's, the
    port's parameters drawn with numpy and carried across."""
    common = dict(hidden_dims=(16, 12), fanouts=(None, None), **kw)
    jm = JaxGraphSAGE(in_dim=GRAPH["num_feats"], num_classes=GRAPH["num_classes"],
                      matmul_precision="highest", spmm_impl=jax_spmm_impl, **common)
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], device="cpu", **common)
    rng = np.random.default_rng(0)

    def draw(p):
        return (rng.normal(size=tuple(p.shape)) * 0.3).astype(np.float32)

    tree = {"layers": [{f: (draw(getattr(layer, f)) if hasattr(layer, f) else None)
                        for f in LAYER_FIELDS} for layer in tm.layers],
            "head": draw(tm.head)}
    params_from_numpy(tm, tree)
    params = SAGEParams(
        layers=tuple(SAGELayerParams(**{f: None if v is None else jnp.asarray(v)
                                        for f, v in p.items()}) for p in tree["layers"]),
        head=jnp.asarray(tree["head"]))
    return jm, params, tm


def _jax_losses(jm, params, jg, cfg, steps):
    tr = JaxFullGraphTrainer(jm, jg, cfg)
    state = tr.init_state()
    state = state.replace(params=params, opt_state=tr.tx.init(params))
    losses = []
    for _ in range(steps):
        state, loss = tr.step(state)
        losses.append(float(loss))
    return losses, tr


# ``spmm_impl`` is JAX's route; the port's is kernel 3's in every case.
@pytest.mark.parametrize("graph,spmm_impl,optimizer,lr,kw", [
    ("symmetric", "auto", "sgd", 0.5, {}),
    ("symmetric", "auto", "adam", 0.01, dict(concat_self=True)),
    ("symmetric", "bucketed_ell", "sgd", 0.5, dict(self_loop=True)),
    ("symmetric", "bucketed_ell", "adam", 0.01, {}),
    # A directed graph: kernel 3's route takes the index_add_ transpose
    # backward (JAX's takes XLA's segment sum).
    ("directed", "auto", "sgd", 0.5, {}),
    ("directed", "auto", "adam", 0.01, dict(concat_self=True)),
])
def test_five_steps_match_jax(graphs, graph, spmm_impl, optimizer, lr, kw):
    jg, tg = graphs[graph]
    jm, params, tm = _models(spmm_impl, **kw)
    cfg = dict(num_steps=5, learning_rate=lr, optimizer=optimizer, test_size=40,
               val_size=30, log_every=0)
    want, jtr = _jax_losses(jm, params, jg, JaxTrainConfig(**cfg), 5)
    tr = FullGraphTrainer(tm, tg, TrainConfig(**cfg))
    np.testing.assert_array_equal(tr.train_nodes, jtr.train_nodes)
    result = tr.run(log=None)
    np.testing.assert_allclose(result["losses"], want, rtol=1e-5)
    assert want[-1] < want[0]


@pytest.mark.parametrize("spmm_impl", ["bucketed_ell", "atuo"])
def test_unknown_spmm_impl_raises(spmm_impl):
    """``spmm_impl`` names a route of ``ops.aggregate.spmm_mean``; the
    degree-bucketed pass is the JAX package's alone."""
    with pytest.raises(ValueError, match=f"unknown spmm_impl '{spmm_impl}'"):
        GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], spmm_impl=spmm_impl, device="cpu")


def test_not_ported_arguments_raise(graphs):
    _, tg = graphs["symmetric"]
    _, _, tm = _models("auto")
    cfg = TrainConfig(num_steps=1, test_size=40, val_size=30, log_every=0)
    # The halo mesh path (tests/test_torch_halo.py) takes mean and maxpool
    # models; an lstm model raises JAX's message before the mesh is read.
    lstm = GraphSAGE(tg.num_features, tg.num_classes, hidden_dims=(8,), fanouts=(None,),
                     aggregator="lstm", device="cpu")
    with pytest.raises(ValueError, match="halo mesh path supports mean and maxpool only"):
        FullGraphTrainer(lstm, tg, cfg, mesh=object())
    tr = FullGraphTrainer(tm, tg, cfg)
    with pytest.raises(ValueError, match="needs checkpoint_path"):
        tr.run(log=None, checkpoint_every=2)
    # Resume: two steps straight equal one, the state carried over, one more.
    kw = dict(test_size=40, val_size=30, log_every=0, optimizer="momentum",
              learning_rate=0.1)
    straight = FullGraphTrainer(_models("auto")[2], tg, TrainConfig(num_steps=2, **kw))
    straight = straight.run(log=None)["losses"]
    cfg1 = TrainConfig(num_steps=1, **kw)
    first = FullGraphTrainer(_models("auto")[2], tg, cfg1)
    head = first.run(log=None)["losses"]
    state = first.state_dict()
    assert int(state["step"]) == 1 and "key" not in state
    second = FullGraphTrainer(_models("auto")[2], tg, cfg1)
    tail = second.run(log=None, initial_state=state)["losses"]
    assert head + tail == straight and second.step_count == 2


def test_evaluate_equals_jax(graphs):
    jg, tg = graphs["symmetric"]
    jm, params, tm = _models("auto")
    cfg = dict(num_steps=1, test_size=40, val_size=30, log_every=0)
    jtr = JaxFullGraphTrainer(jm, jg, JaxTrainConfig(**cfg))
    state = jtr.init_state().replace(params=params)
    nodes = np.arange(tg.num_nodes)
    want = jtr.evaluate(state, nodes)
    got = FullGraphTrainer(tm, tg, TrainConfig(**cfg)).evaluate(nodes)
    assert got == pytest.approx(want, abs=1e-12)


# ------------------------------------------------------- run_preset and CLI
def test_run_preset_full_graph(synth_pubmed_root, capsys):
    result = run_preset("pubmed", str(synth_pubmed_root), device="cpu",
                        mode="full-graph",
                        overrides=dict(num_steps=4, test_size=100, val_size=80, log_every=1))
    tr = result["trainer"]
    assert isinstance(tr, FullGraphTrainer)
    assert tr.model.fanouts == (None, None)
    assert len(result["losses"]) == 4 and np.isfinite(result["losses"]).all()
    assert result["losses"][-1] < result["losses"][0]
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines[:4]] == ["0", "1", "2", "3"]
    assert lines[4].startswith("Validation F1: ")
    assert lines[5].startswith("Average batch time: ")


@pytest.mark.parametrize("preset", ["cora", "cora_pool"])
def test_cli_full_graph(synth_cora_root, capsys, preset):
    main(["--preset", preset, "--mode", "full-graph", "--data-root", str(synth_cora_root),
          "--device", "cpu", "--steps", "3", "--test-size", "100", "--val-size", "80"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines[:3]] == ["0", "1", "2"]
    assert all(np.isfinite(float(ln.split()[1])) for ln in lines[:3])
    assert lines[3].startswith("Validation F1: ")


@pytest.mark.parametrize("aggregator", ["mean", "maxpool", "lstm"])
def test_forward_full_graph_spmm_override(graphs, aggregator):
    """The mean's SpMM is replaced by the override; maxpool ignores it and
    lstm rejects it, as in the JAX package."""
    _, tg = graphs["symmetric"]
    model = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (8,), (None,),
                      aggregator=aggregator, pool_dim=8, device="cpu")
    calls = []

    def override(x):
        calls.append(x.shape)
        return torch.zeros_like(x), tg.degrees

    if aggregator == "lstm":
        with pytest.raises(ValueError, match="mean and maxpool only"):
            model.forward_full_graph(tg, spmm_override=override)
        return
    with torch.no_grad():
        got = model.forward_full_graph(tg, spmm_override=override)
        want = model.forward_full_graph(tg)
    if aggregator == "mean":  # a zero neighbour mean: ReLU(0 @ W) = 0 logits
        assert calls and not got.any() and want.any()
    else:
        assert not calls and torch.equal(got, want)


# ------------------------------------------------ the loss's rows alone
def _weighted_full_loss(tr):
    """The weighted loss over every node from ``forward_full_graph(graph)``,
    the formula the trainer's restricted step must equal."""
    per = tr.model.classification_loss(tr.model.forward_full_graph(tr.graph), tr.graph.labels)
    return (per * tr._train_weight).sum() / tr._train_count


def _loss_and_grads(model, loss_fn):
    loss = loss_fn()
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("hidden", [(16, 12), (12, 16)], ids=["last-projects-first", "last-aggregates-first"])
@pytest.mark.parametrize("self_term", ["none", "concat_self", "self_loop"])
@pytest.mark.parametrize("graph", ["symmetric", "directed"])
@pytest.mark.parametrize("aggregator", ["mean", "maxpool"])
def test_step_over_the_loss_rows_equals_the_weighted_full_loss(graphs, aggregator, graph,
                                                               self_term, hidden):
    """The trainer's last layer and head over the train rows only (a row
    block, and on a symmetric graph its transpose in the backward): the loss
    and every parameter's gradient equal those of the full forward weighted
    by the train mask, bitwise; evaluation and prediction still run every
    row; and a mask zeroed in half after construction (the benchmark's
    ``half_batch`` fault) moves the loss exactly as the full formula does."""
    _, tg = graphs[graph]
    kw = {} if self_term == "none" else {self_term: True}
    model = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], hidden, (None, None),
                      aggregator=aggregator, pool_dim=10, device="cpu",
                      generator=torch.Generator().manual_seed(4), **kw)
    tr = FullGraphTrainer(model, tg, TrainConfig(test_size=40, val_size=30, log_every=0))
    block = tr._rows
    assert block is not None and block.num_rows == len(tr.train_nodes)
    assert (block.transpose is not None) == tg.symmetric
    assert model.use_project_first(1, hidden[0]) == (aggregator == "mean" and hidden == (16, 12))
    got, got_grads = _loss_and_grads(model, tr._loss)
    want, want_grads = _loss_and_grads(model, lambda: _weighted_full_loss(tr))
    assert torch.equal(got, want)
    for (name, _), a, b in zip(model.named_parameters(), got_grads, want_grads):
        assert torch.equal(a, b), name
        assert b.any(), name
    nodes = np.arange(tg.num_nodes)
    with torch.no_grad():
        full = model.predictions(model.forward_full_graph(tg))
    np.testing.assert_array_equal(tr.predict(nodes), full)
    truth = tg.labels.numpy()
    assert tr.evaluate(nodes) == {"micro_f1": micro_f1(truth, full),
                                  "macro_f1": macro_f1(truth, full, tg.num_classes)}
    # The half_batch fault's move: half the train weights zeroed after
    # construction, the count with them.
    w = tr._train_weight
    on = torch.nonzero(w).reshape(-1)
    w[on[: on.numel() // 2]] = 0.0
    tr._train_count = float(w.sum())
    half, half_grads = _loss_and_grads(model, tr._loss)
    want_half, want_half_grads = _loss_and_grads(model, lambda: _weighted_full_loss(tr))
    assert torch.equal(half, want_half) and not torch.equal(half, got)
    for a, b in zip(half_grads, want_half_grads):
        assert torch.equal(a, b)


def test_a_split_of_every_node_keeps_the_full_forward(graphs):
    """No row left out: no block is built and the step is the full path's."""
    _, tg = graphs["symmetric"]
    model = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (8, 8), (None, None),
                      device="cpu")
    tr = FullGraphTrainer(model, tg, TrainConfig(test_size=0, val_size=0, log_every=0))
    assert tr._rows is None
    assert torch.equal(tr._loss(), _weighted_full_loss(tr))
