"""The port's layer-0 modes against the JAX package on the CPU.

``layer0="full"`` runs layer 0 once over every node per step (the CSR
mean-SpMM, or the per-edge segment max for maxpool) and gathers its rows;
``layer0="cached"`` gathers a precomputed full-neighborhood feature mean
(``with_cached_layer0``). Pinned here: the cache in both flavors against
the JAX host build (isolated nodes included), its flavor checks, logits,
loss and parameter gradients of ``full`` and ``cached`` models on a JAX
``Frontier``, and the invariants of ``tests/test_mode_matrix.py`` and
``tests/test_layer0_cached.py`` (sampled with complete neighborhoods ==
full-graph; cached == full at any fanout, gradients included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphsage_torch.ops.spmm as sp
from graphsage_tpu.data.graph import with_cached_layer0 as jax_with_cached_layer0
from graphsage_tpu.data.graph import build_graph as jax_build_graph
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_torch import GraphSAGE, Trainer, TrainConfig, params_from_numpy
from graphsage_torch.convert import LAYER_FIELDS
from graphsage_torch.data.graph import build_graph, with_cached_layer0
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.models.graphsage import Frontier

torch.set_num_threads(1)

# f32 products and sums in other orders; JAX at matmul_precision="highest".
TOL = dict(rtol=1e-4, atol=1e-5)
MODES = {
    "shipped": {},
    "concat_self": dict(concat_self=True),
    "self_loop": dict(self_loop=True),
}
# Power-law degrees (a few hubs); the fixture appends isolated nodes.
GRAPH = dict(num_nodes=90, num_edges=260, num_feats=24, num_classes=4, seed=9)
CASES = [("mean", "full"), ("maxpool", "full"), ("mean", "cached")]


@pytest.fixture(scope="module")
def graphs():
    """A power-law graph with six isolated nodes appended, built by both
    packages from the same arrays."""
    base = power_law_graph(device="cpu", **GRAPH)
    e, extra = base.num_edges, 6
    edges = np.stack([base.edge_src[:e].numpy(), base.edge_dst[:e].numpy()], axis=1)
    rng = np.random.default_rng(1)
    feats = np.concatenate([base.features.numpy(),
                            rng.normal(size=(extra, GRAPH["num_feats"]))]).astype(np.float32)
    labels = np.concatenate([base.labels.numpy(), rng.integers(0, 4, extra)])
    jg = jax_build_graph(feats, labels, edges, num_classes=GRAPH["num_classes"])
    tg = build_graph(feats, labels, edges, num_classes=GRAPH["num_classes"], device="cpu")
    assert int((tg.degrees == 0).sum()) == extra
    return jg, tg


@pytest.fixture(scope="module")
def frontiers(graphs):
    """One JAX frontier per combine mode, one hop short (``full`` and
    ``cached`` do not sample the deepest hop), seeds ``0, 2, ..., 58``."""
    jg, _ = graphs
    seeds = jnp.arange(0, 60, 2, dtype=jnp.int32)
    out = {}
    for mode, kw in MODES.items():
        jm = JaxGraphSAGE(in_dim=GRAPH["num_feats"], num_classes=GRAPH["num_classes"],
                          hidden_dims=(16, 12), fanouts=(4, 3), layer0="full", **kw)
        out[mode] = jax.jit(jm.sample)(jax.random.PRNGKey(1), jg, seeds)
    return out


def to_frontier(fr) -> Frontier:
    return Frontier(ids=tuple(torch.from_numpy(np.array(i)) for i in fr.ids),
                    masks=tuple(torch.from_numpy(np.array(m)) for m in fr.masks))


def models(aggregator, layer0, mode, fanouts=(4, 3)):
    """The JAX model and the port's, with the same parameters drawn from a
    numpy seed and carried into the port by ``params_from_numpy``."""
    common = dict(hidden_dims=(16, 12), fanouts=fanouts, aggregator=aggregator,
                  pool_dim=10, layer0=layer0, **MODES[mode])
    jm = JaxGraphSAGE(in_dim=GRAPH["num_feats"], num_classes=GRAPH["num_classes"],
                      matmul_precision="highest", gather_impl="take", **common)
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


# -------------------------------------------------------------------- cache
@pytest.mark.parametrize("self_loop", [False, True])
def test_cache_matches_jax_host_build(graphs, self_loop):
    jg, tg = graphs
    host = jg if jg.on_host else jg.to_host()
    want = np.asarray(jax_with_cached_layer0(host, self_loop=self_loop).layer0_cache)
    before = sp.launches
    got = with_cached_layer0(tg, self_loop=self_loop)
    assert sp.launches == before  # a CPU graph takes the plain SpMM
    assert got.layer0_cache.dtype == torch.float32
    assert got.layer0_cache_self_loop is self_loop
    np.testing.assert_allclose(got.layer0_cache.numpy(), want, rtol=1e-5, atol=1e-6)
    isolated = (tg.degrees == 0).numpy()
    want_isolated = tg.features.numpy()[isolated] if self_loop else 0.0
    np.testing.assert_array_equal(got.layer0_cache.numpy()[isolated], want_isolated)
    assert with_cached_layer0(got, self_loop=self_loop) is got  # idempotent
    with pytest.raises(ValueError, match="flavors"):
        with_cached_layer0(got, self_loop=not self_loop)
    moved = got.to("cpu")
    assert torch.equal(moved.layer0_cache, got.layer0_cache)
    assert moved.layer0_cache_self_loop is self_loop


@pytest.mark.parametrize("self_loop", [False, True])
def test_cache_quantized_is_not_ported(graphs, self_loop):
    """``quantize=True``: an int8 cache, the JAX build's to one int8 step (the
    f32 sums round apart), idempotent; a dense cache asked for int8 raises."""
    jg, tg = graphs
    want = jax_with_cached_layer0(jg, self_loop=self_loop, quantize=True).layer0_cache
    got = with_cached_layer0(tg, self_loop=self_loop, quantize=True)
    cache = got.layer0_cache
    assert cache.q.dtype == torch.int8 and cache.scale.shape == (tg.num_nodes, 1)
    assert np.abs(cache.q.numpy().astype(int) - np.asarray(want.q).astype(int)).max() <= 1
    np.testing.assert_allclose(cache.scale.numpy(), np.asarray(want.scale), rtol=1e-5)
    assert with_cached_layer0(got, self_loop=self_loop, quantize=True) is got
    with pytest.raises(ValueError, match="quantize=False"):
        with_cached_layer0(got, self_loop=self_loop)
    dense = with_cached_layer0(tg, self_loop=self_loop)
    with pytest.raises(ValueError, match="dense layer0_cache"):
        with_cached_layer0(dense, self_loop=self_loop, quantize=True)


# ------------------------------------------------------------------- models
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("aggregator,layer0", CASES)
def test_loss_and_gradients_match_jax_on_jax_frontier(graphs, frontiers, aggregator,
                                                      layer0, mode):
    jg, tg = graphs
    self_loop = mode == "self_loop"
    if layer0 == "cached":
        jg = jax_with_cached_layer0(jg, self_loop=self_loop)
        tg = with_cached_layer0(tg, self_loop=self_loop)
    jm, params, tm = models(aggregator, layer0, mode)
    jfr = frontiers[mode]
    labels = jnp.take(jg.labels, jfr.ids[0])

    def loss_and_logits(p):
        logits = jm.forward(p, jg.features, jfr, graph=jg)
        return jm.classification_loss(logits, labels).mean(), logits

    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(loss_and_logits, has_aux=True))(params)
    tfr = to_frontier(jfr)
    labels_t = tg.labels[tfr.ids[0].long()]
    logits = tm(tg.features, tfr, graph=tg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    loss = tm.loss(tg.features, tfr, labels_t, graph=tg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for layer, w in zip(tm.layers, want_grads.layers):
        for name, p in layer.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(getattr(w, name)),
                                       err_msg=name, **TOL)
    np.testing.assert_allclose(tm.head.grad.numpy(), np.asarray(want_grads.head), **TOL)


def test_full_mean_layer0_runs_through_the_spmm_function(graphs):
    _, tg = graphs
    _, _, tm = models("mean", "full", "shipped")
    table = tm.layer0_full_table(tg.features, tg)
    assert table.shape == (tg.num_nodes, 16)
    names, fn = [], table.grad_fn
    while fn is not None:  # walk the graph's first inputs down to the SpMM
        names.append(fn.name())
        fn = fn.next_functions[0][0] if fn.next_functions else None
    assert any("SpmmMean" in n for n in names), names


@pytest.mark.parametrize("mode", list(MODES))
def test_cached_equals_full_at_any_fanout_with_gradients(graphs, mode):
    """The cache is the mean that ``full`` recomputes per step: equal
    logits and parameter gradients on one frontier."""
    _, tg = graphs
    _, _, full = models("mean", "full", mode)
    cached = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (16, 12), (4, 3),
                       layer0="cached", device="cpu", **MODES[mode])
    cached.load_state_dict(full.state_dict())
    gc = with_cached_layer0(tg, self_loop=mode == "self_loop")
    seeds = torch.arange(0, 80, 3, dtype=torch.int32)
    fr = full.sample(torch.Generator().manual_seed(4), tg, seeds)
    labels = tg.labels[seeds.long()]
    lf = full.loss(tg.features, fr, labels, graph=tg)
    lc = cached.loss(gc.features, fr, labels, graph=gc)
    lf.backward()
    lc.backward()
    torch.testing.assert_close(lc, lf, rtol=1e-5, atol=1e-6)
    for (name, a), b in zip(cached.named_parameters(), full.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-6, msg=name)


MATRIX = [("mean", "full", m) for m in MODES] + [
    ("maxpool", "full", "shipped"), ("maxpool", "full", "self_loop")] + [
    ("mean", "cached", m) for m in MODES]


@pytest.mark.parametrize("aggregator,layer0,mode", MATRIX)
def test_sampled_no_fanout_equals_full_graph(graphs, aggregator, layer0, mode):
    """With complete neighborhoods (``fanout=None``) the sampled forward of
    a ``full`` or ``cached`` model is the deterministic full-graph forward
    (``tests/test_mode_matrix.py``'s invariant), embeddings included."""
    _, tg = graphs
    if layer0 == "cached":
        tg = with_cached_layer0(tg, self_loop=mode == "self_loop")
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (16, 16), (None, None),
                   aggregator=aggregator, pool_dim=12, layer0=layer0, device="cpu",
                   **MODES[mode])
    seeds = torch.arange(tg.num_nodes, dtype=torch.int32)
    with torch.no_grad():
        fr = tm.sample(torch.Generator().manual_seed(12), tg, seeds)
        assert fr.num_hops == 1
        torch.testing.assert_close(tm(tg.features, fr, graph=tg),
                                   tm.forward_full_graph(tg), **TOL)
        torch.testing.assert_close(tm.embed(torch.Generator(), tg, seeds),
                                   tm.embed_full_graph(tg), **TOL)


def test_mode_checks():
    with pytest.raises(ValueError, match="mean and maxpool"):
        GraphSAGE(8, 2, (4, 4), (2, 2), aggregator="lstm", layer0="full", device="cpu")
    with pytest.raises(ValueError, match="requires the mean"):
        GraphSAGE(8, 2, (4, 4), (2, 2), aggregator="maxpool", layer0="cached",
                  device="cpu")
    with pytest.raises(ValueError, match="unknown layer0"):
        GraphSAGE(8, 2, (4, 4), (2, 2), layer0="half", device="cpu")


def test_forward_without_the_graph_raises(graphs):
    _, tg = graphs
    for layer0, match in (("full", "CSR adjacency"), ("cached", "with_cached_layer0")):
        tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (8, 8), (3, 3),
                       layer0=layer0, device="cpu")
        fr = tm.sample(torch.Generator(), tg, torch.arange(4, dtype=torch.int32))
        with pytest.raises(ValueError, match=match):
            tm(tg.features, fr)
        if layer0 == "cached":  # a graph without the cache
            with pytest.raises(ValueError, match="with_cached_layer0"):
                tm(tg.features, fr, graph=tg)


# ------------------------------------------------------------------ trainer
def test_trainer_builds_the_cache_and_trains(graphs):
    _, tg = graphs
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (16, 16), (4, 4),
                   layer0="cached", self_loop=True, device="cpu")
    cfg = TrainConfig(batch_size=16, num_steps=4, learning_rate=0.5, test_size=20,
                      val_size=20, log_every=0, eval_fanouts=(4, 4))
    tr = Trainer(tm, tg, cfg)
    assert tg.layer0_cache is None and tr.graph.layer0_cache is not None
    assert tr.graph.layer0_cache_self_loop
    want = with_cached_layer0(tg, self_loop=True).layer0_cache
    torch.testing.assert_close(tr.graph.layer0_cache, want, rtol=0, atol=0)
    result = tr.run(log=None)
    assert np.isfinite(result["losses"]).all()
    assert 0.0 <= result["val_micro_f1"] <= 1.0


def test_trainer_rejects_a_cache_of_the_wrong_flavor(graphs):
    """Checked at construction, with ``forward``'s message."""
    _, tg = graphs
    gc = with_cached_layer0(tg, self_loop=True)
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (8, 8), (3, 3),
                   layer0="cached", device="cpu")
    cfg = TrainConfig(batch_size=8, test_size=20, val_size=20)
    with pytest.raises(ValueError, match="rebuild the cache") as at_init:
        Trainer(tm, gc, cfg)
    fr = tm.sample(torch.Generator(), gc, torch.arange(4, dtype=torch.int32))
    with pytest.raises(ValueError) as in_forward:
        tm(gc.features, fr, graph=gc)
    assert str(at_init.value) == str(in_forward.value)
    # The right flavor is taken as it is.
    ok = Trainer(tm, with_cached_layer0(tg), cfg)
    assert not ok.graph.layer0_cache_self_loop
