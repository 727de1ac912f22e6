"""The port's unsupervised objective against the JAX package on the CPU.

Pinned here: the walk and negative-table primitives against JAX's on shared
uniforms (the generators' streams differ), the walks' semantics and first
step statistically, the graph-context loss and every parameter gradient on
a JAX frontier in each layer-0 mode, the linear probe on shared embeddings,
``final_activation="linear"`` on every forward path, and the
``UnsupervisedTrainer`` at a small size against the bars of
``tests/test_unsupervised.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data.graph import build_graph as jax_build_graph
from graphsage_tpu.data.graph import with_cached_layer0 as jax_with_cached_layer0
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_tpu.models.unsupervised import context_group_scores as jax_scores
from graphsage_tpu.models.unsupervised import context_groups as jax_context_groups
from graphsage_tpu.models.unsupervised import linear_probe_predict as jax_probe
from graphsage_tpu.models.unsupervised import unsupervised_loss as jax_unsupervised_loss
from graphsage_tpu.ops import walks as jw
from graphsage_torch import GraphSAGE, TrainConfig, UnsupervisedTrainer, params_from_numpy
from graphsage_torch.convert import LAYER_FIELDS
from graphsage_torch.data.graph import build_graph, with_cached_layer0
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.models.graphsage import Frontier
from graphsage_torch.models.unsupervised import (
    context_group_scores,
    frontier_loss,
    linear_probe_predict,
    unsupervised_loss,
)
from graphsage_torch.ops import walks
from graphsage_torch.train.experiments import main, run_preset

torch.set_num_threads(1)

# Power-law degrees with a few hubs; the fixture appends isolated nodes.
GRAPH = dict(num_nodes=90, num_edges=260, num_feats=24, num_classes=4, seed=9)
Q = 4
# f32 products and sums in other orders; JAX at matmul_precision="highest".
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def graphs():
    """A power-law graph with four isolated nodes appended, built by both
    packages from the same arrays (and a hub-capped copy, ELL width 8)."""
    base = power_law_graph(device="cpu", **GRAPH)
    e, extra = base.num_edges, 4
    edges = np.stack([base.edge_src[:e].numpy(), base.edge_dst[:e].numpy()], axis=1)
    rng = np.random.default_rng(1)
    feats = np.concatenate([base.features.numpy(),
                            rng.normal(size=(extra, GRAPH["num_feats"]))]).astype(np.float32)
    labels = np.concatenate([base.labels.numpy(), rng.integers(0, 4, extra)])
    c = GRAPH["num_classes"]
    jg = jax_build_graph(feats, labels, edges, num_classes=c)
    tg = build_graph(feats, labels, edges, num_classes=c, device="cpu")
    capped = build_graph(feats, labels, edges, num_classes=c, ell_width_cap=8, device="cpu")
    assert not capped.ell_covers_all and int((tg.degrees == 0).sum()) == extra
    return jg, tg, capped


def to_frontier(fr) -> Frontier:
    return Frontier(ids=tuple(torch.from_numpy(np.array(i)) for i in fr.ids),
                    masks=tuple(torch.from_numpy(np.array(m)) for m in fr.masks))


def models(hidden=(16, 12), fanouts=(4, 3), **kw):
    """The JAX model and the port's, both with a linear last layer and the
    same parameters drawn from a numpy seed."""
    common = dict(hidden_dims=hidden, fanouts=fanouts, final_activation="linear", **kw)
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


# --------------------------------------------------------- negative table
@pytest.mark.parametrize("degrees", [
    np.array([3, 0, 1, 7, 2, 2, 40, 0], np.int32),
    np.zeros(5, np.int32),  # edgeless: uniform
    np.random.default_rng(3).zipf(1.8, 5000).astype(np.int32),
], ids=["star-ish", "edgeless", "zipf-5000"])
def test_negative_cdf_bitwise_jax(degrees):
    got, want = walks.negative_cdf(degrees), jw.negative_cdf(degrees)
    assert got.dtype == np.float32 and got[-1] == 1.0
    np.testing.assert_array_equal(got, want)


def test_cdf_lookup_matches_jax_searchsorted():
    cdf_np = jw.negative_cdf(np.array([3, 0, 1, 7, 2, 2, 40, 0, 5], np.int32))
    cdf = jnp.asarray(cdf_np)
    key = jax.random.PRNGKey(7)
    ids = jw.sample_from_cdf(key, cdf, (4000,))
    u = jax.random.uniform(key, (4000,))  # the draw sample_from_cdf makes
    got = walks.cdf_lookup(torch.from_numpy(cdf_np), torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ids))
    # the CDF's own values (ties with a zero-weight node), 0, and u -> 1
    edge = np.concatenate([cdf_np, [0.0, np.nextafter(np.float32(1), np.float32(0))]])
    edge = edge.astype(np.float32)
    want = np.minimum(np.asarray(jnp.searchsorted(cdf, jnp.asarray(edge), side="right")),
                      len(cdf_np) - 1)
    got = walks.cdf_lookup(torch.from_numpy(cdf_np), torch.from_numpy(edge))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ walks
def test_pick_positive_step_matches_jax(graphs):
    jg, _, _ = graphs
    seeds = jnp.arange(jg.num_nodes, dtype=jnp.int32)
    w, v = jax.jit(lambda k: jw.random_walk(k, jg, seeds, 3))(jax.random.PRNGKey(0))
    # Dead walks at several depths: cut some prefixes short by hand.
    v = np.array(v)
    v[::5, 2:] = False
    v[::7, 1:] = False
    key = jax.random.PRNGKey(4)
    pos, mask = jw.pick_positive_step(key, w, jnp.asarray(v), seeds)
    u = jax.random.uniform(key, (jg.num_nodes,))  # the draw JAX's makes
    got_pos, got_mask = walks.pick_positive_step(
        torch.from_numpy(np.asarray(u)), torch.from_numpy(np.asarray(w)),
        torch.from_numpy(v), torch.from_numpy(np.asarray(seeds)))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))


@pytest.mark.parametrize("capped", [False, True], ids=["ell", "hub-capped csr"])
def test_random_walk_stays_on_edges_and_stops_at_sinks(graphs, capped):
    _, tg, cg = graphs
    g = cg if capped else tg
    gen = torch.Generator().manual_seed(0)
    starts = torch.arange(g.num_nodes, dtype=torch.int32).repeat(4)
    w, v = walks.random_walk(gen, g, starts, 4)
    assert w.shape == v.shape == (len(starts), 5) and w.dtype == torch.int32
    indptr, dst = g.indptr.numpy(), g.edge_dst.numpy()
    neigh = {n: set(dst[indptr[n]:indptr[n + 1]].tolist()) for n in range(g.num_nodes)}
    w, v = w.numpy(), v.numpy()
    assert (w[:, 0] == starts.numpy()).all() and v[:, 0].all()
    beyond_ell = 0
    for r in range(len(w)):
        for t in range(1, 5):
            if v[r, t]:
                assert w[r, t] in neigh[w[r, t - 1]]
                beyond_ell += w[r, t] not in g.neighbors[w[r, t - 1]].tolist()
            else:  # a dead walk stays put and never revives
                assert w[r, t] == w[r, t - 1] and not v[r, t:].any()
    isolated = (g.degrees == 0).numpy()[w[:, 0]]
    assert isolated.any() and not v[isolated, 1:].any()
    # On the capped graph hub steps reach neighbors past the ELL width.
    assert (beyond_ell > 0) == capped


def test_random_walk_first_step_uniform():
    """Chi-square over a degree-8 star centre's first step (p = 0.001)."""
    edges = np.array([[0, i] for i in range(1, 9)])
    g = build_graph(np.zeros((12, 2), np.float32), np.zeros(12), edges,
                    num_classes=1, device="cpu")
    gen = torch.Generator().manual_seed(5)
    w, v = walks.random_walk(gen, g, torch.zeros(4000, dtype=torch.int32), 2)
    assert v.all()
    assert (w[:, 2] == 0).all()  # spokes return to the centre
    counts = np.bincount(w[:, 1].numpy(), minlength=9)[1:]
    chi2 = float(((counts - 500.0) ** 2 / 500.0).sum())
    assert chi2 < 24.32, chi2


# ------------------------------------------------------------------- loss
def test_context_group_scores_and_gradient_match_jax():
    rng = np.random.default_rng(2)
    b, d = 6, 5
    z = rng.normal(size=(b * (2 + Q), d)).astype(np.float32)
    z[[0, 9, 13]] = 0.0  # an isolated seed, a negative and a positive embed to 0
    mask = np.array([False, True, True, True, False, True])
    coef = rng.normal(size=b).astype(np.float32)

    def jax_obj(zz):
        per, kept = jax_scores(zz, jnp.asarray(mask), Q)
        return jnp.sum(per * kept * coef), per

    (_, want), want_g = jax.value_and_grad(jax_obj, has_aux=True)(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    per, kept = context_group_scores(zt, torch.from_numpy(mask), Q)
    (per * kept * torch.from_numpy(coef)).sum().backward()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    # The masked group (an isolated seed's) gets exactly 0, not 0/0.
    assert torch.isfinite(zt.grad).all() and (zt.grad[: 2 + Q] == 0).all()


@pytest.mark.parametrize("layer0", ["sampled", "full", "cached"])
def test_unsupervised_loss_and_gradients_match_jax(graphs, layer0):
    """The port's loss on JAX's groups and frontier against JAX's
    ``unsupervised_loss`` with the same key; isolated seeds included."""
    jg, tg, _ = graphs
    if layer0 == "cached":
        jg = jax_with_cached_layer0(jg.to_host()).to_device()
        tg = with_cached_layer0(tg)
    jm, params, tm = models(layer0=layer0)
    cdf = walks.negative_cdf(tg.degrees.numpy())
    seeds = jnp.asarray(np.r_[np.arange(0, 40, 2), tg.num_nodes - 4:tg.num_nodes],
                        jnp.int32)
    key = jax.random.PRNGKey(3)

    @jax.jit
    def jax_side(p):
        loss_grad = jax.value_and_grad(lambda q: jax_unsupervised_loss(
            jm, q, jg, key, seeds, jnp.asarray(cdf), walk_length=3, num_negatives=Q))(p)
        groups, pair_mask, k_sample = jax_context_groups(
            key, jg, seeds, jnp.asarray(cdf), walk_length=3, num_negatives=Q)
        return loss_grad, pair_mask, jm.sample(k_sample, jg, groups)

    (want, want_g), pair_mask, fr = jax_side(params)
    assert not bool(np.asarray(pair_mask).all())  # the isolated seeds drop out
    loss = frontier_loss(tm, tg, to_frontier(fr), torch.from_numpy(np.array(pair_mask)), Q)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    for i, layer in enumerate(tm.layers):
        for f in LAYER_FIELDS:
            if hasattr(layer, f):
                np.testing.assert_allclose(
                    getattr(layer, f).grad.numpy(),
                    np.asarray(getattr(want_g.layers[i], f)), **TOL, err_msg=f"{i}.{f}")
    assert tm.head.grad is None and not np.asarray(want_g.head).any()


def test_unsupervised_loss_bounded_and_isolated_seed_gradients_finite(graphs):
    """Each per-seed term of 1+Q sigmoid terms lies in [0.313, 1.313] on
    unit embeddings; an isolated seed's zero embedding must not turn any
    gradient into NaN (JAX's ``test_isolated_seed_gradients_finite``)."""
    _, tg, _ = graphs
    _, _, tm = models()
    cdf = torch.from_numpy(walks.negative_cdf(tg.degrees.numpy()))
    seeds = torch.tensor([0, 1, tg.num_nodes - 1, 2], dtype=torch.int32)
    loss = unsupervised_loss(tm, tg, torch.Generator().manual_seed(1), seeds, cdf,
                             walk_length=3, num_negatives=Q)
    assert 0.3 * (1 + Q) < float(loss.detach()) < 1.32 * (1 + Q)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in tm.layers.parameters())


# ------------------------------------------------------------------ probe
def test_linear_probe_predicts_jax_classes():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(5, 16)).astype(np.float32) * 2
    y = rng.integers(0, 5, 500).astype(np.int32)
    x = centers[y] + rng.normal(0, 0.6, (500, 16)).astype(np.float32)
    want = np.asarray(jax_probe(jnp.asarray(x[:350]), jnp.asarray(y[:350]),
                                jnp.asarray(x[350:]), 5))
    got = linear_probe_predict(torch.from_numpy(x[:350]), torch.from_numpy(y[:350]),
                               torch.from_numpy(x[350:]), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == y[350:]).mean() > 0.9


# ------------------------------------------------------ final_activation
PATHS = {
    "sampled": dict(),
    "full": dict(layer0="full"),
    "cached": dict(layer0="cached"),
    "maxpool": dict(aggregator="maxpool", pool_dim=10),
    "lstm": dict(aggregator="lstm", pool_dim=10, concat_self=True),
    "one layer": dict(hidden=(12,), fanouts=(4,)),
    "one layer, full": dict(hidden=(12,), fanouts=(4,), layer0="full"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_linear_last_layer_matches_jax(graphs, path):
    """Embeddings of the sampled forward on a JAX frontier and of
    ``forward_full_graph`` against JAX's; the linear layer goes negative."""
    jg, tg, _ = graphs
    kw = dict(PATHS[path])
    if kw.get("layer0") == "cached":
        jg = jax_with_cached_layer0(jg.to_host()).to_device()
        tg = with_cached_layer0(tg)
    jm, params, tm = models(**kw)
    seeds = jnp.arange(0, 60, 3, dtype=jnp.int32)
    fr = jax.jit(jm.sample)(jax.random.PRNGKey(1), jg, seeds)
    want = jax.jit(lambda p: jm.forward(p, jg.features, fr, return_embeddings=True,
                                        graph=jg))(params)
    with torch.no_grad():
        got = tm(tg.features, to_frontier(fr), return_embeddings=True, graph=tg)
        full = tm.embed_full_graph(tg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    want_full = jax.jit(jm.embed_full_graph)(params, jg)
    np.testing.assert_allclose(full.numpy(), np.asarray(want_full), rtol=1e-4, atol=1e-5)
    assert (full < 0).any() and (got < 0).any()


# ---------------------------------------------------------------- trainer
def _trainer_setup():
    from graphsage_torch.data.synthetic import synthetic_cora_graph

    g = synthetic_cora_graph(num_nodes=300, num_feats=64, num_edges=900, seed=0,
                             device="cpu")
    model = GraphSAGE(64, g.num_classes, (32, 32), (5, 5), final_activation="linear",
                      device="cpu", generator=torch.Generator().manual_seed(0))
    return g, model


UNSUP = dict(batch_size=64, optimizer="adam", learning_rate=0.01,
             objective="unsupervised", walk_length=3, num_negatives=8,
             test_size=60, val_size=60, log_every=0)


def test_unsupervised_training_learns_graph_geometry():
    """JAX's bars (``tests/test_unsupervised.py``) at its size: the loss
    falls by 0.3, no collapse to 0, edge endpoints closer than random
    pairs, the probe above chance + 0.2, the head bitwise unchanged."""
    g, model = _trainer_setup()
    head0 = model.head.detach().clone()
    trainer = UnsupervisedTrainer(model, g, TrainConfig(num_steps=120, **UNSUP))
    result = trainer.run(log=None)
    losses = result["losses"]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3
    with torch.no_grad():
        emb = model.embed_full_graph(g).numpy()
    norms = np.linalg.norm(emb, axis=1)
    assert norms.mean() > 0.05
    z = emb / (norms[:, None] + 1e-8)
    e = g.num_edges
    src, dst = g.edge_src[:e].numpy(), g.edge_dst[:e].numpy()
    pos_cos = (z[src] * z[dst]).sum(-1).mean()
    rng = np.random.default_rng(0)
    ri, rj = rng.integers(0, g.num_nodes, 4000), rng.integers(0, g.num_nodes, 4000)
    assert pos_cos > (z[ri] * z[rj]).sum(-1).mean() + 0.2
    assert result["val_micro_f1"] > 1.0 / g.num_classes + 0.2
    assert model.head.grad is None
    assert torch.equal(model.head.detach(), head0)


def test_cached_layer0_equals_full_per_step():
    """JAX's ``test_unsupervised_cached_layer0_matches_full``: the same
    estimand and the same random stream, so the same losses."""
    g, _ = _trainer_setup()
    cfg = TrainConfig(num_steps=3, **{**UNSUP, "batch_size": 32, "num_negatives": 6})
    losses = []
    for layer0, graph in (("full", g), ("cached", with_cached_layer0(g))):
        model = GraphSAGE(64, g.num_classes, (32, 32), (5, 5), final_activation="linear",
                          layer0=layer0, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        losses.append(UnsupervisedTrainer(model, graph, cfg).run(log=None)["losses"])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5, atol=1e-6)


def test_trainer_rejects_relu_and_honours_eval_fanouts(graphs):
    g, _ = _trainer_setup()
    relu = GraphSAGE(64, g.num_classes, (32, 32), (5, 5), device="cpu")
    with pytest.raises(ValueError, match="final_activation"):
        UnsupervisedTrainer(relu, g, TrainConfig(objective="unsupervised"))
    # An lstm model on a hub-capped graph has no full-graph forward: the
    # probe must take the sampled one at eval_fanouts.
    _, _, capped = graphs
    model = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (16, 16), (4, 4),
                      aggregator="lstm", pool_dim=16, final_activation="linear",
                      device="cpu")
    cfg = TrainConfig(num_steps=1, eval_fanouts=(4, 4), **{**UNSUP, "batch_size": 16,
                                                          "test_size": 20, "val_size": 20})
    tr = UnsupervisedTrainer(model, capped, cfg)
    tr.step(next(tr.batches()))
    preds = tr.predict(tr.val_nodes)
    assert preds.shape == (20,)
    np.testing.assert_array_equal(preds, tr.predict(tr.val_nodes))  # seeded


def test_run_preset_dispatches_unsupervised(synth_cora_root):
    over = {"num_steps": 4, "batch_size": 32, "test_size": 100, "val_size": 100}
    result = run_preset("cora_unsup", data_root=synth_cora_root, log=None,
                        overrides=over, device="cpu")
    assert isinstance(result["trainer"], UnsupervisedTrainer)
    assert result["trainer"].model.final_activation == "linear"
    assert len(result["losses"]) == 4 and np.isfinite(result["val_micro_f1"])
    with pytest.raises(ValueError, match="unsupervised"):
        run_preset("cora_unsup", data_root=synth_cora_root, log=None, mode="full-graph",
                   overrides=over, device="cpu")
    # The sharded modes dispatch to the sharded trainers (a world of one).
    from graphsage_torch.train.unsupervised import (
        UnsupervisedFullyShardedTrainer,
        UnsupervisedShardedTrainer,
    )

    over = {**over, "num_steps": 2}
    for mode, cls in (("sharded", UnsupervisedShardedTrainer),
                      ("fully-sharded", UnsupervisedFullyShardedTrainer)):
        result = run_preset("cora_unsup", data_root=synth_cora_root, log=None, mode=mode,
                            overrides=over, device="cpu")
        assert type(result["trainer"]) is cls
        assert len(result["losses"]) == 2 and np.isfinite(result["losses"]).all()


def test_cli_trains_cora_unsup(synth_cora_root, capsys):
    main(["--preset", "cora_unsup", "--data-root", str(synth_cora_root), "--device",
          "cpu", "--steps", "3", "--batch-size", "32", "--test-size", "100",
          "--val-size", "80"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split()[0] == "0" and np.isfinite(float(lines[0].split()[1]))
    assert lines[-2].startswith("Validation F1: ")
    assert lines[-1].startswith("Average batch time: ")


def test_serving_engine_embeds_linearly(graphs):
    from graphsage_torch import ServingEngine

    _, tg, _ = graphs
    _, _, tm = models()
    eng = ServingEngine(tm, tg, device="cpu")
    nodes = np.arange(30)
    with torch.no_grad():
        want = tm.embed_full_graph(tg)[:30].numpy()
    got = eng.embed(nodes)
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any()
