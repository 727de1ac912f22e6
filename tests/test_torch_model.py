"""The port's GraphSAGE against the JAX model: with weights carried across
(``params_from_numpy``) and the JAX ``Frontier`` fed to the port, logits and
embeddings agree; the full-graph forward agrees with project-first forced on
and off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data.synthetic import synthetic_cora_graph as jax_synthetic_cora
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_torch import PRESETS, GraphSAGE, params_from_numpy
from graphsage_torch.data.synthetic import synthetic_cora_graph
from graphsage_torch.models.graphsage import Frontier

torch.set_num_threads(1)

# Different summation orders and matmul kernels in f32.
TOL = dict(rtol=1e-4, atol=1e-5)
MODES = {
    "shipped": {},
    "concat_self": dict(concat_self=True),
    "self_loop": dict(self_loop=True),
}
GRAPH = dict(num_nodes=160, num_feats=40, num_edges=420, num_classes=4, seed=2)


@pytest.fixture(scope="module")
def graphs():
    return jax_synthetic_cora(**GRAPH), synthetic_cora_graph(device="cpu", **GRAPH)


def to_tree(params) -> dict:
    return {"layers": [{"weight": np.asarray(p.weight)} for p in params.layers],
            "head": np.asarray(params.head)}


def to_frontier(fr) -> Frontier:
    return Frontier(
        ids=tuple(torch.from_numpy(np.array(i)) for i in fr.ids),
        masks=tuple(torch.from_numpy(np.array(m)) for m in fr.masks),
    )


def models(mode, project_first="auto", **kw):
    common = dict(hidden_dims=(16, 12), fanouts=(4, 3), project_first=project_first,
                  **MODES[mode], **kw)
    jm = JaxGraphSAGE(in_dim=GRAPH["num_feats"], num_classes=GRAPH["num_classes"],
                      matmul_precision="highest", gather_impl="take", **common)
    params = jm.init(jax.random.PRNGKey(0))
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], device="cpu", **common)
    params_from_numpy(tm, to_tree(params))
    return jm, params, tm


@pytest.mark.parametrize("project_first", ["auto", True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_jax_on_jax_frontier(graphs, mode, project_first):
    jg, tg = graphs
    jm, params, tm = models(mode, project_first)
    fr = jm.sample(jax.random.PRNGKey(1), jg, jnp.arange(40, dtype=jnp.int32))
    with torch.no_grad():
        for emb in (False, True):
            want = jm.forward(params, jg.features, fr, return_embeddings=emb)
            got = tm(tg.features, to_frontier(fr), return_embeddings=emb)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("project_first", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_full_graph_matches_jax(graphs, mode, project_first):
    jg, tg = graphs
    jm, params, tm = models(mode, project_first)
    with torch.no_grad():
        np.testing.assert_allclose(
            tm.forward_full_graph(tg).numpy(),
            np.asarray(jm.forward_full_graph(params, jg)), **TOL)
        np.testing.assert_allclose(
            tm.embed_full_graph(tg).numpy(),
            np.asarray(jm.embed_full_graph(params, jg)), **TOL)


def test_full_graph_spmm_impls_agree(graphs):
    _, tg = graphs
    _, _, tm = models("shipped")
    with torch.no_grad():
        auto = tm.forward_full_graph(tg)
        tm.spmm_impl = "xla"
        torch.testing.assert_close(tm.forward_full_graph(tg), auto, **TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_sample_at_covering_fanouts_identical_to_jax(graphs, mode):
    """Fanouts at the ELL width sample deterministically: the port's
    frontier equals the JAX package's array for array."""
    jg, tg = graphs
    jm, _, tm = models(mode)
    w = tg.max_degree
    seeds = np.arange(0, 150, 7, dtype=np.int32)
    jw = JaxGraphSAGE(in_dim=jm.in_dim, num_classes=jm.num_classes,
                      hidden_dims=jm.hidden_dims, fanouts=(w, w),
                      concat_self=jm.concat_self, self_loop=jm.self_loop)
    want = jw.sample(jax.random.PRNGKey(0), jg, jnp.asarray(seeds))
    got = tm.sample(torch.Generator().manual_seed(0), tg, torch.from_numpy(seeds),
                    fanouts=(w, w))
    assert got.num_hops == 2
    for a, b in zip(got.ids + got.masks, want.ids + want.masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_shapes_and_masks(graphs):
    _, tg = graphs
    _, _, tm = models("concat_self")
    seeds = torch.arange(10, dtype=torch.int32)
    fr = tm.sample(torch.Generator().manual_seed(3), tg, seeds)
    assert [i.numel() for i in fr.ids] == [10, 10 * 4, 10 * 4 * 5]
    hop1 = fr.ids[1].reshape(10, 4)
    assert torch.equal(hop1[:, 0], seeds) and fr.masks[1].reshape(10, 4)[:, 0].all()
    # A masked parent masks its whole row of children.
    parents = fr.masks[1]
    children = fr.masks[2].reshape(-1, 5)
    assert not children[~parents].any()


@pytest.mark.parametrize("sampling", ["floyd", "topk", "windowed"])
def test_sample_uses_the_sampling_method(graphs, sampling, monkeypatch):
    """``sampling`` reaches every hop's sampler call."""
    import graphsage_torch.models.graphsage as model_module
    _, tg = graphs
    seen = []
    real = model_module.sample_neighbors

    def spy(*args, method="floyd", **kw):
        seen.append(method)
        return real(*args, method=method, **kw)

    monkeypatch.setattr(model_module, "sample_neighbors", spy)
    tm = GraphSAGE(tg.num_features, tg.num_classes, (4, 4), (2, 3), sampling=sampling,
                   device="cpu")
    fr = tm.sample(torch.Generator().manual_seed(0), tg, torch.arange(6, dtype=torch.int32))
    assert seen == [sampling, sampling] and fr.ids[2].numel() == 6 * 3 * 2


def test_unknown_sampling_method_raises():
    with pytest.raises(ValueError, match="unknown sampling method"):
        GraphSAGE(8, 2, (4, 4), (2, 2), sampling="reservoir", device="cpu")


def test_from_config_carries_sampling_and_multilabel_is_a_head_option():
    from graphsage_torch.train.config import ModelConfig
    m = GraphSAGE.from_config(ModelConfig(hidden_dims=(4,), fanouts=(2,), sampling="topk"),
                              8, 3, device="cpu")
    assert (m.sampling, m.multilabel) == ("topk", False)
    assert GraphSAGE(8, 3, (4,), (2,), multilabel=True, device="cpu").multilabel


def test_compute_dtype():
    m = GraphSAGE(8, 2, (4, 4), (2, 2), device="cpu", compute_dtype=torch.bfloat16)
    assert m.compute_dtype == torch.bfloat16
    # Parameters stay f32; the products cast them at use.
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        GraphSAGE(8, 2, (4, 4), (2, 2), device="cpu", compute_dtype="bfloat16")


@pytest.mark.parametrize("project_first,num_nodes,slots,want", [
    ("auto", 2708, 25600, True),       # Cora's frontier: project first
    ("auto", 19717, 256000, True),     # Pubmed's
    ("auto", 232965, 128000, False),   # Reddit's: aggregate first
    ("auto", 232965, 512000, False),   # Reddit's at 4x the batch: still
    ("auto", 232965, 1024000, True),   # and at 8x: project first
    (True, 232965, 128000, True),      # pinned either way
    (False, 2708, 25600, False),
])
def test_sampled_layer0_order_rule(project_first, num_nodes, slots, want):
    m = GraphSAGE(602, 4, (128, 128), (10, 25), project_first=project_first,
                  device="cpu")
    assert m.sampled_layer0_project_first(num_nodes, slots) is want
    # A layer that does not shrink never projects first on "auto".
    wide = GraphSAGE(64, 4, (128, 128), (10, 25), device="cpu")
    assert not wide.sampled_layer0_project_first(10, 10**6)


def test_model_validation():
    with pytest.raises(ValueError):
        GraphSAGE(8, 2, (4, 4), (2,), device="cpu")
    with pytest.raises(ValueError):
        GraphSAGE(8, 2, concat_self=True, self_loop=True, device="cpu")


@pytest.mark.parametrize("name", ["cora_pool", "cora_lstm"])
def test_from_config_aggregator_presets(name):
    cfg = PRESETS[name].model
    m = GraphSAGE.from_config(cfg, 50, 3, device="cpu")
    assert (m.aggregator, m.pool_dim, m.concat_self) == (cfg.aggregator, 128, True)
    assert [tuple(layer.weight.shape) for layer in m.layers] == [(178, 128), (256, 128)]
    extra = ("pool_weight", "pool_bias") if name == "cora_pool" else (
        "lstm_wx", "lstm_wh", "lstm_b")
    assert all(hasattr(layer, f) for layer in m.layers for f in extra)


@pytest.mark.parametrize("name", ["cora", "pubmed"])
def test_from_config_presets(name):
    cfg = PRESETS[name].model
    m = GraphSAGE.from_config(cfg, 50, 3, device="cpu")
    assert m.hidden_dims == tuple(cfg.hidden_dims) and m.fanouts == tuple(cfg.fanouts)
    assert [tuple(layer.weight.shape) for layer in m.layers] == [(50, 128), (128, 128)]
    assert tuple(m.head.shape) == (128, 3) and m.device == torch.device("cpu")
    unsup = GraphSAGE.from_config(PRESETS["cora_unsup"].model, 50, 3, device="cpu")
    assert unsup.final_activation == "linear"
    assert unsup.layer_activation(0) is torch.relu and unsup.layer_activation(1) is None
    for preset in ("powerlaw", "powerlaw_1m_layer0_cached", "reddit"):
        m = GraphSAGE.from_config(PRESETS[preset].model, 50, 3, device="cpu")
        assert m.compute_dtype == torch.bfloat16
        assert m.layer0 == PRESETS[preset].model.layer0


def test_seeded_init_is_reproducible_and_glorot():
    a = GraphSAGE(30, 3, (20, 10), (2, 2), device="cpu",
                  generator=torch.Generator().manual_seed(5))
    b = GraphSAGE(30, 3, (20, 10), (2, 2), device="cpu",
                  generator=torch.Generator().manual_seed(5))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    limit = np.sqrt(6.0 / (30 + 20))
    assert float(a.layers[0].weight.detach().abs().max()) <= limit


def test_params_from_numpy_checks_shapes():
    m = GraphSAGE(6, 2, (4, 4), (2, 2), device="cpu")
    tree = {"layers": [{"weight": np.zeros((6, 4))}, {"weight": np.zeros((4, 4))}],
            "head": np.zeros((4, 3))}
    with pytest.raises(ValueError, match="head"):
        params_from_numpy(m, tree)
    with pytest.raises(ValueError, match="layers"):
        params_from_numpy(m, {"layers": tree["layers"][:1], "head": tree["head"]})


def test_predictions_argmax():
    m = GraphSAGE(6, 3, (4, 4), (2, 2), device="cpu")
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 0.5]])
    assert m.predictions(logits).tolist() == [1, 0]


def test_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphSAGE(6, 3, (4, 4), (2, 2))
