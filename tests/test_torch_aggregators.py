"""The port's max-pool and LSTM aggregators against the JAX package on the
CPU: ``masked_max`` and ``segment_max_csr`` with deliberate ties (the
gradient split evenly among tied maxima, as JAX splits it), ``masked_lstm``
and its gradients, and whole maxpool and lstm models (logits, loss and
parameter gradients on a JAX ``Frontier``, the full-graph forward, and the
sampled forward at covering fanouts against the full-graph one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data.graph import build_graph as jax_build_graph
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_tpu.models.layers import masked_lstm as jax_masked_lstm
from graphsage_tpu.ops.aggregate import masked_max as jax_masked_max
from graphsage_tpu.ops.aggregate import segment_max_csr as jax_segment_max_csr
from graphsage_torch import GraphSAGE, params_from_numpy
from graphsage_torch.convert import LAYER_FIELDS
from graphsage_torch.data.graph import build_graph
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.models.graphsage import Frontier
from graphsage_torch.models.layers import SAGELayer, masked_lstm
from graphsage_torch.ops.aggregate import masked_max, segment_max_csr

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


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _vjp(fn, args, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def tree(params) -> dict:
    return {"layers": [{f: (None if getattr(p, f) is None else np.asarray(getattr(p, f)))
                        for f in LAYER_FIELDS} for p in params.layers],
            "head": np.asarray(params.head)}


def assert_grads_match(tm, want: dict):
    for layer, w in zip(tm.layers, want["layers"]):
        for name, p in layer.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), w[name], err_msg=name, **TOL)
    np.testing.assert_allclose(tm.head.grad.numpy(), want["head"], **TOL)


def random_tree(tm, seed=0) -> dict:
    """Parameters of ``tm``'s shapes drawn from a numpy seed, as the numpy
    tree of a JAX ``SAGEParams`` (fields the layers lack left ``None``)."""
    rng = np.random.default_rng(seed)

    def draw(p):
        return (rng.normal(size=tuple(p.shape)) * 0.3).astype(np.float32)

    layers = [{f: (draw(getattr(layer, f)) if hasattr(layer, f) else None)
               for f in LAYER_FIELDS} for layer in tm.layers]
    return {"layers": layers, "head": draw(tm.head)}


def jax_params(t: dict) -> SAGEParams:
    return SAGEParams(
        layers=tuple(SAGELayerParams(**{f: None if v is None else jnp.asarray(v)
                                        for f, v in p.items()}) for p in t["layers"]),
        head=jnp.asarray(t["head"]))


def models(aggregator, mode, fanouts=(4, 3)):
    """The JAX model and the port's with the same numpy-drawn parameters,
    carried into the port by ``params_from_numpy``."""
    common = dict(hidden_dims=(16, 12), fanouts=fanouts, aggregator=aggregator,
                  pool_dim=10, **MODES[mode])
    jm = JaxGraphSAGE(in_dim=GRAPH["num_feats"], num_classes=GRAPH["num_classes"],
                      matmul_precision="highest", gather_impl="take", **common)
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], device="cpu", **common)
    t = random_tree(tm)
    params_from_numpy(tm, t)
    return jm, jax_params(t), tm


def to_frontier(fr) -> Frontier:
    return Frontier(ids=tuple(torch.from_numpy(np.array(i)) for i in fr.ids),
                    masks=tuple(torch.from_numpy(np.array(m)) for m in fr.masks))


@pytest.fixture(scope="module")
def frontiers(graphs):
    """One JAX frontier per combine mode (the aggregator does not change
    what is sampled), for the seeds ``0, 2, ..., 58``."""
    jg, _ = graphs
    seeds = jnp.arange(0, 60, 2, dtype=jnp.int32)
    out = {}
    for mode, kw in MODES.items():
        jm = JaxGraphSAGE(in_dim=GRAPH["num_feats"], num_classes=GRAPH["num_classes"],
                          hidden_dims=(16, 12), fanouts=(4, 3), **kw)
        out[mode] = jax.jit(jm.sample)(jax.random.PRNGKey(1), jg, seeds)
    return out


# ------------------------------------------------------------------ max ops
def test_masked_max_splits_tied_gradients_as_jax():
    """Ties between valid entries (binary features, ReLU zeros), an
    all-masked row (0, no gradient), and three rows whose ties split the
    gradient in halves."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, size=(6, 5, 7)).astype(np.float32)
    x[0, :3, :2] = [[1, 2], [1, 3], [0.5, 3]]
    mask = rng.random((6, 5)) < 0.7
    mask[0] = [True, True, True, False, False]
    mask[1] = False
    g = rng.normal(size=(6, 7)).astype(np.float32)
    want, (want_dx,) = _vjp(lambda v: jax_masked_max(v, jnp.asarray(mask)), [x], g)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = masked_max(xt, torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **TOL)
    assert (got[1] == 0).all() and (xt.grad[1] == 0).all()
    np.testing.assert_allclose(xt.grad[0, :3, :2].numpy() / g[0, :2],
                               [[0.5, 0], [0.5, 0.5], [0, 0.5]])


def test_segment_max_csr_splits_tied_gradients_as_jax():
    """Per-edge values with ties inside segments, padding edges (which must
    not count) and a node without any valid edge."""
    rng = np.random.default_rng(4)
    n, e_pad = 7, 40
    src = np.sort(rng.integers(0, n - 1, size=e_pad)).astype(np.int32)  # node 6: none
    mask = np.ones(e_pad, bool)
    mask[-6:] = False
    src[-6:] = n - 1
    values = rng.integers(0, 2, size=(e_pad, 5)).astype(np.float32)
    values[-6:] = 9.0  # padding edges hold the largest values
    g = rng.normal(size=(n, 5)).astype(np.float32)
    want, (want_dv,) = _vjp(
        lambda v: jax_segment_max_csr(v, jnp.asarray(src), jnp.asarray(mask), n),
        [values], g)
    vt = torch.from_numpy(values).requires_grad_(True)
    got = segment_max_csr(vt, *_t(src, mask), n)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), want_dv, **TOL)
    assert (got[n - 1] == 0).all() and (vt.grad[-6:] == 0).all()


# --------------------------------------------------------------------- lstm
def lstm_case(seed, b=7, k=5, d=6, h=4):
    rng = np.random.default_rng(seed)
    wx = rng.normal(size=(d, 4 * h)).astype(np.float32) * 0.3
    wh = rng.normal(size=(h, 4 * h)).astype(np.float32) * 0.3
    bias = rng.normal(size=(4 * h,)).astype(np.float32) * 0.1
    seq = rng.normal(size=(b, k, d)).astype(np.float32)
    return rng, wx, wh, bias, seq


def test_masked_lstm_and_its_gradients_match_jax():
    """Prefix masks of every length (0: an isolated node gives 0) and
    interleaved padding; gradients of every input."""
    rng, wx, wh, bias, seq = lstm_case(0)
    mask = np.arange(5)[None, :] < np.array([0, 1, 2, 3, 4, 5, 3])[:, None]
    mask[6] = [False, True, False, True, True]
    g = rng.normal(size=(7, 4)).astype(np.float32)
    want, want_grads = _vjp(
        lambda a, b_, c, s: jax_masked_lstm(a, b_, c, s, jnp.asarray(mask),
                                            precision="highest"),
        [wx, wh, bias, seq], g)
    args = [x.requires_grad_(True) for x in _t(wx, wh, bias, seq)]
    got = masked_lstm(*args, torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert (got[0] == 0).all()
    for a, w in zip(args, want_grads):
        np.testing.assert_allclose(a.grad.numpy(), w, **TOL)


def test_masked_lstm_padding_position_invariance():
    """The result depends on the order of the valid slots, never on where
    the padding sits (``tests/test_lstm.py``'s case)."""
    rng, wx, wh, bias, _ = lstm_case(1, d=5, h=3)
    valid = rng.normal(size=(3, 5)).astype(np.float32)
    pad = rng.normal(size=(3, 5)).astype(np.float32) * 100
    seq_tail = np.concatenate([valid, pad])[None]
    seq_mid = np.stack([pad[0], valid[0], pad[1], valid[1], valid[2], pad[2]])[None]
    w = _t(wx, wh, bias)
    a = masked_lstm(*w, *_t(seq_tail, np.array([[1, 1, 1, 0, 0, 0]], bool)))
    b = masked_lstm(*w, *_t(seq_mid, np.array([[0, 1, 0, 1, 1, 0]], bool)))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_layer_parameters_per_aggregator():
    gen = torch.Generator().manual_seed(0)
    pool = SAGELayer(20, 8, True, gen, aggregator="maxpool", pool_dim=6)
    assert {n: tuple(p.shape) for n, p in pool.named_parameters()} == {
        "weight": (26, 8), "pool_weight": (20, 6), "pool_bias": (6,)}
    assert (pool.pool_bias == 0).all()
    lstm = SAGELayer(20, 8, False, gen, aggregator="lstm")
    shapes = {n: tuple(p.shape) for n, p in lstm.named_parameters()}
    assert shapes == {"weight": (20, 8), "lstm_wx": (20, 80), "lstm_wh": (20, 80),
                      "lstm_b": (80,)}
    assert lstm.lstm_b[20:40].eq(1).all() and lstm.lstm_b[:20].eq(0).all()
    assert float(lstm.lstm_wh.detach().abs().max()) <= np.sqrt(6.0 / 100)
    with pytest.raises(ValueError, match="unknown aggregator"):
        SAGELayer(4, 4, aggregator="gcn")


# ------------------------------------------------------------------- models
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("aggregator", ["maxpool", "lstm"])
def test_loss_and_gradients_match_jax_on_jax_frontier(graphs, frontiers, aggregator,
                                                      mode):
    jg, tg = graphs
    jm, params, tm = models(aggregator, mode)
    jfr = frontiers[mode]
    labels = jnp.take(jg.labels, jfr.ids[0])

    def loss_and_logits(p):
        logits = jm.forward(p, jg.features, jfr)
        return jm.classification_loss(logits, labels).mean(), logits

    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(loss_and_logits, has_aux=True))(params)
    tfr = to_frontier(jfr)
    logits = tm(tg.features, tfr)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    loss = tm.classification_loss(logits, tg.labels[tfr.ids[0].long()]).mean()
    torch.testing.assert_close(loss, tm.loss(tg.features, tfr, tg.labels[tfr.ids[0].long()]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    assert_grads_match(tm, tree(want_grads))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("aggregator", ["maxpool", "lstm"])
def test_forward_full_graph_matches_jax(graphs, aggregator, mode):
    jg, tg = graphs
    jm, params, tm = models(aggregator, mode)
    with torch.no_grad():
        np.testing.assert_allclose(
            tm.forward_full_graph(tg).numpy(),
            np.asarray(jax.jit(jm.forward_full_graph)(params, jg)), **TOL)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("aggregator", ["maxpool", "lstm"])
def test_sampled_at_covering_fanouts_equals_full_graph(graphs, aggregator, mode):
    """``fanout=None`` samples every neighbor in adjacency order, the LSTM's
    full-graph sequence (``tests/test_mode_matrix.py``'s invariant)."""
    _, tg = graphs
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (16, 12), (None, None),
                   aggregator=aggregator, pool_dim=10, device="cpu", **MODES[mode])
    seeds = torch.arange(0, tg.num_nodes, 3, dtype=torch.int32)
    with torch.no_grad():
        full = tm.forward_full_graph(tg)[seeds.long()]
        sampled = tm.apply_sampled(torch.Generator().manual_seed(0), tg, seeds)
    torch.testing.assert_close(sampled, full, **TOL)


def test_lstm_full_graph_rejects_a_hub_capped_graph():
    rng = np.random.default_rng(0)
    edges = np.stack([np.zeros(12, int), np.arange(1, 13)], axis=1)
    g = build_graph(rng.normal(size=(13, 4)).astype(np.float32), np.zeros(13), edges,
                    ell_width_cap=8, device="cpu")
    assert not g.ell_covers_all
    m = GraphSAGE(4, 1, (4,), (None,), aggregator="lstm", device="cpu")
    with pytest.raises(ValueError, match="hub-capped"):
        m.forward_full_graph(g)
    GraphSAGE(4, 1, (4,), (None,), aggregator="maxpool", device="cpu").forward_full_graph(g)


def test_params_from_numpy_checks_aggregator_fields():
    _, params, tm = models("maxpool", "shipped")
    t = tree(params)
    for name, p in tm.layers[1].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), t["layers"][1][name])
    t["layers"][0]["lstm_b"] = np.zeros(40, np.float32)
    with pytest.raises(ValueError, match=r"layers\[0\].lstm_b"):
        params_from_numpy(tm, t)
    t = tree(params)
    t["layers"][1]["pool_weight"] = None
    with pytest.raises(ValueError, match=r"layers\[1\].pool_weight"):
        params_from_numpy(tm, t)
    t = tree(params)
    t["layers"][0]["pool_bias"] = np.zeros(11, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tm, t)
