"""The port's reduced precision against the JAX package on the CPU: int8
tables (``ops/quantize.py``, ``quantize_graph``, the int8 layer-0 cache, the
serving tier's int8 table) and bf16 compute (``compute_dtype``).

Quantization is the same arithmetic in both packages, so it is held
bitwise. bf16 models are held to 2e-2 of each result's largest entry: the
two frameworks round to bf16 at different places (a bf16 product in PyTorch
returns bf16; JAX keeps its f32 accumulator until the cast after it). Int8
tables at f32 compute differ only in the order of f32 sums: 1e-5 of the
largest entry. JAX runs under ``jax.jit`` with parameters drawn with numpy,
as in ``tests/test_torch_layer0.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data.graph import quantize_graph as jax_quantize_graph
from graphsage_tpu.data.graph import with_cached_layer0 as jax_with_cached_layer0
from graphsage_tpu.data.synthetic import power_law_graph as jax_power_law_graph
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_tpu.ops import quantize as jq
from graphsage_torch import GraphSAGE, ServingEngine, Trainer, params_from_numpy
from graphsage_torch.convert import LAYER_FIELDS
from graphsage_torch.data.graph import quantize_graph, with_cached_layer0
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.models.graphsage import Frontier
from graphsage_torch.ops import quantize as tq
from graphsage_torch.ops.aggregate import gather, gather_mean
from graphsage_torch.train import experiments

torch.set_num_threads(1)

BF16_RTOL = 2e-2  # of the largest entry: bf16 rounds at other places
INT8_RTOL = 1e-5  # of the largest entry: f32 sums in another order
GRAPH = dict(num_nodes=240, num_edges=900, num_feats=40, num_classes=4, seed=3,
             homophily=0.8)
HIDDEN = (24, 16)


def close(got, want, rtol, what=""):
    """``got`` within ``rtol`` of ``want``'s largest entry."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    assert scale > 0, f"{what}: an all-zero reference has no power"
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |got - want| {err:.3g} > {rtol} x {scale:.3g}"


def bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.fixture(scope="module")
def graphs():
    """``(jax, port)`` pairs of one power-law graph with f32 and with bf16
    features, and the int8 graphs quantized from the f32 ones."""
    out = {}
    for name, (jdt, tdt) in {"f32": (None, torch.float32),
                             "bf16": (jnp.bfloat16, torch.bfloat16)}.items():
        out[name] = (jax_power_law_graph(feature_dtype=jdt, **GRAPH),
                     power_law_graph(feature_dtype=tdt, device="cpu", **GRAPH))
    jg, tg = out["f32"]
    out["int8"] = (jax_quantize_graph(jg), quantize_graph(tg))
    return out


# ------------------------------------------------------------ quantization
def _table(seed=0, n=60, f=37):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, f)) * rng.uniform(0.01, 30, (n, 1))).astype(np.float32)
    x[4] = 0.0  # scale 1
    x[5, :] = 1e-30  # tiny, nonzero
    x[6, 3] = -x[6].__abs__().max() * 2  # negative maximum
    return x


@pytest.mark.parametrize("kind", ["numpy", "tensor", "rows"])
def test_quantization_is_bitwise_jax(kind):
    x = _table()
    if kind == "numpy":
        want, got = jq.quantize_features(x), tq.quantize_features(x)
        assert isinstance(got.q, np.ndarray)
    elif kind == "tensor":
        want = jq.quantize_features(jnp.asarray(x))
        got = tq.quantize_features(torch.from_numpy(x))
    else:  # any rank, the last axis
        x3 = x.reshape(4, 15, 37)
        want, got = jq.quantize_rows(jnp.asarray(x3)), tq.quantize_rows(torch.from_numpy(x3))
    np.testing.assert_array_equal(np.asarray(got.q), np.asarray(want.q))
    np.testing.assert_array_equal(np.asarray(got.scale), np.asarray(want.scale))
    assert got.shape == tuple(want.shape) and got.nbytes == want.nbytes


def test_dequantizing_lookups_and_projection_match_jax():
    x = _table(seed=1)
    jt, tt = jq.quantize_features(jnp.asarray(x)), tq.quantize_features(torch.from_numpy(x))
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 60, (9, 6)).astype(np.int32)
    mask = rng.random((9, 6)) < 0.7
    mask[0] = False  # an all-masked row
    ids[1], mask[1] = 4, True  # a zero row (scale 1)
    close(tq.gather_dequant(tt, torch.from_numpy(ids)), jq.gather_dequant(jt, ids),
          INT8_RTOL, "gather_dequant")
    got = tq.gather_mean_dequant(tt, torch.from_numpy(ids), torch.from_numpy(mask))
    close(got, jq.gather_mean_dequant(jt, ids, mask), INT8_RTOL, "gather_mean_dequant")
    assert (got[0] == 0).all() and (got[1] == 0).all()
    w = rng.normal(size=(37, 11)).astype(np.float32)
    close(tq.project_table(tt, torch.from_numpy(w)),
          jq.project_table(jt, jnp.asarray(w), precision="highest"), INT8_RTOL,
          "project_table")
    np.testing.assert_allclose(tq.dense_host_view(tt), jq.dense_host_view(jt), rtol=1e-6)
    close(tq.dequantize(tt), jq.dequantize(jt), INT8_RTOL, "dequantize")


def test_power_law_graph_bf16_features_are_bitwise_jax(graphs):
    jg, tg = graphs["bf16"]
    assert tg.features.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16_bits(tg.features), bf16_bits(jg.features))


def test_quantize_graph_is_idempotent_and_drops_the_cache(graphs):
    jg, tg = graphs["f32"]
    cached = with_cached_layer0(tg)
    with pytest.warns(UserWarning, match="dropping the pre-built layer0_cache"):
        qg = quantize_graph(cached)
    assert qg.layer0_cache is None and not qg.layer0_cache_self_loop
    np.testing.assert_array_equal(qg.features.q.numpy(), np.asarray(jax_quantize_graph(jg).features.q))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert quantize_graph(qg) is qg
    assert qg.nbytes == tg.nbytes - tg.features.nbytes + qg.features.nbytes
    assert qg.features.nbytes == tg.num_nodes * (tg.num_features + 4)
    moved = qg.to("cpu")
    assert torch.equal(moved.features.q, qg.features.q) and moved.device.type == "cpu"


@pytest.mark.parametrize("self_loop", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int8 dense", "bf16 features"])
def test_cache_kinds_match_jax(graphs, kind, self_loop):
    """``dtype=bf16`` over f32 features; ``quantize=True`` over an int8 graph
    (the trainer's choice) and the f32 cache it defaults to; the bf16 cache
    a bf16 graph defaults to."""
    base = {"bf16": "f32", "int8": "int8", "int8 dense": "int8", "bf16 features": "bf16"}
    jg, tg = graphs[base[kind]]
    kw_j, kw_t = {}, {}
    if kind == "bf16":
        kw_j, kw_t = dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)
    if kind == "int8":
        kw_j = kw_t = dict(quantize=True)
    want = jax_with_cached_layer0(jg, self_loop=self_loop, **kw_j).layer0_cache
    got = with_cached_layer0(tg, self_loop=self_loop, **kw_t).layer0_cache
    if kind == "int8":
        assert got.q.dtype == torch.int8
        assert np.abs(got.q.numpy().astype(int) - np.asarray(want.q).astype(int)).max() <= 1
        close(tq.dequantize(got), jq.dequantize(want), 1e-2, "int8 cache")
        return
    want_dtype = torch.float32 if kind == "int8 dense" else torch.bfloat16
    assert got.dtype == want_dtype
    rtol = INT8_RTOL if kind == "int8 dense" else BF16_RTOL
    close(got.float(), np.asarray(want, np.float32), rtol, kind)


def test_bf16_scatter_sums_in_f32():
    """A row named 1000 times: a bf16 running sum stalls at 256 (256 + 1
    rounds to 256); the gathers' backward and the gather-mean's scatter add
    in f32 and give 1000."""
    table = torch.zeros(10, 8, dtype=torch.bfloat16, requires_grad=True)
    ids = torch.full((1000,), 3, dtype=torch.int32)
    gather(table, ids).backward(torch.ones(1000, 8, dtype=torch.bfloat16))
    assert table.grad.dtype == torch.bfloat16
    assert (table.grad[3] == 1000).all() and table.grad.sum() == 8000
    table.grad = None
    idx = torch.full((1000, 2), 3, dtype=torch.int32)
    mask = torch.ones(1000, 2, dtype=torch.bool)
    gather_mean(table, idx, mask).backward(torch.ones(1000, 8))
    assert (table.grad[3] == 1000).all()


# ------------------------------------------------------------------ models
def to_frontier(fr) -> Frontier:
    return Frontier(ids=tuple(torch.from_numpy(np.array(i)) for i in fr.ids),
                    masks=tuple(torch.from_numpy(np.array(m)) for m in fr.masks))


def models(aggregator="mean", layer0="sampled", compute_dtype=True, fanouts=(4, 3),
           **kw):
    """The JAX model and the port's with the same numpy-drawn parameters."""
    # JAX runs at "highest"; the port's f32 products are full f32 unless TF32
    # is switched on, which these tolerances do not allow for.
    assert not torch.backends.cuda.matmul.allow_tf32
    common = dict(hidden_dims=HIDDEN, fanouts=fanouts, aggregator=aggregator,
                  pool_dim=12, layer0=layer0, **kw)
    jm = JaxGraphSAGE(in_dim=GRAPH["num_feats"], num_classes=GRAPH["num_classes"],
                      matmul_precision="highest", gather_impl="take",
                      compute_dtype=jnp.bfloat16 if compute_dtype else None, **common)
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], device="cpu",
                   compute_dtype=torch.bfloat16 if compute_dtype else None, **common)
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


SEEDS = jnp.arange(0, 240, 1, dtype=jnp.int32)
BF16_CASES = {
    "sampled mean project-first": dict(project_first=True),
    "sampled mean mean-first, concat_self": dict(project_first=False, concat_self=True),
    "sampled maxpool, concat_self": dict(aggregator="maxpool", concat_self=True),
    "sampled lstm": dict(aggregator="lstm"),
    "full mean, self_loop": dict(layer0="full", self_loop=True),
    "cached mean, concat_self": dict(layer0="cached", concat_self=True),
}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_loss_and_gradients_match_jax(graphs, case):
    kw = BF16_CASES[case]
    jg, tg = graphs["bf16"]
    if kw.get("layer0") == "cached":
        self_loop = kw.get("self_loop", False)
        jg = jax_with_cached_layer0(jg, self_loop=self_loop)
        tg = with_cached_layer0(tg, self_loop=self_loop)
        assert tg.layer0_cache.dtype == torch.bfloat16
    jm, params, tm = models(**kw)
    jfr = jax.jit(jm.sample)(jax.random.PRNGKey(1), jg, SEEDS)
    labels = jnp.take(jg.labels, jfr.ids[0])

    def loss_and_logits(p):
        logits = jm.forward(p, jg.features, jfr, graph=jg)
        return jm.classification_loss(logits, labels).mean(), logits

    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(loss_and_logits, has_aux=True))(params)
    tfr = to_frontier(jfr)
    logits = tm(tg.features, tfr, graph=tg)
    assert logits.dtype == torch.float32
    close(logits.detach(), want_logits, BF16_RTOL, "logits")
    loss = tm.loss(tg.features, tfr, tg.labels[tfr.ids[0].long()], graph=tg)
    loss.backward()
    close(loss.detach(), want_loss, BF16_RTOL, "loss")
    for layer, w in zip(tm.layers, want_grads.layers):
        for name, p in layer.named_parameters():
            assert p.grad.dtype == torch.float32
            close(p.grad, getattr(w, name), BF16_RTOL, name)
    close(tm.head.grad, want_grads.head, BF16_RTOL, "head")


@pytest.mark.parametrize("aggregator", ["mean", "maxpool", "lstm"])
def test_bf16_full_graph_forward_and_gradients_match_jax(graphs, aggregator):
    """Logits, loss and parameter gradients of every aggregator."""
    jg, tg = graphs["bf16"]
    jm, params, tm = models(aggregator=aggregator, concat_self=aggregator != "mean",
                            project_first=True)
    nodes = np.arange(GRAPH["num_nodes"])

    def loss_and_logits(p):
        logits = jm.forward_full_graph(p, jg)
        return jm.classification_loss(logits[nodes], jg.labels[nodes]).mean(), logits

    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(loss_and_logits, has_aux=True))(params)
    logits = tm.forward_full_graph(tg)
    close(logits.detach(), want_logits, BF16_RTOL, "logits")
    idx = torch.from_numpy(nodes)
    loss = tm.classification_loss(logits[idx], tg.labels[idx]).mean()
    loss.backward()
    close(loss.detach(), want_loss, BF16_RTOL, "loss")
    for layer, w in zip(tm.layers, want_grads.layers):
        for name, p in layer.named_parameters():
            close(p.grad, getattr(w, name), BF16_RTOL, name)


INT8_CASES = {
    "sampled mean project-first, concat_self": dict(project_first=True, concat_self=True),
    "sampled mean mean-first": dict(project_first=False),
    "sampled maxpool": dict(aggregator="maxpool"),
    "full mean project-first, self_loop": dict(layer0="full", project_first=True,
                                               self_loop=True),
    "full maxpool": dict(layer0="full", aggregator="maxpool"),
    "cached mean, int8 cache": dict(layer0="cached"),
}


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_table_forward_matches_jax(graphs, case):
    kw = INT8_CASES[case]
    jg, tg = graphs["int8"]
    assert tq.is_quantized(tg.features)
    if kw.get("layer0") == "cached":
        jg = jax_with_cached_layer0(jg, quantize=True)
        tg = with_cached_layer0(tg, quantize=True)
    jm, params, tm = models(compute_dtype=False, **kw)
    jfr = jax.jit(jm.sample)(jax.random.PRNGKey(2), jg, SEEDS)
    want = jax.jit(lambda p: jm.forward(p, jg.features, jfr, graph=jg))(params)
    with torch.no_grad():
        got = tm(tg.features, to_frontier(jfr), graph=tg)
    close(got, want, INT8_RTOL, case)


def test_int8_table_full_graph_forward_matches_jax(graphs):
    jg, tg = graphs["int8"]
    jm, params, tm = models(compute_dtype=False, concat_self=True)
    want = jax.jit(lambda p: jm.forward_full_graph(p, jg))(params)
    with torch.no_grad():
        close(tm.forward_full_graph(tg), want, INT8_RTOL, "forward_full_graph")


def test_bf16_step_with_a_row_named_1000_times(graphs):
    """A bf16 step whose gathers name node 7 a thousand times (the seed
    batch, with ``concat_self`` the projected self-table's gather): the
    parameter gradients match an f32 model's on the same bf16 inputs."""
    _, tg = graphs["bf16"]
    kw = dict(concat_self=True, project_first=True)
    _, _, bf = models(**kw)
    _, _, f32 = models(compute_dtype=False, **kw)
    seeds = torch.full((1000,), 7, dtype=torch.int32)
    fr = bf.sample(torch.Generator().manual_seed(5), tg, seeds)
    labels = tg.labels[seeds.long()]
    bf.loss(tg.features, fr, labels).backward()
    f32.loss(tg.features.float(), fr, labels).backward()
    for (name, a), b in zip(bf.named_parameters(), f32.parameters()):
        close(a.grad, b.grad, BF16_RTOL, name)


# ------------------------------------------------------------------ serving
def test_serving_bf16_model_and_int8_table(graphs):
    _, tg = graphs["bf16"]
    _, _, tm = models(project_first=True)
    nodes = np.arange(tg.num_nodes)
    table = ServingEngine(tm, tg, batch_buckets=(64,), device="cpu")
    quant = ServingEngine(tm, tg, batch_buckets=(64,), device="cpu", quantize_table=True)
    want, got = table.logits(nodes), quant.logits(nodes)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    # The int8 table moves each representation by at most half a scale step.
    emb = table.embed(nodes)
    step = np.abs(emb).max(axis=1, keepdims=True) / 127.0
    assert (np.abs(quant.embed(nodes) - emb) <= step / 2 + 1e-6).all()
    close(got, want, 2e-2, "int8 table logits")
    assert quant.memory_stats()["table_bytes_per_chip"] == tg.num_nodes * (HIDDEN[-1] + 4)
    assert table.memory_stats()["table_bytes_per_chip"] == tg.num_nodes * HIDDEN[-1] * 4
    with pytest.raises(ValueError, match="quantize_table requires mode='table'"):
        ServingEngine(tm, tg, mode="sampled", device="cpu", quantize_table=True)
    # Sampled at covering fanouts == the table tier, in bf16.
    max_deg = int(tg.degrees.max())
    sampled = ServingEngine(tm, tg, mode="sampled", batch_buckets=(16,),
                            eval_fanouts=(max_deg, max_deg), device="cpu")
    close(sampled.logits(nodes[:16]), want[:16], BF16_RTOL, "covering sampled")


# --------------------------------------------------------------------- CLI
# The presets' datasets shrunk to a few thousand nodes (widths, classes and
# feature dtypes kept).
SMALL = dict(num_nodes=2500, num_edges=12000)


@pytest.mark.parametrize("name,extra", [
    ("powerlaw", []), ("reddit", []), ("powerlaw_1m", []),
    ("powerlaw_1m_layer0_cached", []), ("powerlaw_1m", ["--quantize-features"]),
    ("powerlaw_1m_layer0_cached", ["--quantize-features"]),
])
def test_cli_trains_the_reduced_precision_presets(name, extra, monkeypatch, capsys):
    small = {k: {**v, **SMALL} for k, v in experiments.POWER_LAW_DATASETS.items()}
    monkeypatch.setattr(experiments, "POWER_LAW_DATASETS", small)
    seen = []
    real = Trainer.__init__

    def spy(self, model, graph, config):
        real(self, model, graph, config)
        seen.append(self)

    monkeypatch.setattr(Trainer, "__init__", spy)
    experiments.main(["--preset", name, "--device", "cpu", "--steps", "2",
                      "--batch-size", "32", "--test-size", "100", "--val-size", "80",
                      *extra])
    (tr,) = seen
    cfg = experiments.PRESETS[name].model
    assert tr.model.compute_dtype == torch.bfloat16
    assert tr.model.hidden_dims == tuple(cfg.hidden_dims)
    want_dtype = experiments.POWER_LAW_DATASETS[experiments.PRESETS[name].dataset].get(
        "feature_dtype", torch.float32)
    if extra:
        assert tq.is_quantized(tr.graph.features)
    else:
        assert tr.graph.features.dtype == want_dtype
    if cfg.layer0 == "cached":  # built at construction, int8 for an int8 graph
        assert tq.is_quantized(tr.graph.layer0_cache) == bool(extra)
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("Validation F1: ") and out[-1].startswith("Average batch time: ")
    losses = [float(line.split()[1]) for line in out if line[:1].isdigit()]
    assert 1 <= len(losses) <= 2 and np.isfinite(losses).all()  # as log_every says
