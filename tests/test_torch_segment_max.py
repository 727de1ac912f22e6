"""The CSR segment max (``graphsage_torch/ops/segment_max.py``) and the
full-graph max-pooling model, held to the benchmark's plain reference
(``perfbench/reference/maxpool.py``).

On the CPU: the full-graph max-pool model through ``FullGraphTrainer.step``
(loss, every leaf's first gradient, every leaf after 3 Adam steps), the
model's full-graph segment max running the op, the op's plain route forward and backward at planted ties, rows without
neighbours and a row wider than the ELL cap of 256, and the card's route for
full ties (moved to the front, summed over the CSR, added back) run with
the plain sum. Marked ``gpu`` (they skip without a card): the kernel against
``segment_max_csr``, forward bitwise and backward to f32 rounding, in one
pass and in column panels, and kernel 3's live column count.
This file imports neither JAX nor the JAX package:

    python -m pytest -m gpu --noconftest tests/test_torch_segment_max.py
"""

import math

import numpy as np
import pytest
import torch

import graphsage_torch.ops.segment_max as smx
import graphsage_torch.ops.spmm as sp
from graphsage_torch import FullGraphTrainer, GraphSAGE, TrainConfig, build_graph
from graphsage_torch.data.graph import row_block
from graphsage_torch.ops.aggregate import gather, segment_max_csr
from graphsage_torch.utils import profiling
from perfbench.reference.maxpool import CsrMax, full_logits
from perfbench.reference.model import Csr, adam_step, cross_entropy

# Sums of the same f32 terms in another order (the scatters' atomics, or
# index_add_ against index_put_).
TOL = dict(rtol=1e-5, atol=1e-6)
HUB = 300  # neighbours of node 0: wider than the ELL cap of 256


def _pairs(n, num_pairs, seed):
    """Distinct undirected pairs ``a < b`` over ``n`` nodes; node 0 a hub of
    ``HUB`` neighbours, the last 10 nodes isolated."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, n - 10, (num_pairs, 2))
    hub = np.stack([np.zeros(HUB, np.int64), np.arange(1, HUB + 1)], 1)
    a = np.concatenate([a[a[:, 0] != a[:, 1]], hub])
    return np.unique(np.sort(a, axis=1), axis=0)


def _csr(n, pairs, device="cpu"):
    """The reference's CSR and the op's ``indptr`` and ``edge_dst`` over it."""
    csr = Csr(torch.from_numpy(pairs).to(device), n)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=device)
    indptr[1:] = torch.cumsum(csr.degrees, 0)
    return csr, indptr, csr.dst.to(torch.int32)


# Values with planted ties: ReLU of small integers (ties at 0 and above
# it), integers from 1 (ties above 0 only), and Gaussians (no ties).
VALUES = {
    "ties at 0": lambda g, shape: torch.relu(torch.randint(-3, 3, shape, generator=g).float()),
    "ties above 0": lambda g, shape: torch.randint(1, 4, shape, generator=g).float(),
    "no ties": lambda g, shape: torch.randn(shape, generator=g),
}


def _grad(fn, x, grad):
    x = x.detach().clone().requires_grad_(True)
    fn(x).backward(grad)
    return x.grad


def _assert_grads_close(got, want, size, rounding=0.0):
    """Sums of the same terms in another order: within 1e-5 of the sum of
    their magnitudes ``size`` (a hub's gradient row sums thousands of terms
    of both signs), and ``rounding`` of the value for a result rounded once
    to a narrower type."""
    assert ((got.float() - want).abs() <= 1e-5 * size + rounding * want.abs() + 1e-6).all()


@pytest.mark.parametrize("values", list(VALUES))
def test_plain_route_matches_the_reference_csr_max(values):
    n, f = 400, 24
    csr, indptr, edge_dst = _csr(n, _pairs(n, 900, seed=1))
    g = torch.Generator().manual_seed(2)
    x = VALUES[values](g, (n, f))
    grad = torch.randn(n, f, generator=g)
    got = smx.segment_max(x, indptr, edge_dst)
    assert torch.equal(got, CsrMax.apply(x, csr))
    assert (got[-10:] == 0).all()  # isolated nodes
    # A max of 0 sends nothing: only zeros lose their gradient.
    want = torch.where(x == 0, 0.0, _grad(lambda t: CsrMax.apply(t, csr), x, grad))
    _assert_grads_close(_grad(lambda t: smx.segment_max(t, indptr, edge_dst), x, grad),
                        want, _grad(lambda t: CsrMax.apply(t, csr), x, grad.abs()))
    # The record: the neighbour that holds each max, -k for k tied slots.
    _, rec = smx.segment_max_plain(x, indptr, edge_dst)
    assert (rec[-10:] == -1).all()
    untied = rec >= 0
    assert torch.equal(x[rec[untied].long(), torch.nonzero(untied)[:, 1]], got[untied])
    assert (values != "no ties") == bool((rec < -1).any())
    # Rows whose max is 0 record -1, as rows without an edge do.
    assert (values == "ties at 0") == bool((rec[:-10] == -1).any())


@pytest.mark.parametrize("full", [[], [3, 17, 18, 39], list(range(40))],
                         ids=["none", "some columns", "every column"])
def test_full_ties_as_a_csr_sum_match_the_plain_backward(full):
    """The route for full ties on a symmetric graph (a row tied with every
    neighbour: ``A (g / deg)`` over those columns, moved to the front by
    their flags and added back) in PyTorch ops, the card's reference, with
    kernel 3's plain version, against the plain backward's even split."""
    n, f = 400, 40
    _, indptr, edge_dst = _csr(n, _pairs(n, 900, seed=14))
    g = torch.Generator().manual_seed(15)
    x = torch.rand((n, f), generator=g)  # no ties but the planted ones
    x[:, full] = 0.5  # a unit that reads one value on every node
    grad = torch.randn(n, f, generator=g)
    out, rec = smx.segment_max_plain(x, indptr, edge_dst)
    deg = (indptr[1:] - indptr[:-1])[:, None]
    is_full = (rec < -1) & (rec == -deg)
    full_cols = is_full.any(0).to(torch.int32)
    assert torch.nonzero(full_cols).reshape(-1).tolist() == full
    want = smx.segment_max_backward_plain(grad, x, out, rec, indptr, edge_dst)
    # What the scatter and the tie pass send: all but the full ties.
    rest = torch.where(is_full, -1, rec)
    got = smx.segment_max_backward_plain(grad, x, out, rest, indptr, edge_dst)
    smx._add_full_ties_plain(got, grad, rec, indptr, edge_dst, full_cols)
    size = smx.segment_max_backward_plain(grad.abs(), x, out, rec, indptr, edge_dst)
    _assert_grads_close(got, want, size)


def _subset_graph(n, num_pairs, undirected, seed, dev="cpu"):
    """``_pairs``' graph (both directions of each pair, or ``a -> b`` alone)
    and about two thirds of its rows, the hub (node 0) and an isolated node
    (the last) among them."""
    g = build_graph(np.zeros((n, 1), np.float32), np.zeros(n), _pairs(n, num_pairs, seed),
                    num_classes=1, undirected=undirected, device=dev)
    keep = np.random.default_rng(seed).random(n) < 2 / 3
    keep[0] = keep[-1] = True
    return g, torch.from_numpy(np.nonzero(keep)[0]).to(dev)


@pytest.mark.parametrize("undirected", [True, False], ids=["symmetric", "directed"])
@pytest.mark.parametrize("values", list(VALUES))
def test_plain_route_over_a_row_subset_equals_the_full_calls_rows(values, undirected):
    """The segment max over a row block (a full-tie column, the hub, a row
    with no edge among its rows): the full call's rows, and for a gradient
    on those rows alone the full call's backward, bitwise; on a symmetric
    graph the card's route for the full ties, in PyTorch ops, through the
    block's transpose, against the plain backward."""
    n, f = 400, 24
    g, rows = _subset_graph(n, 900, undirected, seed=18)
    block = row_block(g, rows)
    assert (block.transpose is not None) == undirected
    gen = torch.Generator().manual_seed(19)
    x = VALUES[values](gen, (n, f))
    x[:, 3] = 0.5  # a unit that reads one value on every node
    grad = torch.randn(rows.numel(), f, generator=gen)
    xs = x.clone().requires_grad_(True)
    sub = smx.segment_max(xs, block.indptr, block.edge_dst, g.symmetric, subset=True,
                          transpose=block.transpose)
    full = smx.segment_max(xs, g.indptr, g.edge_dst, g.symmetric)
    assert sub.shape == (rows.numel(), f) and torch.equal(sub, full[rows])
    assert (sub[-1] == 0).all() and block.degrees[-1] == 0
    (got,) = torch.autograd.grad(sub, xs, grad)
    (want,) = torch.autograd.grad(full, xs, torch.zeros_like(full).index_copy(0, rows, grad))
    assert torch.equal(got, want) and got.any()
    if not undirected:
        return
    out, rec = smx.segment_max_plain(x, block.indptr, block.edge_dst)
    is_full = (rec < -1) & (rec == -block.degrees[:, None])
    full_cols = is_full.any(0).to(torch.int32)
    assert full_cols[3] == 1
    routed = smx.segment_max_backward_plain(grad, x, out, torch.where(is_full, -1, rec),
                                            block.indptr, block.edge_dst)
    smx._add_full_ties_plain(routed, grad, rec, block.indptr, block.edge_dst, full_cols,
                             block.transpose)
    size = smx.segment_max_backward_plain(grad.abs(), x, out, rec, block.indptr, block.edge_dst)
    _assert_grads_close(routed, got, size)


def test_segment_max_takes_a_row_subset_only_when_told():
    g, rows = _subset_graph(400, 900, True, seed=18)
    block = row_block(g, rows)
    x = torch.rand(400, 8)
    with pytest.raises(ValueError, match="indptr must be"):
        smx.segment_max(x, block.indptr, block.edge_dst)
    with pytest.raises(ValueError, match="pass subset=True"):
        smx.segment_max(x, g.indptr, g.edge_dst, True, transpose=block.transpose)


def test_plain_route_matches_segment_max_csr_on_padded_edges():
    n, f = 400, 16
    pairs = _pairs(n, 700, seed=3)
    csr, indptr, edge_dst = _csr(n, pairs)
    e = edge_dst.numel()
    edge_pad = torch.cat([edge_dst, torch.zeros(60, dtype=torch.int32)])
    src = torch.cat([csr.src.to(torch.int32), torch.full((60,), n - 1, dtype=torch.int32)])
    mask = torch.arange(e + 60) < e
    x = VALUES["ties at 0"](torch.Generator().manual_seed(4), (n, f))
    want = segment_max_csr(gather(x, edge_pad), src, mask, n)
    assert torch.equal(smx.segment_max(x, indptr, edge_pad), want)


def _seeded_leaves(model, seed):
    """Glorot-uniform matrices and zero biases from ``seed``, in the order of
    ``named_parameters``."""
    g = torch.Generator().manual_seed(seed)
    leaves = {}
    for name, p in model.named_parameters():
        if p.dim() == 1:
            leaves[name] = torch.zeros_like(p)
        else:
            limit = math.sqrt(6.0 / sum(p.shape))
            leaves[name] = (torch.rand(p.shape, generator=g) * 2 - 1) * limit
    return leaves


def test_full_graph_maxpool_trainer_matches_the_reference():
    n, feats, classes, pool, hidden = 360, 20, 5, 24, (16, 16)
    pairs = _pairs(n, 1000, seed=5)
    rng = np.random.default_rng(6)
    labels = rng.integers(0, classes, n)
    x = rng.standard_normal((n, feats)).astype(np.float32)
    graph = build_graph(x, labels, pairs, num_classes=classes, device="cpu")
    assert graph.neighbors.shape[1] < HUB and int(graph.degrees.max()) >= HUB
    model = GraphSAGE(feats, classes, hidden, (None, None), aggregator="maxpool",
                      pool_dim=pool, concat_self=True, device="cpu")
    leaves = _seeded_leaves(model, seed=7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(leaves[name])
    trainer = FullGraphTrainer(model, graph, TrainConfig(
        learning_rate=0.01, optimizer="adam", seed=8, test_size=60, val_size=40))
    losses, first_grads = [], None
    for s in range(3):
        losses.append(float(trainer.step()))
        if s == 0:
            first_grads = {k: p.grad.clone() for k, p in model.named_parameters()}

    csr = Csr(torch.from_numpy(pairs), n)
    train = torch.from_numpy(trainer.train_nodes).long()
    names = list(leaves)
    ref = [leaves[k].clone().requires_grad_(True) for k in names]
    state = {}
    for s in range(3):
        p = dict(zip(names, ref))
        layers = [(p[f"layers.{i}.weight"], p[f"layers.{i}.pool_weight"],
                   p[f"layers.{i}.pool_bias"]) for i in range(2)]
        loss = cross_entropy(full_logits(torch.from_numpy(x), csr, layers, p["head"])[train],
                             torch.from_numpy(labels)[train])
        grads = torch.autograd.grad(loss, ref)
        assert losses[s] == pytest.approx(float(loss.detach()), rel=1e-5)
        if s == 0:
            for k, gk in zip(names, grads):
                torch.testing.assert_close(first_grads[k], gk, **TOL)
        with torch.no_grad():
            adam_step(ref, list(grads), state, 0.01)
    for k, r in zip(names, ref):
        torch.testing.assert_close(dict(model.named_parameters())[k].detach(), r.detach(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["forward_full_graph", "layer0_full_table"])
def test_cpu_full_graph_maxpool_runs_the_op(monkeypatch, path):
    """On the CPU the model's full-graph segment max is the op the card runs,
    looked up by name in ``graphsage_torch.models.graphsage`` at the call:
    ``_SegmentMax`` forward and its plain backward, once per layer. Its output
    equals ``segment_max_csr`` over the per-edge gather bitwise, and the
    leaves' gradients match that route's."""
    import graphsage_torch.models.graphsage as gs

    n, feats, classes = 360, 12, 4
    pairs = _pairs(n, 600, seed=9)
    rng = np.random.default_rng(10)
    graph = build_graph(rng.standard_normal((n, feats)).astype(np.float32),
                        rng.integers(0, classes, n), pairs, num_classes=classes, device="cpu")
    layer0 = "full" if path == "layer0_full_table" else "sampled"
    model = GraphSAGE(feats, classes, (16, 8), (None, None), aggregator="maxpool", pool_dim=24,
                      layer0=layer0, device="cpu")
    calls = {"forward": 0, "backward": 0}
    op, backward = gs.segment_max, smx.segment_max_backward_plain

    def counted(*args, **kwargs):
        out = op(*args, **kwargs)
        assert type(out.grad_fn).__name__ == "_SegmentMaxBackward"
        calls["forward"] += 1
        return out

    def counted_backward(*args):
        calls["backward"] += 1
        return backward(*args)

    monkeypatch.setattr(gs, "segment_max", counted)
    monkeypatch.setattr(smx, "segment_max_backward_plain", counted_backward)

    def per_edge(pooled):
        return segment_max_csr(gather(pooled, graph.edge_dst), graph.edge_src,
                               graph.edge_mask, graph.num_nodes)

    def run(segmax):
        model.zero_grad()
        if path == "forward_full_graph":
            out = model.forward_full_graph(graph, segmax_override=segmax)
        else:
            out = model.layer0_full_table(graph.features, graph, segmax=segmax)
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(11))
        (out * w).sum().backward()
        return out.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                              if p.grad is not None}

    got, got_grads = run(None)
    layers = model.num_layers if path == "forward_full_graph" else 1
    assert calls == {"forward": layers, "backward": layers}
    want, want_grads = run(per_edge)
    assert calls == {"forward": layers, "backward": layers}
    assert torch.equal(got, want)
    assert got_grads.keys() == want_grads.keys() and got_grads
    for k, gk in got_grads.items():
        torch.testing.assert_close(gk, want_grads[k], **TOL)


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _degrees_csr(deg, seed, dev):
    """CSR with the given row degrees and random ids; padding past
    ``indptr[N]`` holds ids the kernel must never read."""
    rng = np.random.default_rng(seed)
    deg = np.asarray(deg, np.int32)
    n = deg.size
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    edge_dst = np.full(-(-max(e, 1) // 128) * 128 + 128, 2**30, np.int32)
    edge_dst[:e] = rng.integers(0, n, e)
    return torch.from_numpy(indptr).to(dev), torch.from_numpy(edge_dst).to(dev)


CHUNK = sp.MIN_CHUNK
GRAPHS = {
    "star": [5000] + [0] * 5000,  # one row holding every edge
    "about a chunk": [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 5] * 6 + [1] * 9,
    "empty runs": [3] * 5 + [0] * 100 + [2 * CHUNK] + [0] * 70 + [CHUNK + 3, 0, 0, 4] + [0] * 40,
    "poisson with hubs": None,
    "tied hub": None,
}
# "tied hub": row 0 holds TIED_HUB slots (a tie count past any 16- or 17-bit
# field) and row 2 TIED_ROW slots (at least 3 chunks of at most MAX_CHUNK
# items), each over nodes whose rows the test sets to one positive value, so
# every slot of both rows ties in every column.
TIED_HUB, TIED_ROW = 2**17 + 3, 3 * sp.MAX_CHUNK + 7
HUB_NODES, ROW_NODES = slice(10, 74), slice(80, 100)


def _tied_hub_csr(dev):
    n = 20000
    rng = np.random.default_rng(5)
    deg = rng.poisson(3, n).astype(np.int32)
    deg[0], deg[1], deg[2] = TIED_HUB, 0, TIED_ROW
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    edge_dst = np.full(int(indptr[-1]) + 128, 2**30, np.int32)
    edge_dst[:indptr[-1]] = rng.integers(0, n, int(indptr[-1]))
    for row, nodes in ((0, HUB_NODES), (2, ROW_NODES)):
        edge_dst[indptr[row]:indptr[row + 1]] = rng.integers(nodes.start, nodes.stop, deg[row])
    return torch.from_numpy(indptr).to(dev), torch.from_numpy(edge_dst).to(dev)


def _graph(name, dev):
    if name == "symmetric with a hub":  # both directions of each pair
        _, indptr, edge_dst = _csr(20000, _pairs(20000, 100000, seed=4), dev)
        return indptr, edge_dst
    if name == "tied hub":
        return _tied_hub_csr(dev)
    if name == "poisson with hubs":
        deg = np.random.default_rng(1).poisson(12, 20000)
        deg[::7], deg[1], deg[5] = 0, 30000, 3000
        return _degrees_csr(deg, seed=2, dev=dev)
    return _degrees_csr(GRAPHS[name], seed=3, dev=dev)


def _plain_reference(x, indptr, edge_dst):
    """``segment_max_csr`` over the padded per-edge gather, as the sharded
    paths call it."""
    n = indptr.numel() - 1
    e = int(indptr[-1])
    deg = (indptr[1:] - indptr[:-1]).long()
    src = torch.repeat_interleave(torch.arange(n, device=x.device), deg)
    pad = edge_dst.numel() - e
    src = torch.cat([src, src.new_full((pad,), n - 1)])
    mask = torch.arange(edge_dst.numel(), device=x.device) < e
    safe = torch.where(mask, edge_dst, 0)
    return segment_max_csr(gather(x, safe), src, mask, n)


def _counted(fn):
    profiling.reset()
    profiling.enable()
    try:
        out = fn()
        torch.cuda.synchronize()
        counts = {e["name"]: e["args"]["value"]
                  for e in profiling.export()["traceEvents"] if e["ph"] == "C"}
    finally:
        profiling.disable()
        profiling.reset()
    return out, counts.get("agg.segment_max.panels")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,f,panel_bytes", [
    (torch.float32, 512, None),   # one pass
    (torch.float32, 45, None),    # one element a lane
    (torch.float32, 512, 128),    # 16 panels, 4 edges a load
    (torch.float32, 128, 256),    # 2 panels, 2 edges a load
    (torch.float32, 96, 128),     # 3 panels
    (torch.float32, 512, 1024),   # 2 panels of whole warp-wide pieces
    (torch.bfloat16, 512, None),
    (torch.bfloat16, 45, None),
    (torch.bfloat16, 128, 128),   # 2 panels, 4 edges a load
])
@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("values", list(VALUES))
def test_kernel_forward_equals_segment_max_csr(cuda, monkeypatch, values, graph, dtype, f,
                                               panel_bytes):
    indptr, edge_dst = _graph(graph, cuda)
    n = indptr.numel() - 1
    g = torch.Generator().manual_seed(f)
    x = VALUES[values](g, (n, f))
    if graph == "tied hub":
        x[HUB_NODES], x[ROW_NODES] = 2.5, 1.25
    x = x.to(cuda, dtype)
    if panel_bytes is None:
        monkeypatch.setattr(sp, "l2_bytes", lambda index: 1 << 40)
        num_panels = 1
    else:  # an L2 whose budget holds exactly one panel of panel_bytes a row
        monkeypatch.setattr(sp, "l2_bytes", lambda index: math.ceil(n * panel_bytes / sp.L2_SHARE))
        num_panels = f * x.element_size() // panel_bytes
    before = smx.launches
    (out, rec), panels = _counted(lambda: smx._launch(x, indptr, edge_dst))
    assert smx.launches == before + 1 and panels == num_panels
    assert torch.equal(out, _plain_reference(x, indptr, edge_dst))
    assert torch.equal(rec, smx.segment_max_plain(x, indptr, edge_dst)[1])
    again, rec_again = smx._launch(x, indptr, edge_dst)
    assert torch.equal(out, again) and torch.equal(rec, rec_again)  # no atomics: repeatable
    if graph == "tied hub":  # every slot ties: the whole count, across chunks and groups
        assert (rec[0] == -TIED_HUB).all() and (rec[2] == -TIED_ROW).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values", list(VALUES))
@pytest.mark.parametrize("graph", ["poisson with hubs", "about a chunk", "symmetric with a hub"])
def test_kernel_backward_equals_segment_max_csr(cuda, graph, values, dtype):
    indptr, edge_dst = _graph(graph, cuda)
    symmetric = graph.startswith("symmetric")  # full ties go to kernel 3
    n = indptr.numel() - 1
    g = torch.Generator().manual_seed(9)
    x = VALUES[values](g, (n, 64))
    x[:, 3] = 0.5  # a unit that reads one value on every node: every row ties in full
    x = x.to(cuda, dtype)
    grad = torch.randn(n, 64, generator=g).to(cuda, dtype)
    before = sp.launches
    got = _grad(lambda t: smx.segment_max(t, indptr, edge_dst, symmetric), x, grad)
    assert sp.launches == before + symmetric  # one CSR sum over the full ties' columns
    assert got.dtype == dtype
    # The plain route in f32 on the same values: the kernel splits a tie and
    # sums in f32 too, and rounds once to the table's dtype.
    plain = lambda t: _plain_reference(t, indptr, edge_dst)  # noqa: E731
    # A max of 0 sends nothing: only zeros lose their gradient.
    want = torch.where(x.float() == 0, 0.0, _grad(plain, x.float(), grad.float()))
    size = _grad(plain, x.float(), grad.float().abs())
    # bf16: one rounding of the f32 sum, half a unit in the last place.
    _assert_grads_close(got, want, size, 2.0**-8 if dtype == torch.bfloat16 else 0.0)


@pytest.mark.gpu
def test_full_graph_maxpool_step_runs_the_kernel_in_panels(cuda):
    n, feats, classes = 3000, 32, 7
    pairs = _pairs(n, 40000, seed=11)
    rng = np.random.default_rng(12)
    graph = build_graph(rng.standard_normal((n, feats)).astype(np.float32),
                        rng.integers(0, classes, n), pairs, num_classes=classes, device=cuda)
    model = GraphSAGE(feats, classes, (128, 128), (None, None), aggregator="maxpool",
                      pool_dim=512, concat_self=True, device=cuda)
    trainer = FullGraphTrainer(model, graph, TrainConfig(
        learning_rate=0.01, optimizer="adam", seed=13, test_size=300, val_size=200))
    before = smx.launches
    l2 = sp.l2_bytes(0)
    planned = sp.panels(n, 512, 4, l2, True)[0]
    loss, panels = _counted(trainer.step)
    assert math.isfinite(float(loss))
    assert smx.launches == before + 2 and panels == 2 * planned


@pytest.mark.gpu
@pytest.mark.parametrize("panel_bytes", [None, 128, 256])
@pytest.mark.parametrize("live", [0, 1, 31, 32, 33, 100, 128])
def test_kernel3_live_columns_write_the_live_panels_alone(cuda, monkeypatch, panel_bytes, live):
    """Kernel 3 given a column count on the card (``live_cols``): the panels
    that start before it equal the whole call's columns bitwise (the others
    are left unwritten); with no live column no block walks the CSR."""
    indptr, edge_dst = _graph("poisson with hubs", cuda)
    n, f = indptr.numel() - 1, 128
    x = torch.randn((n, f), generator=torch.Generator().manual_seed(16)).to(cuda)
    if panel_bytes is None:
        monkeypatch.setattr(sp, "l2_bytes", lambda index: 1 << 40)
        panel_cols = f
    else:
        monkeypatch.setattr(sp, "l2_bytes", lambda index: math.ceil(n * panel_bytes / sp.L2_SHARE))
        panel_cols = panel_bytes // 4
    whole = sp.spmm_block_sum(x, indptr, edge_dst)
    out = sp.spmm_block_sum(x, indptr, edge_dst,
                            live_cols=torch.tensor([live], dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    written = min(f, -(-live // panel_cols) * panel_cols)
    assert torch.equal(out[:, :written], whole[:, :written])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("panel_bytes", [None, 128])
@pytest.mark.parametrize("full", [[], [3, 17, 18, 39], list(range(0, 512, 7)), list(range(512))],
                         ids=["none", "one panel", "73 columns", "every column"])
def test_kernel_full_ties_equal_the_plain_route(cuda, monkeypatch, dtype, panel_bytes, full):
    """The card's full ties (``segment_max_full_cols`` around kernel 3, the
    columns' count left on the card) bitwise equal to the same steps in
    PyTorch ops, in one pass and in 16 panels of 32 columns."""
    indptr, edge_dst = _graph("symmetric with a hub", cuda)
    n, f = indptr.numel() - 1, 512
    if panel_bytes is None:
        monkeypatch.setattr(sp, "l2_bytes", lambda index: 1 << 40)
    else:
        monkeypatch.setattr(sp, "l2_bytes", lambda index: math.ceil(n * panel_bytes / sp.L2_SHARE))
    g = torch.Generator().manual_seed(17)
    x = torch.rand((n, f), generator=g)
    x[:, full] = 0.5
    x = x.to(cuda, dtype)
    grad = torch.randn((n, f), generator=g).to(cuda, dtype)
    out, rec = smx._launch(x, indptr, edge_dst)
    deg = (indptr[1:] - indptr[:-1])[:, None]
    full_cols = ((rec < -1) & (rec == -deg)).any(0).to(torch.int32)
    # bf16 rows tie by chance too (a low-degree row's two equal values)
    assert set(full) <= set(torch.nonzero(full_cols).reshape(-1).tolist())
    got = torch.zeros((n, f), dtype=torch.float32, device=cuda)
    want = torch.zeros_like(got)
    smx._add_full_ties(got, grad, rec, indptr, edge_dst, full_cols)
    smx._add_full_ties_plain(want, grad, rec, indptr, edge_dst, full_cols)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("undirected", [True, False], ids=["symmetric", "directed"])
def test_kernel_over_a_row_subset_matches_the_plain_route(cuda, undirected):
    """The kernel over a row block (a hub, a row with no edge, a full-tie
    column): the forward bitwise equal to the plain route's and to the full
    call's rows; the backward, whose full ties on a symmetric graph go
    through kernel 3 over the block's transpose (one launch), against the
    plain full backward of a gradient on the rows alone."""
    n, f = 20000, 64
    g, rows = _subset_graph(n, 100000, undirected, seed=4, dev=cuda)
    block = row_block(g, rows)
    gen = torch.Generator().manual_seed(20)
    x = torch.relu(torch.randn((n, f), generator=gen))
    x[:, 3] = 0.5  # every row ties with all its neighbours there
    x = x.to(cuda)
    grad = torch.randn((rows.numel(), f), generator=gen).to(cuda)
    xs = x.clone().requires_grad_(True)
    sub = smx.segment_max(xs, block.indptr, block.edge_dst, g.symmetric, subset=True,
                          transpose=block.transpose)
    assert torch.equal(sub, smx.segment_max_plain(x, block.indptr, block.edge_dst)[0])
    assert torch.equal(sub, smx._launch(x, g.indptr, g.edge_dst)[0][rows])
    before = sp.launches
    (got,) = torch.autograd.grad(sub, xs, grad)
    torch.cuda.synchronize()
    assert sp.launches == before + undirected
    plain = lambda t: _plain_reference(t, g.indptr, g.edge_dst)  # noqa: E731
    wide = torch.zeros((n, f), device=cuda).index_copy(0, rows, grad)
    want = torch.where(x == 0, 0.0, _grad(plain, x, wide))
    size = _grad(plain, x, wide.abs())
    _assert_grads_close(got, want, size)
    assert got.any()
