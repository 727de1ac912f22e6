"""The port's aggregation ops and the plain versions of its kernels against
the JAX package: kernel 1's plain version against the Pallas one-hot kernel
in interpret mode, kernel 3's against the Pallas CSR SpMM in interpret mode
(also at a hub row longer than any of the kernel's chunks, forward and
symmetric backward), and every dispatcher ``impl`` name against JAX; the
launch plans the wrappers of kernels 3 and 4 compute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphsage_torch.ops.gather_dma as gd
import graphsage_torch.ops.gather_mean as gm
import graphsage_torch.ops.scatter_mean as sm
import graphsage_torch.ops.spmm as sp
from graphsage_tpu.data.graph import build_graph as jax_build_graph
from graphsage_tpu.ops.aggregate import gather_mean as jax_gather_mean
from graphsage_tpu.ops.aggregate import masked_mean as jax_masked_mean
from graphsage_tpu.ops.aggregate import segment_mean_csr as jax_segment_mean_csr
from graphsage_tpu.ops.aggregate import spmm_mean as jax_spmm_mean
from graphsage_tpu.ops.pallas_gather import gather_mean as gather_mean_dma_pallas
from graphsage_tpu.ops.pallas_onehot import onehot_gather_mean
from graphsage_tpu.ops.pallas_spmm import _spmm_impl, spmm_mean_vmem
from graphsage_torch.data.graph import build_graph, row_block
from graphsage_torch.ops.aggregate import (
    gather_mean,
    masked_mean,
    segment_mean_csr,
    spmm_mean,
)

torch.set_num_threads(1)

# Kernel 1 (f32 sums of at most 6 rows) and kernel 3 against Pallas.
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(91, 45)).astype(np.float32)
    idx = rng.integers(0, 91, size=(21, 6)).astype(np.int32)
    mask = rng.random((21, 6)) < 0.7
    mask[3] = False  # an all-masked row
    return feats, idx, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_mean_plain_matches_pallas_kernel(case, bf16):
    feats, idx, mask = case
    want = np.asarray(onehot_gather_mean(
        jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(mask), 8, 32, bf16, True))
    x, i, m = _t(feats, idx, mask)
    table = x.to(torch.bfloat16) if bf16 else x
    np.testing.assert_allclose(gm.gather_mean_plain(table, i, m).numpy(), want, **TOL)
    # The wrapper on CPU tensors: the plain version, and no kernel launch.
    before = gm.launches
    got = gm.gather_mean(x, i, m, bf16=bf16)
    assert gm.launches == before and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got[3].numpy(), 0.0)


def test_sum_modes_plain_match_jax_sums(case):
    """``normalize=False``: kernel 1's plain version is JAX's masked mean
    times the valid count (the sum), kernel 2's adds each valid slot's
    cotangent row with unit weight; through the wrapper the sum mode's
    gradient is the scatter's sum mode."""
    feats, idx, mask = case
    cnt = np.maximum(mask.sum(axis=1, keepdims=True), 1).astype(np.float32)
    mean = np.asarray(jax_masked_mean(jnp.asarray(feats)[jnp.asarray(idx)], jnp.asarray(mask)))
    x, i, m = _t(feats, idx, mask)
    got = gm.gather_mean_plain(x, i, m, normalize=False)
    np.testing.assert_allclose(got.numpy(), mean * cnt, **TOL)
    g = np.random.default_rng(1).normal(size=(21, 45)).astype(np.float32)
    want = np.zeros_like(feats)
    for b, j in zip(*np.nonzero(mask)):
        want[idx[b, j]] += g[b]
    np.testing.assert_allclose(
        sm.scatter_mean_plain(torch.from_numpy(g), i, m, 91, normalize=False).numpy(), want,
        **TOL)
    xg = x.clone().requires_grad_(True)
    before = (gm.launches, sm.launches)
    gm.gather_mean(xg, i, m, normalize=False).backward(torch.from_numpy(g))
    assert (gm.launches, sm.launches) == before
    np.testing.assert_allclose(xg.grad.numpy(), want, **TOL)


def test_gather_mean_plain_ignores_ids_in_masked_slots(case):
    feats, idx, mask = case
    garbage = np.where(mask, idx, 10**6).astype(np.int32)
    x, i, g, m = _t(feats, idx, garbage, mask)
    torch.testing.assert_close(gm.gather_mean_plain(x, g, m), gm.gather_mean_plain(x, i, m))


@pytest.mark.parametrize("impl", ["auto", "onehot_pallas", "take", "unrolled"])
def test_gather_mean_impls_match_jax(case, impl):
    feats, idx, mask = case
    jf, ji, jm = jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(mask)
    if impl == "onehot_pallas":  # the TPU kernel, interpreted on the CPU
        want = onehot_gather_mean(jf, ji, jm, 8, 32, False, True)
    else:
        want = jax_gather_mean(jf, ji, jm, impl=impl)
    got = gather_mean(*_t(feats, idx, mask), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_mean_dma_and_unknown_impls(case):
    feats, idx, mask = case
    want = gather_mean_dma_pallas(jnp.asarray(feats), jnp.asarray(idx),
                                  jnp.asarray(mask), 8, True)
    args = _t(*case)
    before = gd.launches
    got = gather_mean(*args, impl="dma")
    assert gd.launches == before and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        gather_mean(*args, impl="nope")


def test_masked_mean_matches_jax(case):
    feats, idx, mask = case
    x = feats[idx]
    np.testing.assert_allclose(
        masked_mean(*_t(x, mask)).numpy(),
        np.asarray(jax_masked_mean(jnp.asarray(x), jnp.asarray(mask))), **TOL)


@pytest.fixture(scope="module")
def csr():
    """A graph with hubs and isolated nodes, built by both packages."""
    rng = np.random.default_rng(3)
    n = 70
    edges = np.concatenate([rng.integers(0, 60, (150, 2)),
                            [[0, i] for i in range(1, 40)]])  # node 0: a hub
    feats = rng.normal(size=(n, 12)).astype(np.float32)  # nodes 60..69 isolated
    labels = np.zeros(n)
    return (jax_build_graph(feats, labels, edges, num_classes=1),
            build_graph(feats, labels, edges, num_classes=1, device="cpu"),
            rng.normal(size=(n, 24)).astype(np.float32))


@pytest.mark.parametrize("normalize", [True, False])
def test_spmm_plain_matches_pallas_kernel(csr, normalize):
    jg, tg, x = csr
    if normalize:
        want = spmm_mean_vmem(jnp.asarray(x), jg.indptr, jg.edge_dst, True, 8, True)
    else:
        want = _spmm_impl(jnp.asarray(x), jg.indptr, jg.edge_dst,
                          normalize=False, interpret=True)
    got = sp.spmm_mean_plain(torch.from_numpy(x), tg.indptr, tg.edge_dst, normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[60:].numpy(), 0.0)
    before = sp.launches
    got2 = sp.spmm_mean(torch.from_numpy(x), tg.indptr, tg.edge_dst, normalize)
    assert sp.launches == before
    torch.testing.assert_close(got2, got)


@pytest.fixture(scope="module")
def star():
    """An undirected star: node 0 has 400 leaves, a row longer than any of
    the kernel's merge-path chunks at this size; nodes 401..409 isolated."""
    rng = np.random.default_rng(5)
    n = 410
    edges = np.array([[0, i] for i in range(1, 401)])
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    labels = np.zeros(n)
    return (jax_build_graph(feats, labels, edges, num_classes=1),
            build_graph(feats, labels, edges, num_classes=1, device="cpu"),
            rng.normal(size=(n, 16)).astype(np.float32))


@pytest.mark.parametrize("normalize", [True, False])
def test_spmm_plain_matches_pallas_kernel_at_a_hub(star, normalize):
    jg, tg, x = star
    hub = int(tg.indptr[1] - tg.indptr[0])
    assert hub == 400 and hub > sp.chunking(tg.num_nodes + tg.edge_dst.numel())[0]
    want = _spmm_impl(jnp.asarray(x), jg.indptr, jg.edge_dst, normalize=normalize,
                      interpret=True)
    got = sp.spmm_mean(torch.from_numpy(x), tg.indptr, tg.edge_dst, normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[401:].numpy(), 0.0)


def test_spmm_symmetric_backward_matches_pallas_at_a_hub(star):
    jg, tg, x = star
    g = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def jax_loss(feats):
        out = spmm_mean_vmem(feats, jg.indptr, jg.edge_dst, True, 8, True)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    assert tg.symmetric
    sp.spmm_mean(xt, tg.indptr, tg.edge_dst, symmetric=True).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)


@pytest.mark.parametrize("items", [1, 15, 16, 17, 13588, 108421, 10**6, 2**31 - 1])
def test_spmm_chunking_covers_every_item(items):
    chunk, num_chunks = sp.chunking(items)
    assert sp.MIN_CHUNK <= chunk <= sp.MAX_CHUNK
    assert (num_chunks - 1) * chunk < items <= num_chunks * chunk
    # The kernel's diagonals c * chunk stay in int32.
    assert (num_chunks - 1) * chunk < 2**31


@pytest.mark.parametrize("b,k,want", [
    (2560, 10, 1),    # Cora's frontier: too few rows to share warps
    (25600, 10, 3),   # Pubmed's: 32 // 10
    (25600, 25, 1),
    (10**6, 40, 1),   # more than 32 slots: one row per warp
    (10**6, 1, 32),
    (32769, 3, 4),    # 32769 // 8192
    (5, 0, 1),
])
def test_rows_per_warp(b, k, want):
    r = gd.rows_per_warp(b, k)
    assert r == want
    assert r == 1 or r * k <= 32  # one ballot covers the warp's slots


# Whole-row copies need rows of a multiple of 16 bytes (F % 4 == 0 in f32,
# F % 8 == 0 in bf16).
@pytest.mark.parametrize("f,whole_rows,itemsize", [
    (f, whole, size) for size in (4, 2)
    for f in (1, 3, 45, 64, 128, 129, 500, 512, 513, 602, 1433, 2048, 3703)
    for whole in (True, False) if not (whole and (f * size) % 16)])
def test_dma_plan_fits_every_copy(f, whole_rows, itemsize):
    p = gd.plan(25600, 10, f, whole_rows, itemsize)
    width = min(f, 128 * p.chunks)
    assert p.chunks in gd.CHUNKS and (width == f or p.chunks == gd.CHUNKS[-1])
    assert 2 <= p.stages <= gd.MAX_STAGES and p.stage_bytes % 16 == 0
    assert p.rows_per_warp == 3
    # The widest copy of a pass: the row itself, or its 16-byte-aligned
    # envelope from any element-aligned start.
    for start in ((0,) if whole_rows else range(0, 16, itemsize)):
        lo, hi = 0, -(-(start + itemsize * width) // 16) * 16
        assert hi - lo <= p.stage_bytes
    # A block's barriers and rings fit the shared memory of one SM.
    warps = gd.WARPS_PER_BLOCK
    assert warps * p.stages * (8 + p.stage_bytes) + 16 <= 227 * 1024


def test_dma_plan_at_the_main_widths():
    assert gd.plan(25600, 10, 128, True) == (3, 1, 4, 512)
    assert gd.plan(25600, 10, 500, True) == (3, 4, 2, 2000)
    assert gd.plan(2560, 10, 1433, False) == (1, 16, 2, 5760)
    # bf16: 8 stages of a 128-wide row; Reddit's 602 columns take envelopes.
    assert gd.plan(25600, 10, 128, True, 2) == (3, 1, 8, 256)
    assert gd.plan(128000, 10, 602, False, 2) == (3, 16, 2, 1232)


@pytest.mark.parametrize("impl", ["auto", "pallas_vmem", "xla"])
def test_spmm_impls_match_jax(csr, impl):
    jg, tg, x = csr
    want = jax_spmm_mean(jnp.asarray(x), jg.edge_src, jg.edge_dst, jg.edge_mask,
                         jg.num_nodes, indptr=jg.indptr, impl=impl)
    got = spmm_mean(torch.from_numpy(x), tg.edge_src, tg.edge_dst, tg.edge_mask,
                    tg.num_nodes, indptr=tg.indptr, impl=impl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spmm_dispatch_errors(csr):
    _, tg, x = csr
    args = (torch.from_numpy(x), tg.edge_src, tg.edge_dst, tg.edge_mask, tg.num_nodes)
    with pytest.raises(ValueError, match="indptr"):
        spmm_mean(*args)
    with pytest.raises(ValueError):
        spmm_mean(*args, indptr=tg.indptr, impl="nope")


def _subset_case(undirected):
    """A graph with a hub and isolated nodes (60..69), symmetric or with one
    direction of each pair, and rows that hold the hub, rows with no edge
    and rows whose neighbours lie outside them."""
    rng = np.random.default_rng(8)
    n = 70
    edges = np.concatenate([rng.integers(0, 60, (150, 2)), [[0, i] for i in range(1, 40)]])
    if not undirected:
        edges = edges[edges[:, 0] < edges[:, 1]]
    g = build_graph(rng.normal(size=(n, 3)).astype(np.float32), np.zeros(n), edges,
                    num_classes=1, undirected=undirected, device="cpu")
    rows = torch.tensor(sorted(set(range(0, n, 3)) | {0, 61, 62}))
    return g, rows, torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("undirected", [True, False], ids=["symmetric", "directed"])
def test_spmm_over_a_row_subset_equals_the_full_calls_rows(impl, undirected):
    """``spmm_mean`` over a row block (its CSR, local ``edge_src``, and on a
    symmetric graph its transpose for the backward): the full call's rows,
    and, for a gradient on those rows alone, the full call's backward,
    bitwise (the same sums in the same order, less terms of 0)."""
    g, rows, x = _subset_case(undirected)
    block = row_block(g, rows)
    assert (block.transpose is not None) == undirected and g.symmetric == undirected
    assert torch.equal(block.degrees, g.degrees[rows])
    xs = x.clone().requires_grad_(True)
    full = spmm_mean(xs, g.edge_src, g.edge_dst, g.edge_mask, g.num_nodes, indptr=g.indptr,
                     impl=impl, symmetric=g.symmetric)
    sub = spmm_mean(xs, block.edge_src, block.edge_dst, block.edge_mask, block.num_rows,
                    indptr=block.indptr, impl=impl, symmetric=g.symmetric, subset=True,
                    transpose=block.transpose)
    assert sub.shape == (rows.numel(), x.shape[1]) and torch.equal(sub, full[rows])
    assert not sub[-2:].any() and sub[0].any()  # rows 61, 62 have no edge; 0 is the hub
    grad = torch.randn(sub.shape, generator=torch.Generator().manual_seed(1))
    (got,) = torch.autograd.grad(sub, xs, grad)
    (want,) = torch.autograd.grad(full, xs, torch.zeros_like(full).index_copy(0, rows, grad))
    assert torch.equal(got, want) and got.any()


def test_spmm_takes_a_row_subset_only_when_told():
    g, rows, x = _subset_case(True)
    block = row_block(g, rows)
    with pytest.raises(ValueError, match="indptr must be"):
        sp.spmm_mean(x, block.indptr, block.edge_dst)
    with pytest.raises(ValueError, match="pass subset=True"):
        sp.spmm_mean(x, g.indptr, g.edge_dst, transpose=block.transpose)
    with pytest.raises(ValueError, match="indptr must be"):  # a transpose of the wrong rows
        sp.spmm_mean(x, block.indptr, block.edge_dst, subset=True,
                     transpose=(block.indptr, block.transpose[1]))


def test_segment_mean_csr_matches_jax(csr):
    jg, tg, x = csr
    per_edge = x[np.asarray(jg.edge_dst)]
    want = jax_segment_mean_csr(jnp.asarray(per_edge), jg.edge_src, jg.edge_mask,
                                jg.num_nodes)
    got = segment_mean_csr(torch.from_numpy(per_edge), tg.edge_src, tg.edge_mask,
                           tg.num_nodes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(case, csr):
    x, i, m = _t(*case)
    bad_gather = [
        (TypeError, (x.double(), i, m)),
        (TypeError, (x, i.long(), m)),
        (TypeError, (x, i, m.int())),
        (ValueError, (x, i, m[:, :3])),
        (ValueError, (x[0], i, m)),
        (ValueError, (x.t(), i, m)),
    ]
    for err, args in bad_gather:
        with pytest.raises(err):
            gm.gather_mean(*args)
    _, tg, feats = csr
    f = torch.from_numpy(feats)
    bad_spmm = [
        (TypeError, (f.double(), tg.indptr, tg.edge_dst)),
        (TypeError, (f, tg.indptr.long(), tg.edge_dst)),
        (ValueError, (f, tg.indptr[:-1], tg.edge_dst)),
        (ValueError, (f, tg.indptr, tg.edge_dst[None])),
        (ValueError, (f.t().contiguous().t(), tg.indptr, tg.edge_dst)),
    ]
    for err, args in bad_spmm:
        with pytest.raises(err):
            sp.spmm_mean(*args)
