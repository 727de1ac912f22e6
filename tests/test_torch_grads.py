"""Gradients of the port's aggregation ops against the JAX package on the CPU.

The port's backward formulas run on the CPU through the same
``autograd.Function`` as on the card, with the plain versions of the kernels:
the scatter-mean (the gather-mean backward, kernel 2) against the Pallas
transposed one-hot kernel in interpret mode and against ``jax.vjp`` of the
JAX ``gather_mean``; the DMA route against ``pallas_gather.gather_mean`` in
interpret mode; the CSR SpMM backward against ``jax.vjp`` of
``spmm_mean_vmem`` in interpret mode, symmetric and directed."""

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
from graphsage_tpu.ops.aggregate import spmm_mean as jax_spmm_mean
from graphsage_tpu.ops.pallas_gather import gather_mean as gather_mean_dma_pallas
from graphsage_tpu.ops.pallas_onehot import _onehot_scatter_mean_grad
from graphsage_tpu.ops.pallas_spmm import spmm_mean_vmem
from graphsage_torch.data.graph import build_graph
from graphsage_torch.ops.aggregate import gather_mean, spmm_mean

torch.set_num_threads(1)

# f32 sums of at most a few dozen rows, taken in other orders.
TOL = dict(rtol=1e-5, atol=1e-6)
N, F, B, K = 91, 45, 21, 6


@pytest.fixture(scope="module")
def case():
    """Table, frontier (row 3 all masked, rows 5..7 every slot on node 2:
    repeated ids) and a cotangent. Masked slots hold in-range ids so that the
    JAX formulas, which read every slot, see valid indices."""
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(N, F)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, K)).astype(np.int32)
    mask = rng.random((B, K)) < 0.7
    mask[3] = False
    idx[5:8], mask[5:8] = 2, True
    g = rng.normal(size=(B, F)).astype(np.float32)
    return feats, idx, mask, g


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _jax_grad(fn, feats, g):
    _, vjp = jax.vjp(fn, jnp.asarray(feats))
    return np.asarray(vjp(jnp.asarray(g))[0])


def test_scatter_mean_plain_matches_pallas_scatter_kernel(case):
    feats, idx, mask, g = case
    want = _onehot_scatter_mean_grad(jnp.asarray(g), jnp.asarray(idx),
                                     jnp.asarray(mask), N, interpret=True)
    got = sm.scatter_mean_plain(*_t(g, idx, mask), N)
    assert got.dtype == torch.float32 and got.shape == (N, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scatter_mean_matches_jax_gather_mean_vjp(case):
    feats, idx, mask, g = case
    want = _jax_grad(
        lambda x: jax_gather_mean(x, jnp.asarray(idx), jnp.asarray(mask), "take"),
        feats, g)
    before = sm.launches
    got = sm.scatter_mean(*_t(g, idx, mask), N)
    assert sm.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_scatter_mean_never_reads_ids_in_masked_slots(case):
    _, idx, mask, g = case
    want = sm.scatter_mean_plain(*_t(g, idx, mask), N)
    junk = idx.copy()
    junk[~mask] = np.random.default_rng(0).choice([-7, N, 2**30], size=int((~mask).sum()))
    torch.testing.assert_close(sm.scatter_mean(*_t(g, junk, mask), N), want)


@pytest.mark.parametrize("impl", ["auto", "onehot_pallas", "take", "unrolled", "dma"])
def test_gather_mean_gradient_matches_jax(case, impl):
    feats, idx, mask, g = case
    want = _jax_grad(
        lambda x: jax_gather_mean(x, jnp.asarray(idx), jnp.asarray(mask), "take"),
        feats, g)
    x = torch.from_numpy(feats).requires_grad_(True)
    out = gather_mean(x, *_t(idx, mask), impl=impl)
    if impl in ("auto", "onehot_pallas", "dma"):
        # The kernel routes run the card's backward through one Function.
        assert "GatherMean" in out.grad_fn.name()
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(x.grad.numpy(), want, **TOL)


def test_gather_mean_gradient_keeps_a_bf16_tables_dtype(case):
    feats, idx, mask, g = case
    x16 = torch.from_numpy(feats).to(torch.bfloat16).requires_grad_(True)
    gm.gather_mean(x16, *_t(idx, mask)).backward(torch.from_numpy(g))
    assert x16.grad.dtype == torch.bfloat16
    # f32 sums, rounded once at the end.
    torch.testing.assert_close(
        x16.grad, sm.scatter_mean_plain(*_t(g, idx, mask), N).to(torch.bfloat16),
        rtol=0, atol=0)
    # bf16=True rounds an f32 table first; the gradient stays f32.
    x = torch.from_numpy(feats).requires_grad_(True)
    gm.gather_mean(x, *_t(idx, mask), bf16=True).backward(torch.from_numpy(g))
    assert x.grad.dtype == torch.float32


def test_gather_mean_dma_forward_and_gradient_match_pallas(case):
    feats, idx, mask, g = case

    def pallas(x):
        return gather_mean_dma_pallas(x, jnp.asarray(idx), jnp.asarray(mask), 8, True)

    want_out, vjp = jax.vjp(pallas, jnp.asarray(feats))
    want_grad = np.asarray(vjp(jnp.asarray(g))[0])
    x = torch.from_numpy(feats).requires_grad_(True)
    before = (gd.launches, sm.launches)
    out = gd.gather_mean_dma(x, *_t(idx, mask))
    out.backward(torch.from_numpy(g))
    assert (gd.launches, sm.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, **TOL)


@pytest.fixture(scope="module")
def graphs():
    """An undirected graph with a hub and isolated nodes, built by both
    packages, and a directed CSR (edges u -> v with u < v only)."""
    rng = np.random.default_rng(5)
    n = 60
    edges = np.concatenate([rng.integers(0, 50, (120, 2)),
                            [[0, i] for i in range(1, 30)]])
    feats = rng.normal(size=(n, 10)).astype(np.float32)  # nodes 50..59 isolated
    labels = np.zeros(n)
    jg = jax_build_graph(feats, labels, edges, num_classes=1)
    tg = build_graph(feats, labels, edges, num_classes=1, device="cpu")
    e = tg.num_edges
    src, dst = tg.edge_src[:e].numpy(), tg.edge_dst[:e].numpy()
    keep = src < dst
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(src[keep], minlength=n), out=indptr[1:])
    directed = (indptr, dst[keep].astype(np.int32))
    x = rng.normal(size=(n, 14)).astype(np.float32)
    g = rng.normal(size=(n, 14)).astype(np.float32)
    return jg, tg, directed, x, g


@pytest.mark.parametrize("symmetric", [True, False])
def test_spmm_gradient_matches_pallas_vjp(graphs, symmetric):
    jg, tg, directed, x, g = graphs
    if symmetric:
        indptr, edge_dst = np.asarray(jg.indptr), np.asarray(jg.edge_dst)
    else:
        indptr, edge_dst = directed
    want_out, vjp = jax.vjp(
        lambda v: spmm_mean_vmem(v, jnp.asarray(indptr), jnp.asarray(edge_dst),
                                 symmetric, 8, True),
        jnp.asarray(x))
    want_grad = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    before = sp.launches
    out = sp.spmm_mean(xt, *_t(indptr, edge_dst), symmetric=symmetric)
    assert "SpmmMean" in out.grad_fn.name()
    out.backward(torch.from_numpy(g))
    assert sp.launches == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, **TOL)
    # The plain forward's own autograd gives the same gradient.
    xp = torch.from_numpy(x).requires_grad_(True)
    sp.spmm_mean_plain(xp, *_t(indptr, edge_dst)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), xp.grad.numpy(), **TOL)


@pytest.mark.parametrize("impl", ["auto", "pallas_vmem", "xla"])
def test_spmm_dispatcher_gradient_matches_jax(graphs, impl):
    jg, tg, _, x, g = graphs
    want = _jax_grad(
        lambda v: jax_spmm_mean(v, jg.edge_src, jg.edge_dst, jg.edge_mask,
                                jg.num_nodes, indptr=jg.indptr, impl=impl),
        x, g)
    xt = torch.from_numpy(x).requires_grad_(True)
    spmm_mean(xt, tg.edge_src, tg.edge_dst, tg.edge_mask, tg.num_nodes,
              indptr=tg.indptr, impl=impl, symmetric=tg.symmetric
              ).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)
    assert np.all(xt.grad[50:].numpy() == 0)  # isolated nodes get nothing
