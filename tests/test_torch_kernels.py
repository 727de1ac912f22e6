"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
without one. This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

import graphsage_torch.ops.gather_dma as gd
import graphsage_torch.ops.gather_mean as gm
import graphsage_torch.ops.scatter_mean as sm
import graphsage_torch.ops.spmm as sp
from graphsage_torch.ops.aggregate import gather_mean, spmm_mean
from graphsage_torch.utils import profiling

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

# The kernels and their plain versions sum in different orders (the scatter
# with atomics, in an order that changes from run to run).
TOL = dict(rtol=1e-5, atol=1e-5)
# A bf16 gradient is an f32 sum rounded once to bf16: sums in another order
# may round to the neighbouring bf16 value, one step of 2**-7 relative.
BF16_GRAD_TOL = dict(rtol=2.0**-7, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gather_case(n, f, b, k, seed, dev, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, f), dtype=np.float32))
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    mask = rng.random((b, k)) < 0.7
    if b:
        mask[0] = False  # an all-masked row
    # Masked slots hold ids the kernel must never read.
    idx[~mask] = rng.choice([-3, n, 2**30], size=int((~mask).sum()))
    return (x.to(device=dev, dtype=dtype), torch.from_numpy(idx).to(dev),
            torch.from_numpy(mask).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,f,b,k", [
    (50, 1, 40, 3),        # scalar loads
    (91, 45, 21, 6),       # F not a multiple of 4
    (2708, 128, 2560, 10),  # Cora serving shape (16-byte loads)
    (300, 500, 256, 10),   # Pubmed mean-first width (8-byte bf16 loads)
    (400, 1433, 64, 10),   # Cora mean-first width
    (120, 64, 33, 40),     # more than 32 slots per row
    (300, 602, 256, 10),   # Reddit's width (bf16 pairs, f32 pairs)
])
def test_gather_mean_kernel_matches_plain(cuda, dtype, n, f, b, k):
    x, idx, mask = _gather_case(n, f, b, k, seed=n + f, dev=cuda, dtype=dtype)
    before = gm.launches
    got = gm.gather_mean(x, idx, mask)
    torch.cuda.synchronize()
    assert gm.launches == before + 1
    want = gm.gather_mean_plain(x.float(), idx, mask)
    assert got.dtype == torch.float32 and got.shape == (b, f)
    torch.testing.assert_close(got, want, **TOL)
    assert (got[0] == 0).all()


def test_gather_mean_kernel_unaligned_table(cuda):
    # A view starting one element in is not 16-byte aligned: scalar loads.
    _, idx, mask = _gather_case(64, 128, 30, 5, seed=1, dev=cuda)
    table = torch.randn(64 * 128 + 1, device=cuda)[1:].view(64, 128)
    assert table.is_contiguous() and table.data_ptr() % 16 != 0
    got = gm.gather_mean(table, idx, mask)
    torch.testing.assert_close(got, gm.gather_mean_plain(table, idx, mask), **TOL)


def test_gather_mean_bf16_flag_and_dispatch(cuda):
    x, idx, mask = _gather_case(200, 128, 64, 8, seed=2, dev=cuda)
    got = gather_mean(x, idx, mask, impl="auto", bf16=True)
    want = gm.gather_mean_plain(x.to(torch.bfloat16).float(), idx, mask)
    torch.testing.assert_close(got, want, **TOL)
    for impl in ("onehot_pallas", "take", "unrolled"):
        safe = torch.where(mask, idx, 0)
        torch.testing.assert_close(
            gather_mean(x, safe, mask, impl=impl),
            gm.gather_mean_plain(x, idx, mask), **TOL)


def test_gather_mean_empty_batch(cuda):
    x, idx, mask = _gather_case(20, 8, 0, 4, seed=3, dev=cuda)
    before = gm.launches
    assert gm.gather_mean(x, idx, mask).shape == (0, 8)
    assert gm.launches == before


def test_gather_mean_rejects_what_the_kernel_does_not_take(cuda):
    x, idx, mask = _gather_case(20, 8, 4, 3, seed=4, dev=cuda)
    with pytest.raises(TypeError):
        gm.gather_mean(x.double(), idx, mask)
    with pytest.raises(TypeError):
        gm.gather_mean(x, idx.long(), mask)
    with pytest.raises(ValueError):
        gm.gather_mean(x, idx.t(), mask.t())
    with pytest.raises(ValueError):
        gm.gather_mean(x, idx, mask.cpu())


SCATTER_SHAPES = [
    (50, 1, 40, 3),          # scalar atomics
    (91, 45, 21, 6),         # F not a multiple of 4
    (2708, 128, 2560, 10),   # Cora training layer 0 (16-byte atomics)
    (19717, 128, 25600, 10),  # Pubmed training layer 0
    (120, 64, 33, 40),       # more than 32 slots per row
]


@pytest.mark.parametrize("n,f,b,k", SCATTER_SHAPES)
def test_scatter_mean_kernel_matches_plain(cuda, n, f, b, k):
    _, idx, mask = _gather_case(n, f, b, k, seed=n + k, dev=cuda)
    if b > 4:  # every slot of rows 1..3 on one id: colliding atomics
        idx[1:4], mask[1:4] = 2, True
    g = torch.randn(b, f, generator=torch.Generator().manual_seed(n)).to(cuda)
    before = sm.launches
    got = sm.scatter_mean(g, idx, mask, n)
    torch.cuda.synchronize()
    assert sm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, f)
    torch.testing.assert_close(got, sm.scatter_mean_plain(g, idx, mask, n), **TOL)


def test_scatter_mean_kernel_unaligned_cotangent(cuda):
    _, idx, mask = _gather_case(64, 128, 30, 5, seed=6, dev=cuda)
    g = torch.randn(30 * 128 + 1, device=cuda)[1:].view(30, 128)
    assert g.is_contiguous() and g.data_ptr() % 16 != 0
    torch.testing.assert_close(sm.scatter_mean(g, idx, mask, 64),
                               sm.scatter_mean_plain(g, idx, mask, 64), **TOL)


# The sum modes (normalize=False): the owner side of the node-sharded
# feature store's exchange (parallel/feature_store.py) at its shapes: an
# owner serves S * B_loc requests, most of them for rows it does not own.
SUM_SHAPES = [
    (91, 45, 21, 6),          # F not a multiple of 4
    (1360, 128, 5120, 10),    # Cora's shard at S = 2 (project-first rows)
    (19717, 128, 25600, 10),  # Pubmed at S = 1
    (120, 64, 33, 40),        # more than 32 slots per row
    (400, 1433, 64, 1),       # row lookups: one slot per request
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,f,b,k", SUM_SHAPES)
def test_gather_sum_mode_matches_plain(cuda, dtype, n, f, b, k):
    x, idx, mask = _gather_case(n, f, b, k, seed=n + k + 3, dev=cuda, dtype=dtype)
    before = gm.launches
    got = gm.gather_mean(x, idx, mask, normalize=False)
    torch.cuda.synchronize()
    assert gm.launches == before + 1 and got.dtype == torch.float32
    want = gm.gather_mean_plain(x, idx, mask, normalize=False)
    torch.testing.assert_close(got, want, **TOL)
    # A second launch sums in the same order.
    assert torch.equal(got, gm.gather_mean(x, idx, mask, normalize=False))


@pytest.mark.parametrize("n,f,b,k", SUM_SHAPES)
def test_scatter_sum_mode_matches_plain(cuda, n, f, b, k):
    _, idx, mask = _gather_case(n, f, b, k, seed=n + k + 4, dev=cuda)
    g = torch.randn(b, f, generator=torch.Generator().manual_seed(k)).to(cuda)
    before = sm.launches
    got = sm.scatter_mean(g, idx, mask, n, normalize=False)
    torch.cuda.synchronize()
    assert sm.launches == before + 1
    torch.testing.assert_close(got, sm.scatter_mean_plain(g, idx, mask, n, normalize=False),
                               **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_mode_gradient_is_the_scatter_sum(cuda, dtype):
    x, idx, mask = _gather_case(2708, 128, 2560, 10, seed=11, dev=cuda, dtype=dtype)
    g = torch.randn(2560, 128, generator=torch.Generator().manual_seed(2)).to(cuda)
    x_kern = x.clone().requires_grad_(True)
    gm.gather_mean(x_kern, idx, mask, normalize=False).backward(g)
    want = sm.scatter_mean_plain(g, idx, mask, 2708, normalize=False)
    tol = TOL if dtype == torch.float32 else BF16_GRAD_TOL
    torch.testing.assert_close(x_kern.grad.float(), want.to(dtype).float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,f,b,k", [(91, 45, 21, 6), (2708, 128, 2560, 10),
                                     (400, 1433, 64, 10)])
def test_gather_mean_gradient_matches_plain(cuda, dtype, n, f, b, k):
    x, idx, mask = _gather_case(n, f, b, k, seed=n + 1, dev=cuda, dtype=dtype)
    g = torch.randn(b, f, generator=torch.Generator().manual_seed(b)).to(cuda)
    x_kern = x.clone().requires_grad_(True)
    before = (gm.launches, sm.launches)
    gm.gather_mean(x_kern, idx, mask).backward(g)
    torch.cuda.synchronize()
    assert (gm.launches, sm.launches) == (before[0] + 1, before[1] + 1)
    assert x_kern.grad.dtype == dtype
    x_plain = x.clone().float().requires_grad_(True)
    gm.gather_mean_plain(x_plain, idx, mask).backward(g)
    tol = TOL if dtype == torch.float32 else BF16_GRAD_TOL
    torch.testing.assert_close(x_kern.grad.float(),
                               x_plain.grad.to(dtype).float(), **tol)


@pytest.mark.parametrize("n,f,b,k", [
    (50, 1, 40, 3),          # 4-byte copies
    (91, 45, 21, 6),         # F not a multiple of 4
    (2708, 128, 2560, 10),   # Cora training layer 0 (16-byte copies)
    (300, 500, 256, 10),     # Pubmed mean-first width
    (400, 1433, 64, 10),     # Cora mean-first width (4-byte copies)
    (120, 64, 33, 40),       # more than 32 slots per row
])
def test_gather_mean_dma_kernel_matches_plain(cuda, n, f, b, k):
    x, idx, mask = _gather_case(n, f, b, k, seed=n + 2, dev=cuda)
    g = torch.randn(b, f, generator=torch.Generator().manual_seed(k)).to(cuda)
    x_kern = x.clone().requires_grad_(True)
    before = (gd.launches, sm.launches)
    got = gd.gather_mean_dma(x_kern, idx, mask)
    got.backward(g)
    torch.cuda.synchronize()
    assert (gd.launches, sm.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, gd.gather_mean_dma_plain(x, idx, mask), **TOL)
    assert (got[0] == 0).all()
    x_plain = x.clone().requires_grad_(True)
    gd.gather_mean_dma_plain(x_plain, idx, mask).backward(g)
    torch.testing.assert_close(x_kern.grad, x_plain.grad, **TOL)


def test_gather_mean_dma_unaligned_table_and_dispatch(cuda):
    _, idx, mask = _gather_case(64, 128, 30, 5, seed=7, dev=cuda)
    table = torch.randn(64 * 128 + 1, device=cuda)[1:].view(64, 128)
    assert table.is_contiguous() and table.data_ptr() % 16 != 0
    want = gd.gather_mean_dma_plain(table, idx, mask)
    torch.testing.assert_close(gd.gather_mean_dma(table, idx, mask), want, **TOL)
    before = gd.launches
    torch.testing.assert_close(gather_mean(table, idx, mask, impl="dma"), want, **TOL)
    assert gd.launches == before + 1
    with pytest.raises(TypeError):
        gd.gather_mean_dma(table.half(), idx, mask)


def _csr_case(n, avg_deg, seed, dev):
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n).astype(np.int32)
    deg[::7] = 0  # zero-degree rows
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    e_pad = -(-max(e, 1) // 128) * 128
    edge_dst = np.zeros(e_pad, np.int32)
    edge_dst[:e] = rng.integers(0, n, e)
    edge_dst[e:] = 2**30  # padding past indptr[N] must never be read
    return (torch.from_numpy(indptr).to(dev), torch.from_numpy(edge_dst).to(dev))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("n,f,avg_deg", [
    (100, 1, 3), (300, 45, 5), (2708, 128, 4), (500, 128, 70), (19717, 128, 4.5),
])
def test_spmm_kernel_matches_plain(cuda, normalize, n, f, avg_deg):
    indptr, edge_dst = _csr_case(n, avg_deg, seed=n, dev=cuda)
    x = torch.randn(n, f, generator=torch.Generator().manual_seed(n)).to(cuda)
    before = sp.launches
    got = sp.spmm_mean(x, indptr, edge_dst, normalize)
    torch.cuda.synchronize()
    assert sp.launches == before + 1
    want = sp.spmm_mean_plain(x, indptr, edge_dst, normalize)
    torch.testing.assert_close(got, want, **TOL)
    assert (got[::7] == 0).all()


def test_spmm_dispatch_and_checks(cuda):
    indptr, edge_dst = _csr_case(64, 4, seed=9, dev=cuda)
    x = torch.randn(64, 16, device=cuda)
    edge_dst = edge_dst.clamp(max=63)
    got = spmm_mean(x, None, edge_dst, None, 64, indptr=indptr, impl="pallas_vmem")
    torch.testing.assert_close(got, sp.spmm_mean_plain(x, indptr, edge_dst), **TOL)
    with pytest.raises(TypeError):
        sp.spmm_mean(x.half(), indptr, edge_dst)
    with pytest.raises(ValueError):
        sp.spmm_mean(x, indptr[:-1].contiguous(), edge_dst)


def _symmetric_csr(n, num_edges, seed, dev):
    """CSR of a random undirected graph; every seventh node isolated."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, (num_edges, 2))
    a = a[(a[:, 0] % 7 != 0) & (a[:, 1] % 7 != 0) & (a[:, 0] != a[:, 1])]
    pairs = np.unique(np.concatenate([a, a[:, ::-1]]), axis=0)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(pairs[:, 0], minlength=n), out=indptr[1:])
    return (torch.from_numpy(indptr).to(dev),
            torch.from_numpy(pairs[:, 1].astype(np.int32)).to(dev))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("n,f", [(300, 45), (2708, 128)])
def test_spmm_gradient_matches_plain(cuda, symmetric, n, f):
    indptr, edge_dst = (_symmetric_csr(n, 4 * n, seed=n, dev=cuda) if symmetric
                        else _csr_case(n, 4, seed=n, dev=cuda))
    x = torch.randn(n, f, generator=torch.Generator().manual_seed(1)).to(cuda)
    g = torch.randn(n, f, generator=torch.Generator().manual_seed(2)).to(cuda)
    x_kern = x.clone().requires_grad_(True)
    before = sp.launches
    sp.spmm_mean(x_kern, indptr, edge_dst, symmetric=symmetric).backward(g)
    torch.cuda.synchronize()
    # The symmetric backward is the kernel again; the directed one a transpose.
    assert sp.launches == before + (2 if symmetric else 1)
    x_plain = x.clone().requires_grad_(True)
    sp.spmm_mean_plain(x_plain, indptr, edge_dst).backward(g)
    torch.testing.assert_close(x_kern.grad, x_plain.grad, **TOL)


@pytest.mark.parametrize("undirected", [True, False], ids=["symmetric", "directed"])
@pytest.mark.parametrize("f", [45, 128])
def test_spmm_kernel_over_a_row_subset_matches_plain(cuda, undirected, f):
    """Kernel 3 over a row block of a graph with a hub and isolated nodes:
    the forward against the plain route's and the full call's rows; the
    backward of a gradient on the rows alone (kernel 3 over the block's
    transpose on a symmetric graph, the plain transpose on a directed one)
    against the plain full backward."""
    from graphsage_torch.data.graph import build_graph, row_block

    n = 3000
    rng = np.random.default_rng(f)
    edges = np.concatenate([rng.integers(0, n - 20, (12 * n, 2)),
                            [[0, i] for i in range(1, 900)]])  # node 0: a hub
    if not undirected:
        edges = edges[edges[:, 0] < edges[:, 1]]
    g = build_graph(np.zeros((n, 1), np.float32), np.zeros(n), edges, num_classes=1,
                    undirected=undirected, device=cuda)
    keep = rng.random(n) < 2 / 3
    keep[0] = keep[-1] = True  # the hub and an isolated node
    rows = torch.from_numpy(np.nonzero(keep)[0]).to(cuda)
    block = row_block(g, rows)
    x = torch.randn(n, f, generator=torch.Generator().manual_seed(3)).to(cuda)
    grad = torch.randn(rows.numel(), f, generator=torch.Generator().manual_seed(4)).to(cuda)
    xs = x.clone().requires_grad_(True)
    before = sp.launches
    sub = sp.spmm_mean(xs, block.indptr, block.edge_dst, symmetric=undirected, subset=True,
                       transpose=block.transpose)
    (got,) = torch.autograd.grad(sub, xs, grad)
    torch.cuda.synchronize()
    assert sp.launches == before + 1 + undirected
    torch.testing.assert_close(sub, sp.spmm_mean_plain(x, block.indptr, block.edge_dst), **TOL)
    torch.testing.assert_close(sub, sp.spmm_mean(x, g.indptr, g.edge_dst)[rows], **TOL)
    assert not sub[-1].any()
    xp = x.clone().requires_grad_(True)
    wide = torch.zeros_like(x).index_copy(0, rows, grad)
    sp.spmm_mean_plain(xp, g.indptr, g.edge_dst).backward(wide)
    torch.testing.assert_close(got, xp.grad, **TOL)


# ------------------------------------------------ shapes of the redesigns
# The gather-mean serves 32 // k rows per warp (one when k > 32); the SpMM
# cuts row ends and edges into equal chunks (``sp.chunking``), so hub rows,
# rows about a chunk long and runs of empty rows cross chunk boundaries.


@pytest.mark.parametrize("dtype,f", [
    (torch.float32, 128),   # 16-byte loads
    (torch.bfloat16, 256),  # 8-element bf16 loads
    (torch.bfloat16, 128),  # 4-element bf16 loads: 8 would leave half the lanes idle
    (torch.bfloat16, 500),  # 4-element bf16 loads
    (torch.bfloat16, 45),   # 1-element loads
])
@pytest.mark.parametrize("k", [1, 10, 25, 32, 33, 40])
# 37 rows: one row per warp. 24577: B // 8192 = 3 rows per warp when
# 32 // k allows it (k = 1, 10), and not a multiple of 3.
@pytest.mark.parametrize("b", [37, 24577])
def test_gather_mean_kernel_slot_groups(cuda, dtype, f, k, b):
    x, idx, mask = _gather_case(300, f, b, k, seed=k + f, dev=cuda, dtype=dtype)
    mask[5:9] = False  # a run of all-masked rows inside one warp's rows
    idx[5:9] = 300      # ids >= N in masked slots
    got = gm.gather_mean(x, idx, mask)
    again = gm.gather_mean(x, idx, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gm.gather_mean_plain(x.float(), idx, mask), **TOL)
    assert (got[0] == 0).all() and (got[5:9] == 0).all()
    assert torch.equal(got, again)  # a fixed summation order


def _csr_from_degrees(deg, seed, dev):
    """CSR with the given row degrees, random in-range ids, and padding past
    ``indptr[N]`` that holds ids the kernel must never read."""
    rng = np.random.default_rng(seed)
    deg = np.asarray(deg, np.int32)
    n = deg.size
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    edge_dst = np.full(-(-max(e, 1) // 128) * 128 + 128, 2**30, np.int32)
    edge_dst[:e] = rng.integers(0, n, e)
    return torch.from_numpy(indptr).to(dev), torch.from_numpy(edge_dst).to(dev)


CHUNK = sp.MIN_CHUNK  # the chunk length of every graph below (checked in the test)
SPMM_GRAPHS = {
    "star": [5000] + [0] * 5000,  # one row holding every edge
    "about a chunk": [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 5] * 6 + [1] * 9,
    "empty runs": [3] * 5 + [0] * 100 + [2 * CHUNK] + [0] * 70 + [CHUNK + 3, 0, 0, 4]
                  + [0] * 40,
    "one node": [3],
    "one isolated node": [0],
}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("f", [1, 45, 128, 500])
@pytest.mark.parametrize("graph", list(SPMM_GRAPHS))
def test_spmm_kernel_chunk_boundaries(cuda, graph, f, normalize):
    indptr, edge_dst = _csr_from_degrees(SPMM_GRAPHS[graph], seed=f, dev=cuda)
    n = indptr.numel() - 1
    assert sp.chunking(n + edge_dst.numel())[0] == CHUNK
    x = torch.randn(n, f, generator=torch.Generator().manual_seed(f)).to(cuda)
    got = sp.spmm_mean(x, indptr, edge_dst, normalize)
    again = sp.spmm_mean(x, indptr, edge_dst, normalize)
    torch.cuda.synchronize()
    _assert_spmm_close(got, x, indptr, edge_dst, normalize)
    assert torch.equal(got, again)  # no atomics: bitwise repeatable


def _assert_spmm_close(got, x, indptr, edge_dst, normalize):
    """Means within ``TOL``; a plain sum (hub rows sum thousands of terms)
    within ``rtol`` of the sum of its terms' magnitudes."""
    want = sp.spmm_mean_plain(x, indptr, edge_dst, normalize)
    if normalize:
        torch.testing.assert_close(got, want, **TOL)
    else:
        magnitude = sp.spmm_mean_plain(x.abs(), indptr, edge_dst, False)
        assert ((got - want).abs() <= TOL["atol"] + TOL["rtol"] * magnitude).all()


@pytest.mark.parametrize("normalize", [True, False])
def test_spmm_kernel_unaligned_table_at_a_hub(cuda, normalize):
    indptr, edge_dst = _csr_from_degrees(SPMM_GRAPHS["star"][:600], seed=3, dev=cuda)
    n = indptr.numel() - 1
    x = torch.randn(n * 128 + 1, device=cuda)[1:].view(n, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0  # single-element loads
    got = sp.spmm_mean(x, indptr, edge_dst, normalize)
    _assert_spmm_close(got, x, indptr, edge_dst, normalize)
    assert torch.equal(got, sp.spmm_mean(x, indptr, edge_dst, normalize))


# ------------------------------------------ the scatter's and dma's redesigns
# The scatter writes its whole output, zeros included, and takes rows of
# more than 32 slots 32 at a time. The dma
# gather serves up to 32 // k rows per warp (``gd.rows_per_warp``: 3 at
# B >= 24576 and k = 10) and streams rows through a ring of
# ``gd.plan(...).stages`` TMA copies: whole rows (F % 4 == 0, aligned
# table) or 16-byte envelopes, read directly where an envelope would leave
# the table.


def _scatter_case(n, f, b, k, seed, dev):
    _, idx, mask = _gather_case(n, f, b, k, seed=seed, dev=dev)
    mask[9:12] = torch.tensor([False, True, False])[:, None]  # a full row between empty ones
    idx[10] = torch.arange(k) % n
    idx[20:84, :10], mask[20:84, :10] = n - 1, True  # 640 slots on the last id: colliding atomics
    g = torch.randn(b, f, generator=torch.Generator().manual_seed(seed)).to(dev)
    return g, idx, mask


@pytest.mark.parametrize("n,f,b,k", [
    (19717, 128, 25600, 10),  # Pubmed's training shape
    (19717, 128, 25600, 25),  # one row of 25 slots per warp
    (300, 64, 32769, 3),      # k = 3
    (300, 128, 500, 40),      # more than 32 slots per row
    (300, 16, 300, 200),      # 200 slots per row, 32 at a time
    (300, 45, 600, 10),       # F not a multiple of 4: scalar atomics, envelopes
    (300, 1433, 300, 10),     # scalar atomics across 45 column chunks
    (300, 16, 40000, 100),    # 40000 rows of 100 slots
])
def test_scatter_mean_kernel_collisions_and_long_rows(cuda, n, f, b, k):
    g, idx, mask = _scatter_case(n, f, b, k, seed=n + k, dev=cuda)
    before = sm.launches
    got = sm.scatter_mean(g, idx, mask, n)
    torch.cuda.synchronize()
    assert sm.launches == before + 1
    assert got.shape == (n, f)
    _assert_scatter_close(got, g, idx, mask, n)


def _assert_scatter_close(got, g, idx, mask, n):
    """Within ``TOL``, the ``rtol`` part taken of the sum of the terms'
    magnitudes: the last id sums 640 terms, in an order the atomics pick."""
    want = sm.scatter_mean_plain(g, idx, mask, n)
    magnitude = sm.scatter_mean_plain(g.abs(), idx, mask, n)
    assert ((got - want).abs() <= TOL["atol"] + TOL["rtol"] * magnitude).all()


def test_scatter_mean_kernel_unaligned_cotangent_and_empty_batch(cuda):
    _, idx, mask = _scatter_case(300, 128, 100, 10, seed=5, dev=cuda)
    g = torch.randn(100 * 128 + 1, device=cuda)[1:].view(100, 128)
    assert g.is_contiguous() and g.data_ptr() % 16 != 0
    _assert_scatter_close(sm.scatter_mean(g, idx, mask, 300), g, idx, mask, 300)
    before = sm.launches
    empty = sm.scatter_mean(g[:0], idx[:0], mask[:0], 300)
    assert sm.launches == before and empty.shape == (300, 128) and (empty == 0).all()


def _dma_case(n, f, b, k, seed, dev, table=None):
    x, idx, mask = _gather_case(n, f, b, k, seed=seed, dev=dev)
    mask[3:6] = False             # a run of all-masked rows
    mask[6:9] = True              # rows with k valid slots: more than the stages
    idx[6], idx[7] = n - 1, 0     # the table's last and first rows
    idx[8] = torch.arange(k) % n
    return (x if table is None else table), idx, mask


def _check_dma(x, idx, mask):
    before = gd.launches
    got = gd.gather_mean_dma(x, idx, mask)
    again = gd.gather_mean_dma(x, idx, mask)
    torch.cuda.synchronize()
    assert gd.launches == before + 2
    torch.testing.assert_close(got, gd.gather_mean_dma_plain(x, idx, mask), **TOL)
    assert (got[0] == 0).all() and (got[3:6] == 0).all()
    assert torch.equal(got, again)  # slots summed in order: bitwise repeatable


@pytest.mark.parametrize("n,f,b,k", [
    (300, 128, 24577, 10),   # 3 rows per warp, B % 3 == 1; 4 stages
    (300, 128, 300, 25),     # 25 valid slots through 4 stages
    (300, 128, 100, 40),     # more than 32 slots per row
    (300, 128, 100, 200),    # 200 slots per row, 32 at a time
    (300, 500, 24577, 10),   # 4 chunks per pass, 2 stages
    (301, 1433, 300, 10),    # envelopes, 2 stages; the last row's leaves the table
    (300, 1433, 64, 25),     # the last row's envelope ends with the table
    (91, 45, 21, 6),         # F not a multiple of 4, one chunk
    (40, 3000, 20, 5),       # two passes of 2048 columns
])
def test_gather_mean_dma_kernel_ring_and_passes(cuda, n, f, b, k):
    _check_dma(*_dma_case(n, f, b, k, seed=n + f + k, dev=cuda))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("f", [128, 1433])
def test_gather_mean_dma_kernel_table_at_an_odd_offset(cuda, offset, f):
    # Row 0's envelope would start before the table: read directly.
    n = 64
    table = torch.randn(n * f + 4, device=cuda)[offset:offset + n * f].view(n, f)
    assert table.is_contiguous() and table.data_ptr() % 16 != 0
    _check_dma(*_dma_case(n, f, 40, 10, seed=offset, dev=cuda, table=table))


@pytest.mark.parametrize("self_loop", [False, True])
def test_layer0_cache_built_by_the_spmm_kernel(cuda, self_loop):
    """``with_cached_layer0`` on a card graph: one SpMM launch, equal to the
    plain build on the CPU; the zero-degree node keeps 0 (or its own row)."""
    from graphsage_torch.data.graph import build_graph, with_cached_layer0

    rng = np.random.default_rng(3)
    edges = np.concatenate([rng.integers(0, 300, (900, 2)), [[0, i] for i in range(1, 280)]])
    feats = rng.standard_normal((301, 37)).astype(np.float32)  # node 300 isolated
    g = build_graph(feats, np.zeros(301), edges, num_classes=1, device=cuda)
    before = sp.launches
    got = with_cached_layer0(g, self_loop=self_loop)
    assert sp.launches == before + 1
    want = with_cached_layer0(g.to("cpu"), self_loop=self_loop)
    torch.testing.assert_close(got.layer0_cache.cpu(), want.layer0_cache, **TOL)
    assert got.layer0_cache.device.type == "cuda"
    last = g.features[-1] if self_loop else torch.zeros_like(g.features[-1])
    assert torch.equal(got.layer0_cache[-1], last)


def test_layer0_full_step_launches_the_spmm_twice(cuda):
    """A ``layer0="full"`` training step: the SpMM kernel forward and again
    in the backward, no gather-mean or scatter; the gradients equal the
    CPU's."""
    import copy

    from graphsage_torch.data.synthetic import synthetic_pubmed_graph
    from graphsage_torch.models.graphsage import GraphSAGE

    g = synthetic_pubmed_graph(num_nodes=600, num_feats=140, num_edges=1500, device=cuda)
    model = GraphSAGE(140, 3, (128, 16), (4, 5), layer0="full", device=cuda)
    seeds = torch.arange(0, 64, dtype=torch.int32, device=cuda)
    fr = model.sample(torch.Generator(device=cuda).manual_seed(0), g, seeds)
    counts = (gm.launches, sm.launches, sp.launches)
    model.loss(g.features, fr, g.labels[seeds.long()], graph=g).backward()
    assert (gm.launches, sm.launches, sp.launches) == (counts[0], counts[1], counts[2] + 2)
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_model.zero_grad(set_to_none=True)
    gc = g.to("cpu")
    cpu_model.loss(gc.features, fr.to("cpu"), gc.labels[seeds.long().cpu()],
                   graph=gc).backward()
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        scale = float(q.grad.abs().max())
        assert float((p.grad.cpu() - q.grad).abs().max()) <= 1e-4 * scale, name


# ----------------------------------------------------------------- precision
# A bf16 result is an f32 sum rounded once; sums in another order may round
# to the neighbouring bf16 value, one step of 2**-7 relative.
BF16_TOL = dict(rtol=2.0**-7, atol=1e-5)


def _int8_case(n, f, b, k, seed, dev):
    """An int8 table (row 5 with scale 0, row 6 all zeros) and a frontier
    whose row 0 is all masked and row 1 names only row 5."""
    from graphsage_torch.ops.quantize import quantize_features
    x, idx, mask = _gather_case(n, f, b, k, seed, dev)
    qt = quantize_features(x)
    scale = qt.scale.clone()
    scale[5] = 0.0
    q = qt.q.clone()
    q[6] = 0
    idx[1], mask[1] = 5, True
    return q, scale.contiguous(), idx, mask


@pytest.mark.parametrize("n,f,b,k", [
    (1000, 256, 4096, 5),    # powerlaw width (8-byte int8 loads on all 32 lanes)
    (300, 512, 256, 5),      # 16-byte int8 loads
    (700, 602, 512, 10),     # Reddit's width (2-byte int8 loads)
    (300, 45, 64, 40),       # single loads, more than 32 slots per row
])
def test_gather_mean_int8_kernel_matches_plain(cuda, n, f, b, k):
    q, scale, idx, mask = _int8_case(n, f, b, k, seed=n, dev=cuda)
    before = gm.launches
    got = gm.gather_mean_int8(q, scale, idx, mask)
    torch.cuda.synchronize()
    assert gm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, f)
    torch.testing.assert_close(got, gm.gather_mean_int8_plain(q, scale, idx, mask), **TOL)
    assert (got[0] == 0).all() and (got[1] == 0).all()
    assert torch.equal(got, gm.gather_mean_int8(q, scale, idx, mask))  # fixed order


@pytest.mark.parametrize("n,f,b,k", [(1000, 256, 4096, 5), (300, 45, 64, 40)])
def test_gather_mean_int8_sum_mode_matches_plain(cuda, n, f, b, k):
    """The int8 route's sum mode (the node-sharded store's owner side over
    an int8 table): the sums undivided, counted as a sum-mode launch."""
    q, scale, idx, mask = _int8_case(n, f, b, k, seed=n + 1, dev=cuda)
    before, before_sum = gm.launches, gm.sum_launches
    got = gm.gather_mean_int8(q, scale, idx, mask, normalize=False)
    torch.cuda.synchronize()
    assert (gm.launches, gm.sum_launches) == (before + 1, before_sum + 1)
    want = gm.gather_mean_int8_plain(q, scale, idx, mask, normalize=False)
    torch.testing.assert_close(got, want, **TOL)
    count = mask.sum(dim=1, keepdim=True).clamp(min=1).float()
    torch.testing.assert_close(got / count, gm.gather_mean_int8(q, scale, idx, mask), **TOL)


def test_gather_mean_int8_rejects_what_the_kernel_does_not_take(cuda):
    q, scale, idx, mask = _int8_case(20, 16, 8, 3, seed=5, dev=cuda)
    with pytest.raises(TypeError):
        gm.gather_mean_int8(q.to(torch.uint8), scale, idx, mask)
    with pytest.raises(TypeError):
        gm.gather_mean_int8(q, scale.double(), idx, mask)
    with pytest.raises(ValueError):
        gm.gather_mean_int8(q, scale[:-1].contiguous(), idx, mask)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("n,f,avg_deg", [
    (2000, 128, 5), (3000, 256, 7), (1500, 602, 6), (300, 45, 70),
])
def test_spmm_kernel_bf16_matches_plain(cuda, normalize, n, f, avg_deg):
    indptr, edge_dst = _csr_case(n, avg_deg, seed=n + f, dev=cuda)
    x = torch.randn(n, f, generator=torch.Generator().manual_seed(n)).to(cuda)
    xb = x.to(torch.bfloat16)
    before = sp.launches
    got = sp.spmm_mean(xb, indptr, edge_dst, normalize)
    torch.cuda.synchronize()
    assert sp.launches == before + 1 and got.dtype == torch.bfloat16
    want = sp.spmm_mean_plain(xb, indptr, edge_dst, normalize)
    assert want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert (got[::7] == 0).all()
    assert torch.equal(got, sp.spmm_mean(xb, indptr, edge_dst, normalize))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("graph", ["star", "about a chunk"])
@pytest.mark.parametrize("f,offset", [(1, 0), (45, 0), (601, 0), (128, 1), (45, 1)])
def test_spmm_kernel_bf16_odd_width_or_offset(cuda, graph, f, offset, normalize):
    """bf16 pairs read from any 2-byte address: at an odd width every other
    row starts in the middle of a 4-byte word and the last element is read
    alone; a table at a 2-byte offset puts every row there. Rows cut by
    chunk boundaries go through the fix-up's f32 rows."""
    indptr, edge_dst = _csr_from_degrees(SPMM_GRAPHS[graph], seed=f + offset, dev=cuda)
    n = indptr.numel() - 1
    flat = torch.randn(n * f + offset, generator=torch.Generator().manual_seed(f))
    x = flat.to(cuda).to(torch.bfloat16)[offset:].view(n, f)
    assert x.is_contiguous() and (x.data_ptr() % 4 != 0) == bool(offset)
    got = sp.spmm_mean(x, indptr, edge_dst, normalize)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (n, f)
    want = sp.spmm_mean_plain(x, indptr, edge_dst, normalize).float()
    magnitude = sp.spmm_mean_plain(x.abs(), indptr, edge_dst, normalize).float()
    tol = BF16_TOL["atol"] + BF16_TOL["rtol"] * magnitude
    assert ((got.float() - want).abs() <= tol).all()
    assert torch.equal(got, sp.spmm_mean(x, indptr, edge_dst, normalize))


@pytest.mark.parametrize("n,f", [(1500, 128), (1500, 602), (1500, 601)])
def test_spmm_bf16_gradient_matches_plain(cuda, n, f):
    indptr, edge_dst = _symmetric_csr(n, 6 * n, seed=n + f, dev=cuda)
    x = torch.randn(n, f, generator=torch.Generator().manual_seed(1)).to(cuda)
    g = torch.randn(n, f, generator=torch.Generator().manual_seed(2)).to(cuda)
    xb = x.to(torch.bfloat16)
    x_kern = xb.clone().requires_grad_(True)
    before = sp.launches
    sp.spmm_mean(x_kern, indptr, edge_dst).backward(g.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert sp.launches == before + 2 and x_kern.grad.dtype == torch.bfloat16
    x_plain = xb.clone().requires_grad_(True)
    sp._SpmmMean.apply(x_plain, indptr, edge_dst, True, True,
                       sp.spmm_mean_plain).backward(g.to(torch.bfloat16))
    torch.testing.assert_close(x_kern.grad.float(), x_plain.grad.float(), **BF16_TOL)


# ------------------------------------------------- kernel 3's column panels
# A table larger than ``sp.L2_SHARE`` of the card's L2 is walked one column
# panel at a time (``sp.panels``). First tables that engage the panels on the
# card's own L2 (f32 [250000, 128] is 128 MB, one line a row 32 MB); then
# the small graphs above with the L2 size patched, so that the panel pass
# meets every kind of chunk boundary.
PANEL_N = 250_000


def _panel_plan(x):
    return sp.panels(x.shape[0], x.shape[1], x.element_size(), sp.l2_bytes(x.device.index),
                     x.data_ptr() % sp.LINE == 0)


def _panel_csr(dev, seed=5):
    """About 2.5M edges over PANEL_N rows, every seventh row empty, and row 1 a
    hub of 60000 edges that many chunks cut."""
    deg = np.random.default_rng(seed).poisson(10, PANEL_N)
    deg[::7] = 0
    deg[1] = 60_000
    return _csr_from_degrees(deg, seed=seed, dev=dev)


def _spmm_counted(x, indptr, edge_dst, normalize):
    """Two launches with the recorder on: both results, the launches and the
    panels counted."""
    profiling.reset()
    profiling.enable()
    try:
        before = sp.launches
        got = sp.spmm_mean(x, indptr, edge_dst, normalize)
        again = sp.spmm_mean(x, indptr, edge_dst, normalize)
        torch.cuda.synchronize()
        counts = {e["name"]: e["args"]["value"]
                  for e in profiling.export()["traceEvents"] if e["ph"] == "C"}
    finally:
        profiling.disable()
        profiling.reset()
    return got, again, sp.launches - before, counts.get("agg.spmm_mean.panels")


def _assert_spmm_bf16_close(got, x, indptr, edge_dst, normalize):
    want = sp.spmm_mean_plain(x, indptr, edge_dst, normalize).float()
    magnitude = sp.spmm_mean_plain(x.abs(), indptr, edge_dst, normalize).float()
    tol = BF16_TOL["atol"] + BF16_TOL["rtol"] * magnitude
    assert ((got.float() - want).abs() <= tol).all()


@pytest.mark.parametrize("dtype,num_panels", [(torch.float32, 4), (torch.bfloat16, 2)])
@pytest.mark.parametrize("normalize", [True, False])
def test_spmm_panels_above_the_l2_budget(cuda, dtype, num_panels, normalize):
    indptr, edge_dst = _panel_csr(cuda)
    x = torch.randn(PANEL_N, 128, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    assert _panel_plan(x) == (num_panels, 128 // num_panels)
    got, again, launches, panels = _spmm_counted(x, indptr, edge_dst, normalize)
    assert launches == 2 and panels == 2 * num_panels  # one launch a call, P panels each
    assert torch.equal(got, again)  # no atomics: bitwise repeatable
    assert got.dtype == dtype and (got[::7] == 0).all()
    if dtype == torch.float32:
        _assert_spmm_close(got, x, indptr, edge_dst, normalize)
    else:
        _assert_spmm_bf16_close(got, x, indptr, edge_dst, normalize)


def test_spmm_panels_gradient_matches_plain(cuda):
    indptr, edge_dst = _symmetric_csr(PANEL_N, 1_000_000, seed=7, dev=cuda)
    x = torch.randn(PANEL_N, 128, generator=torch.Generator().manual_seed(1)).to(cuda)
    g = torch.randn(PANEL_N, 128, generator=torch.Generator().manual_seed(2)).to(cuda)
    assert _panel_plan(x)[0] > 1
    x_kern = x.clone().requires_grad_(True)
    before = sp.launches
    sp.spmm_mean(x_kern, indptr, edge_dst).backward(g)
    torch.cuda.synchronize()
    assert sp.launches == before + 2  # the forward, and the transpose on g / deg
    x_plain = x.clone().requires_grad_(True)
    sp._SpmmMean.apply(x_plain, indptr, edge_dst, True, True,
                       sp.spmm_mean_plain).backward(g)
    torch.testing.assert_close(x_kern.grad, x_plain.grad, **TOL)


# 1 element in: single-element loads; 4 (16 bytes): 16-byte loads, but each
# row's line is split in two.
@pytest.mark.parametrize("offset", [1, 4])
def test_spmm_table_off_the_line_takes_one_pass(cuda, offset):
    indptr, edge_dst = _panel_csr(cuda)
    flat = torch.randn(PANEL_N * 128 + offset, generator=torch.Generator().manual_seed(4))
    x = flat.to(cuda)[offset:].view(PANEL_N, 128)
    assert x.is_contiguous() and _panel_plan(x) == (1, 128)
    got, again, launches, panels = _spmm_counted(x, indptr, edge_dst, True)
    assert launches == 2 and panels == 2
    assert torch.equal(got, again)
    _assert_spmm_close(got, x, indptr, edge_dst, True)


@pytest.mark.parametrize("dtype,f,panel_bytes", [
    (torch.float32, 128, 128),   # 4 panels, 4 edges a load
    (torch.float32, 128, 256),   # 2 panels, 2 edges a load
    (torch.float32, 96, 128),    # 3 panels
    (torch.float32, 512, 1024),  # 2 panels of two warp-wide pieces a row
    (torch.bfloat16, 128, 128),  # 2 panels, 4 edges a load
])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("graph", list(SPMM_GRAPHS))
def test_spmm_panels_at_chunk_boundaries(cuda, monkeypatch, graph, dtype, f, panel_bytes,
                                         normalize):
    indptr, edge_dst = _csr_from_degrees(SPMM_GRAPHS[graph], seed=f, dev=cuda)
    n = indptr.numel() - 1
    x = torch.randn(n, f, generator=torch.Generator().manual_seed(f)).to(cuda, dtype)
    # An L2 whose budget holds exactly one panel of panel_bytes a row.
    monkeypatch.setattr(sp, "l2_bytes", lambda index: math.ceil(n * panel_bytes / sp.L2_SHARE))
    num_panels = f * x.element_size() // panel_bytes
    assert _panel_plan(x) == (num_panels, f // num_panels)
    got, again, launches, panels = _spmm_counted(x, indptr, edge_dst, normalize)
    assert launches == 2 and panels == 2 * num_panels
    assert torch.equal(got, again)
    if dtype == torch.float32:
        _assert_spmm_close(got, x, indptr, edge_dst, normalize)
    else:
        _assert_spmm_bf16_close(got, x, indptr, edge_dst, normalize)


@pytest.mark.parametrize("n,f,b,k", [
    (2000, 128, 25600, 10),  # whole-row copies, 8 stages
    (1500, 602, 2560, 25),   # Reddit's width: envelopes
    (400, 45, 64, 40),       # odd width
])
def test_gather_mean_dma_bf16_matches_plain(cuda, n, f, b, k):
    x, idx, mask = _gather_case(n, f, b, k, seed=n + 3, dev=cuda, dtype=torch.bfloat16)
    before = gd.launches
    got = gd.gather_mean_dma(x, idx, mask)
    torch.cuda.synchronize()
    assert gd.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, gd.gather_mean_dma_plain(x, idx, mask), **TOL)
    assert (got[0] == 0).all()
    assert torch.equal(got, gd.gather_mean_dma(x, idx, mask))


def test_bf16_model_step_on_the_card(cuda):
    """A bf16 power-law model: one sampled step's parameter gradients on the
    card against the CPU's, within 2e-2 of each leaf's largest entry."""
    import copy
    from graphsage_torch import GraphSAGE
    from graphsage_torch.data.synthetic import power_law_graph
    graph = power_law_graph(3000, 20000, num_feats=64, num_classes=5, homophily=0.8,
                            feature_dtype=torch.bfloat16, device=cuda)
    model = GraphSAGE(64, 5, (32, 32), (5, 10), compute_dtype=torch.bfloat16,
                      project_first=True, device=cuda)
    seeds = torch.arange(256, dtype=torch.int32, device=cuda)
    fr = model.sample(torch.Generator(device=cuda).manual_seed(0), graph, seeds)
    labels = graph.labels[seeds.long()]
    model.loss(graph.features, fr, labels).backward()
    cpu_model, cpu_graph = copy.deepcopy(model).to("cpu"), graph.to("cpu")
    cpu_model.zero_grad()
    cpu_model.loss(cpu_graph.features, fr.to("cpu"), labels.cpu()).backward()
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        scale = float(q.grad.abs().max())
        assert scale > 0 and float((p.grad.cpu() - q.grad).abs().max()) <= 2e-2 * scale, name


def test_full_graph_step_on_the_card(cuda):
    """One ``FullGraphTrainer`` step: kernel 3 launches once per layer in the
    forward and once per layer that needs a gradient in the backward (two
    layers, the first projecting first: 2 + 2); loss and gradients equal the
    CPU's."""
    import copy

    from graphsage_torch import FullGraphTrainer, GraphSAGE, TrainConfig
    from graphsage_torch.data.synthetic import power_law_graph

    g = power_law_graph(2000, 12000, num_feats=64, num_classes=5, homophily=0.8,
                        device=cuda)
    model = GraphSAGE(64, 5, (32, 32), (None, None), device=cuda)
    cpu_model = copy.deepcopy(model).to("cpu")
    cfg = TrainConfig(num_steps=1, test_size=200, val_size=100, log_every=0)
    before = sp.launches
    tr = FullGraphTrainer(model, g, cfg)
    loss = tr._loss()
    loss.backward()
    torch.cuda.synchronize()
    assert sp.launches - before == 4
    cpu_tr = FullGraphTrainer(cpu_model, g.to("cpu"), cfg)
    cpu_loss = cpu_tr._loss()
    cpu_loss.backward()
    loss, cpu_loss = float(loss.detach()), float(cpu_loss.detach())
    assert abs(loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        scale = float(q.grad.abs().max())
        assert scale > 0 and float((p.grad.cpu() - q.grad).abs().max()) <= 1e-4 * scale, name


# ------------------------------------------------ unsupervised, checkpoints
def test_unsupervised_step_on_the_card(cuda):
    """A ``cora_unsup``-shaped step (the preset's model on a Cora-sized
    table, 256 seeds' 3072 group seeds): kernels 1 and 2 launch once each,
    the head gets no gradient, the others equal the CPU's within 1e-4 of
    each leaf's largest entry."""
    import copy

    from graphsage_torch import PRESETS, GraphSAGE
    from graphsage_torch.data.synthetic import synthetic_cora_graph
    from graphsage_torch.models.unsupervised import context_groups, frontier_loss
    from graphsage_torch.ops.walks import negative_cdf

    g = synthetic_cora_graph(device=cuda)
    cfg = PRESETS["cora_unsup"]
    model = GraphSAGE.from_config(cfg.model, g.num_features, g.num_classes, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cdf = torch.from_numpy(negative_cdf(g.degrees.cpu().numpy())).to(cuda)
    seeds = torch.arange(256, dtype=torch.int32, device=cuda)
    q = cfg.train.num_negatives
    groups, pair_mask = context_groups(gen, g, seeds, cdf, walk_length=3, num_negatives=q)
    fr = model.sample(gen, g, groups)
    assert fr.ids[2].numel() == 256 * (2 + q) * 100
    counts = (gm.launches, sm.launches, sp.launches)
    frontier_loss(model, g, fr, pair_mask, q).backward()
    assert (gm.launches, sm.launches, sp.launches) == (counts[0] + 1, counts[1] + 1, counts[2])
    cpu_model, gc = copy.deepcopy(model).to("cpu"), g.to("cpu")
    cpu_model.zero_grad(set_to_none=True)
    frontier_loss(cpu_model, gc, fr.to("cpu"), pair_mask.cpu(), q).backward()
    assert model.head.grad is None and cpu_model.head.grad is None
    for (name, p), c in zip(model.named_parameters(), cpu_model.parameters()):
        if c.grad is None:
            continue
        scale = float(c.grad.abs().max())
        assert scale > 0 and float((p.grad.cpu() - c.grad).abs().max()) <= 1e-4 * scale, name


def test_resume_on_the_card(cuda, tmp_path):
    """Six steps straight against three, a checkpoint restored onto the card,
    three more: the same losses and parameters up to the scatter's atomic
    order (1e-4 relative)."""
    from graphsage_torch import GraphSAGE, Trainer, TrainConfig
    from graphsage_torch.data.synthetic import synthetic_cora_graph
    from graphsage_torch.utils.checkpoint import restore_checkpoint

    g = synthetic_cora_graph(num_nodes=800, num_feats=300, num_edges=3000, device=cuda)

    def trainer(steps):
        model = GraphSAGE(300, g.num_classes, (128, 128), (10, 10), device=cuda,
                          generator=torch.Generator().manual_seed(0))
        return Trainer(model, g, TrainConfig(num_steps=steps, batch_size=128,
                                             optimizer="adam", learning_rate=0.01,
                                             test_size=100, val_size=100, log_every=0))

    straight = trainer(6)
    want = straight.run(log=None)["losses"]
    first = trainer(3)
    head = first.run(log=None, checkpoint_path=tmp_path / "ck", checkpoint_every=3)["losses"]
    second = trainer(3)
    state = restore_checkpoint(tmp_path / "ck", second.state_dict(), map_location=cuda)
    assert state["params|head"].device.type == "cuda"
    tail = second.run(log=None, initial_state=state)["losses"]
    assert second.generator.device.type == "cuda" and second.step_count == 6
    np.testing.assert_allclose(head + tail, want, rtol=1e-4)
    for p, q in zip(straight.model.parameters(), second.model.parameters()):
        p, q = p.detach(), q.detach()
        assert float((p - q).abs().max()) <= 1e-4 * float(p.abs().max())


def _halo_shards(cuda, plan):
    """Both ranks' slices of a 2-shard halo plan of a heavy-tailed graph, on
    the card (the plan is built on the host; no collective runs)."""
    from graphsage_torch.data.synthetic import power_law_graph
    from graphsage_torch.parallel.halo import build_node_partition

    g = power_law_graph(3000, 15000, num_feats=8, num_classes=3, seed=4, homophily=0.8,
                        device="cpu")
    part = build_node_partition(g, 2, **plan)
    return [part.local(r, cuda) for r in (0, 1)]


HALO_PLANS = {"global": dict(halo_chunks=3, hub_threshold=40),
              "per_offset": dict(sizing="per_offset", order="bfs")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", list(HALO_PLANS))
def test_spmm_kernel_on_halo_buffer_and_transpose(cuda, plan, dtype):
    """Kernel 3 over a rank's combined CSR (local rows, hub rows, boundary
    chunks or rounds; mean) and over its transpose (the backward's sum on
    ``g / deg``), against the plain version.

    A transposed row of a hub sums hundreds of f32 terms, and each order of
    summation rounds in proportion to its partial sums, not to the result:
    each element of that sum is held to ``atol + rtol * sum(|terms|)``
    (``chip_smoke.max_err``'s ``magnitude``), with ``TOL``'s values."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    for sh in _halo_shards(cuda, HALO_PLANS[plan]):
        buf = torch.randn(sh.width, 128, device=cuda, generator=gen).to(dtype)
        before = sp.launches
        got = sp.spmm_block_sum(buf, sh.indptr, sh.cols, normalize=True)
        assert sp.launches == before + 1 and got.shape == (sh.nodes_per_shard, 128)
        want = sp.spmm_mean_plain(buf, sh.indptr, sh.cols, normalize=True)
        torch.testing.assert_close(got, want, **(TOL if dtype == torch.float32
                                                 else BF16_GRAD_TOL))
        gs = torch.randn(sh.nodes_per_shard, 128, device=cuda, generator=gen)
        got = sp.spmm_block_sum(gs, sh.t_indptr, sh.t_cols)
        assert got.shape == (sh.width, 128)
        want = sp.spmm_mean_plain(gs, sh.t_indptr, sh.t_cols, False)
        magnitude = sp.spmm_mean_plain(gs.abs(), sh.t_indptr, sh.t_cols, False)
        excess = (got - want).abs() - (TOL["atol"] + TOL["rtol"] * magnitude)
        assert bool((excess <= 0).all()), (
            f"transposed sum off by {float((got - want).abs().flatten()[excess.argmax()]):.3g} "
            f"at a terms' magnitude of {float(magnitude.flatten()[excess.argmax()]):.3g}")


@pytest.mark.parametrize("plan", list(HALO_PLANS))
def test_scatter_sum_kernel_on_halo_send_list(cuda, plan):
    """Kernel 2's sum mode over a rank's padded send list (padded slots name
    local row 0 and are masked), against the plain version."""
    for sh in _halo_shards(cuda, HALO_PLANS[plan]):
        assert not bool(sh.send_mask.all())  # some padding to skip
        g = torch.randn(sh.send_idx.shape[0], 128, device=cuda)
        before = sm.sum_launches
        got = sm.scatter_mean(g, sh.send_idx, sh.send_mask, sh.nodes_per_shard,
                              normalize=False)
        assert sm.sum_launches == before + 1
        want = sm.scatter_mean_plain(g, sh.send_idx, sh.send_mask, sh.nodes_per_shard,
                                     normalize=False)
        torch.testing.assert_close(got, want, **TOL)
