"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
without one. This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

import graphsage_torch.ops.gather_dma as gd
import graphsage_torch.ops.gather_mean as gm
import graphsage_torch.ops.scatter_mean as sm
import graphsage_torch.ops.spmm as sp
from graphsage_torch.ops.aggregate import gather_mean, spmm_mean

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
        gd.gather_mean_dma(table.to(torch.bfloat16), idx, mask)


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


# ------------------------------------------------ shapes of the redesigns
# The gather-mean serves 32 // k rows per warp (one when k > 32); the SpMM
# cuts row ends and edges into equal chunks (``sp.chunking``), so hub rows,
# rows about a chunk long and runs of empty rows cross chunk boundaries.


@pytest.mark.parametrize("dtype,f", [
    (torch.float32, 128),   # 16-byte loads
    (torch.bfloat16, 128),  # 8-element bf16 loads
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
