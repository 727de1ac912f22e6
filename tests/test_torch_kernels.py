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
