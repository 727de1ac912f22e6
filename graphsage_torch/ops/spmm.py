"""CSR mean-SpMM: Hopper kernel 3 (``csrc/spmm_mean.cu``), the port of
``graphsage_tpu/ops/pallas_spmm.py:_kernel``.

``spmm_mean(features[N, F], indptr[N+1], edge_dst[E_pad]) -> [N, F]`` in the
features' dtype (f32 or bf16), summed in f32 and rounded once:

    out[v] = scale(v) * sum_{e in [indptr[v], indptr[v+1])} features[edge_dst[e]]

with ``scale(v) = 1 / max(deg v, 1)`` under ``normalize`` (the mean) and 1
without it (the plain sum). Only ``edge_dst[:indptr[N]]`` is read, so padded
edges never count. The kernel splits the row ends and edges into equal
chunks (merge path, :func:`chunking`), so a hub row is shared by many warps;
its pieces are summed in a fixed order, and the result is bitwise repeatable.
A table larger than the card's L2 is walked once per column panel
(:func:`panels`), so that the panel's rows stay in L2.

The backward follows ``graphsage_tpu/ops/pallas_spmm.py:_bwd``: with
``gs = g / max(deg, 1)`` (under ``normalize``), a symmetric adjacency gives
``dX = A gs``, the same kernel with ``normalize=False``; a directed one gives
the transpose ``dX = A^T gs``, a plain ``index_add_`` on either device (the
JAX package leaves it to XLA). ``gs`` is rounded to the features' dtype,
so a bf16 table's backward moves bf16 rows too; the gradient has the
features' dtype. Both devices go through one ``autograd.Function``, so the
CPU runs the card's backward formula.

``subset=True`` computes ``R`` of the ``N`` rows: ``indptr[R+1]`` and
``edge_dst`` are the CSR of those rows (each with its whole neighbour list,
so its mean is the full call's), over the whole table, and the result is
``[R, F]``. Its backward sends ``gs [R, F]`` to the table's ``N`` rows
through ``transpose``, the CSR of the rows' transpose (on a symmetric
graph ``A[:, rows]``, ids local to the rows): the same kernel with
``normalize=False`` over it; without it, the plain transpose.

A CUDA tensor goes to the kernel (or an exception); a CPU tensor goes to
the plain PyTorch version :func:`spmm_mean_plain`, which also serves as the
reference the kernel is held against on the card. ``indptr`` must be a
valid CSR offset array into ``edge_dst`` and every used id must lie in
``[0, N)``, as :func:`graphsage_torch.data.graph.build_graph` guarantees.
"""

from __future__ import annotations

import functools

import torch

from graphsage_torch.ops import _build
from graphsage_torch.utils import profiling

# Kernel launches since the last reset (a run sets it to 0 and reads it back
# to show that its path went through the kernel).
launches = 0


def spmm_mean_plain(
    features: torch.Tensor,
    indptr: torch.Tensor,
    edge_dst: torch.Tensor,
    normalize: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version: per-edge row gather + ``index_add_`` in
    f32, rounded to the features' dtype."""
    n = indptr.numel() - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    e = int(indptr[-1])
    src = torch.repeat_interleave(torch.arange(n, device=features.device), deg)
    rows = features[edge_dst[:e].long()].to(torch.float32)
    out = torch.zeros((n, features.shape[1]), dtype=torch.float32,
                      device=features.device).index_add_(0, src, rows)
    if normalize:
        out = out / deg.clamp(min=1).to(torch.float32)[:, None]
    return out.to(features.dtype)


def spmm_transpose_plain(
    g: torch.Tensor, indptr: torch.Tensor, edge_dst: torch.Tensor,
    num_rows: int | None = None,
) -> torch.Tensor:
    """``A^T g`` for the CSR adjacency ``A``: ``out[edge_dst[e]] += g[v]`` for
    each edge ``e`` of row ``v``, f32 (the directed backward, and an edge
    block's). ``num_rows`` is the output's (the table's) row count, by
    default ``A``'s."""
    n = indptr.numel() - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    e = int(indptr[-1])
    src = torch.repeat_interleave(torch.arange(n, device=g.device), deg)
    return torch.zeros((n if num_rows is None else num_rows, g.shape[1]), dtype=torch.float32,
                       device=g.device).index_add_(0, edge_dst[:e].long(),
                                                   g.to(torch.float32)[src])


def spmm_mean_bytes(rows: int, cols: int, elem: int, num_edges: int,
                    out_rows: int | None = None) -> int:
    """The bytes one call must move, from sizes the host knows: ``rows`` input
    rows of ``cols`` elements of ``elem`` bytes once, ``indptr`` and the
    column ids of the ``num_edges`` edges in use (int32), and the output once
    (in the input's dtype), ``out_rows`` rows (the CSR's; by default
    ``rows``). The recorder's counter ``agg.spmm_mean.bytes``."""
    out_rows = rows if out_rows is None else out_rows
    return (rows + out_rows) * cols * elem + 4 * (out_rows + 1) + 4 * num_edges


# The C entry point for each table dtype.
_ENTRIES = {torch.float32: "gsage_spmm_mean_f32", torch.bfloat16: "gsage_spmm_mean_bf16"}


def _check(features: torch.Tensor, indptr: torch.Tensor, edge_dst: torch.Tensor,
           square: bool = True) -> None:
    if features.dim() != 2:
        raise ValueError(f"features must be [N, F], got {tuple(features.shape)}")
    if indptr.dim() != 1 or (square and indptr.numel() != features.shape[0] + 1):
        raise ValueError(
            f"indptr must be [N+1] = [{features.shape[0] + 1}], got "
            f"{tuple(indptr.shape)}"
        )
    if edge_dst.dim() != 1:
        raise ValueError(f"edge_dst must be 1-D, got {tuple(edge_dst.shape)}")
    if features.dtype not in _ENTRIES:
        raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
    if indptr.dtype != torch.int32 or edge_dst.dtype != torch.int32:
        raise TypeError(
            f"indptr and edge_dst must be int32, got {indptr.dtype} and "
            f"{edge_dst.dtype}"
        )
    if not (features.device == indptr.device == edge_dst.device):
        raise ValueError(
            f"features, indptr and edge_dst lie on {features.device}, "
            f"{indptr.device} and {edge_dst.device}"
        )
    if not (features.is_contiguous() and indptr.is_contiguous()
            and edge_dst.is_contiguous()):
        raise ValueError("features, indptr and edge_dst must be contiguous")


# About 31 warps for each of the H100's 132 SMs: the kernel is bound by the
# latency of each warp's dependent loads, so more, shorter chunks run faster
# until the per-chunk search and carry cost more than they save.
TARGET_CHUNKS = 4096
MIN_CHUNK, MAX_CHUNK = 16, 512  # MAX_CHUNK: a block's windows fit 48 KB


def chunking(num_items: int) -> tuple[int, int]:
    """``(chunk, num_chunks)``: the kernel's merge-path split of ``num_items``
    row ends and edges into equal chunks, one warp each, about
    ``TARGET_CHUNKS`` of them."""
    chunk = min(MAX_CHUNK, max(MIN_CHUNK, -(-num_items // TARGET_CHUNKS)))
    return chunk, max(1, -(-num_items // chunk))


# Column panels (``csrc/spmm_mean.cu``): a table larger than the card's L2
# is gathered one panel of columns at a time, each a whole number of L2
# lines a row, the fewest panels for which one panel of the table fits this
# share of L2; the rest is left to the pass's streams (edge ids, indptr
# windows, output, carries). Measured on an H100 (50 MiB of L2) at degree
# 492: a 41 MB panel was gathered at the rate of an L2-resident table, a
# 51 MB one 5% slower than 26 MB ones; a table that fits L2 whole (51 MB at
# degree 20) ran 1-2% slower in two panels than in one pass.
L2_SHARE = 0.7
LINE = 128  # bytes of an L2 line


def panels(rows: int, cols: int, elem: int, l2_bytes: int,
           line_aligned: bool) -> tuple[int, int]:
    """``(num_panels, panel_cols)``: the column panels of kernel 3 over a
    table of ``rows`` rows of ``cols`` elements of ``elem`` bytes, on a card
    with ``l2_bytes`` of L2: the fewest panels of whole lines whose rows fit
    ``L2_SHARE`` of L2. One panel (the whole row) where the table fits L2,
    where its rows are not whole lines or not ``line_aligned`` (the table's
    start), or where no panel fits, not even one line a row."""
    row_bytes = cols * elem
    if line_aligned and row_bytes % LINE == 0 and rows * row_bytes > l2_bytes:
        lines = row_bytes // LINE
        for p in range(2, lines + 1):
            if lines % p == 0 and rows * (row_bytes // p) <= L2_SHARE * l2_bytes:
                return p, cols // p
    return 1, cols


@functools.cache
def l2_bytes(index: int) -> int:
    """The L2 cache's size on CUDA device ``index``, as its runtime reports it."""
    return torch.cuda.get_device_properties(index).L2_cache_size


def _launch(features, indptr, edge_dst, normalize: bool,
            live_cols: torch.Tensor | None = None) -> torch.Tensor:
    global launches
    n, f = indptr.numel() - 1, features.shape[1]
    out = torch.empty((n, f), dtype=features.dtype, device=features.device)
    if n == 0 or f == 0:
        return out
    # E = indptr[N] lives on the card; edge_dst's length bounds it, and the
    # chunks past the last item return at once.
    items = n + edge_dst.numel()
    if items >= 2**31:
        raise ValueError(f"spmm_mean kernel: N + E_pad = {items} needs 64-bit offsets")
    chunk, num_chunks = chunking(items)
    # Per chunk: an f32 carry row and head row (the pieces of the rows that
    # the chunk's ends cut), F rounded up to even apart, then one int32 row
    # id. Freed on return: the caching allocator gives it out again only to
    # work queued after these kernels on this stream.
    scratch = torch.empty(num_chunks * (2 * (f + f % 2) + 1), dtype=torch.float32,
                          device=features.device)
    num_panels, _ = panels(features.shape[0], f, features.element_size(),
                           l2_bytes(features.device.index),
                           features.data_ptr() % LINE == 0)
    profiling.count("agg.spmm_mean.panels", num_panels)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    with torch.cuda.device(features.device):
        err = getattr(_build.library(), _ENTRIES[features.dtype])(
            features.data_ptr(), indptr.data_ptr(), edge_dst.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n, f, int(normalize), chunk,
            num_chunks, num_panels, None if live_cols is None else live_cols.data_ptr(),
            stream,
        )
    _build.check(err, "spmm_mean kernel")
    launches += 1
    return out


class _SpmmMean(torch.autograd.Function):
    """``forward(features, indptr, edge_dst, normalize, symmetric, fwd,
    num_edges=None, t_indptr=None, t_dst=None)`` runs ``fwd`` (the kernel
    wrapper or the plain version); see the module docstring for the
    backward."""

    @staticmethod
    def forward(ctx, features, indptr, edge_dst, normalize, symmetric, fwd, num_edges=None,
                t_indptr=None, t_dst=None):
        ctx.save_for_backward(indptr, edge_dst, t_indptr, t_dst)
        ctx.normalize, ctx.symmetric, ctx.fwd = normalize, symmetric, fwd
        ctx.dtype, ctx.num_edges, ctx.rows = features.dtype, num_edges, features.shape[0]
        return fwd(features, indptr, edge_dst, normalize)

    @staticmethod
    def backward(ctx, grad):
        rest = (None,) * (len(ctx.needs_input_grad) - 1)
        if not ctx.needs_input_grad[0]:
            return None, *rest
        with profiling.span("agg.spmm_mean.backward", device=grad.device):
            indptr, edge_dst, t_indptr, t_dst = ctx.saved_tensors
            if ctx.num_edges is not None and profiling.recording():
                profiling.count("agg.spmm_mean.bytes", spmm_mean_bytes(
                    grad.shape[0], grad.shape[1], grad.element_size(), ctx.num_edges,
                    out_rows=ctx.rows))
            gs = grad.to(torch.float32)
            if ctx.normalize:
                deg = (indptr[1:] - indptr[:-1]).clamp(min=1).to(torch.float32)
                gs = gs / deg[:, None]
            gs = gs.to(ctx.dtype).contiguous()
            if t_indptr is not None:
                dx = ctx.fwd(gs, t_indptr, t_dst, False)
            elif ctx.symmetric and indptr.numel() - 1 == ctx.rows:
                dx = ctx.fwd(gs, indptr, edge_dst, False)
            else:
                dx = spmm_transpose_plain(gs, indptr, edge_dst, num_rows=ctx.rows).to(ctx.dtype)
        return dx, *rest


def spmm_mean(
    features: torch.Tensor,
    indptr: torch.Tensor,
    edge_dst: torch.Tensor,
    normalize: bool = True,
    symmetric: bool = True,
    num_edges: int | None = None,
    *,
    subset: bool = False,
    transpose: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """CSR (mean-)SpMM ``[R, F]`` in the features' dtype (see module
    docstring), ``R = N`` unless ``subset``. ``symmetric``
    says that the adjacency equals its transpose, which picks the backward.
    ``num_edges`` (``indptr[N]``, where the caller knows it on the host)
    lets the backward count its bytes into ``agg.spmm_mean.bytes``.

    ``subset``: ``indptr`` covers ``R`` rows of the table's adjacency, not
    all ``N`` (:class:`graphsage_torch.data.graph.RowBlock`); the backward
    sums over ``transpose``, the CSR ``(indptr [N+1], ids [E])`` of the
    rows' transpose with ids local to them, where it is given (kernel 3 on
    the card), and takes the plain transpose where it is not."""
    _check(features, indptr, edge_dst, square=not subset)
    if transpose is not None:
        if not subset:
            raise ValueError("transpose= is the CSR of a row subset's transpose: "
                             "pass subset=True")
        _check(features, *transpose)
    if features.device.type == "cpu":
        fwd = spmm_mean_plain
    elif features.device.type == "cuda":
        fwd = _launch
    else:
        raise ValueError(f"no spmm_mean for device {features.device}")
    return _SpmmMean.apply(features, indptr, edge_dst, normalize, symmetric, fwd, num_edges,
                           *(transpose or (None, None)))


def spmm_block_sum(
    features: torch.Tensor, indptr: torch.Tensor, edge_dst: torch.Tensor,
    normalize: bool = False, live_cols: torch.Tensor | None = None,
) -> torch.Tensor:
    """The CSR sum over the rows that ``indptr`` covers, ``[R, F]`` in the
    features' dtype: ``out[r] = sum_{e in [indptr[r], indptr[r+1])}
    features[edge_dst[e]]`` for ``R = indptr.numel() - 1`` rows, which may
    be fewer or more than the table's; ``normalize`` divides each row by
    ``max(deg, 1)`` before the one rounding. Kernel 3 on the card, its plain
    version on the CPU; no autograd (the edge-partitioned path,
    :mod:`graphsage_torch.parallel.distributed`, and the halo exchange,
    :mod:`graphsage_torch.parallel.halo`, have their own backwards).

    ``live_cols``, an int32 ``[1]`` tensor on the card: only the columns
    before that count are wanted. The kernel passes over the column panels
    that start at or past it and leaves their columns unwritten, without
    the host reading the count; the plain version computes every column."""
    _check(features, indptr, edge_dst, square=False)
    if features.device.type == "cpu":
        return spmm_mean_plain(features, indptr, edge_dst, normalize=normalize)
    if features.device.type != "cuda":
        raise ValueError(f"no spmm_mean for device {features.device}")
    return _launch(features, indptr, edge_dst, normalize, live_cols)
