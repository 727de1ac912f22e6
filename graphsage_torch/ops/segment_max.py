"""CSR segment max: ``csrc/segment_max.cu``, the max-pooling aggregator's
full-graph reduction without a per-edge tensor.

``segment_max(x[N, F], indptr[N+1], edge_dst[E_pad]) -> [N, F]`` in ``x``'s
dtype (f32 or bf16):

    out[v] = max_{e in [indptr[v], indptr[v+1])} x[edge_dst[e]]   (0 where deg v = 0)

the same function as :func:`graphsage_torch.ops.aggregate.segment_max_csr`
over ``gather(x, edge_dst)`` (the max is exact: the two agree bitwise), and
the same gradient through the ReLU that made ``x``: ``g[v, c]`` goes to the
neighbour that holds the max, and where ``k`` edge slots tie, ``g[v, c] / k``
to each of them. ``x`` is a ReLU output (the pooling MLP's), whose zeros
take no gradient (ReLU's backward drops what reaches them), so an entry
whose max is 0 sends nothing: ``x``'s own gradient differs from
``segment_max_csr``'s only where ``x`` is 0. Where a pooled unit is off for
most nodes, every row ties at 0 in its column, and the tie pass would walk
every edge of that column with an atomic add apiece (on the H100 at
Reddit's size, most of a 421 ms step). The forward also writes a record
``rec[v, c]``: the neighbour ``u >= 0`` that holds the max alone, ``-k`` for
a ``k``-way tie, ``-1`` for a row with no edge or a max of 0; the backward
sends the untied entries with one scatter and revisits only the rows that
hold a tie.

``symmetric`` (``Graph.symmetric``: the adjacency equals its transpose)
lets the card's backward send a full tie, one of every edge slot of row
``v`` (``k = deg v``), as a CSR sum: ``g[v] / deg v`` to every neighbour is
``A (g / deg)`` in that column, which kernel 3 adds over the columns that
hold one, with no atomics. When a max-pool layer's units die in training,
whole pooled columns read one value on every node, and every row ties with
all of its neighbours there (on the H100 at Reddit's size, 6.1e9 edge and
column hits a call, 170-190 ms of atomic adds that varied with the seed).
Those columns are moved to the front on the card and kernel 3 reads their
count there (``spmm_block_sum``'s ``live_cols``): the host reads nothing
back and does not wait for the card.

The segment_max_csr route gathers ``[E_pad, F]`` first: at Reddit's 114.6M
edge slots and the pooled width of 512 that is 234.7 GB, three times the
card's memory. The kernel walks the CSR as kernel 3 does
(:mod:`graphsage_torch.ops.spmm`): merge-path chunks
(:func:`~graphsage_torch.ops.spmm.chunking`) and, for a table larger than
L2, column panels (:func:`~graphsage_torch.ops.spmm.panels`).

``subset=True`` computes ``R`` of the ``N`` rows: ``indptr[R+1]`` and
``edge_dst`` are the CSR of those rows (each with its whole neighbour list,
global ids into ``x``), and out and rec are ``[R, F]``; the scatter and the
tie pass send to ``x``'s rows unchanged. Its full ties need ``transpose``,
the CSR of the rows' transpose (``A[:, rows]``, ids local to the rows,
:class:`graphsage_torch.data.graph.RowBlock`): kernel 3 sums ``R`` rows of
shares into the ``N`` rows of ``dx``. Without it the tie pass sends them.

A CUDA tensor goes to the kernel (or an exception); a CPU tensor goes to
the plain PyTorch versions :func:`segment_max_plain` and
:func:`segment_max_backward_plain`, which keep the record and its backward
and serve as the reference the kernel is held against on the card.
"""

from __future__ import annotations

import functools

import torch

from graphsage_torch.ops import _build, spmm
from graphsage_torch.utils import profiling

# Kernel launches (forward calls) since the last reset.
launches = 0

# Edge slots per warp of the backward's tie pass: a tied hub is shared by
# deg / TIE_PIECE warps.
TIE_PIECE = 512


def segment_max_bytes(rows: int, cols: int, elem: int, num_edges: int,
                      out_rows: int | None = None) -> int:
    """The bytes one forward call must move, from sizes the host knows: the
    ``rows`` input rows once, ``indptr`` and the ids of the ``num_edges``
    edges in use (int32), the output once and the int32 record, ``out_rows``
    rows each (the CSR's; by default ``rows``). The recorder's counter
    ``agg.segment_max.bytes``."""
    out_rows = rows if out_rows is None else out_rows
    return (rows * cols * elem + out_rows * cols * (elem + 4) + 4 * (out_rows + 1)
            + 4 * num_edges)


def segment_max_backward_bytes(rows: int, cols: int, elem: int,
                               in_rows: int | None = None) -> int:
    """The bytes one backward call must move: the gradient and the record
    (``rows`` rows) read once, the input's gradient (``in_rows``, by default
    ``rows``) written once."""
    in_rows = rows if in_rows is None else in_rows
    return (rows + in_rows) * cols * elem + 4 * rows * cols


def _edge_rows(indptr: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Each used edge slot's row, and the number of used slots."""
    n = indptr.numel() - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=indptr.device), deg), int(indptr[-1])


def segment_max_plain(x: torch.Tensor, indptr: torch.Tensor,
                      edge_dst: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``(out, rec)`` from a per-edge gather, a
    scatter-max and a count of the slots equal to each max."""
    n, f = indptr.numel() - 1, x.shape[1]
    src, e = _edge_rows(indptr)
    nbr = edge_dst[:e].long()
    vals = x[nbr]
    out = x.new_zeros((n, f)).scatter_reduce(0, src[:, None].expand_as(vals), vals, "amax",
                                             include_self=False)
    hit = vals == out[src]
    ties = torch.zeros((n, f), dtype=torch.int64, device=x.device).index_add_(0, src, hit.long())
    arg = torch.zeros_like(ties).index_add_(0, src, torch.where(hit, nbr[:, None], 0))
    rec = torch.where((ties == 0) | (out == 0), -1, torch.where(ties == 1, arg, -ties))
    return out, rec.to(torch.int32)


def segment_max_backward_plain(g, x, out, rec, indptr, edge_dst) -> torch.Tensor:
    """The plain backward: the untied entries to their neighbours' rows, then
    ``g / k`` to each slot of a ``k``-way tie, summed in f32 and rounded to
    ``x``'s dtype."""
    f = x.shape[1]
    dx = torch.zeros((x.shape[0], f), dtype=torch.float32, device=x.device)
    g32 = g.to(torch.float32)
    single = rec >= 0
    cols = torch.arange(f, device=x.device).expand_as(rec)
    dx.index_put_((rec[single].long(), cols[single]), g32[single], accumulate=True)
    src, e = _edge_rows(indptr)
    nbr = edge_dst[:e].long()
    tied = (rec[src] < -1) & (x[nbr] == out[src])
    share = g32 / (-rec).clamp(min=1).to(torch.float32)
    dx.index_add_(0, nbr, torch.where(tied, share[src], 0.0))
    return dx.to(x.dtype)


# The C entry points for each table dtype: forward, backward, the full ties'
# columns.
_ENTRIES = {torch.float32: ("gsage_segment_max_f32", "gsage_segment_max_backward_f32",
                            "gsage_segment_max_full_cols_f32"),
            torch.bfloat16: ("gsage_segment_max_bf16", "gsage_segment_max_backward_bf16",
                             "gsage_segment_max_full_cols_bf16")}


def _launch(x: torch.Tensor, indptr: torch.Tensor,
            edge_dst: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    n, f = indptr.numel() - 1, x.shape[1]
    out = torch.empty((n, f), dtype=x.dtype, device=x.device)
    rec = torch.empty((n, f), dtype=torch.int32, device=x.device)
    if n == 0 or f == 0:
        return out, rec
    items = n + edge_dst.numel()
    if items >= 2**31:
        raise ValueError(f"segment_max kernel: N + E_pad = {items} needs 64-bit offsets")
    chunk, num_chunks = spmm.chunking(items)
    # Per chunk: the carry and head pieces' values (f32) and states (int32),
    # F each, then one int32 row id.
    scratch = torch.empty(num_chunks * (4 * f + 1), dtype=torch.int32, device=x.device)
    num_panels, _ = spmm.panels(x.shape[0], f, x.element_size(),
                                spmm.l2_bytes(x.device.index), x.data_ptr() % spmm.LINE == 0)
    profiling.count("agg.segment_max.panels", num_panels)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(_build.library(), _ENTRIES[x.dtype][0])(
            x.data_ptr(), indptr.data_ptr(), edge_dst.data_ptr(), out.data_ptr(),
            rec.data_ptr(), scratch.data_ptr(), n, f, chunk, num_chunks, num_panels, stream)
    _build.check(err, "segment_max kernel")
    launches += 1
    return out, rec


def _launch_backward(g, x, out, rec, indptr, edge_dst, symmetric=False,
                     transpose=None) -> torch.Tensor:
    n, f = rec.shape
    # A row subset's full ties need its transpose to go through kernel 3;
    # without it the tie pass sends them.
    symmetric = symmetric and (transpose is not None or n == x.shape[0])
    dx = torch.zeros((x.shape[0], f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return dx.to(x.dtype)
    tied = torch.zeros(n, dtype=torch.int32, device=x.device)
    full_cols = torch.zeros(f, dtype=torch.int32, device=x.device)
    num_pieces = max(1, -(-edge_dst.numel() // TIE_PIECE))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(_build.library(), _ENTRIES[x.dtype][1])(
            g.data_ptr(), x.data_ptr(), out.data_ptr(), rec.data_ptr(), indptr.data_ptr(),
            edge_dst.data_ptr(), dx.data_ptr(), tied.data_ptr(), full_cols.data_ptr(), n, f,
            TIE_PIECE, num_pieces, int(symmetric), stream)
    _build.check(err, "segment_max backward kernel")
    if symmetric:
        _add_full_ties(dx, g, rec, indptr, edge_dst, full_cols, transpose)
    return dx if x.dtype == torch.float32 else dx.to(x.dtype)


def _full_tie_columns(full_cols):
    """The columns that hold a full tie first (a stable sort of the flags),
    and their count ``[1]``, both left on the device."""
    order = torch.argsort(full_cols, descending=True, stable=True)
    return order, full_cols.sum(dtype=torch.int32).reshape(1)


def _add_full_ties_plain(dx, g, rec, indptr, edge_dst, full_cols, transpose=None) -> None:
    """:func:`_add_full_ties` in PyTorch ops, over every column (the
    reference for the kernels' route): ``g / deg`` at the full ties, the
    flagged columns moved to the front, their CSR sum, added back."""
    order, live = _full_tie_columns(full_cols)
    deg = (indptr[1:] - indptr[:-1])[:, None]
    share = torch.where((rec < -1) & (rec == -deg), g.to(torch.float32) / deg, 0.0)
    total = spmm.spmm_block_sum(share[:, order], *(transpose or (indptr, edge_dst)),
                                live_cols=live)
    # On the card the columns of the panels past the count are unwritten.
    kept = torch.arange(rec.shape[1], device=dx.device) < live
    dx.index_add_(1, order, torch.where(kept, total, 0.0))


def _add_full_ties(dx, g, rec, indptr, edge_dst, full_cols, transpose=None) -> None:
    """``dx += A (g / deg)`` at the entries that are a full tie (``rec = -deg
    v``, flagged by column in ``full_cols``), on the card: their columns moved
    to the front (``segment_max_full_cols``), kernel 3's plain sum over them,
    added back to their columns. Kernel 3 and the moves read the columns'
    count on the card and touch the live columns alone, so nothing is read
    back. For a row subset (``rec`` has fewer rows than ``dx``) the sum runs
    over ``transpose``, the CSR of its transpose, into ``dx``'s rows."""
    n, f = rec.shape
    t_indptr, t_dst = transpose or (indptr, edge_dst)
    order, live = _full_tie_columns(full_cols)
    share = torch.empty((n, f), dtype=torch.float32, device=dx.device)
    _, panel_cols = spmm.panels(n, f, 4, spmm.l2_bytes(dx.device.index),
                                share.data_ptr() % spmm.LINE == 0)
    entry = getattr(_build.library(), _ENTRIES[g.dtype][2])
    stream = torch.cuda.current_stream(dx.device).cuda_stream
    with torch.cuda.device(dx.device):
        err = entry(g.data_ptr(), rec.data_ptr(), indptr.data_ptr(), order.data_ptr(),
                    live.data_ptr(), share.data_ptr(), None, dx.data_ptr(), n, f, panel_cols,
                    1, stream)
    _build.check(err, "segment_max full ties")
    total = spmm.spmm_block_sum(share, t_indptr, t_dst, live_cols=live)
    with torch.cuda.device(dx.device):
        err = entry(g.data_ptr(), rec.data_ptr(), t_indptr.data_ptr(), order.data_ptr(),
                    live.data_ptr(), None, total.data_ptr(), dx.data_ptr(), dx.shape[0], f,
                    panel_cols, 0, stream)
    _build.check(err, "segment_max full ties")


class _SegmentMax(torch.autograd.Function):
    """``forward(x, indptr, edge_dst, fwd, bwd)`` runs ``fwd`` (the kernel
    wrapper or the plain version) and keeps the record for ``bwd``; the
    backward is the span ``agg.segment_max.backward``."""

    @staticmethod
    def forward(ctx, x, indptr, edge_dst, fwd, bwd):
        out, rec = fwd(x, indptr, edge_dst)
        ctx.save_for_backward(x, out, rec, indptr, edge_dst)
        ctx.bwd = bwd
        return out

    @staticmethod
    def backward(ctx, grad):
        rest = (None,) * (len(ctx.needs_input_grad) - 1)
        if not ctx.needs_input_grad[0]:
            return None, *rest
        with profiling.span("agg.segment_max.backward", device=grad.device):
            x, out, rec, indptr, edge_dst = ctx.saved_tensors
            if profiling.recording():
                profiling.count("agg.segment_max.bytes", segment_max_backward_bytes(
                    rec.shape[0], rec.shape[1], grad.element_size(), x.shape[0]))
            dx = ctx.bwd(grad.contiguous(), x, out, rec, indptr, edge_dst)
        return dx, *rest


def segment_max(x: torch.Tensor, indptr: torch.Tensor, edge_dst: torch.Tensor,
                symmetric: bool = False, *, subset: bool = False,
                transpose: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """The CSR segment max ``[R, F]`` in ``x``'s dtype (see the module
    docstring), ``R = N`` unless ``subset``, differentiable in ``x``, a ReLU
    output: an entry whose max is 0 sends no gradient; ``symmetric``: the
    adjacency equals its transpose (the card's backward sends full ties as a
    CSR sum; over a row subset, through ``transpose``)."""
    spmm._check(x, indptr, edge_dst, square=not subset)
    if transpose is not None:
        if not subset:
            raise ValueError("transpose= is the CSR of a row subset's transpose: "
                             "pass subset=True")
        spmm._check(x, *transpose)
    if x.device.type == "cpu":
        fwd, bwd = segment_max_plain, segment_max_backward_plain
    elif x.device.type == "cuda":
        fwd, bwd = _launch, functools.partial(_launch_backward, symmetric=symmetric,
                                              transpose=transpose)
    else:
        raise ValueError(f"no segment_max for device {x.device}")
    return _SegmentMax.apply(x, indptr, edge_dst, fwd, bwd)
