"""Masked gather-mean by bulk row copies: Hopper kernel 4
(``csrc/gather_mean_dma.cu``), the port of
``graphsage_tpu/ops/pallas_gather.py:_gather_mean_kernel`` (the ``"dma"``
route of :func:`graphsage_torch.ops.aggregate.gather_mean`).

``gather_mean_dma(features[N, F] f32 or bf16, idx[B, k], mask[B, k]) -> [B, F]``
f32
is the same function as :func:`graphsage_torch.ops.gather_mean.gather_mean`;
the kernel differs in kind: each valid neighbour row is copied into a ring
of stages in shared memory (sized by :func:`plan`) by one
TMA bulk copy (``cp.async.bulk`` completing on an ``mbarrier``), several
ahead of the warp's sum, which it keeps in registers. Its backward is the
same scatter-mean, through the shared
:class:`~graphsage_torch.ops.gather_mean.GatherMean` Function (the JAX
package used XLA's ``segment_sum`` there). A bf16 table's rows are copied
as they are (the TPU kernel cast the table to f32 first) and summed in f32.

A CUDA tensor goes to the kernel (or an exception); a CPU tensor goes to the
plain PyTorch version :func:`gather_mean_dma_plain`. Ids in masked slots are
never read and may hold anything; ids in valid slots must lie in ``[0, N)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graphsage_torch.ops import _build
from graphsage_torch.ops.gather_mean import GatherMean, _check, gather_mean_plain

# Kernel launches since the last reset (a run sets it to 0 and reads it back
# to show that its path went through the kernel).
launches = 0

# The plain version: the function is kernel 1's, so its plain version is too.
gather_mean_dma_plain = gather_mean_plain

# The C entry point for each table dtype (kernel 1's checks admit the same).
_ENTRIES = {torch.float32: "gsage_gather_mean_dma_f32",
            torch.bfloat16: "gsage_gather_mean_dma_bf16"}

# Launch plan, checked by the C entry point. A warp takes several rows only
# once the batch gives the card about this many warps that way (as kernel 1
# decides in C).
CARD_WARPS = 8192
# The kernel's blocks hold this many warps, each with its own ring.
WARPS_PER_BLOCK = 4
# Shared memory for one warp's ring, which sets its stages: f32 4 at F=128,
# 2 at F=500 and F=1433; bf16 8 at F=128, 2 at F=602.
RING_BYTES = 2048
MAX_STAGES = 8
# A pass covers 128 columns per chunk; the kernel is built for these.
CHUNKS = (1, 4, 16)


class Plan(NamedTuple):
    rows_per_warp: int
    chunks: int        # 128-column chunks per pass over the slots
    stages: int        # ring stages per warp (rows in flight)
    stage_bytes: int   # bytes per stage, a multiple of 16


def rows_per_warp(b: int, k: int) -> int:
    """Consecutive rows of a ``[b, k]`` frontier that one warp serves:
    ``32 // k`` (all their slots fit one ballot) once the batch has enough
    rows to give the card about ``CARD_WARPS`` warps that way, fewer for
    smaller batches, 1 when ``k > 32``."""
    if k > 32:
        return 1
    return max(1, min(32 // max(k, 1), b // CARD_WARPS))


def plan(b: int, k: int, f: int, whole_rows: bool, itemsize: int = 4) -> Plan:
    """The kernel's launch for a ``[b, k]`` frontier over an F-wide table of
    ``itemsize``-byte elements.

    ``whole_rows``: a row is a multiple of 16 bytes and the table 16-byte
    aligned, so each bulk copy moves a row itself; otherwise it moves the
    row's 16-byte-aligned envelope, up to 16 bytes more. A pass holds up to
    2048 columns in registers (f32 sums, whatever the table's dtype); wider
    rows take several."""
    chunks = next(c for c in CHUNKS if 128 * c >= f or c == CHUNKS[-1])
    row_bytes = itemsize * min(f, 128 * chunks)
    stage_bytes = row_bytes if whole_rows else -(-row_bytes // 16) * 16 + 16
    stages = min(MAX_STAGES, max(2, RING_BYTES // stage_bytes))
    return Plan(rows_per_warp(b, k), chunks, stages, stage_bytes)


def _launch(features: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    global launches
    b, k = idx.shape
    n, f = features.shape
    out = torch.empty((b, f), dtype=torch.float32, device=features.device)
    if b == 0 or f == 0:
        return out
    size = features.element_size()
    p = plan(b, k, f, (f * size) % 16 == 0 and features.data_ptr() % 16 == 0, size)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    with torch.cuda.device(features.device):
        err = getattr(_build.library(), _ENTRIES[features.dtype])(
            features.data_ptr(), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
            n, b, k, f, p.rows_per_warp, p.chunks, p.stages, p.stage_bytes, stream,
        )
    _build.check(err, "gather_mean_dma kernel")
    launches += 1
    return out


def gather_mean_dma(
    features: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked gather-mean ``[B, F]`` f32 of an f32 or bf16 table (see module
    docstring); the gradient has the table's dtype."""
    _check(features, idx, mask)
    if features.device.type == "cpu":
        fwd = gather_mean_dma_plain
    elif features.device.type == "cuda":
        fwd = _launch
    else:
        raise ValueError(f"no gather_mean_dma for device {features.device}")
    return GatherMean.apply(features, idx, mask, fwd, True)
