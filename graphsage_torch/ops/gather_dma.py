"""Masked gather-mean with asynchronous row copies: Hopper kernel
``csrc/gather_mean_dma.cu``, the port of
``graphsage_tpu/ops/pallas_gather.py:_gather_mean_kernel`` (the ``"dma"``
route of :func:`graphsage_torch.ops.aggregate.gather_mean`).

``gather_mean_dma(features[N, F] f32, idx[B, k], mask[B, k]) -> [B, F]`` f32
is the same function as :func:`graphsage_torch.ops.gather_mean.gather_mean`;
the kernel differs in kind: each valid neighbour row is copied into a
two-slot ring in shared memory by ``cp.async`` while the previous row is
added. Its backward is the same scatter-mean, through the shared
:class:`~graphsage_torch.ops.gather_mean.GatherMean` Function (the JAX
package used XLA's ``segment_sum`` there). The table is read as f32, as the
TPU kernel reads it.

A CUDA tensor goes to the kernel (or an exception); a CPU tensor goes to the
plain PyTorch version :func:`gather_mean_dma_plain`. Ids in masked slots are
never read and may hold anything; ids in valid slots must lie in ``[0, N)``.
"""

from __future__ import annotations

import torch

from graphsage_torch.ops import _build
from graphsage_torch.ops.gather_mean import GatherMean, _check, gather_mean_plain

# Kernel launches since the last reset (a run sets it to 0 and reads it back
# to show that its path went through the kernel).
launches = 0

# The plain version: the function is kernel 1's, so its plain version is too.
gather_mean_dma_plain = gather_mean_plain


def _launch(features: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    global launches
    b, k = idx.shape
    f = features.shape[1]
    out = torch.empty((b, f), dtype=torch.float32, device=features.device)
    if b == 0 or f == 0:
        return out
    stream = torch.cuda.current_stream(features.device).cuda_stream
    with torch.cuda.device(features.device):
        err = _build.library().gsage_gather_mean_dma_f32(
            features.data_ptr(), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, k, f, stream,
        )
    _build.check(err, "gather_mean_dma kernel")
    launches += 1
    return out


def gather_mean_dma(
    features: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked gather-mean ``[B, F]`` f32 of an f32 table (see module
    docstring)."""
    _check(features, idx, mask)
    if features.dtype != torch.float32:
        raise TypeError(f"features must be float32, got {features.dtype}")
    if features.device.type == "cpu":
        fwd = gather_mean_dma_plain
    elif features.device.type == "cuda":
        fwd = _launch
    else:
        raise ValueError(f"no gather_mean_dma for device {features.device}")
    return GatherMean.apply(features, idx, mask, fwd)
