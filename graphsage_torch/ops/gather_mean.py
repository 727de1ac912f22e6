"""Fused masked gather-mean: Hopper kernel 1 (``csrc/gather_mean.cu``),
the port of ``graphsage_tpu/ops/pallas_onehot.py:_kernel``.

``gather_mean(features[N, F], idx[B, k], mask[B, k]) -> [B, F]`` f32:

    out[b] = sum_j mask[b, j] * features[idx[b, j]] / max(sum_j mask[b, j], 1)

``normalize=False`` is the sum mode: the same sums undivided (the owner side
of the node-sharded feature store's exchange); its backward is the
scatter-mean's sum mode, unit weights per valid slot.

A CUDA tensor goes to the kernel (or an exception); a CPU tensor goes to the
plain PyTorch version :func:`gather_mean_plain`, which also serves as the
reference the kernel is held against on the card. Ids in masked slots are
never read and may hold anything; ids in valid slots must lie in ``[0, N)``.

Both devices go through one ``autograd.Function`` (:class:`GatherMean`,
which the DMA route of :mod:`graphsage_torch.ops.gather_dma` shares), whose
backward is the scatter-mean of :mod:`graphsage_torch.ops.scatter_mean` (its
kernel on the card, its plain version on the CPU): the CPU runs the same
backward formula as the card, not an autograd derivation of the plain
forward. The gradient has the table's dtype; its sums are f32.

An int8 table (:class:`graphsage_torch.ops.quantize.QuantizedTable`: ``q``
int8 ``[N, F]`` and per-row ``scale`` f32 ``[N, 1]``) goes through the same
kernel as a third row type, :func:`gather_mean_int8`: each valid slot's row
weighted by its scale, the denominator the valid count. Forward only: an
int8 table is frozen.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from graphsage_torch.ops import _build
from graphsage_torch.ops.scatter_mean import scatter_mean

# Kernel launches since the last reset (a run sets it to 0 and reads it back
# to show that its path went through the kernel), and those of them in the
# sum mode (``normalize=False``).
launches = 0
sum_launches = 0


def gather_mean_plain(
    features: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
    normalize: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version: gather ``[B, k, F]``, masked mean (or,
    without ``normalize``, sum) in f32."""
    safe = torch.where(mask, idx, torch.zeros_like(idx)).long()
    w = mask.to(torch.float32)[..., None]
    total = (features[safe].to(torch.float32) * w).sum(dim=-2)
    return total / w.sum(dim=-2).clamp(min=1.0) if normalize else total


# The C entry point for each table dtype (an int8 table also passes its
# scales).
_ENTRIES = {torch.float32: "gsage_gather_mean_f32",
            torch.bfloat16: "gsage_gather_mean_bf16",
            torch.int8: "gsage_gather_mean_int8"}


def _check(features: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
           dtypes=(torch.float32, torch.bfloat16)) -> None:
    if features.dim() != 2:
        raise ValueError(f"features must be [N, F], got {tuple(features.shape)}")
    if idx.dim() != 2 or idx.shape != mask.shape:
        raise ValueError(
            f"idx and mask must both be [B, k], got {tuple(idx.shape)} and "
            f"{tuple(mask.shape)}"
        )
    if features.dtype not in dtypes:
        raise TypeError(f"features must be one of {dtypes}, got {features.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if not (features.device == idx.device == mask.device):
        raise ValueError(
            f"features, idx and mask lie on {features.device}, {idx.device} "
            f"and {mask.device}"
        )
    if not (features.is_contiguous() and idx.is_contiguous() and mask.is_contiguous()):
        raise ValueError("features, idx and mask must be contiguous")


def _launch(features: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
            scale: torch.Tensor | None = None, normalize: bool = True) -> torch.Tensor:
    global launches, sum_launches
    b, k = idx.shape
    f = features.shape[1]
    out = torch.empty((b, f), dtype=torch.float32, device=features.device)
    if b == 0 or f == 0:
        return out
    fn = getattr(_build.library(), _ENTRIES[features.dtype])
    stream = torch.cuda.current_stream(features.device).cuda_stream
    with torch.cuda.device(features.device):
        err = fn(features.data_ptr(), None if scale is None else scale.data_ptr(),
                 idx.data_ptr(), mask.data_ptr(), out.data_ptr(), b, k, f, int(normalize),
                 stream)
    _build.check(err, "gather_mean kernel")
    launches += 1
    sum_launches += not normalize
    return out


class GatherMean(torch.autograd.Function):
    """``apply(features, idx, mask, fwd, normalize)`` runs ``fwd(features,
    idx, mask)`` (a kernel wrapper or a plain version, of the mean or of the
    sum as ``normalize`` says); the backward scatters the cotangent with
    :func:`scatter_mean` in the same mode and casts it to the table's
    dtype."""

    @staticmethod
    def forward(ctx, features, idx, mask, fwd, normalize=True):
        ctx.save_for_backward(idx, mask)
        ctx.num_rows, ctx.dtype, ctx.normalize = features.shape[0], features.dtype, normalize
        return fwd(features, idx, mask)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        idx, mask = ctx.saved_tensors
        dx = scatter_mean(grad.to(torch.float32).contiguous(), idx, mask, ctx.num_rows,
                          normalize=ctx.normalize)
        return dx.to(ctx.dtype), None, None, None, None


def _as_bf16(fwd: Callable) -> Callable:
    return lambda features, idx, mask: fwd(features.to(torch.bfloat16), idx, mask)


def gather_mean(
    features: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    bf16: bool = False,
    normalize: bool = True,
) -> torch.Tensor:
    """Masked gather-mean ``[B, F]`` f32 (see module docstring), or the sum
    mode's masked sum with ``normalize=False``.

    ``bf16=True`` rounds the table to bfloat16 first, as the TPU kernel's
    flag does; a bfloat16 table is read as it is. Sums are f32 either way,
    and the gradient keeps the dtype of the table passed in.
    """
    _check(features, idx, mask)
    if features.device.type == "cpu":
        fwd = functools.partial(gather_mean_plain, normalize=normalize)
    elif features.device.type == "cuda":
        fwd = functools.partial(_launch, normalize=normalize)
    else:
        raise ValueError(f"no gather_mean for device {features.device}")
    if bf16 and features.dtype != torch.bfloat16:
        fwd = _as_bf16(fwd)
    return GatherMean.apply(features, idx, mask, fwd, normalize)


def gather_mean_int8_plain(
    q: torch.Tensor, scale: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
    normalize: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version of the int8 route: one slot at a time,
    ``q[id] * (mask * scale[id])`` summed in f32, over the valid count (no
    ``[B, k, F]`` transient); the sums undivided without ``normalize``."""
    safe = torch.where(mask, idx, torch.zeros_like(idx)).long()
    m = mask.to(torch.float32)
    w = m * scale.reshape(-1)[safe]
    total = torch.zeros((idx.shape[0], q.shape[1]), dtype=torch.float32, device=q.device)
    for j in range(idx.shape[1]):
        total = total + q[safe[:, j]].to(torch.float32) * w[:, j:j + 1]
    return total / m.sum(dim=1, keepdim=True).clamp(min=1.0) if normalize else total


def gather_mean_int8(
    q: torch.Tensor, scale: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
    normalize: bool = True,
) -> torch.Tensor:
    """Masked gather-mean ``[B, F]`` f32 of the int8 table ``q * scale``
    (see module docstring), or its sums without ``normalize`` (the
    node-sharded store's owner side); no gradient."""
    _check(q, idx, mask, dtypes=(torch.int8,))
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if scale.numel() != q.shape[0] or scale.device != q.device or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous [N, 1] = [{q.shape[0]}, 1] on "
                         f"{q.device}, got {tuple(scale.shape)} on {scale.device}")
    if q.device.type == "cpu":
        return gather_mean_int8_plain(q, scale, idx, mask, normalize)
    if q.device.type != "cuda":
        raise ValueError(f"no gather_mean for device {q.device}")
    return _launch(q, idx, mask, scale, normalize)
