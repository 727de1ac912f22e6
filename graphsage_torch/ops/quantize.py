"""Int8 per-row quantized tables: the counterpart of
``graphsage_tpu/ops/quantize.py``.

The feature table is frozen (the reference's ``nn.Embedding`` with
``requires_grad=False``, quirk Q12), so it can be quantized once, at load
time: ``N * F`` int8 bytes and ``4 * N`` bytes of scales, a quarter of the
f32 table and half of the bf16 one, and the deepest hop's gather moves int8
rows. The same holds for the layer-0 cache and for the serving tier's
embedding table, which is rebuilt at each refresh.

Quantization is symmetric per row: ``scale[n] = max|x[n, :]| / 127``,
``q = round(x / scale)`` (to nearest even, clipped to ±127); a row of zeros
gets scale 1. The formula is JAX's, operation for operation, so the two
packages quantize the same table to the same bits.

On the card the masked mean of int8 rows is kernel 1's int8 route
(:func:`graphsage_torch.ops.gather_mean.gather_mean_int8`); a row lookup
(:func:`gather_dequant`) is two ``index_select``s. JAX's lane view of the
scale column works around a row-gather cliff of the TPU and has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from graphsage_torch.ops.gather_mean import gather_mean_int8


@dataclasses.dataclass(frozen=True)
class QuantizedTable:
    """``dequant = q * scale`` (row-broadcast): ``q`` int8 ``[N, F]``,
    ``scale`` f32 ``[N, 1]``, both tensors or both numpy arrays.
    ``shape`` and ``dtype`` are ``q``'s, so code that sizes a table by its
    shape and itemsize sees the int8 width."""

    q: Any
    scale: Any

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.q.shape)) + 4 * int(np.prod(self.scale.shape))

    def to(self, device) -> "QuantizedTable":
        return QuantizedTable(self.q.to(device), self.scale.to(device))


def is_quantized(table) -> bool:
    return isinstance(table, QuantizedTable)


def quantize_features(x) -> QuantizedTable:
    """Quantize a dense ``[N, F]`` table to int8 with per-row symmetric
    scales: numpy in, numpy out; a tensor in, tensors out (on its device)."""
    if isinstance(x, np.ndarray):
        xf = x.astype(np.float32, copy=False)
        maxabs = np.max(np.abs(xf), axis=1, keepdims=True)
        scale = np.where(maxabs > 0, maxabs / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(xf / scale), -127, 127).astype(np.int8)
        return QuantizedTable(q=q, scale=scale)
    if x.dim() != 2:
        raise ValueError(f"quantize_features takes an [N, F] table, got {tuple(x.shape)}")
    return quantize_rows(x)


def quantize_rows(x: torch.Tensor) -> QuantizedTable:
    """Row quantization over the last axis of any rank: ``[..., F]`` -> q
    ``[..., F]`` int8 and scale ``[..., 1]`` f32, on ``x``'s device (the
    serving tier's refreshed table, the layer-0 cache)."""
    xf = x.to(torch.float32)
    maxabs = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(maxabs > 0, maxabs / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedTable(q=q, scale=scale)


def dequantize(qt: QuantizedTable, dtype=torch.float32) -> torch.Tensor:
    """The dense table ``q * scale`` (materializes ``[N, F]``: the paths that
    want dense rows, the full-graph layers and the cache build)."""
    return (qt.q.to(torch.float32) * qt.scale).to(dtype)


def gather_dequant(qt: QuantizedTable, ids: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Row lookup ``dequantize(qt)[ids]`` ``[*ids.shape, F]`` that moves int8
    rows: ``q``'s rows and their scales by ``index_select``."""
    flat = ids.reshape(-1).long()
    rows = qt.q.index_select(0, flat).to(torch.float32) * qt.scale.index_select(0, flat)
    return rows.to(dtype).reshape(*ids.shape, qt.q.shape[1])


def gather_mean_dequant(qt: QuantizedTable, idx: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Masked mean of dequantized neighbour rows: ``[..., k]`` ids and mask
    -> ``[..., F]`` f32 (kernel 1's int8 route on the card), the int8
    counterpart of :func:`graphsage_torch.ops.aggregate.gather_mean`."""
    k = idx.shape[-1]
    out = gather_mean_int8(qt.q, qt.scale, idx.reshape(-1, k).contiguous(),
                           mask.reshape(-1, k).contiguous())
    return out.reshape(*idx.shape[:-1], qt.q.shape[1])


def dense_host_view(features) -> np.ndarray:
    """A dense numpy view of a feature table on the host (dequantized if
    needed), for preprocessing that wants raw rows."""
    if is_quantized(features):
        q, scale = features.q, features.scale
        if isinstance(q, torch.Tensor):
            q, scale = q.cpu().numpy(), scale.cpu().numpy()
        return q.astype(np.float32) * scale
    if isinstance(features, torch.Tensor):
        return features.detach().to(torch.float32).cpu().numpy()
    return np.asarray(features)


def project_table(qt: QuantizedTable, w: torch.Tensor) -> torch.Tensor:
    """``dequantize(qt) @ w`` ``[N, d_out]`` f32 without the dense table:
    the per-row scales commute with the product, and int8 values are exact
    in bf16, so the raw values are multiplied in ``w``'s dtype and the
    scale applied once, in f32, after. (A bf16 product is rounded to bf16
    before the scale, where JAX keeps its f32 accumulator.)"""
    return (qt.q.to(w.dtype) @ w).to(torch.float32) * qt.scale
