"""Measured device-memory accounting: the counterpart of
``graphsage_tpu/utils/memory.py``.

What is resident on the card, read from PyTorch's CUDA caching allocator
(``torch.cuda.memory_stats`` for each device's total of live allocations,
``torch.cuda.memory_snapshot`` for the blocks): the per-device totals catch
aggregate bloat, the largest live block a whole ``[N, F]`` table where none
should be. Sizes are the allocator's blocks, each request rounded up (to
512 bytes and more), so they bound the tensors' bytes from above. The CPU has
no such accounting: asking for it raises.
"""

from __future__ import annotations

import torch

from graphsage_torch._device import resolve_device


def _cuda_devices(device) -> list[int]:
    if device is None:
        resolve_device("cuda")
        return list(range(torch.cuda.device_count()))
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"device memory is measured on a CUDA device, not {dev}: the "
            "CPU has no allocator statistics to read"
        )
    return [dev.index if dev.index is not None else torch.cuda.current_device()]


def live_device_bytes(min_bytes: int = 0, device=None) -> dict:
    """Measured bytes of live allocations, per device and in total, on
    ``device`` (every visible card when ``None``).

    ``buffers`` lists the live blocks of at least ``min_bytes``, largest
    first; the totals count everything."""
    per_device: dict[str, int] = {}
    buffers: list[dict] = []
    for idx in _cuda_devices(device):
        stats = torch.cuda.memory_stats(idx)
        per_device[f"cuda:{idx}"] = int(stats.get("allocated_bytes.all.current", 0))
    wanted = {int(k.split(":")[1]) for k in per_device}
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] not in wanted:
            continue
        for block in seg["blocks"]:
            if block["state"] == "active_allocated" and block["size"] >= min_bytes:
                buffers.append({"device": f"cuda:{seg['device']}",
                                "nbytes": int(block["size"])})
    buffers.sort(key=lambda b: -b["nbytes"])
    return {
        "per_device_bytes": per_device,
        "total_bytes": sum(per_device.values()),
        "largest_buffer_bytes": buffers[0]["nbytes"] if buffers else 0,
        "buffers": buffers,
    }


def max_live_buffer_bytes(device=None) -> int:
    """The largest single live block (bytes) on ``device``."""
    return live_device_bytes(device=device)["largest_buffer_bytes"]


def assert_no_buffer_at_least(limit_bytes: int, context: str = "", device=None) -> None:
    """Raise if any single live block on ``device`` is ``>= limit_bytes``
    (e.g. a whole ``[N, F]`` table where only shards should be)."""
    offenders = live_device_bytes(min_bytes=limit_bytes, device=device)["buffers"]
    if offenders:
        desc = ", ".join(f"{b['nbytes']}B on {b['device']}" for b in offenders[:5])
        raise AssertionError(
            f"live device buffer(s) >= {limit_bytes} bytes"
            f"{' (' + context + ')' if context else ''}: {desc}"
        )
