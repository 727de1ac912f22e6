"""Checkpoint and resume: the counterpart of
``graphsage_tpu/utils/checkpoint.py``.

A trainer's state is a flat dict of tensors (``Trainer.state_dict``): the
model's parameters under the JAX ``SAGEParams`` field names
(``params|layers|0|weight``, ``params|head``), the optimizer's per-parameter
state, the sampler's ``torch.Generator`` state and the step. It round-trips
through one ``torch.save`` file (``.pt`` appended when missing), written
atomically: a temp file, then ``os.replace``. Restore loads with
``weights_only=True`` (no pickled code runs) and checks the entries against
a template state, key for key, shape for shape and dtype for dtype.

The JAX package's orbax variants (``save_checkpoint_orbax``,
``restore_checkpoint_orbax``) have no counterpart: the port runs on one
device, and the file above is its only format.
"""

from __future__ import annotations

import os

import torch

SUFFIX = ".pt"


def _path(path: str | os.PathLike) -> str:
    path = os.fspath(path)
    return path if path.endswith(SUFFIX) else path + SUFFIX


def save_checkpoint(path: str | os.PathLike, state: dict[str, torch.Tensor]) -> str:
    """Write ``state`` (a flat dict of tensors) to ``path`` (``.pt``
    appended if missing) and return the path written. Atomic: a temp file,
    then a rename."""
    path = _path(path)
    bad = [k for k, v in state.items() if not isinstance(v, torch.Tensor)]
    if bad:
        raise TypeError(f"checkpoint entries must be tensors: {bad[:5]}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.detach() for k, v in state.items()}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(
    path: str | os.PathLike, template: dict[str, torch.Tensor], map_location=None
) -> dict[str, torch.Tensor]:
    """The state saved at ``path``, checked against ``template`` (e.g. a
    fresh trainer's ``state_dict()``): the same keys, shapes and dtypes, or
    an error. ``map_location`` places the loaded tensors (the trainer's
    device)."""
    path = _path(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    loaded = torch.load(path, map_location=map_location, weights_only=True)
    out = {}
    for key, want in template.items():
        if key not in loaded:
            raise KeyError(f"checkpoint missing {key!r} (has {sorted(loaded)[:5]}...)")
        arr = loaded.pop(key)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(
                f"{key!r}: checkpoint shape {tuple(arr.shape)} != template "
                f"{tuple(want.shape)}")
        if arr.dtype != want.dtype:
            raise ValueError(
                f"{key!r}: checkpoint dtype {arr.dtype} != template {want.dtype} "
                "(a silent cast would mask a bf16/f32 mixup)")
        out[key] = arr
    if loaded:
        raise ValueError(f"checkpoint has extra entries: {sorted(loaded)[:5]}")
    return out
