"""Model weights from the seed, drawn on the device in one call.

Glorot-uniform ``[fan_in, fan_out]`` leaves, the initialisation the
GraphSAGE reference uses: one per layer (``[d_in, d_out]``, or with
``concat_self`` ``[2 d_in, d_out]``, the rows of the node's own half first)
and the ``[hidden[-1], classes]`` head, in the order of the program's
``named_parameters``.
"""

from __future__ import annotations

import math

import torch

from perfbench.inputs.seeds import sub_seed


def leaf_shapes(config: dict) -> dict[str, tuple[int, int]]:
    shapes, d_in = {}, config["num_features"]
    rows = 2 if config["model"].get("concat_self") else 1
    for i, d_out in enumerate(config["model"]["hidden_dims"]):
        shapes[f"layers.{i}.weight"] = (rows * d_in, d_out)
        d_in = d_out
    shapes["head"] = (d_in, config["num_classes"])
    return shapes


def make_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    shapes = leaf_shapes(config)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.rand(sum(a * b for a, b in shapes.values()), generator=g, device=device)
    out, at = {}, 0
    for name, (a, b) in shapes.items():
        limit = math.sqrt(6.0 / (a + b))
        out[name] = (flat[at:at + a * b].view(a, b) * 2.0 - 1.0) * limit
        at += a * b
    return out
