"""Carry parameters from the JAX package into the port.

The JAX ``SAGEParams`` pytree, turned into numpy by the caller
(``np.asarray`` on each leaf), has the form
``{"layers": [{"weight": ndarray, "pool_weight": ..., ...}, ...],
"head": ndarray}``: each layer's entries are named as the fields of the JAX
``SAGELayerParams`` (``weight``, ``pool_weight``, ``pool_bias``,
``lstm_wx``, ``lstm_wh``, ``lstm_b``), and a field left ``None`` or out is
one the layer does not have. Both packages store weights ``[in, out]``, so
loading is a plain copy; the port never sees a JAX object.
"""

from __future__ import annotations

import numpy as np
import torch

from graphsage_torch.models.graphsage import GraphSAGE

LAYER_FIELDS = ("weight", "pool_weight", "pool_bias", "lstm_wx", "lstm_wh", "lstm_b")


def _copy(param: torch.nn.Parameter, value, what: str) -> None:
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(
            f"{what}: shape {tuple(value.shape)} does not match the model's "
            f"{tuple(param.shape)}"
        )
    param.copy_(value)


@torch.no_grad()
def params_from_numpy(model: GraphSAGE, tree: dict) -> GraphSAGE:
    """Load ``tree`` (see module docstring) into ``model`` in place and
    return it. A field that the tree and the layer do not both have raises,
    as does a shape that differs."""
    layers = tree["layers"]
    if len(layers) != len(model.layers):
        raise ValueError(
            f"tree has {len(layers)} layers, the model {len(model.layers)}"
        )
    for i, (layer, p) in enumerate(zip(model.layers, layers)):
        unknown = set(p) - set(LAYER_FIELDS)
        if unknown:
            raise ValueError(f"layers[{i}]: unknown fields {sorted(unknown)}")
        for name in LAYER_FIELDS:
            given = p.get(name) is not None
            if given != hasattr(layer, name):
                raise ValueError(
                    f"layers[{i}].{name}: the tree "
                    f"{'has' if given else 'lacks'} it and the model's "
                    f"{layer.aggregator} layer {'lacks' if given else 'has'} it"
                )
            if given:
                _copy(getattr(layer, name), p[name], f"layers[{i}].{name}")
    _copy(model.head, tree["head"], "head")
    return model
