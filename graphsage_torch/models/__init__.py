from graphsage_torch.models.layers import (
    SAGELayer,
    apply_full_graph_maxpool_layer,
    apply_full_graph_mean_layer,
    apply_sage_layer,
    combined_input_dim,
    masked_lstm,
    split_mean_weight,
)
from graphsage_torch.models.graphsage import GraphSAGE, Frontier

__all__ = [
    "SAGELayer",
    "apply_sage_layer",
    "apply_full_graph_mean_layer",
    "apply_full_graph_maxpool_layer",
    "combined_input_dim",
    "masked_lstm",
    "split_mean_weight",
    "GraphSAGE",
    "Frontier",
]
