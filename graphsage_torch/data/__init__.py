from graphsage_torch.data.graph import (
    Graph,
    build_graph,
    disjoint_union,
    quantize_graph,
    with_cached_layer0,
)
from graphsage_torch.data.loaders import load_cora, load_pubmed
from graphsage_torch.data.synthetic import (
    power_law_graph,
    synth_cora_files,
    synth_pubmed_files,
    synthetic_cora_graph,
    synthetic_ppi_graphs,
    synthetic_pubmed_graph,
)

__all__ = [
    "Graph",
    "build_graph",
    "disjoint_union",
    "quantize_graph",
    "load_cora",
    "load_pubmed",
    "power_law_graph",
    "synth_cora_files",
    "synth_pubmed_files",
    "synthetic_cora_graph",
    "synthetic_ppi_graphs",
    "synthetic_pubmed_graph",
    "with_cached_layer0",
]
