from graphsage_torch.data.graph import (
    Graph,
    build_graph,
    disjoint_union,
    quantize_graph,
    with_cached_layer0,
)
from graphsage_torch.data.loaders import (
    load_cora,
    load_cora_lazy,
    load_pubmed,
    load_pubmed_lazy,
)
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
    "load_cora_lazy",
    "load_pubmed",
    "load_pubmed_lazy",
    "power_law_graph",
    "shard_features_from_loader",
    "synth_cora_files",
    "synth_pubmed_files",
    "synthetic_cora_graph",
    "synthetic_ppi_graphs",
    "synthetic_pubmed_graph",
    "with_cached_layer0",
]


def __getattr__(name: str):
    # The loader store lives with the sharded trainers, which import this
    # package: it is resolved at first access, not at import.
    if name == "shard_features_from_loader":
        from graphsage_torch.parallel.feature_store import shard_features_from_loader

        return shard_features_from_loader
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
