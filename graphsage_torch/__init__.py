"""graphsage_torch — the PyTorch/CUDA port of ``graphsage_tpu``.

It mirrors the JAX package's module layout and names; inside, it is plain
PyTorch (``nn.Module``s, functions on tensors, ``torch.Generator``s), and
each Pallas kernel of the JAX package becomes a kernel written by hand for
Hopper (``csrc/``, built at first use by :mod:`graphsage_torch.ops._build`).
It imports neither JAX nor anything of ``graphsage_tpu``.

Every entry point places its tensors on ``cuda`` unless the caller passes
``device="cpu"``, and raises when asked for a card that is not there.

  data    — Graph container, Cora/Pubmed loaders (eager and lazy, Python
            and native C++ parsers), synthetic generators
  ops     — sampler, aggregators, Hopper kernels
  models  — GraphSAGE layers + supervised classifier
  serve   — table and sampled serving tiers
  train   — configs, presets, the sampled, full-graph and unsupervised
            trainers, the CLI
  parallel — the process group, meshes, edge partitioning, the halo
            exchange and its node partitions, the node-sharded store (from
            a table or a row loader), the DP+TP, node-sharded and fully
            sharded trainers (``torch.distributed``)
  examples — the JAX package's examples 01-08 on the port
  utils   — metrics, checkpoints, logging, diagnostics, profiling (the span
            recorder), memory
"""

from time import perf_counter_ns as _perf_counter_ns

# The import's own span (``utils/profiling.py`` exports it): first stamp.
_IMPORT_START_NS = _perf_counter_ns()

from graphsage_torch._device import resolve_device
from graphsage_torch.data.graph import (
    Graph,
    build_graph,
    disjoint_union,
    induced_subgraph,
    quantize_graph,
    relabel_graph,
    with_cached_layer0,
)
from graphsage_torch.ops.quantize import QuantizedTable, dequantize, quantize_features
from graphsage_torch.data.loaders import (
    load_cora,
    load_cora_lazy,
    load_pubmed,
    load_pubmed_lazy,
)
from graphsage_torch.models.graphsage import Frontier, GraphSAGE
from graphsage_torch.serve import ServingEngine
from graphsage_torch.train.config import ExperimentConfig, ModelConfig, PRESETS, TrainConfig
from graphsage_torch.train.experiments import run_cora, run_preset, run_pubmed
from graphsage_torch.train.full_graph import FullGraphTrainer
from graphsage_torch.train.trainer import Trainer
from graphsage_torch.train.unsupervised import (
    UnsupervisedFullyShardedTrainer,
    UnsupervisedShardedTrainer,
    UnsupervisedTrainer,
)
from graphsage_torch.convert import params_from_numpy
from graphsage_torch.parallel.distributed import ShardedTrainer
from graphsage_torch.parallel.feature_store import (
    FullyShardedTrainer,
    ShardedFeatureTrainer,
    build_hub_cache,
    hub_request_fraction,
    shard_features_from_loader,
    sharded_comm_stats,
)
from graphsage_torch.parallel.halo import (
    auto_partition_plan,
    build_node_partition,
    locality_relabel,
)
from graphsage_torch.parallel.mesh import make_mesh

__version__ = "0.1.0"

__all__ = [
    "resolve_device",
    "Graph",
    "build_graph",
    "quantize_graph",
    "with_cached_layer0",
    "induced_subgraph",
    "relabel_graph",
    "disjoint_union",
    "QuantizedTable",
    "quantize_features",
    "dequantize",
    "load_cora",
    "load_cora_lazy",
    "load_pubmed",
    "load_pubmed_lazy",
    "Frontier",
    "GraphSAGE",
    "ServingEngine",
    "ExperimentConfig",
    "ModelConfig",
    "TrainConfig",
    "PRESETS",
    "Trainer",
    "UnsupervisedTrainer",
    "UnsupervisedShardedTrainer",
    "UnsupervisedFullyShardedTrainer",
    "FullGraphTrainer",
    "ShardedTrainer",
    "ShardedFeatureTrainer",
    "build_hub_cache",
    "hub_request_fraction",
    "FullyShardedTrainer",
    "sharded_comm_stats",
    "shard_features_from_loader",
    "make_mesh",
    "auto_partition_plan",
    "build_node_partition",
    "locality_relabel",
    "run_cora",
    "run_pubmed",
    "run_preset",
    "params_from_numpy",
    "__version__",
]

_IMPORT_END_NS = _perf_counter_ns()
