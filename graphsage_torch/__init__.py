"""graphsage_torch — the PyTorch/CUDA port of ``graphsage_tpu``.

It mirrors the JAX package's module layout and names; inside, it is plain
PyTorch (``nn.Module``s, functions on tensors, ``torch.Generator``s), and
each Pallas kernel of the JAX package becomes a kernel written by hand for
Hopper (``csrc/``, built at first use by :mod:`graphsage_torch.ops._build`).
It imports neither JAX nor anything of ``graphsage_tpu``.

Every entry point places its tensors on ``cuda`` unless the caller passes
``device="cpu"``, and raises when asked for a card that is not there.

  data    — Graph container, Cora/Pubmed loaders, synthetic generators
  ops     — sampler, aggregators, Hopper kernels
  models  — GraphSAGE layers + supervised classifier
  serve   — table and sampled serving tiers
  train   — configs, presets, the sampled trainer and its CLI
  utils   — metrics
"""

from graphsage_torch._device import resolve_device
from graphsage_torch.data.graph import Graph, build_graph
from graphsage_torch.data.loaders import load_cora, load_pubmed
from graphsage_torch.models.graphsage import Frontier, GraphSAGE
from graphsage_torch.serve import ServingEngine
from graphsage_torch.train.config import ExperimentConfig, ModelConfig, PRESETS, TrainConfig
from graphsage_torch.train.experiments import run_preset
from graphsage_torch.train.trainer import Trainer
from graphsage_torch.convert import params_from_numpy

__version__ = "0.1.0"

__all__ = [
    "resolve_device",
    "Graph",
    "build_graph",
    "load_cora",
    "load_pubmed",
    "Frontier",
    "GraphSAGE",
    "ServingEngine",
    "ExperimentConfig",
    "ModelConfig",
    "TrainConfig",
    "PRESETS",
    "Trainer",
    "run_preset",
    "params_from_numpy",
    "__version__",
]
