from graphsage_torch.train.config import ExperimentConfig, ModelConfig, TrainConfig, PRESETS
from graphsage_torch.train.trainer import Trainer, make_optimizer, reference_splits
from graphsage_torch.train.full_graph import FullGraphTrainer
from graphsage_torch.train.unsupervised import UnsupervisedTrainer
from graphsage_torch.train.experiments import run_cora, run_preset, run_pubmed

__all__ = [
    "ExperimentConfig",
    "ModelConfig",
    "TrainConfig",
    "PRESETS",
    "Trainer",
    "FullGraphTrainer",
    "UnsupervisedTrainer",
    "make_optimizer",
    "reference_splits",
    "run_preset",
    "run_cora",
    "run_pubmed",
]
