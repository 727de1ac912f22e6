from graphsage_torch.utils.metrics import accuracy, macro_f1, micro_f1

__all__ = ["accuracy", "micro_f1", "macro_f1"]
