"""Evaluation metrics in numpy: a copy of ``graphsage_tpu/utils/metrics.py``
(no sklearn dependency).

The reference reports sklearn ``f1_score(average="micro")`` over the 500-node
validation split (reference graphsage/model.py:105). For single-label
multi-class prediction, micro-F1 is exactly accuracy; macro-F1 is also
provided for richer reporting.
"""

from __future__ import annotations

import numpy as np


def accuracy(y_true, y_pred) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if y_true.size == 0:
        return 0.0
    return float((y_true == y_pred).mean())


def micro_f1(y_true, y_pred) -> float:
    """Micro-averaged F1.

    Single-label (1-D class-id inputs): equals accuracy. Multilabel (2-D
    multi-hot ``[N, C]`` inputs): pooled ``2*TP / (2*TP + FP + FN)`` over
    every (example, class) decision — the PPI-family headline metric.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.ndim == 2 and y_true.shape == y_pred.shape and y_true.shape[-1] > 1:
        t = y_true != 0
        p = y_pred != 0
        tp = np.sum(t & p)
        denom = 2 * tp + np.sum(~t & p) + np.sum(t & ~p)
        return float(2 * tp / denom) if denom else 0.0
    return accuracy(y_true, y_pred)


def macro_f1(y_true, y_pred, num_classes: int | None = None) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.ndim == 2 and y_true.shape == y_pred.shape and y_true.shape[-1] > 1:
        # Multilabel: per-class F1 over the class's own binary decisions.
        t = y_true != 0
        p = y_pred != 0
        tp = np.sum(t & p, axis=0)
        denom = 2 * tp + np.sum(~t & p, axis=0) + np.sum(t & ~p, axis=0)
        f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
        return float(f1.mean())
    y_true = y_true.reshape(-1)
    y_pred = y_pred.reshape(-1)
    if num_classes is None:
        num_classes = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    f1s = []
    for c in range(num_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return float(np.mean(f1s))
