"""Validation metrics (score <-> error convention), numpy.

The JAX package's registry (`multimodalpfn_tpu/train/metrics.py`) wraps
scikit-learn's metrics; the port imports no scikit-learn, so it carries numpy
copies of the two it serves: ``log_loss`` (the fine-tune default) and
``accuracy``, equal to scikit-learn 1.9.0's (`tests/test_torch_finetune.py`).
The rest of the registry waits. ``error = optimum - score`` for
greater-is-better metrics, ``error = score`` otherwise, so the fine-tuning
loop always minimizes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
from scipy.special import xlogy


@dataclass(frozen=True)
class Scorer:
    name: str
    fn: Callable[..., float]
    optimum: float
    greater_is_better: bool
    needs_proba: bool = False

    def __call__(self, y_true, y_pred) -> float:
        return float(self.fn(y_true, y_pred))

    def convert_score_to_error(self, score: float) -> float:
        return self.optimum - score if self.greater_is_better else score

    def convert_error_to_score(self, error: float) -> float:
        return self.optimum - error if self.greater_is_better else error


def _proba_to_labels(y_pred):
    y_pred = np.asarray(y_pred)
    return y_pred.argmax(axis=-1) if y_pred.ndim > 1 else (y_pred > 0.5).astype(int)


def accuracy(y_true, y_proba) -> float:
    """scikit-learn's ``accuracy_score(y_true, argmax(y_proba))``."""
    return float(np.average(np.asarray(y_true).reshape(-1) == _proba_to_labels(y_proba)))


def log_loss(y_true, y_proba) -> float:
    """scikit-learn 1.9.0's ``log_loss(y_true, y_proba)``: the columns of
    ``y_proba`` are the sorted labels of ``y_true``; probabilities are clipped
    to [eps, 1 - eps] of their dtype; the mean of the per-row losses."""
    y_true = np.asarray(y_true).reshape(-1)
    p = np.asarray(y_proba)
    if p.dtype not in (np.float32, np.float64):
        p = p.astype(np.float64)
    if p.ndim == 1:
        p = p[:, None]
    if p.shape[1] == 1:
        p = np.concatenate([1 - p, p], axis=1)
    if p.max() > 1 or p.min() < 0:
        raise ValueError("y_proba must lie in [0, 1]")
    classes = np.unique(y_true)
    if len(classes) == 1:
        raise ValueError(f"y_true contains only one label ({classes[0]})")
    if len(classes) != p.shape[1]:
        raise ValueError(
            f"y_true and y_proba contain different number of classes: {len(classes)} vs {p.shape[1]}"
        )
    onehot = (y_true[:, None] == classes[None, :]).astype(p.dtype)
    eps = np.finfo(p.dtype).eps
    loss = -np.sum(xlogy(onehot, np.clip(p, eps, 1 - eps)), axis=1)
    return float(np.average(loss))


METRICS: dict[str, Scorer] = {
    "accuracy": Scorer("accuracy", accuracy, 1.0, True, needs_proba=True),
    "log_loss": Scorer("log_loss", log_loss, 0.0, False, needs_proba=True),
}


def get_scorer(name: str) -> Scorer:
    if name not in METRICS:
        raise ValueError(f"Unknown or not yet ported metric {name}; available: {sorted(METRICS)}")
    return METRICS[name]
