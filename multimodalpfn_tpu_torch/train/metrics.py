"""Validation metrics (score <-> error convention), numpy.

The JAX package's registry (`multimodalpfn_tpu/train/metrics.py`) wraps
scikit-learn's metrics; the port imports no scikit-learn, so it carries numpy
copies of those it serves: ``log_loss`` (the fine-tune default) and
``accuracy`` (`tests/test_torch_finetune.py`), and the regression scorers
``mse``, ``rmse``, ``mae``, ``medae``, ``r2``, ``mape``, ``smape`` and, on
scipy, ``spearmanr`` and ``pearsonr`` (`tests/test_torch_finetune_regression.py`),
each equal to scikit-learn 1.9.0's (or the JAX registry's own formula). The
other classification scorers wait. ``error = optimum - score`` for
greater-is-better metrics, ``error = score`` otherwise, so the fine-tuning
loop always minimizes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
from scipy import stats
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


def _reg_targets(y_true, y_pred, floating: bool = True, sample_weight=None):
    """scikit-learn's ``_check_reg_targets(_with_floating_dtype)`` for one
    output: both as ``(n, 1)`` columns; with ``floating``, both (and the
    weights) in the widest floating dtype among the three (float64 if none
    floats)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if len(y_true) != len(y_pred):
        raise ValueError(f"Found input variables with inconsistent numbers of samples: "
                         f"[{len(y_true)}, {len(y_pred)}]")
    if floating:
        arrays = [y_true, y_pred] + ([] if sample_weight is None else [np.asarray(sample_weight)])
        floats = [a.dtype for a in arrays if a.dtype.kind == "f"]
        dtype = np.result_type(*floats) if floats else np.float64
        y_true, y_pred = y_true.astype(dtype, copy=False), y_pred.astype(dtype, copy=False)
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight, dtype=dtype).reshape(-1)
    return y_true.reshape(len(y_true), -1), y_pred.reshape(len(y_pred), -1), sample_weight


def mean_squared_error(y_true, y_pred) -> float:
    y_true, y_pred, _ = _reg_targets(y_true, y_pred)
    return float(np.average(np.average((y_true - y_pred) ** 2, axis=0)))


def root_mean_squared_error(y_true, y_pred) -> float:
    """The JAX registry's ``rmse``: ``sqrt(mean_squared_error)``."""
    return float(np.sqrt(mean_squared_error(y_true, y_pred)))


def mean_absolute_error(y_true, y_pred) -> float:
    y_true, y_pred, _ = _reg_targets(y_true, y_pred)
    return float(np.average(np.average(np.abs(y_pred - y_true), axis=0)))


def median_absolute_error(y_true, y_pred) -> float:
    y_true, y_pred, _ = _reg_targets(y_true, y_pred, floating=False)
    return float(np.average(np.median(np.abs(y_pred - y_true), axis=0)))


def mean_absolute_percentage_error(y_true, y_pred) -> float:
    y_true, y_pred, _ = _reg_targets(y_true, y_pred)
    eps = np.asarray(np.finfo(np.float64).eps, dtype=y_true.dtype)
    mape = np.abs(y_pred - y_true) / np.maximum(np.abs(y_true), eps)
    return float(np.average(np.average(mape, axis=0)))


def r2_score(y_true, y_pred, sample_weight=None) -> float:
    """scikit-learn 1.9.0's ``r2_score`` (``force_finite=True``): 1 for a
    perfect prediction, 0 for an imperfect one of a constant target, NaN
    below two samples."""
    y_true, y_pred, sample_weight = _reg_targets(y_true, y_pred, sample_weight=sample_weight)
    if len(y_pred) < 2:
        return float("nan")
    weight = 1.0 if sample_weight is None else sample_weight[:, None]
    numerator = np.sum(weight * (y_true - y_pred) ** 2, axis=0)
    denominator = np.sum(
        weight * (y_true - np.average(y_true, axis=0, weights=sample_weight)) ** 2, axis=0
    )
    nonzero_denominator, nonzero_numerator = denominator != 0, numerator != 0
    scores = np.ones([y_true.shape[1]], dtype=numerator.dtype)
    valid = nonzero_denominator & nonzero_numerator
    scores[valid] = 1 - numerator[valid] / denominator[valid]
    scores[nonzero_numerator & ~nonzero_denominator] = 0.0
    return float(np.average(scores))


def smape(y_true, y_pred) -> float:
    """The JAX registry's symmetric MAPE (reference `ag_metrics.py:593-597`):
    an eps-guarded denominator, averaged over rows."""
    y_true, y_pred = np.asarray(y_true, float), np.asarray(y_pred, float)
    eps = np.finfo(np.float64).eps
    return float(np.average(np.abs(y_pred - y_true) / np.maximum(np.abs(y_true) + np.abs(y_pred), eps)))


def spearmanr(y_true, y_pred) -> float:
    return float(stats.spearmanr(y_true, y_pred)[0])


def pearsonr(y_true, y_pred) -> float:
    return float(stats.pearsonr(y_true, y_pred)[0])


METRICS: dict[str, Scorer] = {
    "accuracy": Scorer("accuracy", accuracy, 1.0, True, needs_proba=True),
    "log_loss": Scorer("log_loss", log_loss, 0.0, False, needs_proba=True),
    "mse": Scorer("mse", mean_squared_error, 0.0, False),
    "rmse": Scorer("rmse", root_mean_squared_error, 0.0, False),
    "mae": Scorer("mae", mean_absolute_error, 0.0, False),
    "medae": Scorer("medae", median_absolute_error, 0.0, False),
    "r2": Scorer("r2", r2_score, 1.0, True),
    "mape": Scorer("mape", mean_absolute_percentage_error, 0.0, False),
    "smape": Scorer("smape", smape, 0.0, False),
    "spearmanr": Scorer("spearmanr", spearmanr, 1.0, True),
    "pearsonr": Scorer("pearsonr", pearsonr, 1.0, True),
}


def get_scorer(name: str) -> Scorer:
    if name not in METRICS:
        raise ValueError(f"Unknown or not yet ported metric {name}; available: {sorted(METRICS)}")
    return METRICS[name]
