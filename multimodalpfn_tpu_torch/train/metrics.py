"""Validation metrics (score <-> error convention), numpy.

The JAX package's registry (`multimodalpfn_tpu/train/metrics.py`) wraps
scikit-learn's metrics; the port imports no scikit-learn, so it carries numpy
copies of those it serves: ``log_loss`` (the fine-tune default) and
``accuracy`` (`tests/test_torch_finetune.py`), and the regression scorers
``mse``, ``rmse``, ``mae``, ``medae``, ``r2``, ``mape``, ``smape`` and, on
scipy, ``spearmanr`` and ``pearsonr`` (`tests/test_torch_finetune_regression.py`),
and the classification scorers ``balanced_accuracy``, ``f1``, ``mcc``,
``roc_auc``, ``precision``, ``recall``, ``quadratic_kappa``, ``pac`` and
``average_precision`` (`tests/test_torch_finetune_batch.py`), each equal to
scikit-learn 1.9.0's as the JAX registry calls it (or the JAX registry's own
formula): the same labels, the same sums in the same dtypes.
``error = optimum - score`` for
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


def log_loss(y_true, y_proba, labels=None) -> float:
    """scikit-learn 1.9.0's ``log_loss(y_true, y_proba, labels=labels)``: the
    columns of ``y_proba`` are ``labels`` (default: the sorted labels of
    ``y_true``); probabilities are clipped to [eps, 1 - eps] of their dtype;
    the mean of the per-row losses."""
    y_true = np.asarray(y_true).reshape(-1)
    p = np.asarray(y_proba)
    if p.dtype not in (np.float32, np.float64):
        p = p.astype(np.float64)
    if p.max() > 1 or p.min() < 0:
        raise ValueError("y_proba must lie in [0, 1]")
    classes = np.unique(y_true if labels is None else np.asarray(labels))
    if len(classes) == 1:
        raise ValueError(f"y_true contains only one label ({classes[0]})")
    if p.ndim == 1:
        p = p[:, None]
    if p.shape[1] == 1:
        p = np.concatenate([1 - p, p], axis=1)
    if len(classes) != p.shape[1]:
        raise ValueError(
            f"y_true and y_proba contain different number of classes: {len(classes)} vs {p.shape[1]}"
        )
    onehot = (y_true[:, None] == classes[None, :]).astype(p.dtype)
    eps = np.finfo(p.dtype).eps
    loss = -np.sum(xlogy(onehot, np.clip(p, eps, 1 - eps)), axis=1)
    return float(np.average(loss))


def _labels_and_confusion(y_true, y_pred) -> tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``confusion_matrix(y_true, y_pred)``: rows are true,
    columns predicted labels, over the sorted union of both label sets
    (``unique_labels``)."""
    y_true, y_pred = np.asarray(y_true).reshape(-1), np.asarray(y_pred).reshape(-1)
    if len(y_true) != len(y_pred):
        raise ValueError(f"Found input variables with inconsistent numbers of samples: "
                         f"[{len(y_true)}, {len(y_pred)}]")
    labels = np.union1d(y_true.astype(np.float64), y_pred.astype(np.float64))
    t, p = np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)
    C = np.zeros((len(labels), len(labels)), dtype=np.int64)
    np.add.at(C, (t, p), 1)
    return labels, C


def balanced_accuracy(y_true, y_proba) -> float:
    """``balanced_accuracy_score(y_true, argmax(y_proba))``: the mean recall
    over the labels of y_true (a label only predicted is left out)."""
    _, C = _labels_and_confusion(y_true, _proba_to_labels(y_proba))
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(C) / C.sum(axis=1)
    return float(np.mean(per_class[~np.isnan(per_class)]))


def _prf(y_true, y_proba) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per label (the union of true and predicted ones) of
    ``precision_recall_fscore_support(average=None, zero_division=0)``:
    precision, recall and F1, 0 where a denominator is 0."""
    _, C = _labels_and_confusion(y_true, _proba_to_labels(y_proba))
    tp = np.diag(C)
    pred_sum, true_sum = C.sum(axis=0), C.sum(axis=1)

    def divide(num, den):
        den = np.asarray(den, dtype=np.float64)
        out = np.asarray(num, dtype=np.float64) / np.where(den == 0, 1.0, den)
        out[den == 0] = 0.0
        return out

    f1 = divide(2.0 * tp.astype(np.float64), true_sum.astype(np.float64) + pred_sum.astype(np.float64))
    return divide(tp, pred_sum), divide(tp, true_sum), f1


def f1(y_true, y_proba) -> float:
    """``f1_score(y_true, argmax(y_proba), average="macro")``."""
    return float(np.average(_prf(y_true, y_proba)[2]))


def precision(y_true, y_proba) -> float:
    """``precision_score(..., average="macro", zero_division=0)``."""
    return float(np.average(_prf(y_true, y_proba)[0]))


def recall(y_true, y_proba) -> float:
    """``recall_score(..., average="macro", zero_division=0)``."""
    return float(np.average(_prf(y_true, y_proba)[1]))


def mcc(y_true, y_proba) -> float:
    """``matthews_corrcoef(y_true, argmax(y_proba))``, its multiclass form
    (the binary one is its special case); 0 where undefined."""
    _, C = _labels_and_confusion(y_true, _proba_to_labels(y_proba))
    t_sum = C.sum(axis=1, dtype=np.float64)
    p_sum = C.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(C, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples**2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples**2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ypyp * cov_ytyt))


def quadratic_kappa(y_true, y_proba) -> float:
    """``cohen_kappa_score(y_true, argmax(y_proba), weights="quadratic")``:
    the weights are squared differences of label indices."""
    _, C = _labels_and_confusion(y_true, _proba_to_labels(y_proba))
    C = C.astype(np.float64)
    n = C.shape[0]
    sum0, sum1 = C.sum(axis=0), C.sum(axis=1)
    expected = np.outer(sum0, sum1) / np.sum(sum0)
    w = np.zeros((n, n), dtype=np.float64) + np.arange(n)
    w = (w - w.T) ** 2
    den = np.sum(w * expected)
    if den == 0:
        return float("nan")
    return float(1 - np.sum(w * C) / den)


def pac(y_true, y_proba) -> float:
    """The JAX registry's ``pac``: ``exp(-log_loss)`` of the probabilities
    clipped to [1e-15, 1] in float64, over ``labels=range(n_classes)``."""
    p = np.clip(np.asarray(y_proba, float), 1e-15, 1.0)
    n_classes = p.shape[-1] if p.ndim > 1 else 2
    return float(np.exp(-log_loss(y_true, p, labels=list(range(n_classes)))))


def _clf_curve(y_true: np.ndarray, y_score: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``confusion_matrix_at_thresholds``: false and true
    positives (float64) at each distinct score, scores descending; ``y_true``
    is 0/1."""
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], y_true[order].astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(y_score))[0], [len(y_true) - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps


def _binary_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """``_binary_roc_auc_score``: the trapezoid under ``roc_curve`` (with
    ``drop_intermediate``); NaN when y_true holds one class."""
    if len(np.unique(y_true)) != 2:
        return float("nan")
    fps, tps = _clf_curve(y_true, y_score)
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    fpr, tpr = fps / fps[-1], tps / tps[-1]
    direction = -1 if np.any(np.diff(fpr) < 0) else 1
    return float(direction * np.trapezoid(tpr, fpr))


def roc_auc(y_true, y_proba) -> float:
    """The JAX registry's ``roc_auc``: column 1 of (n, 2) probabilities, the
    binary area (tied scores share their rank); on more classes
    ``roc_auc_score(multi_class="ovo", average="macro")``, the mean over
    pairs of classes of the two one-against-the-other areas."""
    y_true = np.asarray(y_true).reshape(-1)
    p = np.asarray(y_proba)
    if p.ndim > 1 and p.shape[-1] == 2:
        p = p[:, 1]
    classes = np.unique(y_true)
    if p.ndim == 1:
        if len(classes) > 2:
            raise ValueError("multi_class must be in ('ovo', 'ovr')")
        return _binary_roc_auc((y_true == classes[-1]).astype(np.int64), p)
    if not np.allclose(1, p.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc, "
                         "i.e. they should sum up to 1.0 over classes")
    if len(classes) != p.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns in 'y_score'")
    enc = np.searchsorted(classes, y_true)
    pairs = []
    for a in range(len(classes)):
        for b in range(a + 1, len(classes)):
            ab = (enc == a) | (enc == b)
            pairs.append((_binary_roc_auc(enc[ab] == a, p[ab, a])
                          + _binary_roc_auc(enc[ab] == b, p[ab, b])) / 2)
    return float(np.average(np.asarray(pairs)))


def _binary_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """``-Σ Δrecall · precision`` over ``precision_recall_curve``, at least 0."""
    fps, tps = _clf_curve(y_true, y_score)
    ps = tps + fps
    prec = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    rec = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    prec, rec = np.r_[prec[::-1], 1.0], np.r_[rec[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(rec) * prec[:-1])))


def average_precision(y_true, y_proba) -> float:
    """The JAX registry's ``average_precision``: column 1 of (n, 2)
    probabilities against the label 1 (binary, the registry's use); on more
    classes scikit-learn's one-vs-rest macro mean over the labels of y_true."""
    y_true = np.asarray(y_true).reshape(-1)
    p = np.asarray(y_proba)
    if p.ndim > 1 and p.shape[-1] == 2:
        p = p[:, 1]
    classes = np.unique(y_true)
    if len(classes) <= 2:
        if len(classes) == 2 and 1 not in classes:
            raise ValueError(f"pos_label=1 is not a valid label. It should be one of {classes}")
        return _binary_average_precision((y_true == 1).astype(np.int64), p)
    if p.ndim != 2 or p.shape[1] != len(classes):
        raise ValueError("`y_score` needs to be of shape `(n_samples, n_classes)`, since `y_true` "
                         f"contains multiple classes. Got `y_score.shape={p.shape}`.")
    return float(np.average([_binary_average_precision((y_true == c).astype(np.int64), p[:, i])
                             for i, c in enumerate(classes)]))


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
    "balanced_accuracy": Scorer("balanced_accuracy", balanced_accuracy, 1.0, True, needs_proba=True),
    "f1": Scorer("f1", f1, 1.0, True, needs_proba=True),
    "mcc": Scorer("mcc", mcc, 1.0, True, needs_proba=True),
    "roc_auc": Scorer("roc_auc", roc_auc, 1.0, True, needs_proba=True),
    "precision": Scorer("precision", precision, 1.0, True, needs_proba=True),
    "recall": Scorer("recall", recall, 1.0, True, needs_proba=True),
    "quadratic_kappa": Scorer("quadratic_kappa", quadratic_kappa, 1.0, True, needs_proba=True),
    "pac": Scorer("pac", pac, 1.0, True, needs_proba=True),
    "average_precision": Scorer("average_precision", average_precision, 1.0, True, needs_proba=True),
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
