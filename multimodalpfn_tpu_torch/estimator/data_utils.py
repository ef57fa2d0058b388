"""Host-side data validation / dtype fixing / categorical inference.

Semantics anchors: reference `mmpfn/models/mmpfn/utils.py:379-618`.

Inputs are validated as sklearn's ``check_X_y(..., dtype=None,
ensure_all_finite="allow-nan")`` does, on numpy alone. A numeric ``np.ndarray``
skips the ordinal encoding, because the encoder's category/string column
selector picks no column of a float frame (the encoder is an identity there).
pandas is imported only for DataFrame, object or string input; scikit-learn
never.
"""

from __future__ import annotations

import math
import numbers
import warnings
from typing import Sequence

import numpy as np

DEFAULT_NUMPY_DTYPE = np.float64


def is_numeric_array(X) -> bool:
    """True for the inputs that take the numpy-only path."""
    return isinstance(X, np.ndarray) and X.dtype.kind in "iufb"


def fix_dtypes(X, cat_indices: Sequence | None, numeric_dtype="float64"):
    """Coerce input to clean dtypes (reference `_fix_dtypes`, `utils.py:379-445`).

    Numeric arrays without requested categorical columns come back as a float64
    array; everything else goes through pandas as in the reference: requested
    categorical columns become 'category', numerics become float64, objects go
    through pandas dtype inference."""
    if is_numeric_array(X) and not cat_indices:
        return np.asarray(X, dtype=numeric_dtype)
    import pandas as pd

    if isinstance(X, pd.DataFrame):
        convert = True
    elif isinstance(X, np.ndarray):
        if X.dtype.kind in "iufb":
            X = pd.DataFrame(X, copy=False, dtype=numeric_dtype)
            convert = False
        elif X.dtype.kind in "OSV":
            if X.dtype.kind == "S":
                raise ValueError(f"String dtypes are not supported. Got dtype: {X.dtype}")
            X = pd.DataFrame(X, copy=True)
            convert = True
        elif X.dtype.kind == "U":
            raise ValueError(f"String dtypes are not supported. Got dtype: {X.dtype}")
        else:
            raise ValueError(f"Invalid dtype for X: {X.dtype}")
    else:
        raise ValueError(f"Invalid type for X: {type(X)}")

    if cat_indices is not None and len(cat_indices) > 0:
        numeric_idx = all(isinstance(i, (int, np.integer)) for i in cat_indices)
        numeric_cols = all(isinstance(c, (int, np.integer)) for c in X.columns.tolist())
        if numeric_idx and not numeric_cols:
            X.iloc[:, list(cat_indices)] = X.iloc[:, list(cat_indices)].astype("category")
        else:
            X[list(cat_indices)] = X[list(cat_indices)].astype("category")

    if convert:
        X = X.convert_dtypes()
    num_cols = X.select_dtypes(include=["number"]).columns
    if len(num_cols) > 0:
        X[num_cols] = X[num_cols].astype(numeric_dtype)
    return X


class OrdinalEncoder:
    """Category/string columns -> ordinal codes, unknown -> -1, missing stays
    NaN (reference `_get_ordinal_encoder`, `utils.py:447-470`): scikit-learn's
    ``ColumnTransformer`` of an ``OrdinalEncoder`` over the columns that
    ``select_dtypes(include=["category", "string"])`` picks, other columns
    passed through after them, all as float64. A column's codes are the
    positions of its values among its sorted non-missing train values; as in
    scikit-learn, only None and NaN count as missing, and a column whose
    values do not sort (strings beside pandas' NA) is refused."""

    def fit(self, X) -> "OrdinalEncoder":
        picked = set(X.select_dtypes(include=["category", "string"]).columns)
        self.cols_ = [i for i, c in enumerate(X.columns) if c in picked]
        self.rest_ = [i for i in range(X.shape[1]) if i not in self.cols_]
        self.categories_ = []
        for i in self.cols_:
            values = X.iloc[:, i].to_numpy(dtype=object)
            try:
                self.categories_.append(sorted(set(values[~_missing(values)])))
            except TypeError:
                types = sorted({type(v).__qualname__ for v in values})
                raise TypeError(
                    "Encoders require their input argument must be uniformly strings or "
                    f"numbers. Got {types}"
                ) from None
        return self

    def transform(self, X) -> np.ndarray:
        out = []
        for i, cats in zip(self.cols_, self.categories_):
            values = X.iloc[:, i].to_numpy(dtype=object)
            index = {c: j for j, c in enumerate(cats)}
            codes = [np.nan if m else index.get(v, -1) for v, m in zip(values, _missing(values))]
            out.append(np.asarray(codes, dtype=DEFAULT_NUMPY_DTYPE))
        rest = X.iloc[:, self.rest_].to_numpy(dtype=DEFAULT_NUMPY_DTYPE)
        return np.column_stack([*out, rest]) if out else rest

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)


def _missing(values: np.ndarray) -> np.ndarray:
    """The None and NaN entries of an object array."""
    return np.array([v is None or (isinstance(v, numbers.Real) and math.isnan(v)) for v in values],
                    dtype=bool)


def infer_categorical_features(
    X: np.ndarray,
    *,
    provided: Sequence[int] | None,
    min_samples_for_inference: int,
    max_unique_for_category: int,
    min_unique_for_numerical: int,
) -> list[int]:
    """Reference `infer_categorical_features` (`utils.py:570-618`): user-provided
    indices are kept if low-cardinality; otherwise auto-inferred for large-enough
    data with very few unique values."""
    maybe = () if provided is None else provided
    large_enough = X.shape[0] > min_samples_for_inference
    out = []
    for ix in range(X.shape[1]):
        col = X[:, ix]
        if ix in maybe:
            if len(np.unique(col)) <= max_unique_for_category:
                out.append(ix)
        elif large_enough and len(np.unique(col)) < min_unique_for_numerical:
            out.append(ix)
    return out


def _check_X(X: np.ndarray, *, ensure_min_samples: int = 1) -> np.ndarray:
    """sklearn ``check_array(X, dtype=None, ensure_all_finite="allow-nan")``
    for an ndarray: 2-D, at least one feature, no infinities in a float array
    (NaN allowed; an object array is not checked for them)."""
    if X.ndim != 2:
        raise ValueError(
            f"Expected 2D array, got {X.ndim}D array instead. Reshape your data."
        )
    if X.shape[0] < ensure_min_samples:
        raise ValueError(
            f"Found array with {X.shape[0]} sample(s) (shape={X.shape}) while a "
            f"minimum of {ensure_min_samples} is required."
        )
    if X.shape[1] < 1:
        raise ValueError(
            f"Found array with 0 feature(s) (shape={X.shape}) while a minimum of 1 "
            "is required."
        )
    if X.dtype.kind == "f" and np.isinf(X).any():
        raise ValueError("Input X contains infinity or a value too large.")
    return X


def _check_classification_y(y) -> np.ndarray:
    """sklearn ``column_or_1d`` + ``check_classification_targets`` for numpy
    labels: a column vector is raveled, labels must be finite and discrete."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        warnings.warn(
            "A column-vector y was passed when a 1d array was expected.",
            UserWarning,
            stacklevel=3,
        )
        y = y.ravel()
    if y.ndim != 1:
        raise ValueError(f"y should be a 1d array, got an array of shape {y.shape}")
    if y.dtype.kind == "f":
        if not np.isfinite(y).all():
            raise ValueError("Input y contains NaN or infinity.")
        if not np.array_equal(y, np.round(y)):
            raise ValueError(
                "Unknown label type: continuous. Maybe you are trying to fit a "
                "classifier, which expects discrete classes on a regression target "
                "with continuous values."
            )
    elif y.dtype.kind not in "iubOU":
        raise ValueError(f"Unknown label type for y with dtype {y.dtype}")
    return y


def _check_limits(X, *, max_num_features, max_num_samples, ignore_pretraining_limits):
    if X.shape[1] > max_num_features:
        msg = (
            f"Number of features {X.shape[1]} exceeds the maximum {max_num_features} "
            "officially supported by the model."
        )
        if not ignore_pretraining_limits:
            raise ValueError(msg + " Set ignore_pretraining_limits=True to override.")
        warnings.warn(msg + " You may see degraded performance.", UserWarning, stacklevel=3)
    if X.shape[0] > max_num_samples:
        msg = (
            f"Number of samples {X.shape[0]} exceeds the maximum {max_num_samples} "
            "officially supported by the model."
        )
        if not ignore_pretraining_limits:
            raise ValueError(msg + " Set ignore_pretraining_limits=True to override.")
        warnings.warn(msg + " You may see degraded performance.", UserWarning, stacklevel=3)


def validate_Xy_fit(
    X,
    y,
    *,
    estimator,
    max_num_features: int,
    max_num_samples: int,
    ignore_pretraining_limits: bool = False,
):
    """Fit-time validation of a classifier's inputs (reference
    `validate_Xy_fit`, `utils.py:472-550`). A DataFrame comes back as its
    values (object where its columns' dtypes mix). Returns (X, y, feature
    names, n_features)."""
    feature_names = getattr(X, "columns", None)
    X = _check_X(np.asarray(X), ensure_min_samples=2)
    y = _check_classification_y(y)
    if len(y) != X.shape[0]:
        raise ValueError(
            "Found input variables with inconsistent numbers of samples: "
            f"[{X.shape[0]}, {len(y)}]"
        )
    names = np.asarray(list(feature_names)) if feature_names is not None else None
    _check_limits(
        X,
        max_num_features=max_num_features,
        max_num_samples=max_num_samples,
        ignore_pretraining_limits=ignore_pretraining_limits,
    )
    return X, y, names, X.shape[1]


def validate_X_predict(X, estimator):
    X = _check_X(np.asarray(X))
    n = getattr(estimator, "n_features_in_", None)
    if n is not None and X.shape[1] != n:
        raise ValueError(
            f"X has {X.shape[1]} features, but the estimator was fit with {n}."
        )
    return X
