"""Safe power/standard-scaler pipelines.

Reference semantics (`mmpfn/models/mmpfn/model/preprocessing.py:128-291`):
  * SafePowerTransformer: yeo-johnson that reverts features whose transformed
    variance strays from 1 or whose values blow up;
  * finite-sandwich: inf->NaN + mean-impute before/after every scaler;
  * box-cox variants MinMax-scale to (0.1, 1) with clipping first.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
from sklearn.impute import SimpleImputer
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import (
    FunctionTransformer,
    MinMaxScaler,
    PowerTransformer,
    StandardScaler,
)


def _inf_to_nan(x):
    return np.nan_to_num(x, nan=np.nan, neginf=np.nan, posinf=np.nan)


def _identity(x):
    return x


class _IdentityInverseImputer(SimpleImputer):
    """Mean-imputer whose inverse is the identity — the sandwich must be
    transparent on the inverse path (reference `preprocessing.py:232-240`
    monkeypatches exactly this)."""

    def inverse_transform(self, X):
        return X


def _finite_steps(tag: str):
    return [
        (
            f"inf_to_nan_{tag}",
            FunctionTransformer(
                _inf_to_nan, inverse_func=_identity, check_inverse=False
            ),
        ),
        (
            f"nan_impute_{tag}",
            _IdentityInverseImputer(strategy="mean", keep_empty_features=True),
        ),
    ]


def make_safe_scaler(with_mean: bool = True) -> Pipeline:
    """StandardScaler wrapped in finite-sandwich (reference `preprocessing.py:248-262`)."""
    return Pipeline(
        steps=[
            *_finite_steps("pre"),
            ("standard", StandardScaler(with_mean=with_mean)),
            *_finite_steps("post"),
        ]
    )


class SafePowerTransformer(PowerTransformer):
    """Yeo-Johnson/Box-Cox that reverts badly-transformed features
    (reference `preprocessing.py:128-204`, incl. the NaN-lambda guard)."""

    def __init__(self, variance_threshold=1e-3, large_value_threshold=100, **kw):
        super().__init__(**kw)
        self.variance_threshold = variance_threshold
        self.large_value_threshold = large_value_threshold
        self.revert_indices_ = None

    def _yeo_johnson_optimize(self, x):
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings(
                    "ignore", message=r"overflow encountered", category=RuntimeWarning
                )
                return super()._yeo_johnson_optimize(x)
        except Exception:  # scipy BracketError and friends
            return np.nan

    def _yeo_johnson_transform(self, x, lmbda):
        if np.isnan(lmbda):
            return x
        return super()._yeo_johnson_transform(x, lmbda)

    def fit(self, X, y: Any | None = None):
        super().fit(X, y)
        Xt = super().transform(X)
        variances = np.nanvar(Xt, axis=0)
        bad_var = np.where(np.abs(variances - 1) > self.variance_threshold)[0]
        large = np.nonzero(np.any(Xt > self.large_value_threshold, axis=0))[0]
        self.revert_indices_ = np.unique(np.concatenate([bad_var, large]))
        return self

    def transform(self, X):
        Xt = super().transform(X)
        if self.revert_indices_ is not None and len(self.revert_indices_) > 0:
            Xt[:, self.revert_indices_] = X[:, self.revert_indices_]
        return Xt


def make_safe_power_pipeline(*, safe: bool, method: str = "yeo-johnson") -> Pipeline:
    """power/safepower: transformer followed by a safe StandardScaler
    (reference `preprocessing.py:280-291`)."""
    power = (
        SafePowerTransformer(standardize=False, method=method)
        if safe
        else PowerTransformer(standardize=False, method=method)
    )
    return Pipeline(
        steps=[("input_transformer", power), ("standard", make_safe_scaler())]
    )


def make_safe_power_box_pipeline(*, safe: bool) -> Pipeline:
    """Box-cox variants need strictly-positive input: MinMax to (0.1, 1) w/ clip
    (reference `preprocessing.py:265-277`)."""
    return Pipeline(
        steps=[
            ("mm", MinMaxScaler(feature_range=(0.1, 1), clip=True)),
            ("box_cox", make_safe_power_pipeline(safe=safe, method="box-cox")),
        ]
    )
