"""Safe power/standard-scaler pipelines, on the numpy/scipy transformers of
`preprocess.numeric`.

Reference semantics (`mmpfn/models/mmpfn/model/preprocessing.py:128-291`):
  * SafePowerTransformer: yeo-johnson that reverts features whose transformed
    variance strays from 1 or whose values blow up;
  * finite-sandwich: inf->NaN + mean-impute before/after every scaler;
  * box-cox variants MinMax-scale to (0.1, 1) with clipping first.
"""

from __future__ import annotations

import warnings

import numpy as np

from multimodalpfn_tpu_torch.preprocess.numeric import (
    FunctionTransformer,
    MinMaxScaler,
    Pipeline,
    PowerTransformer,
    SimpleImputer,
    StandardScaler,
)


def _inf_to_nan(x):
    return np.nan_to_num(x, nan=np.nan, neginf=np.nan, posinf=np.nan)


def _finite_steps(tag: str):
    return [
        (f"inf_to_nan_{tag}", FunctionTransformer(_inf_to_nan)),
        (f"nan_impute_{tag}", SimpleImputer()),
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
    (reference `preprocessing.py:128-204`, incl. the NaN-lambda guard).

    As in the JAX package's subclass of scikit-learn 1.9.0's
    ``PowerTransformer``: a λ fit that fails (scipy's bracket errors and the
    like) gives λ = NaN, and the transform of such a column is then scipy's,
    NaN throughout (scikit-learn 1.9 transforms through
    ``scipy.stats.yeojohnson`` and no longer consults the subclass's
    transform hook). The revert runs in `fit` and `transform`; inside a
    pipeline the step is fitted by ``fit_transform``, which, as in
    scikit-learn, does not set ``revert_indices_``. The inverse is
    `PowerTransformer`'s (scikit-learn's is not overridden either): every
    column takes its λ back, reverted or not, and a NaN λ gives NaN for the
    non-negative values and ``1 - exp(-x)`` for the negative ones."""

    def __init__(self, variance_threshold=1e-3, large_value_threshold=100, method="yeo-johnson"):
        super().__init__(method=method)
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

    def fit(self, X, y=None):
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
    power = SafePowerTransformer(method=method) if safe else PowerTransformer(method=method)
    return Pipeline(steps=[("input_transformer", power), ("standard", make_safe_scaler())])


def make_safe_power_box_pipeline(*, safe: bool) -> Pipeline:
    """Box-cox variants need strictly-positive input: MinMax to (0.1, 1) w/ clip
    (reference `preprocessing.py:265-277`)."""
    return Pipeline(
        steps=[
            ("mm", MinMaxScaler()),
            ("box_cox", make_safe_power_pipeline(safe=safe, method="box-cox")),
        ]
    )
