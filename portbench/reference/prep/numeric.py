"""numpy/scipy versions of the scikit-learn transformers the preprocessing
steps build, so the port runs its preprocessing where scikit-learn is not
installed.

Each class follows scikit-learn 1.9.0 (`sklearn/preprocessing/_data.py`,
`sklearn/impute/_base.py`, `sklearn/decomposition/_truncated_svd.py`,
`sklearn/pipeline.py`) on dense arrays: the same numpy and scipy calls on the
same dtypes in the same order, so the outputs are scikit-learn's. Only what
the preprocessing uses is kept: forward transforms, the inverses the
regressor's target transforms take back through (`estimator/borders.py`), no
sparse input, no sample weights, no parameter validation beyond what changes
a result. Inputs are validated as scikit-learn does where that changes what
comes out: a float64, float32 or float16 array keeps its dtype (anything else
becomes float64), a transform copies its input in the input's own memory
layout (the layout decides numpy's summation order, and the fingerprint
feature hashes the bits of what comes out), and an infinity (or, where
scikit-learn refuses it, a NaN) raises ``ValueError``.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy import stats
from scipy.sparse.linalg import svds
from scipy.special import boxcox as _boxcox
from scipy.special import inv_boxcox as _inv_boxcox

FLOAT_DTYPES = (np.float64, np.float32, np.float16)
# quantile-transform clipping of values at the quantile range's ends
# (`_data.py:58`)
BOUNDS_THRESHOLD = 1e-7
# rows a quantile transform draws its quantiles from (``subsample=10_000``)
QUANTILE_SUBSAMPLE = 10_000


def _check_array(X, *, copy: bool = False, allow_nan: bool = True, min_features: int = 1):
    """scikit-learn's ``check_array`` for the dense 2-D arrays these
    transformers take."""
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"Expected 2D array, got {X.ndim}D array instead.")
    if X.shape[0] < 1 or X.shape[1] < min_features:
        raise ValueError(f"Found array with shape {X.shape}; too few samples or features.")
    if X.dtype not in FLOAT_DTYPES:
        X = X.astype(np.float64)
    elif copy:
        X = X.copy(order="K")  # the memory layout decides the summation order
    if np.isinf(X).any():
        raise ValueError(f"Input X contains infinity or a value too large for {X.dtype!r}.")
    if not allow_nan and np.isnan(X).any():
        raise ValueError("Input X contains NaN.")
    return X


def check_random_state(seed) -> np.random.RandomState:
    """scikit-learn's ``check_random_state``: None is numpy's global
    RandomState, an int seeds a new one."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


def _is_constant_feature(var, mean, n_samples):
    """A variance indistinguishable from 0 given float64 rounding
    (`_data.py:83-98`)."""
    eps = np.finfo(np.float64).eps
    upper_bound = n_samples * eps * var + (n_samples * mean * eps) ** 2
    return var <= upper_bound


def _handle_zeros_in_scale(scale, copy: bool = True, constant_mask=None):
    """Scales of (near) constant features set to 1 (`_data.py:101-133`)."""
    if np.isscalar(scale):
        return 1.0 if scale == 0.0 else scale
    if constant_mask is None:
        constant_mask = scale < 10 * np.finfo(scale.dtype).eps
    if copy:
        scale = np.array(scale, copy=True)
    scale[constant_mask] = 1.0
    return scale


class Transformer:
    """``fit_transform`` as fit, then transform (scikit-learn's
    ``TransformerMixin``)."""

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


class FunctionTransformer(Transformer):
    """A stateless elementwise function (``FunctionTransformer(func,
    inverse_func)``, which does not validate its input); without an
    ``inverse_func`` the inverse is the identity, as scikit-learn's is."""

    def __init__(self, func, inverse_func=None):
        self.func = func
        self.inverse_func = inverse_func

    def fit(self, X, y=None):
        return self

    def transform(self, X):
        return self.func(X)

    def inverse_transform(self, X):
        return X if self.inverse_func is None else self.inverse_func(X)


class Pipeline(Transformer):
    """Steps fitted in order, each on the previous one's output
    (`pipeline.py`: every step but the last by ``fit_transform``)."""

    def __init__(self, steps: list[tuple[str, Transformer]]):
        self.steps = steps

    def fit(self, X, y=None):
        for _, step in self.steps[:-1]:
            X = step.fit_transform(X)
        self.steps[-1][1].fit(X)
        return self

    def fit_transform(self, X, y=None):
        for _, step in self.steps:
            X = step.fit_transform(X)
        return X

    def transform(self, X):
        for _, step in self.steps:
            X = step.transform(X)
        return X

    def inverse_transform(self, X):
        """Every step's inverse, the last step's first."""
        for _, step in reversed(self.steps):
            X = step.inverse_transform(X)
        return X


class QuantileTransformer(Transformer):
    """Per-feature empirical quantile transform to a uniform or normal output
    (`_data.py:2670-3106`, ``subsample=10_000``); NaN passes through."""

    def __init__(self, *, n_quantiles=1000, output_distribution="uniform", random_state=None):
        self.n_quantiles = n_quantiles
        self.output_distribution = output_distribution
        self.random_state = random_state

    def fit(self, X, y=None):
        if self.n_quantiles > QUANTILE_SUBSAMPLE:
            raise ValueError("The number of quantiles cannot be greater than the number of samples used.")
        X = _check_array(X)
        n_samples = X.shape[0]
        self.n_quantiles_ = max(1, min(self.n_quantiles, n_samples))
        rng = check_random_state(self.random_state)
        self.references_ = np.linspace(0, 1, self.n_quantiles_, endpoint=True)
        references = self.references_ * 100
        if QUANTILE_SUBSAMPLE < n_samples:
            # `resample(X, replace=False, n_samples=subsample)`
            indices = np.arange(n_samples)
            rng.shuffle(indices)
            X = X[indices[:QUANTILE_SUBSAMPLE]]
        self.quantiles_ = np.nanpercentile(X, references, axis=0)
        return self

    def _transform_col(self, X_col, quantiles, inverse: bool):
        """One feature onto the output distribution, or back from it with
        ``inverse`` (`_data.py:2923-2986`): the inverse takes a normal
        output through ``norm.cdf`` first, marks the bounds on [0, 1] and
        interpolates ``references_`` onto the quantiles."""
        normal = self.output_distribution == "normal"
        if not inverse:
            lower_bound_x, upper_bound_x = quantiles[0], quantiles[-1]
            lower_bound_y, upper_bound_y = 0, 1
        else:
            lower_bound_x, upper_bound_x = 0, 1
            lower_bound_y, upper_bound_y = quantiles[0], quantiles[-1]
            if normal:
                with np.errstate(invalid="ignore"):
                    X_col = stats.norm.cdf(X_col)
        with np.errstate(invalid="ignore"):  # NaN comparisons
            if normal:
                lower_bounds_idx = X_col - BOUNDS_THRESHOLD < lower_bound_x
                upper_bounds_idx = X_col + BOUNDS_THRESHOLD > upper_bound_x
            else:
                lower_bounds_idx = X_col == lower_bound_x
                upper_bounds_idx = X_col == upper_bound_x
        isfinite_mask = ~np.isnan(X_col)
        X_col_finite = X_col[isfinite_mask]
        if not inverse:
            # interpolate from both ends and average, for repeated quantiles
            X_col[isfinite_mask] = 0.5 * (
                np.interp(X_col_finite, quantiles, self.references_)
                - np.interp(-X_col_finite, -quantiles[::-1], -self.references_[::-1])
            )
        else:
            X_col[isfinite_mask] = np.interp(X_col_finite, self.references_, quantiles)
        X_col[upper_bounds_idx] = upper_bound_y
        X_col[lower_bounds_idx] = lower_bound_y
        if not inverse and normal:
            with np.errstate(invalid="ignore"):
                X_col = stats.norm.ppf(X_col)
                clip_min = stats.norm.ppf(BOUNDS_THRESHOLD - np.spacing(1))
                clip_max = stats.norm.ppf(1 - (BOUNDS_THRESHOLD - np.spacing(1)))
                X_col = np.clip(X_col, clip_min, clip_max)
        return X_col

    def _transform(self, X, inverse: bool):
        X = _check_array(X, copy=True)
        if X.shape[1] != self.quantiles_.shape[1]:
            raise ValueError(f"X has {X.shape[1]} features, but QuantileTransformer is expecting "
                             f"{self.quantiles_.shape[1]} features as input.")
        for i in range(X.shape[1]):
            X[:, i] = self._transform_col(X[:, i], self.quantiles_[:, i], inverse)
        return X

    def transform(self, X):
        return self._transform(X, inverse=False)

    def inverse_transform(self, X):
        """Back from the output distribution to the feature's scale; NaN
        stays NaN."""
        return self._transform(X, inverse=True)


class StandardScaler(Transformer):
    """Per-feature standardization with NaN-aware float64 statistics
    (`_data.py:742-1135`, one ``partial_fit`` through
    `sklearn.utils.extmath._incremental_mean_and_var`); a (near) constant
    feature keeps scale 1."""

    def __init__(self, *, with_mean: bool = True):
        self.with_mean = with_mean

    def fit(self, X, y=None):
        X = _check_array(X)
        nan_mask = np.isnan(X)
        sum_op = np.nansum if nan_mask.any() else np.sum
        up = {} if X.dtype == np.float64 else {"dtype": np.float64}  # float64 accumulators
        new_sum = sum_op(X, axis=0, **up)
        new_count = X.shape[0] - sum_op(nan_mask.astype(X.dtype), axis=0, **up)
        mean = new_sum / new_count
        temp = X - mean
        correction = sum_op(temp, axis=0)
        temp **= 2
        unnormalized = sum_op(temp, axis=0)
        unnormalized -= correction**2 / new_count
        var = unnormalized / new_count
        n_seen = new_count[0] if new_count.max() == new_count.min() else new_count
        self.mean_, self.var_ = mean, var
        self.scale_ = _handle_zeros_in_scale(
            np.sqrt(var), copy=False, constant_mask=_is_constant_feature(var, mean, n_seen)
        )
        return self

    def transform(self, X):
        X = _check_array(X, copy=True)
        if self.with_mean:
            X -= self.mean_.astype(X.dtype)
        X /= self.scale_.astype(X.dtype)
        return X

    def inverse_transform(self, X):
        """Scaled back by ``scale_`` (1 for a constant feature), then the
        mean added."""
        X = _check_array(X, copy=True)
        X *= self.scale_.astype(X.dtype)
        if self.with_mean:
            X += self.mean_.astype(X.dtype)
        return X


class SimpleImputer(Transformer):
    """NaN replaced by the column's mean over its non-NaN values
    (`impute/_base.py`, ``strategy="mean", keep_empty_features=True``): an
    all-NaN column becomes 0."""

    def fit(self, X, y=None):
        X = _check_array(X)
        masked = np.ma.masked_array(X, mask=np.isnan(X))
        mean_masked = np.ma.mean(masked, axis=0)
        mean = np.ma.getdata(mean_masked)
        mean[np.ma.getmask(mean_masked)] = 0
        self.statistics_ = mean
        self.fill_dtype_ = X.dtype
        return self

    def transform(self, X):
        X = _check_array(X, copy=True)
        missing = np.isnan(X)
        X[missing] = np.broadcast_to(self.statistics_.astype(self.fill_dtype_), X.shape)[missing]
        return X

    def inverse_transform(self, X):
        """The identity, on ``X`` itself: the finite sandwich of the safe
        scaler is transparent on the inverse path (the JAX package's
        ``_IdentityInverseImputer``, after the reference's
        `preprocessing.py:232-240`)."""
        return X


class RobustScaler(Transformer):
    """Median-centered features scaled by their interquartile range, rescaled
    to a standard normal's (`_data.py:1552-1785`, ``unit_variance=True``)."""

    QUANTILE_RANGE = (25.0, 75.0)

    def fit(self, X, y=None):
        X = _check_array(X)
        q_min, q_max = self.QUANTILE_RANGE
        self.center_ = np.nanmedian(X, axis=0)
        quantiles = np.transpose(
            [np.nanpercentile(X[:, i], self.QUANTILE_RANGE) for i in range(X.shape[1])]
        )
        self.scale_ = _handle_zeros_in_scale(quantiles[1] - quantiles[0], copy=False)
        adjust = stats.norm.ppf(q_max / 100.0) - stats.norm.ppf(q_min / 100.0)
        self.scale_ = self.scale_ / adjust
        return self

    def transform(self, X):
        X = _check_array(X, copy=True)
        X -= self.center_
        X /= self.scale_
        return X

    def inverse_transform(self, X):
        """Scaled back by ``scale_``, then ``center_`` added."""
        X = _check_array(X, copy=True)
        X *= self.scale_
        X += self.center_
        return X


class MinMaxScaler(Transformer):
    """Features mapped linearly onto (0.1, 1) by their train minimum and
    maximum, and clipped to it (`_data.py:305-590`,
    ``feature_range=(0.1, 1), clip=True``: the Box-Cox input)."""

    FEATURE_RANGE = (0.1, 1)

    def fit(self, X, y=None):
        X = _check_array(X)
        lo = np.asarray(self.FEATURE_RANGE[0], dtype=X.dtype)
        hi = np.asarray(self.FEATURE_RANGE[1], dtype=X.dtype)
        data_min = np.asarray(np.nanmin(X, axis=0))
        data_max = np.asarray(np.nanmax(X, axis=0))
        self.scale_ = (hi - lo) / _handle_zeros_in_scale(data_max - data_min, copy=True)
        self.min_ = lo - data_min * self.scale_
        return self

    def transform(self, X):
        X = _check_array(X, copy=True)
        X *= self.scale_
        X += self.min_
        np.clip(X, np.asarray(self.FEATURE_RANGE[0], dtype=X.dtype),
                np.asarray(self.FEATURE_RANGE[1], dtype=X.dtype), out=X)
        return X

    def inverse_transform(self, X):
        """The linear map undone; nothing is clipped."""
        X = _check_array(X, copy=True)
        X -= self.min_
        X /= self.scale_
        return X


class PowerTransformer(Transformer):
    """Per-feature Yeo-Johnson or Box-Cox power transform with its λ fitted
    by maximum likelihood (`_data.py:3257-3652`, ``standardize=False``): λ
    from ``scipy.stats.yeojohnson`` / ``scipy.stats.boxcox`` (Brent's method)
    over the column's non-NaN values; a constant column keeps λ = 1 under
    Yeo-Johnson. ``fit_transform`` transforms each column right after its λ
    is fitted."""

    def __init__(self, method: str = "yeo-johnson"):
        if method not in ("yeo-johnson", "box-cox"):
            raise ValueError(f"Unknown power transform method {method!r}")
        self.method = method

    def _transform_function(self, x, lmbda):
        if self.method == "box-cox":
            return _boxcox(x, lmbda)
        return stats.yeojohnson(x, lmbda)

    def _box_cox_optimize(self, x):
        mask = np.isnan(x)
        if np.all(mask):
            raise ValueError("Column must not be all nan.")
        _, lmbda = stats.boxcox(x[~mask], lmbda=None)
        return lmbda

    def _yeo_johnson_optimize(self, x):
        _, lmbda = stats.yeojohnson(x[~np.isnan(x)], lmbda=None)
        return lmbda

    def _check_input(self, X, *, check_shape: bool = False):
        X = _check_array(X, copy=True)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", r"All-NaN (slice|axis) encountered")
            if self.method == "box-cox" and np.nanmin(X) <= 0:
                raise ValueError("The Box-Cox transformation can only be applied to strictly positive data")
        if check_shape and X.shape[1] != len(self.lambdas_):
            raise ValueError(f"X has {X.shape[1]} features, expected {len(self.lambdas_)}")
        return X

    def _fit(self, X, force_transform: bool):
        X = self._check_input(X)
        n_samples = X.shape[0]
        mean = np.mean(X, axis=0, dtype=np.float64)
        var = np.var(X, axis=0, dtype=np.float64)
        optimize = (self._box_cox_optimize if self.method == "box-cox"
                    else self._yeo_johnson_optimize)
        with np.errstate(invalid="ignore"):
            self.lambdas_ = np.empty(X.shape[1], dtype=X.dtype)
            for i, col in enumerate(X.T):
                if self.method == "yeo-johnson" and _is_constant_feature(var[i], mean[i], n_samples):
                    self.lambdas_[i] = 1.0
                    continue
                self.lambdas_[i] = optimize(col)
                if force_transform:
                    X[:, i] = self._transform_function(X[:, i], self.lambdas_[i])
        return X

    def fit(self, X, y=None):
        self._fit(X, force_transform=False)
        return self

    def fit_transform(self, X, y=None):
        return self._fit(X, force_transform=True)

    def transform(self, X):
        X = self._check_input(X, check_shape=True)
        for i, lmbda in enumerate(self.lambdas_):
            with np.errstate(invalid="ignore"):
                X[:, i] = self._transform_function(X[:, i], lmbda)
        return X

    @staticmethod
    def _yeo_johnson_inverse(x, lmbda):
        """The four branches of `_data.py`'s ``_yeo_johnson_inverse_transform``.
        A NaN λ fails both branch tests: the non-negative values come out NaN
        and the negative ones ``1 - exp(-x)``."""
        x_inv = np.zeros_like(x)
        pos = x >= 0
        if abs(lmbda) < np.spacing(1.0):
            x_inv[pos] = np.exp(x[pos]) - 1
        else:
            x_inv[pos] = np.power(x[pos] * lmbda + 1, 1 / lmbda) - 1
        if abs(lmbda - 2) > np.spacing(1.0):
            x_inv[~pos] = 1 - np.power(-(2 - lmbda) * x[~pos] + 1, 1 / (2 - lmbda))
        else:
            x_inv[~pos] = 1 - np.exp(-x[~pos])
        return x_inv

    def inverse_transform(self, X):
        """Each column's inverse power transform with its λ (Box-Cox:
        ``scipy.special.inv_boxcox``), every column, whatever a subclass
        reverted in its forward transform."""
        X = _check_array(X, copy=True)
        if X.shape[1] != len(self.lambdas_):
            raise ValueError(f"X has {X.shape[1]} features, expected {len(self.lambdas_)}")
        inv = _inv_boxcox if self.method == "box-cox" else self._yeo_johnson_inverse
        for i, lmbda in enumerate(self.lambdas_):
            with np.errstate(invalid="ignore", over="ignore"):
                X[:, i] = inv(X[:, i], lmbda)
        return X


class TruncatedSVD(Transformer):
    """Rank-``n_components`` projection by ARPACK
    (`decomposition/_truncated_svd.py`, ``algorithm="arpack"``, ``tol=0``):
    ``svds`` from a start vector drawn uniform on [-1, 1] by
    ``RandomState(random_state)``, singular triplets in descending order and
    signs flipped so each component's largest-magnitude entry is positive;
    transform is ``X @ components_.T``."""

    def __init__(self, n_components: int = 2, *, random_state=None):
        self.n_components = n_components
        self.random_state = random_state

    def fit(self, X, y=None):
        self.fit_transform(X)
        return self

    def fit_transform(self, X, y=None):
        X = _check_array(X, allow_nan=False, min_features=2)
        rng = check_random_state(self.random_state)
        v0 = rng.uniform(-1, 1, min(X.shape))
        U, Sigma, VT = svds(X, k=self.n_components, tol=0.0, v0=v0)
        U, Sigma, VT = U[:, ::-1], Sigma[::-1], VT[::-1]
        # signs fixed by the rows of VT: each row's largest-magnitude entry
        # positive (``svd_flip(u_based_decision=False)``)
        signs = np.sign(VT[np.arange(VT.shape[0]), np.argmax(np.abs(VT), axis=1)])
        U *= signs[np.newaxis, :]
        VT *= signs[:, np.newaxis]
        self.components_ = VT
        self.singular_values_ = Sigma
        return U * Sigma

    def transform(self, X):
        X = _check_array(X, allow_nan=False)
        return X @ self.components_.T

