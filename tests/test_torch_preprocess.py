"""The port's numpy/scipy transformers (multimodalpfn_tpu_torch/preprocess/
numeric.py) against scikit-learn 1.9.0's, and the port's preprocessing steps
against the JAX package's (which build scikit-learn's) on the same data and
seed.

The numpy/scipy versions make the same numpy and scipy calls as scikit-learn,
so their outputs agree to rounding: 1e-12 relative. The ARPACK SVD is compared
after the sign flip at 1e-10. The power transforms' λ come from the same
``scipy.stats.yeojohnson`` / ``scipy.stats.boxcox`` Brent searches on the same
columns, so they agree to 1e-12 too (with another scipy the searches may stop
elsewhere within Brent's tolerance, 1.48e-8 relative).
"""

import numpy as np
import pytest
from sklearn.decomposition import TruncatedSVD as SkTruncatedSVD
from sklearn.impute import SimpleImputer as SkSimpleImputer
from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler
from sklearn.preprocessing import PowerTransformer as SkPowerTransformer
from sklearn.preprocessing import QuantileTransformer as SkQuantileTransformer
from sklearn.preprocessing import RobustScaler as SkRobustScaler
from sklearn.preprocessing import StandardScaler as SkStandardScaler

from multimodalpfn_tpu.preprocess import ensemble as jensemble
from multimodalpfn_tpu.preprocess import kdi as jkdi
from multimodalpfn_tpu.preprocess import safe_power as jsafe_power
from multimodalpfn_tpu.preprocess import steps as jsteps
from multimodalpfn_tpu_torch.preprocess import ensemble, kdi, numeric, safe_power, steps

TOL = dict(rtol=1e-12, atol=1e-12)
SVD_TOL = dict(rtol=1e-10, atol=1e-10)


def _table(n, seed=0, dtype=np.float64):
    """Columns of the kinds the preprocessing meets: normal with NaNs,
    heavy-tailed, constant, near-constant (1e10 + 1e-6 noise), all-NaN,
    binary, tied (five values), negative skewed."""
    rng = np.random.default_rng(seed)
    cols = [
        rng.normal(size=n),
        rng.standard_t(2, size=n) * 10,
        np.full(n, 3.3),
        1e10 + 1e-6 * rng.normal(size=n),
        np.full(n, np.nan),
        rng.integers(0, 2, size=n).astype(float),
        rng.integers(0, 5, size=n).astype(float),
        -np.exp(rng.normal(size=n)),
    ]
    X = np.stack(cols, axis=1).astype(dtype)
    X[rng.random(X.shape) < 0.08] = np.nan
    return X


def _finite(X):
    """The table without its all-NaN column (what a NaN-refusing or
    all-NaN-refusing fit takes)."""
    return np.delete(X, 4, axis=1)


def _with_inf(X):
    X = X.copy()
    X[3, 0], X[7, 1] = np.inf, -np.inf
    return X


def _pair(ours, theirs, X_fit, X_new):
    got_fit, want_fit = ours.fit_transform(X_fit.copy()), theirs.fit_transform(X_fit.copy())
    np.testing.assert_allclose(got_fit, want_fit, **TOL)
    assert got_fit.dtype == want_fit.dtype
    got, want = ours.transform(X_new.copy()), theirs.transform(X_new.copy())
    np.testing.assert_allclose(got, want, **TOL)
    assert got.dtype == want.dtype
    return ours, theirs


@pytest.mark.parametrize(
    "dist,n_quantiles,n", [("uniform", 20, 200), ("normal", 20, 200), ("uniform", 1000, 150),
                           ("normal", 1000, 150), ("uniform", 50, 12_345), ("normal", 7, 12_345)]
)
def test_quantile_transformer_matches_sklearn(dist, n_quantiles, n):
    """n_quantiles above n_samples (cut to n_samples) and, with more than
    10 000 rows, the subsample draw of RandomState(seed)."""
    X = _table(n, seed=1)
    kw = dict(output_distribution=dist, n_quantiles=n_quantiles, random_state=7)
    ours, theirs = _pair(numeric.QuantileTransformer(**kw), SkQuantileTransformer(**kw),
                         X, _table(60, seed=2) * 1.5)
    assert ours.n_quantiles_ == theirs.n_quantiles_
    np.testing.assert_allclose(ours.quantiles_, theirs.quantiles_, **TOL)
    with pytest.raises(ValueError, match="infinity"):
        numeric.QuantileTransformer(**kw).fit(_with_inf(X))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_mean", [True, False])
def test_standard_scaler_matches_sklearn(with_mean, dtype):
    """NaN-aware float64 statistics; the constant and the near-constant
    column keep scale 1, as scikit-learn's zero-scale rule gives them."""
    X = _finite(_table(300, seed=3, dtype=dtype))
    ours, theirs = _pair(numeric.StandardScaler(with_mean=with_mean),
                         SkStandardScaler(with_mean=with_mean), X, _finite(_table(40, seed=4, dtype=dtype)))
    np.testing.assert_allclose(ours.scale_, theirs.scale_, **TOL)
    assert ours.scale_[2] == ours.scale_[3] == 1.0  # the constant and the near-constant column


def test_simple_imputer_keeps_an_all_nan_column_as_zero():
    X = _table(100, seed=5)
    ours, theirs = _pair(numeric.SimpleImputer(),
                         SkSimpleImputer(strategy="mean", keep_empty_features=True),
                         X, _table(30, seed=6))
    assert (ours.transform(X)[:, 4] == 0).all()


def test_robust_scaler_matches_sklearn():
    _pair(numeric.RobustScaler(), SkRobustScaler(unit_variance=True),
          _finite(_table(250, seed=7)), _finite(_table(30, seed=8)))


def test_min_max_scaler_clips_like_sklearn():
    X_new = _finite(_table(30, seed=10)) * 3.0  # outside the train range: clipped
    _pair(numeric.MinMaxScaler(), SkMinMaxScaler(feature_range=(0.1, 1), clip=True),
          _finite(_table(200, seed=9)), X_new)


@pytest.mark.parametrize("method", ["yeo-johnson", "box-cox"])
def test_power_transformer_matches_sklearn(method):
    X = _finite(_table(220, seed=11))
    X_new = _finite(_table(25, seed=12))
    if method == "box-cox":
        # strictly positive, as the pipeline's MinMax step makes it; a
        # constant column is refused by scipy's fit on both sides
        for est in (numeric.PowerTransformer(method=method),
                    SkPowerTransformer(method=method, standardize=False)):
            with pytest.raises(ValueError, match="constant"):
                est.fit(np.abs(X) + 0.1)
        X, X_new = (np.abs(np.delete(a, [2, 3], axis=1)) + 0.1 for a in (X, X_new))
    ours, theirs = _pair(numeric.PowerTransformer(method=method),
                         SkPowerTransformer(method=method, standardize=False), X, X_new)
    np.testing.assert_allclose(ours.lambdas_, theirs.lambdas_, **TOL)


def test_safe_power_transformer_matches_the_jax_package():
    """The revert (fit, then transform) and the NaN λ of a column whose
    Brent search fails (scipy refuses its bracket), against the JAX package's
    subclass of scikit-learn's PowerTransformer."""
    X = _finite(_table(200, seed=13))
    X[:3, 0] = [1e300, -1e300, 3.0]  # the λ search raises: λ = NaN
    X_new = _finite(_table(20, seed=14))
    ours, theirs = safe_power.SafePowerTransformer(), jsafe_power.SafePowerTransformer(standardize=False)
    ours.fit(X.copy())
    theirs.fit(X.copy())
    np.testing.assert_array_equal(ours.revert_indices_, theirs.revert_indices_)
    np.testing.assert_allclose(ours.lambdas_, theirs.lambdas_, **TOL)
    assert np.isnan(ours.lambdas_[0])
    np.testing.assert_allclose(ours.transform(X_new.copy()), theirs.transform(X_new.copy()), **TOL)


@pytest.mark.parametrize("with_mean", [True, False])
def test_safe_scaler_pipeline_matches_the_jax_package(with_mean):
    """inf -> NaN, mean-impute, standardize, again inf -> NaN and impute: on a
    table with infinities and an all-NaN column."""
    X = _with_inf(_table(150, seed=15))
    _pair(safe_power.make_safe_scaler(with_mean), jsafe_power.make_safe_scaler(with_mean),
          X, _with_inf(_table(20, seed=16)))


@pytest.mark.parametrize("n_components", [1, 3])
def test_truncated_svd_matches_sklearn(n_components):
    rng = np.random.default_rng(17)
    X = rng.normal(size=(120, 9)) @ rng.normal(size=(9, 9))
    kw = dict(n_components=n_components, random_state=5)
    ours, theirs = numeric.TruncatedSVD(**kw), SkTruncatedSVD(algorithm="arpack", **kw)
    np.testing.assert_allclose(ours.fit_transform(X), theirs.fit_transform(X), **SVD_TOL)
    np.testing.assert_allclose(ours.components_, theirs.components_, **SVD_TOL)
    X_new = rng.normal(size=(15, 9))
    np.testing.assert_allclose(ours.transform(X_new), theirs.transform(X_new), **SVD_TOL)


def test_norm_and_kdi_matches_the_jax_package():
    X, X_new = _finite(_table(90, seed=18)), _finite(_table(20, seed=19))
    ours = kdi.make_kdi_transformer("norm_and_kdi", 90, 3).fit(X)
    theirs = jkdi.make_kdi_transformer("norm_and_kdi", 90, 3).fit(X)
    np.testing.assert_allclose(ours.transform(X_new), theirs.transform(X_new), **TOL)


def _step_case(step_cls, config, seed):
    return step_cls(
        transform_name=config.name,
        append_to_original=config.append_original,
        subsample_features=config.subsample_features,
        global_transformer_name=config.global_transformer_name,
        apply_to_categorical=config.categorical_name == "numeric",
        random_state=seed,
    )


def _step_data(seed):
    """Train and test rows without the all-NaN and near-constant columns
    (the classifier's RemoveConstantFeaturesStep runs first), with the binary
    and tied columns categorical."""
    X = np.delete(_table(260, seed=seed), [2, 3, 4], axis=1)
    return X[:200], X[200:], [2, 3]


def _check_step(config, seed):
    """The port's step against the JAX package's, on C- and Fortran-ordered
    input. Within the stated tolerances, and in fact bit for bit: the same
    numpy and scipy calls on arrays of the same memory layout (the member's
    fingerprint feature hashes the bits of these outputs)."""
    X, X_new, cat = _step_data(seed)
    for layout in (np.ascontiguousarray, np.asfortranarray):
        ours, theirs = _step_case(steps.ReshapeFeatureDistributionsStep, config, 11), _step_case(
            jsteps.ReshapeFeatureDistributionsStep, config, 11)
        got, want = ours.fit_transform(layout(X), cat), theirs.fit_transform(layout(X), cat)
        assert got.categorical_features == want.categorical_features
        tol = SVD_TOL if config.global_transformer_name == "svd" else TOL
        np.testing.assert_allclose(got.X, want.X, **tol)
        np.testing.assert_array_equal(got.X, want.X)
        got, want = ours.transform(layout(X_new)).X, theirs.transform(layout(X_new)).X
        np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [*steps._PER_FEATURE_POOL, "per_feature", "power_box",
                                  "safepower_box"])
def test_reshape_step_transform_matches_the_jax_package(name):
    """Every per-feature pool name (and ``per_feature``, which draws from the
    pool, and the Box-Cox pipelines) through the port's step against the JAX
    package's on the same data and seed."""
    _check_step(ensemble.PreprocessorConfig(name, categorical_name="numeric"), seed=20)


@pytest.mark.parametrize("which", ["classifier", "regressor"])
def test_reshape_step_default_configs_match_the_jax_package(which):
    """Both default config lists (quantile + append-original + global SVD,
    and the second member's), step by step against the JAX package."""
    ours = getattr(ensemble, f"default_{which}_preprocessor_configs")()
    theirs = getattr(jensemble, f"default_{which}_preprocessor_configs")()
    assert [str(c) for c in ours] == [str(c) for c in theirs]
    for config in ours:
        _check_step(config, seed=21)
