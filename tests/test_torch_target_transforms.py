"""The regressor's quantile and robust target transforms in the port.

* `preprocess/numeric.py`'s ``QuantileTransformer.inverse_transform`` (both
  output distributions, at the ``n_quantiles`` of the six ``quantile_*``
  names for 75 rows) and ``RobustScaler.inverse_transform`` against
  scikit-learn 1.9.0's, bit for bit in float64 and float32, on inputs with
  NaN, values outside [0, 1] and on its bounds, a column of repeated
  quantiles and a zero-IQR column; an infinity raises in both; the forward
  transforms stay bit-equal to scikit-learn's.
* ``MMPFNRegressor`` with ``REGRESSION_Y_PREPROCESS_TRANSFORMS=(None,
  name)`` for each of the seven names against the JAX regressor, on the CPU
  in float32, on the 2-layer width-32 MGM+CAP checkpoint of
  `tests/test_torch_options_parity.py` (75 train rows, 25 test rows; the
  port serves the JAX estimator's own params): the bar probabilities within
  1e-6, the means and medians within 1e-5 of std(y), in
  ``fit_preprocessors`` for all seven and in ``fit_with_cache`` for
  ``quantile_norm`` and ``robust``. The nine quantiles are held to 1e-5 of
  std(y) plus what two float32 ulps of the cumulative probability at the
  level move each by (`_icdf_rounding`): the quantile function divides the
  cumsum's rounding by the probability of the bar it lands in, and torch's
  and XLA's float32 forwards leave the averaged log-probabilities about 1e-6
  apart; where the bar holds 1e-4 of the mass, one ulp near 0.9 is 3e-6 of
  std(y).
"""

import jax
import numpy as np
import pytest
from sklearn.preprocessing import QuantileTransformer as SkQuantileTransformer
from sklearn.preprocessing import RobustScaler as SkRobustScaler

from multimodalpfn_tpu_torch.models.loading import save_npz
from multimodalpfn_tpu_torch.preprocess import numeric
from multimodalpfn_tpu_torch.preprocess.steps import ReshapeFeatureDistributionsStep
from tests.test_torch_options_parity import BORDERS, PROBA_ATOL, STAT_REL, _data, _write_ckpt
from tests.test_torch_utils import few_threads  # noqa: F401  (autouse)

N_ROWS = 75
QUANTILE_NAMES = ["quantile_uni_coarse", "quantile_norm_coarse", "quantile_uni", "quantile_norm",
                  "quantile_uni_fine", "quantile_norm_fine"]
TARGET_NAMES = QUANTILE_NAMES + ["robust"]


def _fit_rows() -> np.ndarray:
    """Four columns of 75 rows: skewed, mostly one repeated value (repeated
    quantiles), rounded to a few levels, and one with 3 NaNs."""
    rng = np.random.default_rng(0)
    X = rng.lognormal(size=(N_ROWS, 4))
    X[:40, 1] = 1.0
    X[:, 2] = np.round(X[:, 2])
    X[[3, 17, 60], 3] = np.nan
    return X


def _inverse_rows(transformer) -> np.ndarray:
    """Rows to take back: a normal spread (outside [0, 1] for the uniform
    output), uniform draws, 0 and 1, the normal output's clip values and
    their neighbours, extremes and NaN."""
    rng = np.random.default_rng(1)
    special = [0.0, 1.0, -1e-8, 1 + 1e-8, 0.5, np.nan, -40.0, 40.0]
    clip = numeric.stats.norm.ppf(numeric.BOUNDS_THRESHOLD - np.spacing(1))
    special += [clip, -clip, np.nextafter(clip, 0), np.nextafter(-clip, 0)]
    cols = [np.concatenate([rng.normal(size=30) * 3, rng.random(30), special]) for _ in range(4)]
    Z = np.stack(cols, axis=1)
    Z[::9, 2] = np.nan
    if transformer is not None:  # the values the forward transform gives
        Z = np.concatenate([Z, transformer.transform(_fit_rows())])
    return Z


def _quantile_pair(name):
    port = ReshapeFeatureDistributionsStep.make_transformer(name, num_examples=N_ROWS, random_state=0)
    assert isinstance(port, numeric.QuantileTransformer)
    sk = SkQuantileTransformer(n_quantiles=port.n_quantiles, output_distribution=port.output_distribution,
                               random_state=0)
    X = _fit_rows()
    return port.fit(X), sk.fit(X)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", QUANTILE_NAMES)
def test_quantile_inverse_bit_equal(name, dtype):
    port, sk = _quantile_pair(name)
    assert port.n_quantiles_ == sk.n_quantiles_ and port.n_quantiles_ in (7, 15, 75)
    np.testing.assert_array_equal(port.quantiles_, sk.quantiles_)
    Z = _inverse_rows(sk).astype(dtype)
    got, want = port.inverse_transform(Z), sk.inverse_transform(Z)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[np.isnan(Z)]).all() and np.isfinite(got[~np.isnan(Z)]).all()
    if sk.output_distribution == "uniform":  # the bounds map onto the ends
        np.testing.assert_array_equal(got[Z[:, 0] == 1.0, 0], dtype(sk.quantiles_[-1, 0]))
    # the forward transform, on the fit rows and on new ones, is scikit-learn's
    X = _fit_rows()
    np.testing.assert_array_equal(port.transform(X), sk.transform(X))
    Xn = np.abs(_inverse_rows(None)) * 2
    np.testing.assert_array_equal(port.transform(Xn), sk.transform(Xn))


@pytest.mark.parametrize("name", ["quantile_uni", "quantile_norm", "robust"])
@pytest.mark.parametrize("value", [np.inf, -np.inf])
def test_inverse_infinity_raises(name, value):
    if name == "robust":
        port, sk = numeric.RobustScaler().fit(_fit_rows()), SkRobustScaler(unit_variance=True).fit(_fit_rows())
    else:
        port, sk = _quantile_pair(name)
    Z = _inverse_rows(None)
    Z[4, 1] = value
    with pytest.raises(ValueError, match="contains infinity"):
        sk.inverse_transform(Z)
    with pytest.raises(ValueError, match="contains infinity"):
        port.inverse_transform(Z)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_robust_inverse_bit_equal(dtype):
    X = _fit_rows()
    X[:, 1] = 1.0  # zero IQR: scale 1 / (the normal's IQR)
    X[:70, 2] = 2.0
    port, sk = numeric.RobustScaler().fit(X), SkRobustScaler(unit_variance=True).fit(X)
    np.testing.assert_array_equal(port.scale_, sk.scale_)
    np.testing.assert_array_equal(port.center_, sk.center_)
    assert port.scale_[1] == port.scale_[2] and port.scale_[1] != 1.0
    Z = np.concatenate([_inverse_rows(None), sk.transform(X)]).astype(dtype)
    got, want = port.inverse_transform(Z), sk.inverse_transform(Z)
    assert got.dtype == want.dtype == dtype and got is not Z
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.transform(X), sk.transform(X))


# ---- the regressor against the JAX package ------------------------------------------


@pytest.fixture(scope="module")
def reg_ckpt(tmp_path_factory):
    return _write_ckpt(tmp_path_factory.mktemp("ckpt") / "regressor.ckpt", regression=True)


CASES = [(name, "fit_preprocessors") for name in TARGET_NAMES] + [
    (name, "fit_with_cache") for name in ("quantile_norm", "robust")]


def serve_regressors(ckpt, kw, train, test, tmp_path):
    """The JAX regressor fitted on ``train`` from ``ckpt``, and the port's
    fitted on the same rows with the JAX estimator's own params; each one's
    ``predict(output_type="full")`` on ``test``."""
    from multimodalpfn_tpu import MMPFNRegressor as JMMPFNRegressor
    from multimodalpfn_tpu_torch import MMPFNRegressor

    jreg = JMMPFNRegressor(model_path=ckpt, **kw).fit(*train)
    want = jreg.predict(*test, output_type="full")
    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jreg.params_), jreg.config_, criterion_borders=BORDERS)
    reg = MMPFNRegressor(model_path=str(npz), device="cpu", **kw).fit(*train)
    return jreg, want, reg, reg.predict(*test, output_type="full")


def assert_regression_matches(jreg, want, got, std: float) -> None:
    """The bar probabilities within `PROBA_ATOL`, the mean and the median
    within `STAT_REL` of std(y), the nine quantiles within that plus what two
    float32 roundings of the cumulative probability move each by
    (`_icdf_rounding`)."""
    assert float(np.ptp(want["mean"])) > 1e-3 * std  # the answers depend on the rows
    np.testing.assert_allclose(np.exp(got["logits"]), np.exp(want["logits"]), atol=PROBA_ATOL, rtol=0)
    for key in ("mean", "median"):
        np.testing.assert_allclose(got[key], want[key], atol=STAT_REL * std, rtol=0, err_msg=key)
    q_err = np.abs(np.stack(got["quantiles"]) - np.stack(want["quantiles"]))
    slack = _icdf_rounding(jreg, want)
    assert (q_err <= STAT_REL * std + slack).all(), (q_err.max() / std, float(slack.max()) / std)


def _icdf_rounding(jreg, want) -> np.ndarray:
    """What two float32 roundings of the cumulative probability move each of
    the nine quantiles by: the width of the bar it lands in over that bar's
    probability, times two ulps of the level. The quantile function divides
    the cumsum's rounding by that probability; float32 forwards in two
    libraries leave the averaged log-probabilities about 1e-6 apart, which
    moves the cumsum near a level by one or two ulps."""
    borders = np.asarray(jreg.renormalized_criterion_.borders, np.float64)
    probs = np.exp(want["logits"].astype(np.float64))
    cum = np.cumsum(probs, axis=-1)
    out = []
    for level in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9):
        b = np.minimum((cum < level).sum(axis=-1), probs.shape[-1] - 1)
        p_at = np.take_along_axis(probs, b[:, None], axis=-1)[:, 0]
        out.append((borders[b + 1] - borders[b]) / p_at * 2 * np.spacing(np.float32(level)))
    return np.stack(out)


@pytest.mark.parametrize("name,fit_mode", CASES)
def test_regressor_target_transform_matches_jax(name, fit_mode, reg_ckpt, tmp_path):
    X, img, y = _data("regression")
    kw = dict(mgm_heads=2, cap_heads=4, n_estimators=4, random_state=0, categorical_features_indices=[2, 4],
              fit_mode=fit_mode, mixer_type="MGM+CAP",
              inference_config={"REGRESSION_Y_PREPROCESS_TRANSFORMS": (None, name)})
    jreg, want, reg, got = serve_regressors(reg_ckpt, kw, (X[:75], img[:75], y[:75]), (X[75:], img[75:]),
                                            tmp_path)
    kind = numeric.RobustScaler if name == "robust" else numeric.QuantileTransformer
    transforms = [type(m.config.target_transform) for m in reg.executor_.members]
    assert transforms.count(kind) == 2 and transforms.count(type(None)) == 2, transforms
    assert_regression_matches(jreg, want, got, float(np.std(y[:75])))
