"""Estimator knobs of `ModelInterfaceConfig` that no other test sets, in the
port against the JAX package, on the CPU in float32, on the 2-layer
width-32 MGM+CAP checkpoints of `tests/test_torch_options_parity.py` (one
each, written once for the module), 75 train rows and 25 test rows; the
port serves the JAX estimator's own params.

* ``MMPFNClassifier``: ``POLYNOMIAL_FEATURES`` 10 and ``"all"``,
  ``OUTLIER_REMOVAL_STD`` 3.0 and None, ``FINGERPRINT_FEATURE=False``,
  ``FEATURE_SHIFT_METHOD`` ``"rotate"`` and None,
  ``USE_SKLEARN_16_DECIMAL_PRECISION``: probabilities within 1e-6.
* ``MMPFNRegressor``: ``POLYNOMIAL_FEATURES`` 5, ``OUTLIER_REMOVAL_STD``
  3.0, ``FIX_NAN_BORDERS_AFTER_TARGET_TRANSFORM=False``,
  ``FEATURE_SHIFT_METHOD="rotate"``: as `tests/test_torch_target_transforms.py`
  holds the regressor (bar probabilities 1e-6, means 1e-5 of std(y)).
* Both, tabular only, ``SUBSAMPLE_SAMPLES`` 50 and 0.5 in
  ``fit_preprocessors`` and ``fit_with_cache``. (With image embeddings
  ``SUBSAMPLE_SAMPLES`` crashes in both packages: the rows of X are
  subsampled per member and the image rows are not.)
"""

import jax
import numpy as np
import pytest

from multimodalpfn_tpu_torch.models.loading import save_npz
from tests.test_torch_options_parity import PROBA_ATOL, _data, _write_ckpt
from tests.test_torch_target_transforms import assert_regression_matches, serve_regressors
from tests.test_torch_utils import few_threads  # noqa: F401  (autouse)

CLASSIFIER_KNOBS = {
    "polynomial_10": {"POLYNOMIAL_FEATURES": 10},
    "polynomial_all": {"POLYNOMIAL_FEATURES": "all"},
    "outlier_std_3": {"OUTLIER_REMOVAL_STD": 3.0},
    "outlier_std_none": {"OUTLIER_REMOVAL_STD": None},
    "no_fingerprint": {"FINGERPRINT_FEATURE": False},
    "shift_rotate": {"FEATURE_SHIFT_METHOD": "rotate"},
    "shift_none": {"FEATURE_SHIFT_METHOD": None},
    "sklearn_16_decimals": {"USE_SKLEARN_16_DECIMAL_PRECISION": True},
}
REGRESSOR_KNOBS = {
    "polynomial_5": {"POLYNOMIAL_FEATURES": 5},
    "outlier_std_3": {"OUTLIER_REMOVAL_STD": 3.0},
    "keep_nan_borders": {"FIX_NAN_BORDERS_AFTER_TARGET_TRANSFORM": False},
    "shift_rotate": {"FEATURE_SHIFT_METHOD": "rotate"},
}
SUBSAMPLE = [(kind, n, mode) for kind in ("classifier", "regressor") for n in (50, 0.5)
             for mode in ("fit_preprocessors", "fit_with_cache")]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    return {kind: _write_ckpt(d / f"{kind}.ckpt", kind == "regressor") for kind in ("classifier", "regressor")}


def _kw(knobs: dict, **over) -> dict:
    return dict(mgm_heads=2, cap_heads=4, n_estimators=4, random_state=0, categorical_features_indices=[2, 4],
                mixer_type="MGM+CAP", inference_config=knobs) | over


def _classifier_matches(ckpt, kw, tabular_only: bool, tmp_path) -> None:
    from multimodalpfn_tpu import MMPFNClassifier as JMMPFNClassifier
    from multimodalpfn_tpu_torch import MMPFNClassifier

    X, img, y = _data("multiclass")
    if tabular_only:
        img = None
    train = (X[:75], None if img is None else img[:75], y[:75])
    test = (X[75:], None if img is None else img[75:])
    jclf = JMMPFNClassifier(model_path=ckpt, **kw).fit(*train)
    want = jclf.predict_proba(*test)
    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    got = MMPFNClassifier(model_path=str(npz), device="cpu", **kw).fit(*train).predict_proba(*test)
    assert got.shape == want.shape == (25, 3)
    assert float(np.ptp(want[:, 0])) > 1e-3  # the answers depend on the rows
    np.testing.assert_allclose(got, want, atol=PROBA_ATOL, rtol=0)


def _regressor_matches(ckpt, kw, tabular_only: bool, tmp_path) -> None:
    X, img, y = _data("regression")
    if tabular_only:
        img = None
    train = (X[:75], None if img is None else img[:75], y[:75])
    test = (X[75:], None if img is None else img[75:])
    jreg, want, _, got = serve_regressors(ckpt, kw, train, test, tmp_path)
    assert_regression_matches(jreg, want, got, float(np.std(y[:75])))


@pytest.mark.parametrize("case", list(CLASSIFIER_KNOBS))
def test_classifier_knob_matches_jax(case, ckpts, tmp_path):
    _classifier_matches(ckpts["classifier"], _kw(CLASSIFIER_KNOBS[case]), False, tmp_path)


@pytest.mark.parametrize("case", list(REGRESSOR_KNOBS))
def test_regressor_knob_matches_jax(case, ckpts, tmp_path):
    _regressor_matches(ckpts["regressor"], _kw(REGRESSOR_KNOBS[case]), False, tmp_path)


@pytest.mark.parametrize("kind,n,fit_mode", SUBSAMPLE)
def test_tabular_subsample_matches_jax(kind, n, fit_mode, ckpts, tmp_path):
    kw = _kw({"SUBSAMPLE_SAMPLES": n}, fit_mode=fit_mode)
    check = _classifier_matches if kind == "classifier" else _regressor_matches
    check(ckpts[kind], kw, True, tmp_path)
