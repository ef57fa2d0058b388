"""The slice end to end: the port's MMPFNClassifier / TabPFNClassifier against
the JAX package's, both in float32 on the CPU, with the same data, the same
``random_state``, the numpy-only preprocessing config, and the JAX weights
carried into the port through an ``.npz``. Plus the import boundaries of the
port: no jax ever, no scikit-learn or pandas on a numeric ndarray (the
default preprocessing included), and the device it runs on.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from multimodalpfn_tpu import MMPFNClassifier as JMMPFNClassifier
from multimodalpfn_tpu import TabPFNClassifier as JTabPFNClassifier
from multimodalpfn_tpu.datasets.synthetic import toy_multimodal_classification
from multimodalpfn_tpu.models import params as jparams
from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.loading import save_model as jsave_model
from multimodalpfn_tpu.preprocess.ensemble import PreprocessorConfig as JPreprocessorConfig
from multimodalpfn_tpu_torch import MMPFNClassifier, TabPFNClassifier
from multimodalpfn_tpu_torch.models.loading import save_npz
from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

REPO = Path(__file__).resolve().parents[1]
# both sides are float32 forwards of the same weights on the same member
# inputs; logits agree to ~1e-6, and the softmax average keeps that scale
PROBA_ATOL = 1e-5


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """A 2-layer, width-32 model in the reference checkpoint format, with the
    zero-initialized output projections filled in."""
    cfg = JModelConfig(
        emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=10,
        mixer=JMixerConfig("MGM+CAP", mgm_heads=2, cap_heads=4, in_dim=64),
    )
    rng = np.random.default_rng(0)
    tree = jax.device_get(jparams.init_params(jax.random.PRNGKey(0), cfg, model_seed=0))
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree
    )
    path = tmp_path_factory.mktemp("ckpt") / "small.ckpt"
    jsave_model(path, tree, cfg)
    return path


def _kwargs(preproc_cls):
    return dict(
        n_estimators=4,
        random_state=0,
        inference_config={
            "PREPROCESS_TRANSFORMS": [
                preproc_cls("none", categorical_name="numeric", subsample_features=-1)
            ]
        },
    )


def _data():
    X, img, y = toy_multimodal_classification(n=90, n_features=6, n_classes=3, emb_dim=64, seed=0)
    return X[:70], img[:70], y[:70], X[70:], img[70:]


def test_mmpfn_predict_proba_matches_jax(small_ckpt, tmp_path):
    X_tr, img_tr, y_tr, X_te, img_te = _data()
    jclf = JMMPFNClassifier(model_path=str(small_ckpt), mgm_heads=2, cap_heads=4,
                            **_kwargs(JPreprocessorConfig))
    jclf.fit(X_tr, img_tr, y_tr)
    want = jclf.predict_proba(X_te, img_te)

    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = MMPFNClassifier(model_path=str(npz), mgm_heads=2, cap_heads=4, device="cpu",
                          **_kwargs(PreprocessorConfig))
    clf.fit(X_tr, img_tr, y_tr)
    got = clf.predict_proba(X_te, img_te)
    assert got.shape == want.shape == (len(X_te), 3)
    np.testing.assert_allclose(got, want, atol=PROBA_ATOL, rtol=0)
    np.testing.assert_array_equal(clf.predict(X_te, img_te), jclf.predict(X_te, img_te))
    np.testing.assert_array_equal(clf.classes_, jclf.classes_)


# options of the classifier the tests above leave at their defaults, each
# against the JAX package's on the same weights and data
@pytest.mark.parametrize(
    "option",
    [{"fit_mode": "low_memory"}, {"average_before_softmax": True},
     {"balance_probabilities": True}, {"n_estimators": 5}],
    ids=["low_memory", "average_before_softmax", "balance_probabilities", "n_estimators_5"],
)
def test_mmpfn_options_match_jax(small_ckpt, tmp_path, option):
    X_tr, img_tr, y_tr, X_te, img_te = _data()
    jclf = JMMPFNClassifier(model_path=str(small_ckpt), mgm_heads=2, cap_heads=4,
                            **(_kwargs(JPreprocessorConfig) | option))
    want = jclf.fit(X_tr, img_tr, y_tr).predict_proba(X_te, img_te)
    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = MMPFNClassifier(model_path=str(npz), mgm_heads=2, cap_heads=4, device="cpu",
                          **(_kwargs(PreprocessorConfig) | option))
    got = clf.fit(X_tr, img_tr, y_tr).predict_proba(X_te, img_te)
    np.testing.assert_allclose(got, want, atol=PROBA_ATOL, rtol=0)


def test_tabpfn_predict_proba_matches_jax(small_ckpt, tmp_path):
    X_tr, _, y_tr, X_te, _ = _data()
    labels = np.array(["a", "b", "c"])[y_tr]  # string labels: LabelEncoder semantics
    jclf = JTabPFNClassifier(model_path=str(small_ckpt), **_kwargs(JPreprocessorConfig))
    jclf.fit(X_tr, labels)
    want = jclf.predict_proba(X_te)

    npz = tmp_path / "tab.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = TabPFNClassifier(model_path=str(npz), device="cpu", **_kwargs(PreprocessorConfig))
    clf.fit(X_tr, labels)
    np.testing.assert_allclose(clf.predict_proba(X_te), want, atol=PROBA_ATOL, rtol=0)
    np.testing.assert_array_equal(clf.predict(X_te), jclf.predict(X_te))


def test_numeric_validation_matches_sklearn_rules():
    X_tr, _, y_tr, _, _ = _data()
    clf = TabPFNClassifier(model_path="random:0", device="cpu", **_kwargs(PreprocessorConfig))
    bad = X_tr.copy()
    bad[0, 0] = np.inf
    with pytest.raises(ValueError, match="infinity"):
        clf.fit(bad, y_tr)
    with pytest.raises(ValueError, match="continuous"):
        clf.fit(X_tr, y_tr + 0.5)
    with pytest.raises(ValueError, match="inconsistent"):
        clf.fit(X_tr, y_tr[:-1])


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax and the JAX package
    unimported."""
    res = _run(
        """
        import importlib, pkgutil, sys
        import multimodalpfn_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            if not m.name.rsplit(".", 1)[-1].startswith("_"):  # skip built .so files
                importlib.import_module(m.name)
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "multimodalpfn_tpu" or m.startswith("multimodalpfn_tpu.")]
        assert not bad, bad
        print("ok")
        """
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


_SMALL_MODEL = """
    import sys, torch, tempfile, os
    from multimodalpfn_tpu_torch import MMPFNClassifier
    from multimodalpfn_tpu_torch.datasets.synthetic import toy_multimodal_classification
    from multimodalpfn_tpu_torch.models.config import MixerConfig, ModelConfig
    from multimodalpfn_tpu_torch.models.loading import save_npz
    from multimodalpfn_tpu_torch.models.params import init_params
    from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig
    cfg = ModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2,
                      mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=4, in_dim=64))
    path = os.path.join(tempfile.mkdtemp(), "m.npz")
    save_npz(path, init_params(torch.Generator().manual_seed(0), cfg), cfg)
    X, img, y = toy_multimodal_classification(n=40, emb_dim=64, seed=1)
"""


def test_numpy_only_path_imports_no_sklearn_or_pandas():
    """A numeric ndarray fits and predicts without scikit-learn or pandas (the
    machine with the card has no scikit-learn), with the "none" preprocessing
    config and with the classifier's default configs (quantile transform,
    global SVD), in both fit modes."""
    res = _run(
        _SMALL_MODEL
        + """
    for transforms in ([PreprocessorConfig("none", categorical_name="numeric")], None):
        for fit_mode in ("fit_preprocessors", "fit_with_cache"):
            clf = MMPFNClassifier(model_path=path, device="cpu", fit_mode=fit_mode,
                                  inference_config={"PREPROCESS_TRANSFORMS": transforms})
            p = clf.fit(X[:30], img[:30], y[:30]).predict_proba(X[30:], img[30:])
            assert p.shape == (10, 3)
    bad = sorted({m.split(".")[0] for m in sys.modules} & {"sklearn", "pandas", "jax"})
    assert not bad, bad
    print("ok")
    """
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_default_configs_fit_and_predict_without_sklearn():
    """With scikit-learn made unimportable, the default preprocessing configs
    fit and predict, and no scikit-learn module was ever loaded."""
    res = _run(
        """
    import sys
    sys.modules["sklearn"] = None  # import sklearn -> ImportError
    """
        + _SMALL_MODEL
        + """
    from multimodalpfn_tpu_torch.preprocess.ensemble import default_classifier_preprocessor_configs
    assert default_classifier_preprocessor_configs()[0].global_transformer_name == "svd"
    clf = MMPFNClassifier(model_path=path, device="cpu", n_estimators=4)
    p = clf.fit(X[:30], img[:30], y[:30]).predict_proba(X[30:], img[30:])
    assert p.shape == (10, 3)
    assert sys.modules["sklearn"] is None
    assert not [m for m in sys.modules if m.startswith("sklearn.")]
    print("ok")
    """
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    """The entry points run on the card unless the caller asks for the CPU:
    the default device is "cuda", and without CUDA ``fit`` raises, naming
    ``device="cpu"``."""
    import torch

    X_tr, img_tr, y_tr, _, _ = _data()
    clf = MMPFNClassifier(model_path="random:0", **_kwargs(PreprocessorConfig))
    assert clf.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        clf.fit(X_tr, img_tr, y_tr)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TabPFNClassifier(model_path="random:0", device="cuda:0").fit(X_tr, y_tr)


def _frame(n, seed, unknown=False):
    import pandas as pd

    rng = np.random.default_rng(seed)
    s = rng.choice(["x", "z", "y"] + (["w"] if unknown else []), size=n).astype(object)
    cat = rng.choice(["b", "a", "c"] + (["q"] if unknown else []), size=n)
    df = pd.DataFrame({
        "num": rng.normal(size=n),
        "cat": pd.Categorical(cat),
        "s": s,
        "i": rng.integers(0, 3, size=n),
        "f": rng.normal(size=n),
    })
    df.loc[rng.random(n) < 0.1, "num"] = np.nan
    return df


@pytest.mark.parametrize("cat_indices", [None, [3]])
def test_ordinal_encoder_matches_sklearn(cat_indices):
    """The port's category/string encoder against the JAX package's
    scikit-learn ColumnTransformer on the same validated, dtype-fixed frames:
    sorted codes, unseen values -1, numeric columns passed through with their
    NaNs; a string column with a missing value (pandas' NA after the dtype
    fix) is refused by both."""
    from multimodalpfn_tpu.estimator import data_utils as jdu
    from multimodalpfn_tpu_torch.estimator import data_utils as tdu

    fit_X = tdu.fix_dtypes(np.asarray(_frame(60, 0)), cat_indices=cat_indices)
    new_X = tdu.fix_dtypes(np.asarray(_frame(25, 1, unknown=True)), cat_indices=cat_indices)
    ours, theirs = tdu.OrdinalEncoder(), jdu.make_ordinal_encoder()
    np.testing.assert_array_equal(ours.fit_transform(fit_X), theirs.fit_transform(fit_X))
    got, want = ours.transform(new_X), theirs.transform(new_X)
    assert (got == -1).any() and np.isnan(got).any()
    np.testing.assert_array_equal(got, want)
    frame = _frame(30, 4)
    frame.loc[3, "s"] = None
    bad = tdu.fix_dtypes(np.asarray(frame), cat_indices=cat_indices)
    for enc in (tdu.OrdinalEncoder(), jdu.make_ordinal_encoder()):
        with pytest.raises(TypeError, match="uniformly strings or numbers"):
            enc.fit(bad)


def test_dataframe_input_matches_jax(small_ckpt, tmp_path):
    """A DataFrame with category, string and numeric columns end to end
    against the JAX classifier, float32, the default preprocessing."""
    X, Xt = _frame(70, 2), _frame(20, 3)
    y = (np.nan_to_num(X["num"].to_numpy()) > 0).astype(int) + (X["i"].to_numpy() > 1)
    jclf = JTabPFNClassifier(model_path=str(small_ckpt), n_estimators=4, random_state=0)
    want = jclf.fit(X, y).predict_proba(Xt)
    npz = tmp_path / "tab.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = TabPFNClassifier(model_path=str(npz), device="cpu", n_estimators=4, random_state=0)
    np.testing.assert_allclose(clf.fit(X, y).predict_proba(Xt), want, atol=PROBA_ATOL, rtol=0)
    np.testing.assert_array_equal(clf.feature_names_in_, jclf.feature_names_in_)
