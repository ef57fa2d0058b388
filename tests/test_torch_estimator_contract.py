"""The port's estimator contract against the JAX package's: where
``model_path="auto"`` finds the published checkpoint, and the scikit-learn
contract (``get_params``, ``set_params``, ``clone``, ``score``, the tags,
``NotFittedError``) that the JAX classifiers inherit from ``ClassifierMixin,
BaseEstimator`` and `tests/test_sklearn_contract.py` pins. The port writes the
contract out without importing scikit-learn; only ``__sklearn_tags__``, which
only scikit-learn calls, imports it.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from sklearn.base import clone, is_classifier
from sklearn.utils import get_tags

from multimodalpfn_tpu import TabPFNClassifier as JTabPFNClassifier
from multimodalpfn_tpu.datasets.synthetic import toy_classification
from multimodalpfn_tpu.estimator.base import initialize_model as jinitialize_model
from multimodalpfn_tpu.models import params as jparams
from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.loading import save_model as jsave_model
from multimodalpfn_tpu.preprocess.ensemble import PreprocessorConfig as JPreprocessorConfig
from multimodalpfn_tpu_torch import MMPFNClassifier, TabPFNClassifier
from multimodalpfn_tpu_torch.estimator.base import initialize_model
from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.loading import save_npz
from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

REPO = Path(__file__).resolve().parents[1]
CKPT = "tabpfn-v2-classifier.ckpt"
INIT_KW = dict(static_seed=0, mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1)


def _write_ckpt(path: Path) -> None:
    """A small model in the reference checkpoint format, written by the JAX
    package's ``save_model``."""
    cfg = JModelConfig(emsize=24, nhead=2, nhid_factor=2, nlayers=1, n_out=10,
                       mixer=JMixerConfig(mixer_type="none"))
    path.parent.mkdir(parents=True, exist_ok=True)
    jsave_model(path, jax.device_get(jparams.init_params(jax.random.PRNGKey(0), cfg, model_seed=0)), cfg)


def _isolate(monkeypatch, root: Path) -> Path:
    """HOME at an empty scratch dir, the two cache variables unset."""
    home = root / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    monkeypatch.delenv("TABPFN_MODEL_CACHE_DIR", raising=False)
    return home


# where the reference caches the checkpoint: the user cache dir under HOME or
# XDG_CACHE_HOME, or the dir TABPFN_MODEL_CACHE_DIR names
@pytest.mark.parametrize("where", ["home", "xdg", "env"])
def test_auto_model_path_loads_the_cached_checkpoint_like_jax(where, tmp_path, monkeypatch):
    home = _isolate(monkeypatch, tmp_path)
    if where == "home":
        ckpt = home / ".cache" / "tabpfn" / CKPT
    elif where == "xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        ckpt = tmp_path / "xdg" / "tabpfn" / CKPT
    else:
        monkeypatch.setenv("TABPFN_MODEL_CACHE_DIR", str(tmp_path / "models"))
        ckpt = tmp_path / "models" / CKPT
    _write_ckpt(ckpt)

    got = initialize_model(model_path="auto", device="cpu", **INIT_KW)
    want = jinitialize_model(model_path="auto", which="classifier", **INIT_KW)
    assert got.config.emsize == want.config.emsize == 24
    flat_got = tparams.flatten_params(tparams.params_to_numpy(got.params))
    flat_want = tparams.flatten_params(jax.device_get(want.params))
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k], err_msg=k)


def test_auto_model_path_reaches_the_classifier_and_fine_tuning(tmp_path, monkeypatch):
    """``MMPFNClassifier()`` and ``fine_tune_mmpfn`` default to "auto": both
    find the reference's cached checkpoint."""
    from multimodalpfn_tpu_torch.train.finetune import make_episode_trainer

    home = _isolate(monkeypatch, tmp_path)
    _write_ckpt(home / ".cache" / "tabpfn" / CKPT)
    X, y = toy_classification(n=40, n_classes=3, seed=0)
    clf = TabPFNClassifier(device="cpu", n_estimators=2)
    assert clf.model_path == "auto"
    assert clf.fit(X[:30], y[:30]).predict_proba(X[30:]).shape == (10, 3)
    trainer = make_episode_trainer(
        path_to_base_model="auto", mixer_type="none", mgm_heads=2, cap_heads=2,
        features_per_group=1, X_train=X, image_train=None, y_train=y, device="cpu",
    )
    assert trainer is not None


def test_auto_model_path_missing_everywhere_raises(tmp_path, monkeypatch):
    """Found nowhere, the checkpoint is downloaded; with both transports
    failing (stubbed: no test opens a connection) the error says where to
    place it."""
    from multimodalpfn_tpu_torch.models import download

    home = _isolate(monkeypatch, tmp_path)
    tried = []

    def broken(*a, **kw):
        tried.append(a or kw)
        raise OSError("no egress")

    monkeypatch.setattr(download, "_default_hf_download", broken)
    monkeypatch.setattr(download, "_default_url_opener", broken)
    with pytest.raises(FileNotFoundError) as info:
        initialize_model(model_path="auto", device="cpu", **INIT_KW)
    assert len(tried) == 2  # the hub, then the direct URL
    msg = str(info.value)
    assert "TABPFN_MODEL_CACHE_DIR" in msg and "random:<seed>" in msg
    assert str(home / ".cache" / "multimodalpfn_tpu") in msg
    assert str(home / ".cache" / "tabpfn") in msg


@pytest.mark.parametrize("cls", [MMPFNClassifier, TabPFNClassifier])
def test_get_set_params_and_clone(cls):
    """As `tests/test_sklearn_contract.py::test_get_set_params_and_clone`
    pins the JAX package's."""
    clf = cls(model_path="random:0", n_estimators=3, softmax_temperature=0.8, random_state=1)
    params = clf.get_params()
    assert params["n_estimators"] == 3 and params["softmax_temperature"] == 0.8
    assert params["device"] == "cuda"
    assert sorted(params) == sorted(JTabPFNClassifier._get_param_names())  # the same names
    assert params["mixer_type"] == ("none" if cls is TabPFNClassifier else "MGM+CAP")
    c2 = clone(clf)
    assert type(c2) is cls and c2.get_params() == params
    assert c2.set_params(n_estimators=2) is c2
    assert c2.n_estimators == 2 and clf.n_estimators == 3
    with pytest.raises(ValueError, match="Invalid parameter"):
        c2.set_params(no_such_param=1)
    assert is_classifier(clf) and clf._estimator_type == "classifier"
    assert get_tags(clf).input_tags.allow_nan
    assert clf._more_tags() == {"allow_nan": True, "multilabel": False}


@pytest.fixture(scope="module")
def fitted_pair(tmp_path_factory):
    """The JAX and the port's TabPFNClassifier fitted on the same data, the
    port on the JAX classifier's weights."""
    path = tmp_path_factory.mktemp("contract") / CKPT
    _write_ckpt(path)
    X, y = toy_classification(n=90, n_features=5, n_classes=3, seed=4)

    def kw(preproc):
        return dict(n_estimators=2, random_state=0, inference_config={
            "PREPROCESS_TRANSFORMS": [preproc("none", categorical_name="numeric")]})

    jclf = JTabPFNClassifier(model_path=str(path), **kw(JPreprocessorConfig)).fit(X[:60], y[:60])
    npz = path.with_suffix(".npz")
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = TabPFNClassifier(model_path=str(npz), device="cpu", **kw(PreprocessorConfig)).fit(X[:60], y[:60])
    return jclf, clf, X[60:], y[60:]


@pytest.mark.parametrize("weighted", [False, True])
def test_score_matches_jax(fitted_pair, weighted):
    jclf, clf, X, y = fitted_pair
    w = np.random.default_rng(0).uniform(0.1, 2.0, size=len(y)) if weighted else None
    got = clf.score(X, y, sample_weight=w)
    np.testing.assert_array_equal(clf.predict(X), jclf.predict(X))
    assert isinstance(got, float)
    assert got == pytest.approx(np.average(clf.predict(X) == y, weights=w), abs=1e-15)
    assert got == pytest.approx(jclf.score(X, y, sample_weight=w), abs=1e-15)
    assert 0.0 < got < 1.0  # a random model: the score is neither trivially 0 nor 1


@pytest.mark.parametrize("cls", [MMPFNClassifier, TabPFNClassifier])
def test_predict_before_fit_raises_not_fitted(cls):
    X, _ = toy_classification(n=10, seed=2)
    clf = cls(model_path="random:0", device="cpu")
    for call in (clf.predict_proba, clf.predict):
        with pytest.raises(ValueError, match="not fitted") as info:
            call(X)
        assert isinstance(info.value, AttributeError)  # as scikit-learn's NotFittedError


def test_package_exports_save_model(tmp_path):
    import multimodalpfn_tpu
    import multimodalpfn_tpu_torch
    from multimodalpfn_tpu_torch import load_model, save_model

    assert "save_model" in multimodalpfn_tpu_torch.__all__
    assert set(multimodalpfn_tpu.__all__) & {"save_model", "load_model"} <= set(multimodalpfn_tpu_torch.__all__)
    loaded = load_model("random:3")
    save_model(tmp_path / "m.ckpt", loaded.params, loaded.config)
    back = load_model(tmp_path / "m.ckpt")
    a, b = (tparams.flatten_params(m.params) for m in (loaded, back))
    assert a.keys() == b.keys() and all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)


def test_contract_imports_no_sklearn():
    """get_params, set_params, score, the tags and NotFittedError need no
    scikit-learn: with it made unimportable they all work, and no scikit-learn
    module is ever loaded."""
    code = """
    import sys
    sys.modules["sklearn"] = None  # import sklearn -> ImportError
    import numpy as np
    from multimodalpfn_tpu_torch import TabPFNClassifier
    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    X, y = toy_classification(n=40, n_classes=3, seed=0)
    clf = TabPFNClassifier(model_path="random:0", device="cpu", n_estimators=2)
    try:
        clf.predict(X)
    except ValueError as e:
        assert isinstance(e, AttributeError)
    else:
        raise AssertionError("predict before fit did not raise")
    clf.set_params(n_estimators=1)
    assert clf.get_params()["n_estimators"] == 1 and clf._more_tags()["allow_nan"]
    s = clf.fit(X[:30], y[:30]).score(X[30:], y[30:])
    assert 0.0 <= s <= 1.0
    assert sys.modules["sklearn"] is None
    assert not [m for m in sys.modules if m.startswith("sklearn.")]
    print("ok")
    """
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
