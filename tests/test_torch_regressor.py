"""The port's MMPFNRegressor / TabPFNRegressor against the JAX package's, in
float32 on the CPU, on one small regression checkpoint (2 layers, width 32,
5000 bars) that both packages load, the same data and the same
``random_state``, with the regressor's default preprocessing (its target
transforms, safepower among them, included). Plus regression checkpoints
(loading, saving, the ``.npz``, ``"auto"``) and the estimator contract.

Tolerances: the averaged bar probabilities to 1e-5 absolute; the mean, the
median and the quantiles to 1e-5 of std(y) absolute; the mode equal wherever
the two most probable bars differ by more than 1e-6.
"""

import jax
import numpy as np
import pytest
from sklearn.base import clone, is_regressor
from sklearn.metrics import r2_score
from sklearn.utils import get_tags

from multimodalpfn_tpu import MMPFNRegressor as JMMPFNRegressor
from multimodalpfn_tpu import TabPFNRegressor as JTabPFNRegressor
from multimodalpfn_tpu.estimator.base import initialize_model as jinitialize_model
from multimodalpfn_tpu.models import params as jparams
from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.loading import load_model as jload_model
from multimodalpfn_tpu.models.loading import save_model as jsave_model
from multimodalpfn_tpu_torch import MMPFNRegressor, TabPFNRegressor
from multimodalpfn_tpu_torch.estimator.base import NotFittedError, initialize_model
from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.loading import load_model, load_npz, save_model, save_npz

PROBA_ATOL = 1e-5
STAT_REL = 1e-5  # of std(y)
MODE_GAP = 1e-6
BORDERS = np.linspace(-12, 12, 5001).astype(np.float32)
REG_CKPT = "tabpfn-v2-regressor.ckpt"


def _write_regression_ckpt(path):
    """A 2-layer, width-32 regressor of 5000 bars with MGM+CAP weights, in
    the reference checkpoint format, written by the JAX package's
    ``save_model`` with the zero-initialized output projections filled in."""
    cfg = JModelConfig(
        emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=5000, max_num_classes=0,
        num_buckets=5000, mixer=JMixerConfig("MGM+CAP", mgm_heads=2, cap_heads=4, in_dim=64),
    )
    rng = np.random.default_rng(0)
    tree = jax.device_get(jparams.init_params(jax.random.PRNGKey(0), cfg, model_seed=0))
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree
    )
    path.parent.mkdir(parents=True, exist_ok=True)
    jsave_model(path, tree, cfg, criterion_borders=BORDERS)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write_regression_ckpt(tmp_path_factory.mktemp("reg") / "small_reg.ckpt")


def _data():
    """Six features with NaNs, a 64-wide image embedding, and a skewed target
    (lognormal noise) on which the safepower target transform has work."""
    rng = np.random.default_rng(0)
    n = 100
    X = rng.normal(size=(n, 6))
    img = (rng.normal(size=(n, 1, 64)) + X[:, :1, None]).astype(np.float32)
    y = X[:, 0] + 0.5 * X[:, 1] + rng.lognormal(sigma=0.5, size=n)
    X[rng.random(X.shape) < 0.05] = np.nan
    return X[:75], img[:75], y[:75], X[75:], img[75:]


CASES = {
    # name: (constructor options, uses X, uses the image)
    "mgm_cap": (dict(), True, True),
    "fit_with_cache": (dict(fit_mode="fit_with_cache"), True, True),
    "low_memory": (dict(fit_mode="low_memory"), True, True),
    "mgm": (dict(mixer_type="MGM"), True, True),
    "image_only": (dict(), False, True),
    "n_estimators_1": (dict(n_estimators=1), True, True),
    "n_estimators_5": (dict(n_estimators=5), True, True),
    "tabpfn": (dict(), True, False),
}


def _fit_pair(ckpt, options, use_x, use_img):
    X_tr, img_tr, y_tr, _, _ = _data()
    kw = dict(model_path=str(ckpt), mgm_heads=2, cap_heads=4, n_estimators=4, random_state=0)
    kw |= options
    if not use_img:
        for key in ("mgm_heads", "cap_heads"):
            kw.pop(key)
        return (JTabPFNRegressor(**kw).fit(X_tr, y_tr),
                TabPFNRegressor(device="cpu", **kw).fit(X_tr, y_tr))
    args = (X_tr if use_x else None, img_tr, y_tr)
    return JMMPFNRegressor(**kw).fit(*args), MMPFNRegressor(device="cpu", **kw).fit(*args)


@pytest.fixture(scope="module")
def fitted(ckpt):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _fit_pair(ckpt, *CASES[name])
        return cache[name]

    return get


def _predict_full(reg, name, **option):
    _, _, _, X_te, img_te = _data()
    _, use_x, use_img = CASES[name]
    for k, v in option.items():
        setattr(reg, k, v)
    if not use_img:
        return reg.predict(X_te, output_type="full")
    return reg.predict(X_te if use_x else None, img_te, output_type="full")


def _assert_full_close(got, want, std):
    np.testing.assert_allclose(np.exp(got["logits"]), np.exp(want["logits"]), atol=PROBA_ATOL, rtol=0)
    for key in ("mean", "median"):
        np.testing.assert_allclose(got[key], want[key], atol=STAT_REL * std, rtol=0, err_msg=key)
    assert len(got["quantiles"]) == len(want["quantiles"]) == 9
    for g, w in zip(got["quantiles"], want["quantiles"]):
        np.testing.assert_allclose(g, w, atol=STAT_REL * std, rtol=0, err_msg="quantiles")
    probs = np.exp(want["logits"])
    top2 = np.sort(probs, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MODE_GAP
    assert clear.any()
    np.testing.assert_array_equal(got["mode"][clear], want["mode"][clear])


@pytest.mark.parametrize("name", list(CASES))
def test_regressor_matches_jax(fitted, name):
    jreg, reg = fitted(name)
    std = float(np.std(_data()[2]))
    got, want = _predict_full(reg, name), _predict_full(jreg, name)
    assert got["mean"].shape == want["mean"].shape == (25,)
    _assert_full_close(got, want, std)
    np.testing.assert_allclose(reg.y_train_std_, jreg.y_train_std_, rtol=1e-15)
    np.testing.assert_array_equal(reg.renormalized_criterion_.borders.numpy(),
                                  np.asarray(jreg.renormalized_criterion_.borders))
    if name == "mgm_cap":  # the member target transforms: (None, "safepower") alternate
        transforms = [m.config.target_transform is None for m in reg.executor_.members]
        assert transforms == [True, False, True, False]


@pytest.mark.parametrize("option", [{"average_before_softmax": True}, {"softmax_temperature": 1.0}],
                         ids=["average_before_softmax", "softmax_temperature_1"])
def test_regressor_options_match_jax(fitted, option):
    """Options read at predict time, on the fitted pair of the first case."""
    jreg, reg = fitted("mgm_cap")
    std = float(np.std(_data()[2]))
    try:
        _assert_full_close(_predict_full(reg, "mgm_cap", **option),
                           _predict_full(jreg, "mgm_cap", **option), std)
    finally:
        for obj in (reg, jreg):
            obj.set_params(average_before_softmax=False, softmax_temperature=0.9)


@pytest.mark.parametrize("output_type", ["mean", "median", "mode", "quantiles", "main"])
def test_output_types_match_full(fitted, output_type):
    _, reg = fitted("mgm_cap")
    _, _, _, X_te, img_te = _data()
    full = reg.predict(X_te, img_te, output_type="full")
    got = reg.predict(X_te, img_te, output_type=output_type)
    if output_type == "main":
        assert set(got) == {"mean", "median", "mode", "quantiles"}
        got, want = got["mean"], full["mean"]
    else:
        want = full[output_type]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    q = np.stack(full["quantiles"])
    assert (np.diff(q, axis=0) >= 0).all()
    assert ((full["median"] >= q[0]) & (full["median"] <= q[-1])).all()
    custom = reg.predict(X_te, img_te, output_type="quantiles", quantiles=[0.25, 0.75])
    assert len(custom) == 2
    with pytest.raises(ValueError, match="Invalid output type"):
        reg.predict(X_te, img_te, output_type="nope")


@pytest.mark.parametrize("name", ["mgm_cap", "fit_with_cache"])
def test_predict_many_equals_sequential(fitted, name):
    _, reg = fitted(name)
    _, _, _, X_te, img_te = _data()
    reqs = [(X_te[:5], img_te[:5]), (X_te, img_te), (X_te[3:20], img_te[3:20])]
    many = reg.predict_many([r[0] for r in reqs], [r[1] for r in reqs], output_type="median")
    for got, (X, img) in zip(many, reqs):
        np.testing.assert_array_equal(got, reg.predict(X, img, output_type="median"))


def test_score_is_r2(fitted):
    jreg, reg = fitted("tabpfn")
    _, _, _, X_te, _ = _data()
    y_te = np.nan_to_num(X_te[:, 0]) * 2.0
    w = np.random.default_rng(1).uniform(0.1, 2.0, size=len(y_te))
    for sw in (None, w):
        got = reg.score(X_te, y_te, sample_weight=sw)
        assert isinstance(got, float)
        assert got == r2_score(y_te, reg.predict(X_te), sample_weight=sw)
        assert got == pytest.approx(jreg.score(X_te, y_te, sample_weight=sw), abs=1e-6)


@pytest.mark.parametrize("cls", [MMPFNRegressor, TabPFNRegressor])
def test_estimator_contract(cls):
    reg = cls(model_path="random:0", n_estimators=3, softmax_temperature=0.8, random_state=1)
    params = reg.get_params()
    assert params["n_estimators"] == 3 and params["device"] == "cuda"
    assert sorted(params) == sorted(JMMPFNRegressor._get_param_names())
    assert params["mixer_type"] == ("none" if cls is TabPFNRegressor else "MGM+CAP")
    c2 = clone(reg)
    assert type(c2) is cls and c2.get_params() == params
    assert c2.set_params(n_estimators=2) is c2 and reg.n_estimators == 3
    with pytest.raises(ValueError, match="Invalid parameter"):
        c2.set_params(no_such_param=1)
    assert is_regressor(reg) and get_tags(reg).input_tags.allow_nan
    X_tr, _, y_tr, X_te, _ = _data()
    with pytest.raises(NotFittedError, match="not fitted") as info:
        TabPFNRegressor(model_path="random:0", device="cpu").predict(X_te)
    assert isinstance(info.value, AttributeError)
    with pytest.raises(ValueError, match="NaN or infinity"):
        TabPFNRegressor(model_path="random:0", device="cpu").fit(X_tr, np.where(y_tr > 2, np.nan, y_tr))


def test_random_regressor_is_the_published_architecture():
    got = initialize_model(model_path="random:0", which="regressor", static_seed=0, mixer_type="none",
                           mgm_heads=2, cap_heads=2, features_per_group=1, device="cpu")
    want = jinitialize_model(model_path="random:0", which="regressor", static_seed=0,
                             mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1)
    for f in ("emsize", "nhead", "nlayers", "n_out", "max_num_classes", "num_buckets"):
        assert getattr(got.config, f) == getattr(want.config, f), f
    assert got.config.n_out == 5000 and tuple(got.params["decoder"]["w2"].shape) == (768, 5000)
    np.testing.assert_array_equal(got.criterion_borders, want.criterion_borders)


def test_regression_checkpoint_round_trips(ckpt, tmp_path):
    """Both packages load the checkpoint to the same params and borders; the
    port's ``save_model`` and ``.npz`` keep the borders, and the JAX package
    reads the port's checkpoint back."""
    kw = dict(mixer_type="MGM+CAP", mgm_heads=2, cap_heads=4)
    got, want = load_model(ckpt, **kw), jload_model(ckpt, **kw)
    assert got.config.n_out == want.config.n_out == 5000 and got.config.max_num_classes == 0
    np.testing.assert_array_equal(got.criterion_borders, want.criterion_borders)
    a = tparams.flatten_params(tparams.params_to_numpy(got.params))
    b = tparams.flatten_params(jax.device_get(want.params))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    save_model(tmp_path / "back.ckpt", got.params, got.config, ckpt_config=got.ckpt_config,
               criterion_borders=got.criterion_borders)
    back = jload_model(tmp_path / "back.ckpt", **kw)
    np.testing.assert_array_equal(back.criterion_borders, want.criterion_borders)
    c = tparams.flatten_params(jax.device_get(back.params))
    assert all(np.array_equal(c[k], b[k]) for k in b)
    save_npz(tmp_path / "m.npz", got.params, got.config, criterion_borders=got.criterion_borders)
    npz = load_npz(tmp_path / "m.npz")
    np.testing.assert_array_equal(npz.criterion_borders, got.criterion_borders)
    assert npz.config == got.config


@pytest.mark.parametrize("where", ["home", "env"])
def test_auto_finds_the_regressor_checkpoint(ckpt, tmp_path, monkeypatch, where):
    """``model_path="auto"`` finds ``tabpfn-v2-regressor.ckpt`` where the JAX
    package looks (the reference's ~/.cache/tabpfn, or
    $TABPFN_MODEL_CACHE_DIR), and the regressor fits on it."""
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    monkeypatch.delenv("TABPFN_MODEL_CACHE_DIR", raising=False)
    if where == "env":
        monkeypatch.setenv("TABPFN_MODEL_CACHE_DIR", str(tmp_path / "models"))
        target = tmp_path / "models" / REG_CKPT
    else:
        target = home / ".cache" / "tabpfn" / REG_CKPT
    target.parent.mkdir(parents=True)
    target.write_bytes(ckpt.read_bytes())
    loaded = initialize_model(model_path="auto", which="regressor", static_seed=0, mixer_type="none",
                              mgm_heads=2, cap_heads=2, features_per_group=1, device="cpu")
    np.testing.assert_array_equal(loaded.criterion_borders, BORDERS)
    if where == "env":  # the JAX package's legacy path: found without its downloader
        want = jinitialize_model(model_path="auto", which="regressor", static_seed=0,
                                 mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1)
        np.testing.assert_array_equal(loaded.criterion_borders, want.criterion_borders)
    X_tr, _, y_tr, X_te, _ = _data()
    reg = TabPFNRegressor(device="cpu", n_estimators=2).fit(X_tr, y_tr)
    assert reg.model_path == "auto" and np.isfinite(reg.predict(X_te)).all()
    from multimodalpfn_tpu_torch.models import download

    def broken(*a, **kw):  # the classifier's checkpoint is missing: no download either
        raise OSError("no egress")

    monkeypatch.setattr(download, "_default_hf_download", broken)
    monkeypatch.setattr(download, "_default_url_opener", broken)
    with pytest.raises(FileNotFoundError, match="tabpfn-v2-classifier.ckpt"):
        initialize_model(model_path="auto", static_seed=0, mixer_type="none", mgm_heads=2,
                         cap_heads=2, features_per_group=1, device="cpu")
