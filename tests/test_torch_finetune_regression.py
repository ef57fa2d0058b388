"""Regression fine-tuning in the port against the JAX package's: the numpy
copy of scikit-learn 1.9.0's non-stratified ``train_test_split`` (the same
indices), the regression scorers (equal to scikit-learn 1.9.0's, or to the
JAX registry's own formula where it has one), a 3-step ``fine_tune_mmpfn``
history with ``task_type="regression"`` within 1e-5 relative of the JAX
package's, and a snapshot that keeps the borders and that `MMPFNRegressor`
serves.
"""

import jax
import numpy as np
import pytest
from sklearn import metrics as M
from sklearn.model_selection import train_test_split

from multimodalpfn_tpu.train import metrics as jmetrics
from multimodalpfn_tpu_torch.train import metrics
from multimodalpfn_tpu_torch.train.data import train_test_split_indices
from multimodalpfn_tpu_torch.train.finetune import create_val_data

REL = 1e-5


@pytest.mark.parametrize("n,test_size", [(2298, 0.2), (101, 0.2), (7, 0.3), (1000, 0.05)])
def test_split_indices_match_sklearn(n, test_size):
    """The same indices as ``train_test_split(..., random_state=rng)`` from a
    RandomState, which both advance alike; the fine-tune's split takes them."""
    rs_sk, rs = np.random.RandomState(42), np.random.RandomState(42)
    rows = np.arange(n)
    want_tr, want_te = train_test_split(rows, test_size=test_size, random_state=rs_sk)
    got_tr, got_te = train_test_split_indices(n, test_size, rs)
    np.testing.assert_array_equal(got_tr, want_tr)
    np.testing.assert_array_equal(got_te, want_te)
    assert rs.randint(2**31) == rs_sk.randint(2**31)
    X = np.random.default_rng(0).normal(size=(n, 3))
    y = X[:, 0] * 2.0
    X_tr, X_va, _, _, y_tr, y_va = create_val_data(X=X, image=None, y=y, rng=np.random.RandomState(1),
                                                   is_classification=False)
    ref = train_test_split(X, y, test_size=0.2, random_state=np.random.RandomState(1))
    for got, want in zip((X_tr, X_va, y_tr, y_va), ref):
        np.testing.assert_array_equal(got, want)


SCORERS = ["mse", "rmse", "mae", "medae", "r2", "mape", "smape", "spearmanr", "pearsonr"]
SKLEARN = {
    "mse": M.mean_squared_error,
    "rmse": lambda y, p: float(np.sqrt(M.mean_squared_error(y, p))),
    "mae": M.mean_absolute_error,
    "medae": M.median_absolute_error,
    "r2": M.r2_score,
    "mape": M.mean_absolute_percentage_error,
}


@pytest.mark.parametrize("dtypes", ["f64", "f32", "f32_f64", "int_f32"])
@pytest.mark.parametrize("name", SCORERS)
def test_regression_scorers_match_sklearn(name, dtypes):
    rng = np.random.default_rng(3)
    t_dt, p_dt = {"f64": (np.float64, np.float64), "f32": (np.float32, np.float32),
                  "f32_f64": (np.float32, np.float64), "int_f32": (np.int64, np.float32)}[dtypes]
    y = (rng.normal(size=203) * 5).astype(t_dt)
    p = (y + rng.normal(size=203)).astype(p_dt)
    scorer, jscorer = metrics.get_scorer(name), jmetrics.get_scorer(name)
    got = scorer(y, p)
    assert got == jscorer(y, p)
    if name in SKLEARN:
        assert got == float(SKLEARN[name](y, p))
    assert (scorer.optimum, scorer.greater_is_better) == (jscorer.optimum, jscorer.greater_is_better)
    assert scorer.convert_score_to_error(got) == jscorer.convert_score_to_error(got)


def test_r2_edge_cases_match_sklearn():
    w = np.random.default_rng(0).uniform(size=5)
    for y, p in (([1.0, 1, 1], [1.0, 1, 2]), ([1.0, 2, 3], [1.0, 2, 3]), ([2.0, 2], [2.0, 2]),
                 ([1.0, 2, 4, 8, 9], [1.5, 2, 3, 8, 10])):
        assert metrics.r2_score(y, p) == M.r2_score(y, p)
    y, p = [1.0, 2, 4, 8, 9], [1.5, 2, 3, 8, 10]
    assert metrics.r2_score(y, p, sample_weight=w) == M.r2_score(y, p, sample_weight=w)
    assert np.isnan(metrics.r2_score([1.0], [2.0]))


# ---- the fine-tune ------------------------------------------------------------


@pytest.fixture(scope="module")
def reg_ckpt(tmp_path_factory):
    """A small random regressor (2 layers, width 24, 5000 bars over
    linspace(-12, 12)) with its output projections filled in, in the
    reference torch format, written by the JAX package."""
    from multimodalpfn_tpu.models.config import MixerConfig, ModelConfig
    from multimodalpfn_tpu.models.loading import save_model
    from multimodalpfn_tpu.models.params import init_params

    cfg = ModelConfig(
        emsize=24, nhead=6, nhid_factor=4, nlayers=2, n_out=5000, max_num_classes=0,
        num_buckets=5000, mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96),
    )
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg, model_seed=0))
    rng = np.random.default_rng(1)
    for grp, name in (("attn_feat", "w_out"), ("attn_item", "w_out"), ("mlp", "w2")):
        w = params["layers"][grp][name]
        params["layers"][grp][name] = (rng.standard_normal(w.shape) / np.sqrt(w.shape[-2])).astype(np.float32)
    path = tmp_path_factory.mktemp("regft") / "base.ckpt"
    save_model(path, params, cfg, criterion_borders=np.linspace(-12, 12, 5001).astype(np.float32))
    return path


def _reg_data(n=100, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    y = 2.0 * X[:, 0] - X[:, 1] + rng.lognormal(sigma=0.5, size=n)
    return X, y


def test_regression_finetune_history_matches_jax(reg_ckpt, tmp_path):
    """Three float32 steps on raw (unstandardized) targets with the bar
    distribution's NLL, validated by rmse on the bar distribution's mean,
    after every step: losses, gradient norms and validation errors within
    1e-5 relative of the JAX package's; the snapshot keeps the borders."""
    from multimodalpfn_tpu.train.finetune import fine_tune_mmpfn as jax_ft
    from multimodalpfn_tpu_torch.models.loading import load_model
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    X, y = _reg_data()
    kw = dict(
        mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=reg_ckpt, finetuning_config={"max_steps": 3, "learning_rate": 3e-3},
        validation_metric="rmse", task_type="regression", X_train=X, y_train=y, random_seed=0,
    )
    want = jax_ft(save_path_to_fine_tuned_model=tmp_path / "jax.ckpt", **kw)
    got = fine_tune_mmpfn(save_path_to_fine_tuned_model=tmp_path / "torch.ckpt", device="cpu", **kw)
    assert got["steps"] == want["steps"] == 3 and got["skipped_steps"] == 0
    for key in ("train_loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=REL, err_msg=key)
    assert [s for s, _ in got["val_error"]] == [s for s, _ in want["val_error"]]
    np.testing.assert_allclose([e for _, e in got["val_error"]], [e for _, e in want["val_error"]],
                               rtol=REL)
    np.testing.assert_allclose(got["best_val_error"], want["best_val_error"], rtol=REL)
    snap = load_model(tmp_path / "torch.ckpt")
    np.testing.assert_array_equal(snap.criterion_borders, np.linspace(-12, 12, 5001).astype(np.float32))
    assert snap.config.max_num_classes == 0 and snap.config.n_out == 5000


def test_multimodal_regression_finetune_is_served(reg_ckpt, tmp_path):
    from multimodalpfn_tpu_torch import MMPFNRegressor
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    X, y = _reg_data(n=90, seed=2)
    img = np.random.default_rng(2).standard_normal((90, 1, 96)).astype(np.float32)
    out = tmp_path / "mm_reg.ckpt"
    hist = fine_tune_mmpfn(
        mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=reg_ckpt, save_path_to_fine_tuned_model=out,
        finetuning_config={"max_steps": 2, "learning_rate": 1e-3}, validation_metric="mae",
        task_type="regression", X_train=X, image_train=img, y_train=y, random_seed=1, device="cpu",
    )
    assert hist["steps"] == 2 and np.isfinite(hist["train_loss"]).all()
    assert np.isfinite(hist["grad_norm"]).all() and hist["skipped_steps"] == 0
    reg = MMPFNRegressor(model_path=out, mgm_heads=2, cap_heads=2, n_estimators=2, device="cpu")
    reg.fit(X[:70], img[:70], y[:70])
    full = reg.predict(X[70:], img[70:], output_type="full")
    assert full["mean"].shape == (20,) and np.isfinite(full["mean"]).all()
    np.testing.assert_allclose(np.exp(full["logits"]).sum(axis=1), 1.0, atol=1e-4)
