"""Estimator and sweep options of the port against the JAX package, on the
CPU in float32, on 2-layer width-32 checkpoints (every leaf moved by seeded
noise, so that the zero-initialized output projections do not hide the
model): the options ``scripts/run_published.py`` and the grid study pass,
which other tests leave at their defaults.

* ``MMPFNClassifier`` and ``MMPFNRegressor`` with ``mixer_type="MoE"`` and
  with MGM+CAP, each with ``categorical_features_indices=[2, 4]``, NaNs and
  the default preprocessing, in ``fit_preprocessors`` and
  ``fit_with_cache``: probabilities (the classifier's, and the regressor's
  bar probabilities) within 1e-6, the regressor's means within 1e-5 of
  std(y). Each mixer's checkpoint holds that mixer; the port serves the JAX
  estimator's own params (``save_npz``). The classifier also with MGM, on
  the image alone, ``categorical_features_indices=[0, 2]``, 1 and 9
  members, ``fit_with_cache`` with 3 members and ``random_state=7``.
* ``MMPFNClassifier`` with PetFinder's serving options: preprocessing off,
  ``ignore_pretraining_limits`` past a lowered row limit, features two a
  group and two embedding tokens a row, in both fit modes.
* ``fine_tune_batched_cells`` with binary ``log_loss`` and ``roc_auc``,
  multiclass ``f1``, and regression ``rmse`` and ``mae``, 2 seeds × 3
  steps: losses and validation errors within 1e-5 relative, with the JAX
  package's mixer inits injected into the port and the mixers' dropout off
  in both (their masks come from different generators).
"""

import dataclasses

import jax
import numpy as np
import pytest

from multimodalpfn_tpu.models import params as jparams
from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.loading import save_npz
from tests.test_torch_utils import few_threads  # noqa: F401  (autouse)

PROBA_ATOL = 1e-6
STAT_REL = 1e-5  # of std(y)
LOSS_REL = 1e-5
BORDERS = np.linspace(-12, 12, 5001).astype(np.float32)


def _write_ckpt(path, regression: bool, mixer_type: str = "MGM+CAP", features_per_group: int = 1) -> str:
    """A 2-layer width-32 model with its ``mixer_type`` mixer (2 MGM heads or
    experts, 4 CAP heads) over 64-wide embeddings, its features
    ``features_per_group`` a group, in the reference format, written by the
    JAX package."""
    from multimodalpfn_tpu.models.loading import save_model

    cfg = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, features_per_group=features_per_group,
                       n_out=5000 if regression else 10, max_num_classes=0 if regression else 10,
                       **({"num_buckets": 5000} if regression else {}),
                       mixer=JMixerConfig(mixer_type, mgm_heads=2, cap_heads=4, in_dim=64))
    rng = np.random.default_rng(0)
    tree = jax.device_get(jparams.init_params(jax.random.PRNGKey(0), cfg, model_seed=0))
    tree = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                        tree)
    save_model(path, tree, cfg, criterion_borders=BORDERS if regression else None)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    out = {(kind, mixer): _write_ckpt(d / f"{kind}_{mixer}.ckpt", kind == "regressor", mixer)
           for kind in ("classifier", "regressor") for mixer in ("MGM+CAP", "MoE")}
    out["classifier_fpg2", "MGM+CAP"] = _write_ckpt(d / "classifier_fpg2.ckpt", False, "MGM+CAP", 2)
    return out


def _data(task: str, n: int = 100):
    """Six features, columns 2 and 4 categorical codes, 5 % NaNs, a 64-wide
    image embedding carrying the target; labels in 3 classes, 2 for
    "binary", or a skewed regression target."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 6))
    X[:, [2, 4]] = rng.integers(0, 4, size=(n, 2))
    if task == "regression":
        y = X[:, 0] + 0.5 * X[:, 2] + rng.lognormal(sigma=0.5, size=n)
        signal = y[:, None]
    else:
        y = (X[:, 0] + 0.5 * X[:, 2] > 0.5).astype(np.int64) + (task != "binary") * (X[:, 1] > 0.8)
        signal = np.eye(3)[y] @ rng.normal(size=(3, 1))
    img = (rng.normal(size=(n, 1, 64)) + signal[:, :, None]).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    return X, img, y


# ---- the estimators --------------------------------------------------------------

MIXERS = ["MoE", "MGM+CAP"]
MODES = ["fit_preprocessors", "fit_with_cache"]


@pytest.mark.parametrize("fit_mode", MODES)
@pytest.mark.parametrize("mixer", MIXERS)
def test_classifier_options_match_jax(mixer, fit_mode, ckpts, tmp_path):
    from multimodalpfn_tpu import MMPFNClassifier as JMMPFNClassifier
    from multimodalpfn_tpu_torch import MMPFNClassifier

    X, img, y = _data("multiclass")
    kw = dict(mgm_heads=2, cap_heads=4, n_estimators=4, random_state=0, categorical_features_indices=[2, 4],
              fit_mode=fit_mode, mixer_type=mixer)
    jclf = JMMPFNClassifier(model_path=ckpts["classifier", mixer], **kw).fit(X[:75], img[:75], y[:75])
    want = jclf.predict_proba(X[75:], img[75:])
    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = MMPFNClassifier(model_path=str(npz), device="cpu", **kw).fit(X[:75], img[:75], y[:75])
    got = clf.predict_proba(X[75:], img[75:])
    assert got.shape == want.shape == (25, 3)
    assert float(np.ptp(want[:, 0])) > 1e-3  # the answers depend on the rows
    np.testing.assert_allclose(got, want, atol=PROBA_ATOL, rtol=0)


@pytest.mark.parametrize("fit_mode", MODES)
@pytest.mark.parametrize("mixer", MIXERS)
def test_regressor_options_match_jax(mixer, fit_mode, ckpts, tmp_path):
    from multimodalpfn_tpu import MMPFNRegressor as JMMPFNRegressor
    from multimodalpfn_tpu_torch import MMPFNRegressor

    X, img, y = _data("regression")
    kw = dict(mgm_heads=2, cap_heads=4, n_estimators=4, random_state=0, categorical_features_indices=[2, 4],
              fit_mode=fit_mode, mixer_type=mixer)
    jreg = JMMPFNRegressor(model_path=ckpts["regressor", mixer], **kw).fit(X[:75], img[:75], y[:75])
    want = jreg.predict(X[75:], img[75:], output_type="full")
    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jreg.params_), jreg.config_, criterion_borders=BORDERS)
    reg = MMPFNRegressor(model_path=str(npz), device="cpu", **kw).fit(X[:75], img[:75], y[:75])
    got = reg.predict(X[75:], img[75:], output_type="full")
    std = float(np.std(y[:75]))
    assert float(np.ptp(want["mean"])) > 1e-3 * std
    np.testing.assert_allclose(np.exp(got["logits"]), np.exp(want["logits"]), atol=PROBA_ATOL, rtol=0)
    np.testing.assert_allclose(got["mean"], want["mean"], atol=STAT_REL * std, rtol=0)


# further classifier options (on the MGM+CAP checkpoint): (data columns used,
# constructor options over those of `test_classifier_options_match_jax`)
MORE_OPTIONS = {
    "MGM": (True, dict(mixer_type="MGM")),
    "image_only": (False, {}),
    "categorical_0_2": (True, dict(categorical_features_indices=[0, 2])),
    "n_estimators_1": (True, dict(n_estimators=1)),
    "n_estimators_9": (True, dict(n_estimators=9)),
    "fit_with_cache_n_estimators_3": (True, dict(fit_mode="fit_with_cache", n_estimators=3)),
    "random_state_7": (True, dict(random_state=7)),
}


@pytest.mark.parametrize("case", list(MORE_OPTIONS))
def test_more_classifier_options_match_jax(case, ckpts, tmp_path):
    from multimodalpfn_tpu import MMPFNClassifier as JMMPFNClassifier
    from multimodalpfn_tpu_torch import MMPFNClassifier

    use_x, option = MORE_OPTIONS[case]
    X, img, y = _data("multiclass")
    X = X if use_x else None
    kw = dict(mgm_heads=2, cap_heads=4, n_estimators=4, random_state=0, categorical_features_indices=[2, 4],
              mixer_type="MGM+CAP") | option
    train, test = ((None if X is None else X[:75]), img[:75]), ((None if X is None else X[75:]), img[75:])
    jclf = JMMPFNClassifier(model_path=ckpts["classifier", "MGM+CAP"], **kw).fit(*train, y[:75])
    want = jclf.predict_proba(*test)
    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    got = MMPFNClassifier(model_path=str(npz), device="cpu", **kw).fit(*train, y[:75]).predict_proba(*test)
    assert got.shape == want.shape == (25, 3)
    np.testing.assert_allclose(got, want, atol=PROBA_ATOL, rtol=0)


@pytest.mark.parametrize("fit_mode", MODES)
def test_petfinder_shaped_classifier_matches_jax(fit_mode, ckpts, tmp_path):
    """PetFinder's serving options (portbench's mmpfn-clf-petfinder-mgmcap32x24,
    `hpo/experiment._accuracy`): preprocessing off with no fingerprint,
    ``ignore_pretraining_limits`` past a lowered row limit, five features two
    a group (the last half filled), and two embedding tokens a row (image and
    text), on an fpg-2 MGM+CAP checkpoint."""
    from multimodalpfn_tpu import MMPFNClassifier as JMMPFNClassifier
    from multimodalpfn_tpu.preprocess.ensemble import PreprocessorConfig as JPreprocessorConfig
    from multimodalpfn_tpu_torch import MMPFNClassifier
    from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

    X, img, y = _data("multiclass")
    X = X[:, :5]
    img = np.concatenate([img, img[::-1] + np.random.default_rng(1).normal(size=img.shape)], axis=1)
    img = img.astype(np.float32)
    assert img.shape == (100, 2, 64)

    def options(preprocessor) -> dict:
        return dict(mgm_heads=2, cap_heads=4, n_estimators=4, random_state=0, features_per_group=2,
                    categorical_features_indices=[2, 4], fit_mode=fit_mode, mixer_type="MGM+CAP",
                    ignore_pretraining_limits=True,
                    inference_config={"FINGERPRINT_FEATURE": False, "MAX_NUMBER_OF_SAMPLES": 50,
                                      "PREPROCESS_TRANSFORMS": [preprocessor(name="none")]})

    path = ckpts["classifier_fpg2", "MGM+CAP"]
    with pytest.warns(UserWarning, match="exceeds the maximum"):
        jclf = JMMPFNClassifier(model_path=path, **options(JPreprocessorConfig)).fit(X[:75], img[:75], y[:75])
    want = jclf.predict_proba(X[75:], img[75:])
    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = MMPFNClassifier(model_path=str(npz), device="cpu", **options(PreprocessorConfig))
    with pytest.warns(UserWarning, match="exceeds the maximum"):
        clf.fit(X[:75], img[:75], y[:75])
    assert clf.config_.features_per_group == 2
    got = clf.predict_proba(X[75:], img[75:])
    assert got.shape == want.shape == (25, 3)
    assert float(np.ptp(want[:, 0])) > 1e-3  # the answers depend on the rows
    np.testing.assert_allclose(got, want, atol=PROBA_ATOL, rtol=0)


# ---- the sweep -------------------------------------------------------------------


def _inject_jax_mixers(monkeypatch):
    """Each run's mixer init: the JAX package's ``init_mixer_params`` of
    ``PRNGKey(seed)``, and dropout off in both packages."""
    from multimodalpfn_tpu.models import mixers as jmixers
    from multimodalpfn_tpu_torch.models import mixers as tmixers
    from multimodalpfn_tpu_torch.train import finetune_batch as tfb

    def jax_init(seed, mixer_cfg, emsize, device):
        jcfg = JMixerConfig(**dataclasses.asdict(mixer_cfg))
        return tparams.params_from_jax(jax.device_get(
            jparams.init_mixer_params(jax.random.PRNGKey(int(seed)), jcfg, emsize)), device)

    monkeypatch.setattr(tfb, "init_run_mixer", jax_init)
    monkeypatch.setattr(jmixers, "_dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(tmixers, "_dropout", lambda x, *a, **k: x)


# (task_type, validation metric)
SWEEPS = {"binary_log_loss": ("binary", "log_loss"), "binary_roc_auc": ("binary", "roc_auc"),
          "multiclass_f1": ("multiclass", "f1"), "regression_rmse": ("regression", "rmse"),
          "regression_mae": ("regression", "mae")}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_sweep_tasks_and_metrics_match_jax(case, ckpts, monkeypatch):
    from multimodalpfn_tpu.train import finetune_batch as jfb
    from multimodalpfn_tpu_torch.train import finetune_batch as tfb

    task, metric = SWEEPS[case]
    _inject_jax_mixers(monkeypatch)
    X, img, y = _data(task, n=60)
    kind = "regressor" if task == "regression" else "classifier"
    kw = dict(cells=[{"mgm_heads": 2, "cap_heads": 4, "seeds": [0, 1]}], mixer_type="MGM+CAP",
              features_per_group=1, path_to_base_model=ckpts[kind, "MGM+CAP"],
              task_type=task, X=X, image=img, y=y, validation_metric=metric,
              finetuning_config={"max_steps": 3, "learning_rate": 1e-3}, static_seed=0)
    want = jfb.fine_tune_batched_cells(**kw)["history"]
    got = tfb.fine_tune_batched_cells(device="cpu", **kw)["history"]
    assert np.asarray(got["train_loss"]).shape == (3, 2)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=LOSS_REL)
    assert [s for s, _ in got["val_error"]] == [s for s, _ in want["val_error"]]
    np.testing.assert_allclose([e for _, e in got["val_error"]], [e for _, e in want["val_error"]],
                               rtol=LOSS_REL)
    np.testing.assert_allclose(got["best_val_error"], want["best_val_error"], rtol=LOSS_REL)
    assert got["skipped_steps"] == [0, 0]
