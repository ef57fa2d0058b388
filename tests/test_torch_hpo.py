"""The port's experiment code (multimodalpfn_tpu_torch/hpo/) against the JAX
package's, on the CPU in float32.

* `GridStudy` as `tests/test_hpo.py` tests the JAX package's copy.
* `nanmin_impute` is bit-equal to the JAX package's.
* `run_experiment_cross_cell` and `run_experiment` on a tiny checkpoint give
  the JAX package's trial states (the pruned cell included) and accuracies,
  with the JAX package's mixer inits injected into the port's sweep and the
  mixers' dropout off in both (their masks come from different generators);
  fine-tuning beats the un-fine-tuned base model (the JAX test's
  learning-quality gate).
* `load_experiment_config` reads `configs/pad_ufes_20.yaml`; the module
  imports and runs with neither scikit-learn nor PyYAML importable, and
  `load_experiment_config` then returns what ``yaml.safe_load`` returns;
  the experiments default to the card.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodalpfn_tpu.models import params as jparams
from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu_torch.hpo import experiment as texp
from multimodalpfn_tpu_torch.hpo.study import GridStudy, Trial, TrialPruned
from multimodalpfn_tpu_torch.models import params as tparams

REPO = Path(__file__).resolve().parents[1]


# ---- the study -----------------------------------------------------------------


def test_grid_study_basics():
    study = GridStudy(search_space={"a": [1, 2, 3], "b": [10, 20]}, direction="maximize")

    def objective(trial):
        a = trial.suggest_categorical("a", [1, 2, 3])
        b = trial.suggest_categorical("b", [10, 20])
        if a == 3:
            raise TrialPruned
        return a * b

    study.optimize(objective)
    assert len(study.trials) == 6
    assert sum(t.state == "pruned" for t in study.trials) == 2
    assert study.best_params == {"a": 2, "b": 20}
    assert study.best_value == 40


def test_grid_study_catches_failures_and_round_trips(tmp_path):
    study = GridStudy(search_space={"a": [1, 2]}, direction="minimize")

    def objective(trial):
        if trial.params["a"] == 1:
            raise RuntimeError("boom")
        return trial.params["a"]

    study.optimize(objective, catch=(RuntimeError,))
    assert study.trials[0].state == "failed" and "boom" in study.trials[0].user_attrs["error"]
    assert study.best_params == {"a": 2}
    study.save(tmp_path / "study.json")
    saved = json.loads((tmp_path / "study.json").read_text())
    assert saved["direction"] == "minimize" and saved["search_space"] == {"a": [1, 2]}
    assert [t["state"] for t in saved["trials"]] == ["failed", "complete"]


def test_study_results_collation(tmp_path):
    st = GridStudy(search_space={"mgm_heads": [2, 4], "cap_heads": [2, 4]})
    for i, (m, c) in enumerate([(2, 2), (2, 4), (4, 2), (4, 4)]):
        t = Trial(number=i, params={"mgm_heads": m, "cap_heads": c})
        st.trials.append(t)
        if m < c:
            t.state = "pruned"
            continue
        t.value = 0.8 + 0.01 * i
        t.state = "complete"
        t.set_user_attr("std_accuracy", 0.01)
    path = tmp_path / "chart.csv"
    st.to_csv(path, scale=100)
    lines = path.read_text().strip().split("\n")
    assert lines[0] == "mgm_heads\tcap_heads\tmean\tstd"
    assert lines[1] == "2\t2\t80.0\t1.0"
    assert len(lines) == 4
    table = st.summary_table(scale=100)
    assert "83.00±1.00*" in table and "-" in table


def test_nanmin_impute_bit_equal_to_jax():
    from multimodalpfn_tpu.hpo.experiment import nanmin_impute as jax_impute

    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.2] = np.nan
    X[:, 4] = np.nan  # an all-NaN column
    got, want = texp.nanmin_impute(X), jax_impute(X)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert not np.isnan(got).any()


def test_load_experiment_config():
    from multimodalpfn_tpu.hpo.experiment import load_experiment_config as jax_load

    path = REPO / "configs" / "pad_ufes_20.yaml"
    cfg = texp.load_experiment_config(path)
    assert cfg == jax_load(path)
    assert cfg["mgm_heads_list"][-1] == 256 and cfg["mixer_type"] == "MGM+CAP"


# ---- the experiments against the JAX package's ----------------------------------


def _save_base(path, mixer):
    from multimodalpfn_tpu.models.loading import save_model

    cfg = JModelConfig(emsize=24, nhead=6, nhid_factor=4, nlayers=2, n_out=10, max_num_classes=10,
                       **({"mixer": mixer} if mixer else {}))
    save_model(path, jparams.init_params(jax.random.PRNGKey(0), cfg, model_seed=0), cfg)
    return str(path)


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    """The JAX test's tiny multimodal base model (2 layers, width 24, MGM+CAP
    2/2 over 96-wide embeddings), saved with its mixer."""
    return _save_base(tmp_path_factory.mktemp("ckpt") / "base.ckpt",
                      JMixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96))


@pytest.fixture(scope="module")
def bare_ckpt(tmp_path_factory):
    """The same architecture saved without a mixer: a sweep draws each run's
    mixer at its cell's head count (a checkpoint's 2-head mixer cannot load
    at 4 heads, in either package)."""
    return _save_base(tmp_path_factory.mktemp("ckpt") / "bare.ckpt", None)


def _no_dropout_and_jax_mixers(monkeypatch):
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


def _data(n=60, seed=1):
    from multimodalpfn_tpu.datasets.synthetic import toy_multimodal_classification

    return toy_multimodal_classification(n=n, n_classes=3, emb_dim=96, seed=seed)


def _trials(study):
    return [(t.params["mgm_heads"], t.params["cap_heads"], t.state, t.value,
             t.user_attrs.get("n_completed_seeds")) for t in study.trials]


def test_cross_cell_study_matches_jax(bare_ckpt, tmp_path, monkeypatch):
    """mgm {1, 2, 4} × cap {2}, 2 seeds, 4 steps: the same trials as the JAX
    package's (mgm 1 pruned), the same accuracies, and the study JSON."""
    from multimodalpfn_tpu.hpo.experiment import run_experiment_cross_cell as jax_run

    _no_dropout_and_jax_mixers(monkeypatch)
    X, emb, y = _data()
    kw = dict(X=X, embeddings=emb, y=y, n_categorical=0,
              config={"mgm_heads_list": [1, 2, 4], "cap_heads_list": [2], "mixer_type": "MGM+CAP",
                      "features_per_group": 1},
              dataset_name="toy", path_to_base_model=bare_ckpt, n_seeds=2,
              finetuning_config={"max_steps": 4, "validate_every_n_steps": 2, "learning_rate": 3e-3})
    want = jax_run(checkpoint_dir=str(tmp_path / "jax"), **kw)
    got = texp.run_experiment_cross_cell(checkpoint_dir=str(tmp_path / "torch"),
                                         results_path=str(tmp_path / "res.json"), device="cpu", **kw)
    assert _trials(got) == _trials(want)
    assert [t[2] for t in _trials(got)] == ["pruned", "complete", "complete"]
    saved = json.loads((tmp_path / "res.json").read_text())
    assert [(t["params"], t["state"], t["value"]) for t in saved["trials"]] == \
        [(t.params, t.state, t.value) for t in got.trials]
    assert len(list((tmp_path / "torch").glob("*.ckpt"))) == 4


def test_run_experiment_matches_jax_and_learns(base_ckpt, tmp_path, monkeypatch):
    """One cell, one seed, 30 steps at lr 3e-3 on near-separable embeddings:
    the JAX package's accuracy, and above the un-fine-tuned base model's by
    0.1 (the JAX test's learning-quality gate). The base checkpoint holds its
    mixer, so both packages start from the same weights."""
    from multimodalpfn_tpu.hpo.experiment import run_experiment as jax_run
    from multimodalpfn_tpu_torch import MMPFNClassifier

    _no_dropout_and_jax_mixers(monkeypatch)
    X, emb, y = _data(n=100, seed=0)
    kw = dict(X=X, embeddings=emb, y=y, n_categorical=0,
              config={"mgm_heads_list": [2], "cap_heads_list": [2], "features_per_group": 1,
                      "mixer_type": "MGM+CAP"},
              dataset_name="toy", path_to_base_model=base_ckpt, n_seeds=1,
              finetuning_config={"max_steps": 30, "validate_every_n_steps": 5, "learning_rate": 3e-3},
              time_limit=600)
    want = jax_run(checkpoint_dir=str(tmp_path / "jax"), **kw)
    got = texp.run_experiment(checkpoint_dir=str(tmp_path / "torch"), device="cpu", **kw)
    assert _trials(got) == _trials(want)
    assert got.trials[0].state == "complete"

    perm = np.random.default_rng(0).permutation(len(y))
    tr, te = perm[:80], perm[80:]
    base = MMPFNClassifier(model_path=base_ckpt, inference_config=texp._no_preprocessing(),
                           ignore_pretraining_limits=True, mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2,
                           features_per_group=1, device="cpu")
    base.fit(texp.nanmin_impute(X[tr]), emb[tr], y[tr])
    base_acc = float(np.mean(y[te] == base.predict(texp.nanmin_impute(X[te]), emb[te])))
    assert got.best_value > base_acc + 0.1, f"fine-tuned {got.best_value} vs base {base_acc}"


def test_evaluate_cell_vmapped_seeds(base_ckpt, tmp_path):
    out = texp.evaluate_cell(X=_data()[0], embeddings=_data()[1], y=_data()[2], n_categorical=0,
                             mgm_heads=2, cap_heads=2, features_per_group=1, n_seeds=2,
                             path_to_base_model=base_ckpt, checkpoint_dir=str(tmp_path),
                             finetuning_config={"max_steps": 2}, vmapped_seeds=True, device="cpu")
    assert out["n_completed_seeds"] == 2 and 0.0 <= out["mean_accuracy"] <= 1.0
    assert len(list(tmp_path.glob("*_seed*.ckpt"))) == 2


def test_experiments_default_to_the_card(base_ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    X, emb, y = _data(n=30)
    kw = dict(X=X, embeddings=emb, y=y, n_categorical=0, path_to_base_model=base_ckpt, n_seeds=1,
              config={"mgm_heads_list": [2], "cap_heads_list": [2], "features_per_group": 1},
              finetuning_config={"max_steps": 1})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        texp.run_experiment_cross_cell(checkpoint_dir=str(tmp_path), **kw)
    study = texp.run_experiment(checkpoint_dir=str(tmp_path), **kw)
    # a failing seed is left out of its cell (reference run.py:72-98)
    assert study.trials[0].state == "complete" and study.trials[0].user_attrs["n_completed_seeds"] == 0


def test_experiment_runs_without_sklearn_or_yaml():
    """The module imports, sweeps two cells and evaluates them (categorical
    columns included) with scikit-learn and PyYAML made unimportable, and
    `load_experiment_config` reads the experiment config without PyYAML to
    what ``yaml.safe_load`` returns."""
    import yaml

    code = """
    import sys, tempfile
    sys.modules["sklearn"] = None
    sys.modules["yaml"] = None
    import numpy as np, torch
    from multimodalpfn_tpu_torch.hpo.experiment import load_experiment_config, run_experiment_cross_cell
    from multimodalpfn_tpu_torch.models.config import ModelConfig
    from multimodalpfn_tpu_torch.models.loading import save_model
    from multimodalpfn_tpu_torch.models.params import init_params
    cfg = ModelConfig(emsize=24, nhead=6, nhid_factor=4, nlayers=1, n_out=10, max_num_classes=10)
    d = tempfile.mkdtemp()
    save_model(d + "/base.ckpt", init_params(torch.Generator().manual_seed(0), cfg), cfg)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 4)); X[:, :2] = rng.integers(0, 3, size=(40, 2)); X[3, 2] = np.nan
    emb = rng.normal(size=(40, 1, 96)).astype(np.float32); y = rng.integers(0, 2, size=40)
    study = run_experiment_cross_cell(
        X=X, embeddings=emb, y=y, n_categorical=2,
        config={"mgm_heads_list": [2, 4], "cap_heads_list": [2], "features_per_group": 1},
        path_to_base_model=d + "/base.ckpt", n_seeds=1, checkpoint_dir=d,
        finetuning_config={"max_steps": 1}, device="cpu")
    assert [t.state for t in study.trials] == ["complete", "complete"], study.trials
    import json
    print(json.dumps(load_experiment_config("configs/pad_ufes_20.yaml")))
    assert sys.modules["sklearn"] is None and sys.modules["yaml"] is None
    assert not [m for m in sys.modules if m.startswith(("sklearn.", "jax", "multimodalpfn_tpu."))]
    print("ok")
    """
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
    config = json.loads(res.stdout.strip().splitlines()[-2])
    assert config == yaml.safe_load((REPO / "configs" / "pad_ufes_20.yaml").read_text())
