"""The port's command-line entry points (`multimodalpfn_tpu_torch/scripts/`)
against the JAX package's `scripts/`, on the CPU in float32.

* ``finetune_cli`` and the JAX CLI on the same ``.npy`` files with
  ``--hps configs/finetuning_hps.yaml --steps 3``: the same steps, the best
  validation error to 1e-5 relative and the saved checkpoints' params to
  1e-5.
* ``run_published`` configs 1 and 2 on `tests/test_run_published.py`'s
  120-row PAD-UFES fixture with pre-seeded caches: the same accuracy, AUROC
  to 1e-6; then the port's configs 1-4 end to end (the JAX file's slow
  chain, made fast by a tiny checkpoint).
* ``run_experiment``: the keyword arguments each CLI passes to its package's
  ``run_experiment``, bit for bit, for every dataset and task the CLI
  dispatches; then one real run and its results JSON.
* Without CUDA every CLI raises and names ``--device cpu``.

The base checkpoint is written by the JAX ``save_model``: 2 layers, width
24, MGM+CAP 2/2 over 768-wide embeddings (the mixer's input width is the
layer's nhid, 24 × 32), every leaf moved by seeded noise so that the
zero-initialized output projections do not hide the model. The mixers'
dropout is off in both packages (their masks come from different
generators).
"""

import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodalpfn_tpu.models import params as jparams
from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu_torch.models.loading import load_model
from multimodalpfn_tpu_torch.models.params import flatten_params
from multimodalpfn_tpu_torch.scripts import finetune_cli, run_experiment, run_published
from tests.test_run_published import pad_dir  # noqa: F401  (the 120-row fixture)
from tests.test_torch_loaders import _airbnb, _cbis, _cloth, _pad_ufes, _petfinder, _salary
from tests.test_torch_utils import few_threads, no_handler_shutdown, restore_package_loggers  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
REL = 1e-5
AUROC_ABS = 1e-6


def save_base(path: Path) -> str:
    """A 2-layer width-24 checkpoint with its mixer over 768-wide inputs, in
    the reference format, written by the JAX package."""
    from multimodalpfn_tpu.models.loading import save_model

    cfg = JModelConfig(emsize=24, nhead=6, nhid_factor=32, nlayers=2, n_out=10, max_num_classes=10,
                       mixer=JMixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=768))
    rng = np.random.default_rng(0)
    tree = jax.device_get(jparams.init_params(jax.random.PRNGKey(0), cfg, model_seed=0))
    tree = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                        tree)
    save_model(path, tree, cfg)
    return str(path)


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    return save_base(tmp_path_factory.mktemp("ckpt") / "base.ckpt")


def no_dropout(monkeypatch):
    from multimodalpfn_tpu.models import mixers as jmixers
    from multimodalpfn_tpu_torch.models import mixers as tmixers

    monkeypatch.setattr(jmixers, "_dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(tmixers, "_dropout", lambda x, *a, **k: x)


def seed_caches(root: Path, n: int) -> Path:
    """The image and clinical-note caches of PAD-UFES-20 under ``root``."""
    rng = np.random.default_rng(1)
    emb_root = root / "embeddings"
    (emb_root / "pad_ufes_20").mkdir(parents=True, exist_ok=True)
    np.savez_compressed(emb_root / "pad_ufes_20" / "pad_ufes_20_dinov2.npz",
                        embeddings=rng.normal(size=(n, 1, 768)).astype(np.float32))
    np.savez_compressed(emb_root / "pad_ufes_20" / "pad_ufes_20_clinical_electra.npz",
                        emb=rng.normal(size=(n, 1, 768)).astype(np.float32))
    return emb_root


def published_argv(tmp_path, emb_root, ckpt, configs, results) -> list[str]:
    return ["--data-root", str(tmp_path / "data"), "--embeddings-root", str(emb_root), "--ckpt", ckpt,
            "--configs", configs, "--seeds", "1", "--steps", "2", "--mgm-heads", "2", "--cap-heads", "2",
            "--results", str(results)]


# ---- finetune_cli ----------------------------------------------------------------


def test_finetune_cli_matches_jax(base_ckpt, tmp_path, monkeypatch, capsys):
    import finetune_cli as jax_cli
    from multimodalpfn_tpu.datasets.synthetic import toy_multimodal_classification
    from multimodalpfn_tpu.train.snapshots import wait_for_pending_snapshots

    no_dropout(monkeypatch)
    no_handler_shutdown(monkeypatch)  # the JAX CLI's setup_logging runs dictConfig
    monkeypatch.chdir(tmp_path)  # the CLIs log to logs/ under the working directory
    X, emb, y = toy_multimodal_classification(n=80, n_classes=3, emb_dim=768, seed=0)
    for name, a in (("x", X), ("image", emb), ("y", y)):
        np.save(tmp_path / f"{name}.npy", a)
    argv = ["--x", str(tmp_path / "x.npy"), "--image", str(tmp_path / "image.npy"), "--y",
            str(tmp_path / "y.npy"), "--base", base_ckpt, "--mgm-heads", "2", "--cap-heads", "2", "--fpg", "1",
            "--hps", str(REPO / "configs" / "finetuning_hps.yaml"), "--steps", "3"]

    monkeypatch.setattr(sys, "argv", ["finetune_cli.py", *argv, "--out", str(tmp_path / "jax.ckpt")])
    jax_cli.main()
    wait_for_pending_snapshots()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = finetune_cli.main([*argv, "--out", str(tmp_path / "torch.ckpt"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got

    assert got["steps"] == want["steps"] == 3
    np.testing.assert_allclose(got["best_val_error"], want["best_val_error"], rtol=REL)
    kw = dict(mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2)
    a = flatten_params(load_model(tmp_path / "torch.ckpt", **kw).params)
    b = flatten_params(load_model(tmp_path / "jax.ckpt", **kw).params)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=REL, rtol=0, err_msg=k)


# ---- run_published ---------------------------------------------------------------


@pytest.mark.parametrize("config", ["1", "2"])
def test_run_published_matches_jax(config, pad_dir, base_ckpt, monkeypatch):  # noqa: F811
    import run_published as jax_script

    no_dropout(monkeypatch)
    tmp_path, n = pad_dir
    emb_root = seed_caches(tmp_path, n)
    want = jax_script.main(published_argv(tmp_path, emb_root, base_ckpt, config, tmp_path / "jax.json"))
    got = run_published.main(published_argv(tmp_path, emb_root, base_ckpt, config, tmp_path / "torch.json")
                             + ["--device", "cpu"])
    (w,), (g,) = want["runs"], got["runs"]
    assert g["config"] == w["config"]
    assert g["accuracy_mean"] == w["accuracy_mean"]
    assert abs(g["auroc_mean"] - w["auroc_mean"]) <= AUROC_ABS, (g, w)


def test_run_published_port_chain(pad_dir, base_ckpt, capsys):  # noqa: F811
    """Configs 1-4 (tabular, + image, + text, tri-modal with 8 members) from
    the data directory to the results JSON."""
    tmp_path, n = pad_dir
    emb_root = seed_caches(tmp_path, n)
    results = tmp_path / "out" / "published.json"
    out = run_published.main(published_argv(tmp_path, emb_root, base_ckpt, "1,2,3,4", results)
                             + ["--device", "cpu"])
    assert [r["config"] for r in out["runs"]] == ["1-tabular-only", "2-tabular+image", "3-tabular+text",
                                                  "4-trimodal-8member"]
    for r in out["runs"]:
        assert 0.0 <= r["auroc_mean"] <= 1.0 and 0.0 <= r["accuracy_mean"] <= 1.0 and r["n_seeds"] == 1
    assert json.loads(results.read_text()) == out
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_clinical_notes_match_jax(pad_dir):  # noqa: F811
    import run_published as jax_script
    from multimodalpfn_tpu_torch.datasets.loaders import PADUFES20Dataset

    tmp_path, n = pad_dir
    ds = PADUFES20Dataset(str(tmp_path / "data" / "pad_ufes_20"))
    notes = run_published.clinical_notes(ds.df)
    assert len(notes) == n and notes == jax_script.clinical_notes(ds.df)


# ---- run_experiment --------------------------------------------------------------

# (CLI arguments, the function that writes the dataset's files under the data root)
EXPERIMENTS = {
    "pad_ufes_20": (["pad_ufes_20"], lambda r: _pad_ufes(r / "pad_ufes_20")),
    "cbis_ddsm_mass": (["cbis_ddsm", "mass"], lambda r: _cbis_named(r, "mass")),
    "cbis_ddsm_calc": (["cbis_ddsm", "calc"], lambda r: _cbis_named(r, "calc")),
    "petfinder_image": (["petfinder", "image"], lambda r: _petfinder(r / "petfinder_adoption")),
    "petfinder_text": (["petfinder", "text"], lambda r: _petfinder(r / "petfinder_adoption")),
    "petfinder_all": (["petfinder", "all"], lambda r: _petfinder(r / "petfinder_adoption")),
    "cloth": (["cloth"], lambda r: _cloth_named(r)),
    "airbnb": (["airbnb"], lambda r: _airbnb(r / "airbnb")),
    "salary": (["salary"], lambda r: _salary(r / "salary")),
}


def _cbis_named(root: Path, kind: str) -> None:
    d = _cbis(root / "cbis_ddsm", kind)
    (d / f"{kind}_case.csv").rename(d / f"{kind}_case_description_train_set.csv")


def _cloth_named(root: Path) -> None:
    d = _cloth(root / "cloth")
    (d / "reviews.csv").rename(d / "Womens Clothing E-Commerce Reviews.csv")


def _seed_experiment_cache(args: list[str], data_root: Path) -> None:
    """The embeddings cache the CLI reads for ``args``, under ``embeddings/``
    of the working directory."""
    from multimodalpfn_tpu_torch.datasets import loaders

    name, task = args[0], (args[1] if len(args) > 1 else None)
    if name == "cbis_ddsm":
        ds = loaders.CBISDDSMDataset(str(data_root / name), f"{task}_case_description_train_set.csv", task, "all")
        cache = ds._cache_path()
    elif name == "petfinder":
        ds = loaders.PetfinderDataset(str(data_root / "petfinder_adoption"))
        cache = ds._cache_path(task)
    else:
        ds = loaders.DATASETS[name](str(data_root / name))
        cache = ds._cache_path()
    loaders._save_cache(cache, np.random.default_rng(2).normal(size=(len(ds), 2, 16)).astype(np.float32))


class _Recorded:
    best_params = {"mgm_heads": 2, "cap_heads": 2}
    best_value = 0.5


def _one_cell_config(path: Path) -> Path:
    path.write_text('# one grid cell\nmgm_heads_list: [2]\ncap_heads_list: [2]\nfeatures_per_group: 1\n'
                    'mixer_type: "MGM+CAP"\n')
    return path


@pytest.mark.parametrize("case", list(EXPERIMENTS))
def test_run_experiment_passes_the_jax_arguments(case, tmp_path, monkeypatch):
    import run_experiment as jax_cli
    from multimodalpfn_tpu.hpo import experiment as jexp
    from multimodalpfn_tpu_torch.hpo import experiment as texp

    args, build = EXPERIMENTS[case]
    monkeypatch.chdir(tmp_path)
    build(tmp_path / "data")
    _seed_experiment_cache(args, tmp_path / "data")
    cfg = _one_cell_config(tmp_path / "cell.yaml")
    calls = {}

    def recorder(tag):
        def run(**kw):
            calls[tag] = kw
            return _Recorded()
        return run

    monkeypatch.setattr(jexp, "run_experiment", recorder("jax"))
    monkeypatch.setattr(texp, "run_experiment", recorder("torch"))
    argv = [*args, "--data-root", "data", "--config", str(cfg), "--base-model", "base.ckpt", "--seeds", "3",
            "--results-dir", "res"]
    monkeypatch.setattr(sys, "argv", ["run_experiment.py", *argv])
    jax_cli.main()
    out = run_experiment.main([*argv, "--device", "cpu"])
    assert out == {"best_params": _Recorded.best_params, "best_value": _Recorded.best_value}

    want, got = calls["jax"], calls["torch"]
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for key in ("X", "embeddings", "y"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in set(want) - {"X", "embeddings", "y"}:
        assert got[key] == want[key] and type(got[key]) is type(want[key]), key


def test_run_experiment_cli_writes_its_study(pad_dir, base_ckpt, monkeypatch, capsys):  # noqa: F811
    """One cell, one seed, the reference's 100 steps: the printed best equals
    the study the CLI wrote."""
    no_dropout(monkeypatch)
    tmp_path, n = pad_dir
    monkeypatch.chdir(tmp_path)
    seed_caches(tmp_path, n)
    out = run_experiment.main(["pad_ufes_20", "--data-root", "data", "--config",
                               str(_one_cell_config(tmp_path / "cell.yaml")), "--base-model", base_ckpt,
                               "--seeds", "1", "--results-dir", "res", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    saved = json.loads((tmp_path / "res" / "pad_ufes_20.json").read_text())
    (trial,) = saved["trials"]
    assert trial["state"] == "complete" and trial["params"] == {"mgm_heads": 2, "cap_heads": 2}
    assert trial["user_attrs"]["n_completed_seeds"] == 1 and 0.0 <= trial["value"] <= 1.0
    assert out == {"best_params": trial["params"], "best_value": trial["value"]}
    assert (tmp_path / "checkpoints" / "finetuned_mmpfn_pad_ufes_20.ckpt").exists()


# ---- the card ----------------------------------------------------------------------

CLI_ARGV = {
    "finetune_cli": (finetune_cli, ["--y", "y.npy", "--out", "out.ckpt"]),
    "run_experiment": (run_experiment, ["pad_ufes_20"]),
    "run_published": (run_published, []),
}


@pytest.mark.parametrize("name", list(CLI_ARGV))
def test_cli_without_cuda_names_the_cpu_option(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    module, argv = CLI_ARGV[name]
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(argv)
    assert not (tmp_path / "logs").exists()  # nothing ran before the refusal


@pytest.mark.parametrize("name", list(CLI_ARGV))
def test_cli_module_entry(name, monkeypatch, capsys):
    """``python -m multimodalpfn_tpu_torch.scripts.<name> --help``, run as
    ``__main__``."""
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as exit_:
        runpy.run_module(f"multimodalpfn_tpu_torch.scripts.{name}", run_name="__main__")
    assert exit_.value.code == 0 and "--device" in capsys.readouterr().out
