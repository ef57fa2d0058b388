"""The port's examples (`multimodalpfn_tpu_torch/examples/`) on the CPU: each
example's ``main`` on a tiny checkpoint returns finite metrics in range,
the serving example's pipelined answers equal its sequential ones bit for
bit, importing an example runs nothing, and without CUDA each example
refuses its default device and names ``device="cpu"``.

The checkpoints are the port's own: 2 layers, width 24, nhid 768 (the
mixers' input width), every leaf moved by seeded noise so that the
zero-initialized output projections do not hide the model; a mixer absent
from a checkpoint is drawn from its model seed at the example's head counts.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodalpfn_tpu_torch.models.config import ModelConfig
from multimodalpfn_tpu_torch.models.loading import save_model
from multimodalpfn_tpu_torch.models.params import flatten_params, init_params
from tests.test_torch_utils import few_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ["mmpfn_multimodal_classification", "serving_pipelined_requests",
            "tabpfn_for_binary_classification", "tabpfn_for_multiclass_classification",
            "tabpfn_for_regression"]


def _save(path: Path, **cfg_kw) -> str:
    cfg = ModelConfig(emsize=24, nhead=6, nhid_factor=32, nlayers=2, **cfg_kw)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    for leaf in flatten_params(params).values():
        leaf.add_(0.05 * torch.randn(leaf.shape, generator=gen))
    regression = cfg_kw.get("max_num_classes") == 0
    save_model(path, params, cfg, criterion_borders=np.linspace(-12, 12, cfg.n_out + 1) if regression else None)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    return {
        "fpg1": _save(d / "fpg1.ckpt", n_out=10, max_num_classes=10),
        "fpg2": _save(d / "fpg2.ckpt", n_out=10, max_num_classes=10, features_per_group=2),
        "regressor": _save(d / "regressor.ckpt", n_out=5000, max_num_classes=0),
    }


def _example(name):
    return importlib.import_module(f"multimodalpfn_tpu_torch.examples.{name}")


def test_multimodal_classification(ckpts, tmp_path, monkeypatch):
    """Three fine-tune steps: the mixers' 16 heads over 768-wide embeddings
    make each step costly on the CPU; the card runs the example's 100."""
    monkeypatch.chdir(tmp_path)  # the example writes checkpoints/ under the working directory
    out = _example("mmpfn_multimodal_classification").main(ckpts["fpg2"], "cpu", max_steps=3)
    assert set(out) == {"accuracy"} and 0.0 <= out["accuracy"] <= 1.0
    assert (tmp_path / "checkpoints" / "finetuned_example.ckpt").exists()


def test_serving_pipelined_equals_sequential(ckpts, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = _example("serving_pipelined_requests").main(ckpts["fpg1"], "cpu")
    assert out["pipelined_equals_sequential"] is True
    assert len(out["probas"]) == len(out["sequential"]) == 4
    for got, want in zip(out["probas"], out["sequential"]):
        assert got.shape == want.shape == (25, 3) and got.dtype == want.dtype
        assert np.array_equal(got, want)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    assert all(1 / 3 <= m <= 1.0 for m in out["mean_max_proba"])


@pytest.mark.parametrize("name,key", [("tabpfn_for_binary_classification", "roc_auc"),
                                      ("tabpfn_for_multiclass_classification", "roc_auc_ovo")])
def test_tabpfn_classification(name, key, ckpts, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = _example(name).main(ckpts["fpg1"], "cpu")
    assert set(out) == {key, "accuracy"}
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in out.values())


def test_tabpfn_regression(ckpts, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = _example("tabpfn_for_regression").main(ckpts["regressor"], "cpu")
    assert np.isfinite(out["mse"]) and out["mse"] >= 0.0
    assert np.isfinite(out["r2"]) and out["r2"] <= 1.0
    assert len(out["median_head"]) == 5 and np.isfinite(out["median_head"]).all()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_cuda_names_the_cpu_option(name, ckpts, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    ckpt = ckpts["regressor" if name.endswith("regression") else "fpg2" if name.startswith("mmpfn") else "fpg1"]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _example(name).main(ckpt)
    assert not (tmp_path / "checkpoints").exists()


def test_importing_the_examples_runs_nothing(tmp_path):
    code = "; ".join(f"import multimodalpfn_tpu_torch.examples.{name}" for name in EXAMPLES)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == "" and list(tmp_path.iterdir()) == []
