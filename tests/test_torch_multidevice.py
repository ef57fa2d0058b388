"""The port's multi-device paths on four gloo ranks (`parallel/launch.run_ranks`,
one torch thread a rank), against single-process runs of the port in this
process (one torch thread too, so that the sums run in the same order):

* the sweep (`fine_tune_batched_cells`, 4 runs of two padded MGM+CAP cells,
  3 steps) over 2 ``dp`` ranks of a ``(2, 2)`` mesh equals the single-process
  sweep exactly: losses, validation errors, skipped steps and every final
  param of every run;
* `fine_tune_batched` over ``dp`` = 4 (the JAX package's
  ``test_fine_tune_batched_on_mesh`` case) gives finite losses and the JAX
  package's history shapes on the same case;
* `shard_estimator` at ``mp`` = 2 (attention heads, MLP hidden units and MGM
  heads sharded at rest, gathered layer by layer) serves the unsharded
  classifier's probabilities (``fit_preprocessors`` and ``fit_with_cache``)
  and regressor's means bit for bit;
* one training step on the ``(2, 2)`` mesh (each ``dp`` rank one of the
  batch's two episodes, the params sharded over ``mp``) equals the
  single-process step on the whole batch: loss, gradient norm, every
  gradient and every param after the step, to 1e-6 of each leaf's largest.
"""

import jax
import numpy as np
import pytest
import torch

from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.loading import save_model as jsave_model
from multimodalpfn_tpu.models.params import init_params as jinit_params
from multimodalpfn_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodalpfn_tpu.train.finetune_batch import fine_tune_batched as jfine_tune_batched
from multimodalpfn_tpu_torch.datasets.synthetic import toy_multimodal_classification
from multimodalpfn_tpu_torch.parallel.launch import run_ranks
from multimodalpfn_tpu_torch.train.finetune_batch import fine_tune_batched_cells
from tests import torch_parallel_workers as w

STEP_REL = 1e-6
BORDERS = np.linspace(-6, 6, 5001).astype(np.float32)


@pytest.fixture
def one_thread():
    """One torch thread, as each rank runs: the same summation order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save(path, cfg, seed, noise=0.0, **kw):
    tree = jax.device_get(jinit_params(jax.random.PRNGKey(seed), cfg, model_seed=0))
    if noise:  # fill the zero-initialized output projections
        rng = np.random.default_rng(seed)
        tree = jax.tree.map(lambda a: (np.asarray(a) + noise * rng.standard_normal(a.shape)).astype(np.float32),
                            tree)
    jsave_model(path, tree, cfg, **kw)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("multidevice")
    # the JAX mesh test's base model and data
    mesh_cfg = JModelConfig(emsize=24, nhead=6, nhid_factor=4, nlayers=2, n_out=10, max_num_classes=10,
                            mixer=JMixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96))
    mesh_ckpt = _save(d / "mesh_base.ckpt", mesh_cfg, 0)
    mesh_data = toy_multimodal_classification(n=60, n_classes=2, emb_dim=96, seed=1)
    # a 1-layer width-32 model without a mixer (the sweep and the classifier
    # draw theirs), a 2-layer regressor of 5000 bars
    small = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=1, n_out=4, max_num_classes=4,
                         compute_dtype="float32")
    ckpt = _save(d / "base.ckpt", small, 3)
    reg_cfg = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=5000, max_num_classes=0,
                           num_buckets=5000)
    reg_ckpt = _save(d / "reg.ckpt", reg_cfg, 0, noise=0.05, criterion_borders=BORDERS)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 3)).astype(np.float32)
    img = rng.normal(size=(40, 1, 64)).astype(np.float32)
    y = rng.integers(0, 3, size=40)
    y_reg = X[:, 0] + 0.5 * rng.normal(size=40)
    sweep_data = (X, img, y)
    clf_data = (X[:30], img[:30], y[:30], X[30:], img[30:])
    reg_data = (X[:30], img[:30], y_reg[:30], X[30:], img[30:])
    port = run_ranks(w.multidevice_checks, 4, mesh_ckpt, mesh_data, ckpt, sweep_data, ckpt, reg_ckpt, clf_data,
                     reg_data, workdir=d / "ranks", timeout=300)
    return dict(port=port, mesh_ckpt=mesh_ckpt, mesh_data=mesh_data, ckpt=ckpt, sweep_data=sweep_data)


def test_sweep_over_dp_equals_single_process(setup, one_thread):
    want = w.sweep_result(fine_tune_batched_cells(**w.sweep_kwargs(setup["ckpt"], setup["sweep_data"])))
    assert want["train_loss"].shape == (3, 4)
    for out in setup["port"]:
        got = out["sweep"]
        np.testing.assert_array_equal(got["train_loss"], want["train_loss"])
        assert got["val_error"] == want["val_error"]
        assert got["best_val_error"] == want["best_val_error"]
        assert got["skipped_steps"] == want["skipped_steps"]
        assert got["n_step_seconds"] == want["n_step_seconds"]
        assert set(got["params"]) == set(want["params"])
        for key, value in want["params"].items():
            np.testing.assert_array_equal(got["params"][key], value, err_msg=key)


def test_fine_tune_batched_on_mesh(setup):
    X, emb, y = setup["mesh_data"]
    want = jfine_tune_batched(mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2, features_per_group=1,
                              path_to_base_model=setup["mesh_ckpt"], X=X, image=emb, y=y, seeds=[0, 1, 2, 3],
                              finetuning_config={"max_steps": 2, "validate_every_n_steps": 2},
                              mesh=jmake_mesh(4, mp=1))["history"]
    for out in setup["port"]:
        got = out["mesh_history"]
        assert np.isfinite(got["train_loss"]).all()
        assert got["train_loss"].shape == np.asarray(want["train_loss"]).shape == (2, 4)
        assert [s for s, _ in got["val_error"]] == [s for s, _ in want["val_error"]]
        assert [len(e) for _, e in got["val_error"]] == [len(e) for _, e in want["val_error"]]
        assert len(got["best_val_error"]) == len(want["best_val_error"]) == 4


@pytest.mark.parametrize("kind", ["classifier", "classifier_cache", "regressor"])
def test_shard_estimator_serves_the_unsharded_answers(setup, kind):
    for out in setup["port"]:
        unsharded, sharded = out[kind]
        assert np.isfinite(unsharded).all() and unsharded.shape[0] == 10
        np.testing.assert_array_equal(sharded, unsharded)


def test_dp_mp_train_step_equals_single_process(setup, one_thread):
    want = w.train_step_result()
    assert want["applied"]
    for out in setup["port"]:
        got = out["step"]
        assert got["applied"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=STEP_REL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=STEP_REL)
        for part in ("grads", "params"):
            assert set(got[part]) == set(want[part])
            for key, value in want[part].items():
                np.testing.assert_allclose(got[part][key], value, rtol=0,
                                           atol=STEP_REL * max(np.abs(value).max(), 1e-30), err_msg=f"{part} {key}")
