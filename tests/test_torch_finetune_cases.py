"""The port's ``fine_tune_mmpfn`` against the JAX package's on the options a
user sets, on the CPU in float32: a tabular fine-tune's history (train
losses, gradient norms, validation errors, best error, steps) matches to
1e-5 relative with ``episode_batch_size=2``, ``validate_every_n_steps=2``,
``freeze_input``, the validation metrics ``accuracy``, ``roc_auc`` and
``balanced_accuracy``, early stopping, ``task_type="binary"`` and
``optimizer="adamw"``. For ``binary`` the bound is 3e-5: its BCE loss and
gradients match JAX's to 3e-7 and 1e-7 relative on one forward, but the
second step's gradient norm moves by 1.1e-5 relative after the first
update (Adam's normalized step amplifies rounding on near-zero gradients,
as `tests/test_cross_cell_batching.py` notes).
"""

import jax
import numpy as np
import pytest

REL = 1e-5

CASES = {
    "episode_batch_size_2": dict(episode_batch_size=2),
    "validate_every_2": dict(finetuning_config={"max_steps": 4, "validate_every_n_steps": 2}),
    "freeze_input": dict(freeze_input=True),
    "accuracy": dict(validation_metric="accuracy"),
    "roc_auc": dict(validation_metric="roc_auc"),
    "balanced_accuracy": dict(validation_metric="balanced_accuracy"),
    "early_stopping": dict(use_early_stopping=True,
                           finetuning_config={"max_steps": 12, "min_patience": 1, "max_patience": 2,
                                              "adaptive_offset": 0, "adaptive_rate": 0.0}),
    "binary": dict(task_type="binary", n_classes=2, rel=3e-5),
    "adamw": dict(finetuning_config={"max_steps": 3, "optimizer": "adamw"}),
}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """The JAX package's small random base checkpoint, as
    `tests/test_torch_finetune.py` builds it."""
    from multimodalpfn_tpu.models.config import MixerConfig, ModelConfig
    from multimodalpfn_tpu.models.loading import save_model
    from multimodalpfn_tpu.models.params import init_params

    path = tmp_path_factory.mktemp("ckpt") / "base.ckpt"
    cfg = ModelConfig(
        emsize=24, nhead=6, nhid_factor=4, nlayers=2, n_out=10, max_num_classes=10,
        mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96),
    )
    save_model(path, init_params(jax.random.PRNGKey(0), cfg, model_seed=0), cfg)
    return path


@pytest.mark.filterwarnings("ignore:The least populated class")
@pytest.mark.parametrize("case", list(CASES))
def test_finetune_option_history_matches_jax(tiny_ckpt, tmp_path, case):
    from multimodalpfn_tpu.datasets.synthetic import toy_classification
    from multimodalpfn_tpu.train.finetune import fine_tune_mmpfn as jax_ft
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    opts = dict(CASES[case])
    rel = opts.pop("rel", REL)
    X, y = toy_classification(n=100, n_classes=opts.pop("n_classes", 3), nan_share=0.0, seed=0)
    ft = {"max_steps": 3, "learning_rate": 3e-3, **opts.pop("finetuning_config", {})}
    kw = dict(
        mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=tiny_ckpt, finetuning_config=ft, X_train=X, y_train=y, random_seed=0,
        **{"task_type": "multiclass", **opts},
    )
    want = jax_ft(save_path_to_fine_tuned_model=tmp_path / "jax.ckpt", **kw)
    got = fine_tune_mmpfn(save_path_to_fine_tuned_model=tmp_path / "torch.ckpt", device="cpu", **kw)
    assert got["steps"] == want["steps"]
    if case == "early_stopping":
        assert got["steps"] < ft["max_steps"]
    else:
        assert got["steps"] == ft["max_steps"]
    for key in ("train_loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=rel, err_msg=key)
    assert [s for s, _ in got["val_error"]] == [s for s, _ in want["val_error"]]
    np.testing.assert_allclose([e for _, e in got["val_error"]], [e for _, e in want["val_error"]],
                               rtol=rel, atol=rel)
    np.testing.assert_allclose(got["best_val_error"], want["best_val_error"], rtol=rel, atol=rel)
    assert got["skipped_steps"] == 0
