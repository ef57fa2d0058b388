"""Fine-tuning with the fused item gate refused, and the fine-tune's exact
resume, against the JAX package on the CPU in float32.

* Whole-model gradients of ``forward_train_test`` on the kernel path with the
  K2 gate refused (a config without the multiquery test block, or
  ``fused_item=False``): both item blocks run flash attention, whose backward
  on the CPU is K11's plain version; they match ``jax.value_and_grad`` of the
  JAX package's forward to 1e-5 of each leaf's largest gradient. Below 512
  train rows the JAX package takes its XLA branch (`ops/attention.py:344`),
  the same function; `tests/test_torch_flash_bwd.py` pins K11's formula to
  the Pallas VJP.
* A three-step fine-tune of a checkpoint without the multiquery test block
  matches the JAX package's history to 1e-5; so do the steps of the kernel
  path (K4 and K11's plain versions) from the same split.
* ``save_train_state`` / ``restore_train_state`` round-trip bit for bit, and
  a fine-tune interrupted and resumed gives the JAX package's resumed
  history to 1e-5 (the same state cadence and interruption).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_finetune import _tiny_model, _torch_cfg

REL = 1e-5


# ---- whole-model gradients with the gate refused ---------------------------------


@pytest.mark.parametrize(
    "refusal", [dict(multiquery_item_attention_for_test_set=False), dict(fused_item=False)]
)
def test_whole_model_grads_with_the_gate_refused_match_jax(refusal, monkeypatch):
    from multimodalpfn_tpu.models.transformer import forward_train_test as jax_fwd
    from multimodalpfn_tpu.train.losses import get_loss_fn as jax_loss
    from multimodalpfn_tpu_torch.models.params import flatten_params, params_from_jax, unflatten_params
    from multimodalpfn_tpu_torch.models.transformer import forward_train_test
    from multimodalpfn_tpu_torch.ops import flash
    from multimodalpfn_tpu_torch.train.losses import get_loss_fn

    jcfg, jparams = _tiny_model(seed=3)
    multiquery = refusal.get("multiquery_item_attention_for_test_set", True)
    jcfg = dataclasses.replace(jcfg, multiquery_item_attention_for_test_set=multiquery)
    rng = np.random.default_rng(8)
    n_tr, n_te, F_ = 37, 11, 5
    x = rng.standard_normal((1, n_tr + n_te, F_)).astype(np.float32)
    img = rng.standard_normal((1, n_tr + n_te, 1, 96)).astype(np.float32)
    y = rng.integers(0, 3, size=(1, n_tr + n_te)).astype(np.float32)
    args = (x[:, :n_tr], y[:, :n_tr], x[:, n_tr:], img[:, :n_tr], img[:, n_tr:])

    def jloss(p):
        logits = jax_fwd(p, jcfg, *map(jnp.asarray, args), train=True, rng=None)
        return jax_loss("multiclass")(logits, jnp.asarray(y[:, n_tr:]))

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    jg = flatten_params(jax.tree.map(np.asarray, jg))

    calls = []
    real = flash.flash_attention_bwd

    def counted(q, k, v, o, lse, do, sm_scale=None):
        calls.append(tuple(q.shape))
        return real(q, k, v, o, lse, do, sm_scale)

    monkeypatch.setattr(flash, "flash_attention_bwd", counted)
    cfg = _torch_cfg(jcfg, fused_ops=True, use_flash=True, **refusal)
    tp = {k: v.requires_grad_(True) for k, v in flatten_params(params_from_jax(jparams)).items()}
    targs = [torch.from_numpy(a) for a in args]
    logits = forward_train_test(unflatten_params(tp), cfg, *targs, train=True, generator=None)
    loss = get_loss_fn("multiclass")(logits, torch.from_numpy(y[:, n_tr:]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert set(tp) == set(jg)
    for k, want in jg.items():
        got = tp[k].grad.numpy()
        err = np.abs(got - want).max()
        assert err <= REL * np.abs(want).max() + 1e-9, f"{k}: {err} vs {np.abs(want).max()}"
    # K11's backward ran for both item blocks of every layer: the train block
    # per head, the test block per head (no multiquery) or folded (h·n_te
    # queries against KV head 0)
    t, h = F_ + 2 + 1, jcfg.nhead  # 5 features + MGM+CAP 2/2's 2 image tokens + the target
    test_q = (t, h * n_te, jcfg.emsize // h) if multiquery else (t * h, n_te, jcfg.emsize // h)
    assert sorted(calls) == sorted([(t * h, n_tr, jcfg.emsize // h), test_q] * jcfg.nlayers)


# ---- fine-tuning a checkpoint without the multiquery test block ----------------------


def _ckpt(path, multiquery: bool):
    """The JAX package's small random base checkpoint, written by the JAX
    package's `save_model`, with or without the multiquery test block."""
    from multimodalpfn_tpu.models.config import MixerConfig, ModelConfig
    from multimodalpfn_tpu.models.loading import save_model
    from multimodalpfn_tpu.models.params import init_params

    cfg = ModelConfig(
        emsize=24, nhead=6, nhid_factor=4, nlayers=2, n_out=10, max_num_classes=10,
        mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96),
        multiquery_item_attention_for_test_set=multiquery,
    )
    save_model(path, init_params(jax.random.PRNGKey(0), cfg, model_seed=0), cfg)
    return path


@pytest.fixture(scope="module")
def non_multiquery_ckpt(tmp_path_factory):
    return _ckpt(tmp_path_factory.mktemp("ckpt") / "base_nmq.ckpt", multiquery=False)


def _ft_kw(ckpt, **over):
    from multimodalpfn_tpu.datasets.synthetic import toy_classification

    X, y = toy_classification(n=100, n_classes=3, nan_share=0.0, seed=0)
    kw = dict(
        mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=ckpt,
        finetuning_config={"max_steps": 3, "learning_rate": 3e-3},
        validation_metric="log_loss", task_type="multiclass",
        X_train=X, y_train=y, random_seed=0,
    )
    return kw | over


def _same_history(got, want):
    assert got["steps"] == want["steps"]
    for key in ("train_loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=REL, err_msg=key)
    assert [s for s, _ in got["val_error"]] == [s for s, _ in want["val_error"]]
    np.testing.assert_allclose([e for _, e in got["val_error"]], [e for _, e in want["val_error"]],
                               rtol=REL)
    np.testing.assert_allclose(got["best_val_error"], want["best_val_error"], rtol=REL)


def test_non_multiquery_finetune_history_matches_jax(non_multiquery_ckpt, tmp_path):
    """A checkpoint whose item attention has no multiquery test block: the
    port's history equals the JAX package's; its snapshot keeps the key, so
    the classifier serves it the same way; and the kernel path's steps (the
    gate refuses the fused item sublayer, so K4 and K11's plain versions run
    in both item blocks) give the same losses."""
    from multimodalpfn_tpu.train.finetune import fine_tune_mmpfn as jax_ft
    from multimodalpfn_tpu_torch.models.loading import load_model
    from multimodalpfn_tpu_torch.train.finetune import (
        create_val_data,
        fine_tune_mmpfn,
        make_episode_trainer,
    )

    kw = _ft_kw(non_multiquery_ckpt)
    want = jax_ft(save_path_to_fine_tuned_model=tmp_path / "jax.ckpt", **kw)
    got = fine_tune_mmpfn(save_path_to_fine_tuned_model=tmp_path / "torch.ckpt", device="cpu", **kw)
    assert got["steps"] == 3 and got["skipped_steps"] == 0
    _same_history(got, want)
    snap = load_model(tmp_path / "torch.ckpt", mixer_type="none")
    assert snap.config.multiquery_item_attention_for_test_set is False

    X_tr, _, _, _, y_tr, _ = create_val_data(X=kw["X_train"], image=None, y=kw["y_train"],
                                             rng=np.random.RandomState(0), is_classification=True)
    trainer = make_episode_trainer(
        path_to_base_model=non_multiquery_ckpt, mixer_type="none", mgm_heads=2, cap_heads=2,
        features_per_group=1, X_train=X_tr, image_train=None, y_train=y_tr, device="cpu",
        random_seed=0, learning_rate=3e-3, cfg_override={"fused_ops": True, "use_flash": True},
    )
    assert trainer.cfg.multiquery_item_attention_for_test_set is False
    steps = [trainer.step() for _ in range(3)]
    np.testing.assert_allclose([float(m["loss"]) for m in steps], want["train_loss"], rtol=REL)
    np.testing.assert_allclose([float(m["grad_norm"]) for m in steps], want["grad_norm"], rtol=REL)


# ---- resume -----------------------------------------------------------------------


def test_train_state_round_trips_bit_for_bit(tmp_path):
    """Params, the optimizer's z and ν of every trainable leaf, its counters
    and the step come back bit for bit; frozen leaves keep no state; a file
    of another structure is refused."""
    from multimodalpfn_tpu_torch.train import step as ts

    gen = torch.Generator().manual_seed(0)
    params = {"encoder": {"w": torch.randn(3, 4, generator=gen)},
              "layers": {"w": torch.randn(2, 5, generator=gen)}}

    def fresh(p=params):
        return ts.init_train_state(p, lambda q: ts.make_optimizer(
            q, 1e-5, freeze_mask=ts.frozen_input_mask(q, True)))

    state = fresh()
    for i in range(4):
        for p in ts.flatten_params(state.params).values():
            p.grad = torch.randn(p.shape, generator=gen) * (float("nan") if i == 2 else 1.0)
        state.optimizer.step()
        state.step += 1
    assert state.optimizer.total_notfinite == 1 and state.optimizer.count == 3
    path = tmp_path / "ft.ckpt.state.npz"
    ts.save_train_state(path, state)
    restored = ts.restore_train_state(path, fresh())
    a, b = ts.train_state_arrays(state), ts.train_state_arrays(restored)
    assert a.keys() == b.keys() and "z/encoder/w" not in a and "z/layers/w" in a
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert restored.step == 4 and restored.optimizer.max_lr == state.optimizer.max_lr
    other = fresh({"layers": {"w": torch.zeros(2, 5)}})
    with pytest.raises(ValueError, match="leaves are not the optimizer's"):
        ts.restore_train_state(path, other)


def test_resumed_finetune_history_matches_jax(tmp_path):
    """Interrupted after 4 steps with the state written every 2 (before steps
    2 and 4, so the file holds the state after step 3), then resumed to 6
    steps: the resumed call starts at step 4, and its history equals the JAX
    package's resumed history. Both restart their episode sampler from its
    seed, so the resumed steps see the first run's first episodes again."""
    from multimodalpfn_tpu.train.finetune import fine_tune_mmpfn as jax_ft
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    ckpt = _ckpt(tmp_path / "base.ckpt", multiquery=True)
    runs = {}
    for name, ft, extra in (("jax", jax_ft, {}), ("torch", fine_tune_mmpfn, {"device": "cpu"})):
        out = tmp_path / f"{name}.ckpt"
        first = ft(save_path_to_fine_tuned_model=out, state_checkpoint_every=2,
                   **_ft_kw(ckpt, finetuning_config={"max_steps": 4, "learning_rate": 3e-3}), **extra)
        assert first["steps"] == 4 and (tmp_path / f"{name}.ckpt.state.npz").exists()
        resumed = ft(save_path_to_fine_tuned_model=out, state_checkpoint_every=2, resume=True,
                     **_ft_kw(ckpt, finetuning_config={"max_steps": 6, "learning_rate": 3e-3}), **extra)
        runs[name] = (first, resumed)
    (jfirst, jres), (tfirst, tres) = runs["jax"], runs["torch"]
    _same_history(tfirst, jfirst)
    _same_history(tres, jres)
    assert [s for s, _ in tres["val_error"]] == [4, 5, 6] and len(tres["train_loss"]) == 3
    assert np.isfinite(tres["train_loss"]).all() and tres["skipped_steps"] == 0
    # the sampler restarted: the resumed step 4 is not the first run's step 4
    assert tres["train_loss"][0] != tfirst["train_loss"][3]
