"""The port's batched multi-run fine-tuning (train/finetune_batch.py) and the
padded mixers it runs, against the JAX package on the CPU in float32.

* `pad_mixer_params` / `slice_mixer_params` equal the JAX package's for MGM,
  MGM+CAP and MoE; the padded + masked forward equals the JAX package's
  padded forward and the port's unpadded forward to 1e-5, on the JAX test's
  cases (densified 2-layer width-32 params); padded leaves get exactly zero
  gradient, and the gradients match ``jax.grad`` to 1e-5 of each leaf's
  largest.
* ``fine_tune_batched_cells`` histories equal the JAX package's to 1e-5
  relative: tabular (schedule-free, ``adamw``, schedule-free with warmup),
  and multimodal MGM+CAP over padded cells with the JAX package's mixer
  inits injected into the port and the mixers' dropout off in both (their
  masks come from different generators); the extracted params equal JAX's.
* Within the port, cells batched together equal the cells run alone: at a
  real learning rate to the JAX test's tolerances, at 1e-12 to 1e-9.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalpfn_tpu.models import params as jparams
from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.transformer import forward as jforward
from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.config import MixerConfig, ModelConfig
from multimodalpfn_tpu_torch.models.transformer import forward_train_test
from multimodalpfn_tpu_torch.train import finetune_batch as tfb

REL = 1e-5
# the JAX test's cases: (mixer type, active heads, padded heads, cap heads)
PAD_CASES = [("MGM+CAP", 2, 5, 2), ("MGM", 2, 6, 2), ("MoE", 3, 7, 2)]


def _jcfg(mixer_type, mgm, cap):
    return JModelConfig(
        emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=4, max_num_classes=4,
        compute_dtype="float32",
        mixer=JMixerConfig(mixer_type=mixer_type, mgm_heads=mgm, cap_heads=cap, in_dim=64),
    )


def _tcfg(jcfg, **kw):
    d = dataclasses.asdict(jcfg)
    return dataclasses.replace(ModelConfig(mixer=MixerConfig(**d.pop("mixer")), **d), **kw)


def _data(seed=0, b=2, S=20, F=3, n_img=1, in_dim=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, F)).astype(np.float32)
    y = rng.integers(0, 3, size=(b, 12)).astype(np.float32)
    img = rng.normal(size=(b, S, n_img, in_dim)).astype(np.float32)
    return x, y, img


def _densified(cfg, seed):
    """The JAX test's `_densify`: every leaf perturbed, so attention mixes."""
    params = jparams.init_params(jax.random.PRNGKey(seed), cfg, model_seed=0)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    leaves = [l + 0.05 * jax.random.normal(k, l.shape, l.dtype) for l, k in zip(leaves, keys)]
    return jax.device_get(jax.tree_util.tree_unflatten(treedef, leaves))


def _noise(mixer_type, F, m_active, m_padded, n_img, emsize):
    """The run's own active-count noise table, zero-padded (MGM/MoE)."""
    if mixer_type == "MGM+CAP":
        return None
    per = n_img if mixer_type == "MGM" else 1
    tab = jparams.get_subspace_noise(0, F + m_active * per, emsize // 4)
    return np.pad(tab, ((0, (m_padded - m_active) * per), (0, 0))).astype(np.float32)


@pytest.mark.parametrize("mixer_type,m_active,m_padded,cap", PAD_CASES)
def test_pad_and_slice_match_jax(mixer_type, m_active, m_padded, cap):
    cfg_a, cfg_p = _jcfg(mixer_type, m_active, cap), _jcfg(mixer_type, m_padded, cap)
    mixer = jax.device_get(jparams.init_mixer_params(jax.random.PRNGKey(1), cfg_a.mixer, 32))
    want = tparams.flatten_params(jax.device_get(jparams.pad_mixer_params(mixer, cfg_p.mixer)))
    padded = tparams.pad_mixer_params(tparams.params_from_jax(mixer), _tcfg(cfg_p).mixer)
    got = tparams.flatten_params(padded)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    back = tparams.flatten_params(tparams.slice_mixer_params(padded, _tcfg(cfg_a).mixer))
    for k, w in tparams.flatten_params(mixer).items():
        np.testing.assert_array_equal(back[k].numpy(), w, err_msg=k)


def _padded_case(mixer_type, m_active, m_padded, cap, seed=0):
    cfg_a, cfg_p = _jcfg(mixer_type, m_active, cap), _jcfg(mixer_type, m_padded, cap)
    params = _densified(cfg_a, seed)
    params_p = dict(params, mixer=jax.device_get(jparams.pad_mixer_params(params["mixer"], cfg_p.mixer)))
    x, y, img = _data(seed)
    noise = _noise(mixer_type, x.shape[-1], m_active, m_padded, img.shape[-2], 32)
    return cfg_a, cfg_p, params, params_p, (x, y, img), noise


def _port_forward(params, cfg, x, y, img, **kw):
    return forward_train_test(params, cfg, x[:, :12], y, x[:, 12:], img[:, :12], img[:, 12:], **kw)


@pytest.mark.parametrize("mixer_type,m_active,m_padded,cap", PAD_CASES)
def test_padded_forward_matches_jax_and_unpadded(mixer_type, m_active, m_padded, cap):
    cfg_a, cfg_p, params, params_p, (x, y, img), noise = _padded_case(mixer_type, m_active, m_padded, cap)
    want = np.asarray(jforward(params_p, cfg_p, x, y, img, single_eval_pos=12,
                               mgm_active=jnp.int32(m_active),
                               feat_pos_noise=None if noise is None else jnp.asarray(noise)))
    tx, ty, timg = map(torch.from_numpy, (x, y, img))
    tnoise = None if noise is None else torch.from_numpy(noise)[None]
    with torch.no_grad():
        got = _port_forward(tparams.params_from_jax(params_p), _tcfg(cfg_p), tx, ty, timg,
                            mgm_active=m_active, feat_pos_noise=tnoise).numpy()
        unpadded = _port_forward(tparams.params_from_jax(params), _tcfg(cfg_a), tx, ty, timg).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL)
    np.testing.assert_allclose(got, unpadded, rtol=REL, atol=REL)


@pytest.mark.parametrize("mixer_type,m_active,m_padded,cap", PAD_CASES)
def test_padded_gradients_match_jax_and_vanish_on_padding(mixer_type, m_active, m_padded, cap):
    cfg_a, cfg_p, params, params_p, (x, y, img), noise = _padded_case(mixer_type, m_active, m_padded, cap, 1)

    def jloss(p):
        out = jforward(p, cfg_p, x, y, img, single_eval_pos=12, mgm_active=jnp.int32(m_active),
                       feat_pos_noise=None if noise is None else jnp.asarray(noise))
        return (out.astype(jnp.float32) ** 2).sum()

    jg = tparams.flatten_params(jax.device_get(jax.grad(jloss)(jax.tree.map(jnp.asarray, params_p))))
    flat = {k: v.requires_grad_(True) for k, v in tparams.flatten_params(tparams.params_from_jax(params_p)).items()}
    out = _port_forward(tparams.unflatten_params(flat), _tcfg(cfg_p), *map(torch.from_numpy, (x, y, img)),
                        mgm_active=m_active,
                        feat_pos_noise=None if noise is None else torch.from_numpy(noise)[None])
    (out**2).sum().backward()
    for k, want in jg.items():
        got = flat[k].grad.numpy()
        err = np.abs(got - want).max()
        assert err <= REL * np.abs(want).max() + 1e-9, f"{k}: {err} vs {np.abs(want).max()}"
    name = "moe" if mixer_type == "MoE" else "mgm"
    axes = tparams._MOE_EXPERT_AXIS if mixer_type == "MoE" else tparams._MGM_HEAD_AXIS
    for leaf, axis in axes.items():
        g = flat[f"mixer/{name}/{leaf}"].grad
        assert torch.all(g.narrow(axis, m_active, m_padded - m_active) == 0), f"{leaf}: padded grads nonzero"
        assert torch.any(g.narrow(axis, 0, m_active) != 0), f"{leaf}: active grads all zero"


def test_padded_dropout_draws_the_unpadded_masks():
    """With dropout on, a padded mixer draws the masks of its unpadded twin."""
    from multimodalpfn_tpu_torch.models.mixers import apply_mixer

    cfg_a, cfg_p = MixerConfig("MGM+CAP", 2, 2, in_dim=16), MixerConfig("MGM+CAP", 5, 2, in_dim=16)
    p = tparams.init_mixer_params(torch.Generator().manual_seed(0), cfg_a, 8)
    p_pad = tparams.pad_mixer_params(p, cfg_p)
    img = torch.randn(1, 6, 1, 16, generator=torch.Generator().manual_seed(1))
    want = apply_mixer(p, cfg_a, img, train=True, generator=torch.Generator().manual_seed(3))
    got = apply_mixer(p_pad, cfg_p, img, train=True, generator=torch.Generator().manual_seed(3), mgm_active=2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_sweep_token_mask_gate():
    assert not tfb.sweep_needs_token_mask(True, True, "MGM+CAP")
    assert not tfb.sweep_needs_token_mask(True, False, "MGM")
    assert not tfb.sweep_needs_token_mask(False, True, "MGM")
    assert tfb.sweep_needs_token_mask(True, True, "MGM")
    assert tfb.sweep_needs_token_mask(True, True, "MoE")


# ---- histories -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """The JAX cross-cell test's base checkpoint (1 layer, width 32)."""
    from multimodalpfn_tpu.models.loading import save_model

    cfg = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=1, n_out=4, max_num_classes=4,
                       compute_dtype="float32")
    path = tmp_path_factory.mktemp("ckpt") / "base.ckpt"
    save_model(path, jparams.init_params(jax.random.PRNGKey(3), cfg, model_seed=0), cfg)
    return str(path)


def _sweep_data(seed=0, n=40, F=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    img = rng.normal(size=(n, 1, 64)).astype(np.float32)
    y = rng.integers(0, 3, size=n)
    return X, img, y


def _assert_histories(got, want, rel=REL):
    g, w = got["history"], want["history"]
    np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=rel)
    assert [s for s, _ in g["val_error"]] == [s for s, _ in w["val_error"]]
    np.testing.assert_allclose([e for _, e in g["val_error"]], [e for _, e in w["val_error"]], rtol=rel)
    np.testing.assert_allclose(g["best_val_error"], w["best_val_error"], rtol=rel)


OPTIMIZERS = {
    "schedule_free": ({"max_steps": 3}, None),
    "adamw": ({"max_steps": 2, "optimizer": "adamw"}, None),
    "schedule_free_warmup": ({"max_steps": 3, "warmup_steps": 3}, 3),
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_tabular_sweep_history_matches_jax(tiny_ckpt, monkeypatch, opt):
    """2 seeds × 3 steps without an image (the JAX package's batched step
    takes no warmup: its `make_optimizer` is given one here)."""
    from multimodalpfn_tpu.train import finetune_batch as jfb

    ft, warmup = OPTIMIZERS[opt]
    if warmup is not None:
        monkeypatch.setattr(jfb, "make_optimizer", functools.partial(jfb.make_optimizer, warmup_steps=warmup))
    X, _, y = _sweep_data()
    kw = dict(cells=[{"mgm_heads": 2, "cap_heads": 2, "seeds": [0, 1]}], mixer_type="MGM+CAP",
              features_per_group=1, path_to_base_model=tiny_ckpt, X=X, image=None, y=y,
              finetuning_config={"learning_rate": 1e-3, **ft})
    want = jfb.fine_tune_batched_cells(**kw)
    got = tfb.fine_tune_batched_cells(device="cpu", **kw)
    assert np.asarray(got["history"]["train_loss"]).shape == (ft["max_steps"], 2)
    _assert_histories(got, want)
    assert got["history"]["skipped_steps"] == [0, 0]
    assert len(got["history"]["step_seconds"]) == ft["max_steps"]


def _inject_jax_mixers(monkeypatch):
    """Each run's mixer init: the JAX package's ``init_mixer_params`` of
    ``PRNGKey(seed)``, and dropout off in both packages."""
    from multimodalpfn_tpu.models import mixers as jmixers
    from multimodalpfn_tpu_torch.models import mixers as tmixers

    def jax_init(seed, mixer_cfg, emsize, device):
        jcfg = JMixerConfig(**dataclasses.asdict(mixer_cfg))
        return tparams.params_from_jax(jax.device_get(
            jparams.init_mixer_params(jax.random.PRNGKey(int(seed)), jcfg, emsize)), device)

    monkeypatch.setattr(tfb, "init_run_mixer", jax_init)
    monkeypatch.setattr(jmixers, "_dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(tmixers, "_dropout", lambda x, *a, **k: x)


def test_multimodal_padded_sweep_matches_jax(tiny_ckpt, monkeypatch):
    """Cells {mgm 2, mgm 4} × cap 2, 2 seeds each, 3 steps in one sweep."""
    from multimodalpfn_tpu.train import finetune_batch as jfb

    _inject_jax_mixers(monkeypatch)
    X, img, y = _sweep_data()
    kw = dict(cells=[{"mgm_heads": 2, "cap_heads": 2, "seeds": [0, 1]},
                     {"mgm_heads": 4, "cap_heads": 2, "seeds": [2, 3]}],
              mixer_type="MGM+CAP", features_per_group=1, path_to_base_model=tiny_ckpt, X=X, image=img,
              y=y, finetuning_config={"max_steps": 3, "learning_rate": 1e-3}, static_seed=0)
    want = jfb.fine_tune_batched_cells(**kw)
    got = tfb.fine_tune_batched_cells(device="cpu", **kw)
    _assert_histories(got, want)
    for r in range(4):
        gp, gcfg = tfb.extract_run_params(got, r)
        wp, wcfg = jfb.extract_run_params(want, r)
        assert gcfg.mixer.mgm_heads == wcfg.mixer.mgm_heads == (2 if r < 2 else 4)
        wflat = tparams.flatten_params(jax.device_get(wp))
        gflat = tparams.flatten_params(gp)
        assert gflat.keys() == wflat.keys()
        for k, w in wflat.items():
            # the JAX test's sign-flip envelope for near-zero-gradient elements
            np.testing.assert_allclose(gflat[k].numpy(), w, rtol=0, atol=2 * 3 * 1e-3 * 1.25, err_msg=k)


@pytest.mark.parametrize("mixer_type", ["MGM+CAP", "MGM"])
def test_cells_batched_equal_cells_alone(tiny_ckpt, mixer_type):
    """[a, b] in one sweep against [a] and [b] alone, inside the port (with
    the mixers' dropout on): at lr 1e-3 to the JAX test's tolerances, at lr
    1e-12 the losses to 1e-5 and the extracted mixers to 1e-9."""
    X, img, y = _sweep_data()
    a = {"mgm_heads": 2, "cap_heads": 2, "seeds": [0, 1]}
    b = {"mgm_heads": 4, "cap_heads": 2, "seeds": [2, 3]}
    for lr, steps in ((1e-3, 3), (1e-12, 2)):
        kw = dict(mixer_type=mixer_type, features_per_group=1, path_to_base_model=tiny_ckpt, X=X,
                  image=img, y=y, finetuning_config={"max_steps": steps, "learning_rate": lr},
                  static_seed=0, device="cpu")
        both = tfb.fine_tune_batched_cells(cells=[a, b], **kw)
        for cell, runs in ((a, slice(0, 2)), (b, slice(2, 4))):
            alone = tfb.fine_tune_batched_cells(cells=[cell], **kw)
            tol = dict(rtol=2e-3, atol=1e-4) if lr > 1e-6 else dict(rtol=1e-5, atol=0)
            np.testing.assert_allclose(np.asarray(both["history"]["train_loss"])[:, runs],
                                       alone["history"]["train_loss"], **tol)
            np.testing.assert_allclose([e[runs] for _, e in both["history"]["val_error"]],
                                       [e for _, e in alone["history"]["val_error"]], rtol=2e-3, atol=1e-4)
            for r_both, r_alone in zip(range(4)[runs], range(2)):
                pb, cb = tfb.extract_run_params(both, r_both)
                pa, ca = tfb.extract_run_params(alone, r_alone)
                assert cb.mixer == ca.mixer
                atol = 2 * steps * lr * 1.25 if lr > 1e-6 else 1e-9
                for k, v in tparams.flatten_params(pa["mixer"]).items():
                    np.testing.assert_allclose(tparams.flatten_params(pb["mixer"])[k].numpy(), v.numpy(),
                                               rtol=0, atol=atol, err_msg=k)


def test_sweep_learns(tmp_path):
    """The JAX package's learning-quality gate (`tests/test_finetune_batch.py`):
    on near-separable embeddings every run beats its initial validation
    error by 0.1."""
    from multimodalpfn_tpu.datasets.synthetic import toy_multimodal_classification
    from multimodalpfn_tpu.models.loading import save_model

    cfg = JModelConfig(emsize=24, nhead=6, nhid_factor=4, nlayers=2, n_out=10, max_num_classes=10,
                       mixer=JMixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96))
    save_model(tmp_path / "base.ckpt", jparams.init_params(jax.random.PRNGKey(0), cfg, model_seed=0), cfg)
    X, emb, y = toy_multimodal_classification(n=100, n_classes=3, emb_dim=96, seed=3)
    out = tfb.fine_tune_batched(
        mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=str(tmp_path / "base.ckpt"), X=X, image=emb, y=y, seeds=[0, 1],
        finetuning_config={"max_steps": 30, "validate_every_n_steps": 5, "learning_rate": 3e-3},
        device="cpu",
    )
    hist = out["history"]
    initial, best = np.asarray(hist["val_error"][0][1]), np.asarray(hist["best_val_error"])
    assert (best < initial - 0.1).all(), f"initial {initial}, best {best}"
    assert out["params_stacked"]["mixer"]["mgm"]["w1"].shape[0] == 2


def test_sweep_refuses_mesh_and_split_caps_and_defaults_to_the_card(tiny_ckpt):
    X, img, y = _sweep_data()
    kw = dict(mixer_type="MGM+CAP", features_per_group=1, path_to_base_model=tiny_ckpt, X=X, image=img, y=y)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        tfb.fine_tune_batched_cells(cells=[{"mgm_heads": 2, "cap_heads": 2, "seeds": [0]}], mesh=object(),
                                    device="cpu", **kw)
    with pytest.raises(ValueError, match="cap_heads must be shared"):
        tfb.fine_tune_batched_cells(cells=[{"mgm_heads": 2, "cap_heads": 2, "seeds": [0]},
                                           {"mgm_heads": 4, "cap_heads": 4, "seeds": [0]}],
                                    device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tfb.fine_tune_batched_cells(cells=[{"mgm_heads": 2, "cap_heads": 2, "seeds": [0]}], **kw)


def test_orthogonality_loss_matches_jax():
    from multimodalpfn_tpu.models.mixers import orthogonality_loss as jax_loss
    from multimodalpfn_tpu_torch.models.mixers import orthogonality_loss

    mixer = jax.device_get(jparams.init_mixer_params(jax.random.PRNGKey(2), _jcfg("MGM", 4, 2).mixer, 32))
    want = float(jax_loss(jax.tree.map(jnp.asarray, mixer["mgm"])))
    got = float(orthogonality_loss(tparams.params_from_jax(mixer)["mgm"]))
    np.testing.assert_allclose(got, want, rtol=1e-6)
