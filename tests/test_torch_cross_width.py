"""Cross-width member batching in the port: members of different preprocessed
widths zero-padded into one group, their padded feature tokens masked out of
feature attention (K6a / K6b, `ops/fused.py`), each keeping its own
positional-embedding draws.

Against the JAX package: the masked plain versions against the masked Pallas
kernels (TPU interpret mode on the CPU), the masked forward against JAX
`forward(tab_valid=, feat_pos_noise=)` on two goldens, and the merge plan's
masks and noise tables. Inside the port: the merged group equals the split
groups, for the full forward and for ``fit_with_cache`` (as the JAX package's
tests/test_cross_width_batching.py pins its own), on the plain path and on the
kernel path (whose wrappers run their plain versions on the CPU).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import multimodalpfn_tpu_torch.estimator.inference as inf
from multimodalpfn_tpu.datasets.synthetic import toy_multimodal_classification
from multimodalpfn_tpu.estimator.inference import _merge_width_aux as j_merge_width_aux
from multimodalpfn_tpu.models.transformer import forward as jforward
from multimodalpfn_tpu.ops import pallas_fused as jf
from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.config import MixerConfig, ModelConfig
from multimodalpfn_tpu_torch.models.transformer import forward
from multimodalpfn_tpu_torch.ops import fused as tf
from tests.golden_utils import GoldenCase
from tests.test_torch_classifier import PROBA_ATOL, small_ckpt  # noqa: F401
from tests.test_torch_forward import to_port_config

# float32 sublayers ending in a LayerNorm, summation order only (as
# tests/test_torch_fused.py); the JAX package's merged-vs-split bar is 1e-5
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# whole float32 forwards with different op orders: the golden parity bound
FORWARD_TOL = dict(rtol=2e-4, atol=2e-5)
MERGE_TOL = dict(rtol=1e-5, atol=1e-5)
PATHS = {"plain": dict(fused_ops=False), "kernels": dict(fused_ops=True, use_flash=True)}
CASES = ["tabular_clf_fpg1", "mm_mgm_cap"]


def _weights(rng, e, h, d):
    return (rng.normal(size=(3, h, d, e)).astype(np.float32) * 0.1,
            rng.normal(size=(h, d, e)).astype(np.float32) * 0.1)


def _ragged_mask(rng, b, t):
    """Per-member key masks: member 0 keeps every key, member 1 only the
    target (the last token), the rest a random prefix of feature tokens."""
    m = np.zeros((b, t), bool)
    m[:, -1] = True
    m[0] = True
    for i in range(2, b):
        m[i, : rng.integers(1, t)] = True
    return m


@pytest.mark.parametrize("b,t,s,e,h,d", [(3, 13, 37, 32, 4, 8), (4, 7, 20, 16, 2, 8)])
def test_masked_feature_attention_im_matches_jax(b, t, s, e, h, d):
    """K6a's plain version against the JAX item-major masked kernel."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, t, s, e)).astype(np.float32)
    w_qkv, w_out = _weights(rng, e, h, d)
    mask = _ragged_mask(rng, b, t)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jf.fused_feature_attention_ln_im(
            jnp.asarray(x), jnp.asarray(w_qkv), jnp.asarray(w_out), block_rows=16,
            key_mask=jnp.asarray(mask)))
    got = tf.fused_feature_attention_ln_im(
        torch.from_numpy(x), torch.from_numpy(w_qkv), torch.from_numpy(w_out),
        key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("lead,mask_lead,t", [((3, 19), (3, 1), 13), ((23,), (23,), 7)])
def test_masked_feature_attention_matches_jax(lead, mask_lead, t):
    """K6b's plain version against the JAX sample-major masked kernel, with a
    per-member mask broadcast over the rows and a per-row mask."""
    rng = np.random.default_rng(1)
    e, h, d = 32, 4, 8
    x = rng.normal(size=(*lead, t, e)).astype(np.float32)
    w_qkv, w_out = _weights(rng, e, h, d)
    mask = _ragged_mask(rng, int(np.prod(mask_lead)), t).reshape(*mask_lead, t)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jf.fused_feature_attention_ln(
            jnp.asarray(x), jnp.asarray(w_qkv), jnp.asarray(w_out), block_rows=16,
            key_mask=jnp.asarray(mask)))
    got = tf.fused_feature_attention_ln(
        torch.from_numpy(x), torch.from_numpy(w_qkv), torch.from_numpy(w_out),
        key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_masked_wrappers_refuse_a_mask_without_the_target_key():
    """Off the CPU the wrapper checks the mask words before any launch: a row
    with no valid key would be an empty softmax."""
    x = torch.empty((2, 5, 9, 16), device="meta")
    w_qkv, w_out = torch.empty((3, 2, 8, 16), device="meta"), torch.empty((2, 8, 16), device="meta")
    mask = torch.ones((2, 5), dtype=torch.bool)
    mask[1, -1] = False
    with pytest.raises(ValueError, match="target"):
        tf.fused_feature_attention_ln_im(x, w_qkv, w_out, key_mask=mask)
    with pytest.raises(ValueError, match="target"):
        tf.fused_feature_attention_ln(x.transpose(1, 2), w_qkv, w_out, key_mask=mask[:, None])


def test_key_mask_words_per_member_and_per_row():
    """A mask broadcast over the rows gives one word per member; bit j is key j."""
    mask = torch.tensor([[1, 0, 1, 1], [0, 0, 0, 1]], dtype=torch.bool)
    words, rpm = tf._key_mask_words("K6b", mask[:, None], (2, 5), 4)
    assert rpm == 5 and words.tolist() == [0b1101, 0b1000]
    words, rpm = tf._key_mask_words("K6b", mask[:, None].expand(2, 5, 4), (2, 5), 4)
    assert rpm == 1 and words.tolist() == [0b1101] * 5 + [0b1000] * 5


def test_merge_width_aux_matches_jax():
    """The padded group's masks and per-member noise tables: the port draws
    the same numbers as the JAX package, on the CPU generator."""
    cfg = ModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, model_seed=3)
    for n_img in (0, 4):
        tv, noise, wmax = inf._merge_width_aux(cfg, [5, 3, 4, 5], n_img)
        jtv, jnoise, jwmax = j_merge_width_aux(cfg, [5, 3, 4, 5], n_img)
        assert wmax == jwmax == 5
        np.testing.assert_array_equal(tv, jtv)
        np.testing.assert_array_equal(noise, jnoise)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("case_name", CASES)
def test_masked_forward_matches_jax(case_name, path):
    """The port's forward with ``tab_valid`` and ``feat_pos_noise`` against the
    JAX package's on the golden weights: three members of widths 5, 3 and 4
    zero-padded to 5."""
    case = GoldenCase(case_name)
    widths, S, sep = [5, 3, 4], 33, 24
    rng = np.random.default_rng(2)
    x = np.zeros((3, S, 5), np.float32)
    for i, w in enumerate(widths):
        x[i, :, :w] = rng.normal(size=(S, w))
    y = rng.integers(0, 3, size=(3, sep)).astype(np.float32)
    img = rng.normal(size=(1, S, 2, 96)).astype(np.float32) if case_name == "mm_mgm_cap" else None
    n_img = 0 if img is None else case.cfg.mixer.cap_heads
    tab_valid, noise, _ = j_merge_width_aux(case.cfg, widths, n_img)
    want = np.asarray(jforward(case.params(), case.cfg, x, y, img, single_eval_pos=sep,
                               tab_valid=jnp.asarray(tab_valid),
                               feat_pos_noise=jnp.asarray(noise)))
    got = forward(
        tparams.params_from_jax(jax.device_get(case.params())),
        to_port_config(case.cfg, **PATHS[path]),
        torch.from_numpy(x), torch.from_numpy(y), None if img is None else torch.from_numpy(img),
        single_eval_pos=sep, tab_valid=torch.from_numpy(tab_valid),
        feat_pos_noise=torch.from_numpy(noise),
    )
    np.testing.assert_allclose(got.numpy(), want, **FORWARD_TOL)


def _members(widths, sep, seed):
    """Members of the given widths over one shared source table, whose
    preprocessors hand back their own columns of the test rows; and the
    test rows."""
    rng = np.random.default_rng(seed)
    X_full = rng.normal(size=(sep + 9, max(widths) + 1)).astype(np.float32)
    y = rng.integers(0, 3, size=(sep,)).astype(np.float32)
    members = [
        inf._Member(
            config=None,
            preprocessor=SimpleNamespace(transform=lambda X, w=w: SimpleNamespace(X=X[:, :w])),
            X_train=X_full[:sep, :w], y_train=y, cat_ix=None,
        )
        for w in widths
    ]
    return members, X_full[sep:]


def _case_image(case_name, sep, seed):
    if case_name != "mm_mgm_cap":
        return None, None
    img = np.random.default_rng(seed).normal(size=(sep + 9, 2, 96)).astype(np.float32)
    return img[:sep], img[sep:]


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("case_name", CASES)
def test_merged_group_matches_split_groups_full_forward(case_name, path, monkeypatch):
    case = GoldenCase(case_name)
    params = tparams.params_from_jax(jax.device_get(case.params()))
    cfg = to_port_config(case.cfg)
    members, X_test = _members([5, 3, 4], sep=24, seed=0)
    img_tr, img_te = _case_image(case_name, 24, seed=3)
    use_kernels = path == "kernels"

    def run(force):
        monkeypatch.setattr(inf, "_FORCE_MERGE", force)
        return inf._group_and_run(
            params, cfg, members, X_test, None if img_tr is None else torch.from_numpy(img_tr),
            img_te, autocast=False, device=torch.device("cpu"), use_kernels=use_kernels)

    for m, s in zip(run(True), run(False)):
        np.testing.assert_allclose(m, s, **MERGE_TOL)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("case_name", CASES)
def test_merged_group_matches_split_groups_cachekv(case_name, path, monkeypatch):
    case = GoldenCase(case_name)
    params = tparams.params_from_jax(jax.device_get(case.params()))
    cfg = to_port_config(case.cfg)
    members, X_test = _members([5, 3, 4], sep=24, seed=1)
    img_tr, img_te = _case_image(case_name, 24, seed=4)

    def run(force):
        monkeypatch.setattr(inf, "_FORCE_MERGE", force)
        eng = inf.InferenceEngineCacheKV(
            params=params, cfg=cfg, members=members, image_train=img_tr, autocast=False,
            device=torch.device("cpu"), use_kernels=path == "kernels")
        eng._prime()
        assert len(eng.caches) == (1 if force else 3)
        return [o for o, _ in eng.iter_outputs(X_test, img_te)]

    for m, s in zip(run(True), run(False)):
        np.testing.assert_allclose(m, s, **MERGE_TOL)


def test_plan_groups_cost_rule_decisions():
    """The H100 cost rule (constants fitted by tools/torch_merge_cost.py, see
    PERF.md): at the flagship widths 39/39/22/22 (sep 1838, 512 test rows) the
    split groups are predicted faster; at near-equal widths 10/9 on a short
    sequence (sep 60, 16 test rows) the merged group is; a KV-cache predict
    (128 test rows against the cache) merges the flagship widths too. The
    card measured the same three choices faster."""
    cfg = ModelConfig(
        emsize=192, nhead=6, nhid_factor=4, nlayers=12, features_per_group=1,
        n_out=10, max_num_classes=10,
        mixer=MixerConfig("MGM+CAP", mgm_heads=16, cap_heads=8, in_dim=768),
    )
    plans = inf._plan_groups({(39, 1838): [0, 1], (22, 1838): [2, 3]}, cfg, 8, 512)
    assert len(plans) == 2 and all(tv is None for _, _, tv, _ in plans)
    plans = inf._plan_groups({(10, 60): [0], (9, 60): [1]}, cfg, 8, 16)
    assert len(plans) == 1
    idxs, width, tab_valid, noise = plans[0]
    assert sorted(idxs) == [0, 1] and width == 10
    assert tab_valid.shape == (2, 10) and noise.shape == (2, 18, 48)
    plans = inf._plan_groups({(39, 1838): [0, 1], (22, 1838): [2, 3]}, cfg, 8, 128, cached=True)
    assert len(plans) == 1 and plans[0][1] == 39 and plans[0][2].shape == (4, 39)


@pytest.mark.parametrize("fit_mode", ["fit_preprocessors", "fit_with_cache"])
def test_default_preprocessing_classifier_matches_jax(fit_mode, small_ckpt, tmp_path):
    """The classifier's default preprocessing (quantile transform, appended
    originals, global SVD; and the plain member) end to end against the JAX
    classifier, float32 on the CPU, four members of two widths. Each package
    plans the widths with its own cost rule; merged or split, the answers
    agree to 1e-5."""
    from multimodalpfn_tpu import MMPFNClassifier as JMMPFNClassifier
    from multimodalpfn_tpu_torch import MMPFNClassifier
    from multimodalpfn_tpu_torch.models.loading import save_npz

    X, img, y = toy_multimodal_classification(n=110, n_features=7, n_classes=3, emb_dim=64, seed=3)
    kw = dict(mgm_heads=2, cap_heads=4, n_estimators=4, random_state=0, fit_mode=fit_mode)
    jclf = JMMPFNClassifier(model_path=str(small_ckpt), **kw).fit(X[:80], img[:80], y[:80])
    want = jclf.predict_proba(X[80:], img[80:])
    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = MMPFNClassifier(model_path=str(npz), device="cpu", **kw).fit(X[:80], img[:80], y[:80])
    widths = {m.X_train.shape[1] for m in clf.executor_.members}
    assert len(widths) == 2, widths
    np.testing.assert_allclose(clf.predict_proba(X[80:], img[80:]), want, atol=PROBA_ATOL, rtol=0)
