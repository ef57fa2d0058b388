"""KV-cache serving in the port (multimodalpfn_tpu_torch/models/cached.py and
the ``fit_with_cache`` engine) against the JAX package's, and pipelined
request streams against sequential predicts.

On the CPU the kernel wrappers run their plain versions, so both of the port's
paths run here: plain (``fused_ops=False, use_flash=False``) and the kernel
path (K5, K4 and K3 through their plain versions).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodalpfn_tpu import MMPFNClassifier as JMMPFNClassifier
from multimodalpfn_tpu import TabPFNClassifier as JTabPFNClassifier
from multimodalpfn_tpu.models.cached import forward_cached as jforward_cached
from multimodalpfn_tpu.models.cached import prime_cache as jprime_cache
from multimodalpfn_tpu.preprocess.ensemble import PreprocessorConfig as JPreprocessorConfig
from multimodalpfn_tpu_torch import MMPFNClassifier, TabPFNClassifier
from multimodalpfn_tpu_torch.datasets.synthetic import (
    toy_classification,
    toy_multimodal_classification,
)
from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.cached import forward_cached, prime_cache
from multimodalpfn_tpu_torch.models.loading import save_npz
from multimodalpfn_tpu_torch.models.transformer import forward
from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig
from tests.golden_utils import GoldenCase
from tests.test_torch_classifier import PROBA_ATOL, _data, _kwargs, small_ckpt  # noqa: F401
from tests.test_torch_forward import to_port_config

# float32 cached forwards on both sides with different op orders: the JAX
# package's own cached-vs-full bound (tests/test_cached_inference.py)
TOL = dict(rtol=2e-4, atol=2e-5)
PATHS = {"plain": dict(fused_ops=False), "kernels": dict(fused_ops=True, use_flash=True)}
CASES = ["tabular_clf_fpg1", "mm_mgm_cap", "tabular_clf_fpg2_outlier12"]


def _case_inputs(name, seed, b=2, S=48, sep=36, F=5):
    """Continuous inputs with a few NaNs (no constant columns), two members,
    and for the multimodal golden a 2-patch image per row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, F)).astype(np.float32)
    x[rng.random(x.shape) < 0.03] = np.nan
    y = rng.integers(0, 3, size=(b, sep)).astype(np.float32)
    img = rng.normal(size=(1, S, 2, 96)).astype(np.float32) if name == "mm_mgm_cap" else None
    return x, y, img, sep


def _jax_cached(case, cfg, x, y, img, sep):
    params = case.params()
    cache = jprime_cache(params, cfg, x[:, :sep], y, None if img is None else img[:, :sep])
    logits = jforward_cached(params, cfg, cache, x[:, sep:], None if img is None else img[:, sep:])
    return np.asarray(logits), np.asarray(cache.kv0)


def _port_cached(case, cfg, x, y, img, sep):
    params = tparams.params_from_jax(jax.device_get(case.params()))
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    cache = prime_cache(params, cfg, t(x[:, :sep]), t(y), None if img is None else t(img[:, :sep]))
    logits = forward_cached(params, cfg, cache, t(x[:, sep:]), None if img is None else t(img[:, sep:]))
    return logits, cache


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", CASES)
def test_cached_matches_jax(name, path):
    """Prime + predict on the golden weights, float32; the cached K/V match
    too, in the port's natural (L, b, t, 2, S_tr, d) layout."""
    case = GoldenCase(name)
    x, y, img, sep = _case_inputs(name, seed=CASES.index(name))
    want, want_kv = _jax_cached(case, case.cfg, x, y, img, sep)
    got, cache = _port_cached(case, to_port_config(case.cfg, **PATHS[path]), x, y, img, sep)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(cache.kv0.numpy(), np.swapaxes(want_kv, -1, -2), **TOL)


def test_cached_bf16_residual_sums(monkeypatch):
    """bfloat16 serving with the residual precisions of the JAX package's
    cached path: after the cached item attention the out-projection emits
    float32 and the residual is summed in float32 (`cached.py:386-403`),
    while prime sums its residuals in bf16 (`cached.py:303-305`). The JAX
    package's bf16 cached path cannot run on XLA's CPU backend (it has no
    BF16 x BF16 = F32 dot), so the sums are pinned here: every predict layer's
    LN input carries more than bf16 precision, and the logits stay within
    bf16 resolution (0.05 abs at unit scale, 3 layers) of the float32 run."""
    from multimodalpfn_tpu_torch.models import cached

    case = GoldenCase("mm_mgm_cap")
    x, y, img, sep = _case_inputs("mm_mgm_cap", seed=7)
    ref, _ = _port_cached(case, to_port_config(case.cfg), x, y, img, sep)
    cfg = to_port_config(dataclasses.replace(case.cfg, compute_dtype="bfloat16"))
    params = tparams.params_from_jax(jax.device_get(case.params()))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    cache = prime_cache(params, cfg, t(x[:, :sep]), t(y), t(img[:, :sep]))
    assert cache.kv0.dtype == torch.bfloat16
    sums = []
    real = cached.ln_rows

    def spy(u):
        sums.append(u)
        return real(u)

    monkeypatch.setattr(cached, "ln_rows", spy)
    got = forward_cached(params, cfg, cache, t(x[:, sep:]), t(img[:, sep:]))
    assert len(sums) == cfg.nlayers
    for u in sums:
        assert u.dtype == torch.float32 and not torch.equal(u, u.to(torch.bfloat16).float())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0.05)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cached_matches_full_forward(path):
    """Where the train rows alone determine the encoder masks (no constant
    columns, no NaNs), the cached predictions are the full forward's."""
    case = GoldenCase("tabular_clf_fpg1")
    cfg = to_port_config(case.cfg, **PATHS[path])
    params = tparams.params_from_jax(jax.device_get(case.params()))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 48, 5)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, size=(1, 36)).astype(np.float32))
    full = forward(params, cfg, x, y, single_eval_pos=36)
    cached = forward_cached(params, cfg, prime_cache(params, cfg, x[:, :36], y), x[:, 36:])
    np.testing.assert_allclose(cached.numpy(), full.numpy(), **TOL)


def test_mmpfn_fit_with_cache_matches_jax(small_ckpt, tmp_path):  # noqa: F811
    X_tr, img_tr, y_tr, X_te, img_te = _data()
    jclf = JMMPFNClassifier(model_path=str(small_ckpt), mgm_heads=2, cap_heads=4,
                            fit_mode="fit_with_cache", **_kwargs(JPreprocessorConfig))
    jclf.fit(X_tr, img_tr, y_tr)
    want = jclf.predict_proba(X_te, img_te)

    npz = tmp_path / "from_jax.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = MMPFNClassifier(model_path=str(npz), mgm_heads=2, cap_heads=4, device="cpu",
                          fit_mode="fit_with_cache", **_kwargs(PreprocessorConfig))
    clf.fit(X_tr, img_tr, y_tr)
    assert clf.executor_.caches is not None  # primed at fit
    np.testing.assert_allclose(clf.predict_proba(X_te, img_te), want, atol=PROBA_ATOL, rtol=0)


def test_tabpfn_fit_with_cache_matches_jax(small_ckpt, tmp_path):  # noqa: F811
    X_tr, _, y_tr, X_te, _ = _data()
    jclf = JTabPFNClassifier(model_path=str(small_ckpt), fit_mode="fit_with_cache",
                             **_kwargs(JPreprocessorConfig))
    jclf.fit(X_tr, y_tr)
    npz = tmp_path / "tab.npz"
    save_npz(npz, jax.device_get(jclf.params_), jclf.config_)
    clf = TabPFNClassifier(model_path=str(npz), device="cpu", fit_mode="fit_with_cache",
                           **_kwargs(PreprocessorConfig))
    clf.fit(X_tr, y_tr)
    np.testing.assert_allclose(clf.predict_proba(X_te), jclf.predict_proba(X_te),
                               atol=PROBA_ATOL, rtol=0)


def test_cache_reprimes_when_the_run_configuration_changes():
    """A cache holds one configuration's values: switching the kernel path
    off makes the next predict prime again, with the plain path."""
    X, y = toy_classification(n=70, n_classes=3, seed=2)
    clf = TabPFNClassifier(model_path="random:0", fit_mode="fit_with_cache",
                           device="cpu", **_kwargs(PreprocessorConfig) | {"n_estimators": 2})
    clf.fit(X[:50], y[:50])
    first = clf.executor_.caches
    assert clf.executor_.primed_cfg.fused_ops is False  # CPU default: plain path
    clf.predict_proba(X[50:])
    assert clf.executor_.caches is first
    clf.executor_.use_kernels = True
    clf.predict_proba(X[50:])
    assert clf.executor_.caches is not first and clf.executor_.primed_cfg.fused_ops is True


def _requests(X_pool, n_requests, rows, seed):
    rng = np.random.default_rng(seed)
    return [X_pool[rng.choice(len(X_pool), size=rows, replace=False)] for _ in range(n_requests)]


@pytest.mark.parametrize(
    "fit_mode,depth",
    [("fit_with_cache", 1), ("fit_with_cache", 3), ("fit_preprocessors", 3)],
)
def test_pipelined_equals_sequential(fit_mode, depth):
    """`predict_proba_many` returns exactly the sequential answers, at every
    in-flight depth (tests/test_serving_pipeline.py:28-48)."""
    X, y = toy_classification(n=90, n_classes=3, seed=11)
    clf = TabPFNClassifier(model_path="random:0", fit_mode=fit_mode, device="cpu",
                           **_kwargs(PreprocessorConfig) | {"n_estimators": 2})
    clf.fit(X[:60], y[:60])
    reqs = _requests(X[60:], n_requests=4, rows=12, seed=0)
    sequential = [clf.predict_proba(r) for r in reqs]
    pipelined = clf.predict_proba_many(reqs, max_in_flight=depth)
    assert len(pipelined) == len(sequential)
    for p, s in zip(pipelined, sequential):
        np.testing.assert_array_equal(p, s)


def test_pipelined_multimodal_kv_cache():
    X, emb, y = toy_multimodal_classification(n=70, n_classes=2, emb_dim=768, seed=5)
    clf = MMPFNClassifier(model_path="random:0", mgm_heads=16, cap_heads=8,
                          fit_mode="fit_with_cache", device="cpu",
                          **_kwargs(PreprocessorConfig) | {"n_estimators": 2})
    clf.fit(X[:50], emb[:50], y[:50])
    reqs_X = [X[50:60], X[55:65], X[60:70]]
    reqs_img = [emb[50:60], emb[55:65], emb[60:70]]
    sequential = [clf.predict_proba(x, e) for x, e in zip(reqs_X, reqs_img)]
    pipelined = clf.predict_proba_many(reqs_X, reqs_img, max_in_flight=2)
    for p, s in zip(pipelined, sequential):
        np.testing.assert_array_equal(p, s)


def test_pipelined_edge_cases():
    X, y = toy_classification(n=60, n_classes=2, seed=3)
    clf = TabPFNClassifier(model_path="random:0", fit_mode="fit_with_cache", device="cpu",
                           **_kwargs(PreprocessorConfig) | {"n_estimators": 2})
    clf.fit(X[:40], y[:40])
    assert clf.predict_proba_many([]) == []
    single = clf.predict_proba_many([X[40:50]])
    np.testing.assert_array_equal(single[0], clf.predict_proba(X[40:50]))
    with pytest.raises(ValueError):
        clf.predict_proba_many([X[40:50]], max_in_flight=0)
    with pytest.raises(ValueError):
        clf.predict_proba_many([X[40:50], X[50:60]], [None])
